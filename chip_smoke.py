#!/usr/bin/env python3
"""Drive the PyTorch port (hyperopt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card; it builds
the port's CUDA kernel from the sources in the checkout and needs no
network.  Every phase asserts, and a failure exits non-zero:

1. the card's name and power limit; build the kernel (nvcc, sm_90a) and
   count the SASS instructions per term of its inner loop (cuobjdump);
2. the kernel against its plain PyTorch version on the card at the
   shapes the 20-dim mixed space gives it (Dg=12, S=128): the sequential
   fmin's asks (B=1, K_below=17, K_above=512), ``suggest_batch`` at
   B=64 on a 500-obs history (K_below=9, K_above=512), and the
   reference's stage batch (B=4096): max error, argmax agreement, two
   launches bitwise equal, kernel and plain times (device time by
   ``torch.profiler``, per call by CUDA events and by the host clock)
   and the bound, and the device time of every split the kernel is
   compiled for beside the one the wrapper picks; at B=64 a second
   K_above splits the time into a part per component and a fixed part;
3. ``tpe.suggest_batch`` at batch 64 on a 500-obs history of
   ``mixed_space()``: suggestions/s, and the kernel launched;
4. the main path: a sequential 1000-trial ``fmin`` on ``mixed_space_fn``
   with the port's ``tpe.suggest``: best loss, wall time, and one kernel
   launch per TPE ask (980); then 20 more asks under ``torch.profiler``
   (host time, device busy time and idle share per ask);
5. the port on CUDA against the port on the CPU, teacher-forced on the
   phase-3 history: every disagreeing pick must be a near-tie;
6. every other suggest path on the card, each with the launch counter set
   to 0 just before it and read just after: (a) the fused sequential
   driver (``partial(tpe.suggest, fused=True)`` on a resident
   ``TorchTrials``, 1000 trials): its loss stream bitwise phase 4's, the
   buffer's transfer counters as the reference counts them, the
   ask-ahead hook still installed and every warm ask served by its
   pre-dispatched draw, and a profiled window beside phase 4's;
   (b) ``joint_ei`` at B=64, CUDA against CPU under the near-tie rule of
   the joint score; (c) ``speculative=4``, one launch per warm k-wide
   redraw; (d) ``anneal.suggest``, resident and not, bitwise equal and
   launching nothing; (e) ``atpe.suggest``, one launch per warm ask, and
   ``build_atpe_device_fn`` at B=64, CUDA against CPU; (f)
   ``rand.suggest(speculative=4)``, one prior draw per four asks;
7. the study-batched serve engine (``serve.SuggestService``): (a)
   ``gmm_llr_stacked`` at 64 studies of the serve shape, one launch
   bitwise the 64 per-study launches and against the plain version,
   timed at every compiled split beside the one forced from one study's
   shape; (b) ``bench.py``'s serve protocol at 64 studies and at one:
   asks/s, p50/p99 ask latency, occupancy, one ``gmm_llr`` launch per
   round; (c) 64 studies told 500 trials each, 20 rounds: round time,
   device busy time and idle share, device kernels and PyTorch
   operations per round; no tensor of a study's slice of the stacked
   step differs from the same study alone, and no fixed-order reduction
   of the fits gives a stacked slice other bits (PyTorch's own
   reductions are counted beside them); (d) the same operations per
   round at 4 studies; (e) every study's stream bitwise its solo fused
   stream on the card;
8. (run right after phase 1, before any profiler has traced: once one has
   run in the process, each graph replay holds the host until the card
   has run it) the compiled loop (``device_loop.compile_fmin``, each
   step a CUDA-graph replay), each path's ``gmm_llr`` launches counted
   as the launches captured in a step times its replays (the wrapper
   counts at capture): (a) ``bench.py``'s ``bench_compiled_at_1k``, a
   warm runner and a timed 1000-trial ``fmin(compiled=True)``: seconds,
   best loss, replays, 980 launches, host time per replay, the time to
   rebuild the ``Trials`` store, and the first 64 replayed steps
   bitwise the same steps run eagerly; (b) a sweep of 8 seeds x 256
   trials, each seed bitwise its solo run; (c) ``chunk_size=250`` with
   progress rows and checkpoints, killed at a chunk boundary through
   ``FaultyFS`` and resumed: bitwise the flat run, the same rows; (d) a
   ``loss_threshold`` the flat run reaches: fewer evaluations, the
   history a bitwise prefix of the flat run's; (e) ``bench_mlp_tune``,
   512 trials of an 8-epoch MLP at batch 32: trials/s, best loss, and
   the kernel at its shape against the plain version and its bound;
   8b also sweeps 8 seeds of ``algo="atpe"`` and of ``joint_ei=True``,
   each seed bitwise its solo run, and holds the kernel against its
   plain version at every launch shape those sweeps and solo runs gave
   it (8 seeds folded into the dim axis at a 256-slot carry); (f), run after phase 9: 8a's last 20
   model steps under ``torch.profiler``: device kernels per step, device
   busy time and idle share; then 8a's bare replays again, after that
   profiler trace;
9. (run right after phase 8, before any profiler too) the multi-fidelity
   schedulers: (a) ``bench.py``'s ``bench_compiled_asha`` on
   ``mlp_tune`` at its full width: 256 trials in brackets of 16 with
   ``asha={"eta": 2, "rung_epochs": 1, "n_rungs": 3}`` against the flat
   compiled sweep of 128 trials of 7 epochs, both with one bracket per
   chunk and progress rows: both walls, brackets/s, ASHA's time to the
   flat sweep's best, the replays and one ``gmm_llr`` launch per model
   bracket; the first brackets replayed bitwise the eager brackets, the
   chunked run bitwise the unchunked one, one artifact row per bracket,
   and a kill at a chunk boundary resumed bitwise; (b) ``compile_pbt``
   (pop 32, ``exploit_every`` 10, 20 rounds: ``bench.py``'s
   ``PBT_STUDY_CONFIG``) and ``compile_sha`` (16 configs x 2 replicas)
   on a population of ``mlp_tune``'s MLP: member-steps/s, ms per round
   and per rung, captured runs bitwise the eager runs, a rung-checkpoint
   resume bitwise; (c) ``successive_halving(max_budget=27, eta=3)`` and
   ``asha(workers=4, max_jobs=40)`` over ``budgeted_quadratic_fn`` with
   the port's ``tpe.suggest`` on the card: walls and launches, and the
   kernel against its plain version at every launch shape of the asks
   (one dim: B=1, Dg=1); 9a's launches are checked to be all at the
   shape 9a holds against the plain version; (d), last
   of all (after it the card's traces came back empty): 9a's model
   brackets under ``torch.profiler``;
10. (after phase 7) durable fmin on the card, ``mixed_space()`` at
   ``tpe.suggest``'s defaults, 120 trials: (a) ``fmin(engine=True)`` at
   ``ask_ahead`` 1 and 4 bitwise the solo fused stream from the same
   rstate, one ``gmm_llr`` launch per ask, ms per trial in pairs with the
   solo fused driver; (b) the same run on a ``SuggestService`` over a
   study root with a ``FaultPlan`` seam, killed once at each
   ``SERVE_CRASH_POINTS`` point and resumed: bitwise, every tell logged
   once, the resumed asks launching the kernel; (c) the solo durable
   driver (``DriverRecovery``) killed once at each ``DRIVER_CRASH_POINTS``
   point and resumed, the same asserts; (d) ATPE through its
   ``host_algo`` hook on a background service, bitwise the solo ATPE,
   every launch from the loop thread; (e) ``catch=`` and
   ``trial_timeout=0.2`` failures durable across a kill and not run
   again; (f) an armed ``FlightRecorder`` on (a)'s run, bitwise the
   unarmed stream, its export auditing clean; the kernel is then held
   against its plain version at every launch shape these paths gave it.
   Every fmin of the script passes ``show_progressbar=False`` (phase 1
   says whether ``tqdm`` is importable);
11. (after phase 10) the suggestion service as a network process, at
   ``mixed_space()``'s full width, every reply asserted ``ok``: (a) the
   console script (``python -m hyperopt_tpu_torch.serve.service --root
   ...``) as a subprocess, 4 studies x 60 trials driven by
   ``RemoteStudy`` threads on binary frames, SIGKILLed once after 30
   tells per study (one ask each in flight) and restarted on its root:
   every stream bitwise the in-process service's, every tell logged once
   (``wal_tells``), the dispatches and ``gmm_llr`` launches read from its
   ``metrics`` op; (b) the reference's burst protocol (64 clients x 8
   pipelined asks over 4 studies, a ``root=`` background service) on
   binary frames and on JSON lines, one pair: asks/s, fsyncs per tell,
   co-batch occupancy; (c) 7b's serve protocol over the socket (one
   ``ask_batch`` frame and 64 pipelined tells per round) in pairs with
   7b's in-process rounds: bitwise, one launch per round, ms per round on
   both sides; (d) 4 ``RemoteStudy`` clients under a seeded
   ``NetFaultPlan`` (resets, latency, truncation, both
   ``NET_CRASH_POINTS``) against a ``root=`` service whose ``FaultPlan``
   injects ``ESTALE``/``EIO`` and partial writes: zero lost and zero
   duplicated tells, streams bitwise the clean run's, the connection cap's
   typed ``Overloaded``, a silent client reaped at ``idle_timeout``; (e)
   (c)'s rounds with ``device_metrics_every=2`` (bitwise, the twin's ms
   per dispatch) and a chunked ``compile_fmin(metrics_registry=)``; then
   the kernel at every launch shape of those paths; (f), last of all,
   served rounds under ``utils.profiling.device_trace``: its Chrome trace
   holds the ``gmm_llr`` kernel;
12. (after phase 11, before 11f) the serve fleet at ``mixed_space()``'s
   full width, every reply asserted ``ok``: (a) ``bench.py``'s
   ``bench_fleet`` protocol in one process (3 replicas of
   ``serve.Fleet`` behind ``FleetRouter``, 12 studies, ``max_batch`` 16,
   ``n_cand`` 128, ``snapshot_cadence`` 64, every replica padded to its
   slot cap once, 3 timed ``ask_batch`` rounds, then the replica owning
   the first study killed and two per-ask passes): asks/s, the failover
   window's p99 ask latency, ``recovery_ms``, one ``gmm_llr`` launch per
   replica round (the replicas' own counts summing to the process's),
   every stream bitwise one in-process service's and every tell logged
   once (restored from the root alone); (b) ``bench_pilot``'s protocol
   (2 replicas under ``FleetPilot(max_replicas=3)``, a flight recorder
   armed): ``pilot_scale_out_ms``, ``pilot_scale_in_ms``, autoscaled
   asks/s, at least one scale-out and one scale-in, every stream bitwise
   (a)'s for the same seed, and the flight log replayed against a fresh
   service at ``replay_fidelity`` 1.0; (c) two console-script replicas
   (``--root R --owner r0``/``r1``, started together) behind the router's
   console script (``python -m hyperopt_tpu_torch.serve.router --salt``
   with the fleet's ``fleet_salt``), each replica warmed by one round, 4
   ``RemoteStudy`` clients x 40 trials on binary frames, the replica
   owning the first study SIGKILLed after 20 tells per study: the
   survivor adopts its studies, every stream bitwise an in-process clean
   run, every tell logged once, each replica's launches after its warm-up
   read from its ``metrics`` op, ``fsck --serve`` at the kill naming the
   dead owner's claims and after ``--repair`` every study restored on a
   fresh service; (d) the kernel against its plain version at every
   launch shape of (a)-(c); (c)'s shapes are not recorded in the replica
   processes but derived from an in-process twin serving the same
   studies: every fold of 1 to 4 of its shapes;
13. (after phase 12, before 11f) asynchronous trial farming at
   ``mixed_space()``'s full width, ``tpe.suggest`` on the card: (a)
   ``ThreadTrials(parallelism=4)``, 200 trials of ``mixed_space_fn`` plus
   three fp32 2048x2048 matmuls on each objective's own thread, twice, in
   pairs with the sequential twin (a plain ``Trials`` at
   ``max_queue_len=4``, the same rstate and objective): both runs bitwise
   the twin, 45 ``gmm_llr`` launches each (5 startup asks of 4, then 45
   TPE asks), ms per trial of each; (s) unequal evaluation times (one
   in four sleeps 0.3 s, the others 0.02 s), 32 trials on
   ``ThreadTrials(parallelism=4)`` in blocking rounds and in the
   reference's refill loop (``FMinIter.run(N, block_until_done=False)``),
   twice each: every trial run once, the blocking streams bitwise, ms per
   trial and the threads' busy share of each; (b) ``FileTrials`` with two
   ``hyperopt_tpu_torch.distributed.worker`` processes (started together,
   their start time read from their logs), 100 trials at
   ``max_queue_len=4``, one worker SIGKILLed while it holds a live claim
   (caught by SIGSTOP samples) so that the survivor reruns the reaped job:
   one DONE doc per tid, the stream bitwise the first 100 trials of (a)'s
   twin, 20 launches, ``fsck --dir`` clean; (c) ``asha_filequeue``
   (max_budget 27, eta 3, 40 jobs, 4 in flight) over
   ``budgeted_quadratic_fn`` with the survivor and a replacement worker:
   every job recorded once, one launch per rung-0 ask on 20 or more
   completed trials, ``fsck --dir`` clean, both workers drained by
   SIGTERM with rc 0; (d) the kernel at every launch shape of (a)-(c);
14. (right after phase 9, before any profiler too) the population models
   (``models.transformer``, ``models.resnet``) at their full widths: (a)
   ``bench.py``'s ``bench_pbt`` protocol on TinyLM (vocab 32, d_model 32,
   2 heads, 2 layers, sequences of 32, batches of 32; ``PBT_STUDY_CONFIG``:
   pop 32, ``exploit_every`` 10, cut to 10 rounds of its 20, lr in (1e-4,
   1), wd in (1e-7, 1e-2)): a warm runner (seed 99), then ``runner(seed=0)`` timed:
   member-steps/s, ms per round, the population's nanmedian loss, the
   captured rounds bitwise the eager rounds and the last round's median
   below the first's; (b) ``compile_sha`` on the same TinyLM (32 configs,
   eta 2, 10 steps per rung, 3 rungs down to 8 survivors: a fourth rung of
   80 steps took half the capture, a sixth of 320 steps is a graph of
   some 670,000 kernels): ms per rung
   replay (CUDA events),
   member-steps/s, captured bitwise eager, the best loss at most rung 0's
   best; (c) ``compile_fmin(transformer.device_objective(n_steps=4))`` at
   (a)'s widths, ``hpo_space()``, 256 trials in batches of 16: a warm
   runner's wall and trials/s, one ``gmm_llr`` launch per model step, a
   second ``runner(seed=0)`` bitwise, the best loss below the worst by
   0.1; (d) ``bench.py``'s ``bench_asha_device`` protocol:
   ``asha(budget_objective(), hpo_space(), max_budget=27, eta=3,
   max_jobs=40, workers=4)`` with ``tpe.suggest`` on the card, every rung
   budget captured first, and ``successive_halving(n_configs=27)`` at
   equal jobs: both walls and best losses, one launch per rung-0 ask on
   20 or more completed trials; (e) a population of 8 ``resnet20()``s
   with distinct lr/wd on ``synthetic_cifar_batch(128, 32)``: 10 steps,
   ms per step (CUDA events), member-images/s, finite and distinct
   losses, the best lowered by training; then ``fmin`` over
   ``resnet.population_objective(width=16, image_size=32,
   batch_size=128, n_steps=3)`` with ``tpe.suggest``, 30 trials: ms per
   trial and 10 launches; the kernel at every launch shape of (c)-(e);
   the card's peak allocated memory of each part;
15. (right after phase 14, before any profiler) the BASELINE.json
   configurations #1 (``quadratic1``, 80 trials), #2 (``branin``, 100;
   ``hartmann6``, 150), #3 (the XGBoost surrogate, 100) and #5
   (NAS-Bench-201, 100), each ``fmin`` run with ``tpe.suggest`` on the card
   and with the host TPE (``tpe_host.suggest``) at the battery's seeds 0-4,
   under ``HYPEROPT_TPU_NATIVE=1``: (c) the native host library built into
   the package's ``_build/`` under strict mode; (a) per configuration and
   algorithm the best loss of each seed and their median beside the
   target and the minimum, ms per trial, and the launches (one per TPE
   ask past the 20 startup trials on the card; none on NAS-Bench-201,
   which is all categorical, nor for the host TPE); every trial ``ok``;
   the card's median best at most the target on the three threshold
   domains (the battery's statistic: ``tests/test_domains.py``); (c) the
   library against the numpy oracle at every shape (a) gave it (1e-12
   for the fit, 1e-9 for the log-density); (d) the same ``fmin`` streams
   of ``tpe.suggest`` on the CPU beside the card's, every configuration
   at seeds 0 and 1:
   the first trial at which the two part (a categorical pick differs, or
   a continuous one beyond rtol 1e-4, atol 1e-5), whether it is a startup
   trial, and the pick margin there of each dimension that differs, from
   ``sweep_margins`` on the CPU (the parity rule allows a departure only at
   a near-tie, a margin below 1e-3); (e) the kernel at every launch
   shape of the card's runs; and (b), run after phase 4's window,
   ``bench.py``'s ``bench_host_tpe`` protocol on phase 4's 1000-trial
   history (a warm-up ask, then 15 timed asks of ``tpe_host.suggest``,
   with the native library and with ``_native`` patched to None), beside
   phase 4's time in the card's ``tpe.suggest``;
16. (after phase 13) the port's own checks: (a) ``hyperopt-tpu-torch-lint``
   (``hyperopt_tpu_torch.analysis.cli``) over this tree, the AST pack,
   ``--trace`` and ``--wire`` against the package's committed baseline and
   wire manifest, each exit 0 with 0 findings, its seconds and the Python
   version; (b) the lockdep sanitizer (``analysis.lockdep``) armed on every
   ``BatchScheduler`` built, over phase 7b's serve protocol at 64 studies
   for 3 rounds and phase 11b's burst cut to 16 clients x 8 pipelined asks
   over 4 studies of a ``root=`` background service on binary frames:
   0 inversions, the traced acquisitions and distinct lock orders, then
   disarmed, and the kernel at every launch shape of the two runs.  Only
   the scheduler's one lock is traced, so 16b is a smoke of the arming
   seam, not evidence about lock order.  No timed phase runs with the
   sanitizer armed;
17. (after phase 16) the rank-sharded suggest (``parallel.sharded_suggest``):
   (a) one rank, no process group: a 100-trial ``fmin`` on ``mixed_space()``
   at the reference's defaults (64 candidates per rank, 24 categorical in
   all), one ``gmm_llr`` launch per warm ask; a warm step bitwise
   ``tpe.build_suggest_fn`` at ``fold_in(key, 0)``; the same ``fmin`` on
   the CPU beside it, parting only at a near-tie (15d's rule); (b) two
   ranks spawned on the one card (``parallel.dcn_check.launch``, ``gloo``
   over a ``file://`` store, the packed winners gathered through the
   host: NCCL refuses two ranks on one card), stages A and B at B=256, 32
   candidates per rank: one all-gather per step, 3 launches per rank,
   the KS line, and rank 0's suggestions bitwise two virtual ranks run in
   this process on the card; (c) the kernel at every launch shape of
   both (``launches_by_path`` keys ``sharded_1``, ``sharded_2``; numbers
   under the kernels line's ``sharded``);
18. (after phase 17) the study and population axes inside one process,
   every shard on the one card: (a) phase 7b's serve protocol (64 studies
   of ``mixed_space()``, n_cand 128, 3 startup asks, a warm-up and 6
   timed rounds) unsharded and on 2- and 4-shard study meshes
   (``virtual_mesh``), then one out-of-order tell and a NaN tenant: every
   stream bitwise the unsharded run's, one ``gmm_llr`` launch per shard
   per round, the out-of-order tell rebuilding one shard
   (``shard_restacks``) with fewer upload bytes than the unsharded full
   rebuild, the NaN tenant evicted, ms per round in pairs (unsharded, 4
   shards, 4 shards, unsharded); (b) ``compile_pbt`` (9b's population MLP,
   pop 32 x 10 steps x 20 rounds) and ``compile_sha`` (9b's 16 configs x 2
   replicas) with ``shard_mode="shard_map"`` at 2 and 4 shards against the
   unsharded schedules, captured against eager, two gathers per exploit;
   (c) the kernel at every per-shard fold (``launches_by_path`` and
   ``checked_shapes`` keys ``serve_shard_2``, ``serve_shard_4``; numbers
   under the kernels line's ``study_mesh``).
19. (after phase 15, before any profiler) the compiled loop's and ATPE's
   ``mesh=``, every virtual rank on the one card: (a) phase 8a's
   ``compile_fmin`` at 256 trials with ``mesh=virtual_mesh(4),
   cand_axis="cand"``: 4 ``gmm_llr`` launches per model step inside the
   captured step, the 20 startup trials bitwise the unsharded run's, two
   runs bitwise, the first 64 replayed steps bitwise the eager steps, and
   ms per step in pairs with the unsharded program; (b) the same with
   ``algo="atpe"``; (c) the trial axis (a placement axis, which inside one
   process runs the unsharded body) at 2 and 4 virtual ranks (B=4)
   bitwise the unsharded stream with its launch count, and the 2 x 4
   trial x cand mesh bitwise the cand-only program; (d) ASHA with
   ``trial_axis`` on 1, 2 and 4 virtual ranks on phase 9a's bracket (8
   brackets), on ``mlp_tune`` and on an elementwise trainable: the rung
   sub-mesh (1, 2, 4), each run bitwise the unsharded brackets with
   their launch count; (e) a 60-trial ``fmin`` with
   ``atpe.suggest(mesh=virtual_mesh(4))``, 4 launches per warm ask; (f)
   the kernel at every launch shape of those paths, the per-rank B=1,
   Dg=12, S=32 among them (``launches_by_path`` and ``checked_shapes``
   keys ``compiled_tpe_cand_4``, ``compiled_atpe_cand_4``,
   ``compiled_trial_2``, ``compiled_trial_4``, ``compiled_trial_cand``,
   ``asha_mlp_trial_{1,2,4}``, ``asha_elementwise_trial_{1,2,4}``,
   ``atpe_mesh_fmin``; numbers under the kernels line's
   ``compiled_mesh``).
20. (after phase 19, before any profiler) populations across processes
   and the models' ``mesh=``: (a) ``dcn_check.launch(world=2)``, stages
   A-E on two ``gloo`` ranks sharing the card: C ``compile_fmin`` with
   its ``trial`` axis over the ranks (64 evaluations at B=2, each rank
   evaluating its column, one host gather of the losses per step between
   the step's two graphs), D ``compile_sha`` and E ``compile_pbt`` over
   the ranks (one gather of the losses and one of the states per rung and
   per exploit): each stage run twice, bitwise its unsharded run in the
   ranks and in this process, the gathers per stage, each stage's wall,
   and each rank's ``gmm_llr`` launches in stage C (one per model step);
   (b) TinyLM at ``bench_pbt``'s width (pop 32) and ResNet-20 at 14e's
   (8 members, batch 128) through ``make_population_train_step(mesh=
   virtual_mesh((2, 4), ("trial", "cand")))``, bitwise the step without
   a mesh, ms per step in pairs; (c) ``compile_hyperband(mesh=
   virtual_mesh(4, "trial"))`` (s_max 3, eta 2, 5 steps per rung) on
   9b's population MLP, bitwise the spread without a mesh; (d) the
   kernel at stage C's launch shape B=2, Dg=2, S=24 (``launches_by_path``
   and ``checked_shapes`` key ``dcn_loop_2``; numbers under the kernels
   line's ``population_mesh``).

The last lines are one JSON object per kernel (``{"kernels": [...]}``,
with each path's launches under ``launches_by_path``, the compiled
loop's numbers under ``compiled``, phase 9's under ``schedulers``, phase
10's under ``durable``, phase 11's under ``transport``, phase 12's under
``fleet``, phase 13's under ``farm``, phase 14's under ``population``,
phase 15's under ``baseline``, phase 16's under ``checks``, phase 17's
under ``sharded``, phase 18's under ``study_mesh``, phase 19's under
``compiled_mesh``, phase 20's under ``population_mesh``,
each new path's launch shapes with their errors under
``checked_shapes``, and each phase's seconds under ``phase_seconds``),
the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""

import contextlib
import importlib.util
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# special-function unit throughput (exp2/log2/rcp...) per SM per clock on
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput table)
SFU_PER_SM_PER_CLOCK = 16
# per (candidate, component) term of the EI scoring: z = lat*inv_s - mu_inv_s
# (2), t = cdiff - 0.5*z*z (3), the sum's add and the max (2) -> 7 FP32
# operations, plus one exp on the SFUs
FP32_OPS_PER_TERM = 7

# the kernel's shapes for the 20-dim mixed space (12 unquantized dims):
# the sequential fmin's last asks (B=1; 1000 obs -> a 2048 bucket, below
# padded to 16 + prior, above compacted to 512), suggest_batch at B=64 on
# a 500-obs history (below padded to 8 + prior), and the reference's
# stage batch
FMIN_SHAPE = dict(B=1, Dg=12, S=128, Kb=17, Ka=512)
MAIN_SHAPE = dict(B=64, Dg=12, S=128, Kb=9, Ka=512)
STAGE_SHAPE = dict(B=4096, Dg=12, S=128, Kb=9, Ka=512)
# the serve engine's round at 64 studies of 500 obs: one study's shape is
# the sequential ask's, and the study axis folds into the dim axis
SERVE_SHAPE = dict(N=64, B=1, Dg=12, S=128, Kb=9, Ka=512)
NEAR_TIE = 1e-3


def smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def log(msg):
    print(msg, flush=True)


def cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "cuobjdump")):
            return os.path.join(root, "bin", "cuobjdump")
    return None


def sass_inner_loops(sass):
    """For each kernel in ``cuobjdump -sass`` text, its hot loop: of the
    innermost loops (a backward branch enclosing no other), the one
    with the most ``MUFU.EX2``, as ``(instructions, MUFU.EX2 count)``,
    or None where no loop holds one."""
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;", line)
        if m and name:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    loops = {}
    for name, code in funcs.items():
        back = []
        for addr, ins in code:
            m = re.search(r"\bBRA\b[^;]*?0x([0-9a-f]+)", ins)
            if m and int(m.group(1), 16) <= addr:
                back.append((int(m.group(1), 16), addr))
        best = None
        for lo, hi in back:
            if any((l2, h2) != (lo, hi) and lo <= l2 and h2 <= hi for l2, h2 in back):
                continue
            body = [ins for addr, ins in code if lo <= addr <= hi]
            n_ex2 = sum("MUFU.EX2" in ins for ins in body)
            if n_ex2 and (best is None or n_ex2 > best[1]):
                best = (len(body), n_ex2)
        loops[name] = best
    return loops


def kernel_config(name):
    """``(k_lanes, rows)`` of a mangled ``gmm_llr_kernel<G, R>`` name."""
    m = re.search(r"gmm_llr_kernelILi(\d+)ELi(\d+)E", name)
    return (int(m.group(1)), int(m.group(2))) if m else None


def cuda_ms(fn, warmup=3, reps=7, iters=10):
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_trace(run):
    """Run ``run()`` under ``torch.profiler``; returns the host wall (us)
    and the device's events as ``(start_us, end_us, name)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return wall_us, [(e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events() if e.device_type == DeviceType.CUDA]


def queued_ms(fn, n):
    """Device time of one call of ``fn``: ``n`` calls enqueued behind a
    spin kernel that holds the stream while the host launches them, timed
    by CUDA events -- so the host's launch gaps are not counted, as they
    would be for a small launch on an idle stream.  Median of five."""
    import torch

    fn()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # some 10 ms at the H100's clock
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def device_ms(fn, n, tries=5):
    """Device time of one call of ``fn``: the summed duration of its
    device kernels and copies, over ``n`` calls after a warm-up.  Unlike
    CUDA events around a loop of calls, it does not count the host's
    launch gaps, which dominate a small launch.  The profiler can drop
    events, or a whole trace, so the trace is taken again (up to
    ``tries`` times) until its events are a multiple of ``n`` and at
    least ``n`` times those of one call traced alone.  Where every try
    falls short, the time is :func:`queued_ms`'s, and a line says so."""
    one = []
    for _ in range(tries):
        if not one:
            _, one = device_trace(fn)
            if not one:
                continue
        _, spans = device_trace(lambda: [fn() for _ in range(n)])
        if len(spans) % n == 0 and len(spans) >= n * len(one):
            return sum(e - s for s, e, _ in spans) / n / 1e3
    ms = queued_ms(fn, n)
    log(f"[profiler] {tries} traces of {n} calls fell short of {len(one)} device events "
        f"per call; timed by CUDA events around {n} calls queued behind a spin kernel "
        f"instead: {ms:.4f} ms")
    return ms


def scoring_inputs(shape, seed, device):
    """Candidates and below/above constants of one unquantized group, as
    the main path makes them: Parzen-like mixtures (prior component
    included) through the port's gmm_precompute, candidates in bounds."""
    import numpy as np
    import torch

    from hyperopt_tpu_torch.ops import kernels as TK

    rng = np.random.default_rng(seed)
    B, Dg, S = shape["B"], shape["Dg"], shape["S"]
    logspace = np.arange(Dg) % 3 == 1  # 8 uniform + 4 loguniform at Dg=12
    low = np.full(Dg, -5.0, np.float32)
    high = np.where(logspace, 2.0, 5.0).astype(np.float32)
    pres = []
    for k in (shape["Kb"], shape["Ka"]):
        w = rng.uniform(0.05, 1.0, (Dg, k)).astype(np.float32)
        w /= w.sum(-1, keepdims=True)
        mu = rng.uniform(low[:, None], high[:, None], (Dg, k)).astype(np.float32)
        sig = rng.uniform(0.05, 3.0, (Dg, k)).astype(np.float32)
        t = lambda a: torch.from_numpy(a).to(device)
        pre = TK.gmm_precompute(t(w), t(mu), t(sig), t(low), t(high))
        pres.append({k_: pre[k_].contiguous() for k_ in ("c1", "inv_s", "mu_inv_s", "c1max")})
    nat_lo = np.where(logspace, np.exp(low), low)[None, :, None]
    nat_hi = np.where(logspace, np.exp(high), high)[None, :, None]
    x = rng.uniform(nat_lo, nat_hi, (B, Dg, S)).astype(np.float32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(logspace).to(device),
            pres[0], pres[1])


def plain_chunked(G, x, ls, pb, pa, chunk=256):
    """The plain version over B in chunks (one [chunk, Dg, S, K] term
    tensor at a time: the whole B=4096 one would not fit the card)."""
    import torch

    if x.shape[0] <= chunk:
        return G.gmm_llr_plain(x, ls, pb, pa)
    return torch.cat([G.gmm_llr_plain(x[i:i + chunk], ls, pb, pa)
                      for i in range(0, x.shape[0], chunk)])


def host_ms(fn, n):
    """Host clock per call over ``n`` back-to-back calls (after a
    warm-up), then one synchronize: what a caller waits for a launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return host


def bound(shape, sfu_per_s):
    terms = shape["B"] * shape["Dg"] * shape["S"] * (shape["Kb"] + shape["Ka"])
    n_x = shape["B"] * shape["Dg"] * shape["S"]
    consts = shape["Dg"] * (3 * (shape["Kb"] + shape["Ka"]) + 2) * 4 + shape["Dg"]
    byte_s = (2 * n_x * 4 + consts) / HBM_BYTES_PER_S
    fp32_s = FP32_OPS_PER_TERM * terms / FP32_FLOPS
    sfu_s = terms / sfu_per_s
    ops_s = max(fp32_s, sfu_s)
    return {
        "terms": terms,
        "bound_ms": max(byte_s, ops_s) * 1e3,
        "bound_by": "bytes" if byte_s > ops_s else "operations",
        "bytes_ms": byte_s * 1e3, "fp32_ms": fp32_s * 1e3, "sfu_ms": sfu_s * 1e3,
    }


def profile_asks(it, n, tries=3):
    """Run ``n`` asks (and evaluations) of an FMinIter under
    ``torch.profiler``: see :func:`profile_window`."""
    return profile_window(lambda: it.run(n), n, tries)


def profile_window(run, n, tries=3):
    """Run ``run()`` (``n`` asks or rounds) under ``torch.profiler``: the
    profiled host wall per unit, the device's busy time per unit (union
    of kernel and copy intervals), its launches per unit, and the
    kernels taking the most device time.  A window whose trace holds no
    device event is run again (each window makes ``n`` more units), up to
    ``tries`` windows; None if none was traced."""
    for _ in range(tries):
        wall_us, spans = device_trace(run)
        if spans:
            break
    else:
        return None
    by_name = {}
    busy, end = 0.0, float("-inf")
    for s, e, name in sorted(spans):
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if e > end:
            busy += e - max(s, end)
            end = e
    llr = sum(us for name, us in by_name.items() if "gmm_llr" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {
        "wall_ms": wall_us / n / 1e3, "busy_ms": busy / n / 1e3,
        "kernels_per_ask": len(spans) / n, "llr_ms": llr / n / 1e3,
        "top": [(name[:60], us / n / 1e3) for name, us in top],
    }


def describe_profile(prof, ask_ms):
    """One log clause for :func:`profile_asks`'s window, beside the
    unprofiled ``ask_ms``."""
    if prof is None:
        return "20 more under torch.profiler: no device event traced, so not measured"
    return (f"20 more under torch.profiler: {prof['wall_ms']:.3f} ms per ask, device busy "
            f"{prof['busy_ms']:.3f} ms per ask (idle share {1.0 - prof['busy_ms'] / ask_ms:.4f} "
            f"of the unprofiled ask), {prof['kernels_per_ask']:.1f} device kernels per ask, "
            f"gmm_llr_kernel {prof['llr_ms']:.4f} ms per ask; top device time per ask: "
            + ", ".join(f"{name} {ms:.4f} ms" for name, ms in prof["top"]))


def count_ops(run):
    """Run ``run()`` counting the PyTorch operations it dispatches, by
    the port's module whose code issued each (innermost frame)."""
    import collections
    import os
    import traceback

    from torch.utils._python_dispatch import TorchDispatchMode

    marker = f"hyperopt_tpu_torch{os.sep}"
    counts = collections.Counter()

    class Counting(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            where = next((f.filename.split(marker)[-1] for f in reversed(traceback.extract_stack())
                          if marker in f.filename), "other")
            counts[where] += 1
            return func(*args, **(kwargs or {}))

    with Counting():
        run()
    return counts


def history_trials(domain, n, seed):
    """A Trials store of ``n`` completed prior draws of the domain's space."""
    import hyperopt_tpu_torch as H
    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch.base import Ctrl, JOB_STATE_DONE, spec_from_misc
    from hyperopt_tpu_torch.rand import docs_from_idxs_vals
    from hyperopt_tpu_torch.tpe import _cast_vals
    from hyperopt_tpu_torch.torch_trials import packed_space_for
    from hyperopt_tpu_torch.vectorize import dense_to_idxs_vals

    ps = packed_space_for(domain)
    trials = H.Trials()
    values, active = ps.sample_prior(R.key(seed, device=ps.device), n)
    ids = trials.new_trial_ids(n)
    idxs, vals = _cast_vals(ps, *dense_to_idxs_vals(
        ids, ps.labels, values.cpu().numpy(), active.cpu().numpy()))
    docs = docs_from_idxs_vals(ids, domain, trials, idxs, vals)
    for doc in docs:
        doc["result"] = domain.evaluate(spec_from_misc(doc["misc"]), Ctrl(trials, doc))
        doc["state"] = JOB_STATE_DONE
    trials.insert_trial_docs(docs)
    trials.refresh()
    return trials


def pick_margins(vals, llr):
    """[B, D, S] candidates -> [B, D]: the winning llr minus the best llr
    of a candidate with another value (inf where all agree)."""
    import numpy as np

    best = llr.argmax(-1)
    win_v = np.take_along_axis(vals, best[..., None], -1)
    other = np.where(vals != win_v, llr, -np.inf).max(-1)
    return np.take_along_axis(llr, best[..., None], -1)[..., 0] - other


def sweep_margins(ps, state, key, gamma, prior_weight, n_cont, n_cat, batch, pad_gamma=0.35):
    """The port's own near-tie margin ``[D, B]`` of every factorized pick
    of one ask (TPE's key tree from ``key``), computed where ``state``
    lies -- on the CPU, as the judge of a CUDA pick.  ``pad_gamma`` is
    ATPE's below-set padding (None: TPE's own gamma)."""
    import numpy as np

    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch.ops import kernels as TK

    fits = TK.fit_all_dims(ps.consts, *state, gamma, 25.0, prior_weight, pad_gamma=pad_gamma,
                           above_cap=TK.DEFAULT_ABOVE_CAP)
    dc, dk = len(ps.cont_idx), len(ps.cat_idx)
    keys = R.split(key, batch * (dc + dk))
    out = np.empty((ps.n_dims, batch))
    if dc:
        cv, cl = TK.ei_sweep_cont_scores(ps.q, ps.consts, keys[: batch * dc].reshape(batch, dc, 2),
                                         fits["cont"], n_cont)
        out[ps.cont_idx] = pick_margins(cv.numpy(), cl.numpy()).T
    if dk:
        kv, kl = TK.ei_sweep_cat_scores(keys[batch * dc:].reshape(batch, dk, 2), *fits["cat"],
                                        n_cat)
        out[ps.cat_idx] = pick_margins(kv.numpy(), kl.numpy()).T
    return out


def joint_scores(ps, state, key, n_cand, batch):
    """The port's joint-EI score ``[B, S]`` of every configuration column
    (``tpe.build_suggest_fn(joint_ei=True)``'s body, default settings)."""
    import torch

    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch.ops import kernels as TK

    c = ps.consts
    fits = TK.fit_all_dims(c, *state, 0.25, 25.0, 1.0, above_cap=TK.DEFAULT_ABOVE_CAP)
    dc, dk, D = len(ps.cont_idx), len(ps.cat_idx), ps.n_dims
    keys = R.split(key, batch * (dc + dk))
    cand = torch.zeros((batch, D, n_cand))
    llrs = torch.zeros((batch, D, n_cand))
    v, l = TK.ei_sweep_cont_scores(ps.q, c, keys[: batch * dc].reshape(batch, dc, 2),
                                   fits["cont"], n_cand)
    cand[:, c["cont_idx"]], llrs[:, c["cont_idx"]] = v, l
    v, l = TK.ei_sweep_cat_scores(keys[batch * dc:].reshape(batch, dk, 2), *fits["cat"], n_cand)
    cand[:, c["cat_idx"]], llrs[:, c["cat_idx"]] = v + c["int_low"][None, :, None], l
    act = ps.active_fn(cand.transpose(0, 1).reshape(D, -1)).reshape(D, batch, n_cand)
    return torch.sum(torch.where(act.transpose(0, 1), llrs, 0.0), dim=1).numpy()


def ask_window(it, n, in_suggest, buf):
    """Run ``n`` asks (and evaluations) of an FMinIter whose algo appends
    its own time to ``in_suggest``: the host ms per ask, the ms of it in
    the algo, and the bytes ``buf`` moved to the card per ask."""
    import torch

    in_suggest.clear()
    b0, t0 = buf.transfer_bytes_total, time.perf_counter()
    it.run(n)
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) / n * 1e3, sum(in_suggest) / n * 1e3,
            (buf.transfer_bytes_total - b0) / n)


# 6d's and 6e's trials: cut from 300 to make room for phase 18 (the whole
# script took 1095 s of its 1200 s limit in one run); the checks are unchanged
PHASE6_TRIALS = 150


def phase6(domain, cpu_domain, hist_trials, plain_losses, plain_window):
    """Drive every suggest path besides phase 4's on the card; returns the
    kernel launches of each, counted from 0 just before it.
    ``plain_window()`` runs 20 more of phase 4's asks (:func:`ask_window`),
    to time the fused ask in turns with the plain one."""
    import numpy as np
    import torch

    import hyperopt_tpu_torch as H
    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch.fmin import FMinIter
    from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn
    from hyperopt_tpu_torch.ops import gmm_scores as G
    from hyperopt_tpu_torch.ops import kernels as TK
    from hyperopt_tpu_torch.torch_trials import obs_buffer_for, packed_space_for

    launches = {}

    def run(algo, n, seed=0, trials=None):
        """One sequential fmin on the card with its own Domain; the kernel
        launches it made, its iterator and its trials."""
        trials = H.Trials() if trials is None else trials
        it = FMinIter(algo, H.Domain(mixed_space_fn, mixed_space(), device="cuda"), trials,
                      rstate=np.random.default_rng(seed), max_evals=n, show_progressbar=False)
        G.KERNEL.launches = 0
        t0 = time.perf_counter()
        it.exhaust()
        torch.cuda.synchronize()
        return G.KERNEL.launches, it, trials, time.perf_counter() - t0

    # -- 6a. the fused sequential driver, 1000 trials ----------------------
    n_trials, n_startup = 1000, 20
    fused = H.partial(H.tpe.suggest, fused=True)
    n, it, ftrials, wall = run(fused, n_trials, trials=H.TorchTrials(resident=True))
    launches["fmin_fused"] = n
    (buf,) = ftrials._buffers.values()
    D = buf.space.n_dims
    # one full upload per bucket (128, 256, 512, then 2048 past the 512
    # compaction cap); every warm tell a delta but the three that a bucket
    # change folds into its upload
    buckets = (128, 256, 512, 2048)
    n_deltas = n_trials - n_startup - (len(buckets) - 1)
    want_bytes = sum(buckets) * (5 * D + 5) + n_deltas * (5 * D + 8)
    log(f"[6a] fused fmin {n_trials} trials: wall {wall:.2f} s ({wall / n_trials * 1e3:.2f} ms "
        f"per trial), kernel launches {n}, best loss {min(ftrials.losses()):.6f}; buffer: "
        f"{buf.full_uploads} full uploads, {buf.delta_tells} delta tells, "
        f"{buf.dispatch_count} dispatches, {buf.transfer_bytes_total} bytes "
        f"({buf.transfer_bytes_total / (n_trials - n_startup):.1f} per warm ask)")
    assert ftrials.losses() == plain_losses, "the fused stream is not phase 4's"
    # 980 asks, and the pre-dispatch after the last result (the reference's
    # driver makes it too: 61 dispatches for 60 trials)
    assert n == n_trials - n_startup + 1, n
    assert (buf.full_uploads, buf.delta_tells, buf.dispatch_count) == (
        len(buckets), n_deltas, n_trials + 1), (buf.full_uploads, buf.delta_tells)
    assert buf.transfer_bytes_total == want_bytes, (buf.transfer_bytes_total, want_bytes)
    st = it.domain._ask_ahead_state
    assert it.domain._ask_ahead_hook is not None, "the ask-ahead hook was removed"
    assert st["taken"] == n_trials - 1, st["taken"]  # every ask after the first
    # where an ask's time goes, as phase 4 measures it
    in_suggest = []

    def timed_fused(*args):
        t = time.perf_counter()
        docs = fused(*args)
        in_suggest.append(time.perf_counter() - t)
        return docs

    pit = FMinIter(timed_fused, H.Domain(mixed_space_fn, mixed_space(), device="cuda"),
                   ftrials, rstate=np.random.default_rng(1), show_progressbar=False)
    pit.run(3)
    (pbuf,) = [b for b in ftrials._buffers.values() if b is not buf]  # pit's own space
    hook, in_hook = pit.domain._ask_ahead_hook, []

    def timed_hook(trials, seed):  # the hook enqueues the fused tell+ask
        t = time.perf_counter()
        hook(trials, seed)
        in_hook.append(time.perf_counter() - t)

    pit.domain._ask_ahead_hook = timed_hook
    # 20-ask windows in turns with phase 4's plain asks, on the same card
    turns = [(name, *(plain_window() if name == "plain" else
                      ask_window(pit, 20, in_suggest, pbuf)))
             for name in ("plain", "fused", "fused", "plain", "plain", "fused")]
    median = {name: statistics.median(a for n_, a, _, _ in turns if n_ == name)
              for name in ("plain", "fused")}
    log("[6a] 20-ask windows in turns at about 1000 obs, (ms per ask and evaluation, ms in "
        "tpe.suggest, bytes moved per ask): " + "; ".join(
            f"{name} ({a:.3f}, {b:.3f}, {c:.1f})" for name, a, b, c in turns)
        + f"; median ms per ask: plain {median['plain']:.3f}, fused {median['fused']:.3f}; "
        f"the fused asks' hook took {sum(in_hook) / len(in_hook) * 1e3:.3f} ms per ask")
    pit.domain._ask_ahead_hook = hook
    ask_ms = median["fused"]
    prof = profile_asks(pit, 20)
    log(f"[6a] fused asks: the ask's work runs in the ask-ahead hook after the tell, "
        f"tpe.suggest only fetches the draw; " + describe_profile(prof, ask_ms))
    ops = count_ops(lambda: pit.run(5))
    log(f"[6a] PyTorch operations per fused ask: {sum(ops.values()) / 5:.1f}; by module: "
        + ", ".join(f"{m} {c / 5:.1f}" for m, c in ops.most_common()))

    # -- 6b. joint EI at B=64 on the phase-3 history -----------------------
    batch = 64
    G.KERNEL.launches = 0
    t0 = time.perf_counter()
    for i in range(5):
        H.tpe.suggest_batch(list(range(500, 500 + batch)), domain, hist_trials, 40 + i,
                            joint_ei=True)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 5
    launches["joint_b64"] = G.KERNEL.launches
    assert G.KERNEL.launches == 5, G.KERNEL.launches
    picks = {}
    for name, d in (("cuda", domain), ("cpu", cpu_domain)):
        ps = packed_space_for(d)
        state = obs_buffer_for(d, hist_trials).device_arrays(pow2_cap=TK.DEFAULT_ABOVE_CAP)
        fn = H.tpe.build_suggest_fn(ps, 128, 0.25, 25, 1.0, joint_ei=True)
        v, a = fn(R.key(2024, device=ps.device), *state, batch)
        picks[name] = (v.cpu().numpy(), a.cpu().numpy())
    ps = packed_space_for(cpu_domain)
    state = obs_buffer_for(cpu_domain, hist_trials).device_arrays(pow2_cap=TK.DEFAULT_ABOVE_CAP)
    joint = joint_scores(ps, state, R.key(2024), 128, batch)
    (gv, ga), (cv, ca) = picks["cuda"], picks["cpu"]
    same = np.all(np.isclose(gv, cv, rtol=1e-4, atol=1e-5), axis=0)
    top2 = np.sort(joint, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    bad = int((~same & (margin >= NEAR_TIE)).sum())
    log(f"[6b] joint_ei suggest_batch B={batch} on 500 obs: {dt * 1e3:.2f} ms per call "
        f"({batch / dt:.1f} suggestions/s), {launches['joint_b64']} kernel launches in 5 calls; "
        f"CUDA vs CPU: {int(same.sum())} of {batch} columns equal, {int((~same).sum())} "
        f"differ, {bad} not near-ties (joint margin >= {NEAR_TIE})")
    assert bad == 0 and np.array_equal(ga[:, same], ca[:, same])

    # -- 6c. speculative=4, 200 trials -------------------------------------
    k = 4
    n, it, strials, wall = run(H.partial(H.tpe.suggest, speculative=k), 200)
    launches["speculative"] = n
    dispatches = obs_buffer_for(it.domain, strials).dispatch_count
    warm_draws = dispatches - n_startup // k  # the startup draws are the prior's
    log(f"[6c] speculative={k} fmin 200 trials: wall {wall:.2f} s, {dispatches} draws "
        f"({warm_draws} warm), kernel launches {n}, best loss {min(strials.losses()):.6f}")
    assert n == warm_draws == (200 - n_startup) // k, (n, warm_draws)

    # -- 6d. annealing, resident and not -----------------------------------
    streams = {}
    for resident in (None, True):
        n, it, atrials, wall = run(H.partial(H.anneal.suggest, resident=resident),
                                   PHASE6_TRIALS, seed=3)
        launches["anneal" + ("_resident" if resident else "")] = n
        streams[resident] = atrials.losses()
        log(f"[6d] anneal fmin {PHASE6_TRIALS} trials (resident={resident}): wall {wall:.2f} s, "
            f"best loss {min(atrials.losses()):.6f}, kernel launches {n}")
        assert n == 0, n
    assert streams[None] == streams[True], "the resident anneal stream differs"
    ops = count_ops(lambda: it.run(5))
    log(f"[6d] PyTorch operations per anneal ask: {sum(ops.values()) / 5:.1f}; by module: "
        + ", ".join(f"{m} {c / 5:.1f}" for m, c in ops.most_common()))

    # -- 6e. ATPE: the sequential driver, and the device fn at B=64 --------
    n, it, ttrials, wall = run(H.atpe.suggest, PHASE6_TRIALS, seed=4)
    launches["atpe"] = n
    log(f"[6e] atpe fmin {PHASE6_TRIALS} trials: wall {wall:.2f} s "
        f"({wall / PHASE6_TRIALS * 1e3:.2f} ms per trial), "
        f"best loss {min(ttrials.losses()):.6f}, kernel launches {n}")
    assert n == PHASE6_TRIALS - n_startup, n
    picks = {}
    for name, d in (("cuda", domain), ("cpu", cpu_domain)):
        ps = packed_space_for(d)
        state = obs_buffer_for(d, hist_trials).device_arrays(pow2_cap=TK.DEFAULT_ABOVE_CAP)
        fn = H.atpe.build_atpe_device_fn(ps, 25.0)
        v, a = fn(R.key(77, device=ps.device), *state, batch)
        g, pw, *_ = fn.settings(state.losses, state.valid)
        picks[name] = (v.cpu().numpy(), a.cpu().numpy(), float(g), float(pw))
    (gv, ga, gg, gpw), (cv, ca, cg, cpw) = picks["cuda"], picks["cpu"]
    assert (gg, gpw) == (cg, cpw), ((gg, gpw), (cg, cpw))
    ps = packed_space_for(cpu_domain)
    state = obs_buffer_for(cpu_domain, hist_trials).device_arrays(pow2_cap=TK.DEFAULT_ABOVE_CAP)
    margins = sweep_margins(ps, state, R.split(R.key(77), 3)[0], torch.tensor(cg),
                            torch.tensor(cpw), 256, 24, batch)
    cat = np.zeros(ps.n_dims, bool)
    cat[ps.cat_idx] = True
    same = np.where(cat[:, None], gv == cv, np.isclose(gv, cv, rtol=1e-4, atol=1e-5))
    bad = int((~same & (margins >= NEAR_TIE)).sum())
    log(f"[6e] build_atpe_device_fn B={batch} on 500 obs (gamma {cg}, prior weight {cpw}): "
        f"CUDA vs CPU picks agree {same.mean():.6f}, {int((~same).sum())} differ, {bad} not "
        f"near-ties (margin >= {NEAR_TIE})")
    assert bad == 0 and np.array_equal(ga, ca)

    # -- 6f. random search, speculative=4 ----------------------------------
    n, it, rtrials, wall = run(H.partial(H.rand.suggest, speculative=k), 100)
    launches["rand"] = n
    draws = it.domain._rand_draws
    log(f"[6f] rand speculative={k} fmin 100 trials: wall {wall:.2f} s, {draws} prior draws, "
        f"kernel launches {n}")
    assert draws == 100 // k and n == 0, (draws, n)
    assert all(np.all(np.isfinite(t.losses())) for t in (ftrials, strials, ttrials, rtrials))
    return launches


SERVE_STUDIES = 64


def serve_loss(vals):
    """bench.py's serve loss: the sum of a configuration's values."""
    return sum(float(v) for v in vals.values() if isinstance(v, (int, float)))


def stacked_scoring_inputs(shape, seed, device):
    """``shape["N"]`` studies' :func:`scoring_inputs` (seeds ``seed + i``),
    stacked along a leading study axis; also each study's own inputs."""
    import torch

    from hyperopt_tpu_torch.ops import gmm_scores as G

    per = [scoring_inputs(shape, seed + i, device) for i in range(shape["N"])]
    stack = lambda j: {k: torch.stack([p[j][k] for p in per]) for k in G._PRE_KEYS}  # noqa: E731
    return torch.stack([p[0] for p in per]), per[0][1], stack(2), stack(3), per


def serve_round(svc, handles, streams=None):
    """One serve round: every study asks, one pump serves them all, every
    study tells its loss."""
    futs = [h.ask_async() for h in handles]
    assert svc.pump() == len(handles)
    for h, f in zip(handles, futs):
        tid, vals = f.result(timeout=120)
        if streams is not None:
            streams.setdefault(h.name, []).append(vals)
        h.tell(tid, serve_loss(vals))


def serve_histories(ps, n_studies, n_obs, seed):
    """``n_obs`` prior draws per study, as configurations to tell."""
    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch.serve.scheduler import dense_to_vals

    out = []
    for i in range(n_studies):
        v, a = (t.cpu().numpy() for t in ps.sample_prior(R.key(seed + i, device=ps.device), n_obs))
        out.append([dense_to_vals(ps, v[:, t], a[:, t]) for t in range(n_obs)])
    return out


def open_service(n_studies, histories=None, mesh=None):
    """A service on the card at the bench's serve settings, ``n_studies``
    studies (seeds 0..n-1), each first told its history, if any; ``mesh``
    shards its study slots."""
    from hyperopt_tpu_torch.models.synthetic import mixed_space
    from hyperopt_tpu_torch.serve import SuggestService

    svc = SuggestService(mixed_space(), max_batch=max(n_studies, 4), background=False,
                         n_startup_jobs=3, n_cand=128, mesh=mesh)
    handles = [svc.create_study(f"bench{i:03d}", seed=i) for i in range(n_studies)]
    for h, hist in zip(handles, histories or ()):
        for tid, vals in enumerate(hist):
            h.tell(tid, serve_loss(vals), vals=vals)
    return svc, handles


def stacked_vs_solo(ps, state, keys, n_cand):
    """Which step of the TPE body gives a study of the stacked state other
    bits than the same study alone: for each fit tensor and for the
    candidates and their llrs, the number of studies that differ."""
    import collections

    import torch

    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch.ops import kernels as TK

    c = ps.consts
    dc = len(ps.cont_idx)
    fit = lambda st: TK.fit_all_dims(c, *st, 0.25, 25.0, 1.0,  # noqa: E731
                                     above_cap=TK.DEFAULT_ABOVE_CAP)
    stacked = fit(state)
    cont_keys = R.split(keys, dc + len(ps.cat_idx))[:, :dc].reshape(-1, 1, dc, 2)
    cand = TK.ei_sweep_cont_candidates(ps.q, c, cont_keys, stacked["cont"], n_cand)
    differ = collections.Counter()
    for i in range(keys.shape[0]):
        solo = fit(tuple(t[i] for t in state))
        named = list(zip(("wb", "mb", "sb", "wa", "ma", "sa"), stacked["cont"], solo["cont"]))
        named += list(zip(("pb", "pa"), stacked["cat"], solo["cat"]))
        one = TK.ei_sweep_cont_candidates(ps.q, c, cont_keys[i], solo["cont"], n_cand)
        named += [("samples", cand[0], one[0]), ("llr", cand[1], one[1])]
        for name, a, b in named:
            differ[name] += 0 if torch.equal(a[i], b) else 1
    return dict(differ)


def reduction_probe(n, seed=0):
    """Which reductions and scans over a history or component axis give
    one slice of a stacked tensor other bits than the same slice alone,
    on the card: each op on random data at the serve round's shapes
    (``n`` studies, 14 continuous and 6 categorical dims, a 512-wide
    history), with the number of slices that differ -- PyTorch's own ops,
    and the fixed-order ones the port's fits use in their place
    (``sum_rows``/``cumsum_rows``)."""
    import torch

    from hyperopt_tpu_torch.ops import kernels as TK

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    cases = {
        "sum dim -1 [n,14,513] (parzen_fit's normalisation)": (
            lambda t: torch.sum(t, dim=-1, keepdim=True),
            lambda t: TK.sum_rows(t, dim=-1, keepdim=True), (n, 14, 513)),
        "cumsum dim -1 [n,14,512] (gmm_precompute)": (
            lambda t: torch.cumsum(t, dim=-1), lambda t: TK.cumsum_rows(t, dim=-1),
            (n, 14, 512)),
        "cumsum dim -2 [n,14,513,5] (compact_gmm)": (
            lambda t: torch.cumsum(t, dim=-2), lambda t: TK.cumsum_rows(t, dim=-2),
            (n, 14, 513, 5)),
        "sum dim -2 [n,6,512,8] (categorical_fit's counts)": (
            lambda t: torch.sum(t, dim=-2), lambda t: TK.sum_rows(t, dim=-2), (n, 6, 512, 8)),
        "sum dim -1 [n,6,8] (categorical_fit's normalisation)": (
            lambda t: torch.sum(t, dim=-1, keepdim=True),
            lambda t: TK.sum_rows(t, dim=-1, keepdim=True), (n, 6, 8)),
        "sum dim -1 [n,1,2,128,512] (gmm_logpdf_quant_pre)": (
            lambda t: torch.sum(t, dim=-1), lambda t: TK.sum_rows(t, dim=-1),
            (n, 1, 2, 128, 512)),
    }
    torch_ops, port_ops = {}, {}
    for name, (torch_fn, port_fn, shape) in cases.items():
        x = torch.rand(shape, device=dev, generator=g)
        for out, fn in ((torch_ops, torch_fn), (port_ops, port_fn)):
            full = fn(x)
            out[name] = sum(0 if torch.equal(full[i], fn(x[i])) else 1 for i in range(n))
    return torch_ops, port_ops


def phase7(cpu_domain, sfu_per_s, n_sms):
    """The study-batched serve engine on the card; returns the kernel
    launches of its paths (each counted from 0 just before it) and the
    kernel's record at the serve shape."""
    import numpy as np
    import torch

    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch import tpe as T
    from hyperopt_tpu_torch.ops import gmm_scores as G
    from hyperopt_tpu_torch.serve.scheduler import dense_to_vals
    from hyperopt_tpu_torch.torch_trials import ObsBuffer, packed_space_for

    dev = torch.device("cuda")
    launches = {}

    # -- 7a. the kernel at the stacked shape ------------------------------
    shape = SERVE_SHAPE
    n, dg, S = shape["N"], shape["Dg"], shape["S"]
    x, ls, pb, pa, per = stacked_scoring_inputs(shape, seed=900, device=dev)
    G.KERNEL.launches = 0
    folded = G.gmm_llr_stacked(x, ls, pb, pa)
    assert G.KERNEL.launches == 1, G.KERNEL.launches
    solo = torch.stack([G.gmm_llr(*p) for p in per])
    torch.cuda.synchronize()
    n_bitwise = sum(bool(torch.equal(folded[i], solo[i])) for i in range(n))
    fold = lambda pre: {k: pre[k].reshape((n * dg,) + tuple(pre[k].shape[2:]))  # noqa: E731
                        for k in G._PRE_KEYS}
    xf, lsf, pbf, paf = x.reshape(1, n * dg, S), ls.repeat(n), fold(pb), fold(pa)
    want = G.gmm_llr_plain(xf, lsf, pbf, paf).reshape(folded.shape)
    max_abs = float((folded - want).abs().max())
    ok = torch.allclose(folded, want, rtol=G.KERNEL_RTOL, atol=G.KERNEL_ATOL)
    argmax_agree = float((folded.argmax(-1) == want.argmax(-1)).float().mean())
    forced = G.launch_config(shape["B"] * S, dg, n_sms)
    by_shape = G.launch_config(shape["B"] * S, n * dg, n_sms)
    out = torch.empty_like(xf)
    by_config = {c: device_ms(lambda c=c: G.launch(xf, lsf, pbf, paf, out, c), 10)
                 for c in G.CONFIGS}
    best = min(by_config, key=by_config.get)
    plain_ms = device_ms(lambda: G.gmm_llr_plain(xf, lsf, pbf, paf), 5)
    call_host_ms = host_ms(lambda: G.gmm_llr_stacked(x, ls, pb, pa), 200)
    ms = by_config[forced]  # the wrapper's one kernel launch, at the split it forces
    b = bound(dict(B=shape["B"], Dg=n * dg, S=S, Kb=shape["Kb"], Ka=shape["Ka"]), sfu_per_s)
    log(f"[7a] gmm_llr_stacked {shape} (folded to [1, {n * dg}, {S}]): one launch; "
        f"{n_bitwise} of {n} studies bitwise their own gmm_llr launch; max_abs_err "
        f"{max_abs:.3e} against the plain version, argmax agreement {argmax_agree:.6f}; "
        f"plain version {plain_ms:.4f} ms device time, wrapper host time per call "
        f"{call_host_ms:.4f} ms; bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']}; the split is forced from one study's "
        f"shape to {forced} (the folded shape alone would pick {by_shape}); kernel device ms "
        "by (k_lanes, rows): " + ", ".join(f"{c} {t:.4f}" for c, t in by_config.items())
        + f"; forced {by_config[forced]:.4f} ms at {b['bound_ms'] / by_config[forced]:.3f} of "
        f"the bound, best {best} {by_config[best]:.4f} ms at "
        f"{b['bound_ms'] / by_config[best]:.3f}")
    assert n_bitwise == n, "the folded launch is not bitwise the per-study launches"
    assert ok and argmax_agree >= 0.999, (max_abs, argmax_agree)
    result = dict(B=shape["B"], N=n, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                  config=forced, host_ms=call_host_ms, forced_ms=by_config[forced],
                  best_config=best, best_ms=by_config[best], **b)
    del x, ls, pb, pa, per, folded, solo, xf, lsf, pbf, paf, want, out
    torch.cuda.empty_cache()

    # -- 7b. bench.py's serve protocol at 64 studies, and one study -------
    def bench(n_studies, rounds, streams=None):
        svc, handles = open_service(n_studies)
        G.KERNEL.launches = 0
        serve_round(svc, handles, streams)  # warm-up: the first materialization
        lat0 = len(svc.scheduler.ask_latencies)
        t0 = time.perf_counter()
        for _ in range(rounds):
            serve_round(svc, handles, streams)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_launch = G.KERNEL.launches
        lats = sorted(1e3 * t for t in list(svc.scheduler.ask_latencies)[lat0:])
        occ = list(svc.scheduler.occupancy)[-rounds:]
        counters = svc.counters
        svc.shutdown()
        return svc.ps, n_studies * rounds / dt, lats, occ, n_launch, counters

    rounds = 6
    streams = {}
    ps, rate, lats, occ, n_launch, counters = bench(SERVE_STUDIES, rounds, streams)
    launches["serve_64"] = n_launch
    _, solo_rate, _, _, solo_launch, _ = bench(1, 24)
    pct = lambda p: lats[min(len(lats) - 1, int(p * len(lats)))]  # noqa: E731
    log(f"[7b] serve {SERVE_STUDIES} studies of mixed_space(), n_cand 128, 3 startup asks, "
        f"1 warm-up and {rounds} timed rounds: {rate:.1f} asks/s across studies, ask latency "
        f"p50 {pct(0.5):.3f} ms p99 {pct(0.99):.3f} ms, occupancy {float(np.mean(occ)):.4f}; "
        f"the same engine at one study: {solo_rate:.1f} asks/s (speedup "
        f"{rate / solo_rate:.2f}x); gmm_llr launches {n_launch} in {rounds + 1} rounds "
        f"(one study: {solo_launch} in 25); counters {counters}")
    assert n_launch == rounds + 1 and solo_launch == 25, (n_launch, solo_launch)
    assert counters["dispatch_count"] == rounds + 1 and counters["upload_events"] == 1
    assert occ == [1.0] * rounds
    serve = dict(asks_per_s=rate, p50_ms=pct(0.5), p99_ms=pct(0.99),
                 occupancy=float(np.mean(occ)), solo_asks_per_s=solo_rate)

    # -- 7c. 64 studies at 500 observations each: where a round's time goes
    histories = serve_histories(ps, SERVE_STUDIES, 500, seed=7000)
    svc, handles = open_service(SERVE_STUDIES, histories)
    warm_streams = {}
    for _ in range(3):  # the first: the materialization at the 512 bucket
        serve_round(svc, handles, warm_streams)
    assert svc.scheduler._bucket == 512, svc.scheduler._bucket
    # counted at the 512 bucket, as 7d's 4 studies are: the fixed-order sums
    # take one add per halving of the history axis, so the operations per
    # round follow the bucket (the timed rounds below grow past it)
    ops64 = count_ops(lambda: [serve_round(svc, handles) for _ in range(2)])
    per_round_64 = sum(ops64.values()) / 2
    G.KERNEL.launches = 0
    t0 = time.perf_counter()
    for _ in range(20):
        serve_round(svc, handles)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) / 20 * 1e3
    llr_per_round = G.KERNEL.launches / 20
    prof = profile_window(lambda: [serve_round(svc, handles) for _ in range(20)], 20)
    bucket_after = svc.scheduler._bucket
    state = svc.scheduler._state
    keys = torch.stack([R.key(11 + i, device=dev) for i in range(SERVE_STUDIES)])
    differ = stacked_vs_solo(svc.ps, state, keys, 128)
    torch_probe, probe = reduction_probe(SERVE_STUDIES)
    log(f"[7c] {SERVE_STUDIES} studies at about 520 observations (bucket 512, K_below 9, "
        f"K_above 512): {round_ms:.3f} ms per round ({SERVE_STUDIES / round_ms * 1e3:.1f} asks/s); "
        + ("20 rounds under torch.profiler: no device event traced, so not measured"
           if prof is None else
           f"20 rounds under torch.profiler: {prof['wall_ms']:.3f} ms per round, device busy "
           f"{prof['busy_ms']:.3f} ms per round (idle share "
           f"{1.0 - prof['busy_ms'] / round_ms:.4f} of the unprofiled round), "
           f"{prof['kernels_per_ask']:.1f} device kernels per round, gmm_llr_kernel "
           f"{prof['llr_ms']:.4f} ms per round; top device time per round: "
           + ", ".join(f"{nm} {t:.4f} ms" for nm, t in prof["top"]))
        + f"; bucket after the timed rounds {bucket_after}; gmm_llr launches per round "
        f"{llr_per_round:.2f}; PyTorch operations per round at the 512 bucket "
        f"{per_round_64:.1f}; by module: "
        + ", ".join(f"{m} {c / 2:.1f}" for m, c in ops64.most_common())
        + f"; studies whose stacked TPE step differs from the same study alone, by tensor: "
        f"{differ}; slices of a stacked reduction that differ from the slice alone, by op: "
        f"the port's fixed-order ones {probe}, PyTorch's own {torch_probe}")
    assert llr_per_round == 1.0, llr_per_round
    assert not any(differ.values()), f"stacked slices differ from the study alone: {differ}"
    assert not any(probe.values()), f"a fixed-order reduction depends on the rows: {probe}"
    svc.shutdown()
    serve.update(round_ms=round_ms, ops_per_round=per_round_64,
                 busy_ms=None if prof is None else prof["busy_ms"],
                 kernels_per_round=None if prof is None else prof["kernels_per_ask"])

    # -- 7d. the same round at 4 studies: the same operations -------------
    svc, handles = open_service(4, histories[:4])
    serve_round(svc, handles)
    G.KERNEL.launches = 0
    ops4 = count_ops(lambda: [serve_round(svc, handles) for _ in range(2)])
    launches["serve_4"] = G.KERNEL.launches
    svc.shutdown()
    per_round_4 = sum(ops4.values()) / 2
    log(f"[7d] PyTorch operations per round: {per_round_4:.1f} at 4 studies, "
        f"{per_round_64:.1f} at {SERVE_STUDIES}; gmm_llr launches {launches['serve_4']} in 2 "
        "rounds at 4 studies")
    assert per_round_4 == per_round_64, (ops4, ops64)
    assert launches["serve_4"] == 2

    # -- 7e. every study's stream against its solo fused stream -----------
    plain = T.build_suggest_fn(ps, 128, 0.25, 25.0, 1.0)
    fused = T.build_suggest_fn(ps, 128, 0.25, 25.0, 1.0, state_io=True)
    cpu_ps = packed_space_for(cpu_domain)

    def against_solo(streams, histories):
        """Each study's served stream against its solo fused stream (the
        same seeds, the same history first): the studies bitwise equal,
        and each first divergence with the CPU's llr margin of every
        differing dim."""
        n_equal, diverged = 0, []
        for i in range(SERVE_STUDIES):
            told = [(v, serve_loss(v)) for v in (histories[i] if histories else ())]
            buf = ObsBuffer(ps, resident=True)
            for v, loss in told:
                buf.add(dict(v), loss)
            rstate = np.random.default_rng(i)
            for k, vals in enumerate(streams[f"bench{i:03d}"]):
                seed = int(rstate.integers(2**31 - 1)) % (2**31 - 1)
                key = R.key(seed, device=dev)
                out_ = (ps.sample_prior(key, 1) if buf.count < 3
                        else T._state_dispatch(buf, key, 1, 512, plain, fused))
                got = dense_to_vals(ps, out_[0][:, 0].cpu().numpy(), out_[1][:, 0].cpu().numpy())
                if got != vals:
                    labels = sorted(l for l in got if got[l] != vals.get(l))
                    cbuf = ObsBuffer(cpu_ps)
                    for v, loss in told:
                        cbuf.add(dict(v), loss)
                    margins = sweep_margins(cpu_ps, cbuf.device_arrays(pow2_cap=512),
                                            R.key(seed), 0.25, 1.0, 128, 128, 1,
                                            pad_gamma=None)[:, 0]
                    diverged.append((i, k, {l: float(margins[cpu_ps.labels.index(l)])
                                            for l in labels}))
                    break
                buf.add(dict(got), serve_loss(got))
                told.append((got, serve_loss(got)))
            else:
                n_equal += 1
        return n_equal, diverged

    n_equal, diverged = against_solo(streams, None)
    n_equal_500, diverged_500 = against_solo(warm_streams, histories)
    bad = [d for d in diverged + diverged_500 if any(m >= NEAR_TIE for m in d[2].values())]
    log(f"[7e] streams bitwise their solo fused streams on the card: {n_equal} of "
        f"{SERVE_STUDIES} studies over 7b's {rounds + 1} asks from an empty history, "
        f"{n_equal_500} of {SERVE_STUDIES} over 7c's first 3 asks after 500 told trials; "
        f"divergences (study, ask, CPU llr margin of each differing dim): {diverged} and "
        f"{diverged_500}; not near-ties: {bad}")
    assert not bad, bad
    assert n_equal == n_equal_500 == SERVE_STUDIES, (n_equal, n_equal_500)
    serve.update(n_bitwise_streams=n_equal, n_bitwise_streams_500=n_equal_500)
    return launches, result, serve


# the compiled loop's experiments: bench.py's bench_compiled_at_1k (the
# sequential 1000-trial run, whose model steps score phase 2's fmin shape
# at a 1024-slot carry) and bench_mlp_tune (512 trials of an 8-epoch MLP,
# batch 32; its model steps score 4 dims x 24 candidates at a 512-slot
# carry: below padded to 8 + prior, above compacted to 512)
COMPILED_TRIALS = 1000
SWEEP_SEEDS, SWEEP_TRIALS = 8, 256
# each new path's launch shapes, held against the plain version by
# check_shapes: {path: [{shape..., "max_abs_err"}]}
CHECKED_SHAPES = {}
MLP_SHAPE = dict(B=32, Dg=4, S=24, Kb=9, Ka=512)


def compiled_launches(prog):
    """``gmm_llr`` launches of a compiled run: the kernel's wrapper counts
    once per launch it records while a step is captured, so a run's
    launches are each regime's captured count times its replays."""
    return sum(prog.launches_per_replay.get(r, 0) * n for r, n in prog.replays.items())


def kernel_at(shape, seed, sfu_per_s):
    """The kernel against its plain version at ``shape`` on the card, now
    (no profiler); returns its record and a function that times it
    later (``device_ms`` traces with ``torch.profiler``, so the timing
    waits for the profiler-free phases to end) and fills the record."""
    import torch

    from hyperopt_tpu_torch.ops import gmm_scores as G

    x, ls, pb, pa = scoring_inputs(shape, seed=seed, device=torch.device("cuda"))
    got = G.gmm_llr(x, ls, pb, pa)
    want = G.gmm_llr_plain(x, ls, pb, pa)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    assert torch.allclose(got, want, rtol=G.KERNEL_RTOL, atol=G.KERNEL_ATOL), \
        f"the kernel disagrees with the plain version at {shape}: {max_abs}"
    cfg = G.launch_config(shape["B"] * shape["S"], shape["Dg"],
                          torch.cuda.get_device_properties(0).multi_processor_count)
    record = dict(B=shape["B"], max_abs_err=max_abs, config=cfg, **bound(shape, sfu_per_s))

    def time_it(tag):
        record["ms"] = ms = device_ms(lambda: G.gmm_llr(x, ls, pb, pa), 20)
        record["plain_ms"] = device_ms(lambda: G.gmm_llr_plain(x, ls, pb, pa), 10)
        record["host_ms"] = host_ms(lambda: G.gmm_llr(x, ls, pb, pa), 200)
        log(f"[{tag}] the kernel at {shape}: device time {ms:.4f} ms (plain "
            f"{record['plain_ms']:.4f} ms), wrapper host time {record['host_ms']:.4f} ms, split "
            f"{cfg}, bound {record['bound_ms']:.5f} ms by {record['bound_by']} "
            f"({record['bound_ms'] / ms:.3f} of it), max_abs_err {max_abs:.3e}")

    return record, time_it


@contextlib.contextmanager
def launch_shapes():
    """Record the shape of every ``gmm_llr`` launch made inside the block
    into the set it yields: ``(B, Dg, S, K_below, K_above, split_dims)``
    of the launch as the wrapper makes it (a stacked launch folds its
    studies into ``Dg`` and splits over one study's ``split_dims``).  A
    compiled program records at capture, where its launches are made.
    The launches and their count are unchanged."""
    from hyperopt_tpu_torch.ops import gmm_scores as G

    seen, real = set(), G._launch_checked

    def recording(x, logspace, pre_b, pre_a, split_dims):
        B, Dg, S = x.shape
        seen.add((B, Dg, S, pre_b["c1"].shape[-1], pre_a["c1"].shape[-1], split_dims))
        return real(x, logspace, pre_b, pre_a, split_dims)

    G._launch_checked = recording
    try:
        yield seen
    finally:
        G._launch_checked = real


def check_shapes(path, shapes, seed):
    """The kernel against its plain version on the card at each launch
    shape that :func:`launch_shapes` recorded on ``path``, on fresh
    inputs of that shape: a stacked launch through ``gmm_llr_stacked``,
    its studies folded as the wrapper folds them.  Returns the shapes
    with their max errors; fails on a disagreement."""
    import torch

    from hyperopt_tpu_torch.ops import gmm_scores as G

    dev = torch.device("cuda")
    checked = []
    assert shapes, f"{path}: no launch shape was recorded"
    for B, dg_all, S, kb, ka, dg in sorted(shapes):
        n = dg_all // dg
        shape = dict(N=n, B=B, Dg=dg, S=S, Kb=kb, Ka=ka)
        if n == 1:
            x, ls, pb, pa = scoring_inputs(shape, seed, dev)
            got, want = G.gmm_llr(x, ls, pb, pa), G.gmm_llr_plain(x, ls, pb, pa)
        else:
            x, ls, pb, pa, _ = stacked_scoring_inputs(shape, seed, dev)
            got = G.gmm_llr_stacked(x, ls, pb, pa)
            fold = lambda pre: {k: pre[k].reshape((n * dg,) + tuple(pre[k].shape[2:]))  # noqa: E731
                                for k in G._PRE_KEYS}
            want = G.gmm_llr_plain(x.transpose(0, 1).reshape(B, n * dg, S), ls.repeat(n),
                                   fold(pb), fold(pa)).reshape(B, n, dg, S).transpose(0, 1)
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, rtol=G.KERNEL_RTOL, atol=G.KERNEL_ATOL)
        log(f"[{path}] the kernel at the path's launch shape {shape}: max_abs_err "
            f"{max_abs:.3e} against the plain version")
        assert ok, f"{path}: the kernel disagrees with the plain version at {shape}: {max_abs}"
        checked.append(dict(shape, max_abs_err=max_abs))
    return checked


def phase8(sfu_per_s):
    """The compiled loop on the card; returns the kernel launches of its
    paths (counted from their replays), the kernel's record at the mlp
    shape, and the loop's numbers."""
    import tempfile

    import numpy as np
    import torch

    import hyperopt_tpu_torch as H
    from hyperopt_tpu_torch.device_loop import _to_trials, compile_fmin
    from hyperopt_tpu_torch.distributed.faults import FaultPlan, SimulatedCrash
    from hyperopt_tpu_torch.models.synthetic import (mixed_space, mixed_space_fn_torch,
                                                     mlp_tune_objective, mlp_tune_space)
    from hyperopt_tpu_torch.ops import gmm_scores as G
    from hyperopt_tpu_torch.ops import kernels as TK

    t_phase = time.perf_counter()
    launches, loop = {}, {}
    n, n_startup = COMPILED_TRIALS, 20
    kw = dict(batch_size=1, n_EI_candidates=128, n_EI_candidates_cat=24)

    # -- 8a. bench_compiled_at_1k: a warm runner, then fmin(compiled=True)
    t0 = time.perf_counter()
    runner = compile_fmin(mixed_space_fn_torch, mixed_space(), max_evals=n, **kw)
    runner(seed=7)  # the warm call: two steps warmed up and captured, one run
    warm_s = time.perf_counter() - t0
    prog = runner._program()
    G.KERNEL.launches = 0
    trials = H.Trials()
    t0 = time.perf_counter()
    H.fmin(mixed_space_fn_torch, mixed_space(), compiled=True, max_evals=n, trials=trials,
           return_argmin=False, rstate=np.random.default_rng(7), show_progressbar=False,
           compiled_options={"runner": runner, "seed": 7})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counted_at_replay = G.KERNEL.launches
    launches["compiled_1k"] = compiled_launches(prog)
    replays = dict(prog.replays)
    losses = trials.losses()
    best = min(losses)
    # the same run replayed bare: host time to enqueue a replay, wall per step
    prog.reset(7, None, 0, float("inf"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(n):
        prog.run(prog.loop.regime(j, 0))
    enqueue_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    rv, ra, rl, _ = prog.host_state()
    assert rl[:n].tolist() == losses, "the bare replays are not the fmin run"
    # the host's share of fmin(compiled=True) outside the replays: the
    # standard Trials store rebuilt from the history
    t0 = time.perf_counter()
    _to_trials(runner._packed_space, rv[:, :n], ra[:, :n], rl[:n])
    rebuild_s = time.perf_counter() - t0
    # the first 64 steps run eagerly: the replayed stream's bits
    prog.reset(7, None, 0, float("inf"))
    for j in range(64):
        prog.step(prog.loop.regime(j, 0))
    ev, ea, el, _ = prog.host_state()
    eager_equal = (np.array_equal(ev[:, :64], rv[:, :64]) and np.array_equal(ea[:, :64], ra[:, :64])
                   and np.array_equal(el[:64], rl[:64]))
    log(f"[8a] compile_fmin(mixed_space_fn_torch, mixed_space(), {n} trials, B=1, n_cand 128, "
        f"cat 24): warm call {warm_s:.2f} s (two steps warmed up and captured, one run); "
        f"fmin(compiled=True) with the warm runner {seconds:.3f} s, best loss {best:.6f} (best "
        f"of the {n_startup} startup trials {min(losses[:n_startup]):.6f}); graph replays "
        f"{replays}; gmm_llr launches {launches['compiled_1k']} (captured per replay "
        f"{prog.launches_per_replay} times replays; the wrapper's counter read "
        f"{counted_at_replay} over the run, since it counts at capture); bare replays: "
        f"{enqueue_us:.1f} us of host time per replay enqueued, {step_ms:.4f} ms per step "
        f"with the card; the Trials store rebuilt from the history in {rebuild_s:.3f} s; "
        f"first 64 replayed steps bitwise the eager step: {eager_equal}")
    assert launches["compiled_1k"] == n - n_startup, launches
    assert replays == {"prior": n_startup, "model": n - n_startup}, replays
    assert prog.launches_per_replay == {"prior": 0, "model": 1}, prog.launches_per_replay
    assert counted_at_replay == 0, counted_at_replay
    assert len(losses) == n and np.all(np.isfinite(losses))
    assert best < min(losses[:n_startup]), "the compiled TPE did not improve on its startup draws"
    assert eager_equal, "the replayed steps are not the eager steps' bits"
    loop.update(seconds=seconds, best_loss=best, replays=sum(replays.values()),
                host_us_per_replay=enqueue_us, step_ms=step_ms, warm_s=warm_s,
                rebuild_s=rebuild_s)
    flat = {"values": rv[:, :n], "active": ra[:, :n], "losses": rl[:n]}

    # -- 8b. the seed sweep: 8 seeds in lockstep, each bitwise its solo run
    sweep_runner = compile_fmin(mixed_space_fn_torch, mixed_space(), max_evals=SWEEP_TRIALS, **kw)
    seeds = list(range(SWEEP_SEEDS))
    t0 = time.perf_counter()
    swept = sweep_runner(seed=seeds)
    sweep_s = time.perf_counter() - t0
    launches["compiled_sweep"] = compiled_launches(sweep_runner._program(SWEEP_SEEDS))
    t0 = time.perf_counter()
    solo = [sweep_runner(seed=s) for s in seeds]
    solo_s = time.perf_counter() - t0
    n_bitwise = sum(all(np.array_equal(a[f], b[f]) for f in ("values", "active", "losses"))
                    for a, b in zip(swept, solo))
    log(f"[8b] seed sweep of {SWEEP_SEEDS} seeds x {SWEEP_TRIALS} trials in one program: "
        f"{sweep_s:.2f} s (first call, capture included), the solo runs {solo_s:.2f} s; "
        f"{n_bitwise} of {SWEEP_SEEDS} seeds bitwise their solo runs; gmm_llr launches "
        f"{launches['compiled_sweep']} (one per model step for all seeds)")
    assert n_bitwise == SWEEP_SEEDS, n_bitwise
    assert launches["compiled_sweep"] == SWEEP_TRIALS - n_startup
    loop.update(sweep_bitwise=n_bitwise, sweep_s=sweep_s)
    # the two bodies that gained their seed axis last: ATPE and joint EI
    for path, extra in (("sweep_atpe", {"algo": "atpe"}), ("sweep_joint", {"joint_ei": True})):
        body = compile_fmin(mixed_space_fn_torch, mixed_space(), max_evals=SWEEP_TRIALS,
                            **kw, **extra)
        with launch_shapes() as swept_shapes:
            t0 = time.perf_counter()
            swept = body(seed=seeds)
            path_s = time.perf_counter() - t0
        launches[path] = compiled_launches(body._program(SWEEP_SEEDS))
        with launch_shapes() as solo_shapes:
            solo = [body(seed=s) for s in seeds]
        n_same = sum(all(np.array_equal(a[f], b[f]) for f in ("values", "active", "losses"))
                     for a, b in zip(swept, solo))
        log(f"[8b] {extra}: {SWEEP_SEEDS} seeds x {SWEEP_TRIALS} trials in one program "
            f"{path_s:.2f} s (capture included); {n_same} of {SWEEP_SEEDS} seeds bitwise their "
            f"solo runs; gmm_llr launches {launches[path]}")
        assert n_same == SWEEP_SEEDS, (extra, n_same)
        assert launches[path] == SWEEP_TRIALS - n_startup, (extra, launches[path])
        assert all(d // split == SWEEP_SEEDS for _, d, _, _, _, split in swept_shapes), \
            swept_shapes
        loop[f"{path}_bitwise"] = n_same
        CHECKED_SHAPES[path] = check_shapes(path, swept_shapes | solo_shapes, seed=81)

    # -- 8c. chunks, progress rows, a kill at a chunk boundary, resume ------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chunk.ckpt")
        plan = FaultPlan(seed=0)
        rows = []
        chunked = compile_fmin(mixed_space_fn_torch, mixed_space(), max_evals=n, chunk_size=n // 4,
                               progress_callback=rows.append, checkpoint_path=path,
                               fs=plan.fs(), **kw)
        whole = chunked(seed=7)
        whole_rows = list(rows)
        rows.clear()
        plan.arm("device_loop_after_ckpt_before_next_chunk", at=2)
        try:
            chunked(seed=7)
            raise AssertionError("the armed crash point did not fire")
        except SimulatedCrash:
            pass
        resumed = chunked(seed=7, resume=True)
        launches["compiled_chunked"] = compiled_launches(chunked._program())
    same = lambda a, b: all(np.array_equal(a[f], b[f]) for f in ("values", "active", "losses"))  # noqa: E731
    log(f"[8c] chunk_size={n // 4} (4 chunks): the chunked run bitwise the flat run: "
        f"{same(whole, flat)}; killed after chunk 2's checkpoint, resumed: bitwise the flat run "
        f"{same(resumed, flat)}; progress rows {whole_rows}, across the kill {rows}; gmm_llr "
        f"launches of the resumed leg {launches['compiled_chunked']}")
    assert same(whole, flat) and same(resumed, flat)
    assert rows == whole_rows and [r["trials_done"] for r in rows] == [n // 4 * k for k in (1, 2, 3, 4)]
    assert launches["compiled_chunked"] == n // 2

    # -- 8d. early stop: a threshold the flat run reaches --------------------
    thr = float(np.min(flat["losses"][:n * 3 // 5]))
    first_hit = int(np.argmax(flat["losses"] <= thr))
    early_runner = compile_fmin(mixed_space_fn_torch, mixed_space(), max_evals=n,
                                loss_threshold=thr, **kw)
    early = early_runner(seed=7)
    launches["compiled_early_stop"] = compiled_launches(early_runner._program())
    n_ev = early["n_evals"]
    prefix = all(np.array_equal(early[f], flat[f][..., :n_ev]) for f in ("values", "active", "losses"))
    log(f"[8d] loss_threshold {thr:.6f} (the flat run's best of its first {n * 3 // 5}, hit at trial "
        f"{first_hit}): n_evals {n_ev}, replays {early_runner._program().replays} (the stop "
        f"flag read every 16), the history a bitwise prefix of the flat run: {prefix}")
    assert n_ev == first_hit + 1 and n_ev < n, (n_ev, first_hit)
    assert prefix, "the early-stopped history is not a prefix of the flat run"

    # -- 8e. bench_mlp_tune: 512 trials, batch 32, 8 epochs -----------------
    mlp = compile_fmin(mlp_tune_objective(n_epochs=8), mlp_tune_space(), max_evals=512,
                       batch_size=32)
    t0 = time.perf_counter()
    mlp(seed=0)  # warm-up and capture
    mlp_warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = mlp(seed=1)
    torch.cuda.synchronize()
    mlp_s = time.perf_counter() - t0
    launches["mlp_tune"] = compiled_launches(mlp._program())
    assert TK._below_pad(25, cap=512, gamma=0.25) + 1 == MLP_SHAPE["Kb"]
    result, time_mlp_kernel = kernel_at(MLP_SHAPE, 8, sfu_per_s)
    log(f"[8e] mlp_tune (512 trials, batch 32, 8 epochs): warm call {mlp_warm_s:.2f} s, timed "
        f"run {mlp_s:.3f} s: {512 / mlp_s:.1f} trials/s, best loss {out['best_loss']:.6f}; "
        f"replays {mlp._program().replays}, gmm_llr launches {launches['mlp_tune']}; the kernel "
        f"at {MLP_SHAPE}: max_abs_err {result['max_abs_err']:.3e} against the plain version "
        f"(timed after phase 9)")
    assert launches["mlp_tune"] == 512 // 32 - 1, launches
    assert np.isfinite(out["losses"]).all() and out["n_evals"] == 512
    loop.update(mlp_trials_per_s=512 / mlp_s, mlp_best_loss=out["best_loss"])

    log(f"[8] {time.perf_counter() - t_phase:.1f} s")

    def profiled():
        time_mlp_kernel("8e")
        phase8f(prog, (rv, ra, rl), n, step_ms, enqueue_us, loop)

    return launches, result, loop, profiled


def phase8f(prog, history, n, step_ms, enqueue_us, loop):
    """8f, run after phase 9, the last of the profiler-free phases."""
    import numpy as np
    import torch

    rv, ra, rl = history
    # -- 8f. where a compiled step's time goes: 8a's last 20 model steps
    # under torch.profiler, after every profiler-free phase, since once a
    # profiler trace has run in the process every replay holds the host
    # until the card has run it (milliseconds where it took microseconds)
    prog.reset(7, (rv, ra, rl, np.arange(rl.shape[0]) < n), 0, float("inf"), start_step=n - 20)
    # each window (retaken if its trace is empty) replays steps n-20 .. n-1
    prof = profile_window(lambda: (prog.i.fill_(n - 20), [prog.run("model") for _ in range(20)]),
                          20)
    log("[8f] 8a's last 20 model steps "
        + ("under torch.profiler: no device event traced, so not measured"
           if prof is None else
           f"under torch.profiler: {prof['wall_ms']:.4f} ms per step, device busy "
           f"{prof['busy_ms']:.4f} ms per step (idle share {1.0 - prof['busy_ms'] / prof['wall_ms']:.4f} "
           f"of the profiled window; busy over 8a's bare step {prof['busy_ms'] / step_ms:.4f}), "
           f"{prof['kernels_per_ask']:.1f} device kernels per step, gmm_llr_kernel "
           f"{prof['llr_ms']:.4f} ms per step; top device time per step: "
           + ", ".join(f"{nm} {t:.4f} ms" for nm, t in prof["top"])))
    # 8a's bare replays once more, now that a profiler trace has run
    prog.reset(7, None, 0, float("inf"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(n):
        prog.run(prog.loop.regime(j, 0))
    enqueue_after_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    step_after_ms = (time.perf_counter() - t0) / n * 1e3
    assert np.array_equal(prog.host_state()[2], rl), "the replays changed after the profiler"
    log(f"[8f] 8a's bare replays after that profiler trace: {enqueue_after_us:.1f} us of host "
        f"time per replay enqueued (before it: {enqueue_us:.1f}), {step_after_ms:.4f} ms per step "
        f"with the card (before it: {step_ms:.4f}); the same losses")
    loop.update(busy_ms=None if prof is None else prof["busy_ms"],
                idle_share=None if prof is None else 1.0 - prof["busy_ms"] / prof["wall_ms"],
                kernels_per_step=None if prof is None else prof["kernels_per_ask"],
                host_us_per_replay_after_profiler=enqueue_after_us)


# the fused ASHA protocol of bench.py:1650 (bench_compiled_asha)
ASHA_BATCH, ASHA_TRIALS, FLAT_TRIALS = 16, 256, 128
# the kernel in a model bracket: mlp_tune's 4 unquantized dims, 24
# candidates, the below pad at a 256-slot carry, the whole history above
ASHA_SHAPE = dict(B=16, Dg=4, S=24, Kb=9, Ka=257)
ASHA = {"eta": 2, "rung_epochs": 1, "n_rungs": 3}
# PBT_STUDY_CONFIG of bench.py:1199, on the population MLP
PBT_POP, PBT_EXPLOIT_EVERY, PBT_ROUNDS = 32, 10, 20
SHA_CONFIGS, SHA_REPLICAS, SHA_STEPS = 16, 2, 10


def population_mlp(n_members, seed=0):
    """``mlp_tune``'s 2-layer regressor at its full width (n_train 256,
    in_dim 8, hidden 32) as a population ``train_fn`` for ``compile_pbt``
    and ``compile_sha``: one full-batch SGD+momentum step of every member
    (``torch.func.vmap`` over the members), the members' MSE after it;
    hypers lr, momentum and weight decay; initial weights at scale 0.3."""
    import torch

    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch.models.synthetic import _mlp_pieces

    init, step, loss = _mlp_pieces(256, 8, 32, seed)

    def train_fn(state, hypers, key):
        state = torch.func.vmap(step)(state, hypers["lr"], hypers["momentum"], hypers["wd"])
        return state, torch.func.vmap(loss)(state)

    keys = R.split(R.key(seed + 1, device="cuda"), n_members)
    state0 = torch.func.vmap(lambda k: init(k, 0.3))(keys)
    bounds = {"lr": (1e-3, 1.0), "momentum": (0.05, 0.99), "wd": (1e-6, 1e-2)}
    return train_fn, state0, bounds


def phase9(sfu_per_s):
    """The multi-fidelity schedulers on the card; returns the kernel
    launches of their paths, their numbers, the kernel's record at the
    bracket's shape, and what runs after the profiler-free phases (the
    kernel's timing and a profiled ASHA run)."""
    import tempfile

    import numpy as np
    import torch

    from hyperopt_tpu_torch import hyperband as HB
    from hyperopt_tpu_torch import tpe
    from hyperopt_tpu_torch.device_loop import compile_fmin
    from hyperopt_tpu_torch.distributed.faults import FaultPlan, SimulatedCrash
    from hyperopt_tpu_torch.models.synthetic import (budgeted_quadratic_fn,
                                                     budgeted_quadratic_space,
                                                     mlp_tune_objective, mlp_tune_space)
    from hyperopt_tpu_torch.ops import gmm_scores as G
    from hyperopt_tpu_torch.pbt import compile_pbt

    t_phase = time.perf_counter()
    launches, sched = {}, {}
    B = ASHA_BATCH
    total_ep = ASHA["rung_epochs"] * (ASHA["eta"] ** ASHA["n_rungs"] - 1) // (ASHA["eta"] - 1)
    n_brackets = ASHA_TRIALS // B
    n_prior = -(-20 // B)  # n_startup_jobs=20: brackets drawn from the prior

    # -- 9a. bench_compiled_asha: fused ASHA against the flat sweep ---------
    def build(n_evals, rows, **kw):
        return compile_fmin(mlp_tune_objective(n_epochs=total_ep), mlp_tune_space(),
                            max_evals=n_evals, batch_size=B, chunk_size=B, progress_every=1,
                            progress_callback=lambda row: rows.append(
                                (time.perf_counter(), row["best_loss"])), **kw)

    rows_flat, rows_asha = [], []
    flat = build(FLAT_TRIALS, rows_flat)
    asha = build(ASHA_TRIALS, rows_asha, asha=ASHA)
    t0 = time.perf_counter()
    flat(seed=0)
    with launch_shapes() as asha_shapes:
        asha(seed=0)  # warm-up and capture of both
    warm_s = time.perf_counter() - t0
    rows_flat.clear()
    t0f = time.perf_counter()
    out_f = flat(seed=1)
    flat_s = time.perf_counter() - t0f
    rows_asha.clear()
    t0a = time.perf_counter()
    out_a = asha(seed=1)
    asha_s = time.perf_counter() - t0a
    prog = asha._program()
    launches["asha_compiled"] = compiled_launches(prog)
    replays = dict(prog.replays)
    q = max(out_f["best_loss"], out_a["best_loss"])
    first = lambda rows, t_0: next((t - t_0 for t, b in rows if b <= q), None)  # noqa: E731
    t_f, t_a = first(rows_flat, t0f), first(rows_asha, t0a)
    rung_counts = np.bincount(out_a["rung_of"] + 1, minlength=ASHA["n_rungs"] + 1).tolist()
    log(f"[9a] bench_compiled_asha on mlp_tune (n_train 256, in_dim 8, hidden 32), batch {B}, "
        f"asha {ASHA}: warm calls {warm_s:.2f} s; flat {FLAT_TRIALS} trials x {total_ep} "
        f"epochs {flat_s:.3f} s, best {out_f['best_loss']:.6f}; asha {ASHA_TRIALS} trials "
        f"{asha_s:.3f} s ({n_brackets / asha_s:.1f} brackets/s), full-fidelity best "
        f"{out_a['best_loss']:.6f}; quality target {q:.6f} reached by flat at "
        f"{t_f} s, by asha at {t_a} s; rung_of counts (-1, 0, 1, 2) {rung_counts}; "
        f"replays {replays}, gmm_llr launches {launches['asha_compiled']} (captured per "
        f"replay {prog.launches_per_replay})")
    assert replays == {"prior": n_prior, "model": n_brackets - n_prior}, replays
    assert prog.launches_per_replay == {"prior": 0, "model": 1}, prog.launches_per_replay
    assert launches["asha_compiled"] == n_brackets - n_prior, launches
    assert rung_counts == [0, ASHA_TRIALS // 2, ASHA_TRIALS // 4, ASHA_TRIALS // 4]
    from hyperopt_tpu_torch.ops import kernels as TK

    assert TK._below_pad(25, cap=ASHA_TRIALS, gamma=0.25) + 1 == ASHA_SHAPE["Kb"]
    assert prog.loop.cap + 1 == ASHA_SHAPE["Ka"]
    # every launch the bracket captured is at the shape held below
    assert asha_shapes == {(B, ASHA_SHAPE["Dg"], ASHA_SHAPE["S"], ASHA_SHAPE["Kb"],
                            ASHA_SHAPE["Ka"], ASHA_SHAPE["Dg"])}, asha_shapes
    record, time_kernel = kernel_at(ASHA_SHAPE, 9, sfu_per_s)
    log(f"[9a] the kernel at the bracket's shape {ASHA_SHAPE}: max_abs_err "
        f"{record['max_abs_err']:.3e} against the plain version (timed after 8f)")
    assert np.isfinite(out_a["losses"]).all() and np.isfinite(out_f["losses"]).all()
    # the first brackets replayed are the eager brackets' bits
    n_eager = 4
    prog.reset(1, None, 0, float("inf"))
    for j in range(n_eager):
        prog.step(prog.loop.regime(j, 0))
    ev, ea, el, _, er = prog.host_state()
    m = n_eager * B
    eager_equal = (np.array_equal(ev[:, :m], out_a["values"][:, :m])
                   and np.array_equal(el[:m], out_a["losses"][:m])
                   and np.array_equal(er[:m], out_a["rung_of"][:m]))
    # chunked against flat, the artifact stream, a kill and a resume
    keys = ("values", "active", "losses", "rung_of")
    same = lambda a, b: all(np.array_equal(a[k], b[k]) for k in keys)  # noqa: E731
    flat_asha = compile_fmin(mlp_tune_objective(n_epochs=total_ep), mlp_tune_space(),
                             max_evals=ASHA_TRIALS, batch_size=B, asha=ASHA)
    flat_equal = same(flat_asha(seed=1), out_a)
    arts = []
    with tempfile.TemporaryDirectory() as tmp:
        plan = FaultPlan(seed=0)
        durable = compile_fmin(mlp_tune_objective(n_epochs=total_ep), mlp_tune_space(),
                               max_evals=ASHA_TRIALS, batch_size=B, asha=ASHA,
                               chunk_size=ASHA_TRIALS // 4,
                               checkpoint_path=os.path.join(tmp, "a.ckpt"),
                               fs=plan.fs(), artifact_callback=arts.append)
        whole = durable(seed=1)
        n_arts = len(arts)
        arts_ok = all(a["loss"] == out_a["losses"][a["slot"]]
                      and out_a["rung_of"][a["slot"]] == ASHA["n_rungs"] - 1
                      and a["slot"] // B == a["bracket"] for a in arts)
        plan.arm("device_loop_after_ckpt_before_next_chunk", at=2)
        try:
            durable(seed=1)
            raise AssertionError("the armed crash point did not fire")
        except SimulatedCrash:
            pass
        resumed = durable(seed=1, resume=True)
    log(f"[9a] the first {n_eager} replayed brackets bitwise the eager brackets: {eager_equal}; "
        f"chunked (chunk_size={B}) bitwise the unchunked ASHA run: {flat_equal}; "
        f"chunk_size={ASHA_TRIALS // 4} with artifacts: bitwise {same(whole, out_a)}, {n_arts} artifact "
        f"rows for {n_brackets} brackets, each its bracket's full-fidelity winner: {arts_ok}; "
        f"killed after chunk 2's checkpoint and resumed: bitwise {same(resumed, out_a)}")
    assert eager_equal, "the replayed brackets are not the eager brackets' bits"
    assert flat_equal and same(whole, out_a) and same(resumed, out_a)
    assert n_arts == n_brackets and arts_ok, (n_arts, arts_ok)
    sched.update(asha_seconds=asha_s, flat_seconds=flat_s, brackets_per_s=n_brackets / asha_s,
                 asha_seconds_to_flat_best=t_a, flat_seconds_to_flat_best=t_f,
                 asha_best_loss=out_a["best_loss"], flat_best_loss=out_f["best_loss"],
                 asha_replays=sum(replays.values()))

    # -- 9b. compile_pbt and compile_sha on the population MLP --------------
    train_fn, state0, bounds = population_mlp(PBT_POP)
    pbt = compile_pbt(train_fn, state0, bounds, pop_size=PBT_POP,
                      exploit_every=PBT_EXPLOIT_EVERY, n_rounds=PBT_ROUNDS)
    pbt(seed=0)  # warm-up and capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_out = pbt(seed=1)
    torch.cuda.synchronize()
    pbt_s = time.perf_counter() - t0
    p_eager = pbt._run(1, None, eager=True)
    pbt_equal = (np.array_equal(p_eager["loss_history"], p_out["loss_history"])
                 and np.array_equal(p_eager["log_hypers"], p_out["log_hypers"]))
    member_steps = PBT_POP * PBT_EXPLOIT_EVERY * PBT_ROUNDS
    log(f"[9b] compile_pbt pop {PBT_POP}, exploit_every {PBT_EXPLOIT_EVERY}, {PBT_ROUNDS} "
        f"rounds on the population MLP: {pbt_s:.3f} s, {member_steps / pbt_s:.1f} member-steps/s,"
        f" {pbt_s / PBT_ROUNDS * 1e3:.3f} ms per round (one replay each); best loss "
        f"{p_out['best_loss']:.6f}, median of the last round "
        f"{float(np.median(p_out['loss_history'][-1])):.6f} (first round "
        f"{float(np.median(p_out['loss_history'][0])):.6f}); captured bitwise eager: {pbt_equal}")
    assert pbt_equal, "the replayed PBT rounds are not the eager rounds' bits"
    assert np.isfinite(p_out["best_loss"])
    sched.update(pbt_seconds=pbt_s, pbt_member_steps_per_s=member_steps / pbt_s,
                 pbt_ms_per_round=pbt_s / PBT_ROUNDS * 1e3, pbt_best_loss=p_out["best_loss"])

    train_fn, state0, bounds = population_mlp(SHA_REPLICAS * SHA_CONFIGS, seed=2)
    sha_faults = FaultPlan(seed=0)
    sha = HB.compile_sha(train_fn, state0, bounds, n_configs=SHA_CONFIGS, eta=2,
                         steps_per_rung=SHA_STEPS, replicas=SHA_REPLICAS, fs=sha_faults.fs())
    sha(seed=0)  # warm-up and capture of every rung
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_out = sha(seed=1)
    sha_s = time.perf_counter() - t0
    # each rung's replay alone, by CUDA events
    rung_ms = []
    for r, (graph,) in enumerate(sha._graphs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        rung_ms.append(start.elapsed_time(end))
    s_eager = sha._run(1, None, eager=True)
    sha_equal = (s_eager["rungs"] == s_out["rungs"]
                 and all(torch.equal(a, b) for a, b in zip(
                     [s_eager["state"][0][k] for k in sorted(s_eager["state"][0])],
                     [s_out["state"][0][k] for k in sorted(s_out["state"][0])])))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sha.npz")
        # a crash right after the second rung's snapshot is published
        sha_faults.arm("sha_after_snapshot_before_next_rung", at=2)
        try:
            sha(seed=1, checkpoint=path)
            raise AssertionError("the armed crash point did not fire")
        except SimulatedCrash:
            pass
        s_resumed = sha(seed=1, checkpoint=path)
    resume_equal = (s_resumed["rungs"] == s_out["rungs"]
                    and s_resumed["best_hypers"] == s_out["best_hypers"])
    sha_steps = sum(SHA_REPLICAS * p * n for p, n, _ in sha._ladder)
    log(f"[9b] compile_sha {SHA_CONFIGS} configs x {SHA_REPLICAS} replicas, eta 2, "
        f"{SHA_STEPS} steps per rung on the population MLP: ladder {sha._ladder}, "
        f"{sha_s:.3f} s ({sha_steps} member-steps, {sha_steps / sha_s:.1f} member-steps/s); ms "
        f"per rung replay {[round(t, 4) for t in rung_ms]}; best loss {s_out['best_loss']:.6f}; "
        f"captured bitwise eager: {sha_equal}; killed after rung 2's snapshot and resumed: "
        f"bitwise {resume_equal}")
    assert sha_equal and resume_equal, (sha_equal, resume_equal)
    sched.update(sha_seconds=sha_s, sha_member_steps_per_s=sha_steps / sha_s,
                 sha_ms_per_rung=rung_ms)

    # -- 9c. the host drivers, rung 0 asked through the port's TPE on the card
    G.KERNEL.launches = 0
    t0 = time.perf_counter()
    sh = HB.successive_halving(budgeted_quadratic_fn, budgeted_quadratic_space(),
                               max_budget=27, eta=3, algo=tpe.suggest,
                               rstate=np.random.default_rng(0))
    sha_host_s = time.perf_counter() - t0
    launches["sha_host"] = G.KERNEL.launches
    expected = []

    def counted_tpe(new_ids, domain, trials, seed):
        # the model runs (one launch) once 20 completed trials exist
        expected.append(int(len(trials.trials) >= 20))
        return tpe.suggest(new_ids, domain, trials, seed)

    G.KERNEL.launches = 0
    with launch_shapes() as host_shapes:
        t0 = time.perf_counter()
        ah = HB.asha(budgeted_quadratic_fn, budgeted_quadratic_space(), max_budget=27, eta=3,
                     max_jobs=40, workers=4, algo=counted_tpe, rstate=np.random.default_rng(0))
        asha_host_s = time.perf_counter() - t0
    launches["asha_host"] = G.KERNEL.launches
    log(f"[9c] successive_halving(max_budget=27, eta=3) with tpe.suggest on the card: "
        f"{sha_host_s:.3f} s, {len(sh['trials'])} evaluations, best {sh['best_loss']:.6f}, "
        f"gmm_llr launches {launches['sha_host']} (rung 0 is one ask on an empty history: "
        f"prior draws); asha(workers=4, max_jobs=40): {asha_host_s:.3f} s, "
        f"{len(ah['trials'])} evaluations, rungs {ah['rungs']}, best {ah['best_loss']:.6f}, "
        f"{len(expected)} rung-0 asks, gmm_llr launches {launches['asha_host']} (one per ask "
        f"on 20 or more completed trials: {sum(expected)})")
    assert len(sh["trials"]) == 27 + 9 + 3 + 1 and launches["sha_host"] == 0
    assert len(ah["trials"]) == 40 and launches["asha_host"] == sum(expected)
    CHECKED_SHAPES["asha_host"] = check_shapes("asha_host", host_shapes, seed=91)
    sched.update(sha_host_seconds=sha_host_s, asha_host_seconds=asha_host_s)
    log(f"[9] {time.perf_counter() - t_phase:.1f} s")

    def profiled():
        time_kernel("9a")

    def profiled_last():
        sched.update(phase9d(asha, out_a))

    return launches, sched, record, profiled, profiled_last


def phase9d(asha, out):
    """Where a model bracket's time goes, run last of all (after this
    profiler session the card's traces came back empty for the rest of
    the process): 9a's 14 model brackets under ``torch.profiler``, from
    9a's history after its 2 prior brackets."""
    import numpy as np

    prog = asha._program()
    n = ASHA_TRIALS // ASHA_BATCH
    n_prior = -(-20 // ASHA_BATCH)
    m, cap = n_prior * ASHA_BATCH, prog.loop.cap
    values = np.zeros((out["values"].shape[0], cap), np.float32)
    active = np.zeros(values.shape, bool)
    losses = np.zeros(cap, np.float32)
    rung_of = np.full(cap, -1, np.int32)
    values[:, :m], active[:, :m] = out["values"][:, :m], out["active"][:, :m]
    losses[:m], rung_of[:m] = out["losses"][:m], out["rung_of"][:m]
    state = (values, active, losses, np.arange(cap) < m)

    def run():
        prog.reset(1, state, 0, float("inf"), start_step=n_prior, rung_of=rung_of)
        for _ in range(n - n_prior):
            prog.run("model")

    prof = profile_window(run, n - n_prior)
    assert np.array_equal(prog.host_state()[2][:n * ASHA_BATCH], out["losses"]), \
        "the profiled brackets are not 9a's"
    log(f"[9d] 9a's {n - n_prior} model brackets "
        + ("under torch.profiler: no device event traced, so not measured" if prof is None else
           f"under torch.profiler: {prof['wall_ms']:.4f} ms per bracket, device busy "
           f"{prof['busy_ms']:.4f} ms per bracket (idle share "
           f"{1.0 - prof['busy_ms'] / prof['wall_ms']:.4f} of the profiled window), "
           f"{prof['kernels_per_ask']:.1f} device kernels per bracket, gmm_llr_kernel "
           f"{prof['llr_ms']:.4f} ms per bracket; top device time per bracket: "
           + ", ".join(f"{nm} {t:.4f} ms" for nm, t in prof["top"])))
    return {} if prof is None else {
        "bracket_busy_ms": prof["busy_ms"], "bracket_wall_ms": prof["wall_ms"],
        "bracket_idle_share": 1.0 - prof["busy_ms"] / prof["wall_ms"],
        "kernels_per_bracket": prof["kernels_per_ask"]}


# phase 14: the population models at their full widths (bench.py:1199-1243
# bench_pbt's TinyLM, bench.py:1150 bench_asha_device, BASELINE.json
# config #4's ResNet-20 on CIFAR-shaped batches)
LM = dict(vocab=32, d_model=32, n_heads=2, n_layers=2, max_len=32)
LM_DATA = dict(batch_size=32, seq_len=32, vocab=32)
LM_BOUNDS = {"lr": (1e-4, 1.0), "wd": (1e-7, 1e-2)}
# 14a runs bench_pbt's population and window for 10 rounds of its 20, 14b
# three rungs (widths 32-8) of five, and 15d the CPU streams of seeds 0
# and 1: room for phase 20 in the script's time
LM_PBT_ROUNDS = 10
LM_SHA = dict(n_configs=32, eta=2, steps_per_rung=10, n_rungs=3)
LM_FMIN = dict(n_steps=4, max_evals=256, batch_size=16)
LM_ASHA = dict(max_budget=27, eta=3, max_jobs=40, workers=4)
RESNET_POP, RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS = 8, 128, 32, 10
RESNET_FMIN_TRIALS = 30


def peak_gb():
    """The card's peak allocated memory since the last reset, in GB."""
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def phase14():
    """The population models on the card; returns the kernel launches of
    their paths and their numbers."""
    import numpy as np
    import torch

    import hyperopt_tpu_torch as H
    from hyperopt_tpu_torch import hyperband as HB
    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch import tpe
    from hyperopt_tpu_torch.device_loop import compile_fmin
    from hyperopt_tpu_torch.models import resnet as TR
    from hyperopt_tpu_torch.models import transformer as TT
    from hyperopt_tpu_torch.ops import gmm_scores as G
    from hyperopt_tpu_torch.pbt import compile_pbt

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    launches, pop = {}, {}
    model = TT.TinyLM(**LM)

    def lm_state(n, seed):
        params = TT.init_population(model, n, R.key(seed, device=dev), seq_len=LM["max_len"])
        return params, {k: torch.zeros_like(v) for k, v in params.items()}

    def same_state(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)

    # -- 14a. bench_pbt's protocol on TinyLM at its full width -------------
    torch.cuda.reset_peak_memory_stats()
    train_fn = TT.make_pbt_train_fn(model, **LM_DATA)
    pbt = compile_pbt(train_fn, lm_state(PBT_POP, 0), LM_BOUNDS, pop_size=PBT_POP,
                      exploit_every=PBT_EXPLOIT_EVERY, n_rounds=LM_PBT_ROUNDS)
    t0 = time.perf_counter()
    pbt(seed=99)  # warm-up and capture
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_out = pbt(seed=0)
    torch.cuda.synchronize()
    pbt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_eager = pbt._run(0, None, eager=True)
    eager_s = time.perf_counter() - t0
    pbt_equal = (np.array_equal(p_eager["loss_history"], p_out["loss_history"])
                 and np.array_equal(p_eager["log_hypers"], p_out["log_hypers"])
                 and same_state(p_eager["state"][0], p_out["state"][0]))
    hist = p_out["loss_history"]
    med_first, med_last = float(np.nanmedian(hist[0])), float(np.nanmedian(hist[-1]))
    member_steps = PBT_POP * PBT_EXPLOIT_EVERY * LM_PBT_ROUNDS
    pop.update(pbt_seconds=pbt_s, pbt_member_steps_per_s=member_steps / pbt_s,
               pbt_ms_per_round=pbt_s / LM_PBT_ROUNDS * 1e3, pbt_median_loss=med_last,
               pbt_first_round_median_loss=med_first, pbt_best_loss=p_out["best_loss"],
               pbt_warm_seconds=warm_s, pbt_eager_seconds=eager_s, pbt_peak_gb=peak_gb())
    log(f"[14a] bench_pbt on TinyLM {LM}, batch {LM_DATA['batch_size']} x "
        f"{LM_DATA['seq_len']}, pop {PBT_POP}, exploit_every {PBT_EXPLOIT_EVERY}, "
        f"{LM_PBT_ROUNDS} rounds, bounds {LM_BOUNDS}: warm-up and capture {warm_s:.3f} s; timed "
        f"runner(seed=0) {pbt_s:.4f} s, {member_steps / pbt_s:.1f} member-steps/s, "
        f"{pbt_s / LM_PBT_ROUNDS * 1e3:.4f} ms per round (one replay each); population median "
        f"loss (nanmedian) of the last round {med_last:.6f}, of the first {med_first:.6f}; "
        f"best {p_out['best_loss']:.6f}; the eager twin {eager_s:.3f} s, captured bitwise "
        f"eager: {pbt_equal}; peak memory "
        f"{pop['pbt_peak_gb']:.3f} GB")
    assert pbt_equal, "the replayed PBT rounds are not the eager rounds' bits"
    assert np.isfinite(med_last) and med_last < med_first, (med_first, med_last)
    del pbt, p_out, p_eager

    # -- 14b. compile_sha on the same TinyLM -----------------------------
    torch.cuda.reset_peak_memory_stats()
    sha = HB.compile_sha(train_fn, lm_state(LM_SHA["n_configs"], 1), LM_BOUNDS, **LM_SHA)
    t0 = time.perf_counter()
    sha(seed=0)  # warm-up and capture of every rung
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_out = sha(seed=1)
    sha_s = time.perf_counter() - t0
    rung_ms = []
    for (graph,) in sha._graphs:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        rung_ms.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    s_eager = sha._run(1, None, eager=True)
    eager_s = time.perf_counter() - t0
    sha_equal = (s_eager["rungs"] == s_out["rungs"]
                 and s_eager["best_index"] == s_out["best_index"]
                 and same_state(s_eager["state"][0], s_out["state"][0]))
    sha_steps = sum(p * n for p, n, _ in sha._ladder)
    best0 = s_out["rungs"][0]["best_loss"]
    pop.update(sha_seconds=sha_s, sha_member_steps_per_s=sha_steps / sha_s,
               sha_ms_per_rung=rung_ms, sha_best_loss=s_out["best_loss"],
               sha_rung0_best_loss=best0, sha_warm_seconds=warm_s, sha_eager_seconds=eager_s,
               sha_peak_gb=peak_gb())
    log(f"[14b] compile_sha on TinyLM, {LM_SHA}: ladder {sha._ladder}, warm-up and capture "
        f"{warm_s:.3f} s, timed run "
        f"{sha_s:.4f} s ({sha_steps} member-steps, {sha_steps / sha_s:.1f} member-steps/s); "
        f"ms per rung replay (CUDA events) {[round(t, 4) for t in rung_ms]}; best loss "
        f"{s_out['best_loss']:.6f} (rung 0's best {best0:.6f}); the eager twin {eager_s:.3f} "
        f"s, captured bitwise eager: "
        f"{sha_equal}; peak memory {pop['sha_peak_gb']:.3f} GB")
    assert sha_equal, "the replayed SHA rungs are not the eager rungs' bits"
    assert s_out["best_loss"] <= best0, (s_out["best_loss"], best0)
    del sha, s_out, s_eager

    # -- 14c. compile_fmin over device_objective at (a)'s widths ----------
    torch.cuda.reset_peak_memory_stats()
    obj = TT.device_objective(n_steps=LM_FMIN["n_steps"], d_model=LM["d_model"],
                              n_heads=LM["n_heads"], n_layers=LM["n_layers"], **LM_DATA)
    runner = compile_fmin(obj, TT.hpo_space(), max_evals=LM_FMIN["max_evals"],
                          batch_size=LM_FMIN["batch_size"])
    t0 = time.perf_counter()
    with launch_shapes() as lm_shapes:
        runner(seed=1)  # warm-up and capture of both regimes
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = runner(seed=0)
    fmin_s = time.perf_counter() - t0
    prog = runner._program()
    launches["lm_compiled"] = compiled_launches(prog)
    replays = dict(prog.replays)
    again = runner(seed=0)
    n_steps = LM_FMIN["max_evals"] // LM_FMIN["batch_size"]
    n_prior = -(-20 // LM_FMIN["batch_size"])
    losses = out["losses"]
    pop.update(fmin_seconds=fmin_s, fmin_trials_per_s=LM_FMIN["max_evals"] / fmin_s,
               fmin_best_loss=out["best_loss"], fmin_max_loss=float(np.max(losses)),
               fmin_peak_gb=peak_gb())
    log(f"[14c] compile_fmin(transformer.device_objective({LM_FMIN['n_steps']} steps, "
        f"TinyLM {LM}, batch {LM_DATA['batch_size']} x {LM_DATA['seq_len']}), hpo_space(), "
        f"max_evals {LM_FMIN['max_evals']}, batch_size {LM_FMIN['batch_size']}): warm-up and "
        f"capture {warm_s:.3f} s; warm runner {fmin_s:.4f} s, "
        f"{LM_FMIN['max_evals'] / fmin_s:.1f} trials/s; best {out['best_loss']:.6f}, worst "
        f"{np.max(losses):.6f}; replays {replays}, gmm_llr launches {launches['lm_compiled']} "
        f"(captured per replay {prog.launches_per_replay}); a second runner(seed=0) bitwise: "
        f"{np.array_equal(again['losses'], losses)}; peak memory {pop['fmin_peak_gb']:.3f} GB")
    assert np.isfinite(losses).all()
    assert replays == {"prior": n_prior, "model": n_steps - n_prior}, replays
    assert prog.launches_per_replay == {"prior": 0, "model": 1}, prog.launches_per_replay
    assert launches["lm_compiled"] == n_steps - n_prior, launches
    assert np.array_equal(again["losses"], losses) and np.array_equal(again["values"],
                                                                      out["values"])
    assert out["best_loss"] < np.max(losses) - 0.1, (out["best_loss"], np.max(losses))
    CHECKED_SHAPES["lm_compiled"] = check_shapes("lm_compiled", lm_shapes, seed=141)
    del runner, prog, obj

    # -- 14d. bench_asha_device's protocol --------------------------------
    torch.cuda.reset_peak_memory_stats()
    fn = TT.budget_objective()
    space = TT.hpo_space()
    t0 = time.perf_counter()
    for b in (1, 3, 9, 27):  # warm (capture) every rung budget
        fn({"lr": 0.1, "wd": 1e-4}, b)
    warm_s = time.perf_counter() - t0
    expected = []

    def counted_tpe(new_ids, domain, trials, seed):
        # the model runs (one launch) once 20 completed trials exist
        expected.append(int(len(trials.trials) >= 20))
        return tpe.suggest(new_ids, domain, trials, seed)

    G.KERNEL.launches = 0
    with launch_shapes() as asha_shapes:
        t0 = time.perf_counter()
        out_a = HB.asha(fn, space, algo=counted_tpe, rstate=np.random.default_rng(0), **LM_ASHA)
        asha_s = time.perf_counter() - t0
    launches["lm_asha"] = G.KERNEL.launches
    G.KERNEL.launches = 0
    t0 = time.perf_counter()
    out_s = HB.successive_halving(fn, space, max_budget=LM_ASHA["max_budget"], min_budget=1,
                                  eta=LM_ASHA["eta"], n_configs=27, algo=tpe.suggest,
                                  rstate=np.random.default_rng(0))
    sync_s = time.perf_counter() - t0
    launches["lm_sha_host"] = G.KERNEL.launches
    pop.update(asha_seconds=asha_s, sha_host_seconds=sync_s, asha_best_loss=out_a["best_loss"],
               sha_host_best_loss=out_s["best_loss"], asha_warm_seconds=warm_s,
               asha_peak_gb=peak_gb())
    log(f"[14d] bench_asha_device: budget_objective() (TinyLM vocab 16, d 16, one layer), "
        f"every rung budget warmed (captured) in {warm_s:.3f} s; asha({LM_ASHA}) with "
        f"tpe.suggest on the card: {asha_s:.4f} s, {len(out_a['trials'])} evaluations, rungs "
        f"{out_a['rungs']}, best {out_a['best_loss']:.6f}, {len(expected)} rung-0 asks, "
        f"gmm_llr launches {launches['lm_asha']} (one per ask on 20 or more completed "
        f"trials: {sum(expected)}); successive_halving(n_configs=27) at equal jobs: "
        f"{sync_s:.4f} s, {len(out_s['trials'])} evaluations, best {out_s['best_loss']:.6f}, "
        f"launches {launches['lm_sha_host']}; peak memory {pop['asha_peak_gb']:.3f} GB")
    assert len(out_a["trials"]) == LM_ASHA["max_jobs"] and len(out_s["trials"]) == 40
    assert launches["lm_asha"] == sum(expected), (launches["lm_asha"], sum(expected))
    assert np.isfinite(out_a["best_loss"]) and np.isfinite(out_s["best_loss"])
    CHECKED_SHAPES["lm_asha"] = check_shapes("lm_asha", asha_shapes, seed=142)

    # -- 14e. ResNet-20 at its full width --------------------------------
    torch.cuda.reset_peak_memory_stats()
    net = TR.resnet20()
    params = TR.init_population(net, RESNET_POP, R.key(0, device=dev),
                                image_size=RESNET_IMAGE)
    momentum = {k: torch.zeros_like(v) for k, v in params.items()}
    images, labels = TR.synthetic_cifar_batch(R.key(1, device=dev), RESNET_BATCH, RESNET_IMAGE)
    lr = torch.exp(torch.linspace(np.log(0.3), np.log(0.003), RESNET_POP, device=dev))
    wd = torch.exp(torch.linspace(np.log(1e-5), np.log(1e-3), RESNET_POP, device=dev))
    step = TR.make_population_train_step(net)
    step(params, momentum, lr, wd, images, labels)  # warm-up: the algorithms' choice
    torch.cuda.synchronize()
    step_ms, step_losses = [], []
    p, m = params, momentum
    for _ in range(RESNET_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        p, m, loss = step(p, m, lr, wd, images, labels)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        step_losses.append(loss.cpu().numpy())
    first, last = step_losses[0], step_losses[-1]
    ms = statistics.median(step_ms)
    pop.update(resnet_ms_per_step=ms, resnet_step_ms=step_ms,
               resnet_member_images_per_s=RESNET_POP * RESNET_BATCH / (ms / 1e3),
               resnet_first_best_loss=float(first.min()),
               resnet_last_best_loss=float(last.min()), resnet_peak_gb=peak_gb())
    log(f"[14e] resnet20 population of {RESNET_POP} (lr {lr.cpu().numpy().round(5).tolist()}), "
        f"batch {RESNET_BATCH} of {RESNET_IMAGE}x{RESNET_IMAGE}x3: ms per step (CUDA events) "
        f"{[round(t, 3) for t in step_ms]}, median {ms:.3f} ms, "
        f"{pop['resnet_member_images_per_s']:.1f} member-images/s; losses at the first step "
        f"{first.round(5).tolist()}, at the last {last.round(5).tolist()}; peak memory "
        f"{pop['resnet_peak_gb']:.3f} GB")
    assert all(np.isfinite(x).all() for x in step_losses)
    assert len(np.unique(last)) > 1, "the members' losses do not differ"
    assert last.min() < first.min(), (first.min(), last.min())
    del p, m, params, momentum

    torch.cuda.reset_peak_memory_stats()
    obj = TR.population_objective(width=16, image_size=RESNET_IMAGE, batch_size=RESNET_BATCH,
                                  n_steps=3)
    trials = H.Trials()
    G.KERNEL.launches = 0
    with launch_shapes() as rn_shapes:
        t0 = time.perf_counter()
        H.fmin(obj, TR.hpo_space(), algo=tpe.suggest, max_evals=RESNET_FMIN_TRIALS,
               trials=trials, rstate=np.random.default_rng(0), show_progressbar=False)
        rn_s = time.perf_counter() - t0
    launches["resnet_fmin"] = G.KERNEL.launches
    rn_losses = trials.losses()
    pop.update(resnet_fmin_seconds=rn_s, resnet_fmin_ms_per_trial=rn_s / RESNET_FMIN_TRIALS * 1e3,
               resnet_fmin_best_loss=float(min(rn_losses)), resnet_fmin_peak_gb=peak_gb())
    log(f"[14e] fmin(resnet.population_objective(width=16, image_size {RESNET_IMAGE}, batch "
        f"{RESNET_BATCH}, 3 steps), hpo_space(), tpe.suggest, {RESNET_FMIN_TRIALS} trials): "
        f"{rn_s:.3f} s, {rn_s / RESNET_FMIN_TRIALS * 1e3:.2f} ms per trial, best "
        f"{min(rn_losses):.6f}, gmm_llr launches {launches['resnet_fmin']}; peak memory "
        f"{pop['resnet_fmin_peak_gb']:.3f} GB")
    assert len(rn_losses) == RESNET_FMIN_TRIALS and np.isfinite(rn_losses).all()
    assert launches["resnet_fmin"] == RESNET_FMIN_TRIALS - 20, launches
    CHECKED_SHAPES["resnet_fmin"] = check_shapes("resnet_fmin", rn_shapes, seed=143)
    pop["seconds"] = time.perf_counter() - t_phase
    log(f"[14] {pop['seconds']:.1f} s")
    return launches, pop


# the reference battery's seeds and statistic (tests/test_domains.py):
# a domain's target is met when the median best loss over them is at most it
BASELINE_SEEDS = (0, 1, 2, 3, 4)
BASELINE_THRESHOLDS = ("quadratic1", "branin", "hartmann6")
BASELINE_TRIALS = 100  # the surrogate's and NAS-Bench-201's evaluations
CPU_STREAM_SEEDS = (0, 1)  # 15d: the seeds of (a) whose streams rerun on the CPU
NORTH_STAR_ASKS = 15  # bench.py's bench_host_tpe: one warm-up ask, then 15 timed
NATIVE_RTOL = {"adaptive_parzen": 1e-12, "gmm_lpdf": 1e-9}  # tests/test_native.py:38, :83


def baseline_domains():
    """BASELINE.json configurations #1 (``quadratic1``), #2 (``branin``,
    ``hartmann6``), #3 (the XGBoost surrogate) and #5 (NAS-Bench-201):
    ``(name, fn, space, n_trials, target, global_min)``; the surrogate's
    minimum is its best known loss."""
    from hyperopt_tpu_torch.models import nasbench, surrogate
    from hyperopt_tpu_torch.models.synthetic import DOMAINS

    out = []
    for name in BASELINE_THRESHOLDS:
        d = DOMAINS[name]
        (n, target), = d.targets.items()
        out.append((name, d.fn, d.make_space, n, target, d.global_min))
    out.append(("surrogate", surrogate.objective, surrogate.space, BASELINE_TRIALS, None,
                surrogate.best_known()))
    out.append(("nasbench", nasbench.objective, nasbench.space, BASELINE_TRIALS, None,
                nasbench.optimal_loss()))
    return out


@contextlib.contextmanager
def strict_native():
    """``HYPEROPT_TPU_NATIVE=1`` inside the block: a failed build of the
    native host library raises instead of falling back to numpy."""
    before = os.environ.get("HYPEROPT_TPU_NATIVE")
    os.environ["HYPEROPT_TPU_NATIVE"] = "1"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("HYPEROPT_TPU_NATIVE", None)
        else:
            os.environ["HYPEROPT_TPU_NATIVE"] = before


@contextlib.contextmanager
def native_calls(native):
    """Record the inputs of the first native call at each shape made inside
    the block: ``{(fn, shape...): (args, kwargs)}``.  The calls and their
    results are unchanged."""
    import numpy as np

    seen, real = {}, {"gmm_lpdf": native.gmm_lpdf, "adaptive_parzen": native.adaptive_parzen}

    def recorder(name):
        def call(*args, **kw):
            key = (name, len(np.atleast_1d(args[0])), len(np.atleast_1d(args[1]))
                   if name == "gmm_lpdf" else args[4],
                   *(kw.get(k) is None for k in ("low", "high", "q")), kw.get("logspace"))
            if key not in seen:
                seen[key] = ([np.array(a) if isinstance(a, np.ndarray) else a for a in args],
                             dict(kw))
            return real[name](*args, **kw)
        return call

    for name in real:
        setattr(native, name, recorder(name))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(native, name, fn)


def phase15(card):
    """BASELINE.json configurations #1, #2, #3 and #5 on the card: (c) the
    native host library built under strict mode; (a) each configuration's
    ``fmin`` with the card's TPE and with the host TPE at the battery's
    seeds (the card's median best at the target on the three threshold
    domains); (c) the library against numpy at every shape (a) gave it;
    (d) the card's streams beside the CPU's (:func:`phase15d`); (e) the
    kernel at every launch shape.  Returns the card's launches by
    path, the numbers, and (b), the north-star comparison, to run on
    phase 4's history."""
    t_phase = time.perf_counter()
    launches, shapes, out = {}, {}, {"domains": {}}
    card_trials = {}
    with strict_native():
        north_star = phase15_runs(card, launches, shapes, out, card_trials)
    out["margins"] = phase15d(card, card_trials)
    # -- 15e. the kernel at every launch shape of the card's runs -----------
    for path, seen in shapes.items():
        if seen:
            CHECKED_SHAPES[path] = check_shapes(f"15 {path}, {card}", seen, seed=151)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[15] {card}: phase 15 took {out['seconds']:.1f} s")
    return {k: v for k, v in launches.items() if not k.endswith("_host")}, out, north_star


def phase15_runs(card, launches, shapes, out, card_trials):
    """Phase 15's runs under strict mode (see :func:`phase15`); keeps the
    card's ``Trials`` of each configuration and seed in ``card_trials``
    for (d); returns (b)."""
    import unittest.mock

    import numpy as np

    import hyperopt_tpu_torch as H
    from hyperopt_tpu_torch import native, tpe_host

    # -- 15c. the native library, built under strict mode ------------------
    t0 = time.perf_counter()
    assert native.available(), "the native library did not build"
    build_s = time.perf_counter() - t0
    build_dir = os.path.join(os.path.dirname(os.path.abspath(H.__file__)), "_build")
    lib = native.lib_path()
    assert os.path.dirname(lib) == build_dir and os.path.exists(lib), lib
    assert tpe_host._native() is native
    log(f"[15c] HYPEROPT_TPU_NATIVE=1: {os.path.relpath(lib, os.path.dirname(build_dir))} built "
        f"and loaded in {build_s:.2f} s")
    out["native"] = dict(lib=os.path.basename(lib), build_s=build_s)

    # -- 15a. the configurations, the card's TPE beside the host TPE -------
    with native_calls(native) as calls:
        for name, fn, space, n, target, gmin in baseline_domains():
            rec = dict(trials=n, target=target, global_min=gmin, seeds=list(BASELINE_SEEDS))
            for algo_name, algo, path in (("card", H.tpe.suggest, f"baseline_{name}"),
                                          ("host", tpe_host.suggest, f"baseline_{name}_host")):
                bests, walls, statuses = [], [], set()

                def run_seeds():
                    for seed in BASELINE_SEEDS:
                        trials = H.Trials()
                        t0 = time.perf_counter()
                        H.fmin(fn, space(), algo=algo, max_evals=n, trials=trials,
                               rstate=np.random.default_rng(seed), show_progressbar=False)
                        p11_sync()
                        walls.append(time.perf_counter() - t0)
                        assert len(trials.trials) == n
                        statuses.update(t["result"]["status"] for t in trials.trials)
                        bests.append(float(min(trials.losses())))
                        if algo_name == "card":
                            card_trials.setdefault(name, {})[seed] = trials

                _, n_launch = counted_run(launches, shapes, path, run_seeds)
                median = float(np.median(bests))
                rec[algo_name] = dict(best=bests, median_best=median, launches=n_launch,
                                      ms_per_trial=sum(walls) / (n * len(walls)) * 1e3)
                log(f"[15a] {card}: {name} ({n} trials, target {target}, minimum {gmin:.6f}), "
                    f"{'tpe.suggest on the card' if algo_name == 'card' else 'tpe_host.suggest'}: "
                    f"best {[round(b, 6) for b in bests]} over seeds {list(BASELINE_SEEDS)}, "
                    f"median {median:.6f}; {rec[algo_name]['ms_per_trial']:.3f} ms per trial; "
                    f"gmm_llr launches {n_launch}")
                assert statuses == {H.STATUS_OK}, (name, algo_name, statuses)
                cont = name != "nasbench"  # NAS-Bench-201 is all categorical
                want = (n - 20) * len(BASELINE_SEEDS) if algo_name == "card" and cont else 0
                assert n_launch == want, (name, algo_name, n_launch, want)
                if algo_name == "card" and target is not None:
                    assert median <= target, (
                        f"{name}: the card's TPE missed its target, median {median} > {target}")
            out["domains"][name] = rec

    # -- 15c. the library against numpy at the shapes (a) gave it ----------
    worst = {"adaptive_parzen": 0.0, "gmm_lpdf": 0.0}
    for key, (args, kw) in sorted(calls.items(), key=str):
        name = key[0]
        if name == "adaptive_parzen":
            got = native.adaptive_parzen(*args, **kw)
            want = tpe_host.adaptive_parzen_normal_numpy(*args, **kw)
        else:
            kw = dict(kw)
            logspace = bool(kw.pop("logspace", False))
            oracle = tpe_host.LGMM1_lpdf_numpy if logspace else tpe_host.GMM1_lpdf_numpy
            got = [native.gmm_lpdf(*args, logspace=logspace, **kw)]
            want = [oracle(*args, **kw)]
        tol = NATIVE_RTOL[name]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=str(key))
            worst[name] = max(worst[name], float(np.max(np.abs(g - w), initial=0.0)))
    n_shapes = {f: sum(k[0] == f for k in calls) for f in worst}
    log(f"[15c] the library against numpy at every shape of (a): adaptive_parzen at "
        f"{n_shapes['adaptive_parzen']} shapes (max abs diff {worst['adaptive_parzen']:.3e}, "
        f"tolerance 1e-12), gmm_lpdf at {n_shapes['gmm_lpdf']} (max abs diff "
        f"{worst['gmm_lpdf']:.3e}, tolerance 1e-9)")
    assert all(n_shapes.values()), n_shapes
    out["native"].update(shapes=n_shapes, max_abs_diff=worst)

    def north_star(history, card_suggest_ms, card_ask_ms):
        """(b) ``bench_host_tpe``'s protocol on ``history``: one warm-up
        ask, then NORTH_STAR_ASKS timed asks of ``tpe_host.suggest``, with
        the native library and with ``_native`` patched to None."""
        from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn

        domain = H.Domain(mixed_space_fn, mixed_space(), device="cuda")
        rates = {}
        for mode in ("native", "numpy"):
            ctx = (strict_native() if mode == "native"
                   else unittest.mock.patch.object(tpe_host, "_native", lambda: None))
            with ctx:
                assert (tpe_host._native() is native) == (mode == "native")
                tpe_host.suggest([10_000], domain, history, seed=0)
                t0 = time.perf_counter()
                for i in range(NORTH_STAR_ASKS):
                    tpe_host.suggest([10_001 + i], domain, history, seed=i)
                dt = time.perf_counter() - t0
            rates[mode] = NORTH_STAR_ASKS / dt
        card_rate = 1e3 / card_suggest_ms
        log(f"[15b] {card}: tpe_host.suggest on {len(history.trials)} observations of "
            f"mixed_space() (bench_host_tpe's protocol, {NORTH_STAR_ASKS} timed asks): native "
            f"library {rates['native']:.2f} suggestions/s ({1e3 / rates['native']:.3f} ms per "
            f"ask), numpy {rates['numpy']:.2f} ({1e3 / rates['numpy']:.3f} ms); the card's "
            f"tpe.suggest in phase 4's window {card_rate:.2f} suggestions/s ({card_suggest_ms:.3f} "
            f"ms in tpe.suggest, {card_ask_ms:.3f} ms per ask and evaluation)")
        return dict(observations=len(history.trials), asks=NORTH_STAR_ASKS,
                    host_native_per_s=rates["native"], host_numpy_per_s=rates["numpy"],
                    card_per_s=card_rate, card_suggest_ms=card_suggest_ms,
                    card_ask_ms=card_ask_ms)

    return north_star


def departure(ps, card_docs, cpu_docs):
    """The first trial at which two ``fmin`` streams pick differently,
    and the labels that differ there: a categorical (or inactive) value
    that is not equal, or a continuous one beyond phase 5's rtol 1e-4,
    atol 1e-5 (the card's and the CPU's draws of one candidate differ in
    the last bits).  ``(None, [])`` where they never part."""
    import numpy as np

    cont = {ps.labels[i] for i in ps.cont_idx}
    for t, (a, b) in enumerate(zip(card_docs, cpu_docs)):
        va, vb = a["misc"]["vals"], b["misc"]["vals"]
        differ = []
        for label in ps.labels:
            x, y = va.get(label, []), vb.get(label, [])
            if len(x) != len(y):
                differ.append(label)
            elif x and (not np.isclose(x[0], y[0], rtol=1e-4, atol=1e-5) if label in cont
                        else x[0] != y[0]):
                differ.append(label)
        if differ:
            return t, differ
    return None, []


def phase15d(card, card_trials):
    """(d): each configuration's ``fmin`` stream of ``tpe.suggest`` on the
    CPU at the seeds :data:`CPU_STREAM_SEEDS` of (a), beside the card's:
    the first departure, and there, on the CPU's history, the pick margin
    of each dimension that differs (:func:`sweep_margins` at TPE's
    defaults and the ask's own seed).  A departure at a startup trial,
    or one whose worst margin is :data:`NEAR_TIE` or more, fails the
    phase once every stream is printed."""
    import numpy as np

    import hyperopt_tpu_torch as H
    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch import tpe
    from hyperopt_tpu_torch.ops import kernels as TK
    from hyperopt_tpu_torch.torch_trials import obs_buffer_for, packed_space_for

    t_phase, out, faults = time.perf_counter(), {}, []
    for name, fn, space, n, _target, _gmin in baseline_domains():
        for seed in CPU_STREAM_SEEDS:
            seeds = []

            def algo(new_ids, domain, trials, s):
                seeds.append(int(s))
                return tpe.suggest(new_ids, domain, trials, s)

            cpu = H.Trials()
            H.fmin(fn, space(), algo=algo, max_evals=n, trials=cpu,
                   rstate=np.random.default_rng(seed), show_progressbar=False, device="cpu")
            domain = H.Domain(fn, space(), device="cpu")
            ps = packed_space_for(domain)
            t, labels = departure(ps, card_trials[name][seed].trials, cpu.trials)
            rec = dict(first_departure=t, labels=labels, startup=None, margins={})
            if t is not None:
                rec["startup"] = t < tpe._default_n_startup_jobs
                if not rec["startup"]:
                    hist = H.trials_from_docs(cpu.trials[:t])
                    # the ask replayed from (history, seed) is the CPU stream's trial t
                    (doc,) = tpe.suggest([t], domain, hist, seeds[t])
                    assert doc["misc"]["vals"] == cpu.trials[t]["misc"]["vals"], (name, seed, t)
                    state = obs_buffer_for(domain, hist).device_arrays(
                        pow2_cap=TK.DEFAULT_ABOVE_CAP)
                    m = sweep_margins(ps, state, R.key(seeds[t] % (2**31 - 1)), tpe._default_gamma,
                                      tpe._default_prior_weight, tpe._default_n_EI_candidates,
                                      tpe._default_n_EI_candidates_cat, 1, pad_gamma=None)[:, 0]
                    rec["margins"] = {lab: float(m[ps.labels.index(lab)]) for lab in labels}
            worst = max(rec["margins"].values(), default=None)
            verdict = ("the streams never part" if t is None
                       else "a departure at a startup trial: a port fault" if rec["startup"]
                       else f"a near-tie (margin below {NEAR_TIE})" if worst < NEAR_TIE
                       else f"NOT a near-tie (margin {worst:.6g} >= {NEAR_TIE}): a port fault")
            log(f"[15d] {card}: {name} seed {seed}, tpe.suggest on the card beside the CPU "
                f"({n} trials): first departure at trial "
                f"{'none' if t is None else t}"
                + ("" if t is None else f" ({', '.join(labels)}); pick margins on the CPU "
                   + ", ".join(f"{k} {v:.6g}" for k, v in rec["margins"].items()))
                + f"; best {min(card_trials[name][seed].losses()):.6f} on the card, "
                f"{min(cpu.losses()):.6f} on the CPU; {verdict}")
            out[f"{name}/{seed}"] = rec
            if t is not None and (rec["startup"] or worst >= NEAR_TIE):
                faults.append((name, seed, t, rec["margins"]))
    log(f"[15d] {card}: the CPU streams took {time.perf_counter() - t_phase:.1f} s")
    assert not faults, f"departures at startup or past a near-tie: {faults}"
    return out


# cut from 300 when the whole script took 1095 s on an H100 (phase 10: 290
# s of it) against its 1200 s limit, and from 200 when it took 1030-1035 s
# (phase 10: 170-172 s); every kill point below fires at the 100th trial,
# so each resumed run still has trials to ask
PHASE10_TRIALS = 120
# the hit of each crash point to kill at, past startup: per tell or round
# for the serve points, per append (an ask and a tell per trial) or per
# bundle (every 25 tells; the trials pickle and the bundle each fire the
# tmp point) for the driver's: the 100th trial, or its bundle
SERVE_KILL_AT = 100
DRIVER_KILL_AT = {"before_wal_append": 200, "after_wal_append_before_tell": 200,
                  "after_tell_before_ask_ahead": 100, "after_ckpt_tmp_before_rename": 7,
                  "after_ckpt_publish_before_wal_reset": 4}
PHASE10_CONTAINMENT_TRIALS = 100


def phase10(card):
    """Durable fmin on the card (``mixed_space()``, ``mixed_space_fn``,
    ``tpe.suggest`` at its defaults, PHASE10_TRIALS trials): (a) the
    engine-routed ``fmin(engine=True)`` at ``ask_ahead`` 1 and 4, bitwise
    the solo fused stream, one ``gmm_llr`` launch per ask, timed in pairs
    with the solo fused driver; (b) the same run on a caller-built
    ``SuggestService`` over a study root, killed once at each
    ``SERVE_CRASH_POINTS`` point and resumed; (c) the solo durable driver
    (``DriverRecovery``) killed once at each ``DRIVER_CRASH_POINTS`` point
    and resumed; (d) ATPE through its ``host_algo`` hook on a background
    service, bitwise the solo ATPE, launched from the loop thread; (e)
    ``catch``/``trial_timeout`` failures durable and not run again after a
    kill; (f) an armed ``FlightRecorder`` on (a)'s run.  Returns each
    path's launches and the kernel checked at every launch shape the
    paths gave it (``CHECKED_SHAPES``)."""
    import tempfile
    import threading

    import numpy as np
    import torch

    import hyperopt_tpu_torch as H
    from hyperopt_tpu_torch.base import STATUS_FAIL
    from hyperopt_tpu_torch.client import resolve_engine_algo
    from hyperopt_tpu_torch.distributed.faults import (DRIVER_CRASH_POINTS, SERVE_CRASH_POINTS,
                                                       FaultPlan, SimulatedCrash)
    from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn
    from hyperopt_tpu_torch.obs import FlightRecorder, audit_flight_log, read_flight_log
    from hyperopt_tpu_torch.ops import gmm_scores as G
    from hyperopt_tpu_torch.serve import SuggestService
    from hyperopt_tpu_torch.utils.checkpoint import DriverRecovery, load_trials
    from hyperopt_tpu_torch.utils.wal import TellWAL

    n = PHASE10_TRIALS
    launches, shapes = {}, {}
    fused = H.partial(H.tpe.suggest, fused=True)

    def stream(trials):
        return [(t["misc"]["vals"], t["result"]) for t in trials.trials]

    def fmin(algo, trials, seed=0, n_trials=n, **kw):
        H.fmin(mixed_space_fn, mixed_space(), algo=algo, max_evals=n_trials, trials=trials,
               rstate=np.random.default_rng(seed), show_progressbar=False, **kw)
        torch.cuda.synchronize()
        return trials

    def counted(path, run):
        """``run()`` with the launch counter at 0 just before it and each
        launch's shape recorded; the launches are added to ``path``."""
        G.KERNEL.launches = 0
        with launch_shapes() as seen:
            t0 = time.perf_counter()
            out = run()
            dt = time.perf_counter() - t0
        launches[path] = launches.get(path, 0) + G.KERNEL.launches
        shapes.setdefault(path, set()).update(seen)
        return out, dt, G.KERNEL.launches

    # -- 10a. engine-routed fmin, in pairs with the solo fused driver ------
    walls = {"solo_fused": [], "engine_k1": [], "engine_k4": []}
    ref = None
    for rep in range(2):
        order = ("solo_fused", "engine_k1", "engine_k4")
        for name in (order if rep == 0 else order[::-1]):
            if name == "solo_fused":
                trials, dt, _ = counted(f"fmin_fused_{n}", lambda: fmin(
                    fused, H.TorchTrials(resident=True)))
                ref = ref or stream(trials)
                assert stream(trials) == ref
            else:
                k = 1 if name == "engine_k1" else 4
                trials, dt, nl = counted("engine_fmin", lambda k=k: fmin(
                    H.tpe.suggest, H.Trials(), engine=True, ask_ahead=k))
                assert stream(trials) == ref, f"engine at ask_ahead={k} is not the solo stream"
                assert nl == n, f"engine ask_ahead={k}: {nl} launches for {n} asks"
            walls[name].append(dt)
    launches[f"fmin_fused_{n}"] //= 2
    launches["engine_fmin"] //= 4
    ms = {k: [1e3 * w / n for w in v] for k, v in walls.items()}
    log(f"[10a] {card}: engine-routed fmin, {n} trials of mixed_space: bitwise the solo fused "
        f"stream at ask_ahead 1 and 4, {launches['engine_fmin']} gmm_llr launches per run (one "
        "per ask: the stacked step runs the TPE body every round); ms per trial in pairs "
        "(solo fused, engine k1, engine k4, then reversed): "
        + "; ".join(f"{k} " + ", ".join(f"{x:.3f}" for x in v) for k, v in ms.items()))
    results = {"ms_per_trial": ms}

    kw = resolve_engine_algo(H.tpe.suggest).algo_kw
    with tempfile.TemporaryDirectory() as tmp:
        # -- 10b. kill and resume through a study root --------------------
        def service(root, fs, **extra):
            return SuggestService(mixed_space(), root=root, fs=fs, background=False,
                                  max_batch=1, n_startup_jobs=20, snapshot_cadence=25,
                                  finite_check=False, **extra, **kw)

        resumed_rounds = 0
        for point in SERVE_CRASH_POINTS:
            root = os.path.join(tmp, point)
            plan = FaultPlan(seed=0).arm(point, at=SERVE_KILL_AT)
            try:
                fmin(H.tpe.suggest, H.Trials(), engine=service(root, plan.fs()))
                raise AssertionError(f"{point} never fired")
            except SimulatedCrash:
                pass
            svc = service(root, FaultPlan(seed=1).fs())
            trials, dt, nl = counted("engine_resume", lambda svc=svc: fmin(
                H.tpe.suggest, H.Trials(), engine=svc))
            total = TellWAL(os.path.join(root, "fmin.wal")).total_tells
            assert stream(trials) == ref, f"resume after {point} is not the uninterrupted run"
            assert [t["tid"] for t in trials.trials] == list(range(n)), point
            assert total == n, f"{point}: the WAL logged {total} tells for {n} trials"
            assert 0 < nl == svc.counters["dispatch_count"], (point, nl)
            resumed_rounds += nl
            log(f"[10b] {card}: killed at {point} (hit {SERVE_KILL_AT}) and resumed: bitwise, "
                f"{total} tells logged for {n} trials, {nl} launches in the resumed run "
                f"({1e3 * dt / max(nl, 1):.3f} ms per resumed trial)")

        # -- 10c. the solo durable driver ---------------------------------
        for point in DRIVER_CRASH_POINTS:
            path = os.path.join(tmp, f"{point}.pkl")
            plan = FaultPlan(seed=0).arm(point, at=DRIVER_KILL_AT[point])
            try:
                fmin(fused, H.TorchTrials(resident=True),
                     resume_from=DriverRecovery(path, fs=plan.fs(), cadence=25))
                raise AssertionError(f"{point} never fired")
            except SimulatedCrash:
                pass
            rec = DriverRecovery(path, cadence=25)
            _, dt, nl = counted("durable_fmin", lambda rec=rec: fmin(
                fused, H.TorchTrials(resident=True), resume_from=rec))
            final = load_trials(path)
            assert stream(final) == ref, f"resume after {point} is not the uninterrupted run"
            assert [t["tid"] for t in final.trials] == list(range(n)), point
            assert rec.wal.total_tells == n, (point, rec.wal.total_tells)
            assert 0 < nl <= n - 20 + 1, (point, nl)
            log(f"[10c] {card}: killed at {point} (hit {DRIVER_KILL_AT[point]}) and resumed: "
                f"bitwise, {rec.wal.total_tells} tells logged for {n} trials, {nl} launches in "
                f"the resumed run, {1e3 * rec.seconds_spent / n:.3f} ms of durability per trial")

        # -- 10d. ATPE through its host_algo hook --------------------------
        solo, solo_dt, solo_nl = counted(f"atpe_{n}", lambda: fmin(H.atpe.suggest, H.Trials(),
                                                                   seed=2))
        bg = SuggestService(mixed_space(), algo="atpe", max_batch=1, n_startup_jobs=20,
                            finite_check=False)
        names, real = [], G._launch_checked

        def recording(*args):
            names.append(threading.current_thread().name)
            return real(*args)

        G._launch_checked = recording
        try:
            hooked, dt, nl = counted("engine_atpe", lambda: fmin(H.atpe.suggest, H.Trials(),
                                                                 seed=2, engine=bg))
        finally:
            G._launch_checked = real
        served = bg.counters["host_algo_served"]
        bg.shutdown()
        assert stream(hooked) == stream(solo), "ATPE through the hook is not the solo ATPE"
        assert nl == solo_nl == n - 20, (nl, solo_nl)
        assert set(names) == {"serve-batcher"} and served == n, (set(names), served)
        log(f"[10d] {card}: ATPE through the host_algo hook of a background service: bitwise "
            f"the solo ATPE, {nl} launches (solo {solo_nl}), all from the serve-batcher thread; "
            f"ms per trial {1e3 * dt / n:.3f} (solo {1e3 * solo_dt / n:.3f})")

        # -- 10e. containment, durable across a kill ------------------------
        calls = []

        def flaky(cfg):
            calls.append(1)
            if len(calls) % 7 == 0:
                raise ValueError(f"boom at call {len(calls)}")
            if len(calls) == 30:
                time.sleep(0.5)
            return mixed_space_fn(cfg)

        m = PHASE10_CONTAINMENT_TRIALS
        root = os.path.join(tmp, "containment")

        def contained(fs, trials):
            H.fmin(flaky, mixed_space(), algo=H.tpe.suggest, max_evals=m, trials=trials,
                   rstate=np.random.default_rng(3), show_progressbar=False,
                   engine=service(root, fs), catch=(ValueError,), trial_timeout=0.2)
            return trials

        plan = FaultPlan(seed=0).arm("serve_after_wal_before_dispatch", at=m // 2)
        try:
            contained(plan.fs(), H.Trials())
            raise AssertionError("the containment kill never fired")
        except SimulatedCrash:
            pass
        before = len(calls)
        docs, _, nl = counted("engine_containment",
                              lambda: contained(FaultPlan(seed=1).fs(), H.Trials()))
        fails = {d["tid"]: d["result"]["failure"] for d in docs.trials
                 if d["result"]["status"] == STATUS_FAIL}
        assert [d["tid"] for d in docs.trials] == list(range(m))
        assert len(calls) == m, f"{len(calls)} evaluations for {m} trials: a failure ran again"
        assert all(f.startswith(("ValueError: boom", "TrialTimeout")) for f in fails.values())
        assert sum(f.startswith("TrialTimeout") for f in fails.values()) == 1, fails
        assert sum(f.startswith("ValueError") for f in fails.values()) == m // 7, fails
        log(f"[10e] {card}: {m} trials with catch= and trial_timeout=0.2, killed after "
            f"{before} evaluations and resumed: STATUS_FAIL docs with their reasons at tids "
            f"{sorted(fails)}, {len(calls)} evaluations in all (none ran again), {nl} launches "
            "in the resumed run")

        # -- 10f. the recorder on (a)'s run ----------------------------------
        fpath = os.path.join(tmp, "flight.wal")
        rec = FlightRecorder(path=fpath)
        armed, dt, nl = counted("engine_recorder", lambda: fmin(
            H.tpe.suggest, H.Trials(), engine=True, recorder=rec))
        rec.close()
        spans = read_flight_log(fpath)
        assert stream(armed) == ref, "arming the recorder changed the stream"
        assert audit_flight_log(fpath) == [], audit_flight_log(fpath)
        assert sum(s["name"] == "driver.trial" for s in spans) == n and nl == n
        log(f"[10f] {card}: FlightRecorder armed on the engine run: bitwise the unarmed "
            f"stream, {len(spans)} spans exported, the log audits clean; "
            f"{1e3 * dt / n:.3f} ms per trial")

    for path, seen in shapes.items():
        if seen:
            CHECKED_SHAPES[path] = check_shapes(f"10 {path}", seen, seed=23)
    results["resumed_rounds"] = resumed_rounds
    return launches, results


# -- phase 11: the suggestion service as a network process -------------------
#: the device phases 11 and 12 serve on (None: the card; a CPU rehearsal
#: sets "cpu")
P11_DEVICE = None
P11_STUDIES, P11_TRIALS, P11_KILL_AT = 4, 60, 30
BURST = dict(n_clients=64, n_studies=4, asks_per_client=8, pool_width=32)
STORM_TRIALS = 20
SOCKET_ROUNDS = 6  # 7b's timed rounds, after one warm-up


def p11_sync():
    import torch

    if P11_DEVICE != "cpu":
        torch.cuda.synchronize()


def counted_run(launches, shapes, path, run):
    """``run()`` with the launch counter at 0 just before it and each
    launch's shape recorded; adds the launches to ``launches[path]`` and
    the shapes to ``shapes[path]``; returns the result and the launches."""
    from hyperopt_tpu_torch.ops import gmm_scores as G

    p11_sync()
    G.KERNEL.launches = 0
    with launch_shapes() as seen:
        result = run()
        p11_sync()
    launches[path] = launches.get(path, 0) + G.KERNEL.launches
    shapes.setdefault(path, set()).update(seen)
    return result, G.KERNEL.launches


def spawn_front(svc, **kw):
    """``serve_forever`` on 127.0.0.1, port 0, served from a daemon thread."""
    import threading

    from hyperopt_tpu_torch.serve.service import serve_forever

    srv = serve_forever(svc, host="127.0.0.1", port=0, **kw)
    threading.Thread(target=srv.serve_forever, name="serve-front", daemon=True).start()
    return srv


def close_front(srv):
    srv.shutdown()
    srv.server_close()


def script_start(module, args, log_path):
    """Start ``python -m module args`` from the checkout (on phase 11's
    device), its standard error appended to ``log_path``."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", module, *args]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p))
    err = open(log_path, "a")
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE, stderr=err,
                            text=True)
    err.close()
    return proc


def script_port(proc, log_path, timeout=120):
    """Read a started script's listening line; returns its port."""
    import select

    deadline = time.perf_counter() + timeout
    while True:
        ready, _, _ = select.select([proc.stdout], [], [], max(deadline - time.perf_counter(), 0))
        line = proc.stdout.readline() if ready else ""
        if "listening on 127.0.0.1:" in line:
            return int(line.split("127.0.0.1:")[1].split()[0])
        if not ready or not line or time.perf_counter() > deadline:
            proc.kill()
            proc.wait(timeout=30)
            with open(log_path) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"{proc.args[2]} did not start: {line!r}\n{tail}")


def serve_script_args(root, *extra):
    """``hyperopt_tpu_torch.serve.service``'s arguments at phase 11's
    settings on ``root``."""
    args = ["--space", "hyperopt_tpu_torch.models.synthetic:mixed_space", "--port", "0",
            "--root", root, "--n-startup-jobs", "3", *extra]
    if P11_DEVICE is not None:
        args += ["--device", P11_DEVICE]
    return args


def console_process(root, log_path):
    """Start the console script (``hyperopt_tpu_torch.serve.service``) on
    ``root`` and read its listening line; returns the process and its
    port."""
    proc = script_start("hyperopt_tpu_torch.serve.service", serve_script_args(root), log_path)
    return proc, script_port(proc, log_path)


def stop_process(proc):
    """SIGINT (the script shuts its service down), then SIGKILL past 30 s."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    proc.stdout.close()


def frame_call(port, req, timeout=120):
    """One request on a new binary-frame connection; asserts its reply is ok."""
    from hyperopt_tpu_torch.serve.frames import FrameConn, dial

    sock, f = dial("127.0.0.1", port, read_timeout=timeout)
    conn = FrameConn(f)
    try:
        reply = conn.call(req)
    finally:
        conn.close()
        sock.close()
    assert reply.get("ok"), reply
    return reply


def run_threads(targets):
    """Run each target on a thread; re-raise the first failure."""
    import threading

    errors = []

    def wrap(fn):
        def run():
            try:
                fn()
            except BaseException as e:  # ferried to the caller, re-raised there
                errors.append(e)
        return run

    threads = [threading.Thread(target=wrap(fn), daemon=True) for fn in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive(), "a client thread hung"
    if errors:
        raise errors[0]


def socket_rounds(port, names, seeds, rounds, streams):
    """``rounds`` of 7b's serve protocol over one binary-frame connection:
    one ``ask_batch`` frame for every study, then one pipelined ``tell``
    each; appends each study's vals to ``streams``; returns the wall."""
    from hyperopt_tpu_torch.serve.frames import FrameConn, dial

    sock, f = dial("127.0.0.1", port, read_timeout=300)
    conn = FrameConn(f)
    try:
        for n, s in zip(names, seeds):
            assert conn.call({"op": "create_study", "name": n, "seed": s})["ok"]
        walls = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            reply = conn.call({"op": "ask_batch", "names": names, "timeout": 300})
            assert reply["ok"], reply
            tells = []
            for n in names:
                r = reply["results"][n]
                assert r["ok"], (n, r)
                streams.setdefault(n, []).append(r["vals"])
                tells.append(conn.submit({"op": "tell", "study": n, "tid": r["tid"],
                                          "loss": serve_loss(r["vals"]), "vals": r["vals"]}))
            assert all(conn.drain(t)["ok"] for t in tells)
            walls.append(time.perf_counter() - t0)
    finally:
        conn.close()
        sock.close()
    return walls


def burst_run(tmp, binary, tag, counted, cfg=BURST):
    """The reference's burst protocol: ``cfg["n_clients"]`` socket
    clients, each pipelining ``cfg["asks_per_client"]`` asks (then their
    tells) to one of ``cfg["n_studies"]`` studies of a ``root=``
    background service under ``tmp``, from a pool of
    ``cfg["pool_width"]`` threads, on binary frames or JSON lines; run
    through ``counted(tag, run)``.  Every reply must be ok."""
    import concurrent.futures
    import tempfile

    import numpy as np

    from hyperopt_tpu_torch.models.synthetic import mixed_space
    from hyperopt_tpu_torch.serve import SuggestService
    from hyperopt_tpu_torch.serve.frames import FrameConn, dial

    broot = tempfile.mkdtemp(dir=tmp, prefix="burst_")
    svc = SuggestService(mixed_space(), root=broot, background=True, max_batch=64,
                         n_startup_jobs=3, n_cand=128, snapshot_cadence=1000,
                         max_queue=4096, study_queue_cap=64, device=P11_DEVICE)
    bnames = [f"b{i}" for i in range(cfg["n_studies"])]
    for i, n in enumerate(bnames):
        svc.create_study(n, seed=i)
    # warm the service with one in-process round before any client connects
    warm = [svc._handles[n].ask_async() for n in bnames]
    for n, fut in zip(bnames, warm):
        tid, vals = fut.result(timeout=120)
        svc._handles[n].tell(tid, 0.1 + (tid % 97) / 100.0)
    srv = spawn_front(svc)
    addr = srv.server_address[:2]
    bad = []

    def one_client(i):
        name = bnames[i % len(bnames)]
        sock, f = dial(*addr, read_timeout=120)
        served = 0
        try:
            conn = FrameConn(f, negotiate=binary)
            assert conn.binary is binary
            futs = [conn.submit({"op": "ask", "study": name, "timeout": 120})
                    for _ in range(cfg["asks_per_client"])]
            replies = [conn.drain(fut) for fut in futs]
            bad.extend(r for r in replies if not r.get("ok"))
            tells = [conn.submit({"op": "tell", "study": name, "tid": r["tid"],
                                  "loss": 0.1 + (r["tid"] % 97) / 100.0})
                     for r in replies if r.get("ok")]
            for fut in tells:
                r = conn.drain(fut)
                served += bool(r.get("ok"))
                if not r.get("ok"):
                    bad.append(r)
            conn.close()
        finally:
            sock.close()
        return served

    def run():
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(cfg["pool_width"]) as pool:
            served = sum(pool.map(one_client, range(cfg["n_clients"])))
        return served, time.perf_counter() - t0

    try:
        occ0 = len(svc.scheduler.occupancy)
        (served, dt), nl = counted(tag, run)
        c = svc.counters
        occ = [float(x) for x in list(svc.scheduler.occupancy)[occ0:]]
    finally:
        close_front(srv)
        svc.shutdown()
    n_asks = cfg["n_clients"] * cfg["asks_per_client"]
    assert not bad and served == n_asks, (served, bad[:3])
    return dict(asks_per_s=served / dt, wal_fsyncs_per_tell=c["wal_fsyncs"] / c["wal_tells"],
                occupancy=float(np.mean(occ)), launches=nl, rounds=len(occ))


def phase11(card):
    """The suggestion service as a network process on the card: (a) the
    console script as a process, killed once with SIGKILL and restarted on
    its root, 4 studies driven by ``RemoteStudy`` threads, bitwise the
    in-process service; (b) the reference's burst protocol on binary
    frames and on JSON lines; (c) 7b's serve protocol over the socket, in
    pairs with the in-process rounds; (d) a storm of network and file
    faults; (e) the device-metrics twin and the compiled loop's
    ``metrics_registry=``.  Returns the launches by path, the numbers,
    and (f), which runs last of all: a ``device_trace`` of served rounds."""
    import signal
    import tempfile

    import numpy as np
    import torch

    from hyperopt_tpu_torch.client import RemoteStudy
    from hyperopt_tpu_torch.distributed.faults import (NET_CRASH_POINTS, FaultPlan,
                                                       NetFaultPlan, SimulatedCrash)
    from hyperopt_tpu_torch.exceptions import Overloaded
    from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn
    from hyperopt_tpu_torch.serve import SuggestService
    from hyperopt_tpu_torch.serve.frames import FrameConn, dial

    t_phase = time.perf_counter()
    launches, shapes, out = {}, {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p11_")

    def counted(path, run):
        return counted_run(launches, shapes, path, run)

    # -- 11a. the console script as a process, killed and restarted -------
    names = [f"p{i}" for i in range(P11_STUDIES)]
    root, plog = os.path.join(tmp, "process"), os.path.join(tmp, "process.log")
    streams = {n: [] for n in names}

    def drive(port, name, seed, upto, recover):
        def run():
            c = RemoteStudy("127.0.0.1", port, name, seed=seed, read_timeout=120)
            if recover:  # the ask in flight at the kill: served again, or drawn again
                r = c.call({"op": "ask", "study": name, "timeout": 120, "recover": True})
                tid, vals = r["tid"], r["vals"]
                assert tid == len(streams[name]), (name, tid)
                c.tell(tid, serve_loss(vals), vals)
                streams[name].append(vals)
            while len(streams[name]) < upto:
                tid, vals = c.ask(timeout=120)
                assert tid == len(streams[name]), (name, tid)
                c.tell(tid, serve_loss(vals), vals)
                streams[name].append(vals)
            c.close()
        return run

    t0 = time.perf_counter()
    proc, port = console_process(root, plog)
    start_1 = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        run_threads([drive(port, n, i, P11_KILL_AT, False) for i, n in enumerate(names)])
        leg_1 = time.perf_counter() - t0
        rows_1 = {r["name"]: r.get("value") for r in frame_call(port, {"op": "metrics"})["metrics"]}
        # one ask per study in flight, its reply never read, then SIGKILL
        sock, f = dial("127.0.0.1", port, read_timeout=120)
        inflight = FrameConn(f)
        for n in names:
            inflight.submit({"op": "ask", "study": n, "timeout": 120})
        time.sleep(0.5)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
        inflight.close()
        sock.close()
    finally:
        stop_process(proc)
    t0 = time.perf_counter()
    proc, port = console_process(root, plog)
    start_2 = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        run_threads([drive(port, n, i, P11_TRIALS, True) for i, n in enumerate(names)])
        leg_2 = time.perf_counter() - t0
        health = frame_call(port, {"op": "health"})
        rows_2 = {r["name"]: r.get("value") for r in frame_call(port, {"op": "metrics"})["metrics"]}
    finally:
        stop_process(proc)
    # the same studies on an in-process service at the script's defaults
    ref = SuggestService(mixed_space(), max_batch=64, background=False, n_startup_jobs=3,
                         device=P11_DEVICE)
    handles = [ref.create_study(n, seed=i) for i, n in enumerate(names)]
    want = {}
    counted("socket_process", lambda: [serve_round(ref, handles, want)
                                       for _ in range(P11_TRIALS)])
    ref.shutdown()
    launches["socket_process"] = rows_1["serve_kernel_launches"] + rows_2["serve_kernel_launches"]
    n_bitwise = sum(streams[n] == [v for v in want[n]] for n in names)
    tells = health["counters"]["wal_tells"]
    per_trial = 1e3 * (leg_1 + leg_2) / (P11_STUDIES * P11_TRIALS)
    log(f"[11a] {card}: hyperopt-tpu-torch-serve as a process (--n-startup-jobs 3, the script's "
        f"n_cand 16), {P11_STUDIES} studies x {P11_TRIALS} trials by RemoteStudy threads on "
        f"binary frames, SIGKILLed after {P11_KILL_AT} tells per study with one ask each in "
        f"flight and restarted on its root: {n_bitwise} of {P11_STUDIES} streams bitwise the "
        f"in-process service's; wal_tells {tells}; dispatches {rows_1['serve_dispatch_total']} "
        f"+ {rows_2['serve_dispatch_total']}, gmm_llr launches {rows_1['serve_kernel_launches']} "
        f"+ {rows_2['serve_kernel_launches']}; {per_trial:.3f} ms wall per trial (legs "
        f"{leg_1:.2f} + {leg_2:.2f} s); process start {start_1:.2f} s, restart {start_2:.2f} s")
    assert n_bitwise == P11_STUDIES, "a served stream is not the in-process stream"
    assert tells == P11_STUDIES * P11_TRIALS, f"{tells} tells logged"
    assert rows_2["serve_dispatch_total"] >= P11_TRIALS - P11_KILL_AT - 1, rows_2
    assert rows_2["serve_kernel_launches"] == rows_2["serve_dispatch_total"] > 0, rows_2
    out["process"] = dict(ms_per_trial=per_trial, start_s=start_1, restart_s=start_2,
                          wal_tells=tells, bitwise=n_bitwise)

    # -- 11b. the reference's burst protocol, binary frames and JSON lines --
    def burst(binary, tag):
        return burst_run(tmp, binary, tag, counted)

    bursts = {"binary": [], "json": []}
    for binary in (True, False):  # one pair, in one call
        tag = "burst_binary" if binary else "burst_json"
        bursts["binary" if binary else "json"].append(burst(binary, tag))
    for proto, runs in bursts.items():
        log(f"[11b] {card}: burst on {proto} ({BURST['n_clients']} clients x "
            f"{BURST['asks_per_client']} pipelined asks over {BURST['n_studies']} studies, pool "
            f"{BURST['pool_width']}, root= background service, n_cand 128): asks/s "
            + ", ".join(f"{r['asks_per_s']:.1f}" for r in runs) + "; wal_fsyncs_per_tell "
            + ", ".join(f"{r['wal_fsyncs_per_tell']:.4f}" for r in runs) + "; mean co-batch "
            "occupancy " + ", ".join(f"{r['occupancy']:.4f}" for r in runs) + "; gmm_llr "
            "launches " + ", ".join(f"{r['launches']} in {r['rounds']} rounds" for r in runs)
            + "; every reply ok")
    out["burst"] = bursts

    # -- 11c. 7b's serve protocol over the socket, in pairs with 7b --------
    snames = [f"bench{i:03d}" for i in range(SERVE_STUDIES)]
    seeds = list(range(SERVE_STUDIES))

    def socket_serve(every=0, twin_ms=None):
        svc = SuggestService(mixed_space(), max_batch=SERVE_STUDIES, background=False,
                             n_startup_jobs=3, n_cand=128, device_metrics_every=every,
                             device=P11_DEVICE)
        if twin_ms is not None:
            real = svc.scheduler._dispatch_device_metrics

            def timed():
                t0 = time.perf_counter()
                real()
                twin_ms.append(1e3 * (time.perf_counter() - t0))

            svc.scheduler._dispatch_device_metrics = timed
        srv = spawn_front(svc)
        got = {}
        try:
            walls = socket_rounds(srv.server_address[1], snames, seeds, 1 + SOCKET_ROUNDS, got)
            c = svc.counters
            twin = svc.scheduler.device_metric_dispatches
        finally:
            close_front(srv)
            svc.shutdown()
        return got, walls[1:], c, twin

    def inprocess_serve():
        # open_service's settings, on phase 11's device
        svc = SuggestService(mixed_space(), max_batch=SERVE_STUDIES, background=False,
                             n_startup_jobs=3, n_cand=128, device=P11_DEVICE)
        handles = [svc.create_study(n, seed=s) for n, s in zip(snames, seeds)]
        got, walls = {}, []
        for _ in range(1 + SOCKET_ROUNDS):
            t0 = time.perf_counter()
            serve_round(svc, handles, got)
            p11_sync()
            walls.append(time.perf_counter() - t0)
        svc.shutdown()
        return got, walls[1:]

    pair_ms = {"socket": [], "in_process": []}
    socket_streams = inproc_streams = None
    for side in ("socket", "in_process", "in_process", "socket"):
        if side == "socket":
            (got, walls, c, twin), nl = counted("socket_serve_64", socket_serve)
            assert nl == 1 + SOCKET_ROUNDS == c["dispatch_count"], (nl, c["dispatch_count"])
            assert twin == 0
            socket_streams = socket_streams or got
            assert got == socket_streams
        else:
            got, walls = inprocess_serve()
            inproc_streams = inproc_streams or got
        pair_ms[side].append(1e3 * float(np.mean(walls)))
    launches["socket_serve_64"] //= 2
    n_bitwise = sum(socket_streams[n] == inproc_streams[n] for n in snames)
    log(f"[11c] {card}: 7b's protocol over the socket ({SERVE_STUDIES} studies, one ask_batch "
        f"frame then {SERVE_STUDIES} pipelined tells per round, 1 warm-up + {SOCKET_ROUNDS} "
        f"timed rounds): {n_bitwise} of {SERVE_STUDIES} streams bitwise the in-process rounds; "
        f"gmm_llr launches {launches['socket_serve_64']} in {1 + SOCKET_ROUNDS} rounds; ms per "
        f"round in pairs (socket, in-process, in-process, socket): socket "
        + ", ".join(f"{x:.3f}" for x in pair_ms["socket"]) + "; in-process "
        + ", ".join(f"{x:.3f}" for x in pair_ms["in_process"]))
    assert n_bitwise == SERVE_STUDIES, "the socket rounds are not the in-process rounds"
    out["socket_serve"] = dict(ms_per_round=pair_ms, bitwise=n_bitwise)

    # -- 11d. the storm: network and file faults ----------------------------
    tnames = [f"t{i}" for i in range(P11_STUDIES)]

    def storm(net_plan, fs_plan, tag):
        sroot = tempfile.mkdtemp(dir=tmp, prefix="storm_")
        svc = SuggestService(mixed_space(), root=sroot, background=True, max_batch=4,
                             n_startup_jobs=3, n_cand=128, snapshot_cadence=8,
                             fs=fs_plan.fs(), device=P11_DEVICE)
        srv = spawn_front(svc)
        port = srv.server_address[1]
        got, crashes = {n: [] for n in tnames}, []

        def client(name):
            def run():
                st = svc.scheduler.study(name)
                c, recover, pending = None, False, None
                while len(got[name]) < STORM_TRIALS:
                    try:
                        if c is None:  # the study exists: a (re)started client attaches
                            c = RemoteStudy("127.0.0.1", port, name, net_plan=net_plan,
                                            read_timeout=60, create=False)
                        if pending is None:
                            if recover:
                                r = c.call({"op": "ask", "study": name, "timeout": 60,
                                            "recover": True})
                                pending = (r["tid"], r["vals"])
                            else:
                                pending = c.ask(timeout=60)
                            recover = False
                        tid, vals = pending
                        c.tell(tid, mixed_space_fn(vals), vals)
                        got[name].append((tid, vals))
                        pending = None
                    except SimulatedCrash as e:  # this client died: a new one resumes
                        crashes.append((name, e.point))
                        c, recover = None, pending is None
                        if recover:
                            # as the reference's lost-ack test waits: let the ask the
                            # dead client sent reach the service before asking it to
                            # serve that ask again (a hello it died in sent none)
                            t_wait = time.perf_counter() + 2.0
                            while (st.next_tid <= len(got[name])
                                   and time.perf_counter() < t_wait):
                                time.sleep(0.005)
                if c is not None:
                    c.close()
            return run

        try:
            for n in tnames:  # created before the storm: the restarted clients re-attach
                svc.create_study(n, seed=int(n[1:]))
            (_, nl) = counted(tag, lambda: run_threads([client(n) for n in tnames]))
            hist = {n: svc.scheduler.study(n) for n in tnames}
            wal = {n: int(st.persist.wal.total_tells) for n, st in hist.items()}
            tids = {n: st.buf.tids[: st.buf.count].tolist() for n, st in hist.items()}
            cap = hygiene(svc) if net_plan is not None else None
        finally:
            close_front(srv)
            svc.shutdown()
        return got, wal, tids, crashes, nl, cap

    def hygiene(svc):
        """A second front on the storm's service: the connection cap's typed
        refusal, and a silent client reaped at the idle deadline."""
        srv = spawn_front(svc, max_conns=1, idle_timeout=0.5)
        addr = srv.server_address[:2]
        try:
            s1, f1 = dial(*addr, read_timeout=30)
            c1 = FrameConn(f1)
            assert c1.call({"op": "ping"})["pong"] is True
            s2, f2 = dial(*addr, read_timeout=30)
            try:
                FrameConn(f2)
                refused = None
            except Overloaded as e:
                refused = e.reason
            f2.close()
            s2.close()
            s1.settimeout(10.0)
            t0 = time.perf_counter()
            reaped = s1.recv(64) == b""  # we stay silent: the server hangs up
            reap_s = time.perf_counter() - t0
            c1.close()
            s1.close()
        finally:
            close_front(srv)
        assert refused == "max_connections", refused
        assert reaped, "the idle client was not reaped"
        return dict(refused=refused, reaped_after_s=reap_s)

    clean, clean_wal, clean_tids, _, _, _ = storm(None, FaultPlan(seed=0), "storm_clean")
    net = NetFaultPlan(seed=11, reset_rate=0.08, latency=0.002, truncate_rate=0.04, burst=2)
    net.arm(NET_CRASH_POINTS[0], at=40).arm(NET_CRASH_POINTS[1], at=70)
    files = FaultPlan(seed=7, rate=0.1, partial_rate=0.2)
    got, wal, tids, crashes, nl, cap = storm(net, files, "storm")
    launches.pop("storm_clean", None)
    shapes.pop("storm_clean", None)
    exact = all(wal[n] == STORM_TRIALS and tids[n] == list(range(STORM_TRIALS)) for n in tnames)
    n_bitwise = sum(got[n] == clean[n] for n in tnames)
    injected = {k: v for k, v in sorted(net.stats.items())}
    file_faults = {k: v for k, v in sorted(files.stats.items())}
    log(f"[11d] {card}: storm, {P11_STUDIES} RemoteStudy clients x {STORM_TRIALS} trials under "
        f"NetFaultPlan(reset 0.08, latency 2 ms, truncate 0.04) with both NET_CRASH_POINTS armed "
        f"once, against a root= service with FaultPlan(rate 0.1, partial 0.2): network "
        f"{injected}, files {file_faults}; client deaths {crashes}; zero lost and zero "
        f"duplicated tells: {exact} (WAL {wal}); {n_bitwise} of {P11_STUDIES} streams bitwise "
        f"the clean run's; gmm_llr launches {nl}; the cap refused with Overloaded("
        f"{cap['refused']}), a silent client reaped after {cap['reaped_after_s']:.2f} s")
    assert exact, (wal, tids)
    assert n_bitwise == P11_STUDIES, "the storm changed a stream"
    assert sorted(p for _, p in crashes) == sorted(NET_CRASH_POINTS), crashes
    assert net.stats["net:reset"] + net.stats["net:truncate"] > 0, injected
    assert sum(v for k, v in files.stats.items() if k.startswith("error:")) > 0, file_faults
    out["storm"] = dict(network=injected, files=file_faults, crashes=len(crashes), **cap)

    # -- 11e. the device utilities -----------------------------------------
    twin_ms = []
    (got, walls, c, twin), nl = counted("twin", lambda: socket_serve(2, twin_ms))
    assert got == socket_streams, "the twin changed a stream"
    assert twin == c["dispatch_count"] // 2 == len(twin_ms), (twin, c["dispatch_count"])
    assert nl == c["dispatch_count"] == 1 + SOCKET_ROUNDS
    log(f"[11e] {card}: 11c's rounds with device_metrics_every=2: the streams bitwise those at "
        f"cadence 0 (twin dispatches 0 there), {twin} twin dispatches in "
        f"{c['dispatch_count']} rounds, ms per twin dispatch "
        + ", ".join(f"{x:.3f}" for x in twin_ms) + " (host clock, its read of the card "
        "included)")
    from hyperopt_tpu_torch.device_loop import compile_fmin
    from hyperopt_tpu_torch.models.synthetic import mixed_space_fn_torch
    from hyperopt_tpu_torch.obs import MetricsRegistry

    reg = MetricsRegistry("dl")
    runner = compile_fmin(mixed_space_fn_torch, mixed_space(), max_evals=COMPILED_TRIALS,
                          chunk_size=COMPILED_TRIALS // 4, metrics_registry=reg,
                          batch_size=1, n_EI_candidates=128, n_EI_candidates_cat=24,
                          device=P11_DEVICE)
    res = runner(seed=7)
    rows = {r["name"]: r.get("value") for r in reg.collect()}
    log(f"[11e] {card}: compile_fmin(chunk_size={COMPILED_TRIALS // 4}, metrics_registry=reg): "
        f"obs_device_events_total {rows['obs_device_events_total']}, device_loop_trials_done "
        f"{rows['device_loop_trials_done']}, device_loop_best_loss "
        f"{rows['device_loop_best_loss']!r} (the run's best {float(res['best_loss'])!r}), "
        f"{rows['device_loop_trials_per_sec']:.1f} trials/s")
    assert rows["obs_device_events_total"] == 4 and rows["device_loop_trials_done"] == COMPILED_TRIALS
    assert rows["device_loop_best_loss"] == float(np.min(res["losses"])) == float(res["best_loss"])
    out["twin"] = dict(ms_per_dispatch=twin_ms, dispatches=twin,
                       compiled_rows=int(rows["obs_device_events_total"]))

    for path, seen in shapes.items():
        if seen:
            CHECKED_SHAPES[path] = check_shapes(f"11 {path}, {card}", seen, seed=29)
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"[11] {card}: phase 11 took {time.perf_counter() - t_phase:.1f} s")

    def trace_11f():
        """(f), last of all: a few served rounds under ``device_trace``; the
        Chrome trace in its logdir holds the ``gmm_llr`` kernel."""
        from hyperopt_tpu_torch.utils.profiling import device_trace as profiled

        svc, handles = open_service(P11_STUDIES)
        for _ in range(2):
            serve_round(svc, handles)
        logdir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
        try:
            with profiled(logdir):
                for _ in range(3):
                    serve_round(svc, handles)
                p11_sync()
            (name,) = os.listdir(logdir)
            with open(os.path.join(logdir, name)) as f:
                events = json.load(f)["traceEvents"]
        finally:
            svc.shutdown()
            shutil.rmtree(logdir, ignore_errors=True)
        kernels = [e for e in events if e.get("cat") == "kernel"]
        ours = [e for e in kernels if "gmm_llr" in e.get("name", "")]
        log(f"[11f] {card}: device_trace over 3 served rounds: {len(events)} events, "
            f"{len(kernels)} CUDA kernel events, {len(ours)} of them the gmm_llr kernel "
            f"({ours[0]['name'] if ours else None})")
        assert ours, "the device_trace holds no gmm_llr kernel event"
        return dict(events=len(events), kernels=len(kernels), gmm_llr_events=len(ours))

    return launches, out, trace_11f


# -- phase 12: the serve fleet ---------------------------------------------------
#: bench.py:777 bench_fleet's fleet (bench_pilot's starts at two replicas)
FLEET = dict(n_replicas=3, n_studies=12, rounds=3)
P12_STUDIES, P12_TRIALS, P12_KILL_AT = 4, 40, 20


def fleet_kw():
    """bench_fleet's and bench_pilot's replica settings, on phase 11's device."""
    return dict(max_batch=16, n_startup_jobs=3, n_cand=128, snapshot_cadence=64,
                device=P11_DEVICE)


def replica_counts(port, since=None):
    """A console replica's ``serve_kernel_launches`` and
    ``serve_dispatch_total`` from its ``metrics`` op, less ``since``."""
    rows = {r["name"]: r.get("value") for r in frame_call(port, {"op": "metrics"})["metrics"]}
    keys = ("serve_kernel_launches", "serve_dispatch_total")
    return {k: rows[k] - (since or {}).get(k, 0) for k in keys}


def run_fsck(*args):
    """``hyperopt_tpu_torch.distributed.fsck ... --format json`` as a
    process; returns its exit code and report."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-m", "hyperopt_tpu_torch.distributed.fsck", *args,
                           "--format", "json"], cwd=here, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=here))
    return proc.returncode, json.loads(proc.stdout)


def phase12(card, sfu_per_s):
    """The serve fleet on the card: (a) bench.py's bench_fleet protocol in
    one process (3 replicas, 12 studies, a replica killed), bitwise one
    service; (b) bench_pilot's protocol under the autoscaler, its flight log
    replayed; (c) the fleet as processes behind the router's console
    script, one replica SIGKILLed, then fsck; (d) the kernel at every launch
    shape of (a)-(c).  Returns the launches by path and the numbers."""
    import signal
    import tempfile
    import threading

    import torch

    from hyperopt_tpu_torch.client import RemoteStudy
    from hyperopt_tpu_torch.models.synthetic import mixed_space
    from hyperopt_tpu_torch.obs import FlightRecorder
    from hyperopt_tpu_torch.ops import gmm_scores as G
    from hyperopt_tpu_torch.serve import (Fleet, FleetPilot, FleetRouter, HashRing, PilotConfig,
                                          StudyClaim, SuggestService)
    from hyperopt_tpu_torch.serve.fleet import fleet_salt
    from hyperopt_tpu_torch.serve.replay import (ServiceTarget, load_workload, replay_fidelity,
                                                 replay_workload)

    t_phase = time.perf_counter()
    launches, shapes, out = {}, {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p12_")

    def counted(path, run):
        return counted_run(launches, shapes, path, run)

    def cold_audit(root, names, n_tells):
        """Every study restored from nothing but the root: its tells, once."""
        audit = SuggestService(mixed_space(), root=root, owner="audit", background=False,
                               **fleet_kw())
        try:
            for n in names:
                h = audit.create_study(n, takeover=True)
                tids = h._study.buf.tids[: h._study.buf.count].tolist()
                assert tids == list(range(n_tells)), (n, tids)
        finally:
            audit.shutdown()

    # -- 12a. bench_fleet's protocol, in one process ------------------------
    names = [f"f{i:03d}" for i in range(FLEET["n_studies"])]
    root = os.path.join(tmp, "fleet")
    fleet = Fleet(mixed_space(), root, n_replicas=FLEET["n_replicas"], **fleet_kw())
    router = FleetRouter(fleet)
    for i, n in enumerate(names):
        router.create_study(n, seed=i)
    streams = {n: [] for n in names}

    def take(n, tid, vals):
        assert tid == len(streams[n]), (n, tid)
        streams[n].append(vals)
        router.tell(n, tid, serve_loss(vals), vals=vals)

    def round_once():
        for n, (tid, vals) in sorted(router.ask_batch(names, timeout=300).items()):
            take(n, tid, vals)

    # bench.py:825-836: every replica padded to its slot cap once, so no
    # first materialization runs in the timed rounds or the failover
    for rid in sorted(fleet.replicas):
        rep = fleet.replicas[rid]
        pads = [rep.open_study(f"warm-{rid}-{i:02d}", seed=1000 + i)
                for i in range(max(0, 9 - len(rep.service.studies())))]
        futs = [h.ask_async() for h in pads]
        if futs:
            rep.pump_until(futs, timeout=300)
        for h in pads:
            h.close()
    round_once()
    before = {rid: (rep.service.counters["dispatch_count"], rep.service.scheduler.kernel_launches)
              for rid, rep in fleet.replicas.items()}
    victim = fleet.route(names[0])

    def fleet_run():
        t0 = time.perf_counter()
        for _ in range(FLEET["rounds"]):
            round_once()
        p11_sync()
        dt = time.perf_counter() - t0
        fleet.kill_replica(victim)
        lats = []
        for _ in range(2):  # two per-ask passes: the first ask on a dead owner fails it over
            for n in names:
                t1 = time.perf_counter()
                tid, vals = router.ask(n, timeout=300)
                p11_sync()
                lats.append(time.perf_counter() - t1)
                take(n, tid, vals)
        return dt, lats

    (dt, lats), nl = counted("fleet_inprocess", fleet_run)
    rounds = sum(rep.service.counters["dispatch_count"] - before[rid][0]
                 for rid, rep in fleet.replicas.items())
    own = sum(rep.service.scheduler.kernel_launches - before[rid][1]
              for rid, rep in fleet.replicas.items())
    gauge = {r["labels"]["replica"]: r["value"] for r in fleet.metrics_rows()
             if r["name"] == "serve_kernel_launches"}
    n_asks = len(names) * (1 + FLEET["rounds"] + 2)
    logged = [fleet.replicas[fleet.route(n)].service.scheduler.study(n).persist.wal.total_tells
              for n in names]
    fsyncs_per_tell = fleet.wal_fsyncs_per_tell()
    recovery_ms = fleet.recovery_ms
    fleet.shutdown()
    cold_audit(root, names, 1 + FLEET["rounds"] + 2)
    solo = SuggestService(mixed_space(), background=False, **fleet_kw())
    handles = [solo.create_study(n, seed=i) for i, n in enumerate(names)]
    want = {}
    for _ in range(1 + FLEET["rounds"] + 2):
        serve_round(solo, handles, want)
    solo.shutdown()
    n_bitwise = sum(streams[n] == want[n] for n in names)
    lat_ms = sorted(1e3 * x for x in lats)
    p99 = lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))]
    rate = len(names) * FLEET["rounds"] / dt
    log(f"[12a] {card}: bench_fleet's protocol ({FLEET['n_replicas']} replicas, "
        f"{len(names)} studies, max_batch 16, n_cand 128, snapshot_cadence 64, the pad "
        f"warm-up, {FLEET['rounds']} timed ask_batch rounds, then {victim} killed and two "
        f"per-ask passes): {rate:.1f} asks/s; failover window p99 {p99:.3f} ms per ask "
        f"(median {statistics.median(lat_ms):.3f}); recovery_ms {recovery_ms:.3f}; "
        f"gmm_llr launches {nl} in {rounds} replica rounds (the replicas' own counts "
        f"{own}; live gauges {gauge}); {n_bitwise} of {len(names)} streams bitwise one "
        f"in-process service's; WAL tells per study {sorted(set(logged))}, each restored "
        f"from the root alone; wal_fsyncs_per_tell {fsyncs_per_tell:.4f}")
    assert n_bitwise == len(names), "a fleet stream is not the one-service stream"
    assert nl == rounds == own > 0, (nl, rounds, own)
    assert set(logged) == {1 + FLEET["rounds"] + 2}, logged
    assert recovery_ms is not None and recovery_ms > 0
    out["inprocess"] = dict(asks_per_s=rate, failover_p99_ms=p99, recovery_ms=recovery_ms,
                            launches=nl, replica_rounds=rounds, bitwise=n_bitwise,
                            wal_fsyncs_per_tell=fsyncs_per_tell, n_asks=n_asks)

    # -- 12b. bench_pilot's protocol under the autoscaler ---------------------
    pnames = [f"a{i:03d}" for i in range(FLEET["n_studies"])]
    flight = os.path.join(tmp, "flight.jsonl")
    recorder = FlightRecorder(path=flight)
    pfleet = Fleet(mixed_space(), os.path.join(tmp, "pilot"), replica_ids=["r0", "r1"],
                   recorder=recorder, **fleet_kw())
    prouter = FleetRouter(pfleet)
    pilot = FleetPilot(pfleet, config=PilotConfig(
        min_replicas=1, max_replicas=3, shed_high=0, queue_high=max(2.0, len(pnames) / 2),
        breach_ticks=1, clear_ticks=1, cooldown_ticks=0))
    assert pilot.scrape == pfleet.metrics_rows  # the scrape is its only input
    for i, n in enumerate(pnames):
        prouter.create_study(n, seed=i)
    recorded = {n: [] for n in pnames}
    actions = []

    def pilot_run():
        served, t0 = 0, time.perf_counter()
        for _ in range(FLEET["rounds"]):
            futs = {}
            for n in pnames:
                rid = pfleet.route(n)
                futs[n] = (rid, pfleet.replicas[rid].ask_async(n))
            actions.append(pilot.tick().action)  # the scrape sees the queued wave
            got, shed = {}, []
            for rid in sorted({r for r, _ in futs.values()}):
                group = [(n, f) for n, (r, f) in futs.items() if r == rid]
                pfleet.replicas[rid].pump_until([f for _, f in group], timeout=300)
                for n, f in group:
                    try:
                        got[n] = f.result(timeout=0)
                    except ValueError:  # shed by a migration: its logged seed serves it again
                        shed.append(n)
            for n in shed:
                got[n] = prouter.ask(n, timeout=300, recover=True)
            for n in pnames:
                tid, vals = got[n]
                assert tid == len(recorded[n]), (n, tid)
                prouter.tell(n, tid, serve_loss(vals), vals=vals)
                recorded[n].append((int(tid), dict(vals)))
                served += 1
        p11_sync()
        return served, time.perf_counter() - t0

    (served, pdt), nl_b = counted("fleet_pilot", pilot_run)
    for _ in range(4):  # the quiet tail
        actions.append(pilot.tick().action)
    prow = {r["name"]: r["value"] for r in pilot.metrics_rows() if not r.get("labels")}
    out_ms, in_ms = prow["pilot_scale_out_ms"], prow["pilot_scale_in_ms"]
    members = sorted(pfleet.replicas)
    pfleet.shutdown()
    recorder.flush()
    target = ServiceTarget(SuggestService(mixed_space(), background=False, **fleet_kw()))
    replayed = replay_workload(load_workload(flight), target, timeout=300)
    target.service.shutdown()
    fidelity = replay_fidelity(recorded, replayed)
    n_prefix = sum([v for _, v in recorded[p]] == streams[n][:FLEET["rounds"]]
                   for p, n in zip(pnames, names))
    log(f"[12b] {card}: bench_pilot's protocol (2 replicas under FleetPilot(max_replicas=3, "
        f"queue_high {max(2.0, len(pnames) / 2)}), a FlightRecorder armed, "
        f"{FLEET['rounds']} waves of {len(pnames)} asks): decisions {actions}, members at the "
        f"end {members}; pilot_scale_out_ms {out_ms:.3f}, pilot_scale_in_ms {in_ms:.3f}; "
        f"{served / pdt:.1f} asks/s autoscaled; gmm_llr launches {nl_b}; {n_prefix} of "
        f"{len(pnames)} streams bitwise (a)'s same seeds; the flight log replayed against a "
        f"fresh service: replay_fidelity {fidelity}")
    assert "scale_out" in actions and "scale_in" in actions, actions
    assert n_prefix == len(pnames), "an autoscaled stream is not (a)'s"
    assert fidelity == 1.0
    out["pilot"] = dict(scale_out_ms=out_ms, scale_in_ms=in_ms, asks_per_s=served / pdt,
                        decisions=actions, launches=nl_b, replay_fidelity=fidelity)

    # -- 12c. the fleet as processes behind the router's console script -------
    croot, clog = os.path.join(tmp, "procs"), os.path.join(tmp, "procs.log")
    cnames = [f"c{i}" for i in range(P12_STUDIES)]
    cstreams = {n: [] for n in cnames}
    t0 = time.perf_counter()
    procs = {rid: script_start("hyperopt_tpu_torch.serve.service",
                               serve_script_args(croot, "--owner", rid), clog)
             for rid in ("r0", "r1")}
    rproc = None
    try:
        ports = {rid: script_port(p, clog) for rid, p in procs.items()}
        start_s = time.perf_counter() - t0
        # one round on each replica before any deadline of the router
        # applies; the path's counts start after it
        for rid, port in ports.items():
            frame_call(port, {"op": "create_study", "name": f"warm-{rid}", "seed": 1})
            frame_call(port, {"op": "ask", "study": f"warm-{rid}", "timeout": 300})
            frame_call(port, {"op": "close_study", "study": f"warm-{rid}"})
        warm = {rid: replica_counts(port) for rid, port in ports.items()}
        salt = fleet_salt("tpe", mixed_space())
        t0 = time.perf_counter()
        rproc = script_start("hyperopt_tpu_torch.serve.router",
                             ["--salt", salt, "--port", "0", "--probe-interval", "0"]
                             + [f"--backend={r}=127.0.0.1:{p}" for r, p in ports.items()], clog)
        rport = script_port(rproc, clog)
        router_start_s = time.perf_counter() - t0
        ring = HashRing(ports, salt=salt)
        victim = ring.owner(cnames[0])
        survivor = next(r for r in ports if r != victim)
        barrier = threading.Barrier(len(cnames) + 1, timeout=600)

        def client(i, n):
            def run():
                c = RemoteStudy("127.0.0.1", rport, n, seed=i, read_timeout=120)
                while len(cstreams[n]) < P12_TRIALS:
                    if len(cstreams[n]) == P12_KILL_AT:
                        barrier.wait()  # every study told KILL_AT trials
                        barrier.wait()  # the victim is dead
                    tid, vals = c.ask(timeout=120)
                    assert tid == len(cstreams[n]), (n, tid)
                    c.tell(tid, serve_loss(vals), vals)
                    cstreams[n].append(vals)
                c.close()
            return run

        errors = []
        t0 = time.perf_counter()

        def drive():
            try:
                run_threads([client(i, n) for i, n in enumerate(cnames)])
            except BaseException as e:  # re-raised on the main thread below
                errors.append(e)

        runner = threading.Thread(target=drive, daemon=True)
        runner.start()
        barrier.wait()
        pre = replica_counts(ports[victim], since=warm[victim])
        owned = [n for n in cnames if StudyClaim.read(croot, n)["replica"] == victim]
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait(timeout=60)
        rc_kill, at_kill = run_fsck("--serve", croot, "--live-owner", survivor)
        barrier.wait()
        runner.join(timeout=900)
        assert not runner.is_alive() and not errors, errors
        legs_s = time.perf_counter() - t0
        claims = {n: StudyClaim.read(croot, n)["replica"] for n in cnames}
        post = replica_counts(ports[survivor], since=warm[survivor])
    finally:
        for p in [*procs.values(), *([rproc] if rproc is not None else [])]:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)
            p.stdout.close()
    rc_after, after = run_fsck("--serve", croot)
    rc_repair, repaired = run_fsck("--serve", croot, "--repair")
    cold_audit(croot, cnames, P12_TRIALS)
    ref = SuggestService(mixed_space(), max_batch=64, background=False, n_startup_jobs=3,
                         device=P11_DEVICE)
    rhandles = [ref.create_study(n, seed=i) for i, n in enumerate(cnames)]
    cwant = {}
    counted("fleet_process_inprocess", lambda: [serve_round(ref, rhandles, cwant)
                                                for _ in range(P12_TRIALS)])
    ref.shutdown()
    ref_shapes = shapes.pop("fleet_process_inprocess")
    launches.pop("fleet_process_inprocess")
    # the replicas' own launch shapes are not recorded (their processes run
    # the console script untouched): a replica folds 1..4 of these studies
    # into a round, so the kernel is checked at every such fold of each
    # shape the in-process twin launched for the same studies
    shapes["fleet_process"] = {(b, k * dg, s_, kb, ka, dg) for (b, _, s_, kb, ka, dg) in ref_shapes
                               for k in range(1, P12_STUDIES + 1)}
    proc_launches = pre["serve_kernel_launches"] + post["serve_kernel_launches"]
    launches["fleet_process"] = proc_launches
    n_bitwise = sum(cstreams[n] == cwant[n] for n in cnames)
    kinds = sorted({i["kind"] for i in at_kill["issues"]})
    log(f"[12c] {card}: two hyperopt-tpu-torch-serve replicas (--root, --owner r0/r1, the "
        f"script's n_cand 16) started together in {start_s:.2f} s, warmed by one round each, "
        f"behind hyperopt-tpu-torch-router --salt (started in {router_start_s:.2f} s); "
        f"{P12_STUDIES} RemoteStudy clients x {P12_TRIALS} trials on binary frames, {victim} "
        f"(owning {owned}) SIGKILLed after {P12_KILL_AT} tells per study: claims afterwards "
        f"{claims}; {n_bitwise} of {P12_STUDIES} streams bitwise the in-process clean run; "
        f"every tell logged once (cold audit of the root); gmm_llr launches after the warm-up "
        f"round (each replica's metrics op, less its reading after the warm-up): {victim} "
        f"{pre['serve_kernel_launches']} in {pre['serve_dispatch_total']} rounds before the "
        f"kill + {survivor} {post['serve_kernel_launches']} in {post['serve_dispatch_total']} "
        f"rounds; fsck at the kill (--live-owner {survivor}): rc {rc_kill}, kinds {kinds}; after "
        f"the run: rc {rc_after}, {len(after['issues'])} issue(s); --repair rc {rc_repair}, "
        f"{repaired['remaining']} left; every study restored on a fresh service; legs "
        f"{legs_s:.2f} s")
    assert set(claims.values()) == {survivor}, claims
    assert n_bitwise == P12_STUDIES, "a process-fleet stream is not the clean run's"
    for counts in (pre, post):
        assert counts["serve_kernel_launches"] == counts["serve_dispatch_total"] > 0, counts
    assert owned and rc_kill == 1 and kinds == ["claim_stale_foreign"], at_kill
    assert sorted(i["path"] for i in at_kill["issues"]) == sorted(
        os.path.join(croot, n + ".claim") for n in owned)
    assert rc_repair == 0 and not (repaired["remaining"] or []), repaired
    out["process"] = dict(start_s=start_s, router_start_s=router_start_s, legs_s=legs_s,
                          bitwise=n_bitwise, launches=proc_launches,
                          launches_by_replica={victim: pre["serve_kernel_launches"],
                                               survivor: post["serve_kernel_launches"]},
                          fsck_at_kill=kinds, fsck_after=len(after["issues"]))

    # -- 12d. the kernel at every launch shape of (a)-(c) ---------------------
    for path, seen in shapes.items():
        if seen:
            CHECKED_SHAPES[path] = check_shapes(f"12 {path}, {card}", seen, seed=31)
    # the fleet's own fold (a replica padded to its slot cap), timed beside
    # its plain version and its bound
    b_, dg_all, s_, kb, ka, dg = max(shapes["fleet_inprocess"])
    fshape = dict(N=dg_all // dg, B=b_, Dg=dg, S=s_, Kb=kb, Ka=ka)
    x, ls, pb, pa, _ = stacked_scoring_inputs(fshape, seed=37, device=torch.device("cuda"))
    fold = lambda pre: {k: pre[k].reshape((dg_all,) + tuple(pre[k].shape[2:]))  # noqa: E731
                        for k in G._PRE_KEYS}
    xf, lsf, pbf, paf = x.reshape(b_, dg_all, s_), ls.repeat(fshape["N"]), fold(pb), fold(pa)
    k_ms = device_ms(lambda: G.gmm_llr_stacked(x, ls, pb, pa), 20)
    p_ms = device_ms(lambda: G.gmm_llr_plain(xf, lsf, pbf, paf), 10)
    fb = bound(dict(B=b_, Dg=dg_all, S=s_, Kb=kb, Ka=ka), sfu_per_s)
    log(f"[12d] {card}: the kernel at the fleet's fold {fshape}: {k_ms:.4f} ms device time "
        f"(plain {p_ms:.4f} ms), bound {fb['bound_ms']:.5f} ms by {fb['bound_by']}: "
        f"{fb['bound_ms'] / k_ms:.3f} of it")
    out["fold"] = dict(fshape, ms=k_ms, plain_ms=p_ms, **fb)
    del x, ls, pb, pa, xf, lsf, pbf, paf
    shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[12] {card}: phase 12 took {out['seconds']:.1f} s")
    return launches, out


FARM_K, FARM_TRIALS, FARM_FILE_TRIALS = 4, 200, 100
FARM_MATMULS, FARM_WIDTH = 3, 2048
FARM_RESERVE_TIMEOUT = 2.0  # the workers' --reserve-timeout: a SIGKILLed claim is reaped after it
FARM_ASHA = dict(max_budget=27, eta=3, max_jobs=40, inflight=4)
# 13s: unequal evaluation times, one call in four the slow one
FARM_STRAGGLER = dict(trials=32, slow_s=0.3, fast_s=0.02)
_FARM_MAT, _STRAGGLER_LOCK = {}, threading.Lock()


def farm_device():
    import torch

    return torch.device("cuda" if P11_DEVICE is None else P11_DEVICE)


def farm_objective(cfg):
    """``mixed_space_fn`` plus a fixed card workload on the calling thread,
    as a threaded objective that trains on the card runs: FARM_MATMULS
    fp32 products of a FARM_WIDTH-square matrix, synchronized on the
    thread's stream.  The loss is ``mixed_space_fn``'s."""
    import torch

    from hyperopt_tpu_torch.models.synthetic import mixed_space_fn

    a = b = _FARM_MAT[farm_device()]
    for _ in range(FARM_MATMULS):
        b = a @ b
    if b.is_cuda:
        torch.cuda.current_stream(b.device).synchronize()
    return mixed_space_fn(cfg)


class StragglerObjective:
    """``mixed_space_fn`` after a sleep of ``FARM_STRAGGLER['slow_s']`` on
    every fourth call and ``['fast_s']`` on the others; ``busy_s`` sums
    the evaluations' seconds over the threads."""

    def __init__(self):
        self.calls, self.busy_s = 0, 0.0

    def __call__(self, cfg):
        from hyperopt_tpu_torch.models.synthetic import mixed_space_fn

        with _STRAGGLER_LOCK:
            slow = self.calls % 4 == 0
            self.calls += 1
        t0 = time.perf_counter()
        time.sleep(FARM_STRAGGLER["slow_s" if slow else "fast_s"])
        loss = mixed_space_fn(cfg)
        with _STRAGGLER_LOCK:
            self.busy_s += time.perf_counter() - t0
        return loss


def farm_straggler(blocking, counted):
    """One ``ThreadTrials(parallelism=FARM_K)`` run of
    ``FARM_STRAGGLER['trials']`` trials of ``StragglerObjective`` with
    ``tpe.suggest`` on the card at ``max_queue_len=FARM_K``: blocking
    rounds as ``fmin`` runs them (one ask, then ``block_until_done``), or
    the reference's refill loop (``FMinIter.run(N,
    block_until_done=False)``: ask whenever fewer than FARM_K trials wait,
    one poll between fills).  Returns the trials, the wall, the asks and
    the threads' busy share (evaluation seconds over wall x parallelism)."""
    import numpy as np

    import hyperopt_tpu_torch as H
    from hyperopt_tpu_torch.base import Domain
    from hyperopt_tpu_torch.distributed import ThreadTrials
    from hyperopt_tpu_torch.fmin import FMinIter
    from hyperopt_tpu_torch.models.synthetic import mixed_space

    n, asks, fn = FARM_STRAGGLER["trials"], [], StragglerObjective()

    def algo(new_ids, domain, trials, seed):
        asks.append(len(new_ids))
        return H.tpe.suggest(new_ids, domain, trials, seed)

    trials = ThreadTrials(parallelism=FARM_K)
    domain = Domain(fn, mixed_space(), device=P11_DEVICE)
    trials._domain = domain  # the pump's domain, as ThreadTrials.fmin sets it
    it = FMinIter(algo, domain, trials, rstate=np.random.default_rng(17),
                  max_queue_len=FARM_K, max_evals=n, show_progressbar=False)

    def run():
        it.run(n, block_until_done=blocking)
        it.block_until_done()

    t0 = time.perf_counter()
    counted("threads_straggler", run)
    wall = time.perf_counter() - t0
    trials.refresh()
    return trials, wall, asks, fn.busy_s / (wall * FARM_K)


def farm_stream(trials):
    return [(t["tid"], t["misc"]["vals"], t["result"]) for t in trials.trials]


def worker_start(qdir, name, log_dir):
    """Start a ``hyperopt_tpu_torch.distributed.worker`` process on
    ``qdir``, its log in ``log_dir``."""
    log_path = os.path.join(log_dir, f"{name}.log")
    proc = script_start("hyperopt_tpu_torch.distributed.worker",
                        ["--dir", qdir, "--poll-interval", "0.05", "--reserve-timeout",
                         str(FARM_RESERVE_TIMEOUT)], log_path)
    return proc, log_path


def workers_up(procs, timeout=120):
    """Wait until every started worker logs that it serves its queue;
    returns the seconds each took."""
    t0, up = time.perf_counter(), {}
    while len(up) < len(procs):
        for name, (proc, log_path) in procs.items():
            if name in up:
                continue
            with open(log_path) as f:
                if " serving " in f.read():
                    up[name] = time.perf_counter() - t0
            assert proc.poll() is None, f"worker {name} exited: {open(log_path).read()[-2000:]}"
        assert time.perf_counter() - t0 < timeout, f"workers not up after {timeout} s"
        time.sleep(0.02)
    return up


def stop_worker(proc):
    """SIGTERM: the worker drains (finishes or gives back its job), exits 0."""
    proc.terminate()
    rc = proc.wait(timeout=60)
    proc.stdout.close()
    return rc


def kill_holding_claim(proc, qdir, owner, after_done, stop, out):
    """Once ``after_done`` jobs are DONE, SIGSTOP the worker again and
    again until it is caught holding a live claim (its claim written in
    ``running/``, no DONE doc and no result being written for that job),
    then SIGKILL it there; records the job in ``out``."""
    import signal

    done_dir, run_dir = os.path.join(qdir, "done"), os.path.join(qdir, "running")
    while not stop.is_set() and len(os.listdir(done_dir)) < after_done:
        time.sleep(0.01)
    tries = 0
    while not stop.is_set():
        tries += 1
        os.kill(proc.pid, signal.SIGSTOP)
        deadline = time.perf_counter() + 5
        while open(f"/proc/{proc.pid}/stat").read().split(")")[-1].split()[0] != "T":
            assert time.perf_counter() < deadline, "the worker did not stop"
            time.sleep(0.0005)
        held = None
        for name in os.listdir(run_dir):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(run_dir, name)) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            busy = [n for n in os.listdir(done_dir) if n.startswith(name)]
            if doc.get("owner") == owner and not busy:
                held = doc["tid"]
        if held is not None:
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)
            out.update(tid=held, tries=tries, at=time.perf_counter())
            return
        os.kill(proc.pid, signal.SIGCONT)
        time.sleep(0.004)


def phase13(card):
    """Asynchronous trial farming on the card: (a) ThreadTrials with a card
    workload in each objective thread, bitwise its sequential twin; (s)
    what a slow trial costs a blocking round against the refill loop; (b)
    FileTrials with two worker processes, one SIGKILLed holding a claim,
    bitwise the twin's first trials, fsck clean; (c) asha_filequeue with
    the worker processes; (d) the kernel at every launch shape.  Returns
    the launches by path and the numbers."""
    import tempfile
    import threading

    import numpy as np
    import torch

    import hyperopt_tpu_torch as H
    from hyperopt_tpu_torch.distributed import FileJobQueue, FileTrials, ThreadTrials
    from hyperopt_tpu_torch.distributed import asha_filequeue
    from hyperopt_tpu_torch.models.synthetic import (budgeted_quadratic_fn,
                                                     budgeted_quadratic_space, mixed_space,
                                                     mixed_space_fn)

    t_phase = time.perf_counter()
    launches, shapes, out = {}, {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p13_")
    dev = farm_device()
    g = torch.Generator().manual_seed(13)
    _FARM_MAT[dev] = (torch.randn(FARM_WIDTH, FARM_WIDTH, generator=g)
                      / FARM_WIDTH ** 0.5).to(dev)

    def counted(path, run):
        return counted_run(launches, shapes, path, run)

    def run_fmin(trials, n, **kw):
        t0 = time.perf_counter()
        H.fmin(farm_objective, mixed_space(), algo=H.tpe.suggest, max_evals=n, trials=trials,
               rstate=np.random.default_rng(13), device=P11_DEVICE, show_progressbar=False,
               **kw)
        p11_sync()
        return (time.perf_counter() - t0) / n * 1e3

    # -- 13a. ThreadTrials(parallelism=4), in pairs with the sequential twin -
    twin, thread_ms, twin_ms, threaded = None, [], [], []
    for kind in ("twin", "threads", "threads", "twin"):
        if kind == "twin":
            trials = H.Trials()
            ms, n = counted("threads_twin", lambda: run_fmin(trials, FARM_TRIALS,
                                                            max_queue_len=FARM_K))
            twin_ms.append(ms)
            stream = farm_stream(trials)
            assert twin is None or stream == twin, "the twin's stream moved between runs"
            twin = stream
        else:
            trials = ThreadTrials(parallelism=FARM_K)
            ms, n = counted("threads_fmin", lambda: run_fmin(trials, FARM_TRIALS))
            thread_ms.append(ms)
            threaded.append(farm_stream(trials))
            owners = {t["owner"] for t in trials.trials}
        assert n == (FARM_TRIALS - 20) // FARM_K == 45, (kind, n)
    n_bitwise = [sum(a == b for a, b in zip(run, twin)) for run in threaded]
    log(f"[13a] {card}: ThreadTrials(parallelism={FARM_K}) x {FARM_TRIALS} trials of "
        f"mixed_space_fn + {FARM_MATMULS} fp32 {FARM_WIDTH}^2 matmuls per objective thread, "
        f"tpe.suggest on the card: {n_bitwise} of {FARM_TRIALS} trials bitwise the sequential "
        f"max_queue_len={FARM_K} twin; ms per trial threaded {[round(x, 3) for x in thread_ms]} "
        f"against the twin's {[round(x, 3) for x in twin_ms]} (twin, threads, threads, twin); "
        f"gmm_llr launches per run 45 (5 startup asks of 4, then 45 TPE asks), "
        f"{launches['threads_fmin']} over the two threaded runs; owners {sorted(owners)}")
    assert n_bitwise == [FARM_TRIALS] * 2 and len(twin) == FARM_TRIALS
    assert all(len(run) == FARM_TRIALS for run in threaded)
    assert launches["threads_fmin"] == launches["threads_twin"] == 90
    assert owners <= {f"thread:{i}" for i in range(FARM_K)}
    out["threads"] = dict(trials=FARM_TRIALS, parallelism=FARM_K, ms_per_trial=thread_ms,
                          twin_ms_per_trial=twin_ms, bitwise=n_bitwise,
                          launches_per_run=launches["threads_fmin"] // 2)

    # -- 13s. unequal evaluation times: a blocking round waits for its -------
    # slowest trial; the reference's refill loop keeps the threads busy
    straggle = {True: [], False: []}
    for blocking in (True, False, False, True):
        trials, wall, asks, busy = farm_straggler(blocking, counted)
        assert [t["tid"] for t in trials.trials] == list(range(FARM_STRAGGLER["trials"]))
        assert {t["state"] for t in trials.trials} == {H.base.JOB_STATE_DONE}
        if blocking:
            assert asks == [FARM_K] * (FARM_STRAGGLER["trials"] // FARM_K), asks
        straggle[blocking].append(dict(wall_s=wall, ms_per_trial=wall / len(trials) * 1e3,
                                       asks=len(asks), busy_share=busy,
                                       stream=farm_stream(trials)))
    assert straggle[True][0]["stream"] == straggle[True][1]["stream"]
    for runs in straggle.values():
        for r in runs:
            del r["stream"]
    log(f"[13s] {card}: ThreadTrials(parallelism={FARM_K}) x {FARM_STRAGGLER['trials']} trials, "
        f"one evaluation in four sleeping {FARM_STRAGGLER['slow_s']} s and the others "
        f"{FARM_STRAGGLER['fast_s']} s, tpe.suggest on the card at max_queue_len={FARM_K} "
        f"(blocking, refill, refill, blocking): blocking rounds "
        f"{[(round(r['ms_per_trial'], 3), round(r['busy_share'], 4)) for r in straggle[True]]} "
        f"(ms per trial, threads' busy share; {straggle[True][0]['asks']} asks, the two streams "
        f"bitwise), the reference's refill loop "
        f"{[(round(r['ms_per_trial'], 3), round(r['busy_share'], 4)) for r in straggle[False]]} "
        f"({[r['asks'] for r in straggle[False]]} asks); gmm_llr launches "
        f"{launches['threads_straggler']} over the four runs")
    out["straggler"] = dict(FARM_STRAGGLER, blocking=straggle[True], refill=straggle[False],
                            launches=launches["threads_straggler"])

    # -- 13b. FileTrials with two worker processes, one SIGKILLed ------------
    qdir = os.path.join(tmp, "queue")
    FileJobQueue(qdir)
    t0 = time.perf_counter()
    procs = {name: worker_start(qdir, name, tmp) for name in ("w0", "w1")}
    up = workers_up(procs)
    start_s = time.perf_counter() - t0
    victim, survivor = procs["w0"][0], procs["w1"][0]
    killed, stop = {}, threading.Event()
    killer = threading.Thread(target=kill_holding_claim, daemon=True, args=(
        victim, qdir, f"{socket.gethostname()}:{victim.pid}", 24, stop, killed))
    killer.start()
    ftrials = FileTrials(qdir, reserve_timeout=FARM_RESERVE_TIMEOUT)
    t0 = time.perf_counter()
    try:
        _, file_launches = counted("file_fmin", lambda: H.fmin(
            mixed_space_fn, mixed_space(), algo=H.tpe.suggest, max_evals=FARM_FILE_TRIALS,
            trials=ftrials, max_queue_len=FARM_K, rstate=np.random.default_rng(13),
            device=P11_DEVICE, show_progressbar=False))
        file_wall = time.perf_counter() - t0
    finally:
        stop.set()
        killer.join(timeout=60)
    queue = FileJobQueue(qdir)
    done = queue.done_docs()
    file_bitwise = sum(a == b for a, b in zip(farm_stream(ftrials), twin[:FARM_FILE_TRIALS]))
    rerun_owner = done[killed["tid"]]["owner"] if killed else None
    # a replacement worker for (c), started now: its start overlaps the audit
    t_c = time.perf_counter()
    procs["w2"] = worker_start(qdir, "w2", tmp)
    rc_fsck, report = run_fsck("--dir", qdir, "--reserve-timeout", str(FARM_RESERVE_TIMEOUT),
                               "--tmp-grace", "0")
    log(f"[13b] {card}: FileTrials + 2 hyperopt-tpu-torch-worker processes (started together, "
        f"serving after {sorted((k, round(v, 2)) for k, v in up.items())} s; {start_s:.2f} s "
        f"for both), {FARM_FILE_TRIALS} trials at max_queue_len={FARM_K}: wall {file_wall:.2f} s "
        f"({file_wall / FARM_FILE_TRIALS * 1e3:.2f} ms per trial), gmm_llr launches "
        f"{file_launches}; w0 SIGKILLed holding the claim of tid {killed.get('tid')} (caught on "
        f"SIGSTOP sample {killed.get('tries')}), rerun by {rerun_owner}; {len(done)} DONE docs, "
        f"queue {queue.counts()}; {file_bitwise} of {FARM_FILE_TRIALS} trials bitwise (a)'s "
        f"twin; fsck --dir rc {rc_fsck}, {len(report['issues'])} issue(s)")
    assert killed, "no worker was caught holding a claim"
    assert rerun_owner == f"{socket.gethostname()}:{survivor.pid}", rerun_owner
    assert sorted(done) == list(range(FARM_FILE_TRIALS)), sorted(done)
    assert queue.counts() == {"new": 0, "running": 0, "done": FARM_FILE_TRIALS}
    assert file_bitwise == FARM_FILE_TRIALS, "the file queue's stream is not the twin's"
    assert file_launches == (FARM_FILE_TRIALS - 20) // FARM_K == 20, file_launches
    assert rc_fsck == 0 and not report["issues"], report
    out["file"] = dict(trials=FARM_FILE_TRIALS, wall_s=file_wall,
                       ms_per_trial=file_wall / FARM_FILE_TRIALS * 1e3, workers_start_s=start_s,
                       worker_start_s=up, killed_tid=killed["tid"], bitwise=file_bitwise,
                       launches=file_launches)

    # -- 13c. asha_filequeue with two worker processes -----------------------
    expected = []

    def counted_tpe(new_ids, domain, trials, seed):
        # the model runs (one launch) once 20 completed trials exist
        expected.append(int(len(trials.trials) >= 20))
        return H.tpe.suggest(new_ids, domain, trials, seed)

    workers_up({"w2": procs["w2"]})
    replace_s = time.perf_counter() - t_c
    t0 = time.perf_counter()
    res, asha_launches = counted("asha_filequeue", lambda: asha_filequeue(
        budgeted_quadratic_fn, budgeted_quadratic_space(), dirpath=qdir, algo=counted_tpe,
        rstate=np.random.default_rng(0), eval_timeout=120.0, device=P11_DEVICE, **FARM_ASHA))
    asha_wall = time.perf_counter() - t0
    done = queue.done_docs()
    asha_done = {t: d for t, d in done.items() if isinstance(t, str)}
    asha_owners = {d["owner"] for d in asha_done.values()}
    rc_fsck_c, report_c = run_fsck("--dir", qdir, "--reserve-timeout",
                                   str(FARM_RESERVE_TIMEOUT), "--tmp-grace", "0")
    rc_drain = [stop_worker(procs[n][0]) for n in ("w1", "w2")]
    log(f"[13c] {card}: asha_filequeue(max_budget=27, eta=3, max_jobs=40, inflight=4) over "
        f"budgeted_quadratic_fn with tpe.suggest on the card and 2 worker processes (w1, and w2 "
        f"started after (b), serving within {replace_s:.2f} s of its start, fsck running "
        f"meanwhile): wall {asha_wall:.2f} s, {len(res['trials'])} evaluations, rungs {res['rungs']}, "
        f"best {res['best_loss']:.6f}; {len(asha_done)} job DONE docs by {len(asha_owners)} "
        f"worker(s); {len(expected)} rung-0 asks, gmm_llr launches {asha_launches} (one per ask "
        f"on 20 or more completed trials: {sum(expected)}); fsck --dir rc {rc_fsck_c}, "
        f"{len(report_c['issues'])} issue(s); the workers drained on SIGTERM with rc {rc_drain}")
    assert len(res["trials"]) == FARM_ASHA["max_jobs"] == len(asha_done)
    assert asha_launches == sum(expected) > 0, (asha_launches, expected)
    assert rc_fsck_c == 0 and not report_c["issues"], report_c
    assert rc_drain == [0, 0], rc_drain
    out["asha"] = dict(jobs=FARM_ASHA["max_jobs"], wall_s=asha_wall, rungs=res["rungs"],
                       launches=asha_launches, worker_ready_s=replace_s)

    # -- 13d. the kernel at every launch shape of (a)-(c) ---------------------
    for path, seen in shapes.items():
        if seen:
            CHECKED_SHAPES[path] = check_shapes(f"13 {path}, {card}", seen, seed=41)
    launches = {k: launches[k] for k in ("threads_fmin", "file_fmin", "asha_filequeue")}
    shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[13] {card}: phase 13 took {out['seconds']:.1f} s")
    return launches, out


LINT_PACKS = (("ast", []), ("trace", ["--trace"]), ("wire", ["--wire"]))
LOCKDEP_SERVE_ROUNDS = 3  # 7b's protocol at SERVE_STUDIES, armed
LOCKDEP_BURST = dict(BURST, n_clients=16, pool_width=16)  # 11b's burst, cut


class Patches:
    """``monkeypatch.setattr`` outside pytest: :meth:`undo` restores every
    attribute set, last first."""

    def __init__(self):
        self._saved = []

    def setattr(self, target, name, value):
        self._saved.append((target, name, getattr(target, name)))
        setattr(target, name, value)

    def undo(self):
        while self._saved:
            target, name, value = self._saved.pop()
            setattr(target, name, value)


def phase16(card):
    """The port's own checks on the card's machine: (a) the lint CLI's
    three packs over this tree, each clean; (b) lockdep armed on every
    ``BatchScheduler`` over 7b's serve protocol and 11b's cut burst, then
    disarmed, with 0 inversions, and the kernel at every launch shape of
    the two runs.  Returns the launches by path and the numbers."""
    import contextlib
    import io
    import tempfile

    from hyperopt_tpu_torch.analysis import cli, lockdep
    from hyperopt_tpu_torch.serve.scheduler import BatchScheduler

    t_phase = time.perf_counter()
    out = {"python": sys.version.split()[0], "lint": {}}
    # -- 16a. hyperopt-tpu-torch-lint over this tree -----------------------
    for pack, flags in LINT_PACKS:
        report = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(report):
            rc = cli.main(flags + ["--format", "json"])
        dt = time.perf_counter() - t0
        summary = json.loads(report.getvalue())["summary"]
        out["lint"][pack] = dict(exit=rc, findings=summary["total"], seconds=dt,
                                 suppressed=summary["pragma_suppressed"],
                                 baseline_size=summary["baseline_size"],
                                 **({"ops": summary["ops_checked"],
                                     "crash_points_armed": summary["crash_points_armed"],
                                     "crash_points": summary["crash_points_total"]}
                                    if pack == "wire" else {"files": summary["files"]}))
        log(f"[16a] {card}: hyperopt-tpu-torch-lint {' '.join(flags) or '(AST pack)'} over "
            f"{os.path.relpath(cli.PACKAGE_DIR, cli.REPO_ROOT)}/ under Python {out['python']}: "
            f"exit {rc}, {summary['total']} findings, {summary['pragma_suppressed']} suppressed "
            f"inline, baseline {summary['baseline_size']} entries, {dt:.2f} s"
            + (f"; {summary['ops_checked']} ops, {summary['crash_points_armed']}/"
               f"{summary['crash_points_total']} crash points armed" if pack == "wire"
               else f"; {summary['files']} files"))
        assert rc == 0 and summary["total"] == 0, (pack, report.getvalue()[-4000:])
    # -- 16b. lockdep armed over 7b's protocol and 11b's cut burst ---------
    launches, shapes = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p16_")
    orig_init = BatchScheduler.__init__
    patches = Patches()
    dep = lockdep.arm_scheduler_class(patches)
    try:
        t0 = time.perf_counter()
        svc, handles = open_service(SERVE_STUDIES)
        try:
            counted_run(launches, shapes, "lockdep_serve", lambda: [
                serve_round(svc, handles) for _ in range(LOCKDEP_SERVE_ROUNDS)])
        finally:
            svc.shutdown()
        serve_traced = isinstance(svc.scheduler._lock, lockdep._TracedLock)
        serve_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        burst = burst_run(tmp, True, "lockdep_burst",
                          lambda path, run: counted_run(launches, shapes, path, run),
                          LOCKDEP_BURST)
        burst_s = time.perf_counter() - t0
    finally:
        patches.undo()
        shutil.rmtree(tmp, ignore_errors=True)
    orders = dep.orders()
    out["lockdep"] = dict(inversions=dep.inversions, acquisitions=dep.acquisitions,
                          orders=len(orders), serve_s=serve_s, burst_s=burst_s,
                          burst_asks_per_s=burst["asks_per_s"], launches=dict(launches))
    log(f"[16b] {card}: lockdep armed on every BatchScheduler over 7b's protocol "
        f"({SERVE_STUDIES} studies, {LOCKDEP_SERVE_ROUNDS} rounds, {serve_s:.2f} s) and 11b's "
        f"burst ({LOCKDEP_BURST['n_clients']} clients x {LOCKDEP_BURST['asks_per_client']} "
        f"pipelined asks over {LOCKDEP_BURST['n_studies']} studies, root= background service, "
        f"binary frames, {burst_s:.2f} s, {burst['asks_per_s']:.1f} asks/s): "
        f"{dep.inversions} inversions, {dep.acquisitions} traced acquisitions, {len(orders)} "
        f"distinct lock orders; gmm_llr launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items()) + "; sanitizer disarmed")
    assert BatchScheduler.__init__ is orig_init, "lockdep stayed armed"
    assert serve_traced and dep.acquisitions > 0, "lockdep saw no acquisition"
    assert dep.inversions == 0, dep.errors
    assert all(launches.values()), launches
    for path, seen in shapes.items():
        CHECKED_SHAPES[path] = check_shapes(f"16 {path}, {card}", seen, seed=161)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[16] {card}: phase 16 took {out['seconds']:.1f} s")
    return launches, out


SHARDED_TRIALS = 100  # 17a's fmin: 20 startup trials, then 80 sharded asks
P17_DEVICE = "cuda"  # where phase 17's ranks compute
DCN_RESULT = re.compile(r"\blaunches_by_rank=\[([0-9, ]*)\]")


def phase17(card):
    """The rank-sharded suggest (``parallel.sharded_suggest``) on the card:
    (a) one rank, no process group: a 100-trial ``fmin`` on
    ``mixed_space()`` at the reference's defaults (64 candidates per rank,
    24 categorical in all), one launch per warm ask; a warm step bitwise
    ``tpe.build_suggest_fn`` at ``fold_in(key, 0)``; the same ``fmin`` on
    the CPU beside it, parting only at a near-tie; (b) two ranks spawned
    on the one card (``dcn_check.launch``: ``gloo``, the packed winners
    gathered through the host), stages A and B at B=256: rank 0's
    suggestions bitwise two virtual ranks in this process on the card,
    one all-gather per step, the KS line; (c) the kernel at every launch
    shape of both.  Returns the launches by path and the numbers."""
    import numpy as np
    import torch

    import hyperopt_tpu_torch as H
    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch import tpe
    from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn
    from hyperopt_tpu_torch.ops import kernels as TK
    from hyperopt_tpu_torch.parallel import dcn_check, sharded
    from hyperopt_tpu_torch.parallel.mesh import default_mesh, virtual_mesh
    from hyperopt_tpu_torch.torch_trials import obs_buffer_for, packed_space_for

    t_phase = time.perf_counter()
    launches, shapes, out = {}, {}, {}
    assert not torch.distributed.is_initialized()
    n_startup, n_rank, n_cat = (sharded._default_n_startup_jobs, sharded._default_n_EI_per_device,
                                sharded._default_n_EI_cat_total)

    def run_fmin(device):
        seeds, trials = [], H.Trials()

        def algo(new_ids, domain, trials_, s):
            seeds.append(int(s))
            return sharded.sharded_suggest(new_ids, domain, trials_, s)

        t0 = time.perf_counter()
        H.fmin(mixed_space_fn, mixed_space(), algo=algo, max_evals=SHARDED_TRIALS,
               trials=trials, rstate=np.random.default_rng(0), device=device,
               show_progressbar=False)
        return trials, seeds, time.perf_counter() - t0

    # -- 17a. one rank, no process group -----------------------------------
    (card_trials, card_seeds, wall), n = counted_run(launches, shapes, "sharded_1",
                                                      lambda: run_fmin(P17_DEVICE))
    losses = card_trials.losses()
    assert len(losses) == SHARDED_TRIALS and np.all(np.isfinite(losses))
    assert n == SHARDED_TRIALS - n_startup, n
    assert min(losses) < min(losses[:n_startup]), "the sharded TPE did not improve on startup"
    # one warm step: one rank at key k is the unsharded step at fold_in(k, 0)
    domain = H.Domain(mixed_space_fn, mixed_space(), device=P17_DEVICE)
    ps = packed_space_for(domain)
    state = obs_buffer_for(domain, card_trials).device_arrays(pow2_cap=TK.DEFAULT_ABOVE_CAP)
    key = R.key(card_seeds[-1] % (2**31 - 1), device=ps.device)
    one = sharded.build_sharded_suggest_fn(ps, default_mesh(), n_rank, 0.25, 25, 1.0,
                                           n_cand_cat_per_device=n_cat)(key, *state, 1)
    flat = tpe.build_suggest_fn(ps, n_rank, 0.25, 25, 1.0, n_cand_cat=n_cat)(
        R.fold_in(key, 0), *state, 1)
    fold_in_bitwise = all(torch.equal(a, b) for a, b in zip(one, flat))
    assert fold_in_bitwise, "one rank is not the unsharded step at fold_in(k, 0)"
    # the same fmin on the CPU: it may part from the card's only at a near-tie
    cpu_trials, cpu_seeds, cpu_wall = run_fmin("cpu")
    cpu_domain = H.Domain(mixed_space_fn, mixed_space(), device="cpu")
    cpu_ps = packed_space_for(cpu_domain)
    t, labels = departure(cpu_ps, card_trials.trials, cpu_trials.trials)
    margins = {}
    if t is not None and t >= n_startup:
        hist = H.trials_from_docs(cpu_trials.trials[:t])
        (doc,) = sharded.sharded_suggest([t], cpu_domain, hist, cpu_seeds[t])
        assert doc["misc"]["vals"] == cpu_trials.trials[t]["misc"]["vals"], t
        cpu_state = obs_buffer_for(cpu_domain, hist).device_arrays(pow2_cap=TK.DEFAULT_ABOVE_CAP)
        m = sweep_margins(cpu_ps, cpu_state, R.fold_in(R.key(cpu_seeds[t] % (2**31 - 1)), 0),
                          0.25, 1.0, n_rank, n_cat, 1, pad_gamma=None)[:, 0]
        margins = {lab: float(m[cpu_ps.labels.index(lab)]) for lab in labels}
    worst = max(margins.values(), default=None)
    out["one_rank"] = dict(trials=SHARDED_TRIALS, launches=n, wall_s=wall,
                           ms_per_trial=wall / SHARDED_TRIALS * 1e3, best=float(min(losses)),
                           fold_in_bitwise=fold_in_bitwise, cpu_wall_s=cpu_wall,
                           first_departure=t, departure_labels=labels, margins=margins)
    log(f"[17a] {card}: sharded_suggest on one rank, {SHARDED_TRIALS}-trial fmin on "
        f"mixed_space() ({n_rank} candidates per rank, {n_cat} categorical): {wall:.2f} s "
        f"({wall / SHARDED_TRIALS * 1e3:.2f} ms per trial), best {min(losses):.6f}, {n} gmm_llr "
        f"launches; a warm step bitwise tpe.build_suggest_fn at fold_in(k, 0): "
        f"{fold_in_bitwise}; the CPU stream ({cpu_wall:.2f} s) first parts at trial "
        f"{'none' if t is None else t}"
        + ("" if t is None else f" ({', '.join(labels)}; margins on the CPU "
           + ", ".join(f"{k} {v:.6g}" for k, v in margins.items()) + ")"))
    assert t is None or (t >= n_startup and worst < NEAR_TIE), (t, labels, margins)
    # -- 17b. two ranks spawned on the one card, gloo through the host -----
    t0 = time.perf_counter()
    report = dcn_check.launch(world=2, timeout=300, device=P17_DEVICE, batch=256,
                              stages="AB")
    dcn_s = time.perf_counter() - t0
    result = next(ln for ln in report.splitlines() if ln.startswith("DCN RESULT"))
    by_rank = [int(x) for x in DCN_RESULT.search(result).group(1).split(",")]
    launches["sharded_2"] = sum(by_rank)
    spawned = dcn_check.parse_values(report)
    # the twin: the same two ranks, in turn, in this process on the card;
    # its launch shapes are the ranks' (the launches are not counted)
    with launch_shapes() as seen:
        virtual, _, _ = dcn_check.run_stages(P17_DEVICE, 256, dcn_check.DEFAULT_N_PER_RANK,
                                             virtual_mesh(2))
    shapes["sharded_2"] = seen
    two_bitwise = spawned == {k: virtual[k] for k in ("A", "B")}
    out["two_ranks"] = dict(seconds=dcn_s, launches_by_rank=by_rank, bitwise=two_bitwise,
                            result=result)
    log(f"[17b] {card}: two gloo ranks on the one card, stages A and B at B=256 "
        f"({dcn_s:.2f} s with the ranks' start): {result}; rank 0 bitwise two virtual ranks "
        f"on the card: {two_bitwise}")
    assert "gathers_per_step=[1, 1, 1]" in result and "ranks_agree=True" in result, result
    assert by_rank == [3, 3], by_rank
    assert two_bitwise, "the spawned ranks differ from the virtual ranks"
    # -- 17c. the kernel at every launch shape of both paths ---------------
    for path, seen in shapes.items():
        CHECKED_SHAPES[path] = check_shapes(f"17 {path}, {card}", seen, seed=171)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[17] {card}: phase 17 took {out['seconds']:.1f} s")
    return launches, out


SHARD_COUNTS = (2, 4)  # 18's study and trial meshes, every shard on the one card
# 18b: the population MLP's sharded PBT loss history against the unsharded
# one, relative (the card's batched products pick other kernels for a
# block than for the whole population; 1.49e-5 measured, PERF.md)
MLP_SHARD_RTOL = 1e-4
SERVE18_ROUNDS = 6  # 7b's timed rounds, after one warm-up


def p18_sync():
    import torch

    torch.cuda.synchronize()


def serve_protocol(mesh):
    """Phase 7b's serve protocol on a service whose study slots ``mesh``
    shards (None: unsharded), then one out-of-order tell (study 0 tells
    its next two tids in reverse) and a NaN tenant (the last study tells a
    NaN loss and asks until it is evicted) while every other study asks
    and tells on.  The kernel's launches are counted from 0 at the first
    round; returns the streams, ms per timed round, the launches and their
    shapes, and the out-of-order round's upload bytes and shard restacks."""
    from hyperopt_tpu_torch.exceptions import StudyPoisoned, StudyQuarantined
    from hyperopt_tpu_torch.ops import gmm_scores as G
    from hyperopt_tpu_torch.serve.scheduler import QUARANTINE_TRIPS

    svc, handles = open_service(SERVE_STUDIES, mesh=mesh)
    streams, rounds = {}, 0
    p18_sync()
    G.KERNEL.launches = 0
    with launch_shapes() as seen:
        serve_round(svc, handles, streams)  # warm-up: the first materialization
        p18_sync()
        t0 = time.perf_counter()
        for _ in range(SERVE18_ROUNDS):
            serve_round(svc, handles, streams)
        p18_sync()
        round_ms = (time.perf_counter() - t0) / SERVE18_ROUNDS * 1e3
        rounds += 1 + SERVE18_ROUNDS
        timed_launches = G.KERNEL.launches
        # one out-of-order tell: the slot is rebuilt from host truth
        before = svc.counters
        h0 = handles[0]
        st0 = svc.scheduler.study(h0.name)
        t_hi = st0.next_tid
        h0.tell(t_hi + 1, 0.9, vals=streams[h0.name][-1])
        h0.tell(t_hi, 0.7, vals=streams[h0.name][-2])
        st0.next_tid = t_hi + 2
        assert st0.dirty, "the out-of-order tell did not dirty its slot"
        serve_round(svc, handles, streams)
        rounds += 1
        after = svc.counters
        # a NaN tenant: trips the finite check until it is evicted
        bad, rest = handles[-1], handles[:-1]
        st_bad = svc.scheduler.study(bad.name)
        bad.tell(st_bad.next_tid, float("nan"), vals=streams[bad.name][-1])
        st_bad.next_tid += 1
        refusals = []
        for _ in range(QUARANTINE_TRIPS + 1):
            futs = [(h, h.ask_async()) for h in rest]
            bad_fut = None if st_bad.quarantined else bad.ask_async()
            svc.pump()
            rounds += 1
            for h, f in futs:
                tid, vals = f.result(timeout=120)
                streams[h.name].append(vals)
                h.tell(tid, serve_loss(vals))
            if bad_fut is not None:
                refusals.append(type(bad_fut.exception(timeout=120)).__name__)
        p18_sync()
    out = dict(streams=streams, round_ms=round_ms, timed_launches=timed_launches,
               launches=G.KERNEL.launches, rounds=rounds, seen=seen,
               ooo_upload_bytes=after["upload_bytes"] - before["upload_bytes"],
               ooo_restacks=after["shard_restacks"] - before["shard_restacks"],
               quarantined=st_bad.quarantined, refusals=refusals, counters=svc.counters)
    svc.shutdown()
    assert all(r in (StudyPoisoned.__name__, StudyQuarantined.__name__) for r in refusals)
    return out


def tree_max_diff(a, b):
    """The largest absolute difference over the leaves of two pytrees of
    tensors (NaN where one side is not finite and the other is)."""
    import torch

    from hyperopt_tpu_torch.utils import tree_leaves

    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if torch.equal(x, y):
            continue
        worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst


def block_probe(train_fn, state0, bounds, n_shards, mlp_seed=None):
    """One ``train_fn`` step of the whole population against the same step
    over ``n_shards`` member blocks, joined: the largest difference of the
    states and of the losses; with ``mlp_seed`` (the population MLP's data
    seed), also of each of the MLP's operations alone under ``vmap``: the
    forward products ``x @ w1`` (a matrix product) and ``h @ w2`` (a
    matrix-vector product), the MSE's mean over the 256 rows, and the
    gradient of each parameter (``torch.func.grad``)."""
    import numpy as np
    import torch

    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch.models.synthetic import _regression_data
    from hyperopt_tpu_torch.utils import tree_leaves, tree_map

    P = tree_leaves(state0)[0].shape[0]
    dev = tree_leaves(state0)[0].device
    hyp = {n: torch.exp(torch.linspace(float(np.log(lo)), float(np.log(hi)), P, device=dev))
           for n, (lo, hi) in bounds.items()}
    key = R.key(5, device=dev)
    p = P // n_shards
    blk = lambda t, k: tree_map(lambda x: x[k * p:(k + 1) * p], t)  # noqa: E731
    cat = lambda trees: tree_map(lambda *xs: torch.cat(xs), *trees)  # noqa: E731

    def whole_vs_blocks(fn, *trees):
        return tree_max_diff(fn(*trees), cat([fn(*(blk(t, k) for t in trees))
                                              for k in range(n_shards)]))

    out = dict(state=whole_vs_blocks(lambda st, hy: train_fn(st, hy, key)[0], state0, hyp),
               losses=whole_vs_blocks(lambda st, hy: train_fn(st, hy, key)[1], state0, hyp))
    if mlp_seed is not None:
        x, y = _regression_data(256, state0[0]["w1"].shape[1], mlp_seed)(dev)
        h_of = lambda q: torch.tanh(x @ q["w1"] + q["b1"])  # noqa: E731
        mse = lambda q: torch.mean((h_of(q) @ q["w2"] + q["b2"] - y) ** 2)  # noqa: E731
        ops = {"x @ w1": lambda q: x @ q["w1"], "h @ w2": lambda q: h_of(q) @ q["w2"],
               "mse mean": mse, "grad": torch.func.grad(mse)}
        for name, fn in ops.items():
            out[name] = whole_vs_blocks(lambda q, fn=fn: torch.func.vmap(fn)(q), state0[0])
    return out


def elementwise_population(n_members):
    """The reference's graftmesh ``train_fn`` (``tests/test_graftmesh.py``):
    noise shared by every member from the step key, per-member elementwise
    math, on the card."""
    import torch

    from hyperopt_tpu_torch import random as R

    def train_fn(state, hypers, key):
        noise = R.normal(key, ()) * 0.01
        theta = state["theta"] - hypers["lr"] * 2.0 * (state["theta"] - 0.7) + noise
        return {"theta": theta}, (theta - 0.7) ** 2

    state0 = {"theta": torch.linspace(0.0, 5.0, n_members, device="cuda")}
    return train_fn, state0, {"lr": (1e-3, 1.0)}


def schedule_shards(card, model, what):
    """18b: ``compile_pbt`` (``what="pbt"``: pop 32 x 10 steps x 20
    rounds) or ``compile_sha`` (16 configs x 2 replicas, 10 steps per
    rung on the MLP, 2 on the elementwise model) on ``model`` ("mlp": 9b's population MLP; "elementwise":
    :func:`elementwise_population`), unsharded and with
    ``shard_mode="shard_map"`` on 2 and 4 shards: each captured run against
    its eager run, the sharded against the unsharded, PBT's gathers (counted
    in the eager run) and SHA's shards per rung.  The elementwise model
    must be bitwise; the MLP's PBT must keep its hypers bitwise and its
    loss history within ``MLP_SHARD_RTOL``, and its SHA the unsharded best
    hypers.  Where a sharded run is not the unsharded one's bits, one step
    of the model over the whole population is held against the same step
    over the blocks (:func:`block_probe`).  Returns the record and the
    faults."""
    import math

    import numpy as np

    from hyperopt_tpu_torch import hyperband as HB
    from hyperopt_tpu_torch import pbt as PBT
    from hyperopt_tpu_torch.parallel.mesh import TRIAL_AXIS, virtual_mesh
    from hyperopt_tpu_torch.pbt import compile_pbt
    from hyperopt_tpu_torch.utils import tree_map

    pop = PBT_POP if what == "pbt" else SHA_REPLICAS * SHA_CONFIGS
    make = population_mlp if model == "mlp" else elementwise_population
    train_fn, state0, bounds = make(pop) if what == "pbt" or model != "mlp" else make(pop, seed=2)
    runs, rec, faults = {}, {}, []
    for n in (None,) + SHARD_COUNTS:
        kw = {} if n is None else dict(mesh=virtual_mesh(n, TRIAL_AXIS), trial_axis=TRIAL_AXIS,
                                       shard_mode="shard_map")
        if what == "pbt":
            runner = compile_pbt(train_fn, state0, bounds, pop_size=PBT_POP,
                                 exploit_every=PBT_EXPLOIT_EVERY, n_rounds=PBT_ROUNDS, **kw)
        else:
            runner = HB.compile_sha(train_fn, state0, bounds, n_configs=SHA_CONFIGS, eta=2,
                                    steps_per_rung=SHA_STEPS if model == "mlp" else 2,
                                    replicas=SHA_REPLICAS, **kw)
        t0 = time.perf_counter()
        runner(seed=0)  # warm-up and capture
        p18_sync()
        capture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = runner(seed=1)
        p18_sync()
        wall = time.perf_counter() - t0
        # the eager run's gathers, each with the number of blocks it joins
        joined, gather = [], PBT._gather
        PBT._gather = lambda dst, blocks: joined.append(len(blocks)) or gather(dst, blocks)
        try:
            eager = runner._run(1, None, eager=True)
        finally:
            PBT._gather = gather
        gathers = len(joined) if what == "pbt" else None
        if what == "pbt" and joined != [n or 1] * (2 * PBT_ROUNDS):
            faults.append(f"pbt/{model} on {n} shards: gathers joined {joined}")
        if what == "pbt":
            captured = (np.array_equal(eager["loss_history"], res["loss_history"])
                        and np.array_equal(eager["log_hypers"], res["log_hypers"]))
            shards = None
        else:
            captured = (eager["rungs"] == res["rungs"]
                        and tree_max_diff(eager["state"], res["state"]) == 0.0)
            shards = None if n is None else [m.size for m in runner._rung_meshes]
        runs[n] = dict(res=res, seconds=wall, capture_s=capture_s, gathers=gathers,
                       captured_bitwise_eager=captured, rung_shards=shards)
    base = runs[None]["res"]
    for n in SHARD_COUNTS:
        run = runs[n]
        res = run.pop("res")
        if what == "pbt":
            gap = np.abs(res["loss_history"] - base["loss_history"])
            diff = dict(loss_history=float(gap.max()),
                        loss_history_rel=float((gap / np.maximum(
                            np.abs(base["loss_history"]), 1e-30)).max()),
                        log_hypers=float(np.abs(res["log_hypers"] - base["log_hypers"]).max()),
                        state=tree_max_diff(res["state"], base["state"]))
            blocks = [(PBT_POP, n)]
        else:
            diff = dict(rungs_equal=res["rungs"] == base["rungs"],
                        best_hypers_equal=res["best_hypers"] == base["best_hypers"],
                        state=tree_max_diff(res["state"], base["state"]))
            blocks = sorted({(pop // 2**r, math.gcd(pop // 2**r, n))
                             for r in range(len(base["rungs"]))})
        bitwise = all(v is True or v == 0.0 for v in diff.values())
        probe = None
        if not bitwise:
            # each (members, blocks) of the run: one step, whole against blocks
            probe = {f"{m}/{k}": block_probe(train_fn, tree_map(lambda x: x[:m], state0),
                                             bounds, k, mlp_seed=None if model != "mlp"
                                             else 0 if what == "pbt" else 2)
                     for m, k in blocks}
        run.update(bitwise=bitwise, diff=diff, probe=probe,
                   plain_seconds=runs[None]["seconds"])
        rec[str(n)] = run
        log(f"[18b] {card}: {what} on the {model} population, shard_map on {n} shards: "
            f"{run['seconds']:.3f} s (unsharded {runs[None]['seconds']:.3f} s), capture "
            f"{run['capture_s']:.2f} s"
            + ("" if what != "pbt" else f", {run['gathers']} gathers in {PBT_ROUNDS} rounds")
            + ("" if what != "sha" else f", shards per rung {run['rung_shards']}")
            + f"; captured bitwise eager: {run['captured_bitwise_eager']}; bitwise the "
            f"unsharded schedule: {bitwise} ({diff})"
            + ("" if probe is None else f"; one step, whole population against its blocks "
               f"(members/blocks: largest differences of state and losses, and of each "
               f"MLP operation alone under vmap): {probe}"))
        if not run["captured_bitwise_eager"]:
            faults.append(f"{what}/{model} on {n} shards: captured runs differ from eager")
        if model == "mlp" and what == "pbt" and not (
                diff["log_hypers"] == 0.0 and diff["loss_history_rel"] <= MLP_SHARD_RTOL):
            faults.append(f"pbt/mlp on {n} shards: hypers not bitwise or loss history past "
                          f"{MLP_SHARD_RTOL} relative ({diff})")
        if model == "mlp" and what == "sha" and not diff["best_hypers_equal"]:
            faults.append(f"sha/mlp on {n} shards: best hypers differ ({diff})")
        if what == "sha":
            want = [math.gcd(pop // 2**r, n) for r in range(len(base["rungs"]))]
            if run["rung_shards"] != want:
                faults.append(f"sha/{model} on {n} shards: rung shards {run['rung_shards']}")
        # a sharded schedule may part from the unsharded one only where one
        # step of the model itself gives a block other bits than the whole
        if not bitwise and (model != "mlp" or not any(
                v["state"] or v["losses"] for v in probe.values())):
            faults.append(f"{what}/{model} on {n} shards: not bitwise the unsharded "
                          f"schedule ({diff}) and the model's step is block-invariant")
    return rec, faults


def phase18(card):
    """The study and population axes inside one process, every shard on
    the one card: (a) 7b's serve protocol unsharded and on 2- and 4-shard
    study meshes, streams bitwise, one launch per shard per round, the
    out-of-order tell's shard-local rebuild, the NaN tenant, ms per round
    in pairs; (b) ``compile_pbt`` and ``compile_sha`` with
    ``shard_mode="shard_map"`` against their unsharded schedules; (c) the
    kernel at every per-shard fold.  Returns the launches by path and the
    numbers."""
    from hyperopt_tpu_torch.parallel.mesh import STUDY_AXIS, virtual_mesh

    t_phase = time.perf_counter()
    launches, out = {}, {"serve": {}, "pbt": {}, "sha": {}}
    # -- 18a. the serve protocol: unsharded, 2, 4, 4, unsharded -------------
    order = (None, 2, 4, 4, None)
    runs = [serve_protocol(None if n is None else virtual_mesh(n, STUDY_AXIS)) for n in order]
    plain = runs[0]
    full_rebuild = plain["ooo_upload_bytes"]
    faults = []
    for n, run in zip(order, runs):
        shards = 1 if n is None else n
        bitwise = run["streams"] == plain["streams"]
        rec = dict(round_ms=run["round_ms"], launches=run["launches"], rounds=run["rounds"],
                   launches_per_round=run["launches"] / run["rounds"],
                   ooo_upload_bytes=run["ooo_upload_bytes"], ooo_restacks=run["ooo_restacks"],
                   quarantined=run["quarantined"], refusals=run["refusals"],
                   evictions=run["counters"]["evictions"], bitwise=bitwise,
                   upload_bytes=run["counters"]["upload_bytes"],
                   shard_restacks=run["counters"]["shard_restacks"])
        out["serve"].setdefault(str(shards), []).append(rec)
        log(f"[18a] {card}: 7b's protocol ({SERVE_STUDIES} studies of mixed_space(), n_cand "
            f"128, 3 startup asks) on {shards} shard(s): {run['round_ms']:.3f} ms per timed "
            f"round; gmm_llr launches {run['launches']} in {run['rounds']} rounds "
            f"({run['timed_launches']} in the warm-up and {SERVE18_ROUNDS} timed rounds); the "
            f"out-of-order tell's round uploaded {run['ooo_upload_bytes']} bytes in "
            f"{run['ooo_restacks']} shard restack(s) (the unsharded full rebuild: "
            f"{full_rebuild}); the NaN tenant refused {run['refusals']}, evicted "
            f"{run['quarantined']}; every stream bitwise the unsharded run's: {bitwise}; "
            f"counters {run['counters']}")
        if not bitwise:
            faults.append(f"{shards} shards: streams differ from the unsharded run")
        if run["launches"] != shards * run["rounds"]:
            faults.append(f"{shards} shards: {run['launches']} launches in {run['rounds']} rounds")
        if not (run["quarantined"] and run["counters"]["evictions"] == 1):
            faults.append(f"{shards} shards: the NaN tenant was not evicted")
        if n is not None and not (run["ooo_restacks"] == 1
                                  and run["ooo_upload_bytes"] < full_rebuild):
            faults.append(f"{shards} shards: the out-of-order tell was not shard-local")
        if n is not None:
            launches[f"serve_shard_{n}"] = launches.get(f"serve_shard_{n}", 0) + run["launches"]
    pairs = [(runs[0]["round_ms"], runs[2]["round_ms"]), (runs[4]["round_ms"], runs[3]["round_ms"])]
    out["serve"]["pairs_ms_unsharded_4"] = pairs
    log(f"[18a] {card}: ms per round in pairs (unsharded, 4 shards): "
        + ", ".join(f"({a:.3f}, {b:.3f})" for a, b in pairs)
        + f"; 4 shards over unsharded {statistics.median(b / a for a, b in pairs):.3f}x")
    # -- 18b. compile_pbt and compile_sha, shard_map at 2 and 4 shards ---------
    # on 9b's population MLP, and on the reference's elementwise train_fn,
    # whose per-member math cannot depend on the block a member trains in
    for model in ("mlp", "elementwise"):
        for what in ("pbt", "sha"):
            rec, why = schedule_shards(card, model, what)
            out[what][model] = rec
            faults.extend(why)
    # -- 18c. the kernel at every per-shard fold -------------------------------
    for n in SHARD_COUNTS:
        seen = set().union(*(r["seen"] for m, r in zip(order, runs) if m == n))
        CHECKED_SHAPES[f"serve_shard_{n}"] = check_shapes(f"18 serve_shard_{n}, {card}", seen,
                                                          seed=181)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[18] {card}: phase 18 took {out['seconds']:.1f} s")
    assert not faults, faults
    return launches, out


MESH_RANKS = 4  # 19's cand axis: virtual ranks on the one card
MESH_TRIALS = 256  # 19a/19b: phase 8a's configuration cut to 256 trials
MESH_EAGER = 64  # 19a/19b: the first steps run eagerly against the replays
TRIAL_BATCH = 4  # 19c: the batch the trial axis places
ASHA_MESH_TRIALS = 128  # 19d: 8 of phase 9a's brackets (2 from the prior)
ATPE_MESH_TRIALS = 60  # 19e
P19_DEVICE = "cuda"  # where phase 19 computes


def p19_sync():
    import torch

    torch.cuda.synchronize()


def bare_replay_ms(runner, n_steps, seed):
    """ms per step of ``n_steps`` bare replays of ``runner``'s program from
    a cold carry (the host loop of ``compile_fmin``'s runner, nothing
    read back)."""
    prog = runner._program()
    prog.reset(seed, None, 0, float("inf"))
    p19_sync()
    t0 = time.perf_counter()
    for j in range(n_steps):
        prog.run(prog.loop.regime(j, 0))
    p19_sync()
    return (time.perf_counter() - t0) / n_steps * 1e3


def same_stream(a, b, fields=("values", "active", "losses")):
    import numpy as np

    return all(np.array_equal(a[f], b[f]) for f in fields)


def cand_mesh_loop(card, algo, launches, shapes):
    """19a (``algo="tpe"``) and 19b (``"atpe"``): phase 8a's compiled loop
    at ``MESH_TRIALS`` trials with the candidate sweep over
    ``MESH_RANKS`` virtual ranks, against the unsharded loop: startup
    bitwise, two runs bitwise, the first ``MESH_EAGER`` replayed steps
    bitwise the eager steps, ``MESH_RANKS`` launches per model step, ms
    per step in pairs with the unsharded program."""
    import numpy as np

    from hyperopt_tpu_torch.device_loop import compile_fmin
    from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn_torch
    from hyperopt_tpu_torch.parallel.mesh import virtual_mesh

    tag = "19a" if algo == "tpe" else "19b"
    path = f"compiled_{algo}_cand_{MESH_RANKS}"
    n, n_startup = MESH_TRIALS, 20
    kw = dict(n_EI_candidates=128, n_EI_candidates_cat=24, algo=algo, device=P19_DEVICE)
    t0 = time.perf_counter()
    plain = compile_fmin(mixed_space_fn_torch, mixed_space(), n, **kw)
    base = plain(seed=7)
    sharded = compile_fmin(mixed_space_fn_torch, mixed_space(), n,
                           mesh=virtual_mesh(MESH_RANKS), cand_axis="cand", **kw)
    with launch_shapes() as seen:
        first = sharded(seed=7)  # the warm call: both steps warmed up and captured
    warm_s = time.perf_counter() - t0
    shapes[path] = seen
    again = sharded(seed=7)
    prog = sharded._program()
    launches[path] = compiled_launches(prog)
    per_replay = dict(prog.launches_per_replay)
    startup = all(np.array_equal(first[f][..., :n_startup], base[f][..., :n_startup])
                  for f in ("values", "active", "losses"))
    two_runs = same_stream(first, again)
    prog.reset(7, None, 0, float("inf"))
    for j in range(MESH_EAGER):
        prog.step(prog.loop.regime(j, 0))
    ev, ea, el, _ = prog.host_state()
    m = MESH_EAGER
    eager = (np.array_equal(ev[:, :m], first["values"][:, :m])
             and np.array_equal(ea[:, :m], first["active"][:, :m])
             and np.array_equal(el[:m], first["losses"][:m]))
    a = bare_replay_ms(plain, n, 7)
    b = bare_replay_ms(sharded, n, 7)
    c = bare_replay_ms(sharded, n, 7)
    d = bare_replay_ms(plain, n, 7)
    pairs = [(a, b), (d, c)]
    ratio = statistics.median(b / a for a, b in pairs)
    rec = dict(trials=n, ranks=MESH_RANKS, launches=launches[path],
               launches_per_replay=per_replay, plain_launches_per_replay=dict(
                   plain._program().launches_per_replay),
               startup_bitwise=startup, two_runs_bitwise=two_runs,
               eager_steps_bitwise=eager, pairs_ms_per_step_unsharded_sharded=pairs,
               sharded_over_unsharded=ratio, warm_s=warm_s,
               best=first["best_loss"], plain_best=base["best_loss"])
    log(f"[{tag}] {card}: compile_fmin(mixed_space_fn_torch, mixed_space(), {n}, algo={algo!r}, "
        f"n_cand 128, cat 24) with the sweep over {MESH_RANKS} virtual ranks on the card: warm "
        f"calls {warm_s:.2f} s; gmm_llr launches {launches[path]} (captured per replay "
        f"{per_replay}; unsharded {rec['plain_launches_per_replay']}); the first {n_startup} "
        f"trials bitwise the unsharded run's: {startup}; two runs bitwise: {two_runs}; the "
        f"first {m} replayed steps bitwise the eager steps: {eager}; best {first['best_loss']:.6f}"
        f" (unsharded {base['best_loss']:.6f}); ms per step in pairs (unsharded, sharded): "
        + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in pairs)
        + f"; sharded over unsharded {ratio:.3f}x")
    faults = []
    if per_replay != {"prior": 0, "model": MESH_RANKS}:
        faults.append(f"{tag}: launches per replay {per_replay}")
    if launches[path] != MESH_RANKS * (n - n_startup):
        faults.append(f"{tag}: {launches[path]} launches")
    for what, ok in (("startup", startup), ("two runs", two_runs), ("eager", eager)):
        if not ok:
            faults.append(f"{tag}: {what} not bitwise")
    if not np.all(np.isfinite(first["losses"])):
        faults.append(f"{tag}: a loss is not finite")
    return rec, faults


def elementwise_trainable():
    """A per-trial trainable over ``mlp_tune_space()`` whose math is
    elementwise (no product, no reduction over the batch), as the
    reference's bitwise sharding tests' trainables are."""
    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch.device_loop import TrainableObjective

    def init(k, cfg):
        return {"w": R.uniform(k, (3,)) * cfg["init_scale"]}

    def step(s, cfg, epoch):
        return {"w": s["w"] - cfg["lr"] * (s["w"] - cfg["momentum"])}

    def loss(s, cfg):
        return (s["w"][0] - 0.5) ** 2 + cfg["wd"]

    return TrainableObjective(init, step, loss)


def phase19(card):
    """The compiled loop's mesh and ATPE's mesh, every rank on the one
    card: (a) the cand-sharded TPE loop and (b) ATPE's (see
    :func:`cand_mesh_loop`); (c) the trial axis at 2 and 4 ranks and the
    2 x 4 trial x cand mesh at B=4 on ``mixed_space_fn_torch``, bitwise
    the unsharded and the cand-only streams, with the unsharded launch
    count; (d) ASHA with ``trial_axis`` at 1, 2 and 4 ranks on phase 9a's
    bracket, on ``mlp_tune`` and an elementwise trainable: the sub-mesh
    sizes, every run bitwise the unsharded bracket with its launch
    count; (e) ``fmin`` with ``atpe.suggest(mesh=virtual_mesh(4))``;
    (f) the kernel at every new launch shape.  Returns the launches by
    path and the numbers."""
    import functools

    import numpy as np

    import hyperopt_tpu_torch as H
    from hyperopt_tpu_torch import atpe
    from hyperopt_tpu_torch.device_loop import compile_fmin
    from hyperopt_tpu_torch.models.synthetic import (mixed_space, mixed_space_fn,
                                                     mixed_space_fn_torch, mlp_tune_objective,
                                                     mlp_tune_space)
    from hyperopt_tpu_torch.ops import gmm_scores as G
    from hyperopt_tpu_torch.parallel.mesh import virtual_mesh

    t_phase = time.perf_counter()
    launches, shapes, out, faults = {}, {}, {}, []
    # -- 19a, 19b. the cand axis inside the captured step --------------------
    for algo in ("tpe", "atpe"):
        out[algo], why = cand_mesh_loop(card, algo, launches, shapes)
        faults += why
    # -- 19c. the trial axis and the 2-D mesh at B=4 --------------------------
    kw = dict(batch_size=TRIAL_BATCH, n_EI_candidates=128, n_EI_candidates_cat=24,
              device=P19_DEVICE)
    run = lambda **m: compile_fmin(mixed_space_fn_torch, mixed_space(), MESH_TRIALS,  # noqa: E731
                                   **m, **kw)
    plain_runner = run()
    plain = plain_runner(seed=3)
    plain_launches = compiled_launches(plain_runner._program())
    trial = {}
    for n in (2, 4):
        runner = run(mesh=virtual_mesh(n, "trial"))
        path = f"compiled_trial_{n}"
        with launch_shapes() as seen:
            trial[str(n)] = same_stream(runner(seed=3), plain)
        shapes[path] = seen
        launches[path] = compiled_launches(runner._program())
        if launches[path] != plain_launches:
            faults.append(f"19c: {path}: {launches[path]} launches, unsharded {plain_launches}")
    cand_only = run(mesh=virtual_mesh(MESH_RANKS), trial_axis=None, cand_axis="cand")
    two_d = run(mesh=virtual_mesh((2, MESH_RANKS), ("trial", "cand")), cand_axis="cand")
    with launch_shapes() as seen:
        two_d_out = two_d(seed=3)
    shapes["compiled_trial_cand"] = seen
    launches["compiled_trial_cand"] = compiled_launches(two_d._program())
    two_d_bitwise = same_stream(two_d_out, cand_only(seed=3))
    out["trial"] = dict(batch=TRIAL_BATCH, trials=MESH_TRIALS, trial_axis_bitwise=trial,
                        launches={n: launches[f"compiled_trial_{n}"] for n in (2, 4)},
                        plain_launches=plain_launches,
                        two_d_bitwise_cand_only=two_d_bitwise,
                        two_d_launches=launches["compiled_trial_cand"],
                        two_d_launches_per_replay=dict(two_d._program().launches_per_replay))
    log(f"[19c] {card}: B={TRIAL_BATCH}, {MESH_TRIALS} trials: the trial axis on 2 and 4 "
        f"virtual ranks bitwise the unsharded stream: {trial}, gmm_llr launches "
        f"{out['trial']['launches']} (unsharded {plain_launches}); trial 2 x cand {MESH_RANKS} bitwise "
        f"the cand-only program: {two_d_bitwise}, {launches['compiled_trial_cand']} launches "
        f"(per replay {out['trial']['two_d_launches_per_replay']})")
    if not all(trial.values()) or not two_d_bitwise:
        faults.append(f"19c: not bitwise ({out['trial']})")
    # -- 19d. ASHA with the trial axis ------------------------------------------
    total_ep = ASHA["rung_epochs"] * (ASHA["eta"] ** ASHA["n_rungs"] - 1) // (ASHA["eta"] - 1)
    B = ASHA_BATCH
    asha = {}
    for model in ("mlp", "elementwise"):
        fn = (mlp_tune_objective(n_epochs=total_ep) if model == "mlp"
              else elementwise_trainable())
        runs = {}
        for n in (None, 1, 2, 4):
            m = {} if n is None else dict(mesh=virtual_mesh(n, "trial"), trial_axis="trial")
            runner = compile_fmin(fn, mlp_tune_space(), ASHA_MESH_TRIALS, batch_size=B,
                                  asha=ASHA, device=P19_DEVICE, **m)
            t0 = time.perf_counter()
            with launch_shapes() as seen:
                runner(seed=0)  # warm-up and capture
            p19_sync()
            capture_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = runner(seed=1)
            p19_sync()
            runs[n] = dict(res=res, seconds=time.perf_counter() - t0, capture_s=capture_s,
                           submesh=getattr(runner, "_asha_submesh_devices", None),
                           launches=compiled_launches(runner._program()))
            if n is not None:
                shapes[f"asha_{model}_trial_{n}"] = seen
                launches[f"asha_{model}_trial_{n}"] = runs[n]["launches"]
        base = runs[None]["res"]
        rec = {}
        for n in (1, 2, 4):
            r = runs[n]
            res = r.pop("res")
            bitwise = same_stream(res, base, ("values", "active", "losses", "rung_of"))
            r.update(bitwise=bitwise, best=res["best_loss"], plain_best=base["best_loss"],
                     plain_seconds=runs[None]["seconds"], plain_launches=runs[None]["launches"])
            rec[str(n)] = r
            log(f"[19d] {card}: ASHA on {model}, brackets of {B} ({ASHA}), {ASHA_MESH_TRIALS} "
                f"trials, trial axis on {n} virtual rank(s): rung sub-mesh {r['submesh']}; "
                f"{r['seconds']:.3f} s (unsharded {r['plain_seconds']:.3f} s), capture "
                f"{r['capture_s']:.2f} s; gmm_llr launches {r['launches']} (unsharded "
                f"{r['plain_launches']}); bitwise the unsharded brackets: {bitwise}; best "
                f"{r['best']:.6f} (unsharded {r['plain_best']:.6f})")
            if r["submesh"] != min(n, ASHA_BATCH // ASHA["eta"] ** (ASHA["n_rungs"] - 1)):
                faults.append(f"19d: {model} on {n}: rung sub-mesh {r['submesh']}")
            if not bitwise:
                faults.append(f"19d: {model} on {n} ranks is not bitwise the unsharded run")
            if not 0 < r["launches"] == r["plain_launches"]:
                faults.append(f"19d: {model} on {n}: {r['launches']} launches, unsharded "
                              f"{r['plain_launches']}")
        asha[model] = rec
    out["asha"] = asha
    # -- 19e. atpe.suggest with the warm sweep over 4 virtual ranks ------------
    walls, streams, counted = {}, {}, {}
    for name, mesh in (("sharded", virtual_mesh(MESH_RANKS)), ("unsharded", None)):
        trials = H.Trials()
        p19_sync()
        before = G.KERNEL.launches
        t0 = time.perf_counter()
        with launch_shapes() as seen:
            H.fmin(mixed_space_fn, mixed_space(), algo=functools.partial(atpe.suggest, mesh=mesh),
                   max_evals=ATPE_MESH_TRIALS, trials=trials, rstate=np.random.default_rng(0),
                   device=P19_DEVICE, show_progressbar=False)
        p19_sync()
        walls[name] = time.perf_counter() - t0
        counted[name] = G.KERNEL.launches - before
        streams[name] = trials
        if name == "sharded":
            shapes["atpe_mesh_fmin"] = seen
            launches["atpe_mesh_fmin"] = counted[name]
    losses = streams["sharded"].losses()
    startup = ([t["misc"]["vals"] for t in streams["sharded"].trials[:20]]
               == [t["misc"]["vals"] for t in streams["unsharded"].trials[:20]])
    out["atpe_fmin"] = dict(trials=ATPE_MESH_TRIALS, launches=counted, walls_s=walls,
                            ms_per_trial={k: v / ATPE_MESH_TRIALS * 1e3 for k, v in walls.items()},
                            best=float(min(losses)),
                            plain_best=float(min(streams["unsharded"].losses())),
                            startup_equal=startup)
    log(f"[19e] {card}: fmin(mixed_space_fn, mixed_space(), algo=partial(atpe.suggest, "
        f"mesh=virtual_mesh({MESH_RANKS}))), {ATPE_MESH_TRIALS} trials: {walls['sharded']:.2f} s "
        f"(unsharded {walls['unsharded']:.2f} s), gmm_llr launches {counted} (sharded, "
        f"unsharded), best {min(losses):.6f} (unsharded {out['atpe_fmin']['plain_best']:.6f}); "
        f"the 20 startup trials equal: {startup}")
    if counted != {"sharded": MESH_RANKS * (ATPE_MESH_TRIALS - 20),
                   "unsharded": ATPE_MESH_TRIALS - 20}:
        faults.append(f"19e: launches {counted}")
    if not (startup and np.all(np.isfinite(losses))):
        faults.append("19e: the startup trials differ or a loss is not finite")
    # -- 19f. the kernel at every new launch shape ----------------------------
    want = (1, 12, 128 // MESH_RANKS)
    if not any(s[:3] == want for s in shapes[f"compiled_tpe_cand_{MESH_RANKS}"]):
        faults.append(f"19f: no launch at {want}: {shapes}")
    out["checked"] = {}
    for path, seen in shapes.items():
        CHECKED_SHAPES[path] = out["checked"][path] = check_shapes(f"19 {path}, {card}", seen,
                                                                   seed=191)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[19] {card}: phase 19 took {out['seconds']:.1f} s")
    assert not faults, faults
    return launches, out


P20_DEVICE = "cuda"  # where phase 20's ranks and models compute
MESH_MODEL_STEPS = 6  # 20b: timed steps of each model, in pairs with its mesh=None twin
HB_MESH = dict(s_max=3, eta=2, steps_per_rung=5)  # 20c: brackets of 8, 4, 2 and 1 configs
DCN_LOOP = re.compile(r"loop_launches_by_rank=\[([0-9, ]*)\]")


def p20_sync():
    import torch

    if P20_DEVICE != "cpu":
        torch.cuda.synchronize()


def mesh_pairs(steps, args, n):
    """``n`` steps of each of ``steps`` (name -> ``step(params, momentum,
    lr, wd, *data)``) from the same start, in turn, each timed by CUDA
    events (the host clock on the CPU): the ms per step of each, and
    whether every step's params, momenta and losses are equal bit for bit."""
    import torch

    params, momentum, lr, wd, data = args
    state = {k: (params, momentum) for k in steps}
    ms = {k: [] for k in steps}
    bitwise = True
    for _ in range(n):
        outs = {}
        for k, step in steps.items():
            p20_sync()
            t0 = time.perf_counter()
            if P20_DEVICE != "cpu":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
            p, m, loss = step(*state[k], lr, wd, *data)
            if P20_DEVICE != "cpu":
                end.record()
                end.synchronize()
                ms[k].append(start.elapsed_time(end))
            else:
                ms[k].append((time.perf_counter() - t0) * 1e3)
            state[k] = (p, m)
            outs[k] = (p, m, loss)
        (p0, m0, l0), (p1, m1, l1) = outs.values()
        bitwise = bitwise and torch.equal(l0, l1) and all(
            torch.equal(p0[n_], p1[n_]) and torch.equal(m0[n_], m1[n_]) for n_ in p0)
    return {k: statistics.median(v) for k, v in ms.items()}, bitwise


def phase20(card):
    """Populations across processes and the models' ``mesh=``, on the one
    card: (a) ``dcn_check.launch(world=2)`` with stages A-E, two ``gloo``
    ranks sharing the card (each rank's captured graphs, the host gathers
    between them): stage C's ``compile_fmin`` over the ``trial`` axis
    (64 evaluations at B=2), D's ``compile_sha`` and E's ``compile_pbt``
    over the ranks, each bitwise its unsharded run (in the ranks, and
    here against the same runs in this process), the gathers per stage,
    each stage's wall and each rank's ``gmm_llr`` launches in stage C;
    (b) TinyLM at ``bench_pbt``'s width (pop 32) and ResNet-20 at 14e's
    (8 members, batch 128) through ``make_population_train_step(mesh=
    virtual_mesh((2, 4), ("trial", "cand")))``, bitwise the step without
    a mesh, ms per step in pairs; (c) ``compile_hyperband(mesh=
    virtual_mesh(4, "trial"))`` on 9b's population MLP, bitwise the
    spread without a mesh; (d) the kernel against its plain version at
    stage C's launch shape.  Returns the launches by path and the
    numbers."""
    import numpy as np
    import torch

    from hyperopt_tpu_torch import hyperband as HB
    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch.models import resnet as TR
    from hyperopt_tpu_torch.models import transformer as TT
    from hyperopt_tpu_torch.models.synthetic import _mlp_pieces
    from hyperopt_tpu_torch.parallel import dcn_check
    from hyperopt_tpu_torch.parallel.mesh import TRIAL_AXIS, virtual_mesh

    t_phase = time.perf_counter()
    launches, shapes, out = {}, {}, {}
    assert not torch.distributed.is_initialized()
    # -- 20a. stages A-E on two gloo ranks sharing the card -----------------
    t0 = time.perf_counter()
    report = dcn_check.launch(world=2, timeout=400, device=P20_DEVICE)
    dcn_s = time.perf_counter() - t0
    result = next(ln for ln in report.splitlines() if ln.startswith("DCN RESULT"))
    loop_by_rank = [int(x) for x in DCN_LOOP.search(result).group(1).split(",")]
    ab_by_rank = [int(x) for x in DCN_RESULT.search(result).group(1).split(",")]
    launches["dcn_loop_2"] = sum(loop_by_rank)
    spawned = dcn_check.parse_values(report)
    # the twin: stages C-E unsharded in this process on the card; stage C's
    # launch shapes are the ranks' (each rank runs the same suggestion)
    with launch_shapes() as seen:
        plain = dcn_check.unsharded_population(P20_DEVICE, 2)
    shapes["dcn_loop_2"] = seen
    pop_bitwise = all(spawned[st] == plain[st] for st in "CDE")
    n_model = (dcn_check.LOOP_EVALS - 20) // 2  # model steps of a run: 20 startup trials
    out["ranks"] = dict(seconds=dcn_s, result=result, loop_launches_by_rank=loop_by_rank,
                        ab_launches_by_rank=ab_by_rank, bitwise_unsharded_here=pop_bitwise)
    log(f"[20a] {card}: two gloo ranks on the one card, stages A-E ({dcn_s:.2f} s with the "
        f"ranks' start): {result}; stages C-E bitwise their unsharded runs in this process "
        f"on the card: {pop_bitwise}")
    for field in ("gathers_per_step=[1, 1, 1]", "loop_matches_unsharded=True",
                  "sha_matches_unsharded=True", "pbt_matches_unsharded=True",
                  "boundaries={'C': 32, 'D': 2, 'E': 4}",
                  "gathers_by_stage={'C': 32, 'D': 4, 'E': 8}", "ranks_agree=True"):
        assert field in result, (field, result)
    # stage C: one launch per model step in each of its two runs, per rank
    assert loop_by_rank == [2 * n_model] * 2, loop_by_rank
    assert ab_by_rank == [3, 3], ab_by_rank
    assert pop_bitwise, "the ranks' stages C-E differ from the unsharded runs here"

    # -- 20b. the models' mesh=: placement, the unsharded step -------------
    dev = torch.device(P20_DEVICE)
    mesh = virtual_mesh((2, 4), (TRIAL_AXIS, "cand"))
    model = TT.TinyLM(**LM)
    params = TT.init_population(model, PBT_POP, R.key(0, device=dev), seq_len=LM["max_len"],
                                device=dev)
    tokens = TT.synthetic_token_batch(R.key(1, device=dev), LM_DATA["batch_size"],
                                      LM_DATA["seq_len"], LM_DATA["vocab"], n_deltas=8)
    lr = torch.exp(torch.linspace(np.log(0.3), np.log(0.003), PBT_POP, device=dev))
    wd = torch.full((PBT_POP,), 1e-5, device=dev)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    lm_ms, lm_bitwise = mesh_pairs(
        {"plain": TT.make_population_train_step(model, device=dev),
         "mesh": TT.make_population_train_step(model, mesh=mesh, device=dev)},
        (params, zeros, lr, wd, (tokens,)), MESH_MODEL_STEPS)
    net = TR.resnet20()
    rparams = TR.init_population(net, RESNET_POP, R.key(0, device=dev), device=dev)
    images, labels = TR.synthetic_cifar_batch(R.key(1, device=dev), RESNET_BATCH, RESNET_IMAGE)
    rlr = torch.exp(torch.linspace(np.log(0.3), np.log(0.003), RESNET_POP, device=dev))
    rwd = torch.full((RESNET_POP,), 1e-4, device=dev)
    rzeros = {k: torch.zeros_like(v) for k, v in rparams.items()}
    rn_ms, rn_bitwise = mesh_pairs(
        {"plain": TR.make_population_train_step(net, device=dev),
         "mesh": TR.make_population_train_step(net, mesh=mesh, device=dev)},
        (rparams, rzeros, rlr, rwd, (images, labels)), MESH_MODEL_STEPS)
    out["models"] = dict(tinylm_ms=lm_ms, tinylm_bitwise=lm_bitwise, resnet_ms=rn_ms,
                         resnet_bitwise=rn_bitwise, steps=MESH_MODEL_STEPS)
    log(f"[20b] {card}: make_population_train_step(mesh={mesh!r}) against mesh=None, "
        f"{MESH_MODEL_STEPS} steps each in pairs: TinyLM {LM} pop {PBT_POP}, batch "
        f"{LM_DATA['batch_size']} x {LM_DATA['seq_len']}: median ms per step {lm_ms}, bitwise "
        f"{lm_bitwise}; ResNet-20 x {RESNET_POP} at batch {RESNET_BATCH} of {RESNET_IMAGE}x"
        f"{RESNET_IMAGE}: {rn_ms}, bitwise {rn_bitwise}")
    assert lm_bitwise and rn_bitwise, "a model's step on a mesh is not its step without one"
    del params, zeros, rparams, rzeros

    # -- 20c. compile_hyperband(mesh=) on 9b's population MLP -------------
    init, _, _ = _mlp_pieces(256, 8, 32, 0)
    train_fn, _, bounds = population_mlp(2)

    def mlp_population(key, n):
        return torch.func.vmap(lambda k: init(k, 0.3))(R.split(key, n))

    spreads = {}
    for name, kw in (("plain", {}), ("mesh", dict(mesh=virtual_mesh(4, TRIAL_AXIS),
                                                  trial_axis=TRIAL_AXIS))):
        runner = HB.compile_hyperband(train_fn, mlp_population, bounds, device=dev, **HB_MESH,
                                      **kw)
        runner(seed=0)  # warm-up and capture of every bracket's rungs
        p20_sync()
        t0 = time.perf_counter()
        spreads[name] = (runner(seed=1), time.perf_counter() - t0,
                         [[m.size for m in run._rung_meshes] if kw else None
                          for _, run in runner._brackets])
    hb_bitwise = spreads["mesh"][0] == spreads["plain"][0]
    out["hyperband"] = dict(config=HB_MESH, seconds={k: v[1] for k, v in spreads.items()},
                            bitwise=hb_bitwise, rung_shards=spreads["mesh"][2],
                            best_loss=spreads["plain"][0]["best_loss"])
    log(f"[20c] {card}: compile_hyperband({HB_MESH}) on 9b's population MLP, "
        f"mesh=virtual_mesh(4, 'trial') against none: rung sub-meshes by bracket "
        f"{spreads['mesh'][2]}, timed run {spreads['plain'][1]:.3f} s plain and "
        f"{spreads['mesh'][1]:.3f} s on the mesh, best {spreads['plain'][0]['best_loss']:.6f} "
        f"(bracket {spreads['plain'][0]['best_bracket']}), bitwise {hb_bitwise}")
    assert hb_bitwise, "compile_hyperband on a mesh is not the spread without one"

    # -- 20d. the kernel at stage C's launch shape --------------------------
    for path, seen in shapes.items():
        CHECKED_SHAPES[path] = check_shapes(f"20 {path}, {card}", seen, seed=201)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[20] {card}: phase 20 took {out['seconds']:.1f} s")
    return launches, out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    import hyperopt_tpu_torch as H
    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch.fmin import FMinIter
    from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn
    from hyperopt_tpu_torch.ops import gmm_scores as G
    from hyperopt_tpu_torch.ops import kernels as TK
    from hyperopt_tpu_torch.torch_trials import obs_buffer_for, packed_space_for

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_seconds, t_lap = {}, [t_start]

    def lap(name):
        """Log and keep the seconds since the previous lap: where the
        script's time goes, phase by phase."""
        now = time.perf_counter()
        phase_seconds[name] = now - t_lap[0]
        t_lap[0] = now
        log(f"[{name}] took {phase_seconds[name]:.1f} s")

    # -- 1. the card; build the kernel ------------------------------------
    card = smi("name,power.limit")
    log(f"[1] card: {card}")
    props = torch.cuda.get_device_properties(0)
    max_clock_mhz = float(smi("clocks.max.sm").split()[0])
    sfu_per_s = props.multi_processor_count * SFU_PER_SM_PER_CLOCK * max_clock_mhz * 1e6
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{props.multi_processor_count} SMs, max SM clock {max_clock_mhz} MHz; tqdm "
        f"{'importable' if importlib.util.find_spec('tqdm') else 'not importable'} (every "
        "fmin here passes show_progressbar=False)")
    t0 = time.perf_counter()
    G.KERNEL.fn()
    log(f"[1] {G.KERNEL.source} built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc: {G.KERNEL.build_seconds} s; None = already built)")
    if G.KERNEL.build_log:
        log("[1] ptxas: " + " | ".join(
            ln.strip() for ln in G.KERNEL.build_log.splitlines() if "ptxas" in ln))
    sass_per_term = {}
    tool = cuobjdump()
    if tool is None:
        log("[1] SASS: cuobjdump is absent; the inner loop's instructions per term "
            "were not counted")
    else:
        sass = subprocess.run([tool, "-sass", G.KERNEL.library_path()[1]],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        for name, loop in sorted(sass_inner_loops(sass).items()):
            config = kernel_config(name)
            if config is None or loop is None:
                continue
            n_ins, n_ex2 = loop
            sass_per_term[config] = n_ins / n_ex2
            log(f"[1] SASS inner loop of gmm_llr_kernel<k_lanes={config[0]}, rows={config[1]}>: "
                f"{n_ins} instructions, {n_ex2} MUFU.EX2: {n_ins / n_ex2:.3f} per term")
        assert set(sass_per_term) == set(G.CONFIGS), sorted(sass_per_term)

    lap("1")
    # -- 8. the compiled loop, before any profiler has traced: once one has
    # run in the process, every graph replay holds the host until the card
    # has run it, which would hide the replays' host cost ----------------
    compiled_launches_by_path, mlp_result, compiled, profile_8f = phase8(sfu_per_s)
    lap("8")
    # -- 9. the multi-fidelity schedulers, before any profiler too ---------
    sched_launches, schedulers, asha_result, profile_9, profile_9d = phase9(sfu_per_s)
    lap("9")
    compiled_launches_by_path.update(sched_launches)
    # -- 14. the population models, before any profiler too ---------------
    population_launches, population = phase14()
    compiled_launches_by_path.update(population_launches)
    lap("14")
    # -- 15. the BASELINE configurations, the card's TPE beside the host TPE
    baseline_launches, baseline, north_star = phase15(card)
    compiled_launches_by_path.update(baseline_launches)
    lap("15")
    # -- 19. the compiled loop's mesh and ATPE's mesh, before any profiler
    mesh_loop_launches, compiled_mesh = phase19(card)
    compiled_launches_by_path.update(mesh_loop_launches)
    lap("19")
    # -- 20. populations across processes and the models' mesh, before any
    # profiler too ----------------------------------------------------------
    population_mesh_launches, population_mesh = phase20(card)
    compiled_launches_by_path.update(population_mesh_launches)
    lap("20")
    # then the kernel's timings at both shapes and the profiled window of
    # the compiled loop (the ASHA brackets' window runs last of all)
    profile_8f()
    profile_9()
    lap("8f, 9 profiles")

    # -- 2. kernel against its plain version -----------------------------
    results = {}
    for name, shape in (("fmin", FMIN_SHAPE), ("main", MAIN_SHAPE), ("stage", STAGE_SHAPE)):
        x, ls, pb, pa = scoring_inputs(shape, seed=7, device=dev)
        got = G.gmm_llr(x, ls, pb, pa)
        again = G.gmm_llr(x, ls, pb, pa)
        torch.cuda.synchronize()
        want = plain_chunked(G, x, ls, pb, pa)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), "kernel output not finite"
        assert torch.equal(got, again), "two launches on the same inputs differ"
        err = (got - want).abs()
        max_abs = float(err.max())
        max_rel = float((err / want.abs().clamp_min(1e-6)).max())
        argmax_agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        ok = torch.allclose(got, want, rtol=G.KERNEL_RTOL, atol=G.KERNEL_ATOL)
        run_kernel = lambda: G.gmm_llr(x, ls, pb, pa)
        run_plain = lambda: plain_chunked(G, x, ls, pb, pa)
        big = shape["B"] > 256
        ms = device_ms(run_kernel, 20)
        call_ms = cuda_ms(run_kernel)
        call_host_ms = host_ms(run_kernel, 200)
        plain_ms = device_ms(run_plain, 2 if big else 10)
        plain_call_ms = cuda_ms(run_plain, warmup=1, reps=3, iters=1 if big else 5)
        b = bound(shape, sfu_per_s)
        picked = G.launch_config(shape["B"] * shape["S"], shape["Dg"],
                                 props.multi_processor_count)
        out = torch.empty_like(x)
        by_config = {c: device_ms(lambda c=c: G.launch(x, ls, pb, pa, out, c), 10)
                     for c in G.CONFIGS}
        results[name] = dict(B=shape["B"], max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                             config=picked, host_ms=call_host_ms, **b)
        log(f"[2] {name} {shape}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
            f"argmax agreement {argmax_agree:.6f}; device time: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms; per call by CUDA events: kernel {call_ms:.4f} ms, "
            f"plain {plain_call_ms:.4f} ms; wrapper host time per call {call_host_ms:.4f} ms "
            f"(host clock over 200 calls); "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} (bytes {b['bytes_ms']:.4f}, "
            f"fp32 {b['fp32_ms']:.4f}, sfu {b['sfu_ms']:.4f} ms; {b['terms']} terms); "
            f"kernel at {b['bound_ms'] / ms:.3f} of the bound")
        log(f"[2] {name}: device ms by (k_lanes, rows), wrapper picks {picked}: "
            + ", ".join(f"{c} {t:.4f}" for c, t in by_config.items()))
        assert ok, f"kernel disagrees with the plain version at {shape}: {max_abs}"
        assert argmax_agree >= 0.999, argmax_agree
        del x, ls, pb, pa, got, again, want, out
        torch.cuda.empty_cache()
    # the B=64 kernel's time split into a part that grows with K and one
    # that does not, from a second K_above at the same split
    short = dict(MAIN_SHAPE, Ka=128)
    x, ls, pb, pa = scoring_inputs(short, seed=7, device=dev)
    assert G.launch_config(short["B"] * short["S"], short["Dg"],
                           props.multi_processor_count) == results["main"]["config"]
    ms_short = device_ms(lambda: G.gmm_llr(x, ls, pb, pa), 20)
    k_long, k_short = MAIN_SHAPE["Kb"] + MAIN_SHAPE["Ka"], short["Kb"] + short["Ka"]
    per_k = (results["main"]["ms"] - ms_short) / (k_long - k_short)
    fixed = ms_short - per_k * k_short
    terms_per_clock = (results["main"]["terms"] / k_long / (per_k * 1e-3)
                       / props.multi_processor_count / (max_clock_mhz * 1e6))
    log(f"[2] main at K_above {short['Ka']}: {ms_short:.4f} ms; so at B=64 the kernel takes "
        f"{fixed:.4f} ms whatever K, and {per_k * 1e3:.4f} us per component of K "
        f"({terms_per_clock:.2f} terms per SM per clock of the SFU's 16)")
    del x, ls, pb, pa

    lap("2")
    # -- 3. suggest_batch at batch 64 on a 500-obs history ----------------
    domain = H.Domain(mixed_space_fn, mixed_space(), device="cuda")
    trials = history_trials(domain, 500, seed=11)
    before = G.KERNEL.launches
    H.tpe.suggest_batch(list(range(500, 564)), domain, trials, 1)  # warm-up
    n_calls = 20
    t0 = time.perf_counter()
    for i in range(n_calls):
        idxs, vals = H.tpe.suggest_batch(list(range(500, 564)), domain, trials, 2 + i)
    dt = time.perf_counter() - t0
    assert G.KERNEL.launches > before, "suggest_batch did not launch the kernel"
    flat = [v for vs in vals.values() for v in vs]
    assert len(vals) == 20 and all(len(v) == 64 for v in vals.values())
    assert np.all(np.isfinite(flat))
    log(f"[3] suggest_batch B=64 on 500 obs: {64 * n_calls / dt:.1f} suggestions/s "
        f"({dt / n_calls * 1e3:.2f} ms per call, {G.KERNEL.launches - before} kernel launches)")

    lap("3")
    # -- 4. the main path: sequential 1000-trial fmin ---------------------
    n_trials, n_startup = 1000, 20
    fmin_trials = H.Trials()
    G.KERNEL.launches = 0
    t0 = time.perf_counter()
    H.fmin(mixed_space_fn, mixed_space(), algo=H.tpe.suggest, max_evals=n_trials,
           trials=fmin_trials, rstate=np.random.default_rng(0), device="cuda",
           show_progressbar=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = G.KERNEL.launches
    losses = fmin_trials.losses()
    best = min(losses)
    log(f"[4] fmin {n_trials} trials: best loss {best:.6f} (best of the {n_startup} "
        f"startup trials {min(losses[:n_startup]):.6f}), wall {wall:.2f} s "
        f"({wall / n_trials * 1e3:.2f} ms per trial), kernel launches {main_launches}")
    assert len(losses) == n_trials and np.all(np.isfinite(losses))
    assert main_launches == n_trials - n_startup, main_launches
    assert best < min(losses[:n_startup]), "TPE did not improve on its startup draws"
    # where an ask's time goes: 20 more asks of the same loop, profiled
    in_suggest = []

    def timed_suggest(*args):
        t = time.perf_counter()
        docs = H.tpe.suggest(*args)
        in_suggest.append(time.perf_counter() - t)
        return docs

    it = FMinIter(timed_suggest, H.Domain(mixed_space_fn, mixed_space(), device="cuda"),
                  fmin_trials, rstate=np.random.default_rng(1), show_progressbar=False)
    it.run(3)  # warm-up: compile the space, sync the buffer
    plain_buf = it.domain._torch_obs_buffer[1]
    ask_ms, suggest_ms, plain_bytes_per_ask = ask_window(it, 20, in_suggest, plain_buf)
    prof = profile_asks(it, 20)
    log(f"[4] 20 asks at {len(fmin_trials.trials) - 40} obs: {ask_ms:.3f} ms per ask "
        f"and evaluation, {suggest_ms:.3f} ms of it in tpe.suggest, "
        f"{plain_bytes_per_ask:.1f} bytes moved per ask; " + describe_profile(prof, ask_ms))
    ops = count_ops(lambda: it.run(5))
    log(f"[4] PyTorch operations per ask: {sum(ops.values()) / 5:.1f}; by module: "
        + ", ".join(f"{m} {c / 5:.1f}" for m, c in ops.most_common()))
    lap("4")
    # -- 15b. the north star: the host TPE on this 1000-trial history ------
    baseline["north_star"] = north_star(H.trials_from_docs(fmin_trials.trials[:n_trials]),
                                        suggest_ms, ask_ms)
    lap("15b")

    # -- 5. CUDA against CPU, teacher-forced on the phase-3 history -------
    cpu_domain = H.Domain(mixed_space_fn, mixed_space(), device="cpu")
    picks, cands = {}, {}
    batch = 64
    for name, d in (("cuda", domain), ("cpu", cpu_domain)):
        ps = packed_space_for(d)
        state = obs_buffer_for(d, trials).device_arrays(pow2_cap=TK.DEFAULT_ABOVE_CAP)
        key = R.key(12345, device=ps.device)
        fn = H.tpe.build_suggest_fn(ps, 128, 0.25, 25, 1.0, n_cand_cat=24)
        v, a = fn(key, *state, batch)
        picks[name] = (v.cpu().numpy(), a.cpu().numpy())
        fits = TK.fit_all_dims(ps.consts, *state, 0.25, 25.0, 1.0, above_cap=TK.DEFAULT_ABOVE_CAP)
        dc, dk = len(ps.cont_idx), len(ps.cat_idx)
        keys = R.split(key, batch * (dc + dk))
        _, llr = TK.ei_sweep_cont_candidates(
            ps.q, ps.consts, keys[: batch * dc].reshape(batch, dc, 2), fits["cont"], 128)
        pb, pa = fits["cat"]
        cands[name] = (llr.cpu().numpy(), (torch.log(pb.clamp_min(1e-30))
                                           - torch.log(pa.clamp_min(1e-30))).cpu().numpy())
    ps = packed_space_for(cpu_domain)
    (gv, ga), (cv, ca) = picks["cuda"], picks["cpu"]
    assert np.array_equal(ga, ca), "active masks differ"
    cont, cat = ps.cont_idx, ps.cat_idx
    cont_same = np.isclose(gv[cont], cv[cont], rtol=1e-4, atol=1e-5)
    cat_same = gv[cat] == cv[cat]
    # every disagreement must be a near-tie under the CPU's own scores
    llr_g, llr_c = cands["cuda"][0], cands["cpu"][0]
    ig, ic = llr_g.argmax(-1), llr_c.argmax(-1)  # [B, Dc]
    cont_margin = (np.take_along_axis(llr_c, ic[..., None], -1)
                   - np.take_along_axis(llr_c, ig[..., None], -1))[..., 0].T
    cat_llr = cands["cpu"][1]
    kg = (gv[cat] - ps.int_low[:, None]).astype(int)
    kc = (cv[cat] - ps.int_low[:, None]).astype(int)
    cat_margin = np.abs(np.take_along_axis(cat_llr, kc, 1) - np.take_along_axis(cat_llr, kg, 1))
    bad = (~cont_same & (cont_margin >= NEAR_TIE)).sum() + (~cat_same & (cat_margin >= NEAR_TIE)).sum()
    log(f"[5] CUDA vs CPU, B={batch} on 500 obs: continuous picks agree {cont_same.mean():.6f}, "
        f"categorical {cat_same.mean():.6f}, active equal; "
        f"{(~cont_same).sum() + (~cat_same).sum()} disagreements, {bad} not near-ties "
        f"(margin >= {NEAR_TIE})")
    assert bad == 0, "CUDA and CPU disagree beyond near-ties"

    lap("5")
    # -- 6. every other suggest path on the card ---------------------------
    launches_by_path = {"fmin": main_launches}
    launches_by_path.update(phase6(domain, cpu_domain, trials, losses,
                                   lambda: ask_window(it, 20, in_suggest, plain_buf)))
    lap("6")

    # -- 7. the study-batched serve engine ---------------------------------
    serve_launches, results["serve"], serve = phase7(cpu_domain, sfu_per_s,
                                                     props.multi_processor_count)
    launches_by_path.update(serve_launches)
    launches_by_path.update(compiled_launches_by_path)
    lap("7")

    # -- 10. durable fmin: the engine client, the WALs, containment --------
    durable_launches, durable = phase10(card)
    lap("10")
    launches_by_path.update(durable_launches)
    # -- 11. the suggestion service as a network process -------------------
    transport_launches, transport, trace_11f = phase11(card)
    launches_by_path.update(transport_launches)
    lap("11")
    # -- 12. the serve fleet -----------------------------------------------
    fleet_launches, fleet = phase12(card, sfu_per_s)
    launches_by_path.update(fleet_launches)
    lap("12")
    # -- 13. asynchronous trial farming -----------------------------------
    farm_launches, farm = phase13(card)
    launches_by_path.update(farm_launches)
    lap("13")
    # -- 16. the port's own checks: the lint packs, lockdep on the card -----
    check_launches, checks = phase16(card)
    launches_by_path.update(check_launches)
    lap("16")
    # -- 17. the rank-sharded suggest: one rank, two ranks on the one card --
    sharded_launches, sharded_out = phase17(card)
    launches_by_path.update(sharded_launches)
    lap("17")
    # -- 18. the study and population axes inside one process ---------------
    mesh_launches, study_mesh_out = phase18(card)
    launches_by_path.update(mesh_launches)
    lap("18")
    results["mlp"] = mlp_result
    results["asha"] = asha_result
    profile_9d()
    # -- 11f. device_trace, last of all (after a trace, later ones came back empty)
    transport["trace"] = trace_11f()
    lap("9d, 11f")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    main = results["fmin"]  # the shape of the main path's asks
    picked = main["config"]
    kernels = {"kernels": [{
        "name": "gmm_llr",
        "route": "cuda",
        "source": "hyperopt_tpu_torch/csrc/gmm_scores.cu",
        "replaces": "hyperopt_tpu/ops/pallas_kernels.py:97",
        "launches": main_launches,
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "launches_by_path": launches_by_path,
        "sass_per_term": sass_per_term.get(picked),
        "shapes": {name: {"B": r["B"], "k_lanes": r["config"][0], "rows": r["config"][1],
                          "ms": r["ms"], "bound_ms": r["bound_ms"], "plain_ms": r["plain_ms"],
                          "host_ms": r["host_ms"], "max_abs_err": r["max_abs_err"],
                          "sass_per_term": sass_per_term.get(r["config"]),
                          **({"studies": r["N"], "forced_ms": r["forced_ms"],
                              "best_split": list(r["best_config"]), "best_ms": r["best_ms"]}
                             if name == "serve" else {})}
                   for name, r in results.items()},
        "serve": serve,
        "compiled": compiled,
        "schedulers": schedulers,
        "durable": durable,
        "transport": transport,
        "fleet": fleet,
        "farm": farm,
        "population": population,
        "baseline": baseline,
        "checks": checks,
        "sharded": sharded_out,
        "study_mesh": study_mesh_out,
        "compiled_mesh": compiled_mesh,
        "population_mesh": population_mesh,
        "checked_shapes": CHECKED_SHAPES,
        "phase_seconds": phase_seconds,
    }]}
    print(json.dumps(kernels))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
