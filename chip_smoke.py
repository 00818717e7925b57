#!/usr/bin/env python3
"""Drive the PyTorch port (hyperopt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card; it builds
the port's CUDA kernel from the sources in the checkout and needs no
network.  Every phase asserts, and a failure exits non-zero:

1. the card's name and power limit; build the kernel (nvcc, sm_90a);
2. the kernel against its plain PyTorch version on the card at the
   shapes the 20-dim mixed space gives it (Dg=12, S=128): the sequential
   fmin's asks (B=1, K_below=17, K_above=512), ``suggest_batch`` at
   B=64 on a 500-obs history (K_below=9, K_above=512), and the
   reference's stage batch (B=4096): max error, argmax agreement, kernel
   and plain times (CUDA events, warm-up, median) and the bound;
3. ``tpe.suggest_batch`` at batch 64 on a 500-obs history of
   ``mixed_space()``: suggestions/s, and the kernel launched;
4. the main path: a sequential 1000-trial ``fmin`` on ``mixed_space_fn``
   with the port's ``tpe.suggest``: best loss, wall time, and one kernel
   launch per TPE ask (980); then 20 more asks under ``torch.profiler``
   (host time, device busy time and idle share per ask);
5. the port on CUDA against the port on the CPU, teacher-forced on the
   phase-3 history: every disagreeing pick must be a near-tie.

The last lines are one JSON object per kernel (``{"kernels": [...]}``),
the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
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
KERNEL_RTOL = KERNEL_ATOL = 1e-5  # same per-term rounding; K-sum order differs
NEAR_TIE = 1e-3


def smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def log(msg):
    print(msg, flush=True)


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


def device_ms(fn, n):
    """Device time of one call of ``fn``: the summed duration of its
    device kernels and copies, over ``n`` calls after a warm-up.  Unlike
    CUDA events around a loop of calls, it does not count the host's
    launch gaps, which dominate a small launch."""
    fn()
    _, spans = device_trace(lambda: [fn() for _ in range(n)])
    assert spans, "torch.profiler recorded no device events"
    return sum(e - s for s, e, _ in spans) / n / 1e3


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


def profile_asks(it, n):
    """Run ``n`` asks (and evaluations) of an FMinIter under
    ``torch.profiler``: the profiled host wall per ask, the device's busy
    time per ask (union of kernel and copy intervals), its launches per
    ask, and the kernels taking the most device time."""
    wall_us, spans = device_trace(lambda: it.run(n))
    assert spans, "torch.profiler recorded no device events"
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

    # -- 1. the card; build the kernel ------------------------------------
    card = smi("name,power.limit")
    log(f"[1] card: {card}")
    props = torch.cuda.get_device_properties(0)
    max_clock_mhz = float(smi("clocks.max.sm").split()[0])
    sfu_per_s = props.multi_processor_count * SFU_PER_SM_PER_CLOCK * max_clock_mhz * 1e6
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{props.multi_processor_count} SMs, max SM clock {max_clock_mhz} MHz")
    t0 = time.perf_counter()
    G.KERNEL.fn()
    log(f"[1] {G.KERNEL.source} built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc: {G.KERNEL.build_seconds} s; None = already built)")
    if G.KERNEL.build_log:
        log("[1] ptxas: " + " | ".join(
            ln.strip() for ln in G.KERNEL.build_log.splitlines() if "ptxas" in ln))

    # -- 2. kernel against its plain version -----------------------------
    results = {}
    for name, shape in (("fmin", FMIN_SHAPE), ("main", MAIN_SHAPE), ("stage", STAGE_SHAPE)):
        x, ls, pb, pa = scoring_inputs(shape, seed=7, device=dev)
        got = G.gmm_llr(x, ls, pb, pa)
        torch.cuda.synchronize()
        want = plain_chunked(G, x, ls, pb, pa)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), "kernel output not finite"
        err = (got - want).abs()
        max_abs = float(err.max())
        max_rel = float((err / want.abs().clamp_min(1e-6)).max())
        argmax_agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        ok = torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        run_kernel = lambda: G.gmm_llr(x, ls, pb, pa)
        run_plain = lambda: plain_chunked(G, x, ls, pb, pa)
        big = shape["B"] > 256
        ms = device_ms(run_kernel, 20)
        call_ms = cuda_ms(run_kernel)
        plain_ms = device_ms(run_plain, 2 if big else 10)
        plain_call_ms = cuda_ms(run_plain, warmup=1, reps=3, iters=1 if big else 5)
        b = bound(shape, sfu_per_s)
        results[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, **b)
        log(f"[2] {name} {shape}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
            f"argmax agreement {argmax_agree:.6f}; device time: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms; per call by CUDA events: kernel {call_ms:.4f} ms, "
            f"plain {plain_call_ms:.4f} ms; "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} (bytes {b['bytes_ms']:.4f}, "
            f"fp32 {b['fp32_ms']:.4f}, sfu {b['sfu_ms']:.4f} ms; {b['terms']} terms); "
            f"kernel at {b['bound_ms'] / ms:.3f} of the bound")
        assert ok, f"kernel disagrees with the plain version at {shape}: {max_abs}"
        assert argmax_agree >= 0.999, argmax_agree
        del x, ls, pb, pa, got, want
        torch.cuda.empty_cache()

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

    # -- 4. the main path: sequential 1000-trial fmin ---------------------
    n_trials, n_startup = 1000, 20
    fmin_trials = H.Trials()
    G.KERNEL.launches = 0
    t0 = time.perf_counter()
    H.fmin(mixed_space_fn, mixed_space(), algo=H.tpe.suggest, max_evals=n_trials,
           trials=fmin_trials, rstate=np.random.default_rng(0), device="cuda")
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
                  fmin_trials, rstate=np.random.default_rng(1))
    it.run(3)  # warm-up: compile the space, sync the buffer
    in_suggest.clear()
    t0 = time.perf_counter()
    it.run(20)
    torch.cuda.synchronize()
    ask_ms = (time.perf_counter() - t0) / 20 * 1e3
    suggest_ms = sum(in_suggest) / 20 * 1e3
    prof = profile_asks(it, 20)
    log(f"[4] 20 asks at {len(fmin_trials.trials) - 40} obs: {ask_ms:.3f} ms per ask "
        f"and evaluation, {suggest_ms:.3f} ms of it in tpe.suggest; "
        f"20 more under torch.profiler: {prof['wall_ms']:.3f} ms per ask, "
        f"device busy {prof['busy_ms']:.3f} ms per ask (idle share "
        f"{1.0 - prof['busy_ms'] / ask_ms:.4f} of the unprofiled ask), "
        f"{prof['kernels_per_ask']:.1f} device kernels per ask, "
        f"gmm_llr_kernel {prof['llr_ms']:.4f} ms per ask; top device time per ask: "
        + ", ".join(f"{n} {ms:.4f} ms" for n, ms in prof["top"]))
    ops = count_ops(lambda: it.run(5))
    log(f"[4] PyTorch operations per ask: {sum(ops.values()) / 5:.1f}; by module: "
        + ", ".join(f"{m} {c / 5:.1f}" for m, c in ops.most_common()))

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
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    main = results["fmin"]  # the shape of the main path's asks
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
