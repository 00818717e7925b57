"""hyperopt_tpu_torch: the PyTorch/CUDA port of hyperopt_tpu.

A second package beside the JAX reference (:mod:`hyperopt_tpu`), held
against it by tests that run both on the same inputs.  It imports
``torch`` and numpy, never ``jax`` and nothing of ``hyperopt_tpu``.  Its
entry points compute on the card unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.

Ported: the sequential driver ``fmin`` with its stopping rules and its
ask-ahead seam, and the device algorithms at its plugin seam --
``tpe.suggest`` (every mode: joint EI, speculative draws, the resident
history with O(D) delta tells, fused tell+ask with ask-ahead),
``rand.suggest``, ``anneal.suggest`` and ``atpe.suggest``; and the
study-batched suggestion service (:mod:`hyperopt_tpu_torch.serve`), where
one round serves every open study; the compiled loop
(:mod:`hyperopt_tpu_torch.device_loop`, with its fused ASHA brackets) and
the multi-fidelity schedulers (:mod:`hyperopt_tpu_torch.hyperband`,
:mod:`hyperopt_tpu_torch.pbt`); and durable ``fmin``: the write-ahead log
and crash-exact resume (``trials_save_file``/``resume_from``),
``trial_timeout``/``catch``, the progress bar, the flight recorder
(:mod:`hyperopt_tpu_torch.obs`) and the engine client
(``fmin(engine=True, ask_ahead=k)``, :mod:`hyperopt_tpu_torch.client`);
and asynchronous trial farming (:mod:`hyperopt_tpu_torch.distributed`:
``ThreadTrials``, ``FileTrials`` with its worker processes, ``MongoTrials``,
``SparkTrials`` and ASHA over the queues), the suggestion on the card.
The EI scoring of continuous candidates runs in a hand-written Hopper
kernel (:mod:`hyperopt_tpu_torch.ops.gmm_scores`).
"""

import torch

# the reference pins exact float32 contractions; TF32 would round every
# float32 matrix product on the card to ~3 decimal digits
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import anneal, atpe, client, early_stop, exceptions, hp, progress, rand, tpe  # noqa: E402
from .base import (  # noqa: E402
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    STATUS_FAIL,
    STATUS_NEW,
    STATUS_OK,
    Ctrl,
    Domain,
    Trials,
    trials_from_docs,
)
from .early_stop import no_progress_loss  # noqa: E402
from .exceptions import AllTrialsFailed, CheckpointError, TrialTimeout  # noqa: E402
from .fmin import FMinIter, fmin, generate_trials_to_calculate, partial, space_eval  # noqa: E402
from .torch_trials import TorchTrials  # noqa: E402

__all__ = ["AllTrialsFailed", "CheckpointError", "Ctrl", "Domain", "FMinIter", "JOB_STATE_DONE",
           "JOB_STATE_ERROR", "JOB_STATE_NEW", "JOB_STATE_RUNNING", "STATUS_FAIL", "STATUS_NEW",
           "STATUS_OK", "TorchTrials", "TrialTimeout", "Trials", "anneal", "atpe", "client",
           "early_stop", "exceptions", "fmin", "generate_trials_to_calculate", "hp",
           "no_progress_loss", "partial", "progress", "rand", "space_eval", "tpe",
           "trials_from_docs"]
