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
``SparkTrials`` and ASHA over the queues), the suggestion on the card;
and the population models (:mod:`hyperopt_tpu_torch.models`: ``TinyLM``
and ResNet-20 trained as populations under ``compile_fmin``, PBT, SHA and
ASHA); and the host algorithms (``tpe_host`` with its C++ helper
:mod:`hyperopt_tpu_torch.native`, ``anneal_host``, ``atpe_host``,
``rand_host`` and ``mix``), ``criteria``, ``plotting``, ``graphviz``, the
domain battery and the surrogate and NAS-Bench-201 benchmarks
(:mod:`hyperopt_tpu_torch.models`).  The submodules that ``import hyperopt_tpu_torch`` does not load
load at first attribute access, as the reference's do.  The EI scoring
of continuous candidates runs in a hand-written Hopper kernel
(:mod:`hyperopt_tpu_torch.ops.gmm_scores`).
"""

import torch

# the reference pins exact float32 contractions; TF32 would round every
# float32 matrix product on the card to ~3 decimal digits
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import anneal, atpe, client, early_stop, exceptions, hp, mix, progress, rand, tpe  # noqa: E402
from .base import (  # noqa: E402
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    JOB_STATES,
    STATUS_FAIL,
    STATUS_NEW,
    STATUS_OK,
    STATUS_RUNNING,
    STATUS_STRINGS,
    STATUS_SUSPENDED,
    Ctrl,
    Domain,
    Trials,
    trials_from_docs,
)
from .early_stop import no_progress_loss  # noqa: E402
from .exceptions import (  # noqa: E402
    AllTrialsFailed,
    CheckpointError,
    DuplicateLabel,
    HyperoptTpuError,
    InvalidLoss,
    InvalidResultStatus,
    InvalidTrial,
    TrialTimeout,
)
from .fmin import (  # noqa: E402
    FMinIter,
    fmin,
    fmin_pass_expr_memo_ctrl,
    generate_trials_to_calculate,
    partial,
    space_eval,
)
from .torch_trials import TorchTrials  # noqa: E402

__version__ = "0.1.0"

# the reference's public names, less its ``*_jax`` modules: the port's
# ``tpe``, ``anneal``, ``atpe`` and ``rand`` are those algorithms, and its
# numpy ones are ``tpe_host``, ``anneal_host``, ``atpe_host`` and
# ``rand_host`` (lazy, below)
__all__ = ["AllTrialsFailed", "Ctrl", "Domain", "DuplicateLabel", "FMinIter",
           "HyperoptTpuError", "InvalidLoss", "InvalidResultStatus", "InvalidTrial",
           "JOB_STATES", "JOB_STATE_DONE", "JOB_STATE_ERROR", "JOB_STATE_NEW",
           "JOB_STATE_RUNNING", "STATUS_FAIL", "STATUS_NEW", "STATUS_OK", "STATUS_RUNNING",
           "STATUS_STRINGS", "STATUS_SUSPENDED", "Trials", "__version__", "anneal", "base",
           "device_loop", "early_stop", "exceptions", "fmin", "fmin_pass_expr_memo_ctrl",
           "generate_trials_to_calculate", "hp", "hyperband", "mix", "no_progress_loss", "partial",
           "pbt", "pyll", "rand", "space_eval", "tpe", "trials_from_docs"]

# modules loaded at first use, so that ``import hyperopt_tpu_torch`` stays
# cheap: the reference's lazy names that the port has, and its own
_LAZY = frozenset({
    "anneal_host", "atpe_host", "convert", "criteria", "device_loop", "distributed", "graphviz",
    "hyperband", "models", "native", "obs", "ops", "parallel", "pbt", "plotting", "pyll_utils",
    "rand_host", "random", "serve", "torch_trials", "tpe_host", "utils", "vectorize",
})


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
