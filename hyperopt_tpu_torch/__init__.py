"""hyperopt_tpu_torch: the PyTorch/CUDA port of hyperopt_tpu.

A second package beside the JAX reference (:mod:`hyperopt_tpu`), held
against it by tests that run both on the same inputs.  It imports
``torch`` and numpy, never ``jax`` and nothing of ``hyperopt_tpu``.  Its
entry points compute on the card unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.

This slice ports the sequential TPE driver: ``fmin(fn, space,
algo=tpe.suggest)`` with the EI scoring of continuous candidates in a
hand-written Hopper kernel (:mod:`hyperopt_tpu_torch.ops.gmm_scores`).
"""

import torch

# the reference pins exact float32 contractions; TF32 would round every
# float32 matrix product on the card to ~3 decimal digits
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import hp, tpe  # noqa: E402
from .base import STATUS_OK, Domain, Trials  # noqa: E402
from .fmin import fmin  # noqa: E402

__all__ = ["Domain", "STATUS_OK", "Trials", "fmin", "hp", "tpe"]
