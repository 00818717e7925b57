"""Small shared helpers of the PyTorch port."""

from __future__ import annotations

import datetime

import torch

__all__ = ["coarse_utcnow", "resolve_device"]


def coarse_utcnow():
    """UTC now, truncated to milliseconds (stable across (de)serialization)."""
    now = datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)
    return now.replace(microsecond=(now.microsecond // 1000) * 1000)


def resolve_device(device=None):
    """The device every entry point of the port computes on.

    ``None`` means the card (``cuda``).  Asking for CUDA where there is
    none raises: the port never falls back to the CPU on its own -- the
    caller opts in with ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hyperopt_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU"
        )
    return dev
