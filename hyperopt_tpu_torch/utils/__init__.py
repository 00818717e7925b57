"""Small shared helpers of the PyTorch port."""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

__all__ = [
    "capture_graph", "coarse_utcnow", "host_copy", "resolve_device", "tree_leaves", "tree_map",
    "working_dir",
]


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


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a pytree of dicts, lists and tuples
    (named tuples keep their type), with ``rest`` trees of the same
    structure passed leaf by leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a pytree, in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def host_copy(x):
    """A tensor as host numpy in new memory (on the CPU ``.numpy()`` alone
    would alias the tensor, which the next run writes again); any other
    leaf through ``np.asarray``."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def capture_graph(step, device):
    """Run ``step()`` once on a side stream (lazy builds, cuBLAS handles,
    the caching allocator's pools, cached constants), then capture a
    second call into a ``torch.cuda.CUDAGraph`` and return it.  The
    warm-up writes whatever static tensors ``step`` writes; callers fill
    them again before the first replay."""
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # thread_local: another thread's work on the card (a serve loop)
    # does not void this capture
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        step()
    return graph


class working_dir:
    """Context manager: chdir into ``path`` (creating it), restore on exit."""

    def __init__(self, path):
        self.path = path

    def __enter__(self):
        os.makedirs(self.path, exist_ok=True)
        self._prev = os.getcwd()
        os.chdir(self.path)
        return self.path

    def __exit__(self, *exc):
        os.chdir(self._prev)
        return False
