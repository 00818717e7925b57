"""Small shared helpers of the PyTorch port."""

from __future__ import annotations

import datetime
import os
import tempfile

import numpy as np
import torch

__all__ = [
    "capture_graph", "coarse_utcnow", "fast_isin", "get_closest_dir", "get_most_recent_inds",
    "host_copy", "path_split_all", "resolve_device", "temp_dir", "tree_leaves", "tree_map",
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


def fast_isin(X, Y):
    """Boolean mask: which elements of X are in (sorted or unsorted) Y."""
    X = np.asarray(X)
    Y = np.asarray(Y)
    if Y.size == 0:
        return np.zeros(len(X), dtype=bool)
    return np.isin(X, Y)


def get_most_recent_inds(obj):
    """Indices of docs that are the latest version per ``_id``.

    ``obj`` is a list of dicts with ``_id`` and ``version`` keys.
    """
    ids = np.array([o["_id"] for o in obj])
    versions = np.array([o.get("version", 0) for o in obj])
    order = np.lexsort((versions, ids))
    ids_sorted = ids[order]
    last_of_id = np.ones(len(ids), dtype=bool)
    last_of_id[:-1] = ids_sorted[1:] != ids_sorted[:-1]
    return np.sort(order[last_of_id])


class temp_dir:
    """Context manager: mkdir (tempfile if needed), yield path, keep dir."""

    def __init__(self, suffix=""):
        self.suffix = suffix

    def __enter__(self):
        self.path = tempfile.mkdtemp(suffix=self.suffix)
        return self.path

    def __exit__(self, *exc):
        return False


def path_split_all(path):
    """Split a path into all of its components."""
    parts = []
    while True:
        path, tail = os.path.split(path)
        if tail:
            parts.append(tail)
        else:
            if path:
                parts.append(path)
            break
    return list(reversed(parts))


def get_closest_dir(workdir):
    """Deepest existing ancestor of ``workdir`` plus the first missing part."""
    closest_dir = ""
    for part in path_split_all(workdir):
        candidate = os.path.join(closest_dir, part) if closest_dir else part
        if os.path.isdir(candidate):
            closest_dir = candidate
        else:
            return closest_dir, part
    return closest_dir, ""
