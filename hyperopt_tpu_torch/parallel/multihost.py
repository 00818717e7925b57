"""Multi-process coordination over ``torch.distributed``.

The counterpart of :mod:`hyperopt_tpu.parallel.multihost`: every process
of a run joins one default process group, one rank per process and one
device per rank; the sharded suggest step spans the ranks (its one
collective a gather of the per-rank bests), and suggested configs are
replicated from rank 0 with a broadcast, so each process evaluates its
share of trials.

A single process degenerates gracefully: ``initialize()`` is a no-op,
``broadcast_configs`` is the identity, ``process_index() == 0``.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "initialize",
    "is_multihost",
    "process_index",
    "process_count",
    "broadcast_configs",
    "fetch_global",
    "shard_ids_for_host",
]


def _backend(num_processes):
    """``nccl`` when every rank has a card of its own, else ``gloo`` (the
    CPU, or several ranks sharing one card, which NCCL refuses)."""
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= int(num_processes):
        return "nccl"
    return "gloo"


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Join the default process group (a no-op returning False with one
    process, or when a group is already initialized).

    ``coordinator_address`` is ``host:port`` (TCP rendezvous, rank 0
    listening) or ``file://<path>`` (a ``FileStore`` on a path every rank
    sees).  The backend is :func:`_backend`'s choice; under ``nccl`` each
    rank takes the card of its own index.
    """
    if num_processes is None or num_processes <= 1:
        return False
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        logger.warning("torch.distributed is already initialized; initialize() did nothing")
        return False
    backend = _backend(num_processes)
    rank, world = int(process_id), int(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    address = str(coordinator_address)
    if address.startswith("file://"):
        store = dist.FileStore(address[len("file://"):], world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    else:
        init = address if "://" in address else f"tcp://{address}"
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
    return True


def _initialized():
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def is_multihost():
    return process_count() > 1


def process_index():
    import torch.distributed as dist

    return dist.get_rank() if _initialized() else 0


def process_count():
    import torch.distributed as dist

    return dist.get_world_size() if _initialized() else 1


def _broadcast(x):
    """``x`` (numpy or a tensor) as rank 0 holds it, in ``x``'s own kind
    and device; every rank passes the same shape and dtype."""
    import torch
    import torch.distributed as dist

    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    wire = torch.device("cuda") if dist.get_backend() == "nccl" else torch.device("cpu")
    buf = (t.to(torch.uint8) if t.dtype == torch.bool else t).to(wire).contiguous()
    dist.broadcast(buf, src=0)
    buf = buf.to(torch.bool) if t.dtype == torch.bool else buf
    if isinstance(x, torch.Tensor):
        return buf.to(x.device)
    return buf.cpu().numpy()


def broadcast_configs(values, active):
    """Replicate a suggested dense batch from rank 0 to every rank, so
    every process materializes identical trial docs without a host-side
    queue (the Mongo role for config distribution)."""
    if process_count() == 1:
        return values, active
    return _broadcast(values), _broadcast(active)


def fetch_global(tree):
    """Host-fetch a nested structure of tensors: every tensor leaf as
    numpy, other leaves through ``np.asarray`` (None stays None).

    In the port every tensor lives on its own process's device, so the
    fetch is local.  Leaves sharded across processes, which the
    reference assembles with ``process_allgather``, come with the
    populations sharded across processes (ROADMAP item 15c).
    """
    import torch

    from ..utils import tree_map

    def fetch(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    return tree_map(fetch, tree)


def shard_ids_for_host(new_ids, index=None, count=None):
    """Round-robin split of a trial-id batch across hosts: each host
    evaluates ``new_ids[process_index::process_count]`` (trial-level
    farming across slices for expensive objectives)."""
    if index is None:
        index = process_index()
    if count is None:
        count = process_count()
    return list(new_ids)[index::count]
