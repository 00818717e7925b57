"""Multi-process coordination over ``torch.distributed``.

The counterpart of :mod:`hyperopt_tpu.parallel.multihost`: every process
of a run joins one default process group, one rank per process and one
device per rank; the sharded suggest step spans the ranks (its one
collective a gather of the per-rank bests), and suggested configs are
replicated from rank 0 with a broadcast, so each process evaluates its
share of trials; :func:`fetch_global` assembles the member blocks of a
population sharded over the processes (``compile_pbt``, ``compile_sha``
and ``compile_fmin``'s ``trial`` axis over real ranks gather through
it at their boundaries).

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


def _gather_blocks(blocks, group=None):
    """ONE ``all_gather`` over ``group`` (None: every process) of this
    process's member ``blocks`` (tensors or arrays; every rank's of the
    same shapes and dtypes), packed into one byte buffer: each block's
    gathered rows, joined along the leading axis in rank order, as
    numpy."""
    import torch
    import torch.distributed as dist

    ts = [b.detach() if torch.is_tensor(b) else torch.from_numpy(np.ascontiguousarray(b))
          for b in blocks]
    wire = torch.device("cuda") if dist.get_backend(group) == "nccl" else torch.device("cpu")
    parts = [t.to(wire).contiguous().reshape(-1).view(torch.uint8) for t in ts]
    buf = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8, device=wire)
    recv = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(recv, buf, group=group)
    out, at = [], 0
    for t, part in zip(ts, parts):
        n = part.numel()
        rows = [r[at:at + n].clone().view(t.dtype).reshape(t.shape) for r in recv]
        out.append(torch.cat(rows).cpu().numpy())
        at += n
    return out


def fetch_global(tree, sharded=False, group=None):
    """Host-fetch a nested structure of tensors: every tensor leaf as numpy
    in new memory, other leaves through ``np.asarray`` (None stays None).

    The leaves that ``sharded`` marks hold this process's block of a
    population sharded over the processes of ``group`` (None: every
    process), rank ``r`` holding block ``r``.  Across processes they are
    assembled as the reference assembles them with
    ``process_allgather(x, tiled=True)``: one ``all_gather`` of every
    marked leaf, packed into one byte buffer, each leaf's blocks joined
    along the leading axis in rank order, so every rank receives the same
    arrays.  ``sharded`` is True (every leaf), False (none) or a tree of
    bools shaped like ``tree``: a tensor does not record that it is
    sharded, as a ``jax.Array`` does.  Every other leaf, and every leaf
    in a single process, is fetched locally.
    """
    from ..utils import host_copy, tree_map

    def local(x):
        return None if x is None else host_copy(x)

    if sharded is False or process_count() == 1:
        return tree_map(local, tree)
    marks = tree_map(lambda _: bool(sharded), tree) if isinstance(sharded, bool) else sharded
    mine = []
    tree_map(lambda x, m: mine.append(x) if m else None, tree, marks)
    gathered = iter(_gather_blocks(mine, group))
    return tree_map(lambda x, m: next(gathered) if m else local(x), tree, marks)


def shard_ids_for_host(new_ids, index=None, count=None):
    """Round-robin split of a trial-id batch across hosts: each host
    evaluates ``new_ids[process_index::process_count]`` (trial-level
    farming across slices for expensive objectives)."""
    if index is None:
        index = process_index()
    if count is None:
        count = process_count()
    return list(new_ids)[index::count]
