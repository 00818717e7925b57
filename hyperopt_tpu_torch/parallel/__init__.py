"""Rank-sharded parallelism for suggest steps, over ``torch.distributed``.

The counterpart of :mod:`hyperopt_tpu.parallel`: candidate batches shard
across the ranks of a :class:`~.mesh.RankMesh` (one process and one
device per rank); the EI argmax reduces over one all-gather of the
per-rank winners; multi-process runs join one default process group
(:mod:`hyperopt_tpu_torch.parallel.multihost`).  Trial-level task
farming (the MongoDB role) lives in :mod:`hyperopt_tpu_torch.distributed`.
"""

from . import multihost
from .mesh import CAND_AXIS, TRIAL_AXIS, default_mesh, device_count, mesh_from_spec
from .sharded import build_sharded_suggest_fn, sharded_suggest, suggest

__all__ = [
    "CAND_AXIS",
    "TRIAL_AXIS",
    "default_mesh",
    "device_count",
    "mesh_from_spec",
    "build_sharded_suggest_fn",
    "sharded_suggest",
    "suggest",
    "multihost",
]
