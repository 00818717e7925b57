"""Rank meshes: how the processes of a ``torch.distributed`` run are arranged.

The counterpart of :mod:`hyperopt_tpu.parallel.mesh`.  In the port one
rank is one process with one device, so a mesh is an arrangement of
global ranks, not of devices: :class:`RankMesh` holds the axis names,
the shape and the ranks in row-major order, and builds the process
group of a proper sub-mesh of the world when a collective first needs
it.  A rank's position on the ``cand`` axis plays the part of the
reference's ``lax.axis_index``.  Axis conventions are the reference's:

  ``cand``  -- candidate-batch sharding (the throughput axis)
  ``trial`` -- trial-batch sharding for population evaluation
  ``study`` -- study-slot sharding for the serve engine

:func:`virtual_mesh` arranges ranks inside one process, on one axis or
several (``virtual_mesh((2, 4), ("trial", "cand"))``): every collective
over it is computed here, each rank's share in turn (tests and the
card's checks hold the real ranks against it).

The study axis of the serve engine and the trial axis of ``compile_pbt``
and ``compile_sha`` need no collective inside a step, so there a shard
is a block of slots or members owned by this one process; the ``cand``
axis of ``compile_fmin`` runs each virtual rank's sweep in turn inside
the one captured step, and its ``trial`` axis is checked and placed
only.  :func:`in_process_shards` gives a named axis's width inside this
process, and :func:`shard_devices` places the shards.

Over real ranks, one process each, the ``trial`` axis of
``compile_pbt``, ``compile_sha`` and ``compile_fmin`` gives rank ``r``
member block ``r`` (:func:`process_block`): each rank runs its block's
captured graph, and the blocks meet in a host gather between graphs
(:func:`~.multihost.fetch_global`), never inside one.

The reference's virtual-device harness has no twin here:
``force_host_cpu_devices``, ``subprocess_env_with_devices``,
``registry_cpu_mesh`` and ``REGISTRY_MESH_DEVICES`` force XLA's host
platform to show several CPU devices.  The port's multi-rank harness is
:func:`hyperopt_tpu_torch.parallel.dcn_check.launch`, which spawns real
ranks, one process each.
"""

from __future__ import annotations

import math

import numpy as np

from .multihost import process_count, process_index

__all__ = [
    "CAND_AXIS",
    "STUDY_AXIS",
    "TRIAL_AXIS",
    "RankMesh",
    "default_mesh",
    "device_count",
    "in_process_shards",
    "mesh_from_spec",
    "over_processes",
    "process_block",
    "rung_submesh",
    "shard_devices",
    "study_mesh",
    "virtual_mesh",
]

CAND_AXIS = "cand"
TRIAL_AXIS = "trial"
STUDY_AXIS = "study"


class RankMesh:
    """An N-D arrangement of global ranks.

    ``shape`` maps each axis name to its width (the reference's
    ``Mesh.shape``), ``ranks`` lists the mesh's global ranks in row-major
    order and ``devices`` shows them in the mesh's shape.  A ``virtual``
    mesh holds ``n`` ranks inside one process (:func:`virtual_mesh`).
    """

    def __init__(self, shape, axis_names, ranks, virtual=False):
        self.axis_names = tuple(axis_names)
        self._dims = tuple(int(s) for s in shape)
        if len(self._dims) != len(self.axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
        self.ranks = tuple(int(r) for r in ranks)
        if len(self.ranks) != self.size:
            raise ValueError(f"mesh shape {shape} needs {self.size} ranks, got {len(ranks)}")
        self.virtual = bool(virtual)
        self._groups = {}

    @property
    def shape(self):
        return dict(zip(self.axis_names, self._dims))

    @property
    def size(self):
        return math.prod(self._dims)

    @property
    def devices(self):
        return np.asarray(self.ranks).reshape(self._dims)

    def __repr__(self):
        kind = "virtual " if self.virtual else ""
        return f"RankMesh({kind}{self.shape}, ranks={list(self.ranks)})"

    def coords(self, rank):
        """The mesh coordinates of global ``rank``, one per axis."""
        if rank not in self.ranks:
            raise ValueError(f"rank {rank} is not on {self!r}")
        return np.unravel_index(self.ranks.index(rank), self._dims)

    def axis_index(self, axis, rank):
        """``rank``'s position on ``axis`` (``lax.axis_index``'s twin)."""
        return int(self.coords(rank)[self.axis_names.index(axis)])

    def axis_ranks(self, axis, rank):
        """The global ranks of the line along ``axis`` through ``rank``,
        in axis order: the members of a collective over ``axis``."""
        at = list(self.coords(rank))
        a = self.axis_names.index(axis)
        line = []
        for i in range(self._dims[a]):
            at[a] = i
            line.append(self.ranks[int(np.ravel_multi_index(tuple(at), self._dims))])
        return tuple(line)

    def group(self, axis, rank):
        """The process group of the line along ``axis`` through ``rank``:
        None for the whole world (the default group), else a group built
        at first use by the line's members alone."""
        line = self.axis_ranks(axis, rank)
        if line == tuple(range(process_count())):
            return None
        if line not in self._groups:
            import torch.distributed as dist

            self._groups[line] = dist.new_group(list(line), use_local_synchronization=True)
        return self._groups[line]


def device_count():
    """Ranks in the run: the default group's world size, or 1 without
    one (one process, one device)."""
    return process_count()


def default_mesh(axis_name=CAND_AXIS, ranks=None):
    """1-D mesh over every (or the given) rank -- the workhorse for
    candidate sharding."""
    if ranks is None:
        ranks = range(device_count())
    ranks = list(ranks)
    return RankMesh((len(ranks),), (axis_name,), ranks)


def mesh_from_spec(shape, axis_names, ranks=None):
    """N-D mesh over the first ranks, e.g. ``mesh_from_spec((2, 4),
    ('trial', 'cand'))`` to split a run between trial-batch and
    candidate-batch parallelism."""
    if ranks is None:
        ranks = range(device_count())
    ranks = list(ranks)
    n = math.prod(int(s) for s in shape)
    if n > len(ranks):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(ranks)}")
    return RankMesh(shape, axis_names, ranks[:n])


def study_mesh(n_devices=None, ranks=None, axis=STUDY_AXIS):
    """1-D ``study`` mesh over the first ``n_devices`` ranks (None: every
    rank) -- the serve engine's slot-axis mesh."""
    if ranks is None:
        ranks = range(device_count())
    ranks = list(ranks)
    if n_devices is not None:
        n = int(n_devices)
        if n > len(ranks):
            raise ValueError(f"study_mesh needs {n} devices, have {len(ranks)}")
        ranks = ranks[:n]
    return RankMesh((len(ranks),), (axis,), ranks)


def rung_submesh(mesh, axis, members):
    """The gcd-sized per-rung sub-mesh of the SHA/ASHA seam: a rung
    shards over the first ``gcd(members, mesh.shape[axis])`` ranks, so a
    late tiny rung shrinks its sub-mesh instead of breaking divisibility,
    and a one-rank sub-mesh is the unsharded program.  Returns
    ``(sub_mesh, n_ranks)``."""
    k = math.gcd(int(members), int(mesh.shape[axis]))
    return RankMesh((k,), (axis,), mesh.ranks[:k], virtual=mesh.virtual), k


def in_process_shards(mesh, axis, what, device=None, one_axis=True):
    """The number of shards ``mesh`` lays along ``axis`` inside this
    process: the axis's width on a virtual mesh, or 1 on a mesh of one
    rank.  A 1-D mesh is required unless ``one_axis=False`` (the other
    axes then replicate; ``compile_fmin``'s ``trial`` x ``cand`` mesh).
    A mesh over several processes is refused here: its shards would meet
    in a collective inside a captured step (the callers that take one
    ask :func:`process_block` first; the rest is ROADMAP.md Queue A, item
    15c, part 6).  With ``device``, the shards must all land on it
    (:func:`shard_devices`)."""
    if axis not in mesh.shape:
        raise ValueError(f"{what}: mesh {mesh!r} has no {axis!r} axis")
    if one_axis and len(mesh.shape) != 1:
        raise NotImplementedError(
            f"{what}: a mesh of more than one axis ({mesh!r}) is not ported yet "
            "(ROADMAP.md Queue A, item 15c, part 6)"
        )
    if over_processes(mesh):
        raise NotImplementedError(
            f"{what}: the {axis!r} axis over {mesh.size} processes is not ported yet; "
            "shard inside one process with virtual_mesh (ROADMAP.md Queue A, item 15c, part 6)"
        )
    n = int(mesh.shape[axis])
    if device is not None:
        shard_devices(n, device, what)
    return n


def over_processes(mesh):
    """Whether ``mesh`` spans several processes: real ranks, not a
    :func:`virtual_mesh`."""
    return mesh is not None and not mesh.virtual and mesh.size > 1


def process_block(mesh, axis, what):
    """The member block of this process on a 1-D ``axis`` mesh of real
    ranks: ``(n, index, group)``, the axis's width, this rank's position
    on it (rank ``r`` owns block ``r``) and the process group its blocks
    meet in (None: every process).  The run must have joined a process
    group holding the mesh's ranks (:func:`~.multihost.initialize`)."""
    if axis not in mesh.shape:
        raise ValueError(f"{what}: mesh {mesh!r} has no {axis!r} axis")
    if len(mesh.shape) != 1:
        raise NotImplementedError(
            f"{what}: a mesh of more than one axis over processes ({mesh!r}) is not ported "
            "yet (ROADMAP.md Queue A, item 15c, part 6)"
        )
    if process_count() < mesh.size or process_index() not in mesh.ranks:
        raise RuntimeError(
            f"{what}: {mesh!r} spans {mesh.size} processes, but this process (rank "
            f"{process_index()} of {process_count()}) is not one of its ranks: join a process "
            "group with parallel.multihost.initialize, or shard inside this process with "
            "parallel.mesh.virtual_mesh")
    rank = process_index()
    return int(mesh.shape[axis]), mesh.axis_index(axis, rank), mesh.group(axis, rank)


def shard_devices(n, device, what="sharding"):
    """Where the ``n`` in-process shards of a caller on ``device`` live:
    every shard on ``device``.  When ``device`` is a card and this process
    sees at least ``n`` cards, the placement is shard ``k`` on ``cuda:k``;
    shards on several cards have no check yet and are refused (ROADMAP.md
    Queue A, item 15c, part 6)."""
    import torch

    device = torch.device(device)
    n = int(n)
    if device.type == "cuda" and n > 1 and torch.cuda.device_count() >= n:
        raise NotImplementedError(
            f"{what}: {n} shards on {n} cards (shard k on cuda:k) are not ported yet; "
            "show this process fewer cards than shards (ROADMAP.md Queue A, item 15c, part 6)"
        )
    return [device] * n


def virtual_mesh(n, axis_name=CAND_AXIS):
    """A mesh of ranks inside this one process: ``n`` ranks on the one
    axis ``axis_name``, or, with a shape and one name per axis
    (``virtual_mesh((2, 4), ("trial", "cand"))``), an N-D mesh.  A
    collective over it computes every rank's share here, in rank order,
    and gathers them as the real ranks' collective would."""
    if isinstance(n, (tuple, list)):
        shape = tuple(int(s) for s in n)
        names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        return RankMesh(shape, names, range(math.prod(shape)), virtual=True)
    return RankMesh((int(n),), (axis_name,), range(int(n)), virtual=True)
