"""The fault seams and the recovery audit of the PyTorch port's serve
stack (a subset of :mod:`hyperopt_tpu.distributed`): the filesystem seam
with seeded file faults and crash points (:mod:`.faults`), seeded network
faults (:mod:`.netfaults`), and ``hyperopt-tpu-torch-fsck``
(:mod:`.fsck`)."""

from .faults import REAL_FS, FaultPlan

__all__ = ["FaultPlan", "REAL_FS"]
