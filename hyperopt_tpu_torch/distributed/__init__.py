"""The fault seams of the PyTorch port's serve stack (a subset of
:mod:`hyperopt_tpu.distributed`): the filesystem seam with seeded file
faults and crash points (:mod:`.faults`), and seeded network faults
(:mod:`.netfaults`)."""

from .faults import REAL_FS, FaultPlan

__all__ = ["FaultPlan", "REAL_FS"]
