"""The fault seam of the PyTorch port's serve stack (a subset of
:mod:`hyperopt_tpu.distributed`: what the scheduler and its guard reach)."""
