"""Tensor programs of the PyTorch port: the space compiler, the TPE math
and the hand-written CUDA kernels."""
