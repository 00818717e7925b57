"""Benchmark spaces of the PyTorch port."""
