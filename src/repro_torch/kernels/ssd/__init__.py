"""Mamba-2 SSD chunk scan: plain versions (``ref``), CUDA kernel, dispatch."""
