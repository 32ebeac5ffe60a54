"""Paged decode attention: plain version (``ref``), CUDA kernel, dispatch."""
