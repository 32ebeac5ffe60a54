"""MoE grouped (per-expert) matmul: plain version (``ref``), CUDA kernel,
dispatch and the expert FFN (``ops``)."""
