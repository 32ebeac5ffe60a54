"""Depthwise causal conv1d (the CGRA stand-in): plain version (``ref``),
CUDA kernel, dispatch."""
