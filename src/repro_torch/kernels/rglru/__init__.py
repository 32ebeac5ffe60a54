"""RG-LRU linear scan: plain version (``ref``), CUDA kernel, dispatch."""
