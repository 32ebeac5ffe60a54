"""Flash attention: plain versions (``ref``), CUDA kernels, autograd dispatch."""
