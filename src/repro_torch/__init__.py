"""PyTorch/CUDA port of the ``repro`` serving stack, for NVIDIA Hopper.

The package mirrors ``src/repro/`` file for file (``repro_torch/models/
transformer.py`` is the counterpart of ``repro/models/transformer.py``) and
imports nothing of it: the JAX package stays the reference the port is
tested against. Entry points run on CUDA unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`); the paged-attention op
launches a hand-written CUDA kernel on CUDA tensors and uses its plain
PyTorch version only for tensors on the CPU.
"""
