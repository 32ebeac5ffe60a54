"""Plain PyTorch version of the depthwise causal conv1d kernel.

Port of ``src/repro/kernels/conv1d/ref.py``: the oracle is the model
layer :func:`repro_torch.models.layers.causal_conv1d`, y only. It runs on
any device; the tests and ``chip_smoke.py`` hold the CUDA kernel to it.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers


def conv1d(x: torch.Tensor, w: torch.Tensor,
           state: torch.Tensor | None = None) -> torch.Tensor:
    """x (B,S,D), w (W,D). Returns y only (oracle for the kernel)."""
    y, _ = layers.causal_conv1d(x, w, state)
    return y
