"""Plain PyTorch version of the RG-LRU linear scan.

The CPU path of :mod:`repro_torch.kernels.rglru.ops`, and what the CUDA
kernel is held to on the card: ``linear_scan_ref``
(``src/repro/models/griffin.py:57``), the sequential scan
``h_t = a_t * h_{t-1} + b_t`` over the time axis of ``(B, S, W)`` inputs,
one step at a time.
"""

from __future__ import annotations

import torch


def rglru(a: torch.Tensor, b: torch.Tensor,
          h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, h_final)``: y ``(B, S, W)`` holds every ``h_t``, h_final
    ``(B, W)`` the last one. Computes in float32, or in float64 when ``a``
    is float64 (the yardstick of the card's float64 check); ``h0``
    ``(B, W)`` is the state before step 0 (zeros when ``None``)."""
    dt = torch.float64 if a.dtype == torch.float64 else torch.float32
    a, b = a.to(dt), b.to(dt)
    h = (torch.zeros((a.shape[0], a.shape[2]), dtype=dt, device=a.device)
         if h0 is None else h0.to(dt))
    y = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        y[:, t] = h
    return y, h
