"""Plain PyTorch version of the RG-LRU linear scan.

The CPU path of :mod:`repro_torch.kernels.rglru.ops`, and what the CUDA
kernels are held to on the card:

- :func:`rglru`: ``linear_scan_ref`` (``src/repro/models/griffin.py:57``),
  the sequential scan ``h_t = a_t * h_{t-1} + b_t`` over the time axis of
  ``(B, S, W)`` inputs, one step at a time;
- :func:`rglru_bwd`: its gradient, the same scan run backwards in time
  (the reference has no such function: it differentiates
  ``linear_scan_blocked``, ``griffin.py:87``, with ``jax.grad``).
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


def rglru_bwd(a: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
              dh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(da, db)``, the gradients of :func:`rglru` (h starting at 0) for
    the output gradients ``dy`` (B, S, W) and ``dh`` (B, W) of ``y`` and
    ``h_final``: ``g_t = dy_t + a_{t+1} g_{t+1}`` walking back from
    ``g_{S-1} = dy_{S-1} + dh``, then ``db_t = g_t`` and ``da_t = g_t
    y_{t-1}`` with ``y_{-1} = 0``. Each step is a multiply, rounded, then
    an add, rounded, as in the kernel. Computes in float32, or in float64
    when ``a`` is float64."""
    dt = torch.float64 if a.dtype == torch.float64 else torch.float32
    a, y, dy = a.to(dt), y.to(dt), dy.to(dt)
    da, db = torch.empty_like(a), torch.empty_like(a)
    g = dh.to(dt)
    s = a.shape[1]
    for t in range(s - 1, -1, -1):
        g = dy[:, t] + (g if t == s - 1 else a[:, t + 1] * g)
        db[:, t] = g
        da[:, t] = g * y[:, t - 1] if t else 0.0
    return da, db
