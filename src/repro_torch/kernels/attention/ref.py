"""Plain PyTorch versions of the flash-attention forward and backward.

The CPU path of :mod:`repro_torch.kernels.attention.ops`, and what the CUDA
kernels are held to on the card. Full-score math (every score is formed,
nothing tiled), with the reference's constants: masked scores are
``-1e30`` and the softmax normaliser is clamped to ``1e-30``.

- :func:`flash_attention_ref` computes what the Pallas kernel
  ``flash_attention_hm`` (``src/repro/kernels/attention/kernel.py:69``)
  computes, and also the per-row log-sum-exp that ``_flash_fwd_impl``
  (``src/repro/models/layers.py:116``) keeps for the backward.
- :func:`flash_attention_bwd_ref` is ``_flash_bwd``
  (``src/repro/models/layers.py:170``) without the tiling.

Layout is the reference's: q ``(B, S, H, D)``, k/v ``(B, S, K, D)``, query
head ``h`` reading KV head ``h // (H // K)``; ``lse`` is ``(B, H, S)``.
The arithmetic runs in float32 for float32 and bfloat16 inputs and in
float64 for float64 inputs (for ``torch.autograd.gradcheck``).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def mask(sq: int, sk: int, causal: bool, window: int | None,
         device) -> torch.Tensor:
    """(sq, sk) bool: key ``c`` is visible from query ``r``."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= qpos - kpos < window
    return keep


def _fold(x: torch.Tensor, n_kv: int, dtype) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, K, G, D) in ``dtype``."""
    b, s, h, d = x.shape
    return x.reshape(b, s, n_kv, h // n_kv, d).to(dtype)


def _scores(qf, k, scale, causal, window, dtype):
    s = torch.einsum("bqkgd,bckd->bkgqc", qf, k.to(dtype)) * scale
    keep = mask(qf.shape[1], k.shape[1], causal, window, qf.device)
    return s, keep


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int | None = None):
    """``(o, lse)``: o ``(B, Sq, H, D)`` in ``q.dtype``, lse ``(B, H, Sq)``
    (float32, or float64 for float64 inputs) with
    ``lse = m + log(max(l, 1e-30))`` per query row."""
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    ct = _compute_dtype(q.dtype)
    qf = _fold(q, n_kv, ct)
    s, keep = _scores(qf, k, 1.0 / math.sqrt(d), causal, window, ct)
    s = torch.where(keep, s, torch.tensor(NEG_INF, dtype=ct, device=q.device))
    m = s.amax(-1)                                        # (B, K, G, Sq)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1).clamp_min(1e-30)
    o = torch.einsum("bkgqc,bckd->bqkgd", p, v.to(ct))
    o = o / l.permute(0, 3, 1, 2)[..., None]
    lse = (m + torch.log(l)).reshape(b, h, sq)
    return o.reshape(b, sq, h, d).to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int | None = None):
    """``(dq, dk, dv)`` in the dtypes of q, k, v: the gradients of
    ``flash_attention_ref``'s ``o`` for the output gradient ``do``,
    recomputed from ``lse``. The gradients of a KV head sum over the
    ``H // K`` query heads of its group."""
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    ct = _compute_dtype(q.dtype)
    scale = 1.0 / math.sqrt(d)
    qf, dof, of = (_fold(x, n_kv, ct) for x in (q, do, o))
    kf, vf = k.to(ct), v.to(ct)
    delta = (dof * of).sum(-1).permute(0, 2, 3, 1)        # (B, K, G, Sq)
    s, keep = _scores(qf, k, scale, causal, window, ct)
    lse = lse.to(ct).reshape(b, n_kv, g, sq)
    p = torch.where(keep, torch.exp(s - lse[..., None]),
                    torch.zeros((), dtype=ct, device=q.device))
    dv = torch.einsum("bkgqc,bqkgd->bckd", p, dof)
    dp = torch.einsum("bqkgd,bckd->bkgqc", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bkgqc,bckd->bqkgd", ds, kf).reshape(b, sq, h, d)
    dk = torch.einsum("bkgqc,bqkgd->bckd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
