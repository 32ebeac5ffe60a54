"""Plain PyTorch versions of the Mamba-2 SSD scan.

The CPU path of :mod:`repro_torch.kernels.ssd.ops`, and what the CUDA
kernel is held to on the card. Ports of ``src/repro/models/mamba2.py``:

* :func:`segsum` (``:35-44``): the segment sums of the intra-chunk decay;
* :func:`ssd_chunked` (``:47-102``): the chunk-parallel algorithm, chunks
  in sequence with the state carried between them. It does the kernel's
  work, in float32 throughout (the model's prefill passes no
  ``compute_dtype``, so the reference computes it in float32 too), or in
  float64 given float64 x (the yardstick of the card's checks at the
  model's scale);
* :func:`ssd_ref` (``:105-122``): the sequential oracle, one step at a time.

Layout (the model's): x ``(b, s, h, p)`` (already scaled by dt), dA
``(b, s, h)``, B and C ``(b, s, h, n)``; outputs y ``(b, s, h, p)`` in x's
dtype and the final state ``(b, h, p, n)``, float32 (float64 when computed
in float64). The state starts at 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x ``(..., l)`` -> ``(..., l, l)`` with ``out[..., i, j] = sum of
    x[k] for j < k <= i``, and ``-inf`` above the diagonal."""
    length = x.shape[-1]
    xx = x[..., None].expand(*x.shape, length)       # (..., i, j) holds x[i]
    strict = torch.tril(torch.ones((length, length), dtype=torch.bool,
                                   device=x.device), -1)
    out = torch.cumsum(torch.where(strict, xx, 0.0), dim=-2)
    lower = torch.tril(torch.ones_like(strict))
    return torch.where(lower, out, float("-inf"))


def ssd_chunked(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, *, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel SSD: ``(y, final_state)``. Any S: the last chunk is
    padded with identity steps (x = 0, dA = 0: decay 1, nothing added)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    pad = -s % q
    dt = torch.float64 if x.dtype == torch.float64 else F32
    xf, dAf, Bf, Cf = (t.to(dt) for t in (x, dA, B, C))
    if pad:
        xf, Bf, Cf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, Bf, Cf))
        dAf = F.pad(dAf, (0, 0, 0, pad))
    state = torch.zeros((b, h, p, n), dtype=dt, device=x.device)
    ys = []
    for c0 in range(0, s + pad, q):
        xq, Bq, Cq = (t[:, c0:c0 + q] for t in (xf, Bf, Cf))
        dAq = dAf[:, c0:c0 + q].transpose(1, 2)           # (b, h, q)
        a_cs = torch.cumsum(dAq, dim=-1)
        decay = torch.exp(segsum(dAq))                    # (b, h, q, q)
        scores = torch.einsum("blhn,bshn->bhls", Cq, Bq) * decay
        y = torch.einsum("bhls,bshp->blhp", scores, xq)
        # the incoming state's contribution
        y = y + torch.einsum("blhn,bhpn,bhl->blhp", Cq, state,
                             torch.exp(a_cs))
        # the state carried to the next chunk
        to_end = torch.exp(a_cs[..., -1:] - a_cs)         # (b, h, q)
        state = (state * torch.exp(a_cs[..., -1])[..., None, None]
                 + torch.einsum("blhn,bhl,blhp->bhpn", Bq, to_end, xq))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(x.dtype), state


def ssd_ref(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence ``state_t = state_{t-1} exp(dA_t) + x_t
    B_t^T``, ``y_t = state_t C_t``: ``(y, final_state)``. Computes in
    float32, or in float64 when x is float64 (the yardstick of the card's
    float64 check)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    dt = torch.float64 if x.dtype == torch.float64 else F32
    state = torch.zeros((b, h, p, n), dtype=dt, device=x.device)
    ys = []
    for t in range(s):
        state = (state * torch.exp(dA[:, t].to(dt))[..., None, None]
                 + torch.einsum("bhp,bhn->bhpn", x[:, t].to(dt),
                                B[:, t].to(dt)))
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C[:, t].to(dt)))
    return torch.stack(ys, dim=1).to(x.dtype), state
