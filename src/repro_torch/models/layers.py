"""Shared neural layers of the decode path, as plain functions on tensors.

Port of the decode subset of ``src/repro/models/layers.py``: norms,
positional encodings, the four MLP kinds, the LM head and the naive
attention oracle, with the reference's dtype boundaries (norm and rope in
float32, cast back to the input dtype) and mask constant (``-1e30``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import axes as lx
from repro_torch.sharding.params import Axes, ParamDecl

F32 = torch.float32
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms / embeddings / positional
# ---------------------------------------------------------------------------


def rmsnorm_decl(d: int) -> ParamDecl:
    return ParamDecl((d,), Axes(lx.EMBED), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in float32 and cast back to ``x.dtype``."""
    dt = x.dtype
    x = x.to(F32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(F32)).to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 1e4) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``(cos, sin)`` of shape ``(..., seq, 1, head_dim // 2)`` for
    :func:`apply_rope`; one pair serves every layer of a step."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=F32, device=positions.device)
                      / half)
    ang = positions.to(F32)[..., None] * freqs
    ang = ang[..., None, :]          # broadcast over heads
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of ``x`` (..., seq, heads, head_dim) in float32,
    cast back to ``x.dtype``."""
    half = x.shape[-1] // 2
    xf = x.to(F32)
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    return apply_rope(x, *rope_angles(positions, x.shape[-1], theta))


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(1e4)
                      * torch.arange(half, dtype=F32, device=positions.device)
                      / half)
    ang = positions.to(F32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Attention oracle
# ---------------------------------------------------------------------------


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  q_offset: int = 0, kv_len: int | None = None) -> torch.Tensor:
    """Naive full-score oracle. q:(B,Sq,H,D) k,v:(B,Sk,K,D); GQA folds
    head ``h`` onto KV head ``h // (H // K)``."""
    b, sq, h, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    qf = q.reshape(b, sq, nkv, h // nkv, d).to(F32)
    s = torch.einsum("bqkgd,bckd->bkgqc", qf, k.to(F32)) / math.sqrt(d)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    if kv_len is not None:
        mask &= kpos < kv_len
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=F32, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckd->bqkgd", p, v.to(F32))
    return o.reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def mlp_decls(d: int, f: int, kind: str) -> dict[str, ParamDecl]:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": ParamDecl((d, f), Axes(lx.EMBED, lx.MLP), init="fan_in"),
            "w_up": ParamDecl((d, f), Axes(lx.EMBED, lx.MLP), init="fan_in"),
            "w_down": ParamDecl((f, d), Axes(lx.MLP, lx.EMBED), init="fan_in"),
        }
    return {  # gelu / squared_relu: plain 2-matrix MLP
        "w_up": ParamDecl((d, f), Axes(lx.EMBED, lx.MLP), init="fan_in"),
        "w_down": ParamDecl((f, d), Axes(lx.MLP, lx.EMBED), init="fan_in"),
    }


def mlp(x: torch.Tensor, p: dict[str, torch.Tensor], kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    if kind == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if kind == "geglu":
        return (F.gelu(x @ p["w_gate"], approximate="tanh")
                * (x @ p["w_up"])) @ p["w_down"]
    h = x @ p["w_up"]
    if kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif kind == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown mlp kind {kind}")
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------


def embed_decl(cfg) -> ParamDecl:
    return ParamDecl((cfg.padded_vocab, cfg.d_model), Axes("vocab_in", lx.EMBED),
                     init="normal", scale=0.02)


def head_decl(cfg) -> ParamDecl:
    return ParamDecl((cfg.d_model, cfg.padded_vocab), Axes(lx.EMBED, lx.VOCAB),
                     init="fan_in")


def lm_head(x: torch.Tensor, params, cfg) -> torch.Tensor:
    """x: (..., d_model) -> logits (..., padded_vocab) with padding masked
    to ``-1e30``."""
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["head"].to(x.dtype)
    if cfg.padded_vocab != cfg.vocab:
        logits[..., cfg.vocab:] = NEG_INF
    return logits
