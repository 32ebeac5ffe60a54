"""Decoder-only transformer: the paged decode subset.

Port of ``src/repro/models/transformer.py`` (``decls``, ``supports_paged``,
``paged_pool_init``, ``decode_step_paged`` without tensor parallelism, and
the helpers they use). The parameter tree keeps the reference's stacked
layout, so weights map one to one: ``blocks[...]["l0"]`` with a leading
``n_super`` axis, ``wq (d,h,hd)``, ``wk/wv (d,k,hd)``, ``wo (h,hd,d)``. The
reference's ``lax.scan`` over that axis is a Python loop here, and the KV
page pool is written **in place** (the reference donates it and returns a
new one).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import device as device_mod
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import axes as lx
from repro_torch.sharding.params import Axes, ParamDecl, stack_tree


def _is_moe_layer(cfg: ModelConfig, layer_idx: int) -> bool:
    if cfg.moe_experts < 2:
        return False
    return layer_idx % cfg.moe_interleave == cfg.moe_interleave - 1


def _attn_decls(cfg: ModelConfig) -> dict[str, ParamDecl]:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "ln": L.rmsnorm_decl(d),
        "wq": ParamDecl((d, h, hd), Axes(lx.EMBED, lx.HEADS, lx.HEAD_DIM), init="fan_in"),
        "wk": ParamDecl((d, k, hd), Axes(lx.EMBED, lx.KV_HEADS, lx.HEAD_DIM), init="fan_in"),
        "wv": ParamDecl((d, k, hd), Axes(lx.EMBED, lx.KV_HEADS, lx.HEAD_DIM), init="fan_in"),
        "wo": ParamDecl((h, hd, d), Axes(lx.HEADS, lx.HEAD_DIM, lx.EMBED), init="fan_in"),
    }


def _layer_decls(cfg: ModelConfig, layer_idx: int) -> dict[str, Any]:
    if _is_moe_layer(cfg, layer_idx):
        raise NotImplementedError("MoE layers are not yet ported")
    return {"attn": _attn_decls(cfg), "ln_mlp": L.rmsnorm_decl(cfg.d_model),
            "mlp": L.mlp_decls(cfg.d_model, cfg.d_ff, cfg.mlp_type)}


def decls(cfg: ModelConfig) -> dict[str, Any]:
    """The parameter declaration tree (the reference's layout)."""
    il = cfg.moe_interleave if cfg.moe_experts >= 2 else 1
    if cfg.n_layers % il:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} % interleave {il} != 0")
    superblock = {f"l{j}": _layer_decls(cfg, j) for j in range(il)}
    tree: dict[str, Any] = {
        "embed": L.embed_decl(cfg),
        "blocks": stack_tree(superblock, cfg.n_layers // il, lx.LAYERS),
        "ln_f": L.rmsnorm_decl(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        tree["head"] = L.head_decl(cfg)
    return tree


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _cast(tree: dict[str, torch.Tensor], dtype) -> dict[str, torch.Tensor]:
    return {k: v.to(dtype) for k, v in tree.items()}


def _project_qkv(h, p, cfg: ModelConfig, rope_cs=None):
    """h (B,S,d) -> q (B,S,H,hd), k/v (B,S,K,hd); rope from precomputed
    ``(cos, sin)`` (:func:`layers.rope_angles`) when the config uses it."""
    def proj(w):
        d, n, hd = w.shape
        return (h @ w.reshape(d, n * hd)).reshape(*h.shape[:-1], n, hd)

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.pos_emb == "rope":
        q = L.apply_rope(q, *rope_cs)
        k = L.apply_rope(k, *rope_cs)
    return q, k, v


def _ffn(x, lp, cfg: ModelConfig):
    h = L.rmsnorm(x, lp["ln_mlp"], cfg.norm_eps)
    return x + L.mlp(h, _cast(lp["mlp"], x.dtype), cfg.mlp_type)


def _act_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _embed(params, cfg: ModelConfig, tokens, positions):
    # gather, then cast: the same values as casting the table first
    x = params["embed"][tokens].to(_act_dtype(cfg))
    if cfg.pos_emb == "sinusoidal":
        x = x + L.sinusoidal(positions, cfg.d_model).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def supports_paged(cfg: ModelConfig) -> bool:
    """True when this config can decode against a global KV page pool
    (MoE excluded: capacity routing mixes tokens across batch rows)."""
    return cfg.moe_experts < 2


def paged_pool_init(cfg: ModelConfig, n_pages: int, page_size: int,
                    dtype=torch.bfloat16, device=None):
    """Zeroed global KV page pool: a (k, v) pair of (L, P, ps, Kh, Dh).

    ``n_pages`` includes any null/sentinel pages the caller reserves.
    ``device=None`` is the card (raises without one).
    """
    dev = device_mod.resolve(device)
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def decode_step_paged(params, cfg: ModelConfig, pool_k, pool_v, tables,
                      lengths, tokens, append_mask=None,
                      window: int | None = None):
    """One serving step against the global page pool.

    tokens (B,) int; lengths (B,) int32, positions already resident per
    slot (the new entry lands at ``lengths[b]``); tables (B, NP) int32 page
    ids; pool_k/pool_v (L, P, ps, Kh, Dh). ``append_mask`` (B,) bool gates
    the KV append per slot (False: the lane is idle and rides the batch;
    its logits are garbage and must be ignored); pass it on the CPU, since
    the lanes it selects are read on the host. Returns ``(logits (B, V),
    pool_k, pool_v)``: the pools are written **in place** and returned as
    the same tensors.

    ``window`` (default ``cfg.sliding_window``) reads the tables as rings
    and attends over the last ``window`` positions. Every attention call
    goes through :func:`repro_torch.kernels.paged_attention.ops.
    paged_attention`: the CUDA kernel on the card, its plain version on
    the CPU.
    """
    if window is None:
        window = cfg.sliding_window
    dev = pool_k.device
    tables = tables.to(dev, torch.int32)
    lengths = lengths.to(dev, torch.int32)
    tokens = tokens.to(dev)
    positions = lengths[:, None]
    x = _embed(params, cfg, tokens[:, None], positions)
    rope_cs = (L.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
               if cfg.pos_emb == "rope" else None)
    # the tail rows are the same for every layer: select the lanes once
    rows = paged_ref.tail_rows(tables, lengths, pool_k.shape[2], append_mask)
    attend_len = lengths + 1
    il = cfg.moe_interleave if cfg.moe_experts >= 2 else 1
    blocks = params["blocks"]
    for s in range(cfg.n_layers // il):
        for j in range(il):
            if _is_moe_layer(cfg, j):
                raise NotImplementedError("MoE layers are not yet ported")
            lp = blocks[f"l{j}"]
            ap = {k: v[s].to(x.dtype) for k, v in lp["attn"].items()}
            h = L.rmsnorm(x, ap["ln"], cfg.norm_eps)
            q, k, v = _project_qkv(h, ap, cfg, rope_cs)
            layer = s * il + j
            paged_ref.write_rows(k[:, 0], v[:, 0], pool_k[layer], pool_v[layer],
                                 rows)
            o = paged_ops.paged_attention(q[:, 0].contiguous(), pool_k[layer],
                                          pool_v[layer], tables, attend_len,
                                          window=window)
            wo = ap["wo"]
            x = x + (o.reshape(o.shape[0], -1) @ wo.reshape(-1, wo.shape[-1])
                     )[:, None]
            x = _ffn(x, {"ln_mlp": lp["ln_mlp"][s],
                         "mlp": {n: w[s] for n, w in lp["mlp"].items()}}, cfg)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = L.lm_head(x, params, cfg)[:, 0]
    return logits, pool_k, pool_v
