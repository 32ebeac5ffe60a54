"""Decoder-only transformer: the training forward, the serve driver's
prefill and decode, and paged decode.

Port of ``src/repro/models/transformer.py`` (``decls`` with dense and MoE
superblocks, ``forward`` for the dense family, ``KVCache``, ``prefill`` and
``decode_step`` for the dense and MoE families, ``remat`` (the training
forward's remat point, shared with griffin and mamba2), ``supports_paged``,
``paged_pool_init``, ``decode_step_paged`` without tensor parallelism, and
the helpers they use). The parameter tree keeps the reference's stacked
layout, so weights map one to one: ``blocks[...]["l{j}"]`` with a leading
``n_super`` axis (``moe_interleave`` layers a superblock, the last one MoE),
``wq (d,h,hd)``, ``wk/wv (d,k,hd)``, ``wo (h,hd,d)``, the experts'
``w_gate/w_up (E,d,f)`` and ``w_down (E,f,d)``. The reference's
``lax.scan`` over that axis is a Python loop here, and the KV cache and the
KV page pool are written **in place** (the reference donates them and
returns new ones).

Every kernel call goes through the XAIF registry under the config's impl
keys (:func:`layers.impl_key`): every MoE layer's expert FFN as op
``"moe_ffn"`` under ``cfg.moe_impl`` (the CUDA grouped-matmul kernel on the
card), every multi-token attention call as ``"attention"`` under
``cfg.attn_impl`` (the CUDA flash kernels), and the paged decode's
attention as ``"paged_attention"`` under ``cfg.attn_impl`` (the CUDA paged
kernel). The one-token decode step of the lane cache attends in plain
PyTorch (:func:`layers.attention_ref` with ``kv_len``), as the reference
does with ``attention_chunked``, not with a Pallas kernel.

The training forward and the prefill take ``tokens`` or, for the audio and
VLM families' stubbed front ends (``embed_inputs=False``), ``embeds`` (B,
S, d_model): the activations then take the embeddings' dtype, as the
reference's do (bf16 embeddings give bf16 activations under a float32
config), and the sinusoidal positions are added in it.

A lane cache (``KVCache.pos`` of shape (B,), built by
``registry.cache_init(..., lanes=True)``) decodes its B rows as B
batch-1 models, as the reference's lane engine ``vmap``s ``decode_step``:
each row at its own position, and the MoE layers routing each row as a
batch of its own (:func:`layers.moe_lanes`). A ``keep`` mask leaves the
masked rows' cache bit for bit as it was.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import device as device_mod
from repro_torch.core.xaif import REGISTRY
# imported for its XAIF registration under "cuda"
from repro_torch.kernels.paged_attention import ops as _paged_ops  # noqa: F401
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import axes as lx
from repro_torch.sharding.params import Axes, ParamDecl, stack_tree, tree_map


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
    out: dict[str, Any] = {"attn": _attn_decls(cfg),
                           "ln_mlp": L.rmsnorm_decl(cfg.d_model)}
    if _is_moe_layer(cfg, layer_idx):
        out["moe"] = L.moe_decls(cfg.d_model, cfg.d_ff, cfg.moe_experts,
                                 cfg.mlp_type, shared=cfg.moe_shared_expert)
    else:
        out["mlp"] = L.mlp_decls(cfg.d_model, cfg.d_ff, cfg.mlp_type)
    return out


def _interleave(cfg: ModelConfig) -> int:
    """Layers a superblock: ``moe_interleave`` for MoE configs, else 1."""
    return cfg.moe_interleave if cfg.moe_experts >= 2 else 1


def decls(cfg: ModelConfig) -> dict[str, Any]:
    """The parameter declaration tree (the reference's layout)."""
    il = _interleave(cfg)
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


def true_fan_in(params, cfg: ModelConfig):
    """``params`` with the attention projections rescaled to the std of
    their true fan-in: d_model for wq, wk and wv, heads * head_dim for wo.

    The reference's ``ParamDecl`` takes ``shape[-2]`` as the fan-in, which
    for these 3-d weights is the head count (wq), the KV head count (wk,
    wv) or the head dim (wo). At granite-3-2b's full width q and k come out
    8 times too large, and the gradients grow 5-10x per layer towards the
    input, past bf16's range at depth 40. Returns a new tree (leaves
    multiplied by a Python float, so numpy and torch leaves alike); the
    other leaves are shared. Every layer of a superblock is rescaled (MoE
    superblocks hold ``moe_interleave`` of them).
    """
    blocks = {name: dict(lp, attn=rescale_attention(lp["attn"], cfg))
              for name, lp in params["blocks"].items()}
    return dict(params, blocks=blocks)


def rescale_attention(attn: dict, cfg: ModelConfig) -> dict:
    """One attention block's params (stacked or not) with wq, wk, wv and wo
    rescaled from the reference's fan-in to their true fan-in (see
    :func:`true_fan_in`); the other leaves are shared."""
    d, h, kh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    a = dict(attn)
    for name, fan_ratio in (("wq", h / d), ("wk", kh / d), ("wv", kh / d),
                            ("wo", 1 / h)):
        a[name] = a[name] * fan_ratio ** 0.5
    return a


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _cast(tree: dict, dtype) -> dict:
    """Every leaf of a (nested) params dict cast to ``dtype``."""
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    """``(cos, sin)`` for :func:`_project_qkv`, or None without rope."""
    return (L.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
            if cfg.pos_emb == "rope" else None)


def _attn_out(x, o, wo):
    """The residual add of the attention output o (B,S,H,hd) through wo."""
    return x + o.reshape(*o.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


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


def _ffn(x, lp, cfg: ModelConfig, is_moe: bool = False, lanes: bool = False):
    """The residual FFN of one layer: the MLP, or for an MoE layer
    :func:`layers.moe` on weights cast to x's dtype (the router is lifted
    back to float32 inside, as the reference's is), or with ``lanes``
    :func:`layers.moe_lanes` (each row routed on its own). The MoE aux
    loss is dropped: the serving paths discard it, as the reference's
    prefill and decode do, and MoE training is not yet ported."""
    h = L.rmsnorm(x, lp["ln_mlp"], cfg.norm_eps)
    if is_moe and lanes:
        return x + L.moe_lanes(h, _cast(lp["moe"], x.dtype),
                               n_exp=cfg.moe_experts, top_k=cfg.moe_top_k,
                               kind=cfg.mlp_type, impl=cfg.moe_impl)
    if is_moe:
        o, _aux = L.moe(h, _cast(lp["moe"], x.dtype),
                        n_exp=cfg.moe_experts, top_k=cfg.moe_top_k,
                        capacity_factor=cfg.moe_capacity_factor,
                        kind=cfg.mlp_type, impl=cfg.moe_impl)
        return x + o
    return x + L.mlp(h, _cast(lp["mlp"], x.dtype), cfg.mlp_type)


def _act_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _embed(params, cfg: ModelConfig, tokens, positions, embeds=None):
    """The first activations (``transformer.py:190-197``): the token
    embeddings in the config's dtype, or ``embeds`` as they are (their
    dtype is the activations'), plus sinusoidal positions in that dtype
    where the config uses them."""
    if embeds is None:
        # gather, then cast: the same values as casting the table first
        x = params["embed"][tokens].to(_act_dtype(cfg))
    else:
        x = embeds
    if cfg.pos_emb == "sinusoidal":
        x = x + L.sinusoidal(positions, cfg.d_model).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def superblocks(blocks, n_super: int) -> list:
    """The per-superblock parameter trees of ``params["blocks"]``.

    ``blocks`` is the stacked tree (every leaf with a leading ``n_super``
    axis), indexed here, or already a list of per-superblock trees. A
    trainer passes the list: each layer then owns its leaf tensors, and
    autograd does not write a stack-sized zero gradient for every index
    into a stacked leaf.
    """
    if isinstance(blocks, (list, tuple)):
        if len(blocks) != n_super:
            raise ValueError(f"{len(blocks)} superblocks, want {n_super}")
        return list(blocks)
    return [tree_map(lambda t, s=s: t[s], blocks) for s in range(n_super)]


def _no_batch_dot(op, args) -> bool:
    """Whether an aten op is a matrix product without batch dimensions:
    ``mm``/``addmm`` (``x @ w`` with a 2-d weight), or ``bmm`` over a batch
    of one (an ``einsum`` that contracts without a batch axis)."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        return True
    return op == aten.bmm.default and args[0].shape[0] == 1


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if _no_batch_dot(op, args)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, cfg: ModelConfig, *args):
    """``fn(*args)`` under ``cfg.remat``, the training forward's one remat
    point for every family (port of ``_maybe_remat``,
    ``src/repro/models/transformer.py:181-187``): ``"none"`` keeps every
    activation; ``"full"`` checkpoints the call (non-reentrant: its
    forward, kernels included, runs again in the backward); ``"dots"``
    (``checkpoint_dots_with_no_batch_dims``) keeps the outputs of matrix
    products without batch dimensions and recomputes the rest, through
    PyTorch's selective checkpointing."""
    if cfg.remat == "none":
        return fn(*args)
    if cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    raise ValueError(f"unknown remat {cfg.remat!r}")


def _attn_train(x, p, cfg: ModelConfig, rope_cs):
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    q, k, v = _project_qkv(h, p, cfg, rope_cs)
    o = L.attention(q, k, v, causal=True, window=cfg.sliding_window,
                    impl=cfg.attn_impl)
    return _attn_out(x, o, p["wo"])


def _layer_train(x, lp, cfg: ModelConfig, rope_cs):
    x = _attn_train(x, _cast(lp["attn"], x.dtype), cfg, rope_cs)
    return _ffn(x, lp, cfg)


def _inputs(params, tokens, embeds):
    """``(tokens, embeds, S)`` on the params' device: one of the two is
    given (``embeds`` (B, S, d_model) for a stubbed front end)."""
    if (tokens is None) == (embeds is None):
        raise ValueError("pass exactly one of tokens and embeds")
    dev = params["embed"].device
    if embeds is not None:
        embeds = embeds.to(dev)
        return None, embeds, embeds.shape[1]
    tokens = tokens.to(dev)
    return tokens, None, tokens.shape[1]


def forward(params, cfg: ModelConfig, tokens=None, positions=None,
            embeds=None):
    """Training/prefill forward: tokens (B, S) or embeds (B, S, d_model) ->
    ``(logits (B, S, V), aux)``, ``aux`` being the MoE load-balance loss (0
    for dense layers).

    Runs where the params are. Every attention call goes through
    :func:`repro_torch.models.layers.attention` under ``cfg.attn_impl``
    (the CUDA flash kernels on the card). Each layer runs under
    ``cfg.remat`` (:func:`remat`). ``params["blocks"]`` may be stacked or a
    list of per-superblock trees (:func:`superblocks`).
    """
    dev = params["embed"].device
    tokens, embeds, s = _inputs(params, tokens, embeds)
    if positions is None:
        positions = torch.arange(s, device=dev)[None]
    positions = positions.to(dev)
    x = _embed(params, cfg, tokens, positions, embeds)
    rope_cs = _rope(cfg, positions)
    il = _interleave(cfg)
    for blk in superblocks(params["blocks"], cfg.n_layers // il):
        for j in range(il):
            if _is_moe_layer(cfg, j):
                raise NotImplementedError("MoE training is not yet ported")
            x = remat(_layer_train, cfg, x, blk[f"l{j}"], cfg, rope_cs)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return L.lm_head(x, params, cfg), torch.zeros((), device=dev)


# ---------------------------------------------------------------------------
# Serving: the serve driver's lane cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """Decode state of the serve driver and of the lane engine: every
    layer's K and V in bf16, ``(L, B, S_cache, Kh, Dh)``, and the next
    position to write, one for the batch (``pos`` 0-d, the serve driver)
    or one a lane (``pos`` (B,), the lane engine). With a sliding window
    the cache is a ring of ``min(max_len, window)`` slots, position p at
    slot ``p % S_cache``."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor    # () or (B,) int32

    @staticmethod
    def cache_len(cfg: ModelConfig, max_len: int) -> int:
        return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len

    @staticmethod
    def init(cfg: ModelConfig, batch: int, max_len: int,
             device=None) -> "KVCache":
        """A zeroed bf16 cache on ``device`` (``None`` is the card)."""
        dev = device_mod.resolve(device)
        shape = (cfg.n_layers, batch, KVCache.cache_len(cfg, max_len),
                 cfg.n_kv_heads, cfg.resolved_head_dim)
        return KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                       torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                       torch.zeros((), dtype=torch.int32, device=dev))


def _layers(params, cfg: ModelConfig):
    """``(layer index, is_moe, layer params)`` in model order, each leaf
    indexed out of the stacked superblock tree."""
    il = _interleave(cfg)
    blocks = params["blocks"]
    for s in range(cfg.n_layers // il):
        for j in range(il):
            lp = tree_map(lambda a, s=s: a[s], blocks[f"l{j}"])
            yield s * il + j, _is_moe_layer(cfg, j), lp


def cache_tail(k, v, s_cache: int, dtype=torch.bfloat16):
    """The cache rows ``(ck, cv)`` (B, s_cache, K, hd) in ``dtype`` that a
    prefill of S positions leaves: with S >= s_cache its last s_cache rows,
    position p at slot ``p % s_cache`` (a ring when the cache is a window),
    else all S rows, zero-padded to s_cache."""
    b, s = k.shape[:2]
    if s >= s_cache:
        slots = torch.arange(s - s_cache, s, device=k.device) % s_cache
        ck = torch.zeros((b, s_cache, *k.shape[2:]), dtype=dtype,
                         device=k.device)
        cv = torch.zeros_like(ck)
        ck[:, slots] = k[:, s - s_cache:].to(dtype)
        cv[:, slots] = v[:, s - s_cache:].to(dtype)
        return ck, cv
    pad = (0, 0, 0, 0, 0, s_cache - s)
    return (torch.nn.functional.pad(k.to(dtype), pad),
            torch.nn.functional.pad(v.to(dtype), pad))


def decode_attend(q, k, v, ck, cv, pos, keep=None):
    """One position per lane against a cache ck/cv (B, S_cache, K, hd): its
    k/v land at slot ``pos % S_cache``, **in place**, and q attends over
    the first ``min(pos + 1, S_cache)`` slots in plain PyTorch
    (:func:`layers.attention_ref`). Without a window S_cache is max_len and
    the slot is pos. ``pos`` is one position for every lane (0-d) or one a
    lane (B,); with one a lane, a lane masked out by ``keep`` (B,) bool
    writes back the entry it holds, so its cache stays bit for bit as it
    was (its query still attends, and its output is to be ignored)."""
    s_cache = ck.shape[1]
    if pos.dim() == 0:
        slot = (pos % s_cache).reshape(1).long()
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
    else:
        lanes = torch.arange(ck.shape[0], device=ck.device)
        slot = (pos % s_cache).long()
        for c, new in ((ck, k), (cv, v)):
            new = new[:, 0].to(c.dtype)
            if keep is not None:
                new = L.keep_lanes(keep, new, c[lanes, slot])
            c[lanes, slot] = new
    kv_len = torch.clamp_max(pos + 1, s_cache)
    return L.attention_ref(q, ck, cv, causal=False, kv_len=kv_len)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None,
            max_len: int | None = None) -> tuple[torch.Tensor, KVCache]:
    """tokens (B, S) or embeds (B, S, d_model) -> ``(logits (B, V),
    cache)``: the logits of the last position, and the cache that
    :func:`decode_step` continues from (``transformer.py:223-271``); the
    decode steps after it take tokens.

    Runs where the params are. ``max_len`` (default S) sizes the cache
    (:meth:`KVCache.cache_len`): a prompt of at least ``S_cache`` positions
    keeps its last ``S_cache`` K/V rows, position p at slot ``p % S_cache``;
    a shorter one is zero-padded. Attention is causal (windowed where the
    config is) through :func:`layers.attention`, the MoE layers' expert
    FFNs through the grouped-matmul op. The B x S tokens of an MoE layer
    are routed together, as the reference routes them.
    """
    dev = params["embed"].device
    tokens, embeds, s = _inputs(params, tokens, embeds)
    max_len = max_len or s
    s_cache = KVCache.cache_len(cfg, max_len)
    positions = torch.arange(s, device=dev)[None]
    rope_cs = _rope(cfg, positions)
    x = _embed(params, cfg, tokens, positions, embeds)
    ks, vs = [], []
    for _, is_moe, lp in _layers(params, cfg):
        ap = _cast(lp["attn"], x.dtype)
        h = L.rmsnorm(x, ap["ln"], cfg.norm_eps)
        q, k, v = _project_qkv(h, ap, cfg, rope_cs)
        o = L.attention(q, k, v, causal=True, window=cfg.sliding_window,
                        impl=cfg.attn_impl)
        x = _attn_out(x, o, ap["wo"])
        x = _ffn(x, lp, cfg, is_moe)
        ck, cv = cache_tail(k, v, s_cache)
        ks.append(ck)
        vs.append(cv)
    xf = L.rmsnorm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    logits = L.lm_head(xf, params, cfg)[:, 0]
    cache = KVCache(torch.stack(ks), torch.stack(vs),
                    torch.tensor(s, dtype=torch.int32, device=dev))
    return logits, cache


def _attn_decode(x, p, cfg: ModelConfig, ck, cv, pos, rope_cs, keep=None):
    """``transformer.py:131-143``: the layer's attention for one position
    per lane, through :func:`decode_attend`."""
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    q, k, v = _project_qkv(h, p, cfg, rope_cs)
    return _attn_out(x, decode_attend(q, k, v, ck, cv, pos, keep), p["wo"])


def advance(pos: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
    """The positions after one decode step: one more, but where ``keep``
    masks a lane out (a mask needs a position a lane, ``pos`` (B,))."""
    if keep is None:
        return pos + 1
    if pos.dim() != 1:
        raise ValueError("a keep mask needs a lane cache (pos of shape (B,))")
    return pos + keep.to(pos.dtype)


def decode_step(params, cfg: ModelConfig, cache: KVCache,
                tokens: torch.Tensor, keep: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, KVCache]:
    """tokens (B, 1) -> ``(logits (B, V), cache)`` (``transformer.py:
    380-410``). The cache is written **in place** (the reference returns a
    new one) and comes back as the same object, its ``pos`` advanced by
    one. With a 0-d ``pos`` (the serve driver) the B tokens of a step are
    routed together, as the reference routes them; with a (B,) ``pos`` (a
    lane cache) each lane is at its own position and routed on its own,
    as under the reference engine's ``vmap``. ``keep`` (B,) bool, on the
    cache's device, masks lanes out: a masked lane's K/V, and its ``pos``,
    stay bit for bit as they were, and its logits are to be ignored."""
    dev = params["embed"].device
    tokens = tokens.to(dev)
    pos = cache.pos
    new_pos = advance(pos, keep)
    positions = pos.reshape(-1, 1)
    rope_cs = _rope(cfg, positions)
    x = _embed(params, cfg, tokens, positions)
    lanes = pos.dim() == 1
    for layer, is_moe, lp in _layers(params, cfg):
        x = _attn_decode(x, _cast(lp["attn"], x.dtype), cfg, cache.k[layer],
                         cache.v[layer], pos, rope_cs, keep)
        x = _ffn(x, lp, cfg, is_moe, lanes)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = L.lm_head(x, params, cfg)[:, 0]
    cache.pos = new_pos
    return logits, cache


# ---------------------------------------------------------------------------
# Serving: the paged engine
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
    dispatches op ``"paged_attention"`` under ``cfg.attn_impl``
    (``"cuda"``: :func:`repro_torch.kernels.paged_attention.ops.
    paged_attention`, the CUDA kernel on the card, its plain version on
    the CPU).
    """
    if window is None:
        window = cfg.sliding_window
    dev = pool_k.device
    tables = tables.to(dev, torch.int32)
    lengths = lengths.to(dev, torch.int32)
    tokens = tokens.to(dev)
    positions = lengths[:, None]
    x = _embed(params, cfg, tokens[:, None], positions)
    rope_cs = _rope(cfg, positions)
    # the tail rows are the same for every layer: select the lanes once
    rows = paged_ref.tail_rows(tables, lengths, pool_k.shape[2], append_mask)
    attend_len = lengths + 1
    impl = L.impl_key(cfg.attn_impl)
    il = _interleave(cfg)
    blocks = params["blocks"]
    for s in range(cfg.n_layers // il):
        for j in range(il):
            if _is_moe_layer(cfg, j):
                raise NotImplementedError("MoE layers have no paged decode")
            lp = blocks[f"l{j}"]
            ap = {k: v[s].to(x.dtype) for k, v in lp["attn"].items()}
            h = L.rmsnorm(x, ap["ln"], cfg.norm_eps)
            q, k, v = _project_qkv(h, ap, cfg, rope_cs)
            layer = s * il + j
            paged_ref.write_rows(k[:, 0], v[:, 0], pool_k[layer], pool_v[layer],
                                 rows)
            o = REGISTRY.dispatch("paged_attention", impl,
                                  q[:, 0].contiguous(), pool_k[layer],
                                  pool_v[layer], tables, attend_len,
                                  window=window)
            x = _attn_out(x, o[:, None], ap["wo"])
            x = _ffn(x, {"ln_mlp": lp["ln_mlp"][s],
                         "mlp": {n: w[s] for n, w in lp["mlp"].items()}}, cfg)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = L.lm_head(x, params, cfg)[:, 0]
    return logits, pool_k, pool_v
