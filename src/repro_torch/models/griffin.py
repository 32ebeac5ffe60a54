"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427): RG-LRU + local attention.

Port of ``src/repro/models/griffin.py`` for serving: the parameter
declarations, :class:`GriffinCache`, :func:`prefill` and :func:`decode_step`
(the training ``forward`` waits for a later slice of the port). The layer
pattern is (rec, rec, attn) repeating: RecurrentGemma-2B's 26 layers are 8
triples and a (rec, rec) tail. The parameter tree keeps the reference's
layout (``triples`` stacked along a leading axis, ``tail`` per layer), so
weights map one to one; the reference's ``lax.scan`` over the triples is a
Python loop here.

Every RG-LRU scan goes through :func:`linear_scan`
(:func:`repro_torch.kernels.rglru.ops.rglru`: the CUDA kernel on the card),
and every multi-token attention call through
:func:`repro_torch.models.layers.attention` (the CUDA flash forward). The
one-token decode step needs neither: its recurrence is one multiply-add,
and its attention over the ring cache is :func:`layers.attention_ref`
(plain PyTorch), as the reference computes it with ``attention_chunked``,
not with a Pallas kernel.

The reference's dtype boundaries are kept: activations are bfloat16
whatever ``cfg.dtype`` is (the embedding is gathered from a bf16 cast of
the table), the Gemma scaling multiplies by ``sqrt(d_model)`` rounded to
bf16, the gates run in float32, and the recurrent state is float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import torch
import torch.nn.functional as F

from repro_torch import device as device_mod
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (_attn_decls, _ffn, _project_qkv,
                                           rescale_attention)
from repro_torch.sharding import axes as lx
from repro_torch.sharding.params import Axes, ParamDecl, stack_tree, tree_map

F32 = torch.float32
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _block_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Block-diagonal linear: x (B,S,W), w (nb, bs, bs), in x's dtype."""
    b, s, width = x.shape
    nb, bs, _ = w.shape
    xr = x.reshape(b, s, nb, bs)
    return torch.einsum("bsgi,gij->bsgj", xr, w).reshape(b, s, width)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(1 + e^x)`` as ``logaddexp(x, 0)``, with no
    threshold (``F.softplus`` returns ``x`` itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def rglru_gates(x: torch.Tensor, p: dict,
                c: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(a, b_in)``: the recurrence coefficient and the gated input, both
    float32 (``griffin.py:44-54``). The block-diagonal gate products run in
    x's dtype and are then cast up; the root's argument is clamped to 1e-12
    before the root."""
    r = torch.sigmoid(_block_linear(x, p["w_r"].to(x.dtype)).to(F32)
                      + p["b_r"].to(F32))
    i = torch.sigmoid(_block_linear(x, p["w_i"].to(x.dtype)).to(F32)
                      + p["b_i"].to(F32))
    log_a = -c * _softplus(p["a_param"].to(F32)) * r
    a = torch.exp(log_a)
    b_in = (torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
            * (i * x.to(F32)))
    return a, b_in


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t h_{t-1} + b_t`` over (B,S,W): ``(y, h_final)``, always
    through :func:`repro_torch.kernels.rglru.ops.rglru` (the reference's
    ``scan_impl`` picks one of three backends; the port has the one)."""
    return rglru_ops.rglru(a, b, h0)


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------


def _rglru_decls(width: int, nb: int) -> dict[str, ParamDecl]:
    bs = width // nb
    return {
        "a_param": ParamDecl((width,), Axes(lx.RNN_WIDTH), init="normal",
                             scale=0.5),
        "w_r": ParamDecl((nb, bs, bs), Axes(lx.HEADS, None, None),
                         init="fan_in"),
        "b_r": ParamDecl((width,), Axes(lx.RNN_WIDTH), init="zeros"),
        "w_i": ParamDecl((nb, bs, bs), Axes(lx.HEADS, None, None),
                         init="fan_in"),
        "b_i": ParamDecl((width,), Axes(lx.RNN_WIDTH), init="zeros"),
    }


def _rec_mix_decls(cfg: ModelConfig) -> dict[str, Any]:
    d, w = cfg.d_model, cfg.rnn_width or cfg.d_model
    return {
        "ln": L.rmsnorm_decl(d),
        "w_y": ParamDecl((d, w), Axes(lx.EMBED, lx.RNN_WIDTH), init="fan_in"),
        "w_x": ParamDecl((d, w), Axes(lx.EMBED, lx.RNN_WIDTH), init="fan_in"),
        "conv": L.conv1d_decl(cfg.ssm_conv_width, w),
        "rglru": _rglru_decls(w, cfg.n_heads),
        "w_out": ParamDecl((w, d), Axes(lx.RNN_WIDTH, lx.EMBED), init="fan_in"),
    }


def _layer_decls(cfg: ModelConfig, kind: str) -> dict[str, Any]:
    # an attention mix has the transformer attention block's five leaves
    mix = _rec_mix_decls(cfg) if kind == "rec" else _attn_decls(cfg)
    return {"mix": mix, "ln_mlp": L.rmsnorm_decl(cfg.d_model),
            "mlp": L.mlp_decls(cfg.d_model, cfg.d_ff, cfg.mlp_type)}


def _block(cfg: ModelConfig) -> tuple[str, ...]:
    """The repeating block of layer kinds."""
    return cfg.block_pattern or ("rec", "rec", "attn")


def _pattern(cfg: ModelConfig) -> list[str]:
    pat = _block(cfg)
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def plan(cfg: ModelConfig) -> tuple[int, list[str]]:
    """(n_triples, tail_kinds)."""
    n_full = cfg.n_layers // len(_block(cfg))
    return n_full, _pattern(cfg)[n_full * len(_block(cfg)):]


def decls(cfg: ModelConfig) -> dict[str, Any]:
    """The parameter declaration tree (the reference's layout)."""
    n_full, tail = plan(cfg)
    pat = _block(cfg)
    triple = {f"p{j}_{k}": _layer_decls(cfg, k) for j, k in enumerate(pat)}
    tree: dict[str, Any] = {
        "embed": L.embed_decl(cfg),
        "triples": stack_tree(triple, n_full, lx.LAYERS),
        "tail": {f"t{j}_{k}": _layer_decls(cfg, k) for j, k in enumerate(tail)},
        "ln_f": L.rmsnorm_decl(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        tree["head"] = L.head_decl(cfg)
    return tree


def true_fan_in(params, cfg: ModelConfig):
    """``params`` with every attention layer's projections rescaled to
    their true fan-in (:func:`transformer.rescale_attention`).

    At the reference's init wk and wv of shape (d_model, 1, head_dim) have
    std 1 (their ``fan_in`` is the KV head count), so the scores are large
    and the softmax nearly one-hot: a rounding difference on one score then
    moves the layer's output by O(1), and two correct implementations with
    different bf16 rounding drift apart. Comparisons across frameworks or
    devices use this init. Returns a new tree (numpy or torch leaves); the
    other leaves are shared.
    """
    def fix(group):
        return {n: (dict(lp, mix=rescale_attention(lp["mix"], cfg))
                    if n.endswith("_attn") else lp)
                for n, lp in group.items()}

    return dict(params, triples=fix(params["triples"]),
                tail=fix(params["tail"]))


def _layers(params, cfg: ModelConfig) -> Iterator[tuple[str, dict]]:
    """``(kind, layer params)`` in model order: the triples, then the tail."""
    n_full, tail = plan(cfg)
    for t in range(n_full):
        for j, kind in enumerate(_block(cfg)):
            yield kind, tree_map(lambda a, t=t: a[t],
                                 params["triples"][f"p{j}_{kind}"])
    for j, kind in enumerate(tail):
        yield kind, params["tail"][f"t{j}_{kind}"]


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GriffinCache:
    """Decode state: per recurrent layer the conv tail and the RG-LRU state,
    per attention layer a ring of the last ``win`` positions' K and V."""

    conv: torch.Tensor   # (n_rec, B, cw-1, W) bf16
    h: torch.Tensor      # (n_rec, B, W) float32
    k: torch.Tensor      # (n_attn, B, win, kv, hd) bf16
    v: torch.Tensor
    pos: torch.Tensor    # () int32: positions consumed so far

    @staticmethod
    def shapes(cfg: ModelConfig, batch: int, max_len: int):
        """Shapes of ``conv``, ``h`` and ``k``/``v``;
        ``win = min(attn_window, max_len)``."""
        kinds = _pattern(cfg)
        w = cfg.rnn_width or cfg.d_model
        win = min(cfg.attn_window or max_len, max_len)
        return ((kinds.count("rec"), batch, cfg.ssm_conv_width - 1, w),
                (kinds.count("rec"), batch, w),
                (kinds.count("attn"), batch, win, cfg.n_kv_heads,
                 cfg.resolved_head_dim))

    @staticmethod
    def init(cfg: ModelConfig, batch: int, max_len: int,
             device=None) -> "GriffinCache":
        """A zeroed cache on ``device`` (``None`` is the card)."""
        dev = device_mod.resolve(device)
        s_conv, s_h, s_kv = GriffinCache.shapes(cfg, batch, max_len)
        return GriffinCache(
            torch.zeros(s_conv, dtype=BF16, device=dev),
            torch.zeros(s_h, dtype=F32, device=dev),
            torch.zeros(s_kv, dtype=BF16, device=dev),
            torch.zeros(s_kv, dtype=BF16, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # gathered, then cast: the same values as the reference's gather from a
    # bf16 cast of the table, whatever cfg.dtype is
    x = params["embed"][tokens].to(BF16)
    # gemma-style scaling by sqrt(d_model) rounded to bf16, as the
    # reference's jnp.asarray(sqrt(d), bf16) (a Python float would not be)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=BF16)


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    return (L.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
            if cfg.pos_emb == "rope" else None)


def _rec_mix_prefill(x, p, cfg: ModelConfig):
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    y = F.gelu(h @ p["w_y"].to(h.dtype), approximate="tanh")
    u = h @ p["w_x"].to(h.dtype)
    # the conv state: the last w-1 rows of [zeros, u], so a prompt shorter
    # than w-1 keeps the zero history GriffinCache.init starts from (the
    # reference slices u itself and then fails to decode); a copy, since a
    # view would keep all of u alive
    u, tail = L.causal_conv1d(u, p["conv"].to(u.dtype))
    tail = tail.clone()
    a, b_in = rglru_gates(u, p["rglru"], cfg.rglru_c)
    ys, h_fin = linear_scan(a, b_in)
    out = (ys.to(x.dtype) * y) @ p["w_out"].to(x.dtype)
    return x + out, tail, h_fin


def _attn_out(x, o, wo):
    return x + o.reshape(*o.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def _attn_mix_prefill(x, p, cfg: ModelConfig, rope_cs, win: int):
    b, s = x.shape[:2]
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    w = {n: p[n].to(h.dtype) for n in ("wq", "wk", "wv", "wo")}
    q, k, v = _project_qkv(h, w, cfg, rope_cs)
    o = L.attention(q, k, v, causal=True, window=cfg.attn_window)
    x = _attn_out(x, o, w["wo"])
    if s >= win:
        # position p sits at ring slot p % win
        slots = torch.arange(s - win, s, device=x.device) % win
        ck = torch.zeros((b, win, *k.shape[2:]), dtype=BF16, device=x.device)
        cv = torch.zeros_like(ck)
        ck[:, slots] = k[:, s - win:].to(BF16)
        cv[:, slots] = v[:, s - win:].to(BF16)
    else:
        ck = F.pad(k.to(BF16), (0, 0, 0, 0, 0, win - s))
        cv = F.pad(v.to(BF16), (0, 0, 0, 0, 0, win - s))
    return x, ck, cv


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int | None = None) -> tuple[torch.Tensor, GriffinCache]:
    """tokens (B, S) -> ``(logits (B, V), cache)``: the logits of the last
    position, and the cache that :func:`decode_step` continues from.

    Runs where the params are. ``max_len`` (default S) sizes the attention
    rings: ``win = min(attn_window, max_len)``; a prompt of at least ``win``
    positions leaves position p at slot ``p % win``, a shorter one is
    zero-padded to ``win``.
    """
    dev = params["embed"].device
    tokens = tokens.to(dev)
    b, s = tokens.shape
    max_len = max_len or s
    win = min(cfg.attn_window or max_len, max_len)
    rope_cs = _rope(cfg, torch.arange(s, device=dev)[None])
    x = _embed(params, cfg, tokens)
    convs, hs, ks, vs = [], [], [], []
    for kind, lp in _layers(params, cfg):
        if kind == "rec":
            x, tail, h_fin = _rec_mix_prefill(x, lp["mix"], cfg)
            convs.append(tail)
            hs.append(h_fin)
        else:
            x, ck, cv = _attn_mix_prefill(x, lp["mix"], cfg, rope_cs, win)
            ks.append(ck)
            vs.append(cv)
        x = _ffn(x, lp, cfg)
    xf = L.rmsnorm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    logits = L.lm_head(xf, params, cfg)[:, 0]
    cache = GriffinCache(torch.stack(convs).to(BF16), torch.stack(hs).to(F32),
                         torch.stack(ks), torch.stack(vs),
                         torch.tensor(s, dtype=torch.int32, device=dev))
    return logits, cache


def _rec_mix_decode(x, p, cfg: ModelConfig, conv_st, h_st):
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    y = F.gelu(h @ p["w_y"].to(h.dtype), approximate="tanh")
    u = h @ p["w_x"].to(h.dtype)
    u, conv2 = L.causal_conv1d(u, p["conv"].to(u.dtype), conv_st)
    a, b_in = rglru_gates(u, p["rglru"], cfg.rglru_c)
    h_new = a[:, 0] * h_st + b_in[:, 0]
    out = (h_new[:, None].to(x.dtype) * y) @ p["w_out"].to(x.dtype)
    return x + out, conv2, h_new


def _attn_mix_decode(x, p, cfg: ModelConfig, ck, cv, pos, rope_cs):
    """One position against the ring: K/V land at slot ``pos % win`` (in
    place in ``ck``/``cv``), and the query attends over the first
    ``min(pos + 1, win)`` slots."""
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    w = {n: p[n].to(h.dtype) for n in ("wq", "wk", "wv", "wo")}
    q, k, v = _project_qkv(h, w, cfg, rope_cs)
    win = ck.shape[1]
    slot = (pos % win).reshape(1).long()
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    kv_len = torch.clamp_max(pos + 1, win)
    o = L.attention_ref(q, ck, cv, causal=False, kv_len=kv_len)
    return _attn_out(x, o, w["wo"])


def decode_step(params, cfg: ModelConfig, cache: GriffinCache,
                tokens: torch.Tensor) -> tuple[torch.Tensor, GriffinCache]:
    """tokens (B, 1) -> ``(logits (B, V), cache)``. The cache is written
    **in place** (the reference returns a new one) and comes back as the
    same object, its ``pos`` advanced by one."""
    dev = params["embed"].device
    tokens = tokens.to(dev)
    pos = cache.pos
    rope_cs = _rope(cfg, pos.reshape(1, 1))
    x = _embed(params, cfg, tokens)
    ri = ai = 0
    for kind, lp in _layers(params, cfg):
        if kind == "rec":
            x, conv2, h2 = _rec_mix_decode(x, lp["mix"], cfg, cache.conv[ri],
                                           cache.h[ri])
            cache.conv[ri].copy_(conv2)
            cache.h[ri].copy_(h2)
            ri += 1
        else:
            x = _attn_mix_decode(x, lp["mix"], cfg, cache.k[ai], cache.v[ai],
                                 pos, rope_cs)
            ai += 1
        x = _ffn(x, lp, cfg)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = L.lm_head(x, params, cfg)[:, 0]
    cache.pos = pos + 1
    return logits, cache
