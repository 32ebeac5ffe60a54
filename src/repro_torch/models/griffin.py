"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427): RG-LRU + local attention.

Port of ``src/repro/models/griffin.py``: the parameter declarations, the
training :func:`forward`, :class:`GriffinCache`, :func:`prefill` and
:func:`decode_step`. The layer
pattern is (rec, rec, attn) repeating: RecurrentGemma-2B's 26 layers are 8
triples and a (rec, rec) tail. The parameter tree keeps the reference's
layout (``triples`` stacked along a leading axis, ``tail`` per layer), so
weights map one to one; the reference's ``lax.scan`` over the triples is a
Python loop here.

Every RG-LRU scan goes through :func:`linear_scan`, which dispatches op
``"rglru"`` through the XAIF registry under ``cfg.scan_impl``
(``"cuda"``: :func:`repro_torch.kernels.rglru.ops.rglru`, the CUDA
kernels on the card, forward and backward), and every multi-token
attention call through :func:`repro_torch.models.layers.attention` under
``cfg.attn_impl`` (the CUDA flash forward and backward). The
one-token decode step needs neither: its recurrence is one multiply-add,
and its attention over the ring cache is :func:`layers.attention_ref`
(plain PyTorch), as the reference computes it with ``attention_chunked``,
not with a Pallas kernel.

The reference's dtype boundaries are kept: activations are bfloat16
whatever ``cfg.dtype`` is (the embedding is gathered from a bf16 cast of
the table), the Gemma scaling multiplies by ``sqrt(d_model)`` rounded to
bf16, the gates run in float32, and the recurrent state is float32. The
training forward and the prefill also take ``embeds`` (B, S, d_model) in
place of tokens (``src/repro/models/griffin.py:309-313,368-373``): the
activations then take the embeddings' dtype, and the scaling is rounded
to it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import torch
import torch.nn.functional as F

from repro_torch import device as device_mod
from repro_torch.core.xaif import REGISTRY
# imported for its XAIF registration under "cuda"
from repro_torch.kernels.rglru import ops as _rglru_ops  # noqa: F401
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (_attn_decls, _attn_out, _ffn,
                                           _project_qkv, _rope, advance,
                                           cache_tail, decode_attend, remat,
                                           rescale_attention, superblocks)
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
                h0: torch.Tensor | None = None, *, impl: str = "cuda"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t h_{t-1} + b_t`` over (B,S,W): ``(y, h_final)``, op
    ``"rglru"`` dispatched under :func:`layers.impl_key` of ``impl`` (the
    reference's three backend names are the port's one, ``"cuda"``:
    :func:`repro_torch.kernels.rglru.ops.rglru`)."""
    return REGISTRY.dispatch("rglru", L.impl_key(impl), a, b, h0)


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
    pos: torch.Tensor    # () or (B,) int32: positions consumed so far

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


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor | None,
           embeds: torch.Tensor | None = None) -> torch.Tensor:
    if embeds is None:
        # gathered, then cast: the same values as the reference's gather
        # from a bf16 cast of the table, whatever cfg.dtype is
        x = params["embed"][tokens.to(params["embed"].device)].to(BF16)
    else:
        x = embeds.to(params["embed"].device)
    # gemma-style scaling by sqrt(d_model) rounded to x's dtype, as the
    # reference's jnp.asarray(sqrt(d), x.dtype) (a Python float would not be)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)


def _rec_mix(x, p, cfg: ModelConfig):
    """The recurrent mix over a whole sequence (training and prefill):
    ``(x + out, conv tail, h_final)``. The conv tail is the last w-1 rows
    of [zeros, u], so a prompt shorter than w-1 keeps the zero history
    GriffinCache.init starts from (the reference slices u itself and then
    fails to decode)."""
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    y = F.gelu(h @ p["w_y"].to(h.dtype), approximate="tanh")
    u = h @ p["w_x"].to(h.dtype)
    u, tail = L.causal_conv1d(u, p["conv"].to(u.dtype))
    a, b_in = rglru_gates(u, p["rglru"], cfg.rglru_c)
    ys, h_fin = linear_scan(a, b_in, impl=cfg.scan_impl)
    out = (ys.to(x.dtype) * y) @ p["w_out"].to(x.dtype)
    return x + out, tail, h_fin


def _rec_mix_prefill(x, p, cfg: ModelConfig):
    x, tail, h_fin = _rec_mix(x, p, cfg)
    return x, tail.clone(), h_fin    # a view would keep all of u alive


def _attn_mix(x, p, cfg: ModelConfig, rope_cs):
    """The local-attention mix over a whole sequence: ``(x + out, k, v)``."""
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    w = {n: p[n].to(h.dtype) for n in ("wq", "wk", "wv", "wo")}
    q, k, v = _project_qkv(h, w, cfg, rope_cs)
    o = L.attention(q, k, v, causal=True, window=cfg.attn_window,
                    impl=cfg.attn_impl)
    return _attn_out(x, o, w["wo"]), k, v


def _attn_mix_prefill(x, p, cfg: ModelConfig, rope_cs, win: int):
    x, k, v = _attn_mix(x, p, cfg, rope_cs)
    ck, cv = cache_tail(k, v, win, BF16)   # position p at ring slot p % win
    return x, ck, cv


def _layer_train(x, lp, kind: str, cfg: ModelConfig, rope_cs):
    mix = _rec_mix(x, lp["mix"], cfg) if kind == "rec" else \
        _attn_mix(x, lp["mix"], cfg, rope_cs)
    return _ffn(mix[0], lp, cfg)


def _triple_train(x, tp, cfg: ModelConfig, rope_cs):
    for j, kind in enumerate(_block(cfg)):
        x = _layer_train(x, tp[f"p{j}_{kind}"], kind, cfg, rope_cs)
    return x


def forward(params, cfg: ModelConfig, tokens=None, positions=None,
            embeds=None):
    """Training forward: tokens (B, S) or embeds (B, S, d_model) ->
    ``(logits (B, S, V), aux = 0)`` (``src/repro/models/griffin.py:309-329``).

    Runs where the params are, in bf16 activations whatever ``cfg.dtype``
    is, after gemma's sqrt(d_model) scaling. Each pattern triple runs under
    ``cfg.remat`` (:func:`repro_torch.models.transformer.remat`), the tail
    layers outside it, as the reference's ``lax.scan`` over the triples and
    its loop over the tail do. ``params["triples"]`` may be stacked or a
    list of per-triple trees (:func:`repro_torch.models.transformer.
    superblocks`).
    """
    dev = params["embed"].device
    x = _embed(params, cfg, tokens, embeds)
    if positions is None:
        positions = torch.arange(x.shape[1], device=dev)[None]
    rope_cs = _rope(cfg, positions.to(dev))
    n_full, tail = plan(cfg)
    for tp in superblocks(params["triples"], n_full):
        x = remat(_triple_train, cfg, x, tp, cfg, rope_cs)
    for j, kind in enumerate(tail):
        x = _layer_train(x, params["tail"][f"t{j}_{kind}"], kind, cfg, rope_cs)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return L.lm_head(x, params, cfg), torch.zeros((), device=dev)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None,
            max_len: int | None = None) -> tuple[torch.Tensor, GriffinCache]:
    """tokens (B, S) or embeds (B, S, d_model) -> ``(logits (B, V),
    cache)``: the logits of the last position, and the cache that
    :func:`decode_step` continues from.

    Runs where the params are. ``max_len`` (default S) sizes the attention
    rings: ``win = min(attn_window, max_len)``; a prompt of at least ``win``
    positions leaves position p at slot ``p % win``, a shorter one is
    zero-padded to ``win``.
    """
    dev = params["embed"].device
    x = _embed(params, cfg, tokens, embeds)
    s = x.shape[1]
    max_len = max_len or s
    win = min(cfg.attn_window or max_len, max_len)
    rope_cs = _rope(cfg, torch.arange(s, device=dev)[None])
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


def _attn_mix_decode(x, p, cfg: ModelConfig, ck, cv, pos, rope_cs,
                     keep=None):
    """One position against the ring: K/V land at slot ``pos % win`` (in
    place in ``ck``/``cv``, not for a lane ``keep`` masks out), and the
    query attends over the first ``min(pos + 1, win)`` slots."""
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    w = {n: p[n].to(h.dtype) for n in ("wq", "wk", "wv", "wo")}
    q, k, v = _project_qkv(h, w, cfg, rope_cs)
    return _attn_out(x, decode_attend(q, k, v, ck, cv, pos, keep), w["wo"])


def decode_step(params, cfg: ModelConfig, cache: GriffinCache,
                tokens: torch.Tensor, keep: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, GriffinCache]:
    """tokens (B, 1) -> ``(logits (B, V), cache)``. The cache is written
    **in place** (the reference returns a new one) and comes back as the
    same object, its ``pos`` advanced by one. A lane cache (``pos`` (B,))
    puts each lane at its own position; ``keep`` (B,) bool masks lanes
    out of it, their conv tail, RG-LRU state, ring and ``pos`` left bit for
    bit as they were (see :func:`repro_torch.models.transformer.
    decode_step`)."""
    pos = cache.pos
    new_pos = advance(pos, keep)
    rope_cs = _rope(cfg, pos.reshape(-1, 1))
    x = _embed(params, cfg, tokens)
    ri = ai = 0
    for kind, lp in _layers(params, cfg):
        if kind == "rec":
            conv, h = cache.conv[ri], cache.h[ri]
            x, conv2, h2 = _rec_mix_decode(x, lp["mix"], cfg, conv, h)
            conv.copy_(L.keep_lanes(keep, conv2, conv))
            h.copy_(L.keep_lanes(keep, h2, h))
            ri += 1
        else:
            x = _attn_mix_decode(x, lp["mix"], cfg, cache.k[ai], cache.v[ai],
                                 pos, rope_cs, keep)
            ai += 1
        x = _ffn(x, lp, cfg)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = L.lm_head(x, params, cfg)[:, 0]
    cache.pos = new_pos
    return logits, cache
