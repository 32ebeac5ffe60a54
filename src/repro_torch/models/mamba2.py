"""Mamba-2 (state-space duality, arXiv:2405.21060): training and serving.

Port of ``src/repro/models/mamba2.py``: the parameter declarations, the
training :func:`forward`, :class:`SSMCache`, :func:`prefill` and
:func:`decode_step`. The parameter tree keeps
the reference's layout (``blocks`` stacked along a leading layer axis), so
weights map one to one; the reference's ``lax.scan`` over the layers is a
Python loop here.

Every multi-token SSD scan dispatches op ``"ssd"`` through the XAIF
registry under ``cfg.scan_impl`` (:func:`repro_torch.models.layers.
impl_key`: the reference's three backend names are the port's one,
``"cuda"``, :func:`repro_torch.kernels.ssd.ops.ssd`, the CUDA chunk-scan
kernels on the card, forward and backward). The one-token decode step
needs no kernel: its recurrence is one multiply-add of the state, as in
the reference.

The reference's dtype boundaries are kept: activations are bfloat16
whatever ``cfg.dtype`` is (the embedding is gathered from a bf16 cast of
the table; ``embeds`` (B, S, d_model), which the training forward and
the prefill take in place of tokens, keep their own dtype), dt, dA and the
scan run in float32, the conv tails are bf16 and the states float32. State per layer is heads x head_dim x state, so a
decode step costs the same at any context length.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import torch

from repro_torch import device as device_mod
from repro_torch.core.xaif import REGISTRY
from repro_torch.kernels.moe import ref as moe_ref
# imported for its XAIF registration under "cuda"
from repro_torch.kernels.ssd import ops as _ssd_ops  # noqa: F401
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.griffin import _softplus
from repro_torch.models.transformer import advance, remat, superblocks
from repro_torch.sharding import axes as lx
from repro_torch.sharding.params import Axes, ParamDecl, stack_tree, tree_map

F32 = torch.float32
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------


def _layer_decls(cfg: ModelConfig) -> dict[str, Any]:
    d, di, h, n, w = (cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state,
                      cfg.ssm_conv_width)
    return {
        "ln": L.rmsnorm_decl(d),
        "w_z": ParamDecl((d, di), Axes(lx.EMBED, lx.RNN_WIDTH), init="fan_in"),
        "w_x": ParamDecl((d, di), Axes(lx.EMBED, lx.RNN_WIDTH), init="fan_in"),
        "w_B": ParamDecl((d, n), Axes(lx.EMBED, lx.STATE), init="fan_in"),
        "w_C": ParamDecl((d, n), Axes(lx.EMBED, lx.STATE), init="fan_in"),
        "w_dt": ParamDecl((d, h), Axes(lx.EMBED, lx.HEADS), init="fan_in"),
        "conv_x": L.conv1d_decl(w, di),
        "conv_B": ParamDecl((w, n), Axes(lx.CONV, lx.STATE), init="fan_in"),
        "conv_C": ParamDecl((w, n), Axes(lx.CONV, lx.STATE), init="fan_in"),
        "A_log": ParamDecl((h,), Axes(lx.HEADS), init="zeros"),
        "D": ParamDecl((h,), Axes(lx.HEADS), init="ones"),
        "dt_bias": ParamDecl((h,), Axes(lx.HEADS), init="zeros"),
        "ln_gate": ParamDecl((di,), Axes(lx.RNN_WIDTH), init="ones"),
        "w_out": ParamDecl((di, d), Axes(lx.RNN_WIDTH, lx.EMBED),
                           init="fan_in"),
    }


def decls(cfg: ModelConfig) -> dict[str, Any]:
    """The parameter declaration tree (the reference's layout)."""
    tree: dict[str, Any] = {
        "embed": L.embed_decl(cfg),
        "blocks": stack_tree(_layer_decls(cfg), cfg.n_layers, lx.LAYERS),
        "ln_f": L.rmsnorm_decl(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        tree["head"] = L.head_decl(cfg)
    return tree


def _layers(params, cfg: ModelConfig) -> Iterator[dict]:
    for i in range(cfg.n_layers):
        yield tree_map(lambda a, i=i: a[i], params["blocks"])


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SSMCache:
    """Decode state: per layer the conv tails of x, B and C (the last w-1
    inputs of each depthwise conv) and the SSD state."""

    conv_x: torch.Tensor   # (L, B, w-1, d_inner) bf16
    conv_B: torch.Tensor   # (L, B, w-1, n) bf16
    conv_C: torch.Tensor   # (L, B, w-1, n) bf16
    state: torch.Tensor    # (L, B, H, P, N) float32
    pos: torch.Tensor      # () or (B,) int32: positions consumed so far

    @staticmethod
    def shapes(cfg: ModelConfig, batch: int):
        """Shapes of ``conv_x``, ``conv_B``/``conv_C`` and ``state``."""
        w = cfg.ssm_conv_width
        return ((cfg.n_layers, batch, w - 1, cfg.d_inner),
                (cfg.n_layers, batch, w - 1, cfg.ssm_state),
                (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                 cfg.ssm_state))

    @staticmethod
    def init(cfg: ModelConfig, batch: int, max_len: int | None = None,
             device=None) -> "SSMCache":
        """A zeroed cache on ``device`` (``None`` is the card). ``max_len``
        is accepted for the registry's common signature: the state does not
        grow with the context."""
        dev = device_mod.resolve(device)
        s_x, s_bc, s_st = SSMCache.shapes(cfg, batch)
        return SSMCache(torch.zeros(s_x, dtype=BF16, device=dev),
                        torch.zeros(s_bc, dtype=BF16, device=dev),
                        torch.zeros(s_bc, dtype=BF16, device=dev),
                        torch.zeros(s_st, dtype=F32, device=dev),
                        torch.zeros((), dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _embed(params, tokens: torch.Tensor | None,
           embeds: torch.Tensor | None = None) -> torch.Tensor:
    if embeds is not None:
        return embeds.to(params["embed"].device)
    # gathered, then cast: the same values as the reference's gather from a
    # bf16 cast of the table, whatever the params' dtype
    return params["embed"][tokens.to(params["embed"].device)].to(BF16)


_silu = moe_ref.silu   # jax.nn.silu as XLA rounds it in bf16


def _mix(x, lp, cfg: ModelConfig):
    """The shared projections: ``(z, x_in, B_raw, C_raw, dt_raw)``."""
    h = L.rmsnorm(x, lp["ln"], cfg.norm_eps)
    return tuple(h @ lp[k].to(h.dtype)
                 for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _ssm_math(xin, Braw, Craw, dt_raw, lp, cfg: ModelConfig):
    """``(xh, xs, dA, Bh, Ch)``: the heads of x, x scaled by dt (float32),
    dA = dt A (float32), and B and C broadcast over the heads (an
    ``expand``: stride 0, no copy)."""
    b, s = xin.shape[:2]
    hn, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    dt = _softplus(dt_raw.to(F32) + lp["dt_bias"].to(F32))          # (b,s,h)
    A = -torch.exp(lp["A_log"].to(F32))                              # (h,)
    dA = dt * A
    xh = xin.reshape(b, s, hn, p)
    xs = xh.to(F32) * dt[..., None]
    Bh = Braw[:, :, None, :].expand(b, s, hn, n)
    Ch = Craw[:, :, None, :].expand(b, s, hn, n)
    return xh, xs, dA, Bh, Ch


def _out(x, y, xh, z, lp, cfg: ModelConfig):
    """The skip term ``D x``, the gated norm and the out projection."""
    y = y + xh.to(F32) * lp["D"].to(F32)[None, None, :, None]
    y = y.reshape(*x.shape[:2], cfg.d_inner)
    # the gated product enters the norm in float32: XLA compiles the
    # reference's bf16 product and the norm's cast to float32 into one
    # fusion and drops the bf16 rounding between them (its default excess
    # precision); rounding there parts from it by a bf16 ulp in a quarter
    # of the values
    gated = y.to(x.dtype).to(F32) * _silu(z).to(F32)
    y = L.rmsnorm(gated, lp["ln_gate"], cfg.norm_eps).to(x.dtype)
    return x + y @ lp["w_out"].to(y.dtype)


def _convs(xin, Braw, Craw, lp, tails=(None, None, None)):
    """The three depthwise causal convs after SiLU: ``(outputs, tails)``,
    each tail the last w-1 rows of ``[previous tail or zeros, input]``."""
    outs = [L.causal_conv1d(_silu(u), lp[k].to(u.dtype), t)
            for u, k, t in zip((xin, Braw, Craw),
                               ("conv_x", "conv_B", "conv_C"), tails)]
    return [o for o, _ in outs], [t for _, t in outs]


def _block_train(x, lp, cfg: ModelConfig):
    z, xin, Braw, Craw, dt_raw = _mix(x, lp, cfg)
    (xin, Braw, Craw), _ = _convs(xin, Braw, Craw, lp)
    xh, xs, dA, Bh, Ch = _ssm_math(xin, Braw, Craw, dt_raw, lp, cfg)
    y, _ = REGISTRY.dispatch(
        "ssd", L.impl_key(cfg.scan_impl), xs, dA, Bh, Ch, chunk=cfg.ssm_chunk,
        compute_dtype=getattr(torch, cfg.ssm_compute_dtype))
    return _out(x, y, xh, z, lp, cfg)


def forward(params, cfg: ModelConfig, tokens=None, positions=None,
            embeds=None):
    """Training forward: tokens (B, S) or embeds (B, S, d_model) ->
    ``(logits (B, S, V), aux = 0)`` (``src/repro/models/mamba2.py:261-271``).

    Runs where the params are, in bf16 activations. Each layer runs under
    ``cfg.remat`` (:func:`repro_torch.models.transformer.remat`). Unlike
    :func:`prefill`, it passes ``cfg.ssm_compute_dtype`` to the scan, as
    only the reference's ``forward`` does; the scan takes float32 only and
    raises for bfloat16. ``params["blocks"]`` may be
    stacked or a list of per-layer trees. ``positions`` is accepted for the
    registry's common signature (the SSM has no positional encoding).
    """
    del positions
    dev = params["embed"].device
    x = _embed(params, tokens, embeds)
    for lp in superblocks(params["blocks"], cfg.n_layers):
        x = remat(_block_train, cfg, x, lp, cfg)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return L.lm_head(x, params, cfg), torch.zeros((), device=dev)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None,
            max_len: int | None = None) -> tuple[torch.Tensor, SSMCache]:
    """tokens (B, S) or embeds (B, S, d_model) -> ``(logits (B, V),
    cache)``: the logits of the last position, and the cache that
    :func:`decode_step` continues from.

    Runs where the params are; ``max_len`` is not needed (the state does
    not grow). The conv tails are the last w-1 rows of ``[zeros, input]``,
    so a prompt shorter than w-1 keeps the zero history
    :meth:`SSMCache.init` starts from (the reference slices the input
    itself, which is too short there, and its next decode step fails).
    """
    del max_len
    dev = params["embed"].device
    x = _embed(params, tokens, embeds)
    s = x.shape[1]
    tails, states = ([], [], []), []
    for lp in _layers(params, cfg):
        z, xin, Braw, Craw, dt_raw = _mix(x, lp, cfg)
        (xin, Braw, Craw), layer_tails = _convs(xin, Braw, Craw, lp)
        for acc, t in zip(tails, layer_tails):
            acc.append(t.clone())        # a view would keep the input alive
        xh, xs, dA, Bh, Ch = _ssm_math(xin, Braw, Craw, dt_raw, lp, cfg)
        y, st = REGISTRY.dispatch("ssd", L.impl_key(cfg.scan_impl), xs, dA, Bh,
                                  Ch, chunk=cfg.ssm_chunk)
        states.append(st)
        x = _out(x, y, xh, z, lp, cfg)
    xf = L.rmsnorm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    logits = L.lm_head(xf, params, cfg)[:, 0]
    cache = SSMCache(*(torch.stack(t) for t in tails), torch.stack(states),
                     torch.tensor(s, dtype=torch.int32, device=dev))
    return logits, cache


def decode_step(params, cfg: ModelConfig, cache: SSMCache,
                tokens: torch.Tensor, keep: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, SSMCache]:
    """tokens (B, 1) -> ``(logits (B, V), cache)``. The cache is written
    **in place** (the reference returns a new one) and comes back as the
    same object, its ``pos`` advanced by one. ``keep`` (B,) bool, with a
    lane cache (``pos`` (B,)), masks lanes out: their conv tails, SSD state
    and ``pos`` stay bit for bit as they were (see
    :func:`repro_torch.models.transformer.decode_step`)."""
    new_pos = advance(cache.pos, keep)
    x = _embed(params, tokens)
    for li, lp in enumerate(_layers(params, cfg)):
        z, xin, Braw, Craw, dt_raw = _mix(x, lp, cfg)
        conv = (cache.conv_x[li], cache.conv_B[li], cache.conv_C[li])
        (xin, Braw, Craw), new_tails = _convs(xin, Braw, Craw, lp, conv)
        xh, xs, dA, Bh, Ch = _ssm_math(xin, Braw, Craw, dt_raw, lp, cfg)
        # the one-step recurrence
        st = cache.state[li]
        if keep is None:
            st.mul_(torch.exp(dA[:, 0])[..., None, None])
            st.add_(torch.einsum("bhp,bhn->bhpn", xs[:, 0], Bh[:, 0].to(F32)))
            new_st = st
        else:
            new_st = (st * torch.exp(dA[:, 0])[..., None, None]
                      + torch.einsum("bhp,bhn->bhpn", xs[:, 0],
                                     Bh[:, 0].to(F32)))
        y = torch.einsum("bhpn,bhn->bhp", new_st, Ch[:, 0].to(F32))[:, None]
        if keep is not None:
            st.copy_(L.keep_lanes(keep, new_st, st))
        for dst, src in zip(conv, new_tails):
            dst.copy_(L.keep_lanes(keep, src, dst))
        x = _out(x, y, xh, z, lp, cfg)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = L.lm_head(x, params, cfg)[:, 0]
    cache.pos = new_pos
    return logits, cache
