"""Family dispatch for the port (port of ``src/repro/models/registry.py``).

Every family of the reference is ported: the dense, MoE, audio and VLM
families (the decoder-only transformer), the hybrid family (Griffin) and
the SSM family (Mamba-2). The serve driver's ``prefill`` / ``decode_step``
/ ``cache_init`` serve them all; the audio and VLM families' stubbed front
ends (``embed_inputs=False``, :func:`uses_token_inputs`) prefill from
``embeds`` and decode tokens. The engine serves every family: the dense,
audio and VLM families on its paged backend (``decode_step_paged``) or on
lanes, the MoE, hybrid and SSM families on lanes only (``supports_paged``
is False for them), through ``decode_step`` over a lane cache
(``cache_init(..., lanes=True)``, :func:`lane_read`, :func:`lane_write`).
Training (``forward``) runs every family but MoE, which raises naming its
ROADMAP item.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import griffin, mamba2, transformer
from repro_torch.models.config import ModelConfig

_TRANSFORMER_FAMILIES = ("dense", "moe", "audio", "vlm")

# every family: (model module, its decode cache class)
_FAMILIES = {**{f: (transformer, transformer.KVCache)
                for f in _TRANSFORMER_FAMILIES},
             "hybrid": (griffin, griffin.GriffinCache),
             "ssm": (mamba2, mamba2.SSMCache)}


def _family(cfg: ModelConfig):
    """``(model module, cache class)`` of ``cfg``'s family."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    return _FAMILIES[cfg.family]


def _mod(cfg: ModelConfig):
    return _family(cfg)[0]


def decls(cfg: ModelConfig):
    """Parameter declaration tree of ``cfg``."""
    return _mod(cfg).decls(cfg)


# the families the training forward does not run yet, and the ROADMAP.md
# items ("Still to port") that bring them
_LATER_TRAIN = {
    "moe": "MoE training, after tensor parallelism (one grok-1 layer's "
           "experts with AdamW's state take 77 GB)",
}


def forward(params, cfg: ModelConfig, tokens=None, embeds=None,
            positions=None):
    """Training forward ``(logits, aux)`` from ``tokens`` (B, S) or
    ``embeds`` (B, S, d_model); see :func:`transformer.forward`,
    :func:`griffin.forward` and :func:`mamba2.forward`. Every family but
    MoE, which raises ``NotImplementedError`` naming its ROADMAP item."""
    if cfg.family in _LATER_TRAIN:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the training forward is not yet "
            f"ported for this family (ROADMAP.md, still to port: "
            f"{_LATER_TRAIN[cfg.family]})")
    return _mod(cfg).forward(params, cfg, tokens=tokens, positions=positions,
                             embeds=embeds)


def uses_token_inputs(cfg: ModelConfig) -> bool:
    """False for the modality stubs (audio, VLM) whose train and prefill
    inputs are embeddings (``embed_inputs=False``)."""
    return cfg.embed_inputs


def stacked(cfg: ModelConfig) -> tuple[str, int]:
    """``(key, n)``: the params entry whose leaves are stacked along a
    leading layer axis, and that axis' length (``blocks`` of superblocks;
    griffin's ``triples``; mamba2's ``blocks`` of layers). A trainer gives
    each entry of it its own leaves (see :func:`transformer.superblocks`)."""
    if cfg.family == "hybrid":
        return "triples", griffin.plan(cfg)[0]
    if cfg.family == "ssm":
        return "blocks", cfg.n_layers
    return "blocks", cfg.n_layers // transformer._interleave(cfg)


def true_fan_in(params, cfg: ModelConfig):
    """``params`` with the attention projections rescaled to their true
    fan-in (:func:`transformer.true_fan_in`, :func:`griffin.true_fan_in`).
    The SSM family has no attention projections: its params come back as
    they are."""
    if cfg.family == "ssm":
        return params
    return _mod(cfg).true_fan_in(params, cfg)


def prefill(params, cfg: ModelConfig, tokens=None, embeds=None, max_len=None):
    """Batched prefill ``(logits of the last position, cache)`` from
    ``tokens`` (B, S) or ``embeds`` (B, S, d_model); see
    :func:`transformer.prefill`, :func:`griffin.prefill` and
    :func:`mamba2.prefill`."""
    return _mod(cfg).prefill(params, cfg, tokens=tokens, embeds=embeds,
                             max_len=max_len)


def decode_step(params, cfg: ModelConfig, cache, tokens, keep=None):
    """One token per lane ``(logits, cache)``, the cache written in place;
    see :func:`transformer.decode_step`, :func:`griffin.decode_step` and
    :func:`mamba2.decode_step`. ``keep`` (B,) bool masks lanes of a lane
    cache out: their state stays bit for bit as it was."""
    return _mod(cfg).decode_step(params, cfg, cache, tokens, keep=keep)


def cache_init(cfg: ModelConfig, batch: int, max_len: int, device=None,
               lanes: bool = False):
    """A zeroed decode cache on ``device`` (``None`` is the card).

    With ``lanes`` it is the lane engine's cache: ``batch`` lanes, each a
    copy of the family's batch-1 cache (its values, not assumed zero), and
    a position a lane (``pos`` (batch,)), so that :func:`decode_step`
    decodes every lane as a batch-1 model of its own. Every cache class
    keeps the batch on axis 1 of its state tensors and ``pos`` last."""
    cls = _family(cfg)[1]
    if not lanes:
        return cls.init(cfg, batch, max_len, device=device)
    one = cls.init(cfg, 1, max_len, device=device)
    return type(one)(**{
        f.name: (getattr(one, f.name).reshape(1).repeat(batch)
                 if f.name == "pos" else
                 getattr(one, f.name).repeat_interleave(batch, dim=1))
        for f in dataclasses.fields(one)})


def lane_read(cache, i: int):
    """Lane ``i`` of a lane cache as a batch-1 cache of its own: a copy
    (every tensor cloned, ``pos`` 0-d), which later in-place steps on the
    lane cache leave as it is. The engine publishes it as a prefix page's
    snapshot."""
    return type(cache)(**{
        f.name: (getattr(cache, f.name)[i] if f.name == "pos" else
                 getattr(cache, f.name)[:, i:i + 1]).clone()
        for f in dataclasses.fields(cache)})


def lane_write(cache, i: int, one) -> None:
    """Copy the batch-1 cache ``one`` (the family's initial cache, or a
    :func:`lane_read` snapshot) into lane ``i`` of a lane cache, in place;
    ``one`` is left as it is."""
    for f in dataclasses.fields(cache):
        dst, src = getattr(cache, f.name), getattr(one, f.name)
        if f.name == "pos":
            dst[i] = src.reshape(())
        else:
            dst[:, i:i + 1].copy_(src)


def cache_bytes(cache) -> int:
    """Bytes of a cache's tensors (a lane snapshot's size)."""
    return sum(t.numel() * t.element_size()
               for t in (getattr(cache, f.name)
                         for f in dataclasses.fields(cache))
               if isinstance(t, torch.Tensor))


def supports_paged(cfg: ModelConfig) -> bool:
    """True when ``cfg`` can decode against a global KV page pool
    (transformer families only)."""
    return _mod(cfg) is transformer and transformer.supports_paged(cfg)


def _require_paged(cfg: ModelConfig) -> None:
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name} ({cfg.family}) has no paged KV decode")


def paged_pool_init(cfg: ModelConfig, n_pages: int, page_size: int,
                    device=None):
    """Zeroed bf16 (k, v) page pool of (L, n_pages, page_size, Kh, Dh)."""
    _require_paged(cfg)
    return transformer.paged_pool_init(cfg, n_pages, page_size, device=device)


def decode_step_paged(params, cfg: ModelConfig, pool_k, pool_v, tables,
                      lengths, tokens, append_mask=None, window=None):
    """One paged decode step; see :func:`transformer.decode_step_paged`."""
    _require_paged(cfg)
    return transformer.decode_step_paged(params, cfg, pool_k, pool_v, tables,
                                         lengths, tokens,
                                         append_mask=append_mask,
                                         window=window)
