"""Family dispatch for the port (port of ``src/repro/models/registry.py``).

The dense and audio families (the decoder-only transformer), the hybrid
family (Griffin) and the SSM family (Mamba-2) are ported; every other
family raises ``NotImplementedError`` until its slice lands. The serve
driver's ``prefill`` / ``decode_step`` / ``cache_init`` serve the hybrid
and SSM families; the transformer families serve through the paged engine,
and their lane-backend prefill and decode are later slices (ROADMAP.md).
"""

from __future__ import annotations

from repro_torch.models import griffin, mamba2, transformer
from repro_torch.models.config import ModelConfig

_PORTED_FAMILIES = ("dense", "audio")

# the families the serve driver runs: (model module, its cache class)
_SERVE = {"hybrid": (griffin, griffin.GriffinCache),
          "ssm": (mamba2, mamba2.SSMCache)}

# the ROADMAP.md items ("Still to port") that bring each family's serve
# driver path, for the error a caller sees
_LATER_SERVE = {
    "dense": "the transformer families' serve-driver prefill and decode",
    "audio": "embeds inputs and the transformer families' serve-driver "
             "prefill and decode",
    "vlm": "embeds inputs and the transformer families' serve-driver "
           "prefill and decode",
    "moe": "the MoE family",
}


def _mod(cfg: ModelConfig):
    if cfg.family in _PORTED_FAMILIES:
        return transformer
    if cfg.family in _SERVE:
        return _SERVE[cfg.family][0]
    raise NotImplementedError(f"{cfg.name} ({cfg.family}): not yet ported")


def decls(cfg: ModelConfig):
    """Parameter declaration tree of ``cfg``."""
    return _mod(cfg).decls(cfg)


def forward(params, cfg: ModelConfig, tokens, positions=None, embeds=None):
    """Training forward ``(logits, aux)``; see :func:`transformer.forward`.
    Dense family only: the audio family's ``embeds`` inputs and the hybrid
    and SSM families' training are not yet ported."""
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): training "
                                  f"forward not yet ported")
    return transformer.forward(params, cfg, tokens, positions=positions,
                               embeds=embeds)


def _serve(cfg: ModelConfig, what: str):
    """``(module, cache class)`` of ``cfg``'s family on the serve driver;
    raises ``NotImplementedError`` naming the ROADMAP item otherwise."""
    if cfg.family not in _SERVE:
        later = _LATER_SERVE.get(cfg.family, "not yet planned")
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): {what} of the serve driver is not "
            f"yet ported for this family (ROADMAP.md, still to port: "
            f"{later})")
    return _SERVE[cfg.family]


def prefill(params, cfg: ModelConfig, tokens, max_len=None):
    """Batched prefill ``(logits of the last position, cache)``; see
    :func:`griffin.prefill` and :func:`mamba2.prefill`. Hybrid and SSM
    families."""
    return _serve(cfg, "prefill")[0].prefill(params, cfg, tokens,
                                             max_len=max_len)


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """One token per lane ``(logits, cache)``, the cache written in place;
    see :func:`griffin.decode_step` and :func:`mamba2.decode_step`. Hybrid
    and SSM families."""
    return _serve(cfg, "decode_step")[0].decode_step(params, cfg, cache,
                                                     tokens)


def cache_init(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """A zeroed decode cache on ``device`` (``None`` is the card). Hybrid
    and SSM families."""
    return _serve(cfg, "cache_init")[1].init(cfg, batch, max_len,
                                             device=device)


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
