"""Family dispatch for the port (port of ``src/repro/models/registry.py``).

The dense and audio families (the decoder-only transformer) are ported;
every other family raises ``NotImplementedError`` until its slice lands.
"""

from __future__ import annotations

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

_PORTED_FAMILIES = ("dense", "audio")


def _mod(cfg: ModelConfig):
    if cfg.family in _PORTED_FAMILIES:
        return transformer
    raise NotImplementedError(f"{cfg.name} ({cfg.family}): not yet ported")


def decls(cfg: ModelConfig):
    """Parameter declaration tree of ``cfg``."""
    return _mod(cfg).decls(cfg)


def forward(params, cfg: ModelConfig, tokens, positions=None, embeds=None):
    """Training forward ``(logits, aux)``; see :func:`transformer.forward`.
    Dense family only: the audio family's ``embeds`` inputs are not yet
    ported."""
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): training "
                                  f"forward not yet ported")
    return transformer.forward(params, cfg, tokens, positions=positions,
                               embeds=embeds)


def supports_paged(cfg: ModelConfig) -> bool:
    """True when ``cfg`` can decode against a global KV page pool."""
    return _mod(cfg).supports_paged(cfg)


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
