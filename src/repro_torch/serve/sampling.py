"""Greedy decoding for the port's serving engine.

Port of the greedy part of ``src/repro/serve/sampling.py``:
:class:`SamplingParams` and :data:`GREEDY` as in the reference, and
:func:`greedy`, the argmax over the (masked, padded) vocabulary that takes
the first maximal index on a tie, as ``jnp.argmax`` does. Stochastic
sampling with threefry-exact keys is a later slice: a request with
``temperature > 0`` raises ``NotImplementedError`` (:func:`require_greedy`).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["GREEDY", "SamplingParams", "greedy", "require_greedy"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls (the reference's fields and checks).

    ``temperature == 0`` is exact greedy decode, the only mode the port
    serves so far.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError("temperature cannot be negative")
        if self.top_k < 0:
            raise ValueError("top_k cannot be negative")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.seed < 0:
            raise ValueError("seed cannot be negative")

    @property
    def greedy(self) -> bool:
        """True when this is the zero-temperature (argmax) degenerate."""
        return self.temperature == 0.0


GREEDY = SamplingParams()


def require_greedy(params: SamplingParams | None) -> None:
    """Raise ``NotImplementedError`` for sampled (temperature > 0) decode."""
    if params is not None and not params.greedy:
        raise NotImplementedError(
            "sampled decoding (temperature > 0) is not yet ported")


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis as int32; the first maximal index wins a
    tie (``torch.argmax`` documents this, as ``jnp.argmax`` does)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
