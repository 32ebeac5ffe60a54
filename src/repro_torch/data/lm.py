"""Deterministic synthetic LM data pipeline.

Port of ``src/repro/data/lm.py``. Stateless and step-indexed: ``batch_at(step)``
is a pure function of ``(seed, step)`` and the shape, drawn from a
``torch.Generator`` on the CPU, so a restarted job resumes on the same
batches. The structure is the reference's: even positions are Zipf-ish
draws ``floor(exp(0.9 log u) * vocab)``, odd positions ``(even * 7 + 13) %
vocab`` (a model that learns the bigram halves the loss), and ``labels``
are the tokens shifted by one. The bits differ from the reference's
threefry draws: tests that compare the two packages feed both the same
numpy batches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    seq: int
    global_batch: int
    accum: int = 1
    seed: int = 0


class LMPipeline:
    def __init__(self, cfg: LMDataConfig):
        if cfg.global_batch % cfg.accum:
            raise ValueError(f"global batch {cfg.global_batch} is not a "
                             f"multiple of accum {cfg.accum}")
        self.cfg = cfg

    def _generator(self, step: int) -> torch.Generator:
        # the CPU generator keeps 32 bits of its seed: mix (seed, step) into
        # one 32-bit word
        word = np.random.SeedSequence([self.cfg.seed, step]).generate_state(1)
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(word[0]))
        return gen

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        """``{"tokens", "labels"}`` int64 of shape (accum, microbatch, seq)
        on the CPU."""
        c = self.cfg
        mb = c.global_batch // c.accum
        gen = self._generator(step)
        n = c.seq + 1
        half = (n + 1) // 2
        u = torch.rand((c.accum, mb, half), generator=gen)
        u = 1e-6 + (1.0 - 1e-6) * u                      # uniform in [1e-6, 1)
        ranks = torch.floor(torch.exp(torch.log(u) * 0.9) * c.vocab)
        evens = ranks.long().clamp(0, c.vocab - 1)
        odds = (evens * 7 + 13) % c.vocab
        toks = torch.stack([evens, odds], dim=-1).reshape(c.accum, mb, 2 * half)
        toks = toks[..., :n]
        return {"tokens": toks[..., :-1].contiguous(),
                "labels": toks[..., 1:].contiguous()}
