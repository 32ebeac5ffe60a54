"""Continuous-batching serving engine on the paged backend (greedy, sync).

Port of ``ContinuousBatchingEngine`` and ``Request`` from
``src/repro/serve/engine.py``, for the slice of the reference that serves a
dense transformer greedily on the paged backend with sync dispatch:

* FIFO admission with ``queue_capacity`` backpressure;
* slot-based batching: one :meth:`~ContinuousBatchingEngine.step` advances
  every occupied slot, prefilling slots feed up to ``prefill_chunk`` prompt
  tokens (clamped to the next page boundary when prefix sharing is on),
  decoding slots one token;
* one global KV page pool with per-slot block tables
  (:mod:`repro_torch.serve.paged`), decoded through the hand-written
  paged-attention kernel on the card;
* prefix sharing through :class:`~repro_torch.serve.pages.PageTable`:
  admission adopts a resident chain by pointing the block table at its
  pages (no copy), and a slot publishes each page its prefill completes.

:func:`build_serve` is the serve driver's one-device prefill and decode
(the reference's ``build_sharded_serve`` without a mesh), which serves the
hybrid and SSM families.

Later slices port the rest of the reference engine: async dispatch, the
lane backend, tensor parallelism, a shared external pool or page table,
fault injection, energy metering, platform banks and interrupts, sampled
requests, dedup claims and mid-flight re-match, sliding-window page
recycling, and preempt/replay with a request journal. Passing a
constructor argument of those features with a non-default value raises
``NotImplementedError``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.serve.paged import PagePool, paged_chunk_fn, paged_step_fn
from repro_torch.serve.pages import PageTable
from repro_torch.serve.sampling import SamplingParams, require_greedy
from repro_torch.sharding.params import tree_leaves

# constructor arguments of the reference engine that later slices port,
# with the value that leaves each feature off (the reference meters energy
# by default; the port has no meter yet, so its default is off)
_LATER_SLICES = {
    "platform": None, "journal": None, "journal_horizon": None,
    "page_table": None, "pool": None, "async_dispatch": False,
    "lane_batch": None, "device_len": None, "admission_hook": None,
    "reclaim": None, "chaos": None, "mesh": None, "tp_axis": "model",
    "metered": False, "operating_point": "max", "gate_idle_banks": True,
}


@dataclasses.dataclass
class Request:
    """One generation request. ``tokens`` is filled in by the engine.

    ``sampling`` ``None`` (or a zero-temperature :class:`SamplingParams`)
    means greedy, the only mode the port serves so far.
    ``first_token_time`` stamps the retire of the first generated token.
    """

    id: str
    prompt: Sequence[int]
    max_new_tokens: int
    on_complete: Callable[["Request"], None] | None = None
    sampling: SamplingParams | None = None
    # engine-written bookkeeping
    tokens: list = dataclasses.field(default_factory=list)
    arrival_time: float | None = None
    admit_time: float | None = None
    first_token_time: float | None = None
    finish_time: float | None = None

    def __post_init__(self):
        self.prompt = tuple(int(t) for t in self.prompt)
        if not self.prompt:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


# ---------------------------------------------------------------------------
# One-device prefill and decode (the serve driver's path)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Serve:
    """The serve driver's two functions for one config, batch and length.

    ``prefill_fn(params, tokens) -> (logits, cache)`` and
    ``decode_fn(params, cache, tokens) -> (logits, cache)``; both run under
    ``torch.inference_mode()``, so no autograd state is kept (the flash
    forward saves nothing for a backward). ``decode_fn`` writes the cache in
    place and returns it.
    """

    prefill_fn: Callable
    decode_fn: Callable
    max_len: int


def build_serve(cfg: ModelConfig, batch: int, max_len: int,
                prefill_len: int | None = None, device=None) -> Serve:
    """Prefill and decode functions of ``cfg`` on one device.

    The one-device counterpart of the reference's ``build_sharded_serve``
    (``src/repro/serve/engine.py:125-200``): no mesh, rules or FSDP (the
    tensor-parallel slice of the port). ``device=None`` is the card and
    raises without one; the params passed to the functions must live there.
    With ``prefill_len`` the prefill checks its tokens are ``(batch,
    prefill_len)``. Families without a serve-driver path raise
    ``NotImplementedError`` from the registry.
    """
    dev = device_mod.resolve(device)
    if batch < 1 or max_len < 1:
        raise ValueError(f"batch {batch} and max_len {max_len} must be >= 1")
    if prefill_len is not None and not 1 <= prefill_len <= max_len:
        raise ValueError(f"prefill_len {prefill_len} must be in [1, "
                         f"max_len {max_len}]")

    def prefill_fn(params, tokens):
        want = (batch, prefill_len or tokens.shape[-1])
        if tuple(tokens.shape) != want:
            raise ValueError(f"prefill tokens {tuple(tokens.shape)}, want "
                             f"{want}")
        with torch.inference_mode():
            return registry.prefill(params, cfg, tokens.to(dev),
                                    max_len=max_len)

    def decode_fn(params, cache, tokens):
        with torch.inference_mode():
            return registry.decode_step(params, cfg, cache, tokens.to(dev))

    return Serve(prefill_fn, decode_fn, max_len)


# ---------------------------------------------------------------------------
# Continuous-batching engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Slot:
    """Host-side state of one decode slot (its device state is the pool
    pages its block table points at)."""

    request: Request
    fed: int = 0             # tokens already consumed (prompt, then generated)
    produced: int = 0        # generated tokens so far
    next_token: int = 0      # token to feed at the next engine step
    page_keys: tuple = ()    # pinned shared-prefix pages (released on evict)
    pages_by_block: dict = dataclasses.field(default_factory=dict)
    blocks_covered: int = 0  # blocks allocated/adopted so far (next to cover)

    @property
    def prefilling(self) -> bool:
        return self.fed < len(self.request.prompt)


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a global KV page pool.

    Each of the ``slots`` decode lanes holds one request. One :meth:`step`
    advances every occupied lane: lanes still consuming their prompt are
    teacher-forced (up to ``prefill_chunk`` tokens), lanes past it decode
    greedily. New requests are admitted into free lanes between steps;
    in-flight lanes never stop. ``page_size`` turns on prefix sharing
    through an engine-private :class:`PageTable` (bounded by
    ``page_capacity`` pages, default ``16 * slots``); without it pages are
    16 tokens and nothing is shared.

    ``device=None`` is the card and raises without one; ``params`` must
    already live on the engine's device. The engine is clock-agnostic:
    ``clock`` is any ``() -> float``.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int, max_len: int,
                 device=None, queue_capacity: int | None = None,
                 clock: Callable[[], float] = lambda: 0.0,
                 pad_token: int = 0, prefill_chunk: int = 1,
                 page_size: int | None = None,
                 page_capacity: int | None = None,
                 paged: bool | None = None, namespace: str = "",
                 name: str | None = None, **later_slices):
        for arg, value in later_slices.items():
            if arg not in _LATER_SLICES:
                raise TypeError(f"unexpected keyword argument {arg!r}")
            if value != _LATER_SLICES[arg]:
                raise NotImplementedError(f"{arg}={value!r}: not yet ported")
        if slots < 1:
            raise ValueError("engine needs at least one decode slot")
        if max_len < 2:
            raise ValueError("max_len must fit a prompt token plus one output")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if paged is False or not registry.supports_paged(cfg):
            raise NotImplementedError(
                f"{cfg.name}: the lane backend is not yet ported")
        if cfg.sliding_window:
            raise NotImplementedError(
                f"{cfg.name}: sliding-window page recycling is not yet ported")
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        for leaf in tree_leaves(params):
            if leaf.device != self.device:
                raise ValueError(f"params live on {leaf.device}, the engine "
                                 f"runs on {self.device}")
        self.params = params
        self.n_slots = slots
        self.max_len = max_len
        self.queue_capacity = queue_capacity
        self.clock = clock
        self.pad_token = pad_token
        self.prefill_chunk = prefill_chunk
        self.namespace = namespace
        self.name = name if name is not None else (namespace or "engine")

        self._ps = page_size or 16
        self._np_slot = -(-max_len // self._ps)
        cap = 0
        if page_size:
            cap = page_capacity if page_capacity is not None else 16 * slots
        self._pool = PagePool(slots * self._np_slot + cap, self._ps)
        self._arena = self._pool.arena(cfg, self.device)
        self.pages: PageTable | None = None
        if page_size:
            self.pages = PageTable(
                page_size,
                capacity_pages=(page_capacity if page_capacity is not None
                                else 16 * slots),
                on_evict=self._pool.release)
        self._pstep = paged_step_fn(cfg)
        self._pchunk = (paged_chunk_fn(cfg, prefill_chunk)
                        if prefill_chunk > 1 else None)

        self.queue: collections.deque[Request] = collections.deque()
        self._ids: set[str] = set()            # every id ever submitted
        self.slots: list[_Slot | None] = [None] * slots

        # throughput counters, monotone by construction
        self.steps = 0                         # engine steps (launches)
        self.token_steps = 0                   # one-token model steps run
        self.tokens_generated = 0
        self.prompt_tokens_processed = 0
        self.prompt_tokens_reused = 0
        self.completed: list[Request] = []
        self.rejected = 0

    # -- admission -----------------------------------------------------------

    def submit(self, request: Request) -> bool:
        """Enqueue a request; False (and counted) when backpressure rejects it."""
        require_greedy(request.sampling)
        if len(request.prompt) + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {request.id!r} needs "
                f"{len(request.prompt) + request.max_new_tokens} positions, "
                f"engine max_len is {self.max_len}")
        if request.id in self._ids:
            raise ValueError(f"duplicate request id {request.id!r}")
        if (self.queue_capacity is not None
                and len(self.queue) >= self.queue_capacity):
            self.rejected += 1
            return False
        if request.arrival_time is None:
            request.arrival_time = self.clock()
        self._ids.add(request.id)
        self.queue.append(request)
        return True

    def _admit(self) -> None:
        free = [i for i in range(self.n_slots) if self.slots[i] is None]
        while self.queue and free:
            self._admit_into(free.pop(0), self.queue.popleft())   # FIFO

    def _admit_into(self, i: int, req: Request) -> None:
        """Bind ``req`` to free slot ``i``, adopting a resident prefix chain
        by pointing the block table at its pages (no state is copied)."""
        match = (self.pages.acquire(req.prompt, self.namespace)
                 if self.pages is not None else None)
        req.tokens = []
        req.admit_time = self.clock()
        slot = _Slot(request=req)
        if match is not None:
            slot.fed = match.tokens_matched
            for b, idx in enumerate(match.chain):
                self._pool.retain(idx)
                slot.pages_by_block[b] = idx
            slot.page_keys = match.keys
            slot.blocks_covered = slot.fed // self._ps
            self.prompt_tokens_reused += match.tokens_matched
        slot.next_token = req.prompt[slot.fed]
        self.slots[i] = slot

    # -- the engine step ------------------------------------------------------

    @property
    def active(self) -> int:
        """Occupied slots."""
        return sum(s is not None for s in self.slots)

    def step(self) -> bool:
        """Admit, then advance every occupied lane one scheduling step.

        A decoding lane consumes exactly one token per step; a prefilling
        lane consumes up to ``prefill_chunk`` prompt tokens (clamped to the
        next page boundary when prefix sharing is on, so every page a
        prefill completes is publishable). The step's tokens are on the
        host when it returns. Returns False when idle.
        """
        self._admit()
        if self.active == 0:
            return False
        dispatched = self._dispatch()
        self.steps += 1
        self._retire(dispatched)
        return True

    def _dispatch(self) -> tuple[torch.Tensor, list, list]:
        """Build this step's batch, launch it, and do the host bookkeeping
        that does not need the token values."""
        chunk = self.prefill_chunk
        n = self.n_slots
        toks = np.full((n, chunk), self.pad_token, np.int32)
        counts = np.zeros((n,), np.int32)
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            if slot.prefilling:
                prompt = slot.request.prompt
                m = min(chunk, len(prompt) - slot.fed)
                if self.pages is not None:
                    m = min(m, self._ps - slot.fed % self._ps)
                toks[i, :m] = prompt[slot.fed:slot.fed + m]
                counts[i] = m
            else:
                counts[i] = 1
                toks[i, 0] = slot.next_token
            self._ensure_pages(slot, slot.fed + int(counts[i]))

        nxt = self._launch(toks, counts)
        emitted, finished = [], []
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            was_prefilling = slot.prefilling
            slot.fed += int(counts[i])
            if was_prefilling:
                self.prompt_tokens_processed += int(counts[i])
                self._maybe_publish(slot)
                if slot.prefilling:
                    # still consuming the prompt: teacher-force the next token
                    slot.next_token = slot.request.prompt[slot.fed]
                    continue
            emitted.append((i, slot))
            slot.produced += 1
            self.tokens_generated += 1
            if slot.produced >= slot.request.max_new_tokens:
                # complete once this step's token lands: free the slot now
                finished.append(slot)
                self._evict(i)
        return nxt, emitted, finished

    def _launch(self, toks: np.ndarray, counts: np.ndarray) -> torch.Tensor:
        """One batched device launch; returns the on-device greedy tokens."""
        arena = self._arena
        tables, lengths = self._build_tables()
        if self._pchunk is None or int(counts.max()) <= 1:
            self.token_steps += 1
            return self._pstep(self.params, arena.k, arena.v, tables, lengths,
                               toks[:, 0], counts > 0)
        self.token_steps += int(counts.max())
        return self._pchunk(self.params, arena.k, arena.v, tables, lengths,
                            toks, counts)

    def _retire(self, dispatched) -> None:
        """Transfer the step's tokens to the host and deliver them."""
        nxt, emitted, finished = dispatched
        vals = nxt.cpu().numpy()
        now = self.clock()
        for i, slot in emitted:
            tok = int(vals[i])
            if not 0 <= tok < self.cfg.vocab:
                raise RuntimeError(f"request {slot.request.id!r}: token {tok} "
                                   f"outside the vocabulary of {self.cfg.vocab}")
            if slot.request.first_token_time is None:
                slot.request.first_token_time = now
            slot.request.tokens.append(tok)
            slot.next_token = tok
        for slot in finished:
            req = slot.request
            req.finish_time = self.clock()
            self.completed.append(req)
            if req.on_complete is not None:
                req.on_complete(req)

    # -- paged-backend plumbing ----------------------------------------------

    def _build_tables(self) -> tuple[np.ndarray, np.ndarray]:
        t = np.full((self.n_slots, self._np_slot), self._pool.null, np.int32)
        lengths = np.zeros((self.n_slots,), np.int32)
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            for b, idx in slot.pages_by_block.items():
                t[i, b] = idx
            lengths[i] = slot.fed
        return t, lengths

    def _ensure_pages(self, slot: _Slot, target: int) -> None:
        """Grow the slot's block table to cover positions [0, target)."""
        need = -(-target // self._ps)
        while slot.blocks_covered < need:
            if not self._pool.free_count and self.pages is not None:
                self.pages.clear()         # recycle unpinned shared residency
            slot.pages_by_block[slot.blocks_covered] = self._pool.alloc(self.name)
            slot.blocks_covered += 1

    def _maybe_publish(self, slot: _Slot) -> None:
        """Publish the page a prefill just completed: a refcount bump on the
        pool page (chunk feeds are clamped so boundaries are hit exactly)."""
        if self.pages is None or slot.fed % self._ps != 0:
            return
        key = slot.request.prompt[:slot.fed]
        if not self.pages.wants(key, self.namespace):
            return
        idx = slot.pages_by_block[slot.fed // self._ps - 1]
        self._pool.retain(idx)             # residency reference
        if not self.pages.publish(key, idx, self.namespace):
            self._pool.release(idx)

    def _evict(self, i: int) -> None:
        slot = self.slots[i]
        if slot.page_keys:
            self.pages.release(slot.page_keys, self.namespace)
        for idx in slot.pages_by_block.values():
            self._pool.release(idx)
        self.slots[i] = None

    # -- convenience ----------------------------------------------------------

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        """Step until queue and slots drain (raises if still busy after
        ``max_steps``)."""
        for _ in range(max_steps):
            if not self.step():
                return
        raise RuntimeError(f"engine still busy after {max_steps} steps")

    def drain_completed(self) -> list[Request]:
        """Hand off finished requests and forget their ids (which become
        reusable), so a long-running loop's history stays bounded."""
        done, self.completed = self.completed, []
        for req in done:
            self._ids.discard(req.id)
        return done

    def stats(self) -> dict:
        """Lifetime counters (monotone), plus page-table and pool stats.

        ``token_steps`` counts one-token model steps: a chunked launch runs
        one per fed position of its longest lane, so every attention layer
        runs ``n_layers * token_steps`` times in all.
        """
        out = {
            "steps": self.steps,
            "token_steps": self.token_steps,
            "tokens_generated": self.tokens_generated,
            "prompt_tokens_processed": self.prompt_tokens_processed,
            "prompt_tokens_reused": self.prompt_tokens_reused,
            "prefill_chunk": self.prefill_chunk,
            "backend": "paged",
            "table_entries_per_slot": self._np_slot,
            "completed": len(self.completed),
            "rejected": self.rejected,
            "queued": len(self.queue),
            "active": self.active,
        }
        if self.pages is not None:
            out["pages"] = dict(self.pages.stats,
                                resident=self.pages.resident,
                                pinned=self.pages.pinned)
        out["pool"] = dict(self._pool.stats,
                           pages=self._pool.n_pages,
                           in_use=self._pool.in_use,
                           free=self._pool.free_count,
                           held_by_engine=self._pool.in_use_by(self.name))
        return out
