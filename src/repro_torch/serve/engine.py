"""Continuous-batching serving engine on the paged and lane backends
(greedy, sync).

Port of ``ContinuousBatchingEngine`` and ``Request`` from
``src/repro/serve/engine.py``, for the slice of the reference that serves
greedily with sync dispatch, on either of its two backends:

* FIFO admission with ``queue_capacity`` backpressure;
* slot-based batching: one :meth:`~ContinuousBatchingEngine.step` advances
  every occupied slot, prefilling slots feed up to ``prefill_chunk`` prompt
  tokens (clamped to the next page boundary when prefix sharing is on),
  decoding slots one token;
* the **paged backend** (dense configs, the default for them): one global
  KV page pool with per-slot block tables (:mod:`repro_torch.serve.paged`),
  decoded through the hand-written paged-attention kernel on the card;
* the **lane backend** (every family the port decodes: the only one for
  MoE, SSM and hybrid configs, ``paged=False`` for dense ones): one lane
  of the family's decode cache a slot, ``n_lanes = max(slots,
  lane_batch)`` lanes and ``device_len = max(max_len, device_len)``
  positions, every lane decoded as a batch-1 model of its own in one
  batched call (:func:`lane_step_fn`, :func:`lane_chunk_fn`; the MoE
  layers route each lane on its own and pack the lanes into one
  grouped-matmul call a weight). Empty lanes ride the step with the pad
  token and are reset to the family's initial cache before their next
  admission;
* prefix sharing through :class:`~repro_torch.serve.pages.PageTable`. On
  the paged backend admission adopts a resident chain by pointing the
  block table at its pages (no copy), and a slot publishes each page its
  prefill completes. On lanes a page is a copy of the lane's cache
  (:func:`repro_torch.models.registry.lane_read`) and admission onto it
  copies it into the lane right before the slot's first step
  (copy-on-write, :meth:`PageTable.note_cow`);
* the platform surface: each slot lives in a memory bank of the engine's
  :class:`~repro_torch.core.platform.Platform`, woken and clock-gated
  through the platform's shared bank refcounts; admissions and completions
  raise the ``serve.admit`` / ``serve.complete`` XAIF interrupt lines; and
  an :class:`~repro_torch.serve.energy_meter.EnergyMeter` (on by default,
  as in the reference) charges every step's joules to its requests
  (``Request.energy_uj``, ``stats()["energy"]``). The meter only observes:
  a metered engine's tokens, admissions and launches equal an unmetered
  one's.

:func:`build_serve` is the serve driver's one-device prefill and decode
(the reference's ``build_sharded_serve`` without a mesh), which serves the
dense, MoE, hybrid and SSM families.

Later slices port the rest of the reference engine: async dispatch,
tensor parallelism, a shared external pool or page table, fault
injection, sampled requests, dedup claims and mid-flight re-match,
sliding-window page recycling on the paged backend, and preempt/replay
with a request journal. Passing a constructor argument of those features
with a non-default value raises ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.platform import Platform, XHeepConfig
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.serve.energy_meter import EnergyMeter
from repro_torch.serve.paged import (PagePool, paged_chunk_fn, paged_step_fn,
                                     to_device)
from repro_torch.serve.pages import PageTable
from repro_torch.serve.sampling import SamplingParams, greedy, require_greedy
from repro_torch.sharding.params import tree_leaves

# constructor arguments of the reference engine that later slices port,
# with the value that leaves each feature off
_LATER_SLICES = {
    "journal": None, "journal_horizon": None,
    "page_table": None, "pool": None, "async_dispatch": False,
    "admission_hook": None, "reclaim": None, "chaos": None, "mesh": None,
    "tp_axis": "model",
}

COMPLETE_LINE = "serve.complete"     # interrupt line raised per finished request
ADMIT_LINE = "serve.admit"           # raised per slot admission


@dataclasses.dataclass
class Request:
    """One generation request. ``tokens`` is filled in by the engine.

    ``sampling`` ``None`` (or a zero-temperature :class:`SamplingParams`)
    means greedy, the only mode the port serves so far.
    ``first_token_time`` stamps the retire of the first generated token.
    ``energy_uj`` accumulates the joules a metered engine attributes to the
    request (prefill/decode work, held KV pages, retention).
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
    energy_uj: float = 0.0

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
    tensor-parallel slice of the port), for the dense, MoE, hybrid and SSM
    families. ``device=None`` is the card and raises without one; the
    params passed to the functions must live there.
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
# The lane backend's step functions
# ---------------------------------------------------------------------------


def lane_step_fn(cfg: ModelConfig):
    """One token a lane over a lane cache, greedy (the reference's
    ``_slot_step_fn``, ``src/repro/serve/engine.py:210-226``).

    Signature: ``(params, cache, toks) -> next_tokens`` (B,) int32 on the
    cache's device; ``toks`` (B,) is a host array. Every lane, empty ones
    with the pad token, steps in one batched
    :func:`~repro_torch.models.registry.decode_step`, which writes the
    cache in place: an empty lane's state is garbage afterwards and is
    reset before its next admission, as in the reference.
    """
    def step(params, cache, toks):
        dev = cache.pos.device
        logits, _ = registry.decode_step(params, cfg, cache,
                                         to_device(toks, dev)[:, None])
        return greedy(logits)

    return step


def lane_chunk_fn(cfg: ModelConfig, chunk: int):
    """Up to ``chunk`` tokens a lane in one launch, greedy (the reference's
    ``_chunk_step_fn``, ``src/repro/serve/engine.py:229-268``).

    Signature: ``(params, cache, toks, counts) -> next_tokens`` with host
    arrays ``toks`` (B, chunk) and ``counts`` (B,). Runs masked one-token
    steps over all lanes: at step ``j`` lane ``b`` consumes ``toks[b, j]``
    if ``j < counts[b]``, and a masked lane's cache, ``pos`` included,
    stays bit for bit as it was (the ``keep`` of
    :func:`~repro_torch.models.registry.decode_step`). The returned token
    of each lane is the greedy token after its last fed token
    (``counts[b] - 1``). Steps past every lane's count would change
    nothing, so the loop stops at ``max(counts)``.
    """
    def step(params, cache, toks, counts):
        dev = cache.pos.device
        counts = np.asarray(counts)
        n = int(counts.max())
        if n > chunk:
            raise ValueError(f"counts exceed the chunk of {chunk}")
        toks = to_device(toks, dev)
        outs = []
        for j in range(n):
            fed = j < counts
            keep = None if fed.all() else to_device(fed, dev)
            logits, _ = registry.decode_step(params, cfg, cache,
                                             toks[:, j:j + 1], keep=keep)
            outs.append(greedy(logits))
        last = to_device(np.maximum(counts - 1, 0), dev).long()
        return torch.stack(outs, 1).gather(1, last[:, None])[:, 0]

    return step


# ---------------------------------------------------------------------------
# Continuous-batching engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Slot:
    """Host-side state of one decode slot (its device state is the pool
    pages its block table points at, or its lane of the lane cache)."""

    request: Request
    fed: int = 0             # tokens already consumed (prompt, then generated)
    produced: int = 0        # generated tokens so far
    next_token: int = 0      # token to feed at the next engine step
    page_keys: tuple = ()    # pinned shared-prefix pages (released on evict)
    pages_by_block: dict = dataclasses.field(default_factory=dict)
    blocks_covered: int = 0  # blocks allocated/adopted so far (next to cover)
    pending_snapshot: Any = None   # lanes: adopted prefix, copied at 1st step

    @property
    def prefilling(self) -> bool:
        return self.fed < len(self.request.prompt)


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a global KV page pool or over
    per-slot lanes.

    Each of the ``slots`` decode lanes holds one request. One :meth:`step`
    advances every occupied lane: lanes still consuming their prompt are
    teacher-forced (up to ``prefill_chunk`` tokens), lanes past it decode
    greedily. New requests are admitted into free lanes between steps;
    in-flight lanes never stop. ``page_size`` turns on prefix sharing
    through an engine-private :class:`PageTable` (bounded by
    ``page_capacity`` pages, default ``16 * slots``); without it pages are
    16 tokens and nothing is shared.

    ``paged=None`` picks the paged backend where the config can page (the
    dense family without a sliding window, which the paged backend does
    not serve yet) and lanes otherwise; ``paged=False`` forces lanes, and
    ``paged=True`` raises for a config that cannot page. ``lane_batch`` and
    ``device_len`` pad the device shapes (lanes or block tables, and cache
    positions) past ``slots`` and ``max_len``; the extra lanes ride idle.

    ``device=None`` is the card and raises without one; ``params`` must
    already live on the engine's device. The engine is clock-agnostic:
    ``clock`` is any ``() -> float``.

    ``platform`` is the X-HEEP platform whose banks and interrupt lines the
    engine uses (default: its own ``Platform(XHeepConfig())``, whose banks
    start clock-gated). ``metered`` (default on, as in the reference) runs
    an :class:`EnergyMeter` at DVFS point ``operating_point``;
    ``gate_idle_banks=False`` charges idle banks and the waiting host at
    full ON power.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int, max_len: int,
                 device=None, platform: Platform | None = None,
                 queue_capacity: int | None = None,
                 clock: Callable[[], float] = lambda: 0.0,
                 pad_token: int = 0, prefill_chunk: int = 1,
                 page_size: int | None = None,
                 page_capacity: int | None = None,
                 paged: bool | None = None, lane_batch: int | None = None,
                 device_len: int | None = None, namespace: str = "",
                 name: str | None = None, metered: bool = True,
                 operating_point: str = "max", gate_idle_banks: bool = True,
                 **later_slices):
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
        can_page = registry.supports_paged(cfg)
        if paged is None:
            paged = can_page
        elif paged and not can_page:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}): no paged KV decode for this "
                "family (MoE routes each lane on its own); it is served on "
                "lanes")
        if paged and cfg.sliding_window:
            raise NotImplementedError(
                f"{cfg.name}: sliding-window page recycling is not yet "
                "ported; paged=False serves it on lanes")
        self.paged = paged
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        for leaf in tree_leaves(params):
            if leaf.device != self.device:
                raise ValueError(f"params live on {leaf.device}, the engine "
                                 f"runs on {self.device}")
        self.params = params
        self.n_slots = slots
        self.max_len = max_len
        self.n_lanes = max(slots, lane_batch or 0)
        self.device_len = max(max_len, device_len or 0)
        owns_platform = platform is None
        self.platform = platform or Platform(XHeepConfig())
        self.queue_capacity = queue_capacity
        self.clock = clock
        self.pad_token = pad_token
        self.prefill_chunk = prefill_chunk
        self.namespace = namespace
        self.name = name if name is not None else (namespace or "engine")

        self._ps = page_size or 16
        self._np_slot = -(-self.device_len // self._ps)
        cap = page_capacity if page_capacity is not None else 16 * slots
        self._pool: PagePool | None = None
        self.pages: PageTable | None = None
        if paged:
            self._pool = PagePool(
                slots * self._np_slot + (cap if page_size else 0), self._ps)
            self._arena = self._pool.arena(cfg, self.device)
            self._pstep = paged_step_fn(cfg)
            self._pchunk = (paged_chunk_fn(cfg, prefill_chunk)
                            if prefill_chunk > 1 else None)
        else:
            # one lane a device slot, each a copy of the family's batch-1
            # initial cache (not assumed to be zeros)
            self._lstep = lane_step_fn(cfg)
            self._lchunk = (lane_chunk_fn(cfg, prefill_chunk)
                            if prefill_chunk > 1 else None)
            self._template = registry.cache_init(cfg, 1, self.device_len,
                                                 device=self.device)
            self._cache = registry.cache_init(cfg, self.n_lanes,
                                              self.device_len,
                                              device=self.device, lanes=True)
        self._dirty: set[int] = set()          # lanes holding a dead state
        if page_size:
            self.pages = PageTable(
                page_size, capacity_pages=cap, platform=self.platform,
                on_evict=self._pool.release if paged else None)

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

        # energy meter: purely observational joule accounting over the
        # calibrated HEEPocrates domain model; it reads launch shapes and
        # page holdings after the fact and never touches tokens or
        # admission order
        self._meter = (EnergyMeter(point=operating_point,
                                   gate_idle_banks=gate_idle_banks)
                       if metered else None)
        n_banks = self.platform.config.n_banks
        self._slot_bank = [f"bank{i % n_banks}" for i in range(slots)]
        # our own platform: the whole idle bank pool starts gated. A shared
        # platform's states are left untouched at construction; all
        # wake/gate transitions go through its shared bank refcounts
        if owns_platform:
            for i in range(n_banks):
                self.platform.power.clock_gate(f"bank{i}")

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
        """Bind ``req`` to free slot ``i``, adopting a resident prefix
        chain: on the paged backend by pointing the block table at its
        pages (no state is copied), on lanes by deferring the copy of the
        chain's last snapshot into the lane to the slot's first step
        (copy-on-write: a slot that never runs never pays for it). A dirty
        lane admitted without a match is reset to the initial cache."""
        match = (self.pages.acquire(req.prompt, self.namespace)
                 if self.pages is not None else None)
        if not self.paged and match is None and i in self._dirty:
            registry.lane_write(self._cache, i, self._template)
            self._dirty.discard(i)
        req.tokens = []
        req.admit_time = self.clock()
        slot = _Slot(request=req)
        if match is not None:
            slot.fed = match.tokens_matched
            slot.page_keys = match.keys
            if self.paged:
                for b, idx in enumerate(match.chain):
                    self._pool.retain(idx)
                    slot.pages_by_block[b] = idx
                slot.blocks_covered = slot.fed // self._ps
            else:
                slot.pending_snapshot = match.snapshot
            self.prompt_tokens_reused += match.tokens_matched
        slot.next_token = req.prompt[slot.fed]
        self.slots[i] = slot
        # shared refcount wakes the bank if idle
        self.platform.bank_acquire(self._slot_bank[i])
        self.platform.interrupts.fire(ADMIT_LINE, req)

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
        if self._meter is not None:
            residents, idle_banks = self._meter_residents()
            self._meter.tick(self.clock(), residents, idle_banks)
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
        n = self.n_lanes
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
            if self.paged:
                self._ensure_pages(slot, slot.fed + int(counts[i]))

        nxt = self._launch(toks, counts)
        emitted, finished, charges = [], [], []
        if self._meter is not None:
            occupied = {self._slot_bank[i]
                        for i, s in enumerate(self.slots) if s is not None}
            launch_idle_banks = len(set(self._slot_bank)) - len(occupied)
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            was_prefilling = slot.prefilling
            if self._meter is not None:
                charges.append((slot.request,
                                "prefill" if was_prefilling else "decode",
                                int(counts[i]), self._page_share(slot)))
            slot.fed += int(counts[i])
            if was_prefilling:
                self.prompt_tokens_processed += int(counts[i])
                self._maybe_publish(i, slot)
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
        if self._meter is not None:
            self._meter.charge_step(charges, launch_idle_banks)
        return nxt, emitted, finished

    def _launch(self, toks: np.ndarray, counts: np.ndarray) -> torch.Tensor:
        """One batched device launch; returns the on-device greedy tokens."""
        if not self.paged:
            return self._launch_lanes(toks, counts)
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
            # XAIF end-of-computation interrupt, then the per-request handler
            self.platform.interrupts.fire(COMPLETE_LINE, req)
            if req.on_complete is not None:
                req.on_complete(req)

    # -- paged-backend plumbing ----------------------------------------------

    def _build_tables(self) -> tuple[np.ndarray, np.ndarray]:
        t = np.full((self.n_lanes, self._np_slot), self._pool.null, np.int32)
        lengths = np.zeros((self.n_lanes,), np.int32)
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

    # -- lane-backend plumbing -----------------------------------------------

    def _launch_lanes(self, toks: np.ndarray,
                      counts: np.ndarray) -> torch.Tensor:
        """The lane backend's launch: pending copy-on-write copies first,
        then one batched step (chunked when a lane feeds more than one
        token)."""
        self._apply_pending_snapshots()
        # empty lanes still ride the batched step (pad token): their lanes
        # are garbage afterwards and must be reset before the next admission
        self._dirty.update(i for i, s in enumerate(self.slots) if s is None)
        self._dirty.update(range(self.n_slots, self.n_lanes))
        if self._lchunk is None or int(counts.max()) <= 1:
            # steady-state decode: every lane feeds one token, so skip the
            # chunk loop and its masks
            self.token_steps += 1
            return self._lstep(self.params, self._cache, toks[:, 0])
        self.token_steps += int(counts.max())
        return self._lchunk(self.params, self._cache, toks, counts)

    def _apply_pending_snapshots(self) -> None:
        """Copy-on-write: a slot admitted onto shared pages borrows their
        snapshot at admission; its private lane copy is made here, right
        before the lane's first step."""
        for i, slot in enumerate(self.slots):
            if slot is None or slot.pending_snapshot is None:
                continue
            registry.lane_write(self._cache, i, slot.pending_snapshot)
            slot.pending_snapshot = None
            self._dirty.discard(i)
            self.pages.note_cow(len(slot.page_keys))

    # -- prefix publication and eviction --------------------------------------

    def _maybe_publish(self, i: int, slot: _Slot) -> None:
        """Publish lane ``i``'s state when its prefill lands on a page
        boundary (chunk feeds are clamped so boundaries are hit exactly).
        Paged backend: a refcount bump on the just-completed pool page.
        Lanes: a copy of the lane's cache (:func:`registry.lane_read`), which
        later steps of the lane do not touch."""
        if self.pages is None or slot.fed % self._ps != 0:
            return
        key = slot.request.prompt[:slot.fed]
        if not self.pages.wants(key, self.namespace):
            return
        if not self.paged:
            self.pages.publish(key, registry.lane_read(self._cache, i),
                               self.namespace)
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
        self._dirty.add(i)
        # shared refcount: gates only when no engine holds the bank
        self.platform.bank_release(self._slot_bank[i])

    @property
    def _bank_load(self) -> dict[str, int]:
        """This engine's live slots per bank (the platform refcounts span
        every holder of the platform)."""
        load = {b: 0 for b in set(self._slot_bank)}
        for i, s in enumerate(self.slots):
            if s is not None:
                load[self._slot_bank[i]] += 1
        return load

    # -- energy metering ------------------------------------------------------

    def _page_share(self, slot: _Slot) -> float:
        """Refcount-weighted KV pages this slot holds: shared-prefix pool
        pages split their holding energy 1/refcount across their holders
        (table residency included), as the reference's paged backend
        charges them; a lane slot counts its pinned snapshot pages at
        weight 1, as the reference's lane backend does."""
        if self.paged and slot.pages_by_block:
            refs = self._pool.refcounts()
            return sum(1.0 / max(refs.get(idx, 1), 1)
                       for idx in slot.pages_by_block.values())
        return float(len(slot.page_keys))

    def _meter_residents(self):
        """(residents, idle_banks) for the meter's clock tick: every
        occupied slot with its bank-leak weight (a bank shared by k live
        slots splits its retention leakage k ways) and page share, plus
        how many of the engine's banks host no live slot."""
        load = self._bank_load
        residents = []
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            bank_weight = 1.0 / load[self._slot_bank[i]]
            residents.append((slot.request, bank_weight,
                              self._page_share(slot)))
        idle_banks = sum(1 for n in load.values() if n == 0)
        return residents, idle_banks

    def set_operating_point(self, name: str) -> None:
        """Move the engine's energy meter to a named DVFS point (see
        :data:`repro_torch.core.energy.OPERATING_POINTS`). Accounting only:
        the engine's tokens stay bit-identical, only the joules-per-token
        bookkeeping changes."""
        if self._meter is None:
            raise ValueError("engine built with metered=False has no "
                             "operating point to set")
        self._meter.set_point(name)

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
        """Lifetime counters (monotone), plus the meter's joules (``energy``,
        when metered) and page-table and pool stats.

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
            "backend": "paged" if self.paged else "lanes",
            "table_entries_per_slot": self._np_slot if self.paged else None,
            "completed": len(self.completed),
            "rejected": self.rejected,
            "queued": len(self.queue),
            "active": self.active,
        }
        if self._meter is not None:
            out["energy"] = self._meter.stats()
        if self.pages is not None:
            out["pages"] = dict(self.pages.stats,
                                resident=self.pages.resident,
                                pinned=self.pages.pinned)
        if self._pool is not None:
            out["pool"] = dict(self._pool.stats,
                               pages=self._pool.n_pages,
                               in_use=self._pool.in_use,
                               free=self._pool.free_count,
                               held_by_engine=self._pool.in_use_by(self.name))
        return out
