"""Continuous-batching serving engine on the paged and lane backends.

Port of ``ContinuousBatchingEngine`` and ``Request`` from
``src/repro/serve/engine.py``, on either of its two backends:

* FIFO admission with ``queue_capacity`` backpressure;
* slot-based batching: one :meth:`~ContinuousBatchingEngine.step` advances
  every occupied slot, prefilling slots feed up to ``prefill_chunk`` prompt
  tokens (clamped to the next page boundary when prefix sharing is on),
  decoding slots one token;
* the **paged backend** (dense configs, sliding-window ones included: the
  default for them): one global KV page pool with per-slot block tables
  (:mod:`repro_torch.serve.paged`), decoded through the hand-written
  paged-attention kernel on the card. A windowed config's block table is a
  **ring** of ``ceil(window / page_size) + 1`` entries: the moment a page
  falls wholly below the window it is recycled (a private page goes back to
  the pool's free list, an adopted shared-prefix page is disowned, its
  table residency kept), so a long windowed request holds O(window) pages,
  and prefix adoption is clamped to the pages the window can still see;
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
  block table at its pages (no copy), a slot publishes each page its
  prefill completes, and two cold same-prefix prefills dedup: the later
  one stalls on the earlier one's claim, then adopts its published pages
  (mid-flight re-match). On lanes a page is a copy of the lane's cache
  (:func:`repro_torch.models.registry.lane_read`) and admission onto it
  copies it into the lane right before the slot's first step
  (copy-on-write, :meth:`PageTable.note_cow`);
* **sampled decoding**: each request's
  :class:`~repro_torch.serve.sampling.SamplingParams` (greedy by default)
  draws its tokens under a per-lane threefry key, re-seeded at admission
  and split once a launch, the carried half kept only where the launch
  emits a token, so a chain's position equals the tokens produced;
* **async double-buffered dispatch** (``async_dispatch=True``): step N+1
  is launched before step N's tokens reach the host. A decoding lane takes
  its input token from step N's on-device output (the feedback path), and
  step N's host bookkeeping (journal, completions) retires while the
  device runs step N+1. On the card step N's tokens go to pinned host
  memory by a copy that does not wait, behind a CUDA event that the
  retire waits on. Every launch is issued on the device's current stream,
  and every host array a launch reads is a copy of its own, so the host
  may rewrite the engine's arrays while the launch is in flight;
* **the journal and preemption**: a
  :class:`~repro_torch.runtime.ft.RequestJournal` records each admission,
  its prefix reuse and each token; :meth:`~ContinuousBatchingEngine.preempt`
  and :meth:`~ContinuousBatchingEngine.preempt_slot` requeue in-flight
  requests, whose replay re-seeds their chains and reproduces their
  tokens bit for bit, checked token by token against the journal. A token
  outside the vocabulary or a journal divergence quarantines its request,
  which replays (``max_replays`` times at most, then the engine raises);
* the platform surface: each slot lives in a memory bank of the engine's
  :class:`~repro_torch.core.platform.Platform`, woken and clock-gated
  through the platform's shared bank refcounts; admissions and completions
  raise the ``serve.admit`` / ``serve.complete`` XAIF interrupt lines; and
  an :class:`~repro_torch.serve.energy_meter.EnergyMeter` (on by default,
  as in the reference) charges every step's joules to its requests
  (``Request.energy_uj``, ``stats()["energy"]``). The meter only observes:
  a metered engine's tokens, admissions and launches equal an unmetered
  one's.

* **a tenant of a cluster** (:mod:`repro_torch.serve.cluster`): given a
  shared ``pool`` and ``page_table`` the engine allocates from the
  cluster's pool (page ids valid across engines, so a shared table keeps
  the paged backend), ``namespace`` keys its prefix pages, an
  ``admission_hook`` vetoes each admission (``True`` admit, ``False`` skip
  the slot, ``None`` stop the scan, :data:`SHED` drop the queue head),
  ``reclaim`` replaces ``pages.clear()`` under pool pressure, and ``chaos``
  (a :class:`~repro_torch.serve.chaos.FaultPlan`) injects faults before
  every launch and into every retired token. :meth:`occupancy` and
  :meth:`step_cost` are what a scheduler arbitrates on.

Engine invariants (as the reference's): FIFO admission, with preemption
requeueing in-flight work at the front in the same order; refcounts never
negative; replay determinism (sync ≡ async, paged ≡ lanes, chunked ≡
unchunked, preempted ≡ undisturbed, bit for bit, greedy and sampled).

:func:`build_serve` is the serve driver's one-device prefill and decode
(the reference's ``build_sharded_serve`` without a mesh), which serves the
dense, MoE, hybrid and SSM families.

**Tensor parallelism** (``mesh``, ``tp_axis``): a
:class:`~repro_torch.launch.mesh.Mesh` pins the paged decode to its shards
(:mod:`repro_torch.serve.paged`): wq/wk/wv split by head, one arena of
``Kh/tp`` heads a shard, the heads gathered before wo. The host state
(slots, block tables, journal, sampling chains) is kept once and does not
depend on the mesh, so tp changes where bytes live, never which tokens
come out. The lane families (MoE, SSM, hybrid) and ``paged=False`` raise
with a mesh.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.platform import Platform, XHeepConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.ft import RequestJournal
from repro_torch.serve import sampling
from repro_torch.serve.energy_meter import EnergyMeter
from repro_torch.serve.paged import (PagePool, feed, last_fed, mesh_tp,
                                     paged_chunk_fn, paged_step_fn,
                                     place_params, shard_devices, to_device)
from repro_torch.serve.pages import PageTable
from repro_torch.serve.sampling import GREEDY, SamplingParams
from repro_torch.sharding.params import tree_leaves

COMPLETE_LINE = "serve.complete"     # interrupt line raised per finished request
ADMIT_LINE = "serve.admit"           # raised per slot admission

# Admission-hook verdict telling the engine to drop the queue head outright
# (latency-SLO admission control: the request can no longer meet its SLO).
# Distinct from False (skip this slot) and None (stop the admission scan);
# see ``ContinuousBatchingEngine._place``.
SHED = object()


@dataclasses.dataclass
class Request:
    """One generation request. ``tokens`` is filled in by the engine.

    ``slo`` (optional) is a latency target the scheduler and the metrics
    layer read (:class:`repro_torch.serve.metrics.SLO`); the engine never
    interprets it. ``sampling`` (optional) selects stochastic decoding
    (:class:`~repro_torch.serve.sampling.SamplingParams`); ``None`` means
    greedy, and rides through preemption untouched, so a replayed admission
    re-seeds the identical chain. ``first_token_time`` stamps the retire of
    the first generated token (TTFT is that minus ``arrival_time``).
    ``slo_preempts`` counts the scheduler's preempt-and-requeue demotions.
    ``energy_uj`` accumulates the joules a metered engine attributes to the
    request (prefill/decode work, held KV pages, retention; replay after a
    preemption is charged on top); ``energy_cap_uj_per_token`` is a tenant
    cap the cluster's energy-aware admission compares against the engine's
    projected marginal cost.
    """

    id: str
    prompt: Sequence[int]
    max_new_tokens: int
    on_complete: Callable[["Request"], None] | None = None
    slo: Any = None
    sampling: SamplingParams | None = None
    # engine-written bookkeeping
    tokens: list = dataclasses.field(default_factory=list)
    arrival_time: float | None = None
    admit_time: float | None = None
    first_token_time: float | None = None
    finish_time: float | None = None
    slo_preempts: int = 0
    energy_uj: float = 0.0
    energy_cap_uj_per_token: float | None = None

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
    tensor-parallel slice of the port), for every family. ``device=None``
    is the card and raises without one; the params passed to the functions
    must live there. ``prefill_fn(params, inputs)`` takes tokens ``(batch,
    S)``, or for a config whose inputs are embeddings
    (``registry.uses_token_inputs`` False: the audio and VLM stubs) embeds
    ``(batch, S, d_model)``; with ``prefill_len`` it checks that S is
    ``prefill_len``. ``decode_fn`` takes tokens in every family.
    """
    dev = device_mod.resolve(device)
    if batch < 1 or max_len < 1:
        raise ValueError(f"batch {batch} and max_len {max_len} must be >= 1")
    if prefill_len is not None and not 1 <= prefill_len <= max_len:
        raise ValueError(f"prefill_len {prefill_len} must be in [1, "
                         f"max_len {max_len}]")

    by_tokens = registry.uses_token_inputs(cfg)

    def prefill_fn(params, inputs):
        if by_tokens:
            what, want = "tokens", (batch, prefill_len or inputs.shape[-1])
        else:
            what = "embeddings"
            want = (batch, prefill_len or inputs.shape[1], cfg.d_model)
        if tuple(inputs.shape) != want:
            raise ValueError(f"prefill {what} {tuple(inputs.shape)}, want "
                             f"{want}")
        key = "tokens" if by_tokens else "embeds"
        with torch.inference_mode():
            return registry.prefill(params, cfg, max_len=max_len,
                                    **{key: inputs.to(dev)})

    def decode_fn(params, cache, tokens):
        with torch.inference_mode():
            return registry.decode_step(params, cfg, cache, tokens.to(dev))

    return Serve(prefill_fn, decode_fn, max_len)




# ---------------------------------------------------------------------------
# The lane backend's step functions
# ---------------------------------------------------------------------------


def lane_step_fn(cfg: ModelConfig):
    """One token a lane over a lane cache, sampled (the reference's
    ``_slot_step_fn``, ``src/repro/serve/engine.py:210-226``).

    Signature: ``(params, cache, toks, feedback, prev, emit, keys, temp,
    top_k, top_p) -> (next_tokens, keys)``; ``toks``, ``feedback``,
    ``emit``, ``temp``, ``top_k`` and ``top_p`` (B,) are host arrays, the
    rest as in :func:`~repro_torch.serve.paged.paged_step_fn`: a lane fed
    back takes ``prev``, and each lane's token is drawn under its key,
    which splits once and is carried where ``emit`` is set. Every lane,
    empty ones with the pad token, steps in one batched
    :func:`~repro_torch.models.registry.decode_step`, which writes the
    cache in place: an empty lane's state is garbage afterwards and is
    reset before its next admission, as in the reference.
    """
    def step(params, cache, toks, feedback, prev, emit, keys, temp, top_k,
             top_p):
        dev = cache.pos.device
        logits, _ = registry.decode_step(
            params, cfg, cache, feed(toks, feedback, prev, dev)[:, None])
        return sampling.draw(logits, keys, emit, temp, top_k, top_p)

    return step


def lane_chunk_fn(cfg: ModelConfig, chunk: int):
    """Up to ``chunk`` tokens a lane in one launch, sampled (the
    reference's ``_chunk_step_fn``, ``src/repro/serve/engine.py:229-268``).

    Signature: ``(params, cache, toks, counts, feedback, prev, emit, keys,
    temp, top_k, top_p) -> (next_tokens, keys)`` with host arrays ``toks``
    (B, chunk) and ``counts`` (B,), the rest as in :func:`lane_step_fn`
    (``feedback`` applies to iteration 0). Runs masked one-token steps over
    all lanes: at step ``j`` lane ``b`` consumes ``toks[b, j]`` if ``j <
    counts[b]``, and a masked lane's cache, ``pos`` included, stays bit for
    bit as it was (the ``keep`` of
    :func:`~repro_torch.models.registry.decode_step`). Each lane's token is
    drawn after its last fed token (``counts[b] - 1``) with the launch's
    one split of its key. Steps past every lane's count would change
    nothing, so the loop stops at ``max(counts)``.
    """
    def step(params, cache, toks, counts, feedback, prev, emit, keys, temp,
             top_k, top_p):
        dev = cache.pos.device
        counts = np.asarray(counts)
        n = int(counts.max())
        if n > chunk:
            raise ValueError(f"counts exceed the chunk of {chunk}")
        toks = to_device(toks, dev)
        first = feed(toks[:, 0], feedback, prev, dev)
        last = None
        for j in range(n):
            fed = j < counts
            keep = None if fed.all() else to_device(fed, dev)
            tok = first if j == 0 else toks[:, j]
            logits, _ = registry.decode_step(params, cfg, cache, tok[:, None],
                                             keep=keep)
            last = last_fed(last, logits, j, counts, dev)
        return sampling.draw(last, keys, emit, temp, top_k, top_p)

    return step


# ---------------------------------------------------------------------------
# Continuous-batching engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Slot:
    """Host-side state of one decode slot (its device state is the pool
    pages its block table points at, or its lane of the lane cache)."""

    request: Request
    seq: int                 # FIFO sequence number of the request
    fed: int = 0             # tokens already consumed (prompt, then generated)
    produced: int = 0        # generated tokens so far
    next_token: int = 0      # token to feed at the next engine step
    page_keys: tuple = ()    # pinned shared-prefix pages (released on evict)
    pages_by_block: dict = dataclasses.field(default_factory=dict)
    blocks_covered: int = 0  # blocks allocated/adopted so far (next to cover)
    pending_snapshot: Any = None   # lanes: adopted prefix, copied at 1st step
    claims: list = dataclasses.field(default_factory=list)  # dedup claims held

    @property
    def prefilling(self) -> bool:
        return self.fed < len(self.request.prompt)


@dataclasses.dataclass
class _StepMeta:
    """Host bookkeeping deferred to a step's retire (async dispatch)."""

    emitted: list            # (lane, slot): token value lands at retire
    finished: list           # slots completing in this step, lane order


@dataclasses.dataclass
class _Launched:
    """A dispatched step: its bookkeeping, its on-device tokens and, on the
    card, the pinned host buffer they are copied into and the event that
    marks the copy done."""

    meta: _StepMeta
    tokens: torch.Tensor
    host: torch.Tensor | None = None
    done: Any = None


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a global KV page pool or over
    per-slot lanes.

    Each of the ``slots`` decode lanes holds one request. One :meth:`step`
    advances every occupied lane: lanes still consuming their prompt are
    teacher-forced (up to ``prefill_chunk`` tokens), lanes past it decode
    under their request's sampling parameters (greedy by default). New
    requests are admitted into free lanes between steps; in-flight lanes
    never stop. ``page_size`` turns on prefix sharing through an
    engine-private :class:`PageTable` (bounded by ``page_capacity`` pages,
    default ``16 * slots``); without it pages are 16 tokens and nothing is
    shared.

    ``paged=None`` picks the paged backend where the config can page (the
    dense family, sliding-window configs on ring block tables) and lanes
    otherwise (and for an external ``page_table`` without a shared
    ``pool``, whose payloads are then lane snapshots); ``paged=False``
    forces lanes, and ``paged=True`` raises for a config that cannot page.
    ``lane_batch`` and ``device_len`` pad the device shapes (lanes or block
    tables, and cache positions) past ``slots`` and ``max_len``; the extra
    lanes ride idle. A windowed config's window is clamped to
    ``device_len`` (as the lane ring cache clamps it), and its private pool
    holds ``slots * (ceil(window / page_size) + 1)`` pages plus the page
    table's capacity.

    ``pool`` and ``page_table`` make the engine one tenant of a cluster
    (see the module docstring), with ``namespace``, ``name`` (its pages'
    owner tag and the scope of its fault draws), ``admission_hook``,
    ``reclaim`` and ``chaos``.

    ``async_dispatch`` launches each step before the previous one retires
    (see the module docstring); the tokens are the same bits either way.
    ``journal`` (default: a new :class:`RequestJournal` with
    ``journal_horizon``) records every admission and token.

    ``device=None`` is the card and raises without one; ``params`` must
    already live on the engine's device. The engine is clock-agnostic:
    ``clock`` is any ``() -> float``.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`) serves the paged
    backend tensor-parallel over its ``tp_axis`` (``self.tp`` shards):
    ``params`` may then live anywhere and are placed on the mesh
    (:func:`~repro_torch.serve.paged.place_params`), and the engine's
    device is the first shard's, where the logits are sampled and the
    async path's tokens and event live. A config the head-sharded decode
    cannot serve (the lane families, Kh not divisible by tp) and
    ``paged=False`` raise ``ValueError``.

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
                 journal: RequestJournal | None = None,
                 pad_token: int = 0, prefill_chunk: int = 1,
                 page_size: int | None = None,
                 page_table: PageTable | None = None,
                 page_capacity: int | None = None,
                 paged: bool | None = None, async_dispatch: bool = False,
                 lane_batch: int | None = None,
                 device_len: int | None = None,
                 pool: PagePool | None = None, namespace: str = "",
                 name: str | None = None, admission_hook=None, reclaim=None,
                 chaos=None, journal_horizon: int | None = None,
                 mesh: Mesh | None = None, tp_axis: str = "model",
                 metered: bool = True,
                 operating_point: str = "max", gate_idle_banks: bool = True):
        if slots < 1:
            raise ValueError("engine needs at least one decode slot")
        if max_len < 2:
            raise ValueError("max_len must fit a prompt token plus one output")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        # tensor parallelism: the params land head-sharded on the mesh
        # (placement raises for a config the sharded decode cannot serve,
        # before any backend is picked) and the tail runs on the first
        # shard's device, the engine's
        self.mesh, self.tp_axis = mesh, tp_axis
        self.tp = mesh_tp(mesh, tp_axis) if mesh is not None else 1
        if mesh is not None:
            placed = place_params(cfg, params, mesh, tp_axis)
        # a shared external table is paged territory only when its payloads
        # are pool ids valid across engines, i.e. the pool is shared too;
        # otherwise it holds lane snapshots and the lane backend serves
        if pool is not None and not registry.supports_paged(cfg):
            raise ValueError(
                f"{cfg.name} ({cfg.family}) cannot join a shared page pool: "
                "no paged KV decode for this family")
        can_page = registry.supports_paged(cfg) and (
            page_table is None or pool is not None)
        if paged is None:
            paged = can_page
        elif paged and not registry.supports_paged(cfg):
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}): no paged KV decode for this "
                "family (MoE routes each lane on its own); it is served on "
                "lanes")
        elif paged and not can_page:
            raise ValueError(
                "paged backend needs either an engine-private page table or "
                "a shared (cluster-owned) pool")
        if pool is not None and not paged:
            raise ValueError("a shared pool is a paged-backend resource; "
                             "drop it or drop paged=False")
        if mesh is not None and not paged:
            raise ValueError(
                "tensor parallelism is a paged-backend feature: the lane "
                "backend has no sharded arena to decode against")
        self.paged = paged
        self.cfg = cfg
        if mesh is None:
            self.device = device_mod.resolve(device)
            for leaf in tree_leaves(params):
                if leaf.device != self.device:
                    raise ValueError(f"params live on {leaf.device}, the "
                                     f"engine runs on {self.device}")
            self.params = params
        else:
            self.device = shard_devices(mesh, tp_axis)[0]
            if device is not None and device_mod.resolve(device) != self.device:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"shard's, {self.device}")
            self.params = placed
        self.n_slots = slots
        self.max_len = max_len
        self.n_lanes = max(slots, lane_batch or 0)
        self.device_len = max(max_len, device_len or 0)
        owns_platform = platform is None
        self.platform = platform or Platform(XHeepConfig())
        self.queue_capacity = queue_capacity
        self.clock = clock
        self.journal = journal or RequestJournal(horizon=journal_horizon)
        self.pad_token = pad_token
        self.prefill_chunk = prefill_chunk
        self.async_dispatch = async_dispatch
        self.namespace = namespace
        self.name = name if name is not None else (namespace or "engine")
        # fault injection (a chaos.FaultPlan or None): drawn before every
        # launch (may raise a retryable DeviceStepFault) and on every
        # retired token (may corrupt the value the host receives)
        self.chaos = chaos
        # scheduler callbacks (a ServeCluster's): ``admission_hook`` vetoes
        # each admission, ``reclaim`` replaces pages.clear() under pool
        # pressure with a cross-tenant policy
        self._admission_hook = admission_hook
        self._reclaim = reclaim

        self._ps = (pool.page_size if pool is not None else page_size) or 16
        np_max = -(-self.device_len // self._ps)
        # a windowed config's ring modulus is the lane ring cache's length,
        # min(window, device_len), and a slot's block table is a ring of
        # ceil(window / ps) + 1 entries: by the time an entry is reused its
        # old block lies wholly below the window
        if cfg.sliding_window:
            self._window: int | None = min(cfg.sliding_window,
                                           self.device_len)
            self._np_slot = min(np_max, -(-self._window // self._ps) + 1)
        else:
            self._window = None
            self._np_slot = np_max
        cap = page_capacity if page_capacity is not None else 16 * slots
        self.owns_pool = pool is None
        self._pool: PagePool | None = pool
        if paged:
            if self._pool is None:
                # O(window) pages a slot for a windowed config, the ring
                # bound being the private pool's budget
                self._pool = PagePool(
                    slots * self._np_slot + (cap if page_size else 0),
                    self._ps)
            self._arena = self._pool.arena(
                cfg, self.device if mesh is None else mesh, tp_axis)
            self._pstep = paged_step_fn(cfg, self._window, mesh, tp_axis)
            self._pchunk = (paged_chunk_fn(cfg, prefill_chunk, self._window,
                                           mesh, tp_axis)
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
        self.pages: PageTable | None = page_table
        if page_table is None and page_size:
            self.pages = PageTable(
                page_size, capacity_pages=cap, platform=self.platform,
                on_evict=self._pool.release if paged else None)
        if paged and self.pages is not None and self.pages.page_size != self._ps:
            raise ValueError(
                f"page table page_size {self.pages.page_size} != pool page "
                f"size {self._ps}: paged payloads are pool pages, the two "
                "extents must coincide")

        self.queue: collections.deque[Request] = collections.deque()
        self._ids: set[str] = set()            # every id ever submitted
        self.slots: list[_Slot | None] = [None] * slots
        self._pending: _Launched | None = None  # unretired step (async)
        self._prev_nxt: torch.Tensor | None = None  # its on-device tokens
        self._pinned: list[torch.Tensor] = []  # free host buffers (card)

        # per-lane sampling state: the PRNG keys (host int64 words, split
        # on the host at each launch) and the parameters, (re-)seeded at
        # admission; greedy lanes keep temperature 0 = exact argmax
        self._keys = sampling.zero_keys(self.n_lanes)
        self._temp = np.zeros((self.n_lanes,), np.float32)
        self._topk = np.zeros((self.n_lanes,), np.int32)
        self._topp = np.ones((self.n_lanes,), np.float32)

        # throughput counters, monotone by construction
        self.steps = 0                         # engine steps (launches)
        self.token_steps = 0                   # one-token model steps run
        self.tokens_generated = 0
        self.prompt_tokens_processed = 0
        self.prompt_tokens_reused = 0
        self.stalls = 0                        # lane-steps waiting on a sibling
        self.admission_stalls = 0              # admissions vetoed by the hook
        self.rematches = 0                     # mid-flight prefix adoptions
        self.rematched_tokens = 0              # prompt tokens adopted mid-flight
        self.pages_recycled = 0                # ring entries reused (windowed)
        self.sampled_requests = 0              # admissions with sampling on
        self.completed: list[Request] = []
        self.rejected = 0
        self.shed = 0                          # queue heads dropped by the hook
        self.token_faults = 0                  # corrupted tokens refused
        self.replays = 0                       # quarantine-driven requeues
        # corruption quarantine: slots whose retired token failed the
        # vocab range check or the journal cross-check; their requests are
        # evicted and replayed by _recover_faulted()
        self._faulted: list[_Slot] = []
        # slot identities a flush-retire must skip (their journal position
        # is behind the in-flight step; delivering would leave a gap)
        self._skip_retire: frozenset = frozenset()
        self._replay_counts: dict[str, int] = {}
        # livelock guard: a request quarantined this many times is a
        # persistent divergence, and the engine raises
        self.max_replays = 16

        # energy meter: purely observational joule accounting over the
        # calibrated HEEPocrates domain model; it reads launch shapes and
        # page holdings after the fact and never touches tokens, keys or
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
        if len(request.prompt) + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {request.id!r} needs "
                f"{len(request.prompt) + request.max_new_tokens} positions, "
                f"engine max_len is {self.max_len}")
        if request.id in self._ids:
            # ids key the journal; a duplicate would interleave two
            # requests' tokens into one record and break replay
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
            i = self._place(free)
            if i is SHED:
                # latency-SLO admission control: the head can no longer
                # meet its SLO, so the scheduler drops it
                self.queue.popleft()
                self.shed += 1
                continue
            if i is None:
                break        # head unplaceable: FIFO forbids skipping it
            free.remove(i)
            self._admit_into(i, self.queue.popleft())   # FIFO

    def _place(self, free: list[int]):
        """First free slot the scheduler lets the queue head into (None:
        stalled this step). The hook peeks, never pops, so a veto leaves
        the request at the head. False vetoes one slot (a later free slot
        may sit on an awake bank and admit the head at no budget cost);
        None ends the scan; :data:`SHED` tells :meth:`_admit` to drop the
        head."""
        if self._admission_hook is None:
            return free[0]
        for i in free:
            verdict = self._admission_hook(self, i, self.queue[0])
            if verdict is SHED:
                return SHED
            if verdict:
                return i
            self.admission_stalls += 1
            if verdict is None:
                return None
        return None

    def _admit_into(self, i: int, req: Request) -> None:
        """Bind ``req`` to free slot ``i``: adopt a resident prefix chain
        (on the paged backend by pointing the block table at its pages, no
        state copied; on lanes by deferring the copy of the chain's last
        snapshot into the lane to the slot's first step, copy-on-write),
        open the journal record, (re-)seed the lane's sampling chain, wake
        the bank and raise the admit interrupt. A dirty lane admitted
        without a match is reset to the initial cache."""
        match = (self.pages.acquire(req.prompt, self.namespace)
                 if self.pages is not None else None)
        if not self.paged and match is None and i in self._dirty:
            registry.lane_write(self._cache, i, self._template)
            self._dirty.discard(i)
        rec = self.journal.open(
            req.id, req.prompt, req.max_new_tokens,
            sampling=req.sampling.astuple() if req.sampling else None)
        req.tokens = []
        req.admit_time = self.clock()
        # replay after a preemption restarts the request's chain from its
        # journaled seed, and the emit-gated split keeps the chain's
        # position at the produced count, however many prefill launches
        # (prefix adoption, chunking, stalls) the replay takes
        sp = req.sampling or GREEDY
        self._temp[i] = sp.temperature
        self._topk[i] = sp.top_k
        self._topp[i] = sp.top_p
        self._keys[i] = sampling.seed_key(sp.seed)
        if req.sampling is not None:
            self.sampled_requests += 1
        slot = _Slot(request=req, seq=rec.arrival_seq)
        if match is not None:
            slot.fed = match.tokens_matched
            if self.paged:
                # window clamp: chain pages wholly below the window the slot
                # will ever attend from (positions < fed + 1 - window) are
                # never read; their tokens count as reused, but the slot
                # neither pins them in the pool nor keeps them in the table
                first_needed = 0
                if self._window is not None:
                    first_needed = max(
                        0, slot.fed + 1 - self._window) // self._ps
                kept = []
                for b, (key, idx) in enumerate(zip(match.keys, match.chain)):
                    if b < first_needed:
                        continue
                    self._pool.retain(idx)
                    slot.pages_by_block[b] = idx
                    kept.append(key)
                dropped = match.keys[:len(match.keys) - len(kept)]
                if dropped:
                    self.pages.release(dropped, self.namespace)
                slot.page_keys = tuple(kept)
                slot.blocks_covered = slot.fed // self._ps
            else:
                slot.page_keys = match.keys
                slot.pending_snapshot = match.snapshot
            self.prompt_tokens_reused += match.tokens_matched
        slot.next_token = req.prompt[slot.fed]
        self.journal.note_prefix(req.id, slot.fed, slot.page_keys)
        self.slots[i] = slot
        # shared refcount wakes the bank if idle
        self.platform.bank_acquire(self._slot_bank[i])
        self.platform.interrupts.fire(ADMIT_LINE, req)

    # -- the engine step ------------------------------------------------------

    @property
    def active(self) -> int:
        """Occupied slots."""
        return sum(s is not None for s in self.slots)

    @property
    def busy(self) -> bool:
        """Work left: occupied slots, queued requests or an unretired
        step."""
        return (self.active > 0 or bool(self.queue)
                or self._pending is not None)

    def step(self) -> bool:
        """Admit, then advance every occupied lane one scheduling step.

        A decoding lane consumes exactly one token per step; a prefilling
        lane consumes up to ``prefill_chunk`` prompt tokens (clamped to the
        next page boundary when prefix sharing is on, so every page a
        prefill completes is publishable), or none while it waits on a
        sibling computing the same page (dedup stall). Sync dispatch
        retires the step before returning; async dispatch launches it and
        then retires the previous one, and a step with no lane left drains
        the last. Returns False when idle.
        """
        if self._faulted:
            # quarantine left by a preemption's flush: recover before
            # dispatch, the faulted slot's next token is stale
            self._recover_faulted()
        if self._meter is not None:
            residents, idle_banks = self._meter_residents()
            self._meter.tick(self.clock(), residents, idle_banks)
        self._admit()
        if self.active == 0:
            if self._pending is not None:
                self._flush()                  # drain the in-flight step
                if self._faulted:
                    self._recover_faulted()
                return True
            return False
        launched = self._dispatch()
        self.steps += 1
        if self.async_dispatch:
            prev, self._pending = self._pending, launched
            self._prev_nxt = launched.tokens
            if prev is not None:
                self._retire(prev)   # the host catches up while the card runs
        else:
            self._retire(launched)
        if self._faulted:
            self._recover_faulted()
        return True

    def _flush(self) -> None:
        """Retire the in-flight async step, if any."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._prev_nxt = None
            self._retire(pending)

    def _dispatch(self) -> _Launched:
        """Build this step's batch, launch it, and do the host bookkeeping
        that does not need the token values (those retire later)."""
        chunk = self.prefill_chunk
        n = self.n_lanes
        toks = np.full((n, chunk), self.pad_token, np.int32)
        counts = np.zeros((n,), np.int32)
        feedback = np.zeros((n,), bool)
        # emit[i]: lane i produces a token this launch (decode steps, and
        # the prefill launch consuming the last prompt token); it gates the
        # key advance, so a lane's chain position equals its produced count
        emit = np.zeros((n,), bool)
        pending_emit = ({i: s for i, s in self._pending.meta.emitted}
                        if self._pending is not None else {})
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            if slot.prefilling:
                if self.paged and self.pages is not None:
                    self._try_rematch(slot)
                prompt = slot.request.prompt
                m = min(chunk, len(prompt) - slot.fed)
                if self.pages is not None:
                    m = min(m, self._ps - slot.fed % self._ps)
                if (self.paged and self.pages is not None
                        and self._stalled(slot)):
                    self.stalls += 1
                    continue               # counts[i] stays 0: wait, adopt
                toks[i, :m] = prompt[slot.fed:slot.fed + m]
                counts[i] = m
                emit[i] = slot.fed + m >= len(prompt)
            else:
                counts[i] = 1
                emit[i] = True
                if self.async_dispatch and pending_emit.get(i) is slot:
                    feedback[i] = True     # the token rides on the device
                else:
                    toks[i, 0] = slot.next_token
            if self.paged and counts[i]:
                self._ensure_pages(slot, slot.fed + int(counts[i]))

        nxt = self._launch(toks, counts, feedback, emit)
        meta = _StepMeta([], [])
        charges = []
        if self._meter is not None:
            occupied = {self._slot_bank[i]
                        for i, s in enumerate(self.slots) if s is not None}
            launch_idle_banks = len(set(self._slot_bank)) - len(occupied)
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            c = int(counts[i])
            was_prefilling = slot.prefilling
            if was_prefilling and c == 0:
                continue                   # stalled this step
            if self._meter is not None:
                charges.append((slot.request,
                                "prefill" if was_prefilling else "decode",
                                c, self._page_share(slot)))
            slot.fed += c
            if self.paged:
                self._recycle_dead(slot)   # window crossed: free dead blocks
            if was_prefilling:
                self.prompt_tokens_processed += c
                self._maybe_publish(i, slot)
                if slot.prefilling:
                    # still consuming the prompt: teacher-force the next token
                    slot.next_token = slot.request.prompt[slot.fed]
                    continue
                self._drop_claims(slot)    # prefill done; nothing to claim
            meta.emitted.append((i, slot))
            slot.produced += 1
            self.tokens_generated += 1
            if slot.produced >= slot.request.max_new_tokens:
                # complete once this step's token lands: free the slot now,
                # so the next admission overlaps the in-flight step
                meta.finished.append(slot)
                self._evict(i)
        if self._meter is not None:
            self._meter.charge_step(charges, launch_idle_banks)
        return self._stage(meta, nxt)

    def _launch(self, toks, counts, feedback, emit) -> torch.Tensor:
        """One batched device launch; returns the on-device tokens (sampled
        per lane, the exact argmax for greedy lanes) and advances the
        lanes' keys. The sampling parameters go in as copies of the
        engine's arrays, which admission may rewrite while the launch is in
        flight. A fault plan's draw comes first, before anything reaches
        the device: a ``DeviceStepFault`` leaves device and host state as
        they were, so the step can be retried (page allocation above it
        resumes where it stopped)."""
        if self.chaos is not None:
            self.chaos.launch(self.name)
        prev = self._prev_nxt
        temp, tk, tp = self._temp.copy(), self._topk.copy(), self._topp.copy()
        if not self.paged:
            return self._launch_lanes(toks, counts, feedback, prev, emit,
                                      temp, tk, tp)
        arena = self._arena
        tables, lengths = self._build_tables()
        if self._pchunk is None or int(counts.max()) <= 1:
            self.token_steps += 1
            nxt, self._keys = self._pstep(
                self.params, arena.k, arena.v, tables, lengths, toks[:, 0],
                feedback, prev, counts > 0, emit, self._keys, temp, tk, tp)
        else:
            self.token_steps += int(counts.max())
            nxt, self._keys = self._pchunk(
                self.params, arena.k, arena.v, tables, lengths, toks, counts,
                feedback, prev, emit, self._keys, temp, tk, tp)
        return nxt

    def _stage(self, meta: _StepMeta, nxt: torch.Tensor) -> _Launched:
        """Start the step's tokens on their way to the host: on the card a
        copy into a pinned buffer that does not wait for the device,
        behind an event :meth:`_retire` waits on; on the CPU they are
        there."""
        launched = _Launched(meta, nxt)
        if nxt.device.type == "cuda":
            if not self._pinned:
                self._pinned.append(torch.empty(nxt.shape, dtype=nxt.dtype,
                                                pin_memory=True))
            launched.host = self._pinned.pop()
            launched.host.copy_(nxt, non_blocking=True)
            launched.done = torch.cuda.Event()
            launched.done.record(torch.cuda.current_stream(nxt.device))
        return launched

    def _retire(self, launched: _Launched) -> None:
        """Host-side completion of a dispatched step: wait for its tokens
        and deliver them.

        Every delivered token runs the corruption gate: a token outside
        the vocabulary or failing the journal's replay cross-check is never
        journaled or appended; its slot joins the quarantine
        (``_faulted``) and the request replays (:meth:`_recover_faulted`).
        Slots in ``_skip_retire`` (an in-flight step flushed during
        quarantine recovery) are skipped: their journal position is behind
        this step."""
        if launched.host is None:
            vals = launched.tokens.numpy()
        else:
            launched.done.synchronize()
            vals = launched.host.numpy().copy()
            self._pinned.append(launched.host)
        now = self.clock()
        meta = launched.meta
        for i, slot in meta.emitted:
            if id(slot) in self._skip_retire:
                continue
            tok = int(vals[i])
            if self.chaos is not None:
                tok = self.chaos.deliver_token(self.name, tok)
            ok = 0 <= tok < self.cfg.vocab
            if ok:
                try:
                    self.journal.record_token(slot.request.id, tok)
                except RuntimeError:
                    ok = False             # diverged from the journaled run
            if not ok:
                self.token_faults += 1
                self._faulted.append(slot)
                continue
            if slot.request.first_token_time is None:
                slot.request.first_token_time = now
            slot.request.tokens.append(tok)
            slot.next_token = tok
        faulted = {id(s) for s in self._faulted}
        for slot in meta.finished:
            if id(slot) in self._skip_retire or id(slot) in faulted:
                continue               # quarantined: must replay, not finish
            req = slot.request
            req.finish_time = self.clock()
            self.journal.complete(req.id)
            self.completed.append(req)
            # XAIF end-of-computation interrupt, then the per-request handler
            self.platform.interrupts.fire(COMPLETE_LINE, req)
            if req.on_complete is not None:
                req.on_complete(req)

    def _recover_faulted(self) -> None:
        """Quarantine recovery: replay every faulted request.

        The in-flight async step (if any) is flushed first with the
        quarantined slots masked out; innocent lanes retire normally. Each
        faulted request is then evicted and requeued at the front with its
        bookkeeping reset; re-admission reopens its journal record (the
        tokens before the fault become the ``prior`` run) and
        ``record_token`` cross-checks the replay token for token. A request
        quarantined more than ``max_replays`` times raises."""
        while self._faulted:
            batch, self._faulted = self._faulted, []
            if self._pending is not None:
                self._skip_retire = frozenset(id(s) for s in batch)
                try:
                    self._flush()
                finally:
                    self._skip_retire = frozenset()
            requeue = []
            for slot in sorted(batch, key=lambda s: s.seq):
                req = slot.request
                n = self._replay_counts.get(req.id, 0) + 1
                self._replay_counts[req.id] = n
                if n > self.max_replays:
                    raise RuntimeError(
                        f"request {req.id!r} quarantined {n} times: "
                        "persistent divergence, not transient corruption")
                for i, s in enumerate(self.slots):
                    if s is slot:
                        self._evict(i)
                        break
                # a host-known-finished slot was evicted at dispatch, and a
                # preemption may have requeued the request: queue it once
                if any(r is req for r in self.queue):
                    continue
                req.tokens = []
                req.admit_time = None
                req.first_token_time = req.finish_time = None
                requeue.append(req)
                self.replays += 1
            self.queue.extendleft(reversed(requeue))

    # -- paged-backend plumbing ----------------------------------------------

    def _build_tables(self) -> tuple[np.ndarray, np.ndarray]:
        t = np.full((self.n_lanes, self._np_slot), self._pool.null, np.int32)
        lengths = np.zeros((self.n_lanes,), np.int32)
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            for b, idx in slot.pages_by_block.items():
                t[i, b % self._np_slot] = idx
            lengths[i] = slot.fed
        return t, lengths

    def _ensure_pages(self, slot: _Slot, target: int) -> None:
        """Grow the slot's block table to cover positions [0, target).

        Windowed configs: the table is a ring, so covering a new block
        first recycles whatever older block holds its entry (by then that
        block lies wholly below the window), and a slot never holds more
        than ``ceil(window / page_size) + 1`` pages. An allocation that
        raises (a fault plan's ``AllocFault``) leaves the slot covering
        what it covered, so the step can be retried."""
        need = -(-target // self._ps)
        while slot.blocks_covered < need:
            b = slot.blocks_covered
            self._free_entry(slot, b)
            if not self._pool.free_count:
                if self._reclaim is not None:
                    self._reclaim(self)    # cluster: fair cross-tenant evict
                elif self.pages is not None:
                    self.pages.clear()     # recycle unpinned shared residency
            slot.pages_by_block[b] = self._pool.alloc(self.name)
            slot.blocks_covered = b + 1

    def _free_entry(self, slot: _Slot, b: int) -> None:
        """Ring recycling's backstop: recycle whatever older block holds
        block ``b``'s table entry. Eager recycling (:meth:`_recycle_dead`)
        frees dead blocks the moment they fall out of the window, so this
        fires only where an entry's reuse comes first (a re-match's jump
        landing on an entry whose old block is still in the window). A
        full-width table never puts two blocks on one entry."""
        if self._window is None:
            return
        width = self._np_slot
        for b_old in [o for o in slot.pages_by_block
                      if o % width == b % width and o != b]:
            self._recycle_block(slot, b_old)

    def _recycle_dead(self, slot: _Slot) -> None:
        """Eager window recycling: free (or disown) every block whose
        positions lie wholly below the slot's window the moment ``fed``
        crosses its boundary, so a slot that then stalls holds no dead
        pages while its peers draw on the shared free list."""
        if self._window is None or not slot.pages_by_block:
            return
        first_needed = max(0, slot.fed + 1 - self._window) // self._ps
        for b_old in [b for b in slot.pages_by_block if b < first_needed]:
            self._recycle_block(slot, b_old)

    def _recycle_block(self, slot: _Slot, b_old: int) -> None:
        """Release one out-of-window block: a private page returns to the
        pool's free list; an adopted shared-prefix page is *disowned* (the
        slot's pool reference and table pin released, the table's own
        residency keeping the page for later admissions)."""
        self._pool.release(slot.pages_by_block.pop(b_old))
        key = slot.request.prompt[:(b_old + 1) * self._ps]
        if key in slot.page_keys:
            self.pages.release((key,), self.namespace)
            slot.page_keys = tuple(k for k in slot.page_keys if k != key)
        self.pages_recycled += 1
        self.journal.note_recycle(slot.request.id, 1)

    def _try_rematch(self, slot: _Slot) -> None:
        """Mid-flight prefix re-match: adopt a sibling's freshly published
        pages covering tokens this slot has not computed yet. Pure
        block-table surgery: a partly written private page in the adopted
        range is released (its positions hold what the shared page holds,
        since both ran the same prompt prefix). A windowed slot adopts only
        the blocks its window can still see after the jump; the blocks below
        count as reused and are never pinned."""
        prompt = slot.request.prompt
        m = self.pages.lookup(prompt, self.namespace)
        if m <= slot.fed:
            return
        from_block = slot.fed // self._ps
        if self._window is not None:
            from_block = max(from_block, (m + 1 - self._window) // self._ps)
        ext = self.pages.acquire_range(prompt, from_block, m // self._ps,
                                       self.namespace)
        if not ext:
            return
        adopted = m - slot.fed
        for key, idx in ext:
            self._pool.retain(idx)
            b = len(key) // self._ps - 1
            self._free_entry(slot, b)      # ring: evict the entry's old block
            if b in slot.pages_by_block:
                self._pool.release(slot.pages_by_block[b])
            slot.pages_by_block[b] = idx
        slot.page_keys += tuple(k for k, _ in ext)
        slot.blocks_covered = max(slot.blocks_covered, m // self._ps)
        slot.fed = m
        self._recycle_dead(slot)           # the jump may strand dead blocks
        slot.next_token = prompt[m]
        self.prompt_tokens_reused += adopted
        self.rematches += 1
        self.rematched_tokens += adopted
        self.journal.note_rematch(slot.request.id, adopted)

    def _stalled(self, slot: _Slot) -> bool:
        """Dedup of concurrent identical cold prefills: if another live
        slot already claimed the page this slot would compute next, wait
        (feed nothing this step) and adopt the page when it publishes.
        Claims live in the page table's claim registry, keyed by namespace
        like the pages, and are dropped the moment the claimant crosses the
        page boundary, so a waiter never outlives its claimant's page."""
        prompt = slot.request.prompt
        boundary = (slot.fed // self._ps + 1) * self._ps
        if boundary > len(prompt) - 1:
            return False                   # tail extent: never publishable
        key = prompt[:boundary]
        if self.pages.has(key, self.namespace):
            return False                   # resident: re-match handles it
        claimant = self.pages.claimant(key, self.namespace)
        if claimant is not None and claimant[1] is not slot:
            c_eng, c_slot = claimant
            if any(s is c_slot for s in c_eng.slots) and c_slot.prefilling:
                return True
            self.pages.unclaim(key, self.namespace)   # stale claim: steal it
        self.pages.claim(key, (self, slot), self.namespace)
        if key not in slot.claims:
            slot.claims.append(key)
        return False

    def _drop_claims(self, slot: _Slot) -> None:
        if self.pages is not None:
            for key in slot.claims:
                claimant = self.pages.claimant(key, self.namespace)
                if claimant is not None and claimant[1] is slot:
                    self.pages.unclaim(key, self.namespace)
        slot.claims = []

    # -- lane-backend plumbing -----------------------------------------------

    def _launch_lanes(self, toks, counts, feedback, prev, emit, temp, tk,
                      tp) -> torch.Tensor:
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
            nxt, self._keys = self._lstep(self.params, self._cache,
                                          toks[:, 0], feedback, prev, emit,
                                          self._keys, temp, tk, tp)
        else:
            self.token_steps += int(counts.max())
            nxt, self._keys = self._lchunk(self.params, self._cache, toks,
                                           counts, feedback, prev, emit,
                                           self._keys, temp, tk, tp)
        return nxt

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
        self.pages.unclaim(key, self.namespace)   # computed: the claim is moot
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
        if slot is not None:
            if slot.page_keys:
                self.pages.release(slot.page_keys, self.namespace)
                slot.page_keys = ()
            slot.pending_snapshot = None
            for idx in slot.pages_by_block.values():
                self._pool.release(idx)
            slot.pages_by_block = {}
            self._drop_claims(slot)
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

    # -- preemption -----------------------------------------------------------

    def preempt(self) -> list[Request]:
        """Evict every lane; requeue the in-flight requests at the front in
        FIFO order.

        Decode is deterministic (greedy by argmax; sampled lanes re-seed
        their journaled chain at re-admission), so replay reproduces the
        preempted requests' tokens bit for bit. An in-flight async step is
        retired first: its tokens belong to the run before the preemption
        and seed the journal's cross-check."""
        self._flush()
        inflight = sorted(
            ((i, s) for i, s in enumerate(self.slots) if s is not None),
            key=lambda t: t[1].seq)
        for i, _ in inflight:
            self._evict(i)
        requeued = [s.request for _, s in inflight]
        for req in requeued:
            req.tokens = []
            req.admit_time = req.first_token_time = req.finish_time = None
        self.queue.extendleft(reversed(requeued))
        return requeued

    def preempt_slot(self, i: int, *, front: bool = True) -> Request | None:
        """Preempt one slot: evict lane ``i`` and requeue its request at the
        queue's front (default, FIFO like :meth:`preempt`) or its back
        (``front=False``: it finishes after the work queued behind it).
        Its replay runs through the journal as :meth:`preempt`'s does; an
        in-flight async step is retired first. Returns the requeued
        request, or None when the slot is empty (perhaps because that
        retire completed it)."""
        self._flush()
        slot = self.slots[i]
        if slot is None:
            return None
        self._evict(i)
        req = slot.request
        req.tokens = []
        req.admit_time = req.first_token_time = req.finish_time = None
        if front:
            self.queue.appendleft(req)
        else:
            self.queue.append(req)
        return req

    # -- convenience ----------------------------------------------------------

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        """Step until queue and slots drain (raises if still busy after
        ``max_steps``)."""
        for _ in range(max_steps):
            if not self.step():
                return
        raise RuntimeError(f"engine still busy after {max_steps} steps")

    def drain_completed(self) -> list[Request]:
        """Hand off finished requests and release their retained state
        (journal records, ids, which become reusable), so a long-running
        loop's history stays bounded."""
        done, self.completed = self.completed, []
        for req in done:
            self.journal.evict(req.id)
            self._ids.discard(req.id)
            self._replay_counts.pop(req.id, None)
        return done

    def occupancy(self) -> dict:
        """Point-in-time load for a scheduler: slot and queue occupancy,
        and this engine's slice of the (possibly shared) page pool."""
        out = {
            "slots": self.n_slots,
            "active": self.active,
            "slots_free": self.n_slots - self.active,
            "queued": len(self.queue),
        }
        if self._pool is not None:
            out.update(pool_free=self._pool.free_count,
                       pool_in_use=self._pool.in_use,
                       pool_pages_held=self._pool.in_use_by(self.name))
        return out

    def step_cost(self) -> int:
        """Tokens the next :meth:`step` would feed the device (one a
        decoding lane, up to ``prefill_chunk`` a prefilling one): the cost
        a cluster's deficit round-robin weighs admissions with."""
        cost = 0
        for slot in self.slots:
            if slot is None:
                continue
            if slot.prefilling:
                cost += min(self.prefill_chunk,
                            len(slot.request.prompt) - slot.fed)
            else:
                cost += 1
        return cost

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
            "async_dispatch": self.async_dispatch,
            "tp": self.tp,
            "window": self._window,
            "table_entries_per_slot": self._np_slot if self.paged else None,
            "pages_recycled": self.pages_recycled,
            "stalls": self.stalls,
            "admission_stalls": self.admission_stalls,
            "rematches": self.rematches,
            "rematched_tokens": self.rematched_tokens,
            "completed": len(self.completed),
            "sampled_requests": self.sampled_requests,
            "rejected": self.rejected,
            "shed": self.shed,
            "token_faults": self.token_faults,
            "replays": self.replays,
            "queued": len(self.queue),
            "active": self.active,
            "journal": self.journal.size(),
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
                               occupancy=round(
                                   self._pool.in_use / self._pool.n_pages, 4),
                               held_by_engine=self._pool.in_use_by(self.name),
                               shared=not self.owns_pool)
        return out
