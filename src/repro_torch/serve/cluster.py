"""Multi-model serving cluster: N engines, one pool, one power budget.

Port of ``src/repro/serve/cluster.py``. The scheduler is host code, the
same as the reference's: its grants, deficits, sheds, stalls, preemptions,
reclaims and fault handling depend on lengths, the clock and the fault
plan's draws, never on token values, so for the same trace the port's
schedule equals the reference's. Its engines run on ``device`` (the card
by default), or a tenant on a mesh on its mesh's shards: every tenant's
arena lives there, and every tenant's launches go on the device's current
stream, one after another, which the paged kernel's shared merge counters
need.

This is the serving rendition of the paper's HEEPocrates example — several
heterogeneous compute units (there: CGRA, IMC, crypto accelerators; here:
per-model :class:`~repro_torch.serve.engine.ContinuousBatchingEngine` instances)
running concurrently against **one** bus/memory pool (here: one
:class:`~repro_torch.serve.paged.PagePool` + one
:class:`~repro_torch.serve.pages.PageTable`) and **one** power manager budget
(here: a :class:`PowerBudget` over the shared
:class:`~repro_torch.core.power.PowerManager`). The cluster owns allocation; the
engines are tenants.

What the :class:`ServeCluster` arbitrates:

* **Admission (weighted round-robin).** Every cluster step opens a round
  of per-engine admission grants equal to each tenant's ``weight``
  (default: its slot count, i.e. unthrottled); an engine that spent its
  grants waits for the next round, so a down-weighted tenant's burst
  admits at a bounded rate instead of starving its peers' share of the
  power/pool budget. Engine order rotates per step so ties break fairly.
* **SLO-aware scheduling (opt-in via** :class:`SchedPolicy` **).** The
  ``"drr"`` scheduler replaces flat per-round grants with deficit-weighted
  round-robin over each engine's actual :meth:`step_cost` — lightly loaded
  tenants bank credit and admit; saturated ones wait. ``shed_busted``
  drops queue heads that have already blown their TTFT target (open-loop
  overload serves *fresh* work instead of a stale backlog), and
  ``preempt_busted`` demotes decoding requests past their end-to-end
  deadline to the back of the queue — they replay bit-identically from
  the journal, so SLO enforcement never changes any request's tokens.
* **Power-budget backpressure.** Before an engine admits into a slot, the
  cluster checks whether waking that slot's memory bank would exceed the
  :class:`PowerBudget`. If it would, the admission *stalls* (the request
  stays at the queue head, FIFO intact) instead of exceeding the budget —
  the scheduling analogue of X-HEEP refusing to power up a domain the
  envelope cannot carry. Slots whose bank is already awake ride for free
  (banks are refcount-shared across engines).
* **Fair cross-tenant reclaim.** When the shared pool runs dry, the
  cluster evicts unpinned prefix residency LRU-first from the *namespace
  holding the most evictable pages*, instead of wiping every tenant's
  warm cache at once. (Unlike an engine-private table, the cluster table
  is not platform-wired: resident pages do not hold banks awake, so a
  warm cache can never carry the platform past the power budget — the
  budget governs slot-driven wakes only.)
* **Prefix sharing across engines.** Engines serving the same model (same
  config + weights) declare the same ``namespace`` and alias each other's
  published prefix pages — pool ids are globally valid, so adoption is
  block-table pointing even across engines. Different namespaces never
  alias (same token ids under different weights are different states).
  Sliding-window tenants participate like any other engine (ring block
  tables): their recycled pages return to the *shared* free list,
  so an SWA tenant's O(window) footprint frees budget for its peers.
* **Data-parallel replica groups.** :meth:`add_replica_group` builds N
  same-model engines, each pinned to its own mesh slice (each member's
  page arena and sharded params live only on its own shards — see
  :mod:`repro_torch.serve.paged`; build the slices with
  :func:`repro_torch.launch.mesh.replica_meshes`), addressable under one
  group name: :meth:`submit` routes group traffic with prefix affinity
  (requests sharing a first page land on the same member, so
  intra-replica prefix dedup keeps working), falling back to least-loaded
  with round-robin tie-breaks. Members get per-replica table namespaces
  (``ns@r0``, ``ns@r1``, …) because page *bytes* live on the owning
  replica's devices — a sibling cannot adopt them by block-table
  pointing, so cross-replica aliasing is deliberately off.
  :meth:`drain_replica` live-migrates a member's work onto its siblings
  (elastic scale-in): preempt flushes its tokens to the journal, each
  in-flight record is :meth:`~repro_torch.runtime.ft.RequestJournal.
  transfer`-red into a sibling's journal, and replay there is
  cross-checked token-for-token against the drained member's output —
  migration meets the same bit-identity bar as crash rebuild.

Invariants (held by ``tests/test_torch_cluster.py``):

* **Per-engine bit-identity.** A request's tokens are identical whether
  its engine runs alone or as a cluster tenant — sharing, stalls, and
  reclaim are scheduling/memory effects only, never numerical ones.
* **The budget is never exceeded.** Admissions stall rather than wake a
  bank past the budget; a budget so tight that no progress is possible
  raises loudly instead of spinning.
* **Preempt/replay stays per-engine deterministic.** ``preempt()``
  flushes and requeues every tenant; each engine's journal cross-checks
  its own replay tokens (the :class:`~repro_torch.runtime.ft.ClusterJournal`
  keeps them separate). This holds for stochastic traffic too: a
  request's :class:`~repro_torch.serve.sampling.SamplingParams` ride on the
  :class:`~repro_torch.serve.engine.Request` through every scheduler move
  (shed exemption, ``preempt_busted`` demotion, full preemption), and
  re-admission re-seeds the journaled per-request PRNG chain — so
  sampled tokens, like greedy ones, are bit-identical whichever policy
  served them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch import device as device_mod
from repro_torch.core.energy import operating_point
from repro_torch.core.platform import Platform, XHeepConfig
from repro_torch.core.power import PowerState
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.ft import ClusterJournal, FTConfig, FTController
from repro_torch.serve.chaos import AllocFault, DeviceStepFault
from repro_torch.serve.engine import SHED, ContinuousBatchingEngine, Request
from repro_torch.serve.paged import PagePool, pool_signature
from repro_torch.serve.pages import PageTable
from repro_torch.serve.sampling import SamplingParams

__all__ = ["PowerBudget", "SchedPolicy", "ServeCluster", "awake_banks"]

# XAIF interrupt lines the fault-recovery layer raises on the platform
CRASH_LINE = "chaos.engine_crash"    # payload: engine name
BANK_FAULT_LINE = "chaos.bank_fault"  # payload: (engine name, bank name)


def awake_banks(platform) -> int:
    """Bank domains currently ``ON`` — the one predicate both the budget
    enforcement and the cluster's introspection count with (a single
    definition keeps the enforced and the reported quantity identical)."""
    return sum(1 for name, state in platform.power.states.items()
               if name.startswith("bank") and state is PowerState.ON)


@dataclasses.dataclass(frozen=True)
class PowerBudget:
    """Envelope the cluster must stay inside when waking memory banks.

    ``max_awake_banks`` caps the number of bank domains in the ``ON``
    state at once (the paper's power-gating view: only so many domains may
    be powered). ``budget_uw`` caps the platform's total µW at
    ``freq_mhz`` instead (meaningful when the platform's domains carry
    real leakage/dynamic coefficients). Either or both may be set; a bank
    that is already awake never re-charges the budget.

    Two energy-aware levers richer than a stall:

    * ``throttle_point`` — the DVFS analogue of the paper's §IV-D curve:
      instead of stalling the first admission that would bust the
      envelope, drop the target engine's metered operating point to this
      name (e.g. ``"nominal"`` — calibrated ~5.9× lower power than
      ``"max"``) and admit. An engine already throttled to the point
      stalls as before, so the budget still binds.
    * ``max_uj_per_token`` — energy-aware admission control: shed a
      queue head when the engine's projected marginal joules/token
      exceeds the cap (a per-request ``energy_cap_uj_per_token``
      overrides this cluster-wide default).
    """

    max_awake_banks: int | None = None
    budget_uw: float | None = None
    freq_mhz: float = 100.0
    throttle_point: str | None = None
    max_uj_per_token: float | None = None

    def __post_init__(self):
        if (self.max_awake_banks is None and self.budget_uw is None
                and self.max_uj_per_token is None):
            raise ValueError("budget needs max_awake_banks, budget_uw, or "
                             "max_uj_per_token")
        if self.max_awake_banks is not None and self.max_awake_banks < 1:
            raise ValueError("max_awake_banks must be >= 1 (0 can never "
                             "admit anything)")
        if self.max_uj_per_token is not None and self.max_uj_per_token <= 0:
            raise ValueError("max_uj_per_token must be > 0")
        if self.throttle_point is not None:
            operating_point(self.throttle_point)   # fail fast on typos

    def would_exceed(self, platform, bank: str) -> bool:
        """True when waking ``bank`` (if it is not already ``ON``) would
        push the platform past this budget. Pure query — no state is
        touched."""
        power = platform.power
        if power.state(bank) is PowerState.ON:
            return False
        if self.max_awake_banks is not None:
            if awake_banks(platform) + 1 > self.max_awake_banks:
                return True
        if self.budget_uw is not None:
            dom = power.domains[bank]
            now = power.power_uw(self.freq_mhz)
            delta = (dom.power_uw(PowerState.ON, 0.0, self.freq_mhz)
                     - dom.power_uw(power.state(bank), 0.0, self.freq_mhz))
            if now + delta > self.budget_uw:
                return True
        return False


@dataclasses.dataclass(frozen=True)
class SchedPolicy:
    """How the cluster arbitrates admission and slot tenure.

    ``scheduler`` selects the grant discipline per scheduling round:

    * ``"wrr"`` (default) — flat weighted round-robin: each tenant gets
      ``weight`` admission grants per round, regardless of how much work
      its slots already carry.
    * ``"drr"`` — deficit-weighted round-robin over
      :meth:`~repro_torch.serve.engine.ContinuousBatchingEngine.step_cost`:
      each round a tenant banks ``max(0, quantum·weight − step_cost())``
      *token* credits (a loaded engine accrues slowly, an idle one fast),
      capped at ``deficit_cap·quantum·weight``, and an admission charges
      the request's full token cost (prompt + max_new_tokens). Admission
      pace thus follows committed device work, not just slot counts.

    The two SLO levers are independent of the grant discipline:

    * ``shed_busted`` — latency-SLO admission control: a queue head whose
      TTFT target is already blown is dropped (shed) instead of admitted;
      under overload, capacity goes to requests that can still meet their
      SLO. A request the scheduler itself previously demoted is exempt —
      it already holds journal state and must finish.
    * ``preempt_busted`` — preempt-and-requeue of SLO-busting long tails:
      a decoding request whose :meth:`~repro_torch.serve.metrics.SLO.deadline`
      has passed while peers queue is evicted and re-queued at the *back*
      (at most once per request; journal replay reproduces its tokens
      bit-for-bit), freeing the slot for salvageable work.
    """

    scheduler: str = "wrr"
    quantum: int = 16        # drr: token credits banked per weight per round
    deficit_cap: int = 4     # drr: max rounds of unspent credit banked
    shed_busted: bool = False
    preempt_busted: bool = False

    def __post_init__(self):
        if self.scheduler not in ("wrr", "drr"):
            raise ValueError(f"unknown scheduler {self.scheduler!r} "
                             "(one of 'wrr', 'drr')")
        if self.quantum < 1:
            raise ValueError("quantum must be >= 1 token")
        if self.deficit_cap < 1:
            raise ValueError("deficit_cap must be >= 1 round")


class ServeCluster:
    """N continuous-batching engines over one pool, table, and platform.

    The cluster owns the shared resources (``pool_pages`` KV pages of
    ``page_size`` tokens, one prefix :class:`PageTable`, one
    :class:`~repro_torch.core.platform.Platform`) and constructs its tenant
    engines via :meth:`add_engine` — engines never allocate for
    themselves. :meth:`step` advances every tenant once on the shared
    clock; admission inside each engine step is arbitrated by the
    cluster's weighted-round-robin grants and the optional
    :class:`PowerBudget`. ``device`` (default None: the card, which raises
    without one) is the device of every tenant without a mesh and its
    arena's; the params given to :meth:`add_engine` must live there. A
    tenant on a mesh (``mesh=`` to :meth:`add_engine`, or a replica
    group's member) runs on its mesh's shards.
    """

    def __init__(self, *, pool_pages: int, page_size: int = 16,
                 platform=None, clock: Callable[[], float] = lambda: 0.0,
                 capacity_pages: int | None = None,
                 power_budget: PowerBudget | None = None,
                 journal: ClusterJournal | None = None,
                 policy: SchedPolicy | None = None,
                 chaos=None,
                 watchdog: FTConfig | None = None,
                 journal_horizon: int | None = None,
                 max_fault_streak: int = 8,
                 degrade_streak: int = 3,
                 device=None):
        self.device = device_mod.resolve(device)
        owns_platform = platform is None
        self.platform = platform or Platform(XHeepConfig())
        self.clock = clock
        self.budget = power_budget
        self.pool = PagePool(pool_pages, page_size)
        # deliberately NOT platform-wired: an engine-private table holds
        # its resident pages' banks awake (the SRAM-retention analogue),
        # but here bank wakes are governed by the admission-time power
        # budget, and residency waking banks behind the budget's back
        # would let warm caches exceed the envelope. Cluster residency is
        # power-free; the budget caps compute-driven (slot) wakes only.
        self.table = PageTable(
            page_size,
            capacity_pages=(capacity_pages if capacity_pages is not None
                            else pool_pages),
            on_evict=self.pool.release)
        self.journal = journal or ClusterJournal(horizon=journal_horizon)
        self.policy = policy or SchedPolicy()
        self.engines: dict[str, ContinuousBatchingEngine] = {}
        self._weights: dict[str, int] = {}
        self._grants: dict[str, int] = {}
        self._deficit: dict[str, float] = {}  # drr: banked token credits
        self._ns_identity: dict[str, tuple] = {}
        self._rr_offset = 0
        self.steps = 0
        self.power_stalls = 0          # admissions stalled by the budget
        self.dvfs_throttles = 0        # engines dropped to the throttle point
        self.energy_sheds = 0          # heads shed by the joules/token cap
        self.wrr_stalls = 0            # admissions deferred to the next round
        self.sheds = 0                 # SLO-busted heads dropped at admission
        self.slo_preempts = 0          # SLO-busting tails demoted to the back
        self.reclaims: dict[str, int] = {}   # namespace -> pages reclaimed
        # -- fault injection + recovery --------------------------------------
        # chaos (a repro_torch.serve.chaos.FaultPlan, or None) is shared with
        # every tenant engine; the cluster additionally draws per-step
        # crash and bank faults and wires the pool/table hooks
        self.chaos = chaos
        if chaos is not None:
            self.pool.fault_hook = chaos.alloc
            self.table.fault_hook = chaos.drop_prefix
        # per-engine watchdog: each tenant is one FTController worker —
        # heartbeats on every successful step, coordinator-observed
        # failures on crash, restart_delay() gating every rebuild. Built
        # whenever fault handling is live (explicit config or any chaos)
        self.watchdog = (FTController(0, watchdog or FTConfig(),
                                      clock=clock)
                         if watchdog is not None or chaos is not None
                         else None)
        self.max_fault_streak = max_fault_streak
        self.degrade_streak = degrade_streak
        self._watch_ids: dict[str, int] = {}    # engine name -> worker id
        self._fault_streak: dict[str, int] = {}  # consecutive step faults
        self._backoff: dict[str, int] = {}      # rounds left to sit out
        self._down: dict[str, int] = {}         # crashed: rounds to restart
        self._lost: dict[str, list[Request]] = {}   # queue at crash time
        self._tenants: dict[str, tuple] = {}    # rebuild recipe per engine
        # submission log (request handles for crash re-admission); only
        # kept while fault handling is live, pruned of finished work at
        # every rebuild
        self._requests: dict[str, dict[str, Request]] = {}
        # -- data-parallel replica groups -------------------------------------
        self._groups: dict[str, list[str]] = {}   # group -> member engines
        self._group_rr: dict[str, int] = {}       # routing tie-break cursor
        self._group_hint: dict[str, dict[tuple, str]] = {}  # first page->home
        self.migrations = 0            # journal records handed to siblings
        self.step_faults = 0           # device launches that raised
        self.alloc_faults = 0          # pool allocations that raised
        self.retries = 0               # engine steps retried after a fault
        self.crashes = 0               # engines that lost host state
        self.bank_faults = 0           # bank power-faults applied
        self.rebuilds = 0              # engines rebuilt from the journal
        if owns_platform:
            # our own platform: the idle bank pool starts gated (same rule
            # the engine applies when it owns its platform)
            for i in range(self.platform.config.n_banks):
                self.platform.power.clock_gate(f"bank{i}")

    # -- tenancy ---------------------------------------------------------------

    def add_engine(self, cfg: ModelConfig, params, *, name: str, slots: int,
                   max_len: int, namespace: str | None = None,
                   weight: int | None = None,
                   **engine_kwargs) -> ContinuousBatchingEngine:
        """Construct a tenant engine on the cluster's shared resources.

        ``namespace`` defaults to ``cfg.name``; engines may share one
        namespace **only** when they serve the same model — same config
        *and* the **same parameter tree object** — because namespace peers
        alias each other's prefix pages bitwise. Replicas must be handed
        one shared params tree (load the checkpoint once, pass it to every
        replica): identity is checked by object, since shape-equal trees
        with different weights would silently corrupt aliased pages, and
        sharing the host copy is the memory-sane layout anyway. ``weight``
        is the engine's admission grants per scheduling round; the default
        (``slots``) lets a tenant fill every free slot each round, exactly
        like an isolated engine — lower it to pace a tenant's admissions
        relative to its peers.
        """
        if name in self.engines or name in self._groups:
            raise ValueError(f"duplicate target name {name!r}")
        if not registry.supports_paged(cfg):
            raise ValueError(
                f"{cfg.name} ({cfg.family}) cannot join the cluster: the "
                "shared pool/table requires the paged backend")
        if weight is None:
            weight = slots
        if weight < 1:
            raise ValueError("weight must be >= 1")
        ns = cfg.name if namespace is None else namespace
        identity = (pool_signature(cfg), cfg, id(params))
        prior = self._ns_identity.get(ns)
        if prior is not None and prior != identity:
            raise ValueError(
                f"namespace {ns!r} already serves a different model: "
                "namespace peers alias each other's prefix pages, so they "
                "must share config and weights exactly")
        self._ns_identity[ns] = identity
        eng = self._build_engine(cfg, params, ns, name,
                                 dict(slots=slots, max_len=max_len,
                                      **engine_kwargs))
        self.engines[name] = eng
        self._weights[name] = weight
        self._deficit[name] = 0.0
        self._tenants[name] = (cfg, params, ns,
                               dict(slots=slots, max_len=max_len,
                                    **engine_kwargs))
        if self.watchdog is not None:
            self._watch_ids[name] = self.watchdog.add_worker()
        return eng

    def _build_engine(self, cfg, params, ns: str, name: str,
                      kwargs: dict) -> ContinuousBatchingEngine:
        """One construction path for both first build and crash rebuild:
        the tenant always lands on the cluster's shared resources (a
        tenant on a mesh on its mesh: ``kwargs`` keeps it for the
        rebuild)."""
        return ContinuousBatchingEngine(
            cfg, params,
            device=self.device if kwargs.get("mesh") is None else None,
            platform=self.platform, clock=self.clock,
            journal=self.journal.journal(name),
            pool=self.pool, page_table=self.table,
            namespace=ns, name=name,
            admission_hook=self._admission_hook,
            reclaim=self._reclaim,
            chaos=self.chaos,
            **kwargs)

    def add_replica_group(self, cfg: ModelConfig, params, *, name: str,
                          slots: int, max_len: int, meshes,
                          namespace: str | None = None,
                          weight: int | None = None,
                          **engine_kwargs) -> list[str]:
        """Construct a data-parallel replica group: one member engine per
        entry of ``meshes`` (a :class:`~repro_torch.launch.mesh.Mesh` pins
        that member's arena + sharded params to its shards — build the
        slices with :func:`repro_torch.launch.mesh.replica_meshes`;
        ``None`` means an unsharded member on the cluster's device).
        Members are named ``{name}/r{i}`` and land in per-replica table
        namespaces ``{ns}@r{i}``: page bytes live only on the owning
        replica's shards, so siblings must not alias each other's prefix
        pages — sharing happens *within* a replica, steered there by the
        group router's prefix affinity. Submit to the group name; the
        cluster routes (:meth:`route`). Returns the member names."""
        meshes = list(meshes)
        if not meshes:
            raise ValueError("a replica group needs at least one mesh "
                             "(use None entries for unsharded members)")
        if name in self.engines or name in self._groups:
            raise ValueError(f"duplicate target name {name!r}")
        ns = cfg.name if namespace is None else namespace
        members = []
        for i, mesh in enumerate(meshes):
            member = f"{name}/r{i}"
            self.add_engine(cfg, params, name=member, slots=slots,
                            max_len=max_len, namespace=f"{ns}@r{i}",
                            weight=weight, mesh=mesh, **engine_kwargs)
            members.append(member)
        self._groups[name] = members
        self._group_rr[name] = 0
        self._group_hint[name] = {}
        return list(members)           # a copy: the group's own roster mutates

    @property
    def targets(self) -> set[str]:
        """Every name :meth:`submit` accepts: engines plus replica groups
        (what a trace may tag; the simulator validates against this)."""
        return set(self.engines) | set(self._groups)

    def route(self, group: str, request: Request) -> str:
        """Pick the member of ``group`` that serves ``request``.

        Deterministic three-step policy: (1) **prefix affinity** — the
        prompt's first page of tokens looks up the member that last homed
        that prefix, so shared-prefix traffic co-locates and the member's
        intra-namespace dedup/adoption machinery fires exactly as it
        would on a single engine; (2) a cold prefix goes to the **least
        loaded** member (queued + active), (3) ties broken **round-robin**
        so a cold burst spreads instead of piling onto member 0. The
        winner becomes the prefix's home for subsequent arrivals."""
        members = self._groups[group]
        hints = self._group_hint[group]
        key = tuple(request.prompt[:self.pool.page_size])
        target = hints.get(key)
        if target is None:
            off = self._group_rr[group] % len(members)
            order = members[off:] + members[:off]
            self._group_rr[group] += 1
            target = min(order, key=lambda m: (len(self.engines[m].queue)
                                               + self.engines[m].active))
            hints[key] = target
        return target

    def submit(self, name: str, request: Request) -> bool:
        """Enqueue ``request`` on engine ``name`` — or, when ``name`` is a
        replica group, on the member :meth:`route` picks. Engine
        backpressure applies: False = rejected and counted there."""
        if name in self._groups:
            name = self.route(name, request)
        ok = self.engines[name].submit(request)
        if ok and self.watchdog is not None:
            # keep the client's handle: after a crash the rebuild re-admits
            # in-flight work onto these exact objects, so arrival times and
            # completion callbacks survive the engine's death
            self._requests.setdefault(name, {})[request.id] = request
        return ok

    def drain_replica(self, group: str, member: str) -> dict[str, list[str]]:
        """Live-migrate every request on ``member`` onto its group
        siblings and retire the member (elastic scale-in).

        The drain reuses the crash-recovery plumbing, but *losslessly*:
        ``preempt()`` first retires any in-flight device step (its tokens
        are journaled, not dropped) and requeues the member's residents in
        FIFO order; each journaled record is then
        :meth:`~repro_torch.runtime.ft.RequestJournal.transfer`-red into a
        sibling's journal (round-robin over siblings, FIFO preserved
        per destination) and the request resubmitted there — the sibling
        replays it with every regenerated token cross-checked against
        the drained member's output, so migration is bit-identical by
        construction, not by luck. The member's table namespace is then
        evicted (its page bytes live on devices we are giving up) and the
        engine removed from every cluster registry and the group. Returns
        ``{sibling: [migrated request ids]}``."""
        if group not in self._groups:
            raise ValueError(f"unknown replica group {group!r}")
        members = self._groups[group]
        if member not in members:
            raise ValueError(f"{member!r} is not a member of {group!r}")
        siblings = [m for m in members if m != member and m in self.engines]
        if not siblings:
            raise ValueError(f"cannot drain {member!r}: it is the last "
                             f"replica of {group!r}")
        if member in self._down:
            raise ValueError(f"{member!r} is down — crashed members go "
                             "through rebuild_engine, not a live drain")
        eng = self.engines[member]
        eng.preempt()                  # flush in-flight tokens to the journal
        moving = list(eng.queue)
        eng.queue.clear()
        src = self.journal.journal(member)
        moved: dict[str, list[str]] = {m: [] for m in siblings}
        for i, req in enumerate(moving):
            dest = siblings[i % len(siblings)]
            if src.has(req.id):
                self.journal.journal(dest).adopt(src.transfer(req.id))
                self.migrations += 1
            if not self.engines[dest].submit(req):
                raise RuntimeError(
                    f"drain of {member!r} would drop {req.id!r}: sibling "
                    f"{dest!r} rejected it (queue capacity) — migration "
                    "must be lossless, raise capacity or drain later")
            if self.watchdog is not None:
                self._requests.setdefault(dest, {})[req.id] = req
            moved[dest].append(req.id)
        # the member's prefix pages live on devices we are releasing:
        # evict its namespace (unpinned now — preempt dropped every pin)
        ns = eng.namespace
        while self.table.evict_lru(1, ns=ns):
            pass
        # re-home future traffic: hints that pointed at the member re-route
        hints = self._group_hint[group]
        for k in [k for k, v in hints.items() if v == member]:
            del hints[k]
        members.remove(member)
        del self.engines[member]
        for reg in (self._weights, self._grants, self._deficit,
                    self._tenants, self._requests, self._fault_streak,
                    self._backoff, self._lost, self._watch_ids):
            reg.pop(member, None)
        self._ns_identity.pop(ns, None)
        return moved

    # -- arbitration -----------------------------------------------------------

    def _admission_hook(self, eng, slot_idx: int, request):
        """Per-admission veto, called from inside each engine's step:
        latency-SLO admission control first (``SHED`` drops a head that
        can no longer meet its TTFT target), then the scheduler budget
        (one WRR grant, or the request's token cost against the engine's
        DRR deficit), then the power budget for the slot's bank. Returns
        True to admit, False to skip this slot (power vetoes are per-slot
        — another slot's bank may already be awake), None to end the
        engine's admission scan (a spent budget is engine-global), or
        ``SHED`` to drop the head outright.

        Graceful degradation under sustained faults: an engine whose
        fault streak reached ``degrade_streak`` sheds SLO-blown heads
        even when the policy's ``shed_busted`` is off — recovery steps
        already charged the backlog's TTFT, so serving a head that can
        no longer make its target would spend post-fault capacity on
        worthless work."""
        degraded = self._fault_streak.get(eng.name, 0) >= self.degrade_streak
        if self.policy.shed_busted or degraded:
            slo = getattr(request, "slo", None)
            # a head holding journal state (scheduler-demoted, crash-
            # recovered, or corruption-replayed) must finish — shedding it
            # would leave an in-flight record that the next crash rebuild
            # resurrects, double-accounting the request. Shedding applies
            # to fresh heads only
            if (slo is not None and slo.ttft is not None
                    and request.slo_preempts == 0
                    and not eng.journal.has(request.id)
                    and request.arrival_time is not None
                    and self.clock() - request.arrival_time > slo.ttft):
                self.sheds += 1
                return SHED
        if self.budget is not None or getattr(
                request, "energy_cap_uj_per_token", None) is not None:
            # energy-aware admission control: shed a head whose projected
            # marginal joules/token busts its cap (per-request cap wins
            # over the cluster-wide budget default). Same journal-state
            # exemption as the TTFT shed: demoted/replayed heads must
            # finish, so only fresh heads are sheddable
            cap = getattr(request, "energy_cap_uj_per_token", None)
            if cap is None and self.budget is not None:
                cap = self.budget.max_uj_per_token
            meter = getattr(eng, "_meter", None)
            if (cap is not None and meter is not None
                    and request.slo_preempts == 0
                    and not eng.journal.has(request.id)
                    and meter.projected_uj_per_token() > cap):
                self.energy_sheds += 1
                return SHED
        if self.policy.scheduler == "drr":
            cost = len(request.prompt) + request.max_new_tokens
            if self._deficit.get(eng.name, 0.0) < cost:
                self.wrr_stalls += 1
                return None
        elif self._grants.get(eng.name, 0) <= 0:
            self.wrr_stalls += 1
            return None
        bank = eng._slot_bank[slot_idx]
        if self.budget is not None and self.budget.would_exceed(
                self.platform, bank):
            # DVFS throttle: the first violation on a metered engine that
            # is not yet at the throttle point drops it there (the paper's
            # §IV-D move — calibrated ~5.9× platform power) and admits;
            # an already-throttled engine stalls as before, so the
            # envelope still binds
            meter = getattr(eng, "_meter", None)
            if (self.budget.throttle_point is not None and meter is not None
                    and meter.point.name != self.budget.throttle_point):
                eng.set_operating_point(self.budget.throttle_point)
                self.dvfs_throttles += 1
            else:
                self.power_stalls += 1
                return False
        if self.policy.scheduler == "drr":
            self._deficit[eng.name] -= (len(request.prompt)
                                        + request.max_new_tokens)
        else:
            self._grants[eng.name] -= 1
        return True

    def _reclaim(self, eng) -> None:
        """Pool pressure: evict unpinned prefix residency, LRU within the
        namespace currently holding the most evictable pages (fair across
        tenants — the heaviest idle footprint pays first). One page per
        iteration is deliberate: eviction stops the moment a pool page
        actually frees, so the warm cache loses the minimum — the rescan
        per evicted page is the price of that minimality, fine at this
        pool's scale."""
        while not self.pool.free_count:
            evictable = self.table.unpinned_by_ns()
            if not evictable:
                return                 # nothing reclaimable: alloc will raise
            ns = max(sorted(evictable), key=lambda n: evictable[n])
            if not self.table.evict_lru(1, ns=ns):
                return
            self.reclaims[ns] = self.reclaims.get(ns, 0) + 1

    # -- the cluster step ------------------------------------------------------

    @property
    def busy(self) -> bool:
        """True while any tenant has queued or in-flight work — including
        a crashed tenant whose journaled work is waiting out its restart
        backoff (its slots and queue are empty, but the work is not)."""
        return bool(self._down) or any(e.busy for e in self.engines.values())

    def _preempt_busted(self) -> None:
        """SLO enforcement: demote any decoding request that has already
        blown past its end-to-end deadline while fresh work waits in its
        engine's queue. The long tail goes to the *back* of the queue (it
        already missed; the fresh head may still make its target) and is
        replayed bit-identically from the journal when re-admitted. At
        most once per request — a second demotion could livelock."""
        for name, eng in self.engines.items():
            if not eng.queue:
                continue
            now = self.clock()
            for i, slot in enumerate(eng.slots):
                if slot is None or slot.prefilling or slot.produced < 1:
                    continue
                req = slot.request
                slo = getattr(req, "slo", None)
                if (slo is None or req.slo_preempts > 0
                        or req.arrival_time is None
                        or now <= slo.deadline(req.arrival_time,
                                               req.max_new_tokens)):
                    continue
                if eng.preempt_slot(i, front=False) is not None:
                    req.slo_preempts += 1
                    self.slo_preempts += 1
                    self.journal.journal(name).note_slo_preempt(req.id)

    def step(self) -> bool:
        """One scheduling round: inject any scheduled cluster faults
        (chaos), preempt SLO-busted long tails (if the policy says so),
        refill every tenant's admission budget — flat WRR grants, or DRR
        deficits accumulated against each engine's actual
        ``step_cost()`` — then advance each engine one step (order
        rotates per round). A tenant sitting out a fault backoff or a
        crash-restart delay counts as progress (deliberate idling, not a
        deadlock); a transient :class:`~repro_torch.serve.chaos.
        DeviceStepFault` / :class:`~repro_torch.serve.chaos.AllocFault` from an
        engine step is counted, backed off exponentially (in rounds),
        and retried — past ``max_fault_streak`` consecutive faults it
        raises. Returns False when every tenant is idle; raises when
        queued work exists but the power budget lets nothing run (a
        budget deadlock — stalling forever would spin silently)."""
        if self.chaos is not None:
            self._inject_cluster_faults()
        if self.policy.preempt_busted:
            self._preempt_busted()
        if self.policy.scheduler == "drr":
            q = self.policy.quantum
            for name, eng in self.engines.items():
                if not eng.busy:
                    # idle tenants bank no deficit: DRR shares the *busy*
                    # period, it does not let an idle tenant hoard credit
                    self._deficit[name] = 0.0
                    continue
                w = self._weights.get(name, 1)
                gain = max(0.0, q * w - eng.step_cost())
                cap = self.policy.deficit_cap * q * w
                self._deficit[name] = min(cap, self._deficit[name] + gain)
        else:
            self._grants = dict(self._weights)
        names = list(self.engines)
        if names:
            off = self._rr_offset % len(names)
            names = names[off:] + names[:off]
            self._rr_offset += 1
        launched = False
        for name in names:
            if name in self._down:
                self._down[name] -= 1
                if self._down[name] <= 0:
                    self.rebuild_engine(name)
                launched = True        # restart progress, not a deadlock
                continue
            if self._backoff.get(name, 0) > 0:
                self._backoff[name] -= 1
                launched = True        # deliberate fault backoff
                continue
            eng = self.engines[name]
            try:
                stepped = eng.step()
            except (DeviceStepFault, AllocFault) as e:
                self._note_fault(name, e)
                launched = True        # the retry is scheduled work
                continue
            if stepped:
                self._fault_streak[name] = 0
            if self.watchdog is not None:
                # liveness, not throughput: an idle engine heartbeats too
                self.watchdog.report_heartbeat(self._watch_ids[name])
            launched |= stepped
        if launched:
            self.steps += 1
        elif self.busy:
            raise RuntimeError(
                "cluster stalled: queued work but no engine can run — the "
                "power budget admits nothing (budget deadlock)")
        if self.watchdog is not None:
            self._watchdog_tick()
        return launched

    # -- fault injection + recovery --------------------------------------------

    def _inject_cluster_faults(self) -> None:
        """Draw this round's cluster-level faults (engine crash, bank
        power-fault) for every live tenant, in registration order — the
        draw order is deterministic, so two same-seed chaos runs inject
        the identical schedule."""
        for name in list(self.engines):
            if name in self._down:
                continue
            if self.chaos.crash(name):
                self._crash(name, reason="injected crash")
                continue
            if self.chaos.bank(name):
                self._apply_bank_fault(name)

    def _note_fault(self, name: str, exc: Exception) -> None:
        """Account a transient step/alloc fault and set the engine's
        exponential backoff (in scheduling rounds — driver-agnostic, so
        the same recovery runs under a frozen or a simulated clock).
        Raises once the consecutive-fault streak exceeds
        ``max_fault_streak``: at that point the fault is not transient
        and silent spinning would hide it."""
        if isinstance(exc, DeviceStepFault):
            self.step_faults += 1
        else:
            self.alloc_faults += 1
        self.retries += 1
        streak = self._fault_streak.get(name, 0) + 1
        self._fault_streak[name] = streak
        if streak > self.max_fault_streak:
            raise RuntimeError(
                f"engine {name!r}: {streak} consecutive step faults — "
                "beyond the transient-retry budget") from exc
        self._backoff[name] = min(2 ** (streak - 1), 16)

    def _crash(self, name: str, reason: str) -> None:
        """Kill engine ``name``: all host-side slot state is lost.

        What a real crash loses is the engine process's bookkeeping; the
        cluster (the coordinator) survives and still owns the shared
        pool/table/platform, so it sweeps the dead tenant's references —
        the unretired in-flight step is dropped (its tokens die with the
        host), every occupied slot is evicted (pool refs, table pins,
        dedup claims, bank refs all released), and the engine's queue is
        set aside for re-submission. The watchdog records the death and
        its ``restart_delay()`` (exponential backoff) gates the rebuild;
        an exhausted restart budget raises instead of retrying forever.
        """
        eng = self.engines[name]
        self.crashes += 1
        # the in-flight async step dies with the host process — its token
        # values were never journaled, so replay regenerates them
        eng._pending = None
        eng._prev_nxt = None
        eng._faulted = []
        for i, s in enumerate(eng.slots):
            if s is not None:
                eng._evict(i)
        self._lost[name] = list(eng.queue)
        eng.queue.clear()
        self.platform.interrupts.fire(CRASH_LINE, name)
        rounds = 1
        if self.watchdog is not None:
            self.watchdog.report_failure(self._watch_ids[name], reason)
            delay = self.watchdog.restart_delay()
            if delay is None:
                raise RuntimeError(
                    f"engine {name!r}: restart budget exhausted "
                    f"({self.watchdog.cfg.max_restarts} restarts)")
            rounds = max(1, int(delay))
        self._down[name] = rounds
        self._fault_streak.pop(name, None)
        self._backoff.pop(name, None)

    def crash_engine(self, name: str, *,
                     rebuild: bool = True) -> ContinuousBatchingEngine | None:
        """Kill engine ``name`` (loss of all host-side slot state) and —
        by default — rebuild it immediately from the journal. Pass
        ``rebuild=False`` to leave the tenant down and let the cluster
        step loop restart it after the watchdog backoff. The test
        entrypoint for crash-recovery scenarios; chaos-injected crashes
        run the same two halves."""
        self._crash(name, reason="crash_engine()")
        if rebuild:
            return self.rebuild_engine(name)
        return None

    def rebuild_engine(self, name: str) -> ContinuousBatchingEngine:
        """Rebuild a crashed tenant and re-admit its in-flight work.

        The new engine lands on the same shared pool/table/platform and
        the same per-engine journal (same name); its monotone counters,
        completed list, and id registry carry over from the dead object
        so cluster-level accounting (and the simulator's per-name delta
        tracking) stays continuous. Every record in
        ``journal.incomplete()`` is re-admitted in original
        ``arrival_seq`` order — onto the client's tracked
        :class:`~repro_torch.serve.engine.Request` handles where available
        (arrival times and completion callbacks survive), else onto
        reconstructed requests — and replays through ``journal.open`` /
        ``record_token``, which cross-checks every regenerated token
        against the pre-crash run. Queue residents that were never
        admitted (no journal record) are re-queued behind them. Shared
        prefix pages the dead engine published are still table-resident,
        so replay re-adopts them instead of recomputing."""
        cfg, params, ns, kwargs = self._tenants[name]
        old = self.engines[name]
        eng = self._build_engine(cfg, params, ns, name, dict(kwargs))
        for attr in ("steps", "token_steps", "tokens_generated",
                     "prompt_tokens_processed",
                     "prompt_tokens_reused", "stalls", "admission_stalls",
                     "rematches", "rematched_tokens", "pages_recycled",
                     "rejected", "shed", "sampled_requests", "token_faults",
                     "replays"):
            setattr(eng, attr, getattr(old, attr))
        eng.completed = old.completed
        eng._ids = old._ids
        eng._replay_counts = old._replay_counts
        # accumulated joules survive the crash — the meter is host-side
        # accounting the coordinator keeps, like the monotone counters
        # above (the fresh engine's own meter is discarded)
        eng._meter = old._meter
        self.engines[name] = eng       # same key: dict/rotation order kept
        tracked = self._requests.get(name, {})
        for rid in [r for r, req in tracked.items()
                    if req.finish_time is not None]:
            del tracked[rid]           # acknowledged: replay never needs it
        requeued = set()
        journal = self.journal.journal(name)
        for rec in journal.incomplete():
            req = tracked.get(rec.request_id)
            if req is None:
                # untracked submission: reconstruct what replay needs from
                # the journal (the callback/arrival context is gone)
                req = Request(rec.request_id, rec.prompt, rec.max_new_tokens,
                              sampling=(SamplingParams(*rec.sampling)
                                        if rec.sampling else None))
            req.tokens = []
            req.admit_time = req.first_token_time = req.finish_time = None
            if req.arrival_time is None:
                req.arrival_time = self.clock()
            eng._ids.add(req.id)
            eng.queue.append(req)
            requeued.add(req.id)
        for req in self._lost.pop(name, []):
            if req.id in requeued:
                continue               # preempted resident: already queued
            eng._ids.add(req.id)
            eng.queue.append(req)
        self._down.pop(name, None)
        self.rebuilds += 1
        if self.watchdog is not None:
            # the rebuilt engine's first heartbeat is its rejoin
            self.watchdog.report_heartbeat(self._watch_ids[name])
        return eng

    def _apply_bank_fault(self, name: str) -> None:
        """Power-fault one occupied memory bank of engine ``name``: every
        slot on it is preempted and requeued at the front (the pre-fault
        tokens are valid journal state — the flush retires them first),
        the slots' bank references drop so the domain gates, and a
        ``chaos.bank_fault`` interrupt fires on the platform fabric. A
        tenant with no occupied slots absorbs the fault as a no-op."""
        eng = self.engines[name]
        occupied = [i for i, s in enumerate(eng.slots) if s is not None]
        if not occupied:
            return
        bank = eng._slot_bank[occupied[0]]
        victims = [i for i in occupied if eng._slot_bank[i] == bank]
        # descending seq + front requeue => ascending FIFO order in queue
        for i in sorted(victims,
                        key=lambda i: -(eng.slots[i].seq
                                        if eng.slots[i] is not None else 0)):
            if eng.slots[i] is not None:
                eng.preempt_slot(i, front=True)
        self.bank_faults += 1
        self.platform.interrupts.fire(BANK_FAULT_LINE, (name, bank))

    def _watchdog_tick(self) -> None:
        """Run watchdog detection; a tenant declared dead (heartbeat
        timeout under an advancing clock — e.g. stuck in backoff for
        longer than the timeout) escalates to the crash path, whose
        journal rebuild is the recovery for lost liveness too."""
        result = self.watchdog.tick()
        by_wid = {wid: n for n, wid in self._watch_ids.items()}
        for wid in result["dead"]:
            name = by_wid.get(wid)
            if name is not None and name not in self._down:
                self._crash(name, reason="heartbeat timeout")

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        """Step until every tenant drains (raises after ``max_steps``)."""
        for _ in range(max_steps):
            if not self.step():
                return
        raise RuntimeError(f"cluster still busy after {max_steps} steps")

    # -- preemption ------------------------------------------------------------

    def preempt(self) -> dict[str, list[Request]]:
        """Preempt every tenant: in-flight work is requeued FIFO per
        engine. Replay is bit-identical per engine (each engine's journal
        cross-checks its own tokens on the way back)."""
        return {name: eng.preempt() for name, eng in self.engines.items()}

    # -- introspection ---------------------------------------------------------

    def awake_banks(self) -> int:
        """Bank domains currently ``ON`` — what the budget caps."""
        return awake_banks(self.platform)

    def stats(self) -> dict:
        """Cluster counters plus every tenant's ``engine.stats()`` (one
        source of truth: the pool/table numbers inside each tenant's entry
        describe the same shared objects)."""
        meters = [e._meter for e in self.engines.values()
                  if e._meter is not None]
        return {
            "steps": self.steps,
            "power_stalls": self.power_stalls,
            "dvfs_throttles": self.dvfs_throttles,
            "energy_sheds": self.energy_sheds,
            "wrr_stalls": self.wrr_stalls,
            "scheduler": self.policy.scheduler,
            "sheds": self.sheds,
            "slo_preempts": self.slo_preempts,
            "reclaims": dict(self.reclaims),
            "groups": {g: list(ms) for g, ms in self._groups.items()},
            "migrations": self.migrations,
            "awake_banks": self.awake_banks(),
            "energy": {
                "total_uj": sum(m.total_uj for m in meters),
                "attributed_uj": sum(m.attributed_uj for m in meters),
                "overhead_uj": sum(m.overhead_uj for m in meters),
                "metered_engines": len(meters),
            },
            "faults": {
                "step_faults": self.step_faults,
                "alloc_faults": self.alloc_faults,
                "token_faults": sum(e.token_faults
                                    for e in self.engines.values()),
                "replays": sum(e.replays for e in self.engines.values()),
                "retries": self.retries,
                "crashes": self.crashes,
                "bank_faults": self.bank_faults,
                "rebuilds": self.rebuilds,
                "down": sorted(self._down),
                "injected": (dict(self.chaos.counts)
                             if self.chaos is not None else None),
                "watchdog_events": (len(self.watchdog.events)
                                    if self.watchdog is not None else 0),
            },
            "pool": dict(self.pool.stats, pages=self.pool.n_pages,
                         in_use=self.pool.in_use, free=self.pool.free_count,
                         by_owner={str(k): v
                                   for k, v in self.pool.owners().items()}),
            "table": dict(self.table.stats, resident=self.table.resident,
                          pinned=self.table.pinned,
                          by_namespace=self.table.resident_by_ns()),
            "engines": {name: eng.stats()
                        for name, eng in self.engines.items()},
        }
