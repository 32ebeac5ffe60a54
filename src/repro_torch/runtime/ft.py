"""Fault-tolerance runtime: the watchdog and the serving engine's journals.

Port of ``src/repro/runtime/ft.py``, host-only, with the same records,
states, timing rules and errors:

* :class:`FTController` — a tick-driven liveness state machine over
  workers (heartbeats, straggler detection from step times, deaths by
  heartbeat timeout or reported failure, rejoin on the next heartbeat, an
  exponential restart backoff with a budget, elastic rescale plans,
  straggler microbatch shares). Transport-agnostic and clock-injectable,
  so a serving cluster drives it on a simulated clock
  (:class:`repro_torch.serve.cluster.ServeCluster`'s watchdog: one worker
  an engine);
* :class:`RequestJournal` — the serving engine's write-ahead record of
  every admitted request, and :class:`ClusterJournal`, one journal an
  engine of a cluster. The journal's invariants:

* **Replay determinism** — decode is deterministic even when stochastic:
  greedy replay is argmax, and sampled requests journal their
  ``SamplingParams`` tuple (temperature/top-k/top-p/seed) at first open so
  a replay re-seeds the identical per-request PRNG chain. Either way a
  replay from the journaled prompt reproduces the original tokens
  bit-for-bit; ``record_token`` cross-checks every replayed token against
  the pre-preemption run and raises on divergence rather than serving
  silently different output.
* **FIFO order survives preemption** — ``arrival_seq`` is assigned once at
  first admission and never reassigned, so ``incomplete()`` always returns
  the original admission order.
* **Page-table state is journaled** — ``note_prefix`` records each
  admission's shared-prefix reuse (token count + pinned page keys); reuse
  is an optimisation only and must never change the emitted tokens.
* **In-flight records are never evicted** — ``evict`` refuses to drop a
  record whose request has not completed (that would lose replay state).

Training's use of the controller (elastic restore with checkpoints) comes
with the slice that ports that.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import math
import statistics
import time
from typing import Callable

__all__ = ["ClusterJournal", "FTConfig", "FTController", "RequestJournal",
           "SlotRecord", "WorkerInfo", "WorkerState"]


class WorkerState(enum.Enum):
    HEALTHY = "healthy"
    STRAGGLING = "straggling"
    DEAD = "dead"


@dataclasses.dataclass
class WorkerInfo:
    last_heartbeat: float = 0.0
    state: WorkerState = WorkerState.HEALTHY
    step_times: list = dataclasses.field(default_factory=list)
    slow_streak: int = 0


@dataclasses.dataclass(frozen=True)
class FTConfig:
    heartbeat_timeout_s: float = 60.0
    straggler_factor: float = 1.5      # slower than median x this => slow
    straggler_streak: int = 3          # consecutive slow steps => flagged
    max_restarts: int = 5
    backoff_base_s: float = 2.0
    window: int = 20                   # step-time history window


class FTController:
    def __init__(self, n_workers: int, cfg: FTConfig = FTConfig(),
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.workers = {i: WorkerInfo(last_heartbeat=clock())
                        for i in range(n_workers)}
        self.restarts = 0
        self.events: list[tuple[float, str]] = []

    # -- membership ------------------------------------------------------
    def add_worker(self) -> int:
        """Register one more worker and return its id — dynamic
        registration for controllers built before their workers exist
        (e.g. a serving cluster adding engines after construction)."""
        wid = max(self.workers, default=-1) + 1
        self.workers[wid] = WorkerInfo(last_heartbeat=self.clock())
        return wid

    # -- reporting -------------------------------------------------------
    def report_heartbeat(self, worker: int):
        w = self.workers[worker]
        w.last_heartbeat = self.clock()
        if w.state is WorkerState.DEAD:
            w.state = WorkerState.HEALTHY   # rejoin (elastic upscale)
            self._log(f"worker {worker} rejoined")

    def report_step_time(self, worker: int, seconds: float):
        w = self.workers[worker]
        w.step_times.append(seconds)
        if len(w.step_times) > self.cfg.window:
            w.step_times.pop(0)

    def report_failure(self, worker: int, reason: str = "fault"):
        """Coordinator-observed failure: declare ``worker`` dead now,
        without waiting out the heartbeat timeout (e.g. an engine crash
        the serving cluster detected synchronously). A later heartbeat
        rejoins it, exactly like a timeout death."""
        w = self.workers[worker]
        if w.state is not WorkerState.DEAD:
            w.state = WorkerState.DEAD
            w.slow_streak = 0
            self._log(f"worker {worker} declared dead ({reason})")

    # -- detection --------------------------------------------------------
    def tick(self) -> dict:
        """Run detection; returns {'dead': [...], 'stragglers': [...]}"""
        now = self.clock()
        dead, stragglers = [], []
        alive_times = [t for w in self.workers.values()
                       if w.state is not WorkerState.DEAD
                       for t in w.step_times[-1:]]
        median = statistics.median(alive_times) if alive_times else None
        for wid, w in self.workers.items():
            if w.state is WorkerState.DEAD:
                continue
            if now - w.last_heartbeat > self.cfg.heartbeat_timeout_s:
                w.state = WorkerState.DEAD
                dead.append(wid)
                self._log(f"worker {wid} declared dead (heartbeat timeout)")
                continue
            if median and w.step_times:
                if w.step_times[-1] > self.cfg.straggler_factor * median:
                    w.slow_streak += 1
                else:
                    w.slow_streak = 0
                if w.slow_streak >= self.cfg.straggler_streak:
                    if w.state is not WorkerState.STRAGGLING:
                        self._log(f"worker {wid} flagged as straggler")
                    w.state = WorkerState.STRAGGLING
                    stragglers.append(wid)
                elif w.state is WorkerState.STRAGGLING:
                    w.state = WorkerState.HEALTHY
        return {"dead": dead, "stragglers": stragglers}

    # -- mitigation --------------------------------------------------------
    def healthy_workers(self) -> list[int]:
        return [i for i, w in self.workers.items()
                if w.state is not WorkerState.DEAD]

    def rescale_plan(self, mesh_shape: tuple[int, ...],
                     axis: int = 0) -> tuple[int, ...] | None:
        """Largest valid mesh after losing workers: shrink ``axis`` to the
        biggest power-of-two of healthy workers (keeps divisibility for
        checkpoint resharding). None if unchanged."""
        alive = len(self.healthy_workers())
        total = math.prod(mesh_shape)
        if alive >= total:
            return None
        per_other = total // mesh_shape[axis]
        new_axis = 1
        while new_axis * 2 * per_other <= alive:
            new_axis *= 2
        new = list(mesh_shape)
        new[axis] = new_axis
        return tuple(new)

    def microbatch_shares(self, n_microbatches: int) -> dict[int, int]:
        """Straggler mitigation: stragglers get half-weight shares of the
        next step's microbatches (work rerouted to healthy peers)."""
        weights = {}
        for wid, w in self.workers.items():
            if w.state is WorkerState.DEAD:
                continue
            weights[wid] = 0.5 if w.state is WorkerState.STRAGGLING else 1.0
        total_w = sum(weights.values())
        shares = {wid: int(n_microbatches * wt / total_w)
                  for wid, wt in weights.items()}
        # distribute remainder to healthiest workers
        rem = n_microbatches - sum(shares.values())
        for wid in sorted(weights, key=lambda i: -weights[i]):
            if rem <= 0:
                break
            shares[wid] += 1
            rem -= 1
        return shares

    def restart_delay(self) -> float | None:
        """Exponential-backoff restart policy; None when budget exhausted."""
        if self.restarts >= self.cfg.max_restarts:
            return None
        delay = self.cfg.backoff_base_s * (2 ** self.restarts)
        self.restarts += 1
        return delay

    def _log(self, msg: str):
        self.events.append((self.clock(), msg))


# ---------------------------------------------------------------------------
# Preemption-safe slot state for the serving engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SlotRecord:
    """Durable record of one in-flight request (what replay needs).

    ``prefix_reused``/``page_keys`` journal the page-table decision taken
    at (re-)admission: how many prompt tokens were admitted pre-consumed
    from shared prefix pages, and which pages were pinned. Reuse never
    changes the emitted tokens (greedy decode from a correct prefix state
    is bit-identical to re-running the prefill), so replay stays
    bit-identical whether or not the replayed admission finds the same
    pages resident — the fields make every run auditable, and
    ``record_token`` enforces the invariant.
    """

    request_id: str
    prompt: tuple                  # token ids, immutable for safety
    max_new_tokens: int
    arrival_seq: int               # FIFO position — preserved across preemption
    generated: list = dataclasses.field(default_factory=list)
    prior: list = dataclasses.field(default_factory=list)  # pre-preemption run
    completed: bool = False
    prefix_reused: int = 0         # prompt tokens pre-consumed at admission
    page_keys: tuple = ()          # page-table chain pinned at admission
    rematched: int = 0             # prompt tokens adopted mid-flight (re-match)
    recycled: int = 0              # ring pages recycled out of the window
    slo_preempts: int = 0          # scheduler preempt-and-requeue demotions
    # stochastic decode: (temperature, top_k, top_p, seed) or None for
    # greedy. Set at first open and immutable for the record's lifetime —
    # replay re-seeds the request's PRNG chain from this, so changing it
    # mid-flight would silently break the divergence cross-check
    sampling: tuple | None = None


class RequestJournal:
    """Write-ahead record of every admitted request.

    The continuous-batching engine journals each request when it is admitted
    to a slot and each token as it is emitted. If the engine is preempted
    (worker loss, elastic rescale, a scheduler's demotion), the
    journal is the source of truth: ``incomplete()`` returns the in-flight
    requests in their original FIFO order so the engine can re-queue and
    replay them. Greedy decoding is deterministic, so a replay from the
    prompt reproduces the original tokens bit-for-bit; ``record_token``
    cross-checks this whenever a replayed slot overlaps its pre-preemption
    progress.

    ``horizon`` bounds memory in long open-loop runs: when more than
    ``horizon`` *completed* records are retained, the oldest-completed
    ones are auto-evicted (in-flight records are never evicted — the
    replay-state invariant holds unconditionally). ``None`` retains
    everything, the pre-horizon behaviour.
    """

    def __init__(self, horizon: int | None = None):
        if horizon is not None and horizon < 0:
            raise ValueError("horizon must be >= 0 (None = unbounded)")
        self.horizon = horizon
        self._records: dict[str, SlotRecord] = {}
        self._seq = 0
        # completion order, for horizon eviction (may hold ids already
        # dropped by an explicit evict(); the auto-evict loop skips those)
        self._done_order: collections.deque[str] = collections.deque()
        self.auto_evicted = 0

    def open(self, request_id: str, prompt, max_new_tokens: int,
             sampling: tuple | None = None) -> SlotRecord:
        """Open (or re-open, on replay) the record for one admission.

        ``sampling`` is the request's ``(temperature, top_k, top_p,
        seed)`` tuple (None for greedy), journaled at first open; a
        re-open with *different* sampling params raises — the replayed
        PRNG chain would not reproduce the prior run's tokens, so the
        conflict must fail at admission, not as a later divergence.
        """
        if request_id in self._records:
            rec = self._records[request_id]
            if rec.completed:
                raise ValueError(f"request {request_id!r} already completed")
            if rec.sampling != sampling:
                raise ValueError(
                    f"request {request_id!r} re-opened with sampling params "
                    f"{sampling!r} != journaled {rec.sampling!r}: replay "
                    "must re-seed the original chain")
            # replay restarts emission from scratch; keep the longest run
            # observed so far so record_token can cross-check determinism
            # even after a preemption that interrupts an earlier replay
            if len(rec.generated) > len(rec.prior):
                rec.prior = list(rec.generated)
            rec.generated = []
            return rec
        rec = SlotRecord(request_id, tuple(int(t) for t in prompt),
                         max_new_tokens, self._seq, sampling=sampling)
        self._seq += 1
        self._records[request_id] = rec
        return rec

    def note_prefix(self, request_id: str, tokens_reused: int,
                    page_keys) -> None:
        """Journal the page-table state of an admission: how much of the
        prompt came pre-consumed from shared pages. Recorded per admission
        (a replay may find more, fewer, or no pages resident — the tokens
        must come out identical either way)."""
        rec = self._records[request_id]
        rec.prefix_reused = int(tokens_reused)
        rec.page_keys = tuple(tuple(k) for k in page_keys)
        rec.rematched = 0              # fresh admission restarts the count
        rec.recycled = 0

    def note_rematch(self, request_id: str, tokens_adopted: int) -> None:
        """Journal a mid-flight prefix re-match: at a page boundary during
        chunked prefill the slot adopted a sibling's freshly published pages
        instead of recomputing them. Like ``note_prefix``, this is an audit
        field — adoption is an optimisation only and must never change the
        emitted tokens (``record_token`` enforces that on replay)."""
        self._records[request_id].rematched += int(tokens_adopted)

    def note_recycle(self, request_id: str, n_pages: int) -> None:
        """Journal a sliding-window ring recycle: ``n_pages`` of the slot's
        block table were released (or disowned, for adopted shared pages)
        because their positions fell wholly outside the window. Like the
        other page-table fields this is an audit record — recycling frees
        memory the attention window can no longer see, so it must never
        change the emitted tokens, and replay after ``preempt()`` stays
        bit-identical whatever recycling the replayed run performs
        (``record_token`` enforces that)."""
        self._records[request_id].recycled += int(n_pages)

    def note_slo_preempt(self, request_id: str) -> None:
        """Journal a scheduler-driven preempt-and-requeue (an SLO-busting
        request demoted to the back of its engine's queue). A lifetime
        count — unlike the per-admission page fields it survives
        re-admission, so replay audits how often the scheduler bounced a
        request. The demotion changes *when* the tokens re-emerge, never
        what they are: replay after an SLO preemption runs through the
        same ``open`` → ``record_token`` path as a full ``preempt()``,
        and the divergence cross-check holds as usual."""
        self._records[request_id].slo_preempts += 1

    def record_token(self, request_id: str, token: int) -> None:
        rec = self._records[request_id]
        idx, token = len(rec.generated), int(token)
        if idx < len(rec.prior) and rec.prior[idx] != token:
            raise RuntimeError(
                f"replay divergence for request {request_id!r} at token "
                f"{idx}: original {rec.prior[idx]}, replay {token} — decode "
                f"is expected to be deterministic")
        rec.generated.append(token)

    def complete(self, request_id: str) -> None:
        rec = self._records[request_id]
        if not rec.completed:
            rec.completed = True
            self._done_order.append(request_id)
            if self.horizon is not None:
                self._trim()

    def _trim(self) -> None:
        live = sum(1 for rid in self._done_order
                   if self._records.get(rid) is not None
                   and self._records[rid].completed)
        while live > self.horizon and self._done_order:
            rid = self._done_order.popleft()
            rec = self._records.get(rid)
            if rec is None or not rec.completed:
                continue               # explicitly evicted, or re-opened
            del self._records[rid]
            self.auto_evicted += 1
            live -= 1

    def get(self, request_id: str) -> SlotRecord:
        return self._records[request_id]

    def has(self, request_id: str) -> bool:
        """True when a record exists for ``request_id`` — i.e. the request
        has been admitted at least once. Schedulers use this to exempt
        replayed work (preempted, crash-recovered, or corruption-
        quarantined) from admission-control shedding: a request holding
        journal state must finish, or its record would sit in-flight
        forever and resurrect at the next crash rebuild."""
        return request_id in self._records

    def evict(self, request_id: str) -> None:
        """Drop a completed record (post-acknowledgement cleanup). Evicting
        an in-flight record would lose replay state, so that is an error;
        an id the horizon already auto-evicted is silently gone."""
        rec = self._records.get(request_id)
        if rec is None:
            return                     # horizon got there first
        if not rec.completed:
            raise ValueError(f"request {request_id!r} is still in flight")
        del self._records[request_id]

    # -- live migration (replica drain) -----------------------------------

    def transfer(self, request_id: str) -> SlotRecord:
        """Remove and return an *in-flight* record so a sibling journal can
        :meth:`adopt` it — the handoff half of live slot migration (a
        replica draining its work onto its peers). Transferring a
        completed record is an error (finished work is acknowledged where
        it ran, never migrated)."""
        rec = self._records[request_id]
        if rec.completed:
            raise ValueError(
                f"request {request_id!r} already completed — completed "
                "work is acknowledged in place, not migrated")
        del self._records[request_id]
        return rec

    def adopt(self, rec: SlotRecord) -> SlotRecord:
        """Adopt a record transferred from a sibling journal.

        The source engine's emitted tokens ride along as the ``prior``
        run, so when the adopting engine replays the request its
        ``record_token`` cross-checks every token against the source's
        output — migration is held to the same bit-identity bar as
        preemption replay. ``arrival_seq`` is reassigned in adoption
        order (the one exception to never-reassigned: the sequence is
        journal-local, and the drain hands records over in the source's
        FIFO order, so relative order is preserved on the sibling)."""
        if rec.request_id in self._records:
            raise ValueError(
                f"request {rec.request_id!r} already journaled here — two "
                "engines cannot both own an in-flight record")
        if rec.completed:
            raise ValueError(f"request {rec.request_id!r} is completed")
        if len(rec.generated) > len(rec.prior):
            rec.prior = list(rec.generated)
        rec.generated = []
        rec.arrival_seq = self._seq
        self._seq += 1
        self._records[rec.request_id] = rec
        return rec

    def size(self) -> dict:
        """Retention counters for ``engine.stats()``: live record and
        token counts, an order-of-magnitude byte estimate, and how many
        completed records the horizon auto-evicted."""
        tokens = sum(len(r.prompt) + len(r.generated) + len(r.prior)
                     for r in self._records.values())
        return {
            "records": len(self._records),
            "in_flight": sum(1 for r in self._records.values()
                             if not r.completed),
            "tokens": tokens,
            # ints in CPython are ~28 bytes; the record object + dict
            # slot overhead lands around 400 — a sizing signal, not an
            # exact accounting
            "approx_bytes": 400 * len(self._records) + 28 * tokens,
            "auto_evicted": self.auto_evicted,
            "horizon": self.horizon,
        }

    def incomplete(self) -> list[SlotRecord]:
        """In-flight records, oldest first — the replay queue."""
        return sorted((r for r in self._records.values() if not r.completed),
                      key=lambda r: r.arrival_seq)

    def completed(self) -> list[SlotRecord]:
        return sorted((r for r in self._records.values() if r.completed),
                      key=lambda r: r.arrival_seq)


class ClusterJournal:
    """One durable root over per-engine :class:`RequestJournal` instances.

    Each engine of a :class:`~repro_torch.serve.cluster.ServeCluster` journals
    into its own ``RequestJournal`` (obtained via :meth:`journal`), keeping
    FIFO sequence numbers and replay cross-checks engine-local — a replay
    of model A must never be validated against model B's tokens. The
    cluster-level views (:meth:`incomplete` / :meth:`completed`) aggregate
    per engine name, which is what a coordinator restarts from after a
    cluster-wide preemption. ``horizon`` is handed to every per-engine
    journal (completed-record retention bound, see
    :class:`RequestJournal`).
    """

    def __init__(self, horizon: int | None = None):
        self.horizon = horizon
        self._journals: dict[str, RequestJournal] = {}

    def journal(self, engine: str) -> RequestJournal:
        """The (created-on-first-use) journal for ``engine``."""
        if engine not in self._journals:
            self._journals[engine] = RequestJournal(horizon=self.horizon)
        return self._journals[engine]

    def engines(self) -> list[str]:
        """Engine names with a journal, in registration order."""
        return list(self._journals)

    def incomplete(self) -> dict[str, list[SlotRecord]]:
        """Engine name -> in-flight records (each list oldest-first) —
        the cluster-wide replay set after a preemption."""
        return {name: j.incomplete() for name, j in self._journals.items()
                if j.incomplete()}

    def completed(self) -> dict[str, list[SlotRecord]]:
        """Engine name -> completed records, per-engine arrival order."""
        return {name: j.completed() for name, j in self._journals.items()
                if j.completed()}
