"""Deterministic simulation of the serving engine under scripted traffic.

Port of ``src/repro/serve/sim.py``. The harness is host-only: the cost
model sums the same host floats in the same order as the reference's, so
for the same schedule the port's simulated times equal the reference's
bit for bit; only the engine steps it drives run on the device.

No wall clock anywhere: a :class:`FakeClock` provides time, arrivals come
from a scripted :class:`Trace`, and every engine step is charged a fixed
cost — ``step_time`` of device compute plus ``dispatch_time`` of host
scheduling. A synchronous engine pays the two serially; an engine running
async double-buffered dispatch overlaps them, modelled with an explicit
device-busy-until pipeline (see :class:`Simulator`). This makes
throughput, latency, and fairness assertions exactly reproducible — the
serving analogue of the repo's step-indexed data pipeline — including the
measured win from host/device overlap.

The same harness drives two admission policies:

* ``sequential=False`` — continuous batching (the engine's native mode).
* ``sequential=True``  — one-request-at-a-time serving: the next request is
  only handed to the engine when it is completely idle. This is the
  baseline the paper's interrupt-driven overlap is measured against.

Trace generators: :func:`staggered_trace` (arrivals ``gap`` apart),
:func:`burst_trace` (everything at once), and
:func:`shared_prefix_requests` (a multi-tenant workload where every
request's prompt starts with the same prefix — the page-table reuse
workload; with prefix sharing enabled only the first request prefills the
shared pages). For a multi-model cluster, tag each arrival with its
target engine (:func:`tag_engine`) and drive the merged trace through
:class:`ClusterSimulator` — several engines, one fake clock, one report.

Traces may also be *lazy*: both simulators accept any iterator of
:class:`Arrival` (e.g. :func:`repro_torch.serve.loadgen.open_loop_trace`) and
pull from it one arrival at a time, so a 10⁵–10⁶-request open-loop trace
never materialises in memory. Lazy traces must already be time-ordered
(generators own their ordering); materialised sequences are stable-sorted
by the simulator as before.

Invariants the harness preserves: no wall clock or randomness anywhere, so
every report is exactly reproducible; same-time arrivals are delivered in
trace order (FIFO admission is observable end-to-end); and a reused engine
reports per-run deltas, never cumulative lifetime counters.
"""

from __future__ import annotations

import collections.abc
import dataclasses
from typing import Iterable, Sequence

from repro_torch.serve.engine import ContinuousBatchingEngine, Request


class FakeClock:
    """Deterministic simulated time source (compatible with FTController)."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        """Move time forward by ``dt`` (negative ``dt`` raises)."""
        if dt < 0:
            raise ValueError("time cannot run backwards")
        self.t += dt

    def advance_to(self, t: float) -> None:
        """Jump forward to ``t`` (never backwards)."""
        self.t = max(self.t, float(t))


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scripted arrival; ``engine`` routes it on a cluster trace
    (single-engine simulations leave it ``None``)."""

    time: float
    request: Request
    engine: str | None = None


def staggered_trace(requests: Sequence[Request], start: float = 0.0,
                    gap: float = 1.0) -> list[Arrival]:
    """Arrivals spaced ``gap`` apart — the canonical overlap workload."""
    return [Arrival(start + i * gap, r) for i, r in enumerate(requests)]


def burst_trace(requests: Sequence[Request], at: float = 0.0) -> list[Arrival]:
    """Everything at once — the saturation workload."""
    return [Arrival(at, r) for r in requests]


def tag_engine(trace: Sequence[Arrival], engine: str) -> list[Arrival]:
    """Route every arrival of ``trace`` to cluster engine ``engine``.
    Merge tagged traces (list concatenation) before handing them to
    :class:`ClusterSimulator`; delivery is stable-sorted by time, so
    same-time arrivals keep their merged order."""
    return [Arrival(a.time, a.request, engine) for a in trace]


def shared_prefix_requests(n: int, *, prefix_len: int = 64,
                           tail_len: int = 4, new_tokens: int = 8,
                           prefix: Sequence[int] | None = None,
                           id_prefix: str = "shared") -> list[Request]:
    """``n`` requests whose prompts share one ``prefix_len``-token prefix.

    The shared-prefix serving workload (a common system prompt, a shared
    document, a RAG template): tails are distinct per request, so outputs
    diverge after the prefix. Deterministic — same arguments, same
    requests. Pass an explicit ``prefix`` to pin the shared tokens.
    """
    if prefix is None:
        prefix = [(13 * j) % 241 + 1 for j in range(prefix_len)]
    prefix = [int(t) for t in prefix]
    return [
        Request(id=f"{id_prefix}{i}",
                prompt=prefix + [(17 * i + 5 * j) % 239 + 1
                                 for j in range(tail_len)],
                max_new_tokens=new_tokens)
        for i in range(n)
    ]


class _TraceFeed:
    """Uniform, lazily-consumed view over an arrival trace.

    A materialised sequence is validated up front and stable-sorted by
    time (same-time arrivals keep trace order — the FIFO contract). Any
    other iterable is consumed one arrival at a time — an open-loop
    generator of 10⁶ arrivals costs O(1) memory — and must already be
    time-ordered: the feed enforces nondecreasing times and validates
    each arrival as it surfaces, so a bad engine tag raises a clear
    ``ValueError`` naming the arrival instead of a bare ``KeyError``
    deep inside the cluster.
    """

    def __init__(self, trace: Iterable[Arrival], *,
                 engines: collections.abc.Set | None = None):
        self._engines = engines
        self._lazy = not isinstance(trace, collections.abc.Sequence)
        if self._lazy:
            self._it = iter(trace)
        else:
            arrivals = list(trace)
            for arr in arrivals:
                self._validate(arr)
            arrivals.sort(key=lambda a: a.time)      # stable: ties keep order
            self._it = iter(arrivals)
        self._last = float("-inf")
        self.head: Arrival | None = None
        self._advance()

    def _validate(self, arr: Arrival) -> None:
        if self._engines is None or arr.engine in self._engines:
            return
        if arr.engine is None:
            raise ValueError(
                f"untagged arrival {arr.request.id!r}: cluster traces "
                "route by engine name (see tag_engine)")
        raise ValueError(
            f"arrival {arr.request.id!r} targets unknown engine "
            f"{arr.engine!r} (cluster engines: {sorted(self._engines)}; "
            "see tag_engine)")

    def _advance(self) -> None:
        arr = next(self._it, None)
        if arr is not None and self._lazy:
            if arr.time < self._last:
                raise ValueError(
                    f"lazy trace ran backwards: arrival "
                    f"{arr.request.id!r} at t={arr.time} after t="
                    f"{self._last} (generator traces must be "
                    "nondecreasing; materialise a list to let the "
                    "simulator sort)")
            self._validate(arr)
        if arr is not None:
            self._last = arr.time
        self.head = arr

    def pop(self) -> Arrival:
        """Return the current head and pull the next arrival forward."""
        arr = self.head
        self._advance()
        return arr

    def __bool__(self) -> bool:
        return self.head is not None

    def __getitem__(self, i: int) -> Arrival:
        # head-only indexing keeps the `sim.pending[0].time` drive-by-hand
        # idiom working on lazy feeds (only the head is materialised)
        if i != 0 or self.head is None:
            raise IndexError("trace feed exposes only its head arrival")
        return self.head


@dataclasses.dataclass
class SimReport:
    elapsed: float                    # fake-clock span of the run
    steps: int
    tokens_generated: int
    completed: list                   # requests, completion order
    rejected: int
    energy_uj: float = 0.0            # metered platform energy, this run

    @property
    def throughput(self) -> float:
        """Generated tokens per unit of fake time."""
        return self.tokens_generated / self.elapsed if self.elapsed else 0.0

    @property
    def tokens_per_joule(self) -> float:
        """Generated tokens per joule of metered platform energy
        (``0.0`` for unmetered runs)."""
        if self.energy_uj <= 0:
            return 0.0
        return self.tokens_generated / (self.energy_uj * 1e-6)


class Simulator:
    """Drive an engine step-by-step from a scripted arrival trace.

    The cost model has two components per engine step: ``step_time`` (the
    device computing one batched launch) and ``dispatch_time`` (the host
    building the batch, journaling, scheduling — everything in
    ``engine.step()`` outside the device). A synchronous engine pays them
    serially: ``dispatch_time + step_time`` per step. An engine with
    ``async_dispatch=True`` overlaps them — the host dispatches step N+1
    while the device chews on step N — so the steady-state cost is
    ``max(dispatch_time, step_time)`` per step, modelled with an explicit
    device-busy-until timestamp (depth-1 double buffering: the host blocks
    on step N-1's completion only after dispatching step N). The default
    ``dispatch_time=0.0`` charges each step its ``step_time`` alone.
    """

    def __init__(self, engine: ContinuousBatchingEngine,
                 trace: Iterable[Arrival], clock: FakeClock, *,
                 step_time: float = 1.0, dispatch_time: float = 0.0,
                 sequential: bool = False):
        if engine.clock is not clock:
            raise ValueError("engine must share the simulator's clock")
        if step_time < 0 or dispatch_time < 0:
            raise ValueError("step/dispatch times cannot be negative")
        self.engine = engine
        self.clock = clock
        self.step_time = step_time
        self.dispatch_time = dispatch_time
        self.sequential = sequential
        self._device_free = clock.t          # device pipeline: busy-until
        self.pending = _TraceFeed(trace)

    def _deliver_due(self) -> None:
        eng = self.engine
        while self.pending and self.pending[0].time <= self.clock.t:
            if self.sequential and eng.busy:
                break                    # hold traffic until the engine drains
            arr = self.pending.pop()
            arr.request.arrival_time = arr.time
            eng.submit(arr.request)
            if self.sequential:
                break                    # at most one request in flight

    def _timed_step(self) -> None:
        """Advance the engine one step and charge the cost model."""
        eng = self.engine
        steps_before = eng.steps
        eng.step()
        launched = eng.steps > steps_before
        if not getattr(eng, "async_dispatch", False):
            if launched:
                self.clock.advance(self.dispatch_time + self.step_time)
            return
        if not launched:
            # flush-only step (retiring the in-flight launch at drain time)
            self.clock.advance_to(self._device_free)
            return
        dispatched = self.clock.t + self.dispatch_time
        prev_free = self._device_free
        # device starts when both the dispatch and its previous step are done
        self._device_free = max(dispatched, prev_free) + self.step_time
        # depth-1 double buffer: after dispatching step N the host retires
        # step N-1, blocking until the device finished it
        self.clock.advance_to(max(dispatched, prev_free))

    def run(self, max_steps: int = 1_000_000) -> SimReport:
        """Deliver arrivals and step the engine until the trace drains;
        returns this run's deltas (a reused engine never double-counts)."""
        eng = self.engine
        # snapshot the engine's lifetime counters: a reused engine must
        # report this run's deltas, not cumulative totals over stale time
        t0 = self.clock.t
        steps0, tokens0 = eng.steps, eng.tokens_generated
        done0, rejected0 = len(eng.completed), eng.rejected
        energy0 = eng._meter.total_uj if eng._meter is not None else 0.0
        for _ in range(max_steps):
            self._deliver_due()
            if eng.busy:
                self._timed_step()
            elif self.pending:
                # idle: jump to the next arrival instead of spinning
                self.clock.advance_to(self.pending[0].time)
            else:
                break
        else:
            raise RuntimeError(f"simulation did not drain in {max_steps} steps")
        if getattr(eng, "async_dispatch", False):
            self.clock.advance_to(self._device_free)   # drain the pipeline
        energy = (eng._meter.total_uj - energy0
                  if eng._meter is not None else 0.0)
        return SimReport(elapsed=self.clock.t - t0, steps=eng.steps - steps0,
                         tokens_generated=eng.tokens_generated - tokens0,
                         completed=list(eng.completed[done0:]),
                         rejected=eng.rejected - rejected0,
                         energy_uj=energy)


@dataclasses.dataclass
class ClusterSimReport:
    """One cluster run: aggregate counters plus per-engine completions."""

    elapsed: float                    # fake-clock span of the run
    steps: int                        # cluster scheduling rounds
    tokens_generated: int             # summed over every engine
    completed: dict                   # engine name -> requests, finish order
    rejected: int                     # summed engine backpressure rejections
    shed: int = 0                     # summed SLO-busted heads dropped
    energy_uj: float = 0.0            # summed metered energy, this run

    @property
    def throughput(self) -> float:
        """Aggregate generated tokens per unit of fake time."""
        return self.tokens_generated / self.elapsed if self.elapsed else 0.0

    @property
    def tokens_per_joule(self) -> float:
        """Aggregate generated tokens per joule of metered energy
        (``0.0`` for unmetered runs)."""
        if self.energy_uj <= 0:
            return 0.0
        return self.tokens_generated / (self.energy_uj * 1e-6)


class ClusterSimulator:
    """Drive a :class:`~repro_torch.serve.cluster.ServeCluster` from one merged,
    engine-tagged arrival trace (list or lazy generator) on one fake clock.

    Cost model: the cluster's engines are modelled as concurrently running
    accelerator tiles on one platform (the X-HEEP picture), so one cluster
    step — every busy engine advancing one batched launch — charges
    ``dispatch_time`` once, plus device time per the engine's own dispatch
    mode. A synchronous engine holds the round open for its full
    ``step_time``; an ``async_dispatch`` engine carries its own
    device-busy-until pipeline (exactly the :class:`Simulator` depth-1
    double-buffer model, one pipeline per engine), so the round only waits
    for its *previous* launch and its device time overlaps the next
    round's host work. Cross-engine prefix reuse therefore shows up as
    *fewer cluster steps* to drain the same trace, and async tenants are
    charged their overlapped cost, not the sync one. With only sync
    engines this reproduces the original ``dispatch_time + step_time``
    per-round accounting bit-for-bit.
    """

    def __init__(self, cluster, trace: Iterable[Arrival], clock: FakeClock,
                 *, step_time: float = 1.0, dispatch_time: float = 0.0):
        if cluster.clock is not clock:
            raise ValueError("cluster must share the simulator's clock")
        if step_time < 0 or dispatch_time < 0:
            raise ValueError("step/dispatch times cannot be negative")
        # engine tags are validated against the cluster's tenant set — a
        # sequence trace entirely at construction, a lazy one per arrival
        self.cluster = cluster
        self.clock = clock
        self.step_time = step_time
        self.dispatch_time = dispatch_time
        # replica groups are valid targets too (cluster.submit routes them)
        self.pending = _TraceFeed(
            trace, engines=getattr(cluster, "targets", None)
            or set(cluster.engines))

    def _deliver_due(self) -> None:
        while self.pending and self.pending[0].time <= self.clock.t:
            arr = self.pending.pop()
            arr.request.arrival_time = arr.time
            self.cluster.submit(arr.engine, arr.request)

    def run(self, max_steps: int = 1_000_000) -> ClusterSimReport:
        """Deliver arrivals and step the cluster until the trace drains;
        returns this run's deltas (a reused cluster never double-counts)."""
        cl = self.cluster
        t0 = self.clock.t
        steps0 = cl.steps
        tokens0 = {n: e.tokens_generated for n, e in cl.engines.items()}
        done0 = {n: len(e.completed) for n, e in cl.engines.items()}
        rejected0 = {n: e.rejected for n, e in cl.engines.items()}
        shed0 = {n: e.shed for n, e in cl.engines.items()}
        # meters survive crash rebuilds (the cluster carries them over),
        # so per-name snapshots stay valid across mid-run engine swaps
        energy0 = {n: e._meter.total_uj for n, e in cl.engines.items()
                   if e._meter is not None}
        # per-engine device pipelines (device-busy-until timestamps)
        dev_free = {n: self.clock.t for n in cl.engines}
        steps_prev = {n: e.steps for n, e in cl.engines.items()}
        for _ in range(max_steps):
            self._deliver_due()
            if cl.busy:
                pend_prev = {n: e._pending is not None
                             for n, e in cl.engines.items()}
                if cl.step():
                    dispatched = self.clock.t + self.dispatch_time
                    round_end = dispatched
                    for n, e in cl.engines.items():
                        launched = e.steps > steps_prev[n]
                        steps_prev[n] = e.steps
                        if not getattr(e, "async_dispatch", False):
                            if launched:       # sync: round holds for device
                                dev_free[n] = dispatched + self.step_time
                                round_end = max(round_end, dev_free[n])
                        elif launched:
                            # async: device starts once the dispatch and the
                            # engine's previous step are both done; the host
                            # only blocks on the *previous* step (depth-1)
                            prev = dev_free[n]
                            dev_free[n] = (max(dispatched, prev)
                                           + self.step_time)
                            round_end = max(round_end, prev)
                        elif pend_prev[n] and e._pending is None:
                            # flush-only: host blocked until the in-flight
                            # launch finished on the device
                            round_end = max(round_end, dev_free[n])
                    self.clock.advance_to(round_end)
            elif self.pending:
                # idle: jump to the next arrival instead of spinning
                self.clock.advance_to(self.pending[0].time)
            else:
                break
        else:
            raise RuntimeError(f"simulation did not drain in {max_steps} steps")
        if dev_free:
            self.clock.advance_to(max(dev_free.values()))  # drain pipelines
        return ClusterSimReport(
            elapsed=self.clock.t - t0, steps=cl.steps - steps0,
            tokens_generated=sum(e.tokens_generated - tokens0[n]
                                 for n, e in cl.engines.items()),
            completed={n: list(e.completed[done0[n]:])
                       for n, e in cl.engines.items()},
            rejected=sum(e.rejected - rejected0[n]
                         for n, e in cl.engines.items()),
            shed=sum(e.shed - shed0[n] for n, e in cl.engines.items()),
            energy_uj=sum(e._meter.total_uj - energy0.get(n, 0.0)
                          for n, e in cl.engines.items()
                          if e._meter is not None))
