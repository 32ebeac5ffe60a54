"""Deterministic fault injection for the serving stack.

Port of ``src/repro/serve/chaos.py`` (host-only; the same streams, draws,
budgets and counts, so a port's fault schedule equals the reference's for
the same seed and the same sequence of decision points). This is the
serving rendition of FEMU-style pre-silicon fault emulation:
X-HEEP's platform story is that compute domains can be power-gated away
and the host keeps running — here an engine, a device step, or a pool
allocation can fail mid-flight and the cluster must keep serving
bit-identical outputs. The :class:`FaultPlan` injects faults at defined
points through hooks threaded into the engine
(:mod:`repro_torch.serve.engine`), the page pool (:mod:`repro_torch.serve.paged`),
the prefix table (:mod:`repro_torch.serve.pages`), and the cluster
(:mod:`repro_torch.serve.cluster`):

* **Device-step failure** (``step_fail``) — the batched launch raises
  :class:`DeviceStepFault` before any device state is touched. All host
  bookkeeping that launch would have driven happens *after* the launch
  returns, and page allocation is idempotent-resumable, so the cluster
  retries the step after a bounded backoff.
* **Corrupted token** (``token_corrupt``) — the host-transferred next
  token is bit-flipped before retire (the on-device value is
  untouched, modelling a transfer-level upset). The engine's vocab
  range check refuses to journal it; the slot is quarantined and the
  request replays from the journal, whose ``record_token`` cross-check
  verifies the replayed prefix token-for-token.
* **NaN logits** (``nan_logits``) — the sampled token degenerates to
  ``-1`` (an argmax over all-NaN logits); detected and recovered
  exactly like a corrupted token.
* **Allocation failure** (``alloc_fail``) — :meth:`~repro_torch.serve.
  paged.PagePool.alloc` raises :class:`AllocFault`; transient, retried with
  backoff like a step failure.
* **Engine crash** (``engine_crash``) — the engine loses *all*
  host-side slot state. The cluster sweeps the dead tenant's shared
  references, then rebuilds the engine from
  :meth:`~repro_torch.runtime.ft.ClusterJournal.incomplete` — every in-flight
  request is re-admitted and replayed (re-adopting shared prefix pages
  where still resident).
* **Bank power-fault** (``bank_fault``) — one memory bank of the
  engine's platform faults: every slot on that bank is preempted and
  requeued (its pre-fault tokens are valid journal state), and a
  ``chaos.bank_fault`` interrupt fires on the platform's XAIF fabric.
* **Prefix-match drop** (``prefix_drop``) — a page-table ``acquire``
  spuriously misses, forcing a cold prefill. Sharing is an optimisation
  only, so this degrades throughput without touching any token.

Determinism contract (the invariant the chaos bench and tests assert):
the plan draws from per-``(kind, scope)`` streams seeded as
``random.Random(f"{seed}-{kind}-{scope}")`` — the string-keyed idiom of
:mod:`repro_torch.serve.loadgen` — at decision points that are themselves
deterministic, so two same-seed chaos runs inject the identical fault
schedule and produce bit-identical outputs; and under *any* schedule,
every completed request's tokens equal the fault-free run's, with no
request lost or double-completed.
"""

from __future__ import annotations

import dataclasses
import random

__all__ = ["AllocFault", "DeviceStepFault", "FaultSpec", "FaultPlan"]


class DeviceStepFault(RuntimeError):
    """A batched device launch failed (transient; the step is retryable)."""


class AllocFault(RuntimeError):
    """A page-pool allocation failed (transient; the step is retryable)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-point fault probabilities (all default 0 = that fault off).

    ``step_fail``/``alloc_fail`` draw once per device launch / pool
    allocation; ``token_corrupt``/``nan_logits`` once per retired token;
    ``engine_crash``/``bank_fault`` once per cluster step per engine;
    ``prefix_drop`` once per page-table acquire.
    """

    step_fail: float = 0.0
    token_corrupt: float = 0.0
    nan_logits: float = 0.0
    alloc_fail: float = 0.0
    engine_crash: float = 0.0
    bank_fault: float = 0.0
    prefix_drop: float = 0.0

    def __post_init__(self):
        for f in dataclasses.fields(self):
            p = getattr(self, f.name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{f.name} must be a probability, got {p}")


# a corrupted token has bit 30 forced on: far above any model's vocab, so
# the engine's range check catches every injected flip (the analogue of an
# ECC/range trap on the device->host transfer)
_FLIP_BIT = 1 << 30


class FaultPlan:
    """Seeded, string-keyed fault schedule over the serving stack.

    One plan is shared by a cluster and all its engines; each injection
    point draws from its own ``(kind, scope)`` RNG stream (scope = engine
    name, pool owner, or namespace), so adding an engine or reordering
    hook calls in one scope never perturbs another scope's schedule.
    ``budget`` optionally caps injections per kind (``{"engine_crash":
    2}``) — a draw past its budget always passes, which bounds recovery
    work in smoke tests. ``counts`` tallies every injected fault by kind.
    """

    def __init__(self, seed: int, spec: FaultSpec,
                 budget: dict[str, int] | None = None):
        self.seed = int(seed)
        self.spec = spec
        self.budget = dict(budget) if budget else {}
        self.counts: dict[str, int] = {
            f.name: 0 for f in dataclasses.fields(FaultSpec)}
        self._rngs: dict[tuple[str, str], random.Random] = {}

    def _draw(self, kind: str, scope: str) -> bool:
        p = getattr(self.spec, kind)
        if p <= 0.0:
            return False
        key = (kind, scope)
        rng = self._rngs.get(key)
        if rng is None:
            rng = self._rngs[key] = random.Random(
                f"{self.seed}-{kind}-{scope}")
        hit = rng.random() < p
        if not hit:
            return False
        cap = self.budget.get(kind)
        if cap is not None and self.counts[kind] >= cap:
            return False
        self.counts[kind] += 1
        return True

    # -- engine-level points -------------------------------------------------

    def launch(self, engine: str) -> None:
        """Device-launch injection point: raises :class:`DeviceStepFault`
        on a ``step_fail`` draw. Called at the very top of the engine's
        launch, before any device buffer is donated, so a faulted step
        leaves device and host state untouched and fully retryable."""
        if self._draw("step_fail", engine):
            raise DeviceStepFault(f"injected device-step fault on {engine}")

    def deliver_token(self, engine: str, token: int) -> int:
        """Token-transfer injection point: returns ``token`` possibly
        corrupted — bit-flipped out of vocab range (``token_corrupt``) or
        degenerated to ``-1`` (``nan_logits``, an argmax over all-NaN
        logits). The engine's range check quarantines either one."""
        if self._draw("token_corrupt", engine):
            return int(token) | _FLIP_BIT
        if self._draw("nan_logits", engine):
            return -1
        return int(token)

    # -- pool / table points -------------------------------------------------

    def alloc(self, owner: str | None) -> None:
        """Pool-allocation injection point (wired as
        :attr:`~repro_torch.serve.paged.PagePool.fault_hook`): raises
        :class:`AllocFault` on an ``alloc_fail`` draw, before the free
        list is touched."""
        if self._draw("alloc_fail", owner or ""):
            raise AllocFault(
                f"injected page-allocation fault (owner {owner!r})")

    def drop_prefix(self, ns: str) -> bool:
        """Prefix-acquire injection point (wired as
        :attr:`~repro_torch.serve.pages.PageTable.fault_hook`): True =
        suppress this acquire's match, forcing a cold prefill."""
        return self._draw("prefix_drop", ns)

    # -- cluster-level points ------------------------------------------------

    def crash(self, engine: str) -> bool:
        """Per-cluster-step crash draw for ``engine``: True = the engine
        loses all host-side slot state this round (the cluster sweeps and
        rebuilds it from the journal)."""
        return self._draw("engine_crash", engine)

    def bank(self, engine: str) -> bool:
        """Per-cluster-step bank power-fault draw for ``engine``: True =
        one of its occupied banks faults (every slot on it is preempted
        and requeued)."""
        return self._draw("bank_fault", engine)
