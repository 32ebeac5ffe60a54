"""Step-level energy meter for the serving engine.

A copy of ``src/repro/serve/energy_meter.py`` (which imports only the
energy and power models), kept in the port so that ``repro_torch`` stands
alone; it charges the same floats in the same order, so a port engine and
the reference engine that schedule a trace alike meter equal joules.

Integrates the calibrated HEEPocrates domain model
(:mod:`repro_torch.core.energy` / :mod:`repro_torch.core.power`) over the
engine loop and attributes joules to individual requests. The meter is
purely observational — it never touches launches, tokens, PRNG state, or
admission order, so a metered engine's completed tokens are bit-identical
to an unmetered run of the same trace.

Accounting model
----------------

Work is charged in **cycles**, converted to energy at the meter's current
DVFS :class:`~repro_torch.core.energy.OperatingPoint`:

* a decode token costs ``CYCLES_PER_DECODE_TOKEN``, a prefill token
  ``CYCLES_PER_PREFILL_TOKEN``;
* bank dynamic energy is ``active_dyn × dyn_scale(V) × cycles`` — CV²·cycles,
  so frequency cancels and only voltage matters;
* bank leakage accrues over the *time* those cycles take
  (``cycles / freq``), so a lower-frequency point pays more leakage per
  token — together these land the two calibrated points on the paper's
  §IV-D ~2.1× DVFS energy ratio;
* KV pages held by a slot leak at a retention-class per-page power for the
  step's duration, with shared prefix pages split ``1/refcount`` across
  their local holders;
* per-step CPU work and the engine's *idle* banks go to unattributed
  overhead buckets (``host`` / ``idle``): the CPU burns
  :data:`HOST_DISPATCH_CYCLES` of active dispatch per step, then waits out
  the device. With clock gating on (the default) the waiting CPU and the
  idle banks fall to leakage; with ``gate_idle_banks=False`` both burn
  full ON duty-0 power — the host-only baseline of the tokens/joule
  benchmark, mirroring the paper's Fig. 6 clock-gated vs active split.

Conservation holds by construction and is property-tested
(``tests/test_energy_serve.py``; the port's by
``tests/test_torch_energy_serve.py``)::

    total_uj == attributed_uj + overhead_uj
    attributed_uj == Σ Request.energy_uj  (over every metered request)

All accumulators are monotone non-decreasing; every charge is ≥ 0. Each
engine meters its own bank/page view, so cluster totals are sums of
per-engine meters (a shared pool page held by two engines is split only
among the holders each meter can see).
"""

from __future__ import annotations

from repro_torch.core import energy
from repro_torch.core.power import RETENTION_LEAK_FACTOR

# A bank holds this many KV pages in the retention-cost model: one bank's
# retention-class leakage is split evenly over its pages, giving the
# per-page holding power below. Purely an accounting granularity — the
# pool's real page count is whatever the engine configured.
PAGES_PER_BANK = 8

# Per-page holding power (µW at 0.8 V): a held KV page keeps 1/8th of a
# bank in retention — 5.0 µW leak × 0.575 retention factor / 8 pages.
PAGE_RETENTION_UW = 5.0 * RETENTION_LEAK_FACTOR / PAGES_PER_BANK

# CPU cycles of active host work per engine step (batch building,
# journaling, scheduling); the rest of the step the CPU waits on the
# device — at gated leakage or, ungated, at ON duty-0 power.
HOST_DISPATCH_CYCLES = 1e5


class EnergyMeter:
    """Per-engine joule accounting over the calibrated domain model.

    The engine calls :meth:`tick` once per step (wall/sim-clock retention)
    and :meth:`charge_step` after each device launch (cycle-derived work);
    policies read :meth:`projected_uj_per_token` and flip the DVFS point
    with :meth:`set_point`. Everything else is read-only reporting.
    """

    def __init__(self, *, point: str = "max",
                 gate_idle_banks: bool = True) -> None:
        pm = energy.build_heepocrates_pm()
        self._cpu = pm.domains["cpu"]
        self._bank = pm.domains["bank0"]
        self._point = energy.operating_point(point)
        self.gate_idle_banks = gate_idle_banks
        # attributed buckets (mirrored into Request.energy_uj)
        self.prefill_uj = 0.0
        self.decode_uj = 0.0
        self.pages_uj = 0.0
        self.retention_uj = 0.0
        # unattributed overhead buckets
        self.host_uj = 0.0
        self.idle_uj = 0.0
        self.dvfs_switches = 0
        self._last_tick: float | None = None

    # -- DVFS ---------------------------------------------------------------

    @property
    def point(self) -> energy.OperatingPoint:
        """The meter's current DVFS operating point."""
        return self._point

    def set_point(self, name: str) -> None:
        """Switch the DVFS point (accounting only — outputs never change)."""
        pt = energy.operating_point(name)
        if pt is not self._point:
            self._point = pt
            self.dvfs_switches += 1

    # -- totals -------------------------------------------------------------

    @property
    def attributed_uj(self) -> float:
        """Energy charged to specific requests (Σ ``Request.energy_uj``)."""
        return (self.prefill_uj + self.decode_uj + self.pages_uj
                + self.retention_uj)

    @property
    def overhead_uj(self) -> float:
        """Energy no single request owns: CPU dispatch + idle banks."""
        return self.host_uj + self.idle_uj

    @property
    def total_uj(self) -> float:
        """Total platform energy integral — conservation's left-hand side."""
        return self.attributed_uj + self.overhead_uj

    def projected_uj_per_token(self) -> float:
        """Marginal decode-token energy at the current point.

        The energy-aware admission policy compares this against a tenant's
        ``energy_cap_uj_per_token``: ~4.4 µJ at ``max``, ~2.1 µJ at
        ``nominal`` (the calibrated §IV-D tradeoff).
        """
        pt = self._point
        cycles = energy.CYCLES_PER_DECODE_TOKEN
        dyn = self._bank.active_dyn_uw_mhz * pt.dyn_scale * cycles * 1e-6
        leak = (self._bank.leak_uw * pt.leak_scale
                * cycles / (pt.freq_mhz * 1e6))
        return dyn + leak

    # -- charging -----------------------------------------------------------

    def charge_step(self, slot_charges, idle_banks: int) -> None:
        """Charge one device step.

        ``slot_charges`` is ``[(request, kind, tokens, page_share)]`` for
        every slot the launch fed: ``kind`` is ``"prefill"`` or ``"decode"``,
        ``tokens`` the count consumed/produced this step, ``page_share`` the
        slot's refcount-weighted KV page holding. ``idle_banks`` is how many
        of the engine's banks hosted no occupied slot during the step.
        """
        pt = self._point
        ds, ls = pt.dyn_scale, pt.leak_scale
        hz = pt.freq_mhz * 1e6
        tau_step = 0.0
        for request, kind, tokens, page_share in slot_charges:
            per_tok = (energy.CYCLES_PER_PREFILL_TOKEN if kind == "prefill"
                       else energy.CYCLES_PER_DECODE_TOKEN)
            cycles = tokens * per_tok
            tau = cycles / hz
            tau_step = max(tau_step, tau)
            dyn = self._bank.active_dyn_uw_mhz * ds * cycles * 1e-6
            leak = self._bank.leak_uw * ls * tau
            hold = PAGE_RETENTION_UW * ls * page_share * tau
            if kind == "prefill":
                self.prefill_uj += dyn + leak
            else:
                self.decode_uj += dyn + leak
            self.pages_uj += hold
            if request is not None:
                request.energy_uj += dyn + leak + hold
        if not slot_charges:
            return
        # host CPU: a fixed slice of active dispatch work, then waiting on
        # the device — gated to leakage, or full ON duty-0 power when
        # clock gating is off
        self.host_uj += (self._cpu.active_dyn_uw_mhz * ds
                         * HOST_DISPATCH_CYCLES * 1e-6
                         + self._cpu.leak_uw * ls * HOST_DISPATCH_CYCLES / hz)
        if self.gate_idle_banks:
            cpu_wait_uw = self._cpu.leak_uw * ls
        else:
            cpu_wait_uw = (self._cpu.leak_uw * ls
                           + self._cpu.idle_dyn_uw_mhz * pt.freq_mhz * ds)
        self.host_uj += cpu_wait_uw * tau_step
        # banks with no occupied slot: same gating split
        if idle_banks > 0:
            if self.gate_idle_banks:
                per_bank = self._bank.leak_uw * ls * tau_step
            else:
                per_bank = (self._bank.leak_uw * ls
                            + self._bank.idle_dyn_uw_mhz * pt.freq_mhz
                            * ds) * tau_step
            self.idle_uj += idle_banks * per_bank
        return

    def tick(self, now: float, residents, idle_banks: int = 0) -> None:
        """Accrue clock-time retention since the last tick.

        ``residents`` is ``[(request, bank_weight, page_share)]`` for every
        occupied slot: banks in retention leak at ``RETENTION_LEAK_FACTOR``
        split by ``bank_weight`` across the slots sharing the bank, and held
        pages leak at :data:`PAGE_RETENTION_UW`. Idle banks accrue to the
        overhead bucket. Under the engine's default frozen clock ``dt`` is
        zero and this is a no-op; fake-clock simulations make it count.
        """
        if self._last_tick is None:
            self._last_tick = now
            return
        dt = now - self._last_tick
        self._last_tick = now
        if dt <= 0.0:
            return
        ls = self._point.leak_scale
        bank_ret = self._bank.leak_uw * RETENTION_LEAK_FACTOR * ls
        for request, bank_weight, page_share in residents:
            e = (bank_ret * bank_weight
                 + PAGE_RETENTION_UW * ls * page_share) * dt
            self.retention_uj += e
            if request is not None:
                request.energy_uj += e
        if idle_banks > 0:
            self.idle_uj += idle_banks * bank_ret * dt

    # -- reporting ----------------------------------------------------------

    def stats(self) -> dict:
        """Snapshot for ``engine.stats()['energy']`` — all µJ, all monotone."""
        return {
            "point": self._point.name,
            "total_uj": self.total_uj,
            "attributed_uj": self.attributed_uj,
            "overhead_uj": self.overhead_uj,
            "prefill_uj": self.prefill_uj,
            "decode_uj": self.decode_uj,
            "pages_uj": self.pages_uj,
            "retention_uj": self.retention_uj,
            "host_uj": self.host_uj,
            "idle_uj": self.idle_uj,
            "dvfs_switches": self.dvfs_switches,
            "projected_uj_per_token": self.projected_uj_per_token(),
        }
