"""Power domains and the power manager (paper §III-A5).

A copy of ``src/repro/core/power.py`` (which imports no JAX), kept in the
port so that ``repro_torch`` stands alone.

The paper's power manager exposes clock-gating, power-gating and SRAM
retention to both the platform and — through XAIF power ports — to external
accelerators. Here a :class:`PowerDomain` is an accounting + *functional*
unit: domains marked OFF are skipped in compute graphs (unrouted experts),
RETENTION keeps state without compute, CLOCK_GATED stops dynamic switching
but keeps leakage.

All coefficients are in µW (leakage) and µW/MHz (dynamic) at the calibration
voltage 0.8 V; voltage scaling follows §energy.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Mapping


class PowerState(enum.Enum):
    ON = "on"
    CLOCK_GATED = "clock_gated"
    RETENTION = "retention"   # memories only: -42.5 % leakage, no access
    OFF = "off"


# Paper: retention reduces leakage by about 42.5 % when the bank is idle.
RETENTION_LEAK_FACTOR = 1.0 - 0.425


@dataclasses.dataclass(frozen=True)
class PowerDomain:
    name: str
    leak_uw: float                 # leakage @0.8 V when ON / CLOCK_GATED
    idle_dyn_uw_mhz: float = 0.0   # clock-tree switching when ON but idle
    active_dyn_uw_mhz: float = 0.0  # switching when actively computing
    retainable: bool = False       # supports RETENTION (SRAM banks, ctx mems)

    def power_uw(self, state: PowerState, duty: float, freq_mhz: float,
                 leak_scale: float = 1.0, dyn_scale: float = 1.0) -> float:
        """Power of this domain in one scenario.

        ``duty`` is the fraction of time the domain is actively computing
        (the rest of the time it idles at clock-tree power).
        """
        if state is PowerState.OFF:
            return 0.0
        if state is PowerState.RETENTION:
            if not self.retainable:
                raise ValueError(f"domain {self.name} is not retainable")
            return self.leak_uw * RETENTION_LEAK_FACTOR * leak_scale
        leak = self.leak_uw * leak_scale
        if state is PowerState.CLOCK_GATED:
            # Gated between uses: wakes for ``duty``, burns no idle clock tree.
            return leak + self.active_dyn_uw_mhz * duty * freq_mhz * dyn_scale
        dyn = (self.active_dyn_uw_mhz * duty
               + self.idle_dyn_uw_mhz * (1.0 - duty)) * freq_mhz * dyn_scale
        return leak + dyn


class PowerManager:
    """Real-time control over the low-power techniques (paper Fig. 1).

    External accelerators get their own domains via XAIF power ports —
    :meth:`add_domain` is the power-port attach operation.
    """

    def __init__(self, domains: Iterable[PowerDomain]):
        self.domains: dict[str, PowerDomain] = {d.name: d for d in domains}
        self.states: dict[str, PowerState] = {n: PowerState.ON for n in self.domains}

    # -- XAIF power port -----------------------------------------------------
    def add_domain(self, domain: PowerDomain) -> None:
        if domain.name in self.domains:
            raise ValueError(f"duplicate power domain {domain.name!r}")
        self.domains[domain.name] = domain
        self.states[domain.name] = PowerState.ON

    def remove_domain(self, name: str) -> None:
        """Detach a power port (accelerator unplugged / spec replaced)."""
        if name not in self.domains:
            raise KeyError(name)
        del self.domains[name]
        del self.states[name]

    def set_state(self, name: str, state: PowerState) -> None:
        if name not in self.domains:
            raise KeyError(name)
        if state is PowerState.RETENTION and not self.domains[name].retainable:
            raise ValueError(f"domain {name} does not support retention")
        self.states[name] = state

    def set_states(self, states: Mapping[str, PowerState]) -> None:
        for k, v in states.items():
            self.set_state(k, v)

    def all_on(self) -> None:
        for n in self.states:
            self.states[n] = PowerState.ON

    def state(self, name: str) -> PowerState:
        if name not in self.states:
            raise KeyError(name)
        return self.states[name]

    def wake(self, name: str) -> None:
        self.set_state(name, PowerState.ON)

    def clock_gate(self, name: str) -> None:
        self.set_state(name, PowerState.CLOCK_GATED)

    def is_active(self, name: str) -> bool:
        return self.states[name] in (PowerState.ON, PowerState.CLOCK_GATED)

    # -- accounting ------------------------------------------------------------
    def power_uw(self, freq_mhz: float, *, activity: Mapping[str, float] | None = None,
                 leak_scale: float = 1.0, dyn_scale: float = 1.0) -> float:
        activity = activity or {}
        total = 0.0
        for name, dom in self.domains.items():
            total += dom.power_uw(self.states[name], activity.get(name, 0.0),
                                  freq_mhz, leak_scale, dyn_scale)
        return total

    def leakage_uw(self, leak_scale: float = 1.0) -> float:
        return sum(
            d.power_uw(self.states[n], 0.0, 0.0, leak_scale, 0.0)
            for n, d in self.domains.items()
        )
