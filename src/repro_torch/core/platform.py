"""The X-HEEP platform object: configuration + dispatch + power.

Port of ``src/repro/core/platform.py``. Mirrors the paper's configurability
axes (§III-A):

* ``core``        — CV32E20 / CV32E40X / CV32E40P, i.e. which execution
                    backend compute ops default to. In the port the
                    processing-oriented CV32E40P maps to ``"cuda"``, the impl
                    key of the hand-written Hopper kernels (the reference's
                    ``"pallas"``); the other two keep ``"ref"`` and
                    ``"chunked"``.
* ``bus``         — one_at_a_time vs fully_connected -> sharding rule preset.
* ``addressing``  — contiguous vs interleaved -> activation layout (sequence
                    parallelism on/off).
* ``n_banks``     — memory pool shard count.
* ``peripherals`` — optional subsystems (data pipeline stages, loggers).

An accelerator registered through XAIF can override the backend for its op,
and its power domain joins the platform power manager. The bus and the
addressing mode pick the sharding rules (:meth:`Platform.rules`).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.core import xaif
from repro_torch.core.power import PowerDomain, PowerManager
from repro_torch.sharding import axes as lax_
from repro_torch.sharding import rules as rules_lib

CORE_BACKEND = {
    "cv32e20": "ref",       # control-oriented core -> reference path
    "cv32e40x": "chunked",  # XIF co-processor socket -> chunked/scan formulations
    "cv32e40p": "cuda",     # processing-oriented -> hand-written CUDA kernels
}

BUSES = ("one_at_a_time", "fully_connected")
ADDRESSING = ("contiguous", "interleaved")
DEFAULT_PERIPHERALS = ("uart", "spi", "gpio", "timer", "dma", "plic")

@dataclasses.dataclass(frozen=True)
class XHeepConfig:
    core: str = "cv32e40x"
    bus: str = "fully_connected"
    addressing: str = "contiguous"
    n_banks: int = 8
    peripherals: Sequence[str] = DEFAULT_PERIPHERALS
    # op -> impl overrides (accelerator plug-ins chosen per op)
    op_impls: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.core not in CORE_BACKEND:
            raise ValueError(f"unknown core {self.core!r}; options {list(CORE_BACKEND)}")
        if self.bus not in BUSES:
            raise ValueError(f"unknown bus {self.bus!r}")
        if self.addressing not in ADDRESSING:
            raise ValueError(f"unknown addressing {self.addressing!r}")
        if self.n_banks < 1:
            raise ValueError("need at least one memory bank")


class Platform:
    """A configured X-HEEP instance hosting models and accelerators."""

    def __init__(self, config: XHeepConfig | None = None,
                 registry: xaif.XaifRegistry | None = None):
        self.config = config or XHeepConfig()
        self.registry = registry or xaif.REGISTRY
        self.power = PowerManager(
            [PowerDomain("host", leak_uw=0.0)]
            + [PowerDomain(f"bank{i}", leak_uw=0.0, retainable=True)
               for i in range(self.config.n_banks)]
        )
        self.interrupts = xaif.InterruptController()
        self._attached: list[xaif.AcceleratorSpec] = []
        self._added_domains: set[str] = set()   # domains attach() created
        self._bank_refs: dict[str, int] = {}    # shared bank occupancy

    # -- XAIF attach ---------------------------------------------------------
    def attach(self, spec: xaif.AcceleratorSpec) -> None:
        """Plug an accelerator in: register fn + join the power manager.

        Re-attaching (same op/impl) replaces the registration but joins the
        power manager exactly once — the power port is level-, not
        edge-attached.
        """
        self.registry.register(spec, allow_override=True)
        if spec.power_domain is not None:
            if spec.power_domain.name not in self.power.domains:
                self.power.add_domain(spec.power_domain)
                self._added_domains.add(spec.power_domain.name)
        replaced = [s for s in self._attached
                    if (s.op, s.impl) == (spec.op, spec.impl)]
        self._attached = [s for s in self._attached
                          if (s.op, s.impl) != (spec.op, spec.impl)]
        self._attached.append(spec)
        # a replaced spec's domain must not linger and leak — but only
        # domains attach() itself created are ours to remove (a spec naming
        # a platform built-in like "bank0" must never delete it)
        for old in replaced:
            if old.power_domain is None:
                continue
            name = old.power_domain.name
            still_used = any(
                s.power_domain is not None and s.power_domain.name == name
                for s in self._attached)
            if not still_used and name in self._added_domains:
                self.power.remove_domain(name)
                self._added_domains.discard(name)

    # -- shared bank occupancy (engines and pipelines co-own the pool) --------
    def bank_acquire(self, name: str) -> None:
        """Refcounted wake: the first user of an idle bank powers it on."""
        refs = self._bank_refs.get(name, 0)
        if refs == 0:
            self.power.wake(name)
        self._bank_refs[name] = refs + 1

    def bank_release(self, name: str) -> None:
        """Refcounted gate: the last user leaving an idle bank clock-gates
        it. Gating never fires while any other holder is live."""
        refs = self._bank_refs.get(name, 0)
        if refs <= 0:
            raise ValueError(f"bank {name!r} released more than acquired")
        self._bank_refs[name] = refs - 1
        if self._bank_refs[name] == 0:
            self.power.clock_gate(name)

    @property
    def accelerators(self) -> list[xaif.AcceleratorSpec]:
        return list(self._attached)

    # -- dispatch -------------------------------------------------------------
    def impl_for(self, op: str) -> str:
        override = dict(self.config.op_impls or {}).get(op)
        if override:
            return override
        default = CORE_BACKEND[self.config.core]
        if default in self.registry.impls(op):
            return default
        return "ref"

    def dispatch(self, op: str, *args, **kwargs):
        return self.registry.dispatch(op, self.impl_for(op), *args, **kwargs)

    # -- sharding rules (bus topology + addressing mode) ----------------------
    def rules(self, mesh) -> rules_lib.Rules:
        """The bus preset's sharding rules on ``mesh``; interleaved
        addressing on the fully connected bus adds sequence parallelism."""
        preset = rules_lib.PRESETS[self.config.bus](mesh)
        if self.config.addressing == "interleaved" and self.config.bus == "fully_connected":
            # Interleaved addressing stripes sequences across banks for
            # bandwidth (paper §III-A3) == sequence parallelism on activations.
            preset = preset.override(
                name=f"{preset.name}+interleaved", **{lax_.SEQ: ("data",)}
            )
        return preset
