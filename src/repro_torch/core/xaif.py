"""XAIF — the eXtendible Accelerator InterFace (paper §III-B), PyTorch edition.

Port of ``src/repro/core/xaif.py``. In silicon, XAIF lets an accelerator
plug into the host through (1) slave/master OBI bus ports, (2) interrupt
lines, (3) power-control ports, without forking the platform RTL. Here an
accelerator is a callable on tensors (typically the device-dispatching
wrapper of a hand-written CUDA kernel, registered under the impl key
``"cuda"``) plus the same three contracts:

* ``slave_ports``  — what the host pushes *into* the accelerator
  (configuration, weights): named abstract values.
* ``master_ports`` — what the accelerator reads/writes in device memory on
  its own: named logical-axes contracts. The number of master ports is the
  bandwidth contract (paper: CGRA = 4×32 bit master ports = 128 bit/cycle).
* ``interrupt``    — completion notification: the serving engine's callback
  hook (host polling in the engine loop).
* ``power_domain`` — a PowerDomain attached to the platform PowerManager so
  the accelerator participates in clock/power-gating and energy accounting.

Registering an accelerator NEVER requires editing platform or model code —
callers dispatch ops through the registry by name (the no-RTL-fork
property).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core.power import PowerDomain
from repro_torch.sharding.params import Axes


@dataclasses.dataclass(frozen=True)
class PortSpec:
    """One XAIF bus port: a named operand with a logical sharding contract."""

    name: str
    axes: Axes                    # logical axes of the operand
    direction: str = "master"     # "master" (acc <-> memory) | "slave" (host -> acc)
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.direction not in ("master", "slave"):
            raise ValueError(f"bad port direction {self.direction}")


@dataclasses.dataclass(frozen=True)
class AcceleratorSpec:
    """A pluggable accelerator implementation of one framework op."""

    name: str                     # e.g. "flash_attention_cuda"
    op: str                       # op it implements, e.g. "attention"
    impl: str                     # impl key, e.g. "cuda"
    fn: Callable[..., Any]
    slave_ports: Sequence[PortSpec] = ()
    master_ports: Sequence[PortSpec] = ()
    interrupt: bool = True
    power_domain: PowerDomain | None = None
    description: str = ""

    @property
    def bus_width_bits(self) -> int:
        """Paper-style bandwidth figure: 32 bit per master port per cycle."""
        return 32 * len(self.master_ports)


class InterruptController:
    """The platform's interrupt fabric (paper: PLIC + fast interrupts).

    Accelerators and the serving engine raise *lines* by name; the host
    (or any observer) connects handlers per line. Firing a line with no
    handler is not an error — the event is still counted, mirroring a
    masked interrupt that stays pending in the controller.
    """

    def __init__(self):
        self._handlers: dict[str, list[Callable[..., Any]]] = {}
        self.counts: dict[str, int] = {}

    def lines(self) -> list[str]:
        return sorted(set(self._handlers) | set(self.counts))

    def connect(self, line: str, handler: Callable[..., Any]) -> None:
        self._handlers.setdefault(line, []).append(handler)

    def disconnect(self, line: str, handler: Callable[..., Any]) -> None:
        self._handlers.get(line, []).remove(handler)

    def fire(self, line: str, payload: Any = None) -> int:
        """Raise ``line``; returns the number of handlers that ran."""
        self.counts[line] = self.counts.get(line, 0) + 1
        handlers = list(self._handlers.get(line, ()))
        for h in handlers:
            h(payload)
        return len(handlers)

    def count(self, line: str) -> int:
        return self.counts.get(line, 0)


class XaifRegistry:
    """op name -> impl name -> accelerator. The platform's plug-in socket."""

    def __init__(self):
        self._ops: dict[str, dict[str, AcceleratorSpec]] = {}

    def register(self, spec: AcceleratorSpec, *, allow_override: bool = False) -> None:
        impls = self._ops.setdefault(spec.op, {})
        if spec.impl in impls and not allow_override:
            raise ValueError(f"impl {spec.impl!r} already registered for op {spec.op!r}")
        impls[spec.impl] = spec

    def get(self, op: str, impl: str) -> AcceleratorSpec:
        try:
            return self._ops[op][impl]
        except KeyError:
            raise KeyError(
                f"no accelerator for op={op!r} impl={impl!r}; "
                f"registered: { {o: sorted(i) for o, i in self._ops.items()} }"
            ) from None

    def impls(self, op: str) -> list[str]:
        return sorted(self._ops.get(op, {}))

    def ops(self) -> list[str]:
        return sorted(self._ops)

    def dispatch(self, op: str, impl: str, *args, **kwargs):
        return self.get(op, impl).fn(*args, **kwargs)


# The process-global registry: kernels self-register on import (ops.py files).
REGISTRY = XaifRegistry()


def register(spec: AcceleratorSpec, *, allow_override: bool = False) -> AcceleratorSpec:
    REGISTRY.register(spec, allow_override=allow_override)
    return spec


def accelerator(op: str, impl: str, *, slave_ports=(), master_ports=(),
                power_domain: PowerDomain | None = None, description: str = "",
                allow_override: bool = False):
    """Decorator form of :func:`register`."""

    def deco(fn):
        register(
            AcceleratorSpec(
                name=f"{op}_{impl}", op=op, impl=impl, fn=fn,
                slave_ports=tuple(slave_ports), master_ports=tuple(master_ports),
                power_domain=power_domain, description=description,
            ),
            allow_override=allow_override,
        )
        return fn

    return deco
