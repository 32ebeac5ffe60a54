"""Hardware constants of the paper's silicon.

A copy of ``src/repro/core/hw.py`` (which imports no JAX), kept in the port
so that ``repro_torch`` stands alone: the :class:`ChipSpec` record, the
measured DVFS envelope of the TSMC 65 nm LP HEEPocrates chip used by the
calibrated energy model (:mod:`repro_torch.core.energy`), and
:func:`bytes_of`. The reference's ``TPU_V5E`` spec is left out: its figures
are a TPU's, and the port states no TPU number. Its users (the reference's
``analysis/hlo.py`` and ``launch/dryrun.py``) are still to port, and the
card's own spec comes with them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-chip roofline terms (all per second)."""

    name: str
    peak_flops_bf16: float  # FLOP/s
    hbm_bandwidth: float    # bytes/s
    ici_bandwidth: float    # bytes/s per link
    hbm_bytes: int          # capacity
    vmem_bytes: int         # on-chip vector memory
    mxu_dim: int = 128      # systolic array tile edge


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """A (voltage, frequency) DVFS point of the HEEPocrates silicon."""

    voltage: float   # volts
    freq_hz: float   # hertz


# Measured silicon envelope (paper §IV-C): 0.8 V/170 MHz ... 1.2 V/470 MHz,
# down to the 32 kHz always-on clock.
HEEPOCRATES_POINTS = {
    "sleep_32khz_0v8": OperatingPoint(0.8, 32e3),
    "acquisition_1mhz_0v8": OperatingPoint(0.8, 1e6),
    "processing_170mhz_0v8": OperatingPoint(0.8, 170e6),
    "max_470mhz_1v2": OperatingPoint(1.2, 470e6),
    "cgra_60mhz_0v8": OperatingPoint(0.8, 60e6),
}


def bytes_of(shape, dtype_bytes: int) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * dtype_bytes
