"""Calibrated HEEPocrates energy model (paper §IV-C/D, §V, §VI).

A copy of ``src/repro/core/energy.py`` (which imports no JAX), kept in the
port so that ``repro_torch`` stands alone. Its coefficients are the paper's
65 nm silicon, not a number of any card. The reference's "TPU-scale energy
reporting" block (``TPU_*``, ``tpu_step_energy_j``) is left out: its only
user is the reference launcher's energy estimate, which the port's launcher
does not have.

The paper's evaluation is an energy study of fabricated silicon.  We model it
analytically: per power-domain leakage + dynamic coefficients (TSMC 65 nm LP
@0.8 V) with DVFS voltage scaling.  Coefficients were solved once against the
paper's measured anchors and are validated by ``tests/test_energy.py``
(the port's copy by ``tests/test_torch_platform.py``):

  * 270 µW @32 kHz/0.8 V; 48 mW @470 MHz/1.2 V          (§I, §IV-C)
  * acquisition ladder 384 → 310 (−19 %) → 286 µW (−8 %)  (§IV-C1)
  * processing ladder 8.17 → 7.68 mW (−6 %)               (§IV-C2)
  * CGRA CNN 4.01 mW @60 MHz                              (§IV-C2)
  * DVFS 5.9× power, 2.8× perf, 2.1× energy               (§IV-D)
  * CGRA 16×16 conv(3×3): 4.9× energy benefit             (Fig. 6)
  * GP-peripheral trim: −65 % AO leakage, −27 %/−3 % app energy (§VI)
  * Fig. 5 orderings: Apollo best-acquisition, GAP9 best-processing,
    HEEPocrates in between.

Accounting note: the paper counts 11 power domains; we carry two extra
*accounting-only* splits (always-on essential vs general-purpose to express the
35 %/65 % leakage split of Fig. 2d, and I/O pads to express acquisition-phase
SPI pad energy) that are not independently gateable in silicon.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core.power import PowerDomain, PowerManager, PowerState

# ---------------------------------------------------------------------------
# Calibrated constants (leak µW and dyn µW/MHz at 0.8 V)
# ---------------------------------------------------------------------------

V_NOM = 0.8
DYN_VOLT_EXP = 1.907   # dynamic ∝ (V/0.8)^1.907  (fits the 48 mW corner)
LEAK_VOLT_EXP = 2.26   # leakage ∝ (V/0.8)^2.26   (×2.5 at 1.2 V)

CPU_ACTIVE_DYN = 39.05      # matmul on CV32E20
IO_PADS_ACQ_DYN = 101.69    # SPI/ADC pad drivers during acquisition
CGRA_ACTIVE_DYN = 54.63     # CGRA datapath at full tilt

N_BANKS = 8

# cycle costs for the accelerator-vs-host study (Fig. 6)
CPU_CYCLES_PER_MAC = 12.0       # CV32E20: mul+acc+2 loads+addressing
CGRA_CYCLES_PER_MAC = 1.6555    # 4 PEs, ~6.6 cycles per 4-MAC bundle

# application profiles (paper Table 2 + §V-B)
HEARTBEAT_ACQ_S = 15.0
HEARTBEAT_PROC_CYCLES = 30.4e6   # morphological filtering (~80 %) + projections
SEIZURE_ACQ_S = 4.0
SEIZURE_PROC_CYCLES = 510e6      # 3×conv1d + pool + 2×FC on 23×1024 window


def leak_scale(voltage: float) -> float:
    return (voltage / V_NOM) ** LEAK_VOLT_EXP


def dyn_scale(voltage: float) -> float:
    return (voltage / V_NOM) ** DYN_VOLT_EXP


def build_heepocrates_pm() -> PowerManager:
    """The HEEPocrates power-domain set (paper Fig. 3)."""
    domains = [
        PowerDomain("ao_essential", leak_uw=54.25, idle_dyn_uw_mhz=2.0,
                    active_dyn_uw_mhz=2.0),
        PowerDomain("ao_gp_periph", leak_uw=100.75),
        PowerDomain("io_pads", leak_uw=0.0, active_dyn_uw_mhz=IO_PADS_ACQ_DYN),
        PowerDomain("cpu", leak_uw=25.0, idle_dyn_uw_mhz=3.0,
                    active_dyn_uw_mhz=CPU_ACTIVE_DYN),
        PowerDomain("periph", leak_uw=25.0, idle_dyn_uw_mhz=1.2,
                    active_dyn_uw_mhz=4.0),
        *[PowerDomain(f"bank{i}", leak_uw=5.0, idle_dyn_uw_mhz=0.12,
                      active_dyn_uw_mhz=1.0, retainable=True)
          for i in range(N_BANKS)],
        PowerDomain("cgra_logic", leak_uw=10.0, idle_dyn_uw_mhz=0.2,
                    active_dyn_uw_mhz=CGRA_ACTIVE_DYN),
        PowerDomain("cgra_mem", leak_uw=5.0, idle_dyn_uw_mhz=0.1,
                    active_dyn_uw_mhz=2.0, retainable=True),
        PowerDomain("imc", leak_uw=8.0, idle_dyn_uw_mhz=0.2,
                    active_dyn_uw_mhz=25.0),
        PowerDomain("fll", leak_uw=2.0, idle_dyn_uw_mhz=1.0,
                    active_dyn_uw_mhz=1.0),
    ]
    return PowerManager(domains)


def _banks(prefix: str, n: int) -> list[str]:
    return [f"bank{i}" for i in range(n)]


# ---------------------------------------------------------------------------
# Scenario powers (all µW unless stated)
# ---------------------------------------------------------------------------

def power_uw(pm: PowerManager, freq_mhz: float, voltage: float,
             activity: Mapping[str, float]) -> float:
    return pm.power_uw(freq_mhz, activity=activity,
                       leak_scale=leak_scale(voltage),
                       dyn_scale=dyn_scale(voltage))


def _proc_activity() -> dict[str, float]:
    # CPU matmul touching 2 of 8 banks.
    return {"cpu": 1.0, "bank0": 1.0, "bank1": 1.0}


def power_sleep_32khz() -> float:
    pm = build_heepocrates_pm()
    return power_uw(pm, 0.032, 0.8, {})


def power_max_470mhz_1v2() -> float:
    pm = build_heepocrates_pm()
    return power_uw(pm, 470.0, 1.2, _proc_activity())


def power_processing(optimized: bool = False) -> float:
    """§IV-C2: 8.17 mW all-on -> 7.68 mW with unused domains off (-6 %)."""
    pm = build_heepocrates_pm()
    if optimized:
        off = ["periph", "imc", "cgra_logic", "cgra_mem"] + [f"bank{i}" for i in range(2, 8)]
        pm.set_states({d: PowerState.OFF for d in off})
    return power_uw(pm, 170.0, 0.8, _proc_activity())


def power_acquisition(level: int = 0) -> float:
    """§IV-C1 ladder. level 0: all-on, CPU clock-gated between samples (384 µW);
    level 1: + unused banks/periph/accelerators off (310 µW);
    level 2: + CPU power-gated during idle (286 µW)."""
    pm = build_heepocrates_pm()
    cpu_duty = 0.15
    act = {"cpu": cpu_duty, "ao_essential": 1.0, "io_pads": 1.0,
           "bank0": 0.3, "bank1": 0.3, "bank2": 0.3}
    pm.set_state("cpu", PowerState.CLOCK_GATED)
    if level >= 1:
        off = ["periph", "imc", "cgra_logic", "cgra_mem"] + [f"bank{i}" for i in range(3, 8)]
        pm.set_states({d: PowerState.OFF for d in off})
    p = power_uw(pm, 1.0, 0.8, act)
    if level >= 2:
        # CPU power-gated during idle: pays leakage only for its duty cycle.
        p -= pm.domains["cpu"].leak_uw * (1.0 - cpu_duty)
    return p


def power_cgra_cnn() -> float:
    """§IV-C2: CGRA CNN at 60 MHz, CPU/periph/unused banks off -> 4.01 mW."""
    pm = build_heepocrates_pm()
    off = ["cpu", "periph", "imc"] + [f"bank{i}" for i in range(4, 8)]
    pm.set_states({d: PowerState.OFF for d in off})
    act = {"cgra_logic": 1.0, "cgra_mem": 1.0, "ao_essential": 1.0,
           "bank0": 1.0, "bank1": 1.0, "bank2": 1.0, "bank3": 1.0}
    return power_uw(pm, 60.0, 0.8, act)


# ---------------------------------------------------------------------------
# Derived paper results
# ---------------------------------------------------------------------------

def dvfs_ratios() -> tuple[float, float, float]:
    """Returns (power_ratio ~5.9, perf_ratio ~2.8, energy_ratio ~2.1)."""
    p_hi = power_max_470mhz_1v2()
    p_lo = power_processing(optimized=False)
    power_ratio = p_hi / p_lo
    perf_ratio = 470.0 / 170.0
    energy_ratio = power_ratio / perf_ratio
    return power_ratio, perf_ratio, energy_ratio


def conv_energy_uj(on_cgra: bool, img: int = 16, filt: int = 3) -> float:
    """Fig. 6: energy of one img×img conv with filt×filt filter."""
    macs = img * img * filt * filt
    if on_cgra:
        cycles = macs * CGRA_CYCLES_PER_MAC
        t_s = cycles / 60e6
        return power_cgra_cnn() * 1e-6 * t_s * 1e6
    cycles = macs * CPU_CYCLES_PER_MAC
    t_s = cycles / 170e6
    return power_processing(optimized=True) * 1e-6 * t_s * 1e6


def cgra_benefit() -> float:
    return conv_energy_uj(on_cgra=False) / conv_energy_uj(on_cgra=True)


# ---------------------------------------------------------------------------
# Fig. 5 — MCU comparison models
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class McuModel:
    """Two-phase (acquisition + processing) energy model of one MCU."""

    name: str
    acq_power_uw: float          # duty-cycled sleep/acquire power
    proc_power_uw: float         # active processing power
    proc_freq_mhz: float
    cycle_scale: Mapping[str, float]  # app -> relative cycle count vs CV32E20

    def app_energy_mj(self, app: "AppProfile") -> tuple[float, float]:
        scale = self.cycle_scale.get(app.name, 1.0)
        t_proc = app.proc_cycles * scale / (self.proc_freq_mhz * 1e6)
        e_acq = self.acq_power_uw * 1e-6 * app.acq_s * 1e3
        e_proc = self.proc_power_uw * 1e-6 * t_proc * 1e3
        return e_acq, e_proc


@dataclasses.dataclass(frozen=True)
class AppProfile:
    name: str
    acq_s: float
    proc_cycles: float


HEARTBEAT = AppProfile("heartbeat", HEARTBEAT_ACQ_S, HEARTBEAT_PROC_CYCLES)
SEIZURE = AppProfile("seizure", SEIZURE_ACQ_S, SEIZURE_PROC_CYCLES)


def mcu_models(trim_gp_periph: bool = False) -> dict[str, McuModel]:
    """Table 1 MCUs. ``trim_gp_periph`` applies the §VI what-if (remove the
    general-purpose peripherals from the HEEPocrates always-on domain)."""
    heep_acq = power_acquisition(level=2)
    heep_proc = power_processing(optimized=True)
    if trim_gp_periph:
        gp = 100.75  # 65 % of the always-on leakage (Fig. 2d)
        heep_acq -= gp
        heep_proc -= gp
    return {
        "apollo3_blue": McuModel(
            "apollo3_blue", acq_power_uw=60.0, proc_power_uw=4600.0,
            proc_freq_mhz=96.0, cycle_scale={"heartbeat": 0.88, "seizure": 1.1}),
        "gap9": McuModel(
            "gap9", acq_power_uw=400.0, proc_power_uw=5600.0,
            proc_freq_mhz=240.0, cycle_scale={"heartbeat": 0.6, "seizure": 0.6}),
        "heepocrates": McuModel(
            "heepocrates", acq_power_uw=heep_acq, proc_power_uw=heep_proc,
            proc_freq_mhz=170.0, cycle_scale={}),
    }


def gp_trim_saving(app: AppProfile) -> float:
    """Fraction of HEEPocrates app energy saved by trimming GP peripherals
    (paper: ~27 % heartbeat, ~3 % seizure)."""
    base = sum(mcu_models()["heepocrates"].app_energy_mj(app))
    trimmed = sum(mcu_models(trim_gp_periph=True)["heepocrates"].app_energy_mj(app))
    return 1.0 - trimmed / base


# ---------------------------------------------------------------------------
# Serving operating points (DVFS analogue for the serving stack)
# ---------------------------------------------------------------------------

# Cycle model for the serving energy meter: a decode token replays the whole
# cached context (memory-bound), a prefill token is written once. The absolute
# numbers are model constants (they scale every per-token figure together);
# what the calibration pins down is the *ratio* between operating points,
# which inherits the paper's §IV-D DVFS curve through leak/dyn voltage
# scaling below.
CYCLES_PER_DECODE_TOKEN = 2e6
CYCLES_PER_PREFILL_TOKEN = 1e6


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One DVFS point of the serving platform (paper §IV-D).

    ``max`` is the 470 MHz/1.2 V corner the engine boots at; ``nominal`` is
    the 170 MHz/0.8 V point the DVFS-throttle policy drops to. The energy
    meter charges dynamic energy ∝ dyn_scale (CV²·cycles — frequency
    cancels) and leakage ∝ leak_scale × time (frequency-dependent), so the
    tokens/joule ratio between the two points lands on the calibrated
    ~2.1× energy ratio of ``dvfs_ratios()``.
    """

    name: str
    freq_mhz: float
    voltage: float

    @property
    def leak_scale(self) -> float:
        """Leakage multiplier vs the 0.8 V baseline at this voltage."""
        return leak_scale(self.voltage)

    @property
    def dyn_scale(self) -> float:
        """Dynamic-energy multiplier vs the 0.8 V baseline at this voltage."""
        return dyn_scale(self.voltage)


OPERATING_POINTS: dict[str, OperatingPoint] = {
    "max": OperatingPoint("max", freq_mhz=470.0, voltage=1.2),
    "nominal": OperatingPoint("nominal", freq_mhz=170.0, voltage=0.8),
}


def operating_point(name: str) -> OperatingPoint:
    """Look up a named DVFS point, with a helpful error on typos."""
    try:
        return OPERATING_POINTS[name]
    except KeyError:
        raise ValueError(
            f"unknown operating point {name!r} "
            f"(have {sorted(OPERATING_POINTS)})") from None
