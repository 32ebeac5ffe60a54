"""Synthetic biosignal acquisition pipeline (paper §V-B).

A copy of ``src/repro/data/biosignal.py`` (numpy only), kept in the port so
that ``repro_torch`` stands alone; its windows equal the reference's bit for
bit.

Simulates the HEEPocrates acquisition phase: ECG (3 leads @256 Hz, 16 bit)
for the heartbeat classifier and EEG (23 leads @256 Hz) for the seizure CNN.
The generator streams sample windows exactly like the paper's SPI+DMA path
stores them into SRAM banks; bank residency is reported so the power manager
can gate unused banks (the -19 % acquisition optimization).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

SAMPLE_RATE_HZ = 256
BANK_BYTES = 32 * 1024   # one X-HEEP SRAM bank


@dataclasses.dataclass(frozen=True)
class AcquisitionSpec:
    name: str
    leads: int
    window_s: float
    bits_per_sample: int = 16

    @property
    def samples_per_window(self) -> int:
        return int(self.window_s * SAMPLE_RATE_HZ)

    @property
    def window_bytes(self) -> int:
        return self.leads * self.samples_per_window * self.bits_per_sample // 8

    @property
    def banks_needed(self) -> int:
        return max(1, math.ceil(self.window_bytes / BANK_BYTES))


# Paper Table 2
HEARTBEAT_ECG = AcquisitionSpec("heartbeat_ecg", leads=3, window_s=15.0)
SEIZURE_EEG = AcquisitionSpec("seizure_eeg", leads=23, window_s=4.0)


def ecg_window(spec: AcquisitionSpec, seed: int = 0,
               abnormal: bool = True) -> np.ndarray:
    """(leads, samples) int16 synthetic ECG with QRS-like spikes."""
    rng = np.random.default_rng(seed)
    n = spec.samples_per_window
    t = np.arange(n) / SAMPLE_RATE_HZ
    out = np.zeros((spec.leads, n), np.float32)
    hr = 1.2  # ~72 bpm
    for lead in range(spec.leads):
        base = 0.05 * np.sin(2 * np.pi * 0.3 * t + lead)
        qrs = np.zeros(n, np.float32)
        phase = (t * hr) % 1.0
        qrs += np.exp(-((phase - 0.5) ** 2) / 0.0004) * (1.0 + 0.1 * lead)
        if abnormal:
            beat_idx = (t * hr).astype(int)
            irregular = (beat_idx % 7 == 3).astype(np.float32)
            qrs += irregular * np.exp(-((phase - 0.62) ** 2) / 0.001) * 0.8
        noise = rng.normal(0, 0.02, n).astype(np.float32)
        out[lead] = base + qrs + noise
    return np.clip(out * 16384, -32768, 32767).astype(np.int16)


def eeg_window(spec: AcquisitionSpec, seed: int = 0,
               seizure: bool = False) -> np.ndarray:
    """(leads, samples) int16 synthetic EEG; seizures add 3 Hz spike-waves."""
    rng = np.random.default_rng(seed)
    n = spec.samples_per_window
    t = np.arange(n) / SAMPLE_RATE_HZ
    out = np.zeros((spec.leads, n), np.float32)
    for lead in range(spec.leads):
        alpha = 0.3 * np.sin(2 * np.pi * 10 * t + rng.uniform(0, 6))
        beta = 0.1 * np.sin(2 * np.pi * 22 * t + rng.uniform(0, 6))
        sig = alpha + beta + rng.normal(0, 0.15, n)
        if seizure:
            sw = np.sign(np.sin(2 * np.pi * 3 * t)) * 0.9
            sig = sig * 0.4 + sw * (1 + 0.05 * lead)
        out[lead] = sig
    return np.clip(out * 8192, -32768, 32767).astype(np.int16)


class AcquisitionSim:
    """Streams windows + reports bank usage to the power manager."""

    def __init__(self, spec: AcquisitionSpec, n_banks: int = 8, seed: int = 0):
        self.spec = spec
        self.n_banks = n_banks
        self.seed = seed

    def bank_states(self) -> list[bool]:
        """True = bank holds acquisition data (must stay on/retained)."""
        used = self.spec.banks_needed
        return [i < used for i in range(self.n_banks)]

    def window(self, idx: int) -> np.ndarray:
        if self.spec.name.startswith("heartbeat"):
            return ecg_window(self.spec, seed=self.seed + idx)
        return eeg_window(self.spec, seed=self.seed + idx,
                          seizure=(idx % 5 == 0))
