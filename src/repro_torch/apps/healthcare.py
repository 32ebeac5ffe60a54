"""The paper's healthcare benchmark applications (§V-B), in PyTorch.

Port of ``src/repro/apps/healthcare.py``:

* Heartbeat classifier [Braojos et al., DATE'13]: morphological filtering
  (~80 % of cycles) + random-projection classification over 3-lead ECG.
* Seizure detection CNN [Gómez et al., 2020]: 3 × (conv1d + pool + ReLU)
  + 2 fully-connected layers over 23-lead EEG.

Both run on the *host* path (plain PyTorch) or offload their convolutions
to the CGRA accelerator (the hand-written conv1d CUDA kernel, registered
under ``"cuda"``) through XAIF — the software side of the paper's Fig. 6
experiment. Everything runs on an explicit device: ``device=None`` is the
card (:func:`repro_torch.device.resolve`); pass ``device="cpu"`` for the
plain path on the CPU.

Random weights: the reference draws :meth:`SeizureCNN.init` and
:meth:`HeartbeatModel.projection` from ``jax.random`` (threefry), which the
port does not reproduce. The port draws the same shapes and scales from a
``torch.Generator`` seeded with the model's ``seed`` (on the CPU, so every
device gets the same numbers), and these numbers differ from JAX's. To hold
the port to the reference, pass the reference's weights in: ``params`` to
:meth:`SeizureCNN.apply` and ``projection`` to
:meth:`HeartbeatModel.classify`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

import repro_torch.kernels  # noqa: F401  (XAIF registration of the CGRA)
from repro_torch import device as device_mod
from repro_torch.core.xaif import REGISTRY
from repro_torch.data import biosignal

F32 = torch.float32


# ---------------------------------------------------------------------------
# Heartbeat classifier
# ---------------------------------------------------------------------------


def _window(x: torch.Tensor, width: int, fill: float) -> torch.Tensor:
    """(leads, n, width) sliding windows along time, padded with ``fill``
    ``width // 2`` steps on the left and ``width - 1 - width // 2`` on the
    right, as the reference pads (``healthcare.py:32-44``)."""
    xp = F.pad(x, (width // 2, width - 1 - width // 2), value=fill)
    return xp.unfold(-1, width, 1)


def _erode(x: torch.Tensor, width: int) -> torch.Tensor:
    """Morphological erosion along time: min over a sliding window."""
    return _window(x, width, math.inf).amin(-1)


def _dilate(x: torch.Tensor, width: int) -> torch.Tensor:
    return _window(x, width, -math.inf).amax(-1)


def morphological_filter(ecg: torch.Tensor, width: int = 13) -> torch.Tensor:
    """Baseline-wander removal by opening+closing (the 80 %-of-cycles stage)."""
    x = ecg.to(F32)
    opened = _dilate(_erode(x, width), width)
    closed = _erode(_dilate(opened, width), width)
    return x - closed


def median(f: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values for an even count,
    as ``(low + high) * 0.5`` (JAX's "midpoint" quantile). ``torch.median``
    returns the lower of the two instead."""
    s = f.sort(dim=dim).values
    n = s.shape[dim]
    low = s.select(dim, (n - 1) // 2)
    high = s.select(dim, n // 2)
    return (low + high) * 0.5


def _std(s: torch.Tensor) -> torch.Tensor:
    """``jnp.std``: the square root of the mean squared deviation (divides
    by n, not n - 1 as ``torch.std`` does by default)."""
    return ((s - s.mean()) ** 2).mean().sqrt()


def _dev_scores(f: torch.Tensor) -> torch.Tensor:
    """f (beats, dim) -> each beat's distance from the median template."""
    return ((f - median(f, 0)) ** 2).sum(-1).sqrt()


@dataclasses.dataclass(frozen=True)
class HeartbeatModel:
    projection_dim: int = 32
    sigma: float = 2.0     # adaptive threshold: mean + sigma*std
    seed: int = 42

    def projection(self, window: int, device=None) -> torch.Tensor:
        """A (window, projection_dim) float32 random projection, N(0, 1) /
        sqrt(window), drawn from a generator seeded with ``seed`` (not the
        reference's numbers: see the module's docstring)."""
        gen = torch.Generator().manual_seed(self.seed)
        p = torch.randn((window, self.projection_dim), generator=gen,
                        dtype=F32) / math.sqrt(window)
        return p.to(device_mod.resolve(device))

    def classify(self, ecg, *, projection=None, device=None) -> torch.Tensor:
        """ecg: (leads, samples) int16 -> per-beat abnormality flags (bool).

        Stages (paper §V-B1): morphological filtering -> R-peak-aligned beat
        segmentation -> random projection -> template-deviation score.
        Lead 0 is analysed first; the other leads confirm. ``projection``
        (``(192, projection_dim)``) replaces :meth:`projection`."""
        s0, thr0, sc, thrc = self._scores(ecg, projection, device)
        return (s0 > thr0) & (sc > thrc)                   # lead 0 first

    def _scores(self, ecg, projection, device):
        """The deviation scores and thresholds :meth:`classify` compares:
        ``(lead 0's scores, its threshold, the other leads' mean scores,
        their threshold)``."""
        dev = device_mod.resolve(device)
        x = torch.as_tensor(np.asarray(ecg), device=dev)
        filt = morphological_filter(x.to(F32) / 16384.0)
        n = filt.shape[1]
        period = 256.0 / 1.2                     # nominal 72 bpm grid
        n_beats = int(n / period) - 1
        half = 64
        width = 192

        # R-peak detection: argmax of |lead 0| within each nominal region.
        # The grid is float32 arithmetic truncated to int32, as in JAX
        f32 = lambda v: torch.tensor(v, dtype=F32, device=dev)
        grid = torch.arange(1, n_beats + 1, dtype=F32, device=dev)
        starts = (grid * f32(period) - f32(period / 2)).to(torch.int32).long()
        region = torch.arange(int(period), device=dev)
        ridx = (starts[:, None] + region[None, :]).clamp(0, n - 1)
        peaks = starts + torch.argmax(filt[0].abs()[ridx], dim=1)

        # peak-centered beat windows, all leads
        widx = (peaks[:, None] - half
                + torch.arange(width, device=dev)[None, :]).clamp(0, n - 1)
        beats = filt[:, widx]                    # (leads, beats, width)
        proj = (self.projection(width, dev) if projection is None
                else torch.as_tensor(np.array(projection, np.float32),
                                     device=dev))
        feats = torch.einsum("lbt,td->lbd", beats, proj)

        s0 = _dev_scores(feats[0])
        thr0 = s0.mean() + self.sigma * _std(s0)
        sc = torch.stack([_dev_scores(f) for f in feats[1:]]).mean(0)
        thrc = sc.mean() + 0.5 * self.sigma * _std(sc)
        return s0, thr0, sc, thrc

    def mac_count(self, samples: int) -> int:
        beat_len = 213
        n_beats = samples // beat_len
        morph = samples * 13 * 4 * 3           # 4 morphology passes x 3 leads
        proj = n_beats * beat_len * self.projection_dim * 3
        return morph + proj


# ---------------------------------------------------------------------------
# Seizure detection CNN
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SeizureCNN:
    channels: tuple = (23, 32, 32, 16)
    kernel: int = 4
    hidden: int = 64
    seed: int = 7

    def init(self, device=None) -> dict:
        """The parameter dict on ``device``: the reference's shapes and
        scales, drawn from a generator seeded with ``seed`` (not the
        reference's numbers: see the module's docstring)."""
        gen = torch.Generator().manual_seed(self.seed)
        normal = lambda *shape: torch.randn(shape, generator=gen, dtype=F32)
        p = {}
        for i in range(3):
            cin, cout = self.channels[i], self.channels[i + 1]
            p[f"conv{i}_w"] = (normal(self.kernel, cin, cout)
                               * (1.0 / np.sqrt(self.kernel * cin)))
            p[f"conv{i}_b"] = torch.zeros((cout,), dtype=F32)
        feat = self.channels[-1] * (1024 // 2 ** 3)
        p["fc1_w"] = normal(feat, self.hidden) / np.sqrt(feat)
        p["fc1_b"] = torch.zeros((self.hidden,), dtype=F32)
        p["fc2_w"] = normal(self.hidden, 2) / np.sqrt(self.hidden)
        p["fc2_b"] = torch.zeros((2,), dtype=F32)
        dev = device_mod.resolve(device)
        return {k: v.to(dev) for k, v in p.items()}

    def _conv(self, x, w, b, impl: str):
        """x: (B,S,Cin), w: (K,Cin,Cout). Full conv = K·Cin·Cout MACs/sample.
        The CGRA path streams each tap-slice through the depthwise kernel."""
        k, cin, cout = w.shape
        if impl == "cgra":
            # express the dense conv as cin depthwise convs + channel mix
            # (the CGRA's 4 PEs stream 4 taps — paper Fig. 6 kernel shape);
            # each input channel is broadcast over the outputs with stride 0
            y = 0.0
            for ci in range(cin):
                xi = x[..., ci:ci + 1].expand(*x.shape[:-1], cout)
                y = y + REGISTRY.dispatch("conv1d", "cuda", xi, w[:, ci, :])
            return y + b
        # host path: shift-and-accumulate (CV32E20-style MAC loop)
        s = x.shape[1]
        xp = F.pad(x, (0, 0, k - 1, 0))
        y = sum(torch.einsum("bsc,cd->bsd", xp[:, i:i + s], w[i])
                for i in range(k))
        return y + b

    def apply(self, eeg, impl: str = "host", params=None,
              device=None) -> torch.Tensor:
        """eeg: (leads, samples) int16 -> (2,) logits [normal, seizure], on
        ``device``. ``params`` (as :meth:`init` returns, on that device)
        default to :meth:`init`'s."""
        dev = device_mod.resolve(device)
        p = params if params is not None else self.init(dev)
        x = torch.as_tensor(np.asarray(eeg), device=dev)
        x = (x.to(F32) / 8192.0).T[None]             # (1, S, leads)
        x = x[:, :1024]
        for i in range(3):
            x = self._conv(x, p[f"conv{i}_w"], p[f"conv{i}_b"], impl)
            x = torch.relu(x)
            x = x[:, ::2]                              # max-ish pool (stride)
        feat = x.reshape(1, -1)
        h = torch.relu(feat @ p["fc1_w"] + p["fc1_b"])
        return (h @ p["fc2_w"] + p["fc2_b"])[0]

    def mac_count(self, samples: int = 1024) -> int:
        total, s = 0, samples
        for i in range(3):
            total += s * self.kernel * self.channels[i] * self.channels[i + 1]
            s //= 2
        feat = self.channels[-1] * s
        total += feat * self.hidden + self.hidden * 2
        return total


def run_heartbeat(seed: int = 0, device=None, projection=None):
    """The heartbeat classifier on one synthetic ECG window: ``(flags as a
    numpy bool array, MAC count)``."""
    ecg = biosignal.ecg_window(biosignal.HEARTBEAT_ECG, seed=seed)
    model = HeartbeatModel()
    flags = model.classify(ecg, projection=projection, device=device)
    return flags.cpu().numpy(), model.mac_count(ecg.shape[1])


def run_seizure(seed: int = 0, impl: str = "host", device=None, params=None):
    """The seizure CNN on one synthetic EEG window: ``(logits as a numpy
    float32 array, MAC count)``."""
    eeg = biosignal.eeg_window(biosignal.SEIZURE_EEG, seed=seed,
                               seizure=(seed % 5 == 0))
    model = SeizureCNN()
    logits = model.apply(eeg, impl, params, device=device)
    return logits.cpu().numpy(), model.mac_count()
