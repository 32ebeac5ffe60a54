"""Device meshes for tensor-parallel serving and replica groups.

Port of ``src/repro/launch/mesh.py``. The reference drives every device of
its mesh from one process (the decode runs under ``shard_map``), and its
tests fake the devices (``--xla_force_host_platform_device_count``). The
port does the same with its own :class:`Mesh`: one process, a numpy array
of ``torch.device`` entries named by axis. An entry may repeat, so a mesh
of ``["cuda:0"] * 4`` runs a tp 4 decode on one card and a mesh of
``["cpu"] * 2`` a tp 2 decode in a CPU test; each position still holds a
shard of its own.

The constructors are functions, never module-level constants, so importing
this module touches no device. Their default device list is every CUDA
device the process sees; with fewer than needed they raise ``ValueError``,
and the message says to pass ``devices=``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch import device as device_mod


class Mesh:
    """Named axes over an array of devices.

    ``devices`` is a numpy object array of ``torch.device`` (CUDA entries
    carry their index), ``axis_names`` one name per dimension, and
    ``shape`` maps each name to its size. Two meshes are equal when they
    name the same devices in the same layout under the same axis names, as
    two JAX meshes over one device array are.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        flat = [device_mod.resolve(d) for d in arr.flat]
        self.devices = np.empty(len(flat), dtype=object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d device array")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def _key(self) -> tuple:
        return (self.axis_names, self.devices.shape, tuple(self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"[{', '.join(str(d) for d in self.devices.flat)}])")


def _devices(devices, need: int, what: str) -> list:
    """``devices`` as a list (default: every CUDA device), at least
    ``need`` of them."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) < need:
        raise ValueError(
            f"need {need} devices for {what}, have {len(devices)}: pass "
            f"devices= explicitly, e.g. ['cuda:0'] * {need} or "
            f"['cpu'] * {need} (an entry may repeat)")
    return devices


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over the first ``prod(shape)``
    of ``devices``, in row-major order."""
    shape = tuple(shape)
    n = math.prod(shape)
    devs = _devices(devices, n, f"a {shape} mesh")[:n]
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The reference's production shapes: ``(16, 16)`` over ``("data",
    "model")``, or with ``multi_pod`` ``(2, 16, 16)`` over ``("pod",
    "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_host_mesh(devices=None) -> Mesh:
    """Every given device (default: every CUDA device) under the
    production axis names: ``(1, 1)`` for one, else ``(n, 1)``."""
    devs = _devices(devices, 1, "a host mesh")
    n = len(devs)
    return make_mesh((1, n) if n == 1 else (n, 1), ("data", "model"), devs)


def serve_tp_mesh(tp: int, devices=None) -> Mesh:
    """A 1-D ``("model",)`` mesh of ``tp`` devices for the tensor-parallel
    paged decode (:mod:`repro_torch.serve.paged`): the first ``tp`` of
    ``devices`` (default: every CUDA device)."""
    devs = _devices(devices, tp, f"tp={tp}")
    return make_mesh((tp,), ("model",), devs[:tp])


def replica_meshes(replicas: int, tp: int, devices=None) -> list[Mesh]:
    """``replicas`` ``("model",)`` meshes of ``tp`` devices each, slice
    ``i`` being ``devices[i*tp:(i+1)*tp]`` (disjoint where the entries
    are), for :meth:`~repro_torch.serve.cluster.ServeCluster.
    add_replica_group`."""
    devs = _devices(devices, replicas * tp,
                    f"{replicas} replicas at tp={tp}")
    return [serve_tp_mesh(tp, devs[i * tp:(i + 1) * tp])
            for i in range(replicas)]
