"""The RG-LRU linear scan, dispatched by device.

Port of ``src/repro/kernels/rglru/ops.py``. As the reference's wrapper does
(``ops.py:18-23``), :func:`rglru` folds ``h0`` into the first step
(``b[:, 0] += a[:, 0] * h0``) and casts ``a`` and ``b`` to float32. CUDA
tensors then launch the hand-written kernel
(:func:`repro_torch.kernels.rglru.kernel.rglru_scan_cuda`), CPU tensors
take the plain version (``ref.py``), and any other device raises. There is
no fallback from the kernel to the plain version. :data:`SPEC` registers
:func:`rglru` with the XAIF registry under the impl key ``"cuda"``, with
the reference's ports and power domain (``ops.py:26-39``).
"""

from __future__ import annotations

import torch

from repro_torch.core.power import PowerDomain
from repro_torch.core.xaif import AcceleratorSpec, PortSpec, register
from repro_torch.kernels.rglru import kernel, ref
from repro_torch.sharding import axes as lx
from repro_torch.sharding.params import Axes


def _scan(a, b):
    if a.device.type == "cuda":
        return kernel.rglru_scan_cuda(a, b)
    return ref.rglru(a, b)


def rglru(a: torch.Tensor, b: torch.Tensor,
          h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t * h_{t-1} + b_t``; a, b ``(B, S, W)``, h0 ``(B, W)`` or
    ``None``. Returns ``(y (B, S, W), h_final (B, W))``, both float32."""
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the RG-LRU scan runs on cuda or cpu, not {a.device}")
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0.to(b.dtype)
    return _scan(a.to(torch.float32).contiguous(),
                 b.to(torch.float32).contiguous())


SPEC = AcceleratorSpec(
    name="rglru_scan_cuda",
    op="rglru",
    impl="cuda",
    fn=rglru,
    master_ports=(
        PortSpec("a", Axes(lx.BATCH, lx.SEQ, lx.RNN_WIDTH)),
        PortSpec("b", Axes(lx.BATCH, lx.SEQ, lx.RNN_WIDTH)),
        PortSpec("y", Axes(lx.BATCH, lx.SEQ, lx.RNN_WIDTH)),
    ),
    power_domain=PowerDomain("acc_rglru", leak_uw=6.0, active_dyn_uw_mhz=22.0),
    description="RG-LRU linear scan: one thread per lane, h in a register",
)
register(SPEC, allow_override=True)
