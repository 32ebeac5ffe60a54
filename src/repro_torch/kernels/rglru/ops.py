"""The RG-LRU linear scan, dispatched by device.

Port of ``src/repro/kernels/rglru/ops.py``. As the reference's wrapper does
(``ops.py:18-23``), :func:`rglru` folds ``h0`` into the first step
(``b[:, 0] += a[:, 0] * h0``, differentiable, so ``h0`` and ``a[:, 0]``
get their share of the gradient) and casts ``a`` and ``b`` to float32.
The scan itself is a ``torch.autograd.Function`` on both devices: CUDA
tensors launch the hand-written kernels, the forward
(:func:`repro_torch.kernels.rglru.kernel.rglru_scan_cuda`) and its
backward (:func:`~repro_torch.kernels.rglru.kernel.rglru_scan_bwd_cuda`,
which reads ``h_{t-1}`` from the saved ``y``); CPU tensors take the plain
versions (``ref.py``), and any other device raises. There is no fallback
from a kernel to its plain version. :data:`SPEC` registers
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


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        if a.device.type == "cuda":
            y, h = kernel.rglru_scan_cuda(a, b)
        else:
            y, h = ref.rglru(a, b)
        ctx.save_for_backward(a, y)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        a, y = ctx.saved_tensors
        dy, dh = dy.contiguous(), dh.contiguous()
        if a.device.type == "cuda":
            return kernel.rglru_scan_bwd_cuda(a, y, dy, dh)
        return ref.rglru_bwd(a, y, dy, dh)


def _scan(a, b):
    return _Scan.apply(a, b)


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
    description="RG-LRU linear scan: blocks of 32 lanes, 128-step tiles "
                "streamed through a cp.async ring in shared memory, h in a "
                "register",
)
register(SPEC, allow_override=True)
