"""The SSD chunk scan, dispatched by device.

Port of ``src/repro/kernels/ssd/ops.py``: :func:`ssd` takes the model's
layout and returns ``(y, final_state)``, differentiable: the scan is a
``torch.autograd.Function`` on both devices. CUDA tensors launch the
hand-written kernels, the forward
(:func:`repro_torch.kernels.ssd.kernel.ssd_cuda`, which reads that layout
through strides; the reference transposes to head-major for its Pallas
kernel) and the backward (:func:`~repro_torch.kernels.ssd.kernel.
ssd_bwd_cuda`, which returns dB and dC per head: where B and C are
``expand``ed over the heads, the expand's own backward sums them); CPU
tensors take the plain versions (:func:`repro_torch.kernels.ssd.ref.
ssd_chunked` and :func:`~repro_torch.kernels.ssd.ref.ssd_bwd`); any other
device raises. There is no fallback from a kernel to its plain version.
:data:`SPEC` registers :func:`ssd` with the XAIF registry under the impl
key ``"cuda"``, with the reference's ports and power domain
(``ops.py:36-53``).
"""

from __future__ import annotations

import torch

from repro_torch.core.power import PowerDomain
from repro_torch.core.xaif import AcceleratorSpec, PortSpec, register
from repro_torch.kernels.ssd import kernel, ref
from repro_torch.sharding import axes as lx
from repro_torch.sharding.params import Axes


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dA, B, C, chunk):
        if x.device.type == "cuda":
            y, state = kernel.ssd_cuda(x, dA, B, C, chunk=chunk)
        else:
            y, state = ref.ssd_chunked(x, dA, B, C, chunk=chunk)
        ctx.save_for_backward(x, dA, B, C)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dA, B, C = ctx.saved_tensors
        if x.device.type == "cuda":
            grads = kernel.ssd_bwd_cuda(x, dA, B, C, dy, dstate)
        else:
            grads = ref.ssd_bwd(x, dA, B, C, dy, dstate, chunk=ctx.chunk)
        return (*grads, None)


def _scan(x, dA, B, C, chunk):
    return _Scan.apply(x, dA, B, C, chunk)


def ssd(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        *, chunk: int, init_state: torch.Tensor | None = None,
        compute_dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``(b, s, h, p)`` (scaled by dt), dA ``(b, s, h)``, B and C ``(b, s,
    h, n)`` -> ``(y (b, s, h, p) in x's dtype, state (b, h, p, n) float32)``,
    chunks of ``min(chunk, s)``, the state starting at 0; differentiable in
    x, dA, B and C. Raises on ``init_state``, as the reference's wrapper
    does (``src/repro/kernels/ssd/ops.py:20-21``). ``compute_dtype`` is the
    reference's (``src/repro/models/mamba2.py:47``); only float32 is
    supported, on both devices: the kernels compute float32-accurate sums,
    and the reference's bfloat16 mode rounds where they do not."""
    if init_state is not None:
        raise NotImplementedError("init_state continuation is not supported "
                                  "by the SSD scan")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the SSD scan runs on cuda or cpu, not {x.device}")
    if compute_dtype != torch.float32:
        raise ValueError(f"compute_dtype {compute_dtype}: the SSD scan "
                         "computes in float32 only")
    return _scan(x, dA, B, C, chunk)


SPEC = AcceleratorSpec(
    name="ssd_chunk_scan_cuda",
    op="ssd",
    impl="cuda",
    fn=ssd,
    slave_ports=(PortSpec("chunk_config", Axes(), direction="slave",
                          dtype="int32"),),
    master_ports=(
        PortSpec("x", Axes(lx.BATCH, lx.SEQ, lx.HEADS, lx.HEAD_DIM)),
        PortSpec("dA", Axes(lx.BATCH, lx.SEQ, lx.HEADS)),
        PortSpec("B", Axes(lx.BATCH, lx.SEQ, lx.HEADS, lx.STATE)),
        PortSpec("C", Axes(lx.BATCH, lx.SEQ, lx.HEADS, lx.STATE)),
        PortSpec("y", Axes(lx.BATCH, lx.SEQ, lx.HEADS, lx.HEAD_DIM)),
    ),
    power_domain=PowerDomain("acc_ssd", leak_uw=9.0, active_dyn_uw_mhz=40.0),
    description="SSD chunk scan: chunks in parallel on the tensor cores (bf16 B, C), "
                "one block per (b, h) row on the CUDA cores (float32 B, C)",
)
register(SPEC, allow_override=True)
