"""The SSD chunk scan, dispatched by device.

Port of ``src/repro/kernels/ssd/ops.py``: :func:`ssd` takes the model's
layout and returns ``(y, final_state)``. CUDA tensors launch the
hand-written kernel (:func:`repro_torch.kernels.ssd.kernel.ssd_cuda`),
which reads that layout through strides (the reference transposes to
head-major for its Pallas kernel); CPU tensors take the plain chunked
version (:func:`repro_torch.kernels.ssd.ref.ssd_chunked`); any other device
raises. There is no fallback from the kernel to the plain version. XAIF
registration waits for the platform slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd import kernel, ref


def _scan(x, dA, B, C, chunk):
    if x.device.type == "cuda":
        return kernel.ssd_cuda(x, dA, B, C, chunk=chunk)
    return ref.ssd_chunked(x, dA, B, C, chunk=chunk)


def ssd(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        *, chunk: int, init_state: torch.Tensor | None = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``(b, s, h, p)`` (scaled by dt), dA ``(b, s, h)``, B and C ``(b, s,
    h, n)`` -> ``(y (b, s, h, p) in x's dtype, state (b, h, p, n) float32)``,
    chunks of ``min(chunk, s)``, the state starting at 0. Raises on
    ``init_state``, as the reference's wrapper does
    (``src/repro/kernels/ssd/ops.py:20-21``)."""
    if init_state is not None:
        raise NotImplementedError("init_state continuation is not supported "
                                  "by the SSD scan")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the SSD scan runs on cuda or cpu, not {x.device}")
    return _scan(x, dA, B, C, chunk)
