"""The depthwise causal conv1d op (the "CGRA"), dispatched by device, and
its XAIF registration.

Port of ``src/repro/kernels/conv1d/ops.py``. :func:`conv1d` sends a CUDA
tensor to the hand-written kernel
(:func:`repro_torch.kernels.conv1d.kernel.conv1d_cuda`), a CPU tensor to
the plain version (``ref.py``), and raises on any other device. There is no
fallback from the kernel to the plain version.

Port structure mirrors the paper's CGRA (§IV-A2), as the reference's
``SPEC`` does: two slave ports (configuration registers + context memory =
the tap weights) and four master ports (the 4 PEs' independent memory
streams ≙ 4×32 bit OBI masters, 128 bit/cycle); one interrupt line
(completion callback); one power-control port (the ``cgra`` power domain
registered with the platform power manager). It registers under the impl
key ``"cuda"``.
"""

from __future__ import annotations

import torch

from repro_torch.core.power import PowerDomain
from repro_torch.core.xaif import AcceleratorSpec, PortSpec, register
from repro_torch.kernels.conv1d import kernel, ref
from repro_torch.sharding import axes as lx
from repro_torch.sharding.params import Axes


def conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,D), w (W,D) -> (B,S,D) causal depthwise conv, in x's dtype."""
    if x.device.type == "cuda":
        return kernel.conv1d_cuda(x, w)
    if x.device.type == "cpu":
        return ref.conv1d(x, w)
    raise ValueError(f"conv1d runs on cuda or cpu, not {x.device}")


SPEC = AcceleratorSpec(
    name="cgra_conv1d_cuda",
    op="conv1d",
    impl="cuda",
    fn=conv1d,
    slave_ports=(
        PortSpec("config_regs", Axes(), direction="slave", dtype="int32"),
        PortSpec("context_memory", Axes(lx.CONV, lx.RNN_WIDTH), direction="slave"),
    ),
    master_ports=(
        PortSpec("pe0_stream", Axes(lx.BATCH, lx.SEQ, lx.RNN_WIDTH)),
        PortSpec("pe1_stream", Axes(lx.BATCH, lx.SEQ, lx.RNN_WIDTH)),
        PortSpec("pe2_stream", Axes(lx.BATCH, lx.SEQ, lx.RNN_WIDTH)),
        PortSpec("pe3_stream", Axes(lx.BATCH, lx.SEQ, lx.RNN_WIDTH)),
    ),
    power_domain=PowerDomain("cgra", leak_uw=15.0, active_dyn_uw_mhz=54.63,
                             retainable=False),
    description=("CGRA-analogue depthwise conv: one thread per channel walks "
                 "a tile of time steps, taps in registers"),
)
register(SPEC, allow_override=True)
