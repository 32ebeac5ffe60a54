"""The grouped matmul and the MoE expert FFN, dispatched by device, and
their XAIF registration.

Port of ``src/repro/kernels/moe/ops.py``. :func:`grouped_matmul` sends a
CUDA tensor to the hand-written kernels
(:func:`repro_torch.kernels.moe.kernel.grouped_matmul_cuda`, which plans
the route: wgmma + TMA for bf16 prefill shapes, split D for bf16 at C <=
16, ``mma.sync`` for bf16 TMA cannot read, CUDA cores for float32), a CPU
tensor to the plain version (``ref.py``), and raises on any other device.
There is no fallback from the kernels to the plain version. :func:`moe_ffn`
makes its three products (gate, up, down) through it, so on the card an
expert FFN is three calls of the kernel.

It is differentiable on both devices (:class:`_GroupedMatmul`, as the
reference's einsums are under ``jax.grad``): the forward saves x and w;
the backward computes only the gradients asked for, dx = dy w^T and dw =
x^T dy, through the backward kernels on the card
(``grouped_matmul_dx_cuda``, ``grouped_matmul_dw_cuda``) and the plain
versions on the CPU. On the card an expert FFN's backward is six kernel
calls: dx and dw for each of gate, up and down.

The ``SPEC`` keeps the reference's op name, ports (one slave port for the
routing configuration, master ports for the tokens and the three expert
weights, each with its logical axes) and power domain ``acc_moe``, and
registers under the impl key ``"cuda"``.
"""

from __future__ import annotations

import torch

from repro_torch.core.power import PowerDomain
from repro_torch.core.xaif import AcceleratorSpec, PortSpec, register
from repro_torch.kernels.moe import kernel, ref
from repro_torch.sharding import axes as lx
from repro_torch.sharding.params import Axes


class _GroupedMatmul(torch.autograd.Function):
    """y = x w per expert; the backward's two grouped products by device."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cuda":
            return kernel.grouped_matmul_cuda(x, w)
        return ref.grouped_matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        cuda = dy.device.type == "cuda"
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (kernel.grouped_matmul_dx_cuda(dy, w) if cuda
                  else ref.grouped_matmul_dx(dy, w))
        if ctx.needs_input_grad[1]:
            dw = (kernel.grouped_matmul_dw_cuda(x, dy) if cuda
                  else ref.grouped_matmul_dw(x, dy))
        return dx, dw


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, D) @ w (E, D, F) -> (E, C, F) in x's dtype, summed in
    float32; differentiable in x and w."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"grouped_matmul runs on cuda or cpu, not {x.device}")
    return _GroupedMatmul.apply(x, w)


def moe_ffn(xg: torch.Tensor, p: dict[str, torch.Tensor],
            kind: str = "swiglu") -> torch.Tensor:
    """xg (E, C, d); p: expert weights {w_gate, w_up, w_down} (E, ...),
    cast to xg's dtype as the reference casts them. Three grouped matmuls:
    the kernel on the card, the plain version on the CPU."""
    p = {n: p[n].to(xg.dtype) for n in ("w_gate", "w_up", "w_down")}
    return ref.expert_ffn(xg, p, kind, grouped_matmul)


SPEC = AcceleratorSpec(
    name="moe_grouped_matmul_cuda",
    op="moe_ffn",
    impl="cuda",
    fn=moe_ffn,
    slave_ports=(PortSpec("routing_config", Axes(), direction="slave",
                          dtype="int32"),),
    master_ports=(
        PortSpec("tokens_in", Axes(lx.EXPERT, None, lx.EMBED)),
        PortSpec("w_gate", Axes(lx.EXPERT, lx.EMBED, lx.MLP)),
        PortSpec("w_up", Axes(lx.EXPERT, lx.EMBED, lx.MLP)),
        PortSpec("w_down", Axes(lx.EXPERT, lx.MLP, lx.EMBED)),
        PortSpec("tokens_out", Axes(lx.EXPERT, None, lx.EMBED)),
    ),
    power_domain=PowerDomain("acc_moe", leak_uw=14.0, active_dyn_uw_mhz=52.0),
    description=("Per-expert matmul: bf16 prefill on persistent wgmma + "
                 "TMA tiles, decode with D split over blocks and summed in "
                 "a fixed order; unrouted experts stay power-gated"),
)
register(SPEC, allow_override=True)
