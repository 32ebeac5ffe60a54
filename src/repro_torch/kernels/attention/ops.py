"""Flash attention with its backward, dispatched by device.

Port of ``src/repro/kernels/attention/ops.py`` together with the custom VJP
of the reference's training path (``_flash``/``_flash_fwd``/``_flash_bwd``,
``src/repro/models/layers.py:108-231``). :func:`flash_attention` is a
``torch.autograd.Function``: the forward saves ``(q, k, v, o, lse)`` and the
backward recomputes the scores from ``lse``, so no O(S^2) tensor is kept
between the passes.

CUDA tensors launch the hand-written kernels
(:mod:`repro_torch.kernels.attention.kernel`), CPU tensors take the plain
versions (``ref.py``), any other device raises. There is no fallback from a
kernel to its plain version. The reference's wrapper pads D to 128 and
rescales q for the TPU's matrix unit (``ops.py:48-56``); the result it
matches, ``softmax(q k^T / sqrt(D)) v``, is what both versions compute
directly. :data:`SPEC` registers :func:`flash_attention` with the XAIF
registry under the impl key ``"cuda"``, with the reference's ports and
power domain (``src/repro/kernels/attention/ops.py:64-82``).
"""

from __future__ import annotations

import torch

from repro_torch.core.power import PowerDomain
from repro_torch.core.xaif import AcceleratorSpec, PortSpec, register
from repro_torch.kernels.attention import kernel, ref
from repro_torch.sharding import axes as lx
from repro_torch.sharding.params import Axes


def _forward(q, k, v, causal, window):
    if q.device.type == "cuda":
        return kernel.flash_attention_fwd_cuda(q, k, v, causal=causal,
                                               window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def _backward(q, k, v, o, lse, do, causal, window):
    if q.device.type == "cuda":
        return kernel.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                               causal=causal, window=window)
    return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = _forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do.contiguous(), ctx.causal,
                               ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Multi-token GQA attention, differentiable.

    q ``(B, Sq, H, D)``; k/v ``(B, Sk, K, D)`` with ``H % K == 0`` (query
    head ``h`` reads KV head ``h // (H // K)``; KV is not repeated). Scale
    ``1/sqrt(D)``; ``causal`` masks keys after the query, ``window`` keeps
    the last ``window`` positions. Returns o ``(B, Sq, H, D)`` in
    ``q.dtype``; its gradients come back in the dtypes of q, k, v.
    """
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, window)


SPEC = AcceleratorSpec(
    name="flash_attention_cuda",
    op="attention",
    impl="cuda",
    fn=flash_attention,
    slave_ports=(
        PortSpec("attn_config", Axes(), direction="slave", dtype="int32"),
    ),
    master_ports=(
        PortSpec("q", Axes(lx.BATCH, lx.SEQ, lx.HEADS, lx.HEAD_DIM)),
        PortSpec("k", Axes(lx.BATCH, lx.SEQ, lx.KV_HEADS, lx.HEAD_DIM)),
        PortSpec("v", Axes(lx.BATCH, lx.SEQ, lx.KV_HEADS, lx.HEAD_DIM)),
        PortSpec("o", Axes(lx.BATCH, lx.SEQ, lx.HEADS, lx.HEAD_DIM)),
    ),
    power_domain=PowerDomain("acc_attention", leak_uw=12.0,
                             active_dyn_uw_mhz=48.0),
    description="Flash attention CUDA kernels: online softmax over KV tiles",
)
register(SPEC, allow_override=True)
