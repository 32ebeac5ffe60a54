"""Plain PyTorch versions of the grouped matmul and the MoE expert FFN.

Port of ``src/repro/kernels/moe/ref.py``, with the Pallas kernel's own
arithmetic (``src/repro/kernels/moe/kernel.py:21-35``): float32 products, a
float32 sum over D and one rounding to x's dtype. The backward's two
products, :func:`grouped_matmul_dx` and :func:`grouped_matmul_dw` (the
gradient of ``jnp.einsum("ecd,edf->ecf")``, which the reference takes
with ``jax.grad``), have the same arithmetic; float64 inputs stay float64
throughout, for ``gradcheck``. They take any C, D and F (the Pallas
wrapper asserts its block sizes divide them) and run on any device; the
tests and ``chip_smoke.py`` hold the CUDA kernels to them.
:func:`expert_ffn` takes the matmul as an argument, so ``ops.moe_ffn``
runs the same FFN through the kernel; :func:`silu` is also mamba2's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it: ``x * (1 / (1 + exp(-x)))``,
    each step rounded to x's dtype (``F.silu`` rounds once, so in bf16 it
    parts from the reference by an ulp in about a third of the values)."""
    return x * (1 / (1 + torch.exp(-x)))


def expert_ffn(xg: torch.Tensor, p: dict[str, torch.Tensor], kind: str,
               matmul) -> torch.Tensor:
    """xg (E, C, d) -> (E, C, d), experts batched on dim 0, each of the
    three products ``matmul(x (E, C, D), w (E, D, F))``. The activation is
    the reference's: SiLU rounded as XLA rounds it (:func:`silu`) for
    ``"swiglu"``, tanh GELU otherwise (``src/repro/models/layers.py:381-386``)."""
    gate = matmul(xg, p["w_gate"])
    up = matmul(xg, p["w_up"])
    act = silu(gate) if kind == "swiglu" else F.gelu(gate, approximate="tanh")
    return matmul(act * up, p["w_down"])


def _acc(t: torch.Tensor) -> torch.dtype:
    """The sum's dtype: float32, or float64 for float64 inputs (gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, D) @ w (E, D, F) -> (E, C, F) in x's dtype, summed in
    float32."""
    acc = _acc(x)
    return torch.einsum("ecd,edf->ecf", x.to(acc), w.to(acc)).to(x.dtype)


def grouped_matmul_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The backward's dx: dy (E, C, F) . w (E, D, F)^T -> (E, C, D) in dy's
    dtype, summed over F in float32, one rounding (the kernels' contract)."""
    acc = _acc(dy)
    return torch.einsum("ecf,edf->ecd", dy.to(acc), w.to(acc)).to(dy.dtype)


def grouped_matmul_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The backward's dw: x (E, C, D)^T . dy (E, C, F) -> (E, D, F) in x's
    dtype, summed over the C rows in float32, one rounding."""
    acc = _acc(x)
    return torch.einsum("ecd,ecf->edf", x.to(acc), dy.to(acc)).to(x.dtype)


def moe_ffn(xg: torch.Tensor, p: dict[str, torch.Tensor],
            kind: str = "swiglu") -> torch.Tensor:
    """Per-expert gated FFN on capacity-grouped tokens xg (E, C, d): three
    grouped matmuls with the reference's activation between them
    (``src/repro/kernels/moe/ops.py:28-38``)."""
    return expert_ffn(xg, p, kind, grouped_matmul)
