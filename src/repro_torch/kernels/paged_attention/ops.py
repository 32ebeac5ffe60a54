"""Dispatch for the paged decode attention op.

Port of ``src/repro/kernels/paged_attention/ops.py``. The op runs where its
tensors are: a CUDA query launches the hand-written Hopper kernel
(:func:`repro_torch.kernels.paged_attention.kernel.paged_attention_cuda`),
a CPU query takes the plain PyTorch version (``ref.py``), and any other
device raises. There is no fallback from the kernel to the plain version:
a kernel that does not build or launch raises.

The KV append is plain PyTorch indexing on either device (the JAX package
computes it as an XLA scatter outside its Pallas kernel too) and writes the
pool **in place**. :data:`SPEC` registers :func:`paged_attention` with
the XAIF registry under the impl key ``"cuda"``, with the reference's
ports and power domain (``ops.py:78-98``).
"""

from __future__ import annotations

from repro_torch.core.power import PowerDomain
from repro_torch.core.xaif import AcceleratorSpec, PortSpec, register
from repro_torch.kernels.paged_attention import kernel, ref
from repro_torch.sharding import axes as lx
from repro_torch.sharding.params import Axes


def paged_attention(q, k_pool, v_pool, tables, lengths, *,
                    window: int | None = None):
    """Single-query paged attention over a (P, ps, K, D) page pool.

    q (B, H, D); tables (B, NP) int32 page ids; lengths (B,) int32 valid
    counts. With ``window`` the tables carry **ring** semantics (entry
    ``e`` holds the newest block ``≡ e (mod NP)``) and only the last
    ``window`` positions attend. Returns (B, H, D) in ``q.dtype``.
    """
    if q.device.type == "cuda":
        return kernel.paged_attention_cuda(q, k_pool, v_pool, tables, lengths,
                                           window=window)
    if q.device.type == "cpu":
        return ref.paged_attention(q, k_pool, v_pool, tables, lengths,
                                   window=window)
    raise ValueError(f"paged attention runs on cuda or cpu, not {q.device}")


def paged_decode_append(q, k_new, v_new, k_pool, v_pool, tables, lengths, *,
                        append_mask=None, window: int | None = None):
    """Fused decode step: append the new KV entry in place, attend over it.

    Writes ``k_new[b]``/``v_new[b]`` at position ``lengths[b]`` of slot
    ``b``'s page chain (``append_mask`` False leaves the pool bitwise
    untouched: the lane rides the batch idle and its output is ignored),
    then attends over ``lengths[b] + 1`` positions through
    :func:`paged_attention`. Returns ``(o, k_pool, v_pool)``, the pools
    being the tensors that were passed in.
    """
    ref.append_to_tail_pages(k_new, v_new, k_pool, v_pool, tables, lengths,
                             append_mask)
    o = paged_attention(q, k_pool, v_pool, tables, lengths + 1, window=window)
    return o, k_pool, v_pool


SPEC = AcceleratorSpec(
    name="paged_attention_cuda",
    op="paged_attention",
    impl="cuda",
    fn=paged_attention,
    slave_ports=(
        PortSpec("paged_config", Axes(), direction="slave", dtype="int32"),
    ),
    master_ports=(
        PortSpec("q", Axes(lx.DECODE_BATCH, lx.HEADS, lx.HEAD_DIM)),
        PortSpec("k_pool", Axes(None, lx.CACHE_SEQ, lx.KV_HEADS, lx.HEAD_DIM)),
        PortSpec("v_pool", Axes(None, lx.CACHE_SEQ, lx.KV_HEADS, lx.HEAD_DIM)),
        PortSpec("block_table", Axes(lx.DECODE_BATCH, None), dtype="int32"),
        PortSpec("o", Axes(lx.DECODE_BATCH, lx.HEADS, lx.HEAD_DIM)),
    ),
    power_domain=PowerDomain("acc_paged_attention", leak_uw=10.0,
                             active_dyn_uw_mhz=42.0),
    description=("Paged decode attention: split-KV, one block per (split of "
                 "64 positions, KV head, slot), the pages read through the "
                 "block table, online softmax, the splits merged in order in "
                 "the same launch"),
)
register(SPEC, allow_override=True)
