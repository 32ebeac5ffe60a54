"""Dispatch for the paged decode attention op.

Port of ``src/repro/kernels/paged_attention/ops.py``. The op runs where its
tensors are: a CUDA query launches the hand-written Hopper kernel
(:func:`repro_torch.kernels.paged_attention.kernel.paged_attention_cuda`),
a CPU query takes the plain PyTorch version (``ref.py``), and any other
device raises. There is no fallback from the kernel to the plain version:
a kernel that does not build or launch raises.

The KV append is plain PyTorch indexing on either device (the JAX package
computes it as an XLA scatter outside its Pallas kernel too) and writes the
pool **in place**. XAIF registration of the kernel waits for the platform
slice of the port.
"""

from __future__ import annotations

from repro_torch.kernels.paged_attention import kernel, ref


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
