"""Plain PyTorch version of the paged decode attention kernel.

Port of ``src/repro/kernels/paged_attention/ref.py``. Each slot ``b`` holds
one single-token query and a *block table*, a row of page ids into a global
KV page pool. The op gathers the slot's positions, masks those at or beyond
``lengths[b]``, and computes grouped-query attention (head ``h`` reads KV
head ``h // (H // K)``). Two table layouts:

* **Contiguous** (``window=None``): page ``j`` of the table covers
  positions ``[j*ps, (j+1)*ps)``.
* **Ring** (``window=W``): entry ``e`` holds the page of the newest block
  ``≡ e (mod NP)``; the gather rebuilds a ``W``-position ring buffer where
  position ``p`` sits at index ``p % W`` and attends over
  ``min(lengths[b], W)`` of them.

This is the version the CPU runs and the yardstick the CUDA kernel
(``kernel.py``) is held to on the card. Unlike the JAX package, the pool is
written **in place**: :func:`append_to_tail_pages` mutates ``k_pool`` /
``v_pool`` and returns the same tensors.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention(q, k_pool, v_pool, tables, lengths, *,
                    window: int | None = None) -> torch.Tensor:
    """Single-query paged attention, plain PyTorch.

    q: (B, H, D) post-rope queries. k_pool/v_pool: (P, ps, K, D), one
    layer of the pool. tables: (B, NP) int page ids; entries a slot does
    not use must point at pages whose positions are masked. lengths: (B,)
    valid positions per slot. ``window`` reads the table as a ring and
    attends over the last ``window`` positions. Scores are scaled by
    ``1/sqrt(D)``. Returns (B, H, D) in ``q.dtype``; softmax and
    accumulation run in float32.
    """
    b, h, d = q.shape
    _, ps, kh, _ = k_pool.shape
    n_entries = tables.shape[1]
    tables = tables.long()
    lengths = lengths.long()
    if window is not None:
        # ring buffer index i holds the newest position p < len with
        # p ≡ i (mod window); indices at or past min(len, window) are masked
        i = torch.arange(window, device=q.device)
        lb = lengths[:, None]
        p = i + torch.div(lb - 1 - i, window, rounding_mode="floor") * window
        p = p.clamp_min(0)
        entry = torch.div(p, ps, rounding_mode="floor") % n_entries
        page = torch.gather(tables, 1, entry)
        kg, vg = k_pool[page, p % ps], v_pool[page, p % ps]   # (B, W, K, D)
        valid = i[None, :] < torch.minimum(lb, torch.full_like(lb, window))
    else:
        kg = k_pool[tables].reshape(b, n_entries * ps, kh, d)
        vg = v_pool[tables].reshape(b, n_entries * ps, kh, d)
        kpos = torch.arange(n_entries * ps, device=q.device)
        valid = kpos[None, :] < lengths[:, None]
    qf = q.to(torch.float32).reshape(b, kh, h // kh, d)
    s = torch.einsum("bkgd,bckd->bkgc", qf, kg.to(torch.float32)) / math.sqrt(d)
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(NEG_INF, dtype=torch.float32, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckd->bkgd", p, vg.to(torch.float32))
    return o.reshape(b, h, d).to(q.dtype)


def tail_rows(tables, lengths, page_size: int, append_mask=None):
    """Where each appending slot's new KV entry lands: ``(lanes, pages,
    offsets)``, the page ``tables[b, (lengths[b] // ps) % NP]`` and row
    ``lengths[b] % ps``. The ``% NP`` serves contiguous tables and ring
    tables (whose tail entry wraps) alike.

    Lanes whose ``append_mask`` is False are left out of the index, so a
    write through these rows leaves their pages bitwise untouched. Pass a
    CPU mask: selecting lanes from a CUDA mask would wait for the device.
    """
    dev = tables.device
    if append_mask is None:
        lanes = torch.arange(tables.shape[0], device=dev)
    else:
        lanes = torch.nonzero(append_mask.cpu(), as_tuple=True)[0].to(
            dev, non_blocking=True)
    lengths = lengths.to(dev).long()[lanes]
    entry = torch.div(lengths, page_size, rounding_mode="floor") % tables.shape[1]
    pages = tables[lanes, entry].long()
    return lanes, pages, lengths % page_size


def write_rows(k_new, v_new, k_pool, v_pool, rows) -> None:
    """Write ``k_new[lane]``/``v_new[lane]`` at ``rows`` (from
    :func:`tail_rows`) into the pools, in place, cast to the pool dtype."""
    lanes, pages, offs = rows
    k_pool[pages, offs] = k_new[lanes].to(k_pool.dtype)
    v_pool[pages, offs] = v_new[lanes].to(v_pool.dtype)


def append_to_tail_pages(k_new, v_new, k_pool, v_pool, tables, lengths,
                         append_mask=None):
    """Write each slot's new KV entry into its tail page, in place.

    The entry lands at page ``tables[b, (lengths[b] // ps) % NP]``, row
    ``lengths[b] % ps``. Lanes with ``append_mask`` False write nothing
    (the pool stays bitwise untouched). Returns ``(k_pool, v_pool)``, the
    same tensors that were passed in.
    """
    rows = tail_rows(tables, lengths, k_pool.shape[1], append_mask)
    write_rows(k_new, v_new, k_pool, v_pool, rows)
    return k_pool, v_pool


def paged_decode_append(q, k_new, v_new, k_pool, v_pool, tables, lengths, *,
                        append_mask=None, window: int | None = None):
    """Plain version of the fused decode step: append, then attend.

    Writes ``k_new[b]``/``v_new[b]`` at position ``lengths[b]`` of slot
    ``b`` (in place), then attends over ``lengths[b] + 1`` positions (the
    last ``window`` of them when windowed). Masked lanes append nothing and
    their output is garbage that must be ignored. Returns ``(o, k_pool,
    v_pool)`` with the pools the same tensors that were passed in.
    """
    append_to_tail_pages(k_new, v_new, k_pool, v_pool, tables, lengths,
                         append_mask)
    o = paged_attention(q, k_pool, v_pool, tables, lengths + 1, window=window)
    return o, k_pool, v_pool
