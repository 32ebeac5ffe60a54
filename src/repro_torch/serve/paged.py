"""Global KV page pool + paged decode steps for the serving engine.

Port of ``src/repro/serve/paged.py`` (single device, greedy). One pool of
fixed-size KV pages is shared by every decode slot and by the prefix page
table, reached per step through per-slot *block tables*. The allocator
(free list, refcounts, per-tenant accounting, the null page) is host state;
the device storage lives in per-cache-signature *arenas* created lazily by
:meth:`PagePool.arena` as torch tensors on the engine's device.

Invariants (as in the reference):

* **Pool refcounts never go negative.** Every page id handed out by
  :meth:`PagePool.alloc` / pinned by :meth:`PagePool.retain` is released
  exactly once; over-release raises.
* **A referenced page is never recycled.** A page returns to the free list
  only when its last holder releases it.
* **The null page is write-never and release-never.** Row ``null`` pads
  unused block-table entries; attention never reads a position there that
  it uses, and the allocator refuses to ``retain``/``release`` it.

The step functions are plain functions. They write the arena **in place**
(the reference donates its buffers and gets new ones back) and return the
next token of every lane, greedy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.serve.sampling import greedy

__all__ = ["PagePool", "PoolArena", "pool_signature", "paged_step_fn",
           "paged_chunk_fn"]


def pool_signature(cfg: ModelConfig) -> tuple:
    """Cache-shape signature of a config: configs with equal signatures can
    share one device arena (their KV pages are layout-compatible)."""
    return (cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim)


@dataclasses.dataclass
class PoolArena:
    """Device storage for one cache signature: a (k, v) pair shaped
    ``(L, n_pages + 1, page_size, Kh, Dh)``; the extra row is the null
    page. Engines write ``k``/``v`` in place every step."""

    k: torch.Tensor
    v: torch.Tensor


class PagePool:
    """Fixed-size KV page pool: free list, per-page refcounts, per-tenant
    accounting, and lazily created per-signature device arenas.

    ``alloc()`` hands out a page id with one reference; ``retain`` /
    ``release`` follow the shared-bank discipline. :meth:`arena` gives the
    (k, v) tensors for a config's cache signature on a device; every arena
    spans the whole id space.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError("pool needs at least one page of one token")
        self.page_size = page_size
        self.n_pages = n_pages
        self.null = n_pages                    # sentinel row, never written
        self._arenas: dict[tuple, PoolArena] = {}
        self._refs = np.zeros((n_pages,), np.int32)
        self._free = list(range(n_pages - 1, -1, -1))   # pop() -> 0, 1, 2, ...
        self._owner: dict[int, str | None] = {}
        self._by_owner: dict[str | None, int] = {}
        self.stats = {"allocated": 0, "freed": 0, "high_water": 0}

    def arena(self, cfg: ModelConfig, device: torch.device) -> PoolArena:
        """Device arena for ``cfg``'s cache signature on ``device``, created
        on first use; same-signature configs get the same arena object."""
        device = device_mod.resolve(device)
        sig = (pool_signature(cfg), device)
        if sig not in self._arenas:
            k, v = registry.paged_pool_init(cfg, self.n_pages + 1,
                                            self.page_size, device=device)
            self._arenas[sig] = PoolArena(k, v)
        return self._arenas[sig]

    def _check(self, idx: int) -> None:
        if not 0 <= idx < self.n_pages:
            raise ValueError(
                f"page id {idx} out of range (the null sentinel "
                f"{self.null} is not a refcounted page)")

    def alloc(self, owner: str | None = None) -> int:
        """Take a free page (one reference held by the caller), tagged with
        ``owner`` for per-tenant accounting until it is recycled."""
        if not self._free:
            raise RuntimeError(
                f"page pool exhausted ({self.n_pages} pages, all referenced)")
        idx = self._free.pop()
        self._refs[idx] = 1
        self._owner[idx] = owner
        self._by_owner[owner] = self._by_owner.get(owner, 0) + 1
        self.stats["allocated"] += 1
        self.stats["high_water"] = max(self.stats["high_water"], self.in_use)
        return idx

    def retain(self, idx: int) -> None:
        """Add a reference to a live page (block-table pin or residency)."""
        self._check(idx)
        if self._refs[idx] <= 0:
            raise ValueError(f"page {idx} retained while free")
        self._refs[idx] += 1

    def release(self, idx: int) -> None:
        """Drop one reference; the last release recycles the page."""
        self._check(idx)
        if self._refs[idx] <= 0:
            raise ValueError(f"page {idx} released more than retained")
        self._refs[idx] -= 1
        if self._refs[idx] == 0:
            self._free.append(idx)
            owner = self._owner.pop(idx, None)
            self._by_owner[owner] = self._by_owner.get(owner, 1) - 1
            if not self._by_owner[owner]:
                del self._by_owner[owner]
            self.stats["freed"] += 1

    @property
    def in_use(self) -> int:
        """Pages currently referenced (allocated and not yet recycled)."""
        return self.n_pages - len(self._free)

    @property
    def free_count(self) -> int:
        """Pages available for allocation."""
        return len(self._free)

    def in_use_by(self, owner: str | None) -> int:
        """Live pages carrying ``owner``'s tag (alloc-origin accounting: a
        page stays charged to the tenant that allocated it until its final
        release)."""
        return self._by_owner.get(owner, 0)


def _to(x, dev: torch.device) -> torch.Tensor:
    # host-chosen inputs (numpy or CPU tensors) go to the device without
    # waiting for it
    return torch.as_tensor(x).to(dev, non_blocking=True)


def paged_step_fn(cfg: ModelConfig, window: int | None = None):
    """Single-token paged decode over every lane, greedy.

    Signature: ``(params, pool_k, pool_v, tables, lengths, toks, mask) ->
    next_tokens`` (B,) int32 on the pool's device. ``tables`` (B, NP),
    ``lengths`` (B,), ``toks`` (B,) and ``mask`` (B,) bool are host arrays;
    ``mask`` gates the KV append (False: an idle lane riding the batch).
    The pools are written in place. ``window`` reads the block tables as
    rings (sliding-window configs).
    """
    def step(params, pool_k, pool_v, tables, lengths, toks, mask):
        dev = pool_k.device
        logits, _, _ = registry.decode_step_paged(
            params, cfg, pool_k, pool_v, _to(tables, dev), _to(lengths, dev),
            _to(toks, dev), append_mask=torch.as_tensor(mask), window=window)
        return greedy(logits)

    return step


def paged_chunk_fn(cfg: ModelConfig, chunk: int, window: int | None = None):
    """Chunked step: up to ``chunk`` tokens per lane in one launch, greedy.

    Signature: ``(params, pool_k, pool_v, tables, lengths, toks, counts) ->
    next_tokens`` with host arrays ``toks`` (B, chunk) and ``counts`` (B,).
    Runs masked one-token steps: at step ``j`` lane ``b`` appends
    ``toks[b, j]`` at ``lengths[b] + j`` if ``j < counts[b]``, and a masked
    lane leaves the pool bitwise untouched. The returned token of each lane
    is the greedy token after its last fed token (``counts[b] - 1``). Steps
    past every lane's count would be masked for all lanes and change
    nothing, so the loop stops at ``max(counts)``.
    """
    def step(params, pool_k, pool_v, tables, lengths, toks, counts):
        dev = pool_k.device
        counts = np.asarray(counts)
        n = int(counts.max())
        if n > chunk:
            raise ValueError(f"counts exceed the chunk of {chunk}")
        tables, lengths = _to(tables, dev), _to(lengths, dev)
        toks = _to(toks, dev)
        outs = []
        for j in range(n):
            logits, _, _ = registry.decode_step_paged(
                params, cfg, pool_k, pool_v, tables, lengths + j, toks[:, j],
                append_mask=torch.from_numpy(j < counts), window=window)
            outs.append(greedy(logits))
        last = _to(np.maximum(counts - 1, 0), dev).long()
        return torch.stack(outs, 1).gather(1, last[:, None])[:, 0]

    return step
