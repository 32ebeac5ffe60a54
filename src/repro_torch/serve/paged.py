"""Global KV page pool + paged decode steps for the serving engine.

Port of ``src/repro/serve/paged.py``. One pool of
fixed-size KV pages is shared by every decode slot and by the prefix page
table, reached per step through per-slot *block tables*. The allocator
(free list, refcounts, per-tenant accounting, the null page) is host state;
the device storage lives in per-cache-signature *arenas* created lazily by
:meth:`PagePool.arena` as torch tensors on the engine's device.

The pool is a *cluster-ownable* resource (:mod:`repro_torch.serve.cluster`):
it hands out **globally valid page ids** from one id space, and engines
serving configs of one cache signature on one device share one arena, so a
page published by one engine is readable by every other through the shared
ids. Engines of other signatures share only the id space and the budget.

Invariants (as in the reference):

* **Pool refcounts never go negative.** Every page id handed out by
  :meth:`PagePool.alloc` / pinned by :meth:`PagePool.retain` is released
  exactly once; over-release raises.
* **A referenced page is never recycled.** A page returns to the free list
  only when its last holder releases it.
* **The null page is write-never and release-never.** Row ``null`` pads
  unused block-table entries; attention never reads a position there that
  it uses, and the allocator refuses to ``retain``/``release`` it.
* **One id space, many arenas.** ``alloc`` draws from a single free list
  whichever arena the page's bytes land in, so the pool is one shared
  budget; per-tenant ``in_use_by`` accounting lets a scheduler arbitrate it.

The step functions are plain functions. They write the arena **in place**
(the reference donates its buffers and gets new ones back) and return the
next token of every lane, sampled under its request's parameters (exact
argmax at temperature 0), with the lanes' carried PRNG keys.

**Tensor parallelism** (the reference's ``mesh``/``tp_axis``): on a
:class:`~repro_torch.launch.mesh.Mesh` whose ``tp_axis`` holds ``tp``
positions, :func:`place_params` splits wq/wk/wv into contiguous per-shard
head slices and :meth:`PagePool.arena` gives every shard an arena of
``Kh/tp`` heads of every page; the step functions then run
:func:`repro_torch.models.transformer.decode_step_paged` on the shards in
mesh order and sample on the first shard's device. One process drives
every shard, as the reference's one process drives its mesh, and a mesh
may name one device more than once (``["cuda:0"] * 4``). Page ids, block
tables and the allocator do not depend on the mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.launch.mesh import Mesh
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.serve import sampling
from repro_torch.sharding import rules as R
from repro_torch.sharding.params import tree_map2

__all__ = ["PagePool", "PoolArena", "feed", "last_fed", "pool_signature",
           "paged_step_fn", "paged_chunk_fn", "to_device", "place_params",
           "mesh_tp", "shard_devices", "clear_placed"]

# params tree -> its placement on a mesh, keyed (id(params), mesh,
# tp_axis); the entry holds the tree itself, so a recycled id() never
# returns another model's placement
_PLACED_PARAMS: dict = {}


def mesh_tp(mesh: Mesh, tp_axis: str = "model") -> int:
    """Size of the tensor-parallel axis of ``mesh`` (loud on a bad axis)."""
    if tp_axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.axis_names} has no axis {tp_axis!r}")
    return mesh.shape[tp_axis]


def shard_devices(mesh: Mesh, tp_axis: str = "model") -> list[torch.device]:
    """The devices of the decode's shards, in mesh order: one a position
    of ``tp_axis``. The decode shards over that axis alone, so every other
    axis of the mesh must have size 1."""
    tp = mesh_tp(mesh, tp_axis)
    if mesh.devices.size != tp:
        raise ValueError(
            f"mesh {mesh.shape}: the paged decode shards over {tp_axis!r} "
            "alone, every other axis must have size 1")
    return list(mesh.devices.flat)


def place_params(cfg: ModelConfig, params, mesh: Mesh,
                 tp_axis: str = "model") -> list[dict]:
    """Lay a params tree out on ``mesh`` for the tensor-parallel paged
    decode: one tree a shard, in mesh order.

    :func:`repro_torch.sharding.rules.serve_param_specs` names the leaves
    that shard: wq/wk/wv, whose head axis each shard holds a contiguous
    slice of (a tensor of its own on its device). Every other leaf is
    replicated, placed once per distinct device and shared by the shards
    there (on the leaf's own device it is the leaf itself). ``params`` may
    live on any device. The placement is cached per (params, mesh, axis),
    so replicas of one checkpoint on one mesh share it; the cache holds
    ``params`` alive until :func:`clear_placed`. Raises the reference's
    ``ValueError`` for a config the head-sharded decode cannot serve.
    """
    devs = shard_devices(mesh, tp_axis)
    tp = len(devs)
    R.validate_serve_tp(cfg, tp)           # on every call: cfg is no key
    key = (id(params), mesh, tp_axis)
    hit = _PLACED_PARAMS.get(key)
    if hit is None or hit[0] is not params:
        specs = R.serve_param_specs(cfg, tp_axis)
        replicated: dict = {}

        def shard(i: int, dev: torch.device) -> dict:
            def leaf(p, spec):
                if tp_axis in spec:
                    axis = spec.index(tp_axis)
                    n = p.shape[axis] // tp
                    return p.narrow(axis, i * n, n).to(dev).contiguous()
                if (id(p), dev) not in replicated:
                    replicated[(id(p), dev)] = p.to(dev)
                return replicated[(id(p), dev)]
            return tree_map2(leaf, params, specs)

        hit = (params, [shard(i, d) for i, d in enumerate(devs)])
        _PLACED_PARAMS[key] = hit
    return hit[1]


def clear_placed() -> None:
    """Forget every cached placement (:func:`place_params`), letting the
    params trees and their shards go."""
    _PLACED_PARAMS.clear()


def pool_signature(cfg: ModelConfig) -> tuple:
    """Cache-shape signature of a config: configs with equal signatures can
    share one device arena (their KV pages are layout-compatible)."""
    return (cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim)


@dataclasses.dataclass
class PoolArena:
    """Device storage for one cache signature: a (k, v) pair shaped
    ``(L, n_pages + 1, page_size, Kh, Dh)``; the extra row is the null
    page. Engines write ``k``/``v`` in place every step. On a ``mesh``,
    ``k`` and ``v`` are lists of the shards' tensors in mesh order, each
    ``(L, n_pages + 1, page_size, Kh/tp, Dh)`` on its shard's device."""

    k: torch.Tensor | list[torch.Tensor]
    v: torch.Tensor | list[torch.Tensor]
    mesh: Mesh | None = None


class PagePool:
    """Fixed-size KV page pool: free list, per-page refcounts, per-tenant
    accounting, and lazily created per-signature device arenas.

    ``alloc()`` hands out a page id with one reference; ``retain`` /
    ``release`` follow the shared-bank discipline. :meth:`arena` gives the
    (k, v) tensors for a config's cache signature on a device; every arena
    spans the whole id space. ``fault_hook`` (fault injection, default
    None) is called with the owner tag at the top of every :meth:`alloc`
    and may raise (:class:`repro_torch.serve.chaos.AllocFault`), leaving
    the pool untouched.
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
        self.fault_hook = None

    def arena(self, cfg: ModelConfig, where, tp_axis: str = "model"
              ) -> PoolArena:
        """Device arena for ``cfg``'s cache signature on ``where`` (a
        device, or a :class:`~repro_torch.launch.mesh.Mesh`), created on
        first use; same-signature configs on the same device or mesh get
        the same arena object.

        On a mesh the arena's KV-head axis is split over ``tp_axis``
        (:func:`repro_torch.sharding.rules.serve_pool_spec`): each shard
        holds ``Kh/tp`` heads of every page, so ``tp`` shards hold the KV
        bytes of one. Arenas on different meshes are distinct storage,
        keyed ``(signature, mesh, tp_axis)``; meshes naming the same
        devices in the same layout are one mesh.
        """
        if isinstance(where, Mesh):
            sig = (pool_signature(cfg), where, tp_axis)
            if sig not in self._arenas:
                devs = shard_devices(where, tp_axis)
                R.validate_serve_tp(cfg, len(devs))
                pools = [registry.paged_pool_init(cfg, self.n_pages + 1,
                                                  self.page_size, device=d,
                                                  tp=len(devs))
                         for d in devs]
                self._arenas[sig] = PoolArena([k for k, _ in pools],
                                              [v for _, v in pools], where)
            return self._arenas[sig]
        device = device_mod.resolve(where)
        sig = (pool_signature(cfg), device)
        if sig not in self._arenas:
            k, v = registry.paged_pool_init(cfg, self.n_pages + 1,
                                            self.page_size, device=device)
            self._arenas[sig] = PoolArena(k, v)
        return self._arenas[sig]

    def bytes_by_device(self) -> dict[str, int]:
        """KV bytes resident per device, summed over every arena (k and v).
        A one-device arena counts under the device's name (``"cuda:0"``,
        ``"cpu"``); a mesh arena's shard under its device and mesh
        position (``"cuda:0#1"``: position 1), so the split shows when
        shards share a device. Arenas of two meshes add up under a key
        they share."""
        out: dict[str, int] = {}
        for arena in self._arenas.values():
            if arena.mesh is None:
                named = [(str(t.device), t) for t in (arena.k, arena.v)]
            else:
                named = [(f"{t.device}#{i}", t)
                         for pair in (arena.k, arena.v)
                         for i, t in enumerate(pair)]
            for key, t in named:
                out[key] = out.get(key, 0) + t.numel() * t.element_size()
        return out

    def _check(self, idx: int) -> None:
        if not 0 <= idx < self.n_pages:
            raise ValueError(
                f"page id {idx} out of range (the null sentinel "
                f"{self.null} is not a refcounted page)")

    def alloc(self, owner: str | None = None) -> int:
        """Take a free page (one reference held by the caller), tagged with
        ``owner`` for per-tenant accounting until it is recycled. A
        ``fault_hook`` runs first and may raise; the pool is then untouched,
        so the caller's allocation loop can be retried."""
        if self.fault_hook is not None:
            self.fault_hook(owner)
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

    @property
    def device_pages(self) -> int:
        """Device pages materialised: every arena carries the whole id space
        plus the null row, so ``arenas x (n_pages + 1)``."""
        return len(self._arenas) * (self.n_pages + 1)

    def refcounts(self) -> dict[int, int]:
        """Live page id -> reference count (the energy meter's page shares,
        tests)."""
        return {i: int(r) for i, r in enumerate(self._refs) if r > 0}

    def in_use_by(self, owner: str | None) -> int:
        """Live pages carrying ``owner``'s tag (alloc-origin accounting: a
        page stays charged to the tenant that allocated it until its final
        release)."""
        return self._by_owner.get(owner, 0)

    def owners(self) -> dict[str | None, int]:
        """Tenant tag -> live page count (alloc-origin, see
        :meth:`in_use_by`); the counts sum to :attr:`in_use`."""
        return dict(self._by_owner)


def to_device(x, dev: torch.device) -> torch.Tensor:
    """A host-chosen input (numpy or a CPU tensor) on ``dev``, copied
    without waiting for the device. On the card a copy from pageable memory
    has read its source when the call returns, so the caller may rewrite
    the array at once; on the CPU the result may share the array's memory
    and is read at once by the eager ops that take it."""
    return torch.as_tensor(x).to(dev, non_blocking=True)


def feed(toks, feedback, prev, dev: torch.device) -> torch.Tensor:
    """The tokens a launch feeds, on ``dev``: ``toks`` (host) where
    ``feedback`` (host, bool) is unset, else ``prev`` (the previous
    launch's on-device tokens: the async feedback path). ``prev`` may be
    None when no lane takes it."""
    fed = to_device(toks, dev)
    if feedback is not None and np.any(feedback):
        fed = torch.where(to_device(feedback, dev), prev.to(fed.dtype), fed)
    return fed


def last_fed(last, logits: torch.Tensor, j: int, counts,
             dev: torch.device) -> torch.Tensor:
    """Each lane's logits after its last fed token of a chunk, kept as the
    chunk's iterations run: iteration ``j``'s ``logits`` (B, V) for the
    lanes whose ``counts[b] - 1 == j``, ``last`` (None at ``j == 0``) for
    the others; iteration 0 gives every lane's first, as the reference's
    ``max(counts - 1, 0)`` takes for a lane fed nothing."""
    if last is None:
        return logits
    ends = np.asarray(counts) - 1 == j
    if not ends.any():
        return last
    return torch.where(to_device(ends, dev)[:, None], logits, last)


def _sampling_device(mesh: Mesh | None, tp_axis: str):
    """A step function's check of its pools against ``mesh``: returns a
    function of ``pool_k`` giving the device that samples (the first
    shard's)."""
    if mesh is None:
        def tail(pool_k):
            if isinstance(pool_k, (list, tuple)):
                raise ValueError("sharded pools need the step's mesh")
            return pool_k.device
        return tail
    devs = shard_devices(mesh, tp_axis)

    def tail(pool_k):
        if [t.device for t in pool_k] != devs:
            raise ValueError(f"pool shards on {[t.device for t in pool_k]}, "
                             f"the mesh is {devs}")
        return devs[0]
    return tail


def paged_step_fn(cfg: ModelConfig, window: int | None = None,
                  mesh: Mesh | None = None, tp_axis: str = "model"):
    """Single-token paged decode over every lane, sampled.

    Signature: ``(params, pool_k, pool_v, tables, lengths, toks, feedback,
    prev, mask, emit, keys, temp, top_k, top_p) -> (next_tokens, keys)``,
    the reference's (``src/repro/serve/paged.py:315-352``) less the pools
    in the result: they are written in place. ``tables`` (B, NP),
    ``lengths``, ``toks``, ``feedback``, ``mask``, ``emit``, ``temp``,
    ``top_k`` and ``top_p`` (B,) are host arrays; ``feedback`` selects the
    previous launch's on-device token ``prev`` instead of ``toks`` (async
    double-buffering; ``prev`` may be None without it); ``mask`` gates the
    KV append (False: an idle or stalled lane riding the batch). Each
    lane's token is drawn by :func:`~repro_torch.serve.sampling.draw` under
    its key of ``keys`` (B, 2) and its (``temp``, ``top_k``, ``top_p``):
    the exact argmax at temperature 0; its key splits once and the carried
    half is kept where ``emit`` is set. ``next_tokens`` (B,) int32 lives on
    the pool's device, ``keys`` where they came from. ``window`` reads the
    block tables as rings (sliding-window configs).

    With ``mesh`` the step is tensor-parallel over ``tp_axis``: ``params``
    is :func:`place_params`' list of shards and the pools the arena's
    lists; the tokens are fed and sampled on the first shard's device,
    from the logits the tail computes there, as the reference samples the
    replicated logits outside its sharded region.
    """
    tail = _sampling_device(mesh, tp_axis)

    def step(params, pool_k, pool_v, tables, lengths, toks, feedback, prev,
             mask, emit, keys, temp, top_k, top_p):
        dev = tail(pool_k)
        logits, _, _ = registry.decode_step_paged(
            params, cfg, pool_k, pool_v, to_device(tables, dev),
            to_device(lengths, dev), feed(toks, feedback, prev, dev),
            append_mask=torch.as_tensor(mask), window=window)
        return sampling.draw(logits, keys, emit, temp, top_k, top_p)

    return step


def paged_chunk_fn(cfg: ModelConfig, chunk: int, window: int | None = None,
                   mesh: Mesh | None = None, tp_axis: str = "model"):
    """Chunked step: up to ``chunk`` tokens per lane in one launch, sampled.

    Signature: ``(params, pool_k, pool_v, tables, lengths, toks, counts,
    feedback, prev, emit, keys, temp, top_k, top_p) -> (next_tokens,
    keys)`` with host arrays ``toks`` (B, chunk) and ``counts`` (B,); the
    rest as in :func:`paged_step_fn`, ``feedback`` applying to iteration 0.
    Runs masked one-token steps: at step ``j`` lane ``b`` appends
    ``toks[b, j]`` at ``lengths[b] + j`` if ``j < counts[b]``, and a masked
    lane leaves the pool bitwise untouched. Each lane's token is drawn
    after its last fed token (``counts[b] - 1``) with the launch's one
    split of its key, as every iteration of the reference's scan draws
    with it and keeps the last fed one's. Steps past every lane's count
    would be masked for all lanes and change nothing, so the loop stops at
    ``max(counts)``. ``mesh`` and ``tp_axis`` as in :func:`paged_step_fn`.
    """
    tail = _sampling_device(mesh, tp_axis)

    def step(params, pool_k, pool_v, tables, lengths, toks, counts, feedback,
             prev, emit, keys, temp, top_k, top_p):
        dev = tail(pool_k)
        counts = np.asarray(counts)
        n = int(counts.max())
        if n > chunk:
            raise ValueError(f"counts exceed the chunk of {chunk}")
        tables, lengths = to_device(tables, dev), to_device(lengths, dev)
        toks = to_device(toks, dev)
        first = feed(toks[:, 0], feedback, prev, dev)
        last = None
        for j in range(n):
            logits, _, _ = registry.decode_step_paged(
                params, cfg, pool_k, pool_v, tables, lengths + j,
                first if j == 0 else toks[:, j],
                append_mask=torch.from_numpy(j < counts), window=window)
            last = last_fed(last, logits, j, counts, dev)
        return sampling.draw(last, keys, emit, temp, top_k, top_p)

    return step
