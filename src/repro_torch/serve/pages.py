"""Paged prefix cache: refcounted KV pages shared across requests.

A copy of ``src/repro/serve/pages.py`` (the reference is free of JAX; the
port keeps its own copy). The port's engine passes its platform, so
resident pages keep their banks awake as in the reference; the cluster and
the claim registry are used by later slices of the port.

This module is the host-side page table, the serving rendition of the
paper's refcounted memory banks. A *page* is the model state after
consuming a fixed-size extent of ``page_size`` prompt tokens: pages chain
(page *k* of a prompt extends page *k-1*), and a request whose prompt
starts with an already-resident chain is admitted with those tokens
pre-consumed — no prefill work for the shared prefix.

Every page additionally lives in a **namespace** (``ns``): the
model-identity component of the prefix key. One table can serve several
engines on one ``ServeCluster`` (not yet ported) — engines
serving the *same* model (same config and weights) share a namespace and
alias each other's prefixes, while engines serving different models keep
identical token prefixes isolated (the same token ids produce different
KV states under different weights, so cross-namespace aliasing would be
silently wrong). The default ``ns=""`` keeps the single-engine API
unchanged. Capacity and LRU eviction are global across namespaces — the
table is one shared residency budget, arbitrated like the paper's memory
pool.

Page *payloads* are opaque to the table. Under the engine's paged backend
a payload is a pool page id (:class:`repro_torch.serve.paged.PagePool`) —
adoption is block-table pointing and publication a refcount bump; under
the lane backend it is a full batch-1 cache snapshot, copied into the
slot's lane on first write (the copy-on-write bullet below). Mid-flight
re-match (:meth:`PageTable.acquire_range`) lets a slot that is already
prefilling adopt a sibling's freshly published pages, and ``on_evict``
hands dropped payloads back to their owner (the pool's free list).

Sharing follows the ``Platform.bank_acquire``/``bank_release`` discipline:

* **Refcounts never go negative.** ``acquire`` pins every page of the
  matched chain; ``release`` unpins; releasing more than was acquired
  raises (exactly like over-releasing a bank).
* **A referenced page is never freed.** LRU eviction only considers pages
  with zero refs *and* no resident children — pinning a leaf transitively
  protects its ancestors through the child links.
* **Copy-on-write.** ``acquire`` hands out the shared snapshot without
  copying; the engine materialises a private lane copy only when the slot
  first writes a divergent token (its first step), and reports that event
  back through :meth:`PageTable.note_cow`. A request evicted before its
  first step never pays for the copy.
* **Eviction disowns before it calls back.** Dropping a page runs in a
  fixed order: the page leaves the table (and its parent's child count),
  its bank reference is released, and only *then* does ``on_evict`` fire
  with the payload. By the time the callback runs, the table holds no
  reference of any kind to the page — so a shared pool's ``release`` in
  the callback is the payload's final reference drop and can never race a
  transient table-held refcount, even under cross-tenant eviction.
* **Power-aware residency.** With a platform attached, each resident page
  holds one refcounted bank acquisition (round-robin over the platform's
  banks), so banks retaining shared pages stay awake and eviction of the
  last page on a bank lets it clock-gate again.

Invariants (checked by ``tests/test_pages.py``): refcounts never negative,
eviction never frees a referenced page or a page with resident children,
``acquire`` always leaves at least one prompt token to feed (the final
token must run through the model to produce the first output logits), and
reuse never changes emitted tokens — greedy decode from a correct prefix
state is bit-identical to re-running the prefill.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

__all__ = ["Page", "PrefixMatch", "PageTable"]


@dataclasses.dataclass
class Page:
    """One resident page: the state after consuming ``key`` tokens.

    ``key`` is the full consumed-token prefix (length a multiple of the
    table's ``page_size``; the page's own extent is its last ``page_size``
    tokens) and ``ns`` the namespace (model identity) the page belongs to.
    ``snapshot`` is an opaque batch-1 cache pytree owned by the table until
    eviction.
    """

    key: tuple
    snapshot: Any
    ns: str = ""
    refs: int = 0          # live slot pins (acquire/release)
    children: int = 0      # resident pages extending this chain
    bank: str | None = None
    last_used: int = 0     # LRU tick


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Result of :meth:`PageTable.acquire`: a pinned chain of pages."""

    tokens_matched: int          # prompt tokens covered by the chain
    snapshot: Any                # payload of the chain's last page
    keys: tuple                  # chain keys, shortest first (release handle)
    chain: tuple = ()            # per-page payloads, shortest-key first


class PageTable:
    """Host-side table of shared prefix pages with bank-style refcounts.

    ``capacity_pages`` bounds residency *across all namespaces*;
    ``platform`` (optional) wires page residency into the platform's shared
    bank refcounts so resident pages keep their memory bank awake. One
    (namespace, model config, ``max_len``) triple keys a compatible payload
    family — the ``ns`` keyword on every lookup/publish isolates models
    that must not alias each other's state.
    """

    def __init__(self, page_size: int, *, capacity_pages: int | None = None,
                 platform=None, on_evict=None):
        if page_size < 1:
            raise ValueError("page_size must be >= 1 token")
        if capacity_pages is not None and capacity_pages < 1:
            raise ValueError("capacity_pages must be >= 1")
        self.page_size = page_size
        self.capacity_pages = capacity_pages
        self.platform = platform
        # called with the dropped page's payload on every eviction — the
        # paged engine uses it to return pool page ids to the free list
        # (payloads are opaque to the table: device snapshots in lane mode,
        # pool indices in paged mode). Fires only after the table has fully
        # disowned the page — see "Eviction disowns before it calls back"
        # in the module docstring.
        self.on_evict = on_evict
        self._pages: dict[tuple[str, tuple], Page] = {}
        # cold-prefill dedup claims: (ns, key) -> opaque owner token.
        # Table-level (not engine-local) so that two engines sharing the
        # table — replicas of one model in one namespace — dedup identical
        # concurrent cold prefills across engines: the later slot stalls
        # on the earlier engine's claim and adopts the published page.
        self._claims: dict[tuple[str, tuple], Any] = {}
        # fault-injection hook (chaos harness): called with the namespace
        # at the top of every acquire; returning True suppresses the
        # match (a spurious cold prefill). Sharing is an optimisation
        # only, so a dropped match degrades throughput, never tokens.
        self.fault_hook = None
        self._tick = 0
        self._next_bank = 0
        self.stats = {
            "hits": 0,             # acquisitions that matched a chain
            "misses": 0,           # acquisitions with no usable chain
            "tokens_reused": 0,    # prompt tokens skipped via sharing
            "published": 0,        # pages added
            "evicted": 0,          # pages LRU-evicted
            "cow_copies": 0,       # private lane copies materialised
            "rematches": 0,        # mid-flight prefix adoptions
            "rematched_pages": 0,  # pages pinned via acquire_range (the
                                   # engine counts token-granular adoption
                                   # in its own rematched_tokens)
        }

    # -- lookup / pinning ----------------------------------------------------

    def _chain_keys(self, prompt: Sequence[int], ns: str) -> list[tuple]:
        """Resident chain keys covering a prefix of ``prompt`` in ``ns``,
        shortest first. Caps at ``len(prompt) - 1``: the final prompt token
        is always fed through the model (its logits seed generation)."""
        prompt = tuple(int(t) for t in prompt)
        ps = self.page_size
        keys = []
        for k in range(1, (len(prompt) - 1) // ps + 1):
            key = prompt[:k * ps]
            if (ns, key) not in self._pages:
                break
            keys.append(key)
        return keys

    def lookup(self, prompt: Sequence[int], ns: str = "") -> int:
        """Prompt tokens a matching resident chain covers (0 = no match).
        Pure query: no refcounts, no stats."""
        keys = self._chain_keys(prompt, ns)
        return len(keys[-1]) if keys else 0

    def acquire(self, prompt: Sequence[int], ns: str = "") -> PrefixMatch | None:
        """Pin the longest resident chain matching ``prompt``'s prefix in
        namespace ``ns``.

        Every page of the chain is individually refcounted; the caller must
        hand the returned ``keys`` back to :meth:`release` exactly once
        (on completion, eviction, or preemption). With a ``fault_hook``
        installed (chaos harness) a hook hit turns this acquire into a
        miss — the caller cold-prefills as if nothing were resident."""
        if self.fault_hook is not None and self.fault_hook(ns):
            self.stats["misses"] += 1
            return None
        keys = self._chain_keys(prompt, ns)
        if not keys:
            self.stats["misses"] += 1
            return None
        self._tick += 1
        for key in keys:
            page = self._pages[(ns, key)]
            page.refs += 1
            page.last_used = self._tick
        matched = len(keys[-1])
        self.stats["hits"] += 1
        self.stats["tokens_reused"] += matched
        return PrefixMatch(tokens_matched=matched,
                           snapshot=self._pages[(ns, keys[-1])].snapshot,
                           keys=tuple(keys),
                           chain=tuple(self._pages[(ns, k)].snapshot
                                       for k in keys))

    def acquire_range(self, prompt: Sequence[int], from_block: int,
                      to_block: int, ns: str = "") -> list[tuple[tuple, Any]]:
        """Pin resident pages covering blocks ``[from_block, to_block)`` of
        ``prompt`` — the mid-flight re-match: a slot that already consumed
        ``from_block`` pages' worth of tokens adopts a sibling's freshly
        published pages instead of recomputing them. Returns
        ``[(key, payload), ...]`` shortest-key first; every returned page is
        individually pinned and must go back through :meth:`release` (the
        caller appends the keys to its release handle)."""
        prompt = tuple(int(t) for t in prompt)
        ps = self.page_size
        out = []
        self._tick += 1
        for b in range(from_block, to_block):
            key = prompt[:(b + 1) * ps]
            page = self._pages.get((ns, key))
            if page is None:
                break                      # chain must stay contiguous
            page.refs += 1
            page.last_used = self._tick
            out.append((key, page.snapshot))
        if out:
            # page-granular accounting; tokens_reused stays admission-only
            self.stats["rematches"] += 1
            self.stats["rematched_pages"] += len(out)
        return out

    def release(self, keys: Sequence[tuple], ns: str = "") -> None:
        """Unpin a chain previously returned by :meth:`acquire`.

        Mirrors ``Platform.bank_release``: releasing a page more times than
        it was acquired raises instead of driving the refcount negative.
        Atomic: every key is checked, a key repeated in ``keys`` needing as
        many refs, before any refcount moves, so an over-release leaves the
        other pins' refs as they were."""
        need: dict[tuple, int] = {}
        for key in keys:
            loc = (ns, tuple(key))
            need[loc] = need.get(loc, 0) + 1
            page = self._pages.get(loc)
            if page is None or page.refs < need[loc]:
                raise ValueError(
                    f"page {key!r} (ns={ns!r}) released more than acquired")
        for loc, n in need.items():
            self._pages[loc].refs -= n

    # -- cold-prefill dedup claims -------------------------------------------

    def claim(self, key: Sequence[int], owner: Any, ns: str = "") -> None:
        """Register ``owner`` as the party currently computing page
        ``key`` in ``ns``. Owners are opaque to the table (the engine
        passes an ``(engine, slot)`` pair); claims are advisory dedup
        state, not residency — they hold no refcounts and survive no
        publication (:meth:`unclaim` or a fresh :meth:`claim` replaces
        them). Table-level so claims are visible across every engine
        sharing the table."""
        self._claims[(ns, tuple(key))] = owner

    def claimant(self, key: Sequence[int], ns: str = "") -> Any:
        """The current claim owner for page ``key`` in ``ns`` (None when
        unclaimed). Pure query; staleness is the caller's judgement —
        the table cannot tell a live claimant from a dead one."""
        return self._claims.get((ns, tuple(key)))

    def unclaim(self, key: Sequence[int], ns: str = "") -> None:
        """Drop the claim on page ``key`` in ``ns`` (no-op when
        unclaimed) — fired when the page publishes (claim moot), when the
        claimant abandons the prefill, or when a waiter steals a stale
        claim."""
        self._claims.pop((ns, tuple(key)), None)

    def note_cow(self, n_pages: int) -> None:
        """Record that a slot materialised its private copy of ``n_pages``
        shared pages (the copy-on-write event, fired at first divergent
        token)."""
        self.stats["cow_copies"] += int(n_pages)

    # -- publication / eviction ----------------------------------------------

    def wants(self, key: Sequence[int], ns: str = "") -> bool:
        """True if :meth:`publish` would accept ``key`` in ``ns`` — lets
        the engine skip the device gather when the page is already
        resident."""
        key = tuple(int(t) for t in key)
        if not key or len(key) % self.page_size != 0:
            return False
        if (ns, key) in self._pages:
            return False
        return (len(key) == self.page_size
                or (ns, key[:-self.page_size]) in self._pages)

    def publish(self, key: Sequence[int], snapshot: Any,
                ns: str = "") -> bool:
        """Add the page completing chain ``key`` in namespace ``ns`` (state
        after consuming all of ``key``). Returns False when the page is
        already resident or its parent chain is gone (nothing to graft
        onto)."""
        key = tuple(int(t) for t in key)
        if not key or len(key) % self.page_size != 0:
            raise ValueError(
                f"page key length {len(key)} is not a positive multiple of "
                f"page_size={self.page_size}")
        self._tick += 1
        if (ns, key) in self._pages:
            self._pages[(ns, key)].last_used = self._tick
            return False
        parent = None
        if len(key) > self.page_size:
            parent = self._pages.get((ns, key[:-self.page_size]))
            if parent is None:
                return False         # orphan extent: chain must be contiguous
        self._make_room(protect=parent)
        page = Page(key=key, snapshot=snapshot, ns=ns,
                    last_used=self._tick, bank=self._assign_bank())
        self._pages[(ns, key)] = page
        if parent is not None:
            parent.children += 1
        self.stats["published"] += 1
        return True

    def _assign_bank(self) -> str | None:
        if self.platform is None:
            return None
        n = self.platform.config.n_banks
        bank = f"bank{self._next_bank % n}"
        self._next_bank += 1
        self.platform.bank_acquire(bank)   # resident page keeps its bank awake
        return bank

    def _make_room(self, protect: Page | None = None) -> None:
        """Evict down below capacity before an insert. Only unpinned leaves
        are candidates (refs > 0 is a live slot pin, children > 0 means a
        resident page still needs this state, and the incoming page's
        parent must survive to keep the chain contiguous). When everything
        is pinned the table overflows instead of freeing a referenced page.
        """
        if self.capacity_pages is None:
            return
        while len(self._pages) >= self.capacity_pages:
            candidates = [p for p in self._pages.values()
                          if p.refs == 0 and p.children == 0
                          and p is not protect]
            if not candidates:
                return
            self._drop(min(candidates, key=lambda p: p.last_used))
            self.stats["evicted"] += 1

    def evict_lru(self, n: int = 1, ns: str | None = None) -> int:
        """Evict up to ``n`` unpinned, childless pages in LRU order —
        restricted to namespace ``ns`` when given (``None`` = any). Returns
        the number actually evicted. This is the cluster's fair-reclaim
        primitive: a scheduler targets the tenant holding the most idle
        residency instead of wiping every namespace at once."""
        evicted = 0
        while evicted < n:
            # one scan per batch, not per page; the rescan only matters for
            # parents that became childless leaves inside the batch
            candidates = sorted(
                (p for p in self._pages.values()
                 if p.refs == 0 and p.children == 0
                 and (ns is None or p.ns == ns)),
                key=lambda p: p.last_used)
            if not candidates:
                break
            for page in candidates[:n - evicted]:
                self._drop(page)
                self.stats["evicted"] += 1
                evicted += 1
        return evicted

    def _drop(self, page: Page) -> None:
        # ordering contract (see module docstring): (1) the page leaves the
        # table and its parent's child count, (2) the bank reference is
        # released, (3) on_evict fires last, once the table holds nothing
        del self._pages[(page.ns, page.key)]
        if len(page.key) > self.page_size:
            self._pages[(page.ns, page.key[:-self.page_size])].children -= 1
        if page.bank is not None:
            self.platform.bank_release(page.bank)
        if self.on_evict is not None:
            self.on_evict(page.snapshot)

    def clear(self) -> None:
        """Drop every unpinned page in every namespace (pinned chains
        survive)."""
        for page in sorted(self._pages.values(),
                           key=lambda p: -len(p.key)):   # leaves first
            if page.refs == 0 and page.children == 0:
                self._drop(page)
                self.stats["evicted"] += 1

    # -- introspection --------------------------------------------------------

    @property
    def resident(self) -> int:
        """Number of resident pages (all namespaces)."""
        return len(self._pages)

    @property
    def pinned(self) -> int:
        """Number of pages with a live slot pin (all namespaces)."""
        return sum(p.refs > 0 for p in self._pages.values())

    def resident_by_ns(self) -> dict[str, int]:
        """Namespace -> resident page count (tenant residency footprint)."""
        out: dict[str, int] = {}
        for page in self._pages.values():
            out[page.ns] = out.get(page.ns, 0) + 1
        return out

    def unpinned_by_ns(self) -> dict[str, int]:
        """Namespace -> evictable page count (unpinned, childless) — what
        fair reclaim arbitrates over."""
        out: dict[str, int] = {}
        for page in self._pages.values():
            if page.refs == 0 and page.children == 0:
                out[page.ns] = out.get(page.ns, 0) + 1
        return out

    def refcounts(self, ns: str | None = "") -> dict:
        """Per-page refcounts (for tests and the journal): token-prefix key
        -> refs within namespace ``ns``; pass ``ns=None`` for every
        namespace, keyed ``(ns, key)``."""
        if ns is None:
            return {k: p.refs for k, p in self._pages.items()}
        return {k: p.refs for (n, k), p in self._pages.items() if n == ns}

    def has(self, key, ns: str = "") -> bool:
        """True when chain ``key`` is resident in namespace ``ns``."""
        return (ns, tuple(key)) in self._pages

    def __contains__(self, key) -> bool:
        return self.has(key)

    def __len__(self) -> int:
        return len(self._pages)
