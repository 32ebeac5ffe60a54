"""The port's ``PageTable.release`` is atomic: an over-release raises
before any refcount moves.

The reference's ``release`` (``src/repro/serve/pages.py``) walks a chain's
keys shortest first and decrements each one; on an over-release it raises
at the first key whose refcount is 0, after it has decremented the shorter
keys, whose refs belong to other pins. The port checks every key, counted
with multiplicity, first. Here the body of the reference's property test
``tests/test_pool_properties.py::
test_table_random_ops_preserve_chains_pins_and_namespaces`` runs against
the port's table at explicit seeds (4180, 37, 55 and 122 fail on a
release that is not atomic) and over a seeded range; two unit tests pin
the error path down.
"""

import random

import pytest

PageTable = None  # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port when these tests run, not when pytest collects this
    file, as every port test file does; the page table needs no torch, so
    this worker does not load it."""
    global PageTable
    from repro_torch.serve.pages import PageTable


_PS = 4          # small pages: chains cross page boundaries quickly
_NAMESPACES = ("modelA", "modelB")


def _prompt(chain: int, blocks: int) -> tuple:
    """The reference test's per-chain token sequence, ``blocks`` pages long;
    every namespace uses the same ids, so equal keys must isolate."""
    return tuple((31 * chain + j) % 97 + 1 for j in range(blocks * _PS))


def _check_table(table, pins: dict) -> None:
    """Structural invariants over every resident page (the reference
    test's)."""
    pages = table._pages
    for (ns, key), page in pages.items():
        assert page.refs >= 0
        assert len(key) % _PS == 0
        if len(key) > _PS:                 # chains stay parent-contiguous
            assert (ns, key[:-_PS]) in pages, (
                f"orphan page {key} in {ns}: parent evicted under it")
        kids = sum(1 for (n2, k2) in pages
                   if n2 == ns and len(k2) == len(key) + _PS
                   and k2[:len(key)] == key)
        assert page.children == kids
    held: dict[tuple, int] = {}
    for keys, ns in pins.values():
        for key in keys:
            held[(ns, key)] = held.get((ns, key), 0) + 1
    for loc, n in held.items():
        assert loc in pages and pages[loc].refs >= n
    assert table.resident == len(pages)
    assert table.stats["published"] == table.resident + table.stats["evicted"]


def _random_ops(seed: int) -> None:
    """The reference property test's body: random acquire / publish / adopt
    / claim / evict / release / clear traffic over two namespaces under a
    capacity bound, an over-release of a drained handle, then a full drain
    that must leave nothing resident and hand every payload back once."""
    rng = random.Random(seed)
    dropped: list = []
    table = PageTable(_PS, capacity_pages=rng.randint(6, 14),
                      on_evict=dropped.append)
    pins: dict[int, tuple[tuple, str]] = {}    # handle -> (keys, ns)
    next_pin = 0
    published = 0
    for _ in range(rng.randint(40, 150)):
        ns = rng.choice(_NAMESPACES)
        chain = rng.randint(0, 2)
        prompt = _prompt(chain, blocks=3)
        op = rng.random()
        if op < 0.35:
            key = prompt[:rng.randint(1, 3) * _PS]
            if table.publish(key, snapshot=(ns, key), ns=ns):
                published += 1
                assert table.has(key, ns)
            assert not table.wants(key, ns)
        elif op < 0.60:
            m = table.acquire(prompt + (99,), ns=ns)
            if m is not None:
                assert m.tokens_matched % _PS == 0
                assert m.keys[-1] == prompt[:m.tokens_matched]
                assert all(s == (ns, k) for k, s in zip(m.keys, m.chain))
                pins[next_pin] = (m.keys, ns)
                next_pin += 1
        elif op < 0.70:
            got = table.acquire_range(prompt, 0, rng.randint(1, 3), ns=ns)
            if got:
                pins[next_pin] = (tuple(k for k, _ in got), ns)
                next_pin += 1
        elif op < 0.80 and pins:
            keys, pns = pins.pop(rng.choice(list(pins)))
            table.release(keys, ns=pns)
        elif op < 0.88:
            table.claim(prompt[:_PS], owner=("eng", chain), ns=ns)
            assert table.claimant(prompt[:_PS], ns=ns) == ("eng", chain)
            table.unclaim(prompt[:_PS], ns=ns)
            assert table.claimant(prompt[:_PS], ns=ns) is None
        elif op < 0.96:
            before = table.resident
            n = table.evict_lru(rng.randint(1, 3),
                                ns=rng.choice((None,) + _NAMESPACES))
            assert table.resident == before - n
        else:
            table.clear()
        _check_table(table, pins)
    if pins:
        keys, pns = pins.pop(rng.choice(list(pins)))
        table.release(keys, ns=pns)
        pages = table._pages
        if any(pages[(pns, k)].refs == 0 for k in keys if (pns, k) in pages):
            with pytest.raises(ValueError):
                table.release(keys, ns=pns)
                table.release(keys, ns=pns)
    for keys, pns in pins.values():
        table.release(keys, ns=pns)
    table.clear()
    assert table.resident == 0 and table.pinned == 0
    assert table.stats["published"] == published == table.stats["evicted"]
    assert len(dropped) == published
    assert table.refcounts(None) == {}


@pytest.mark.parametrize("seed", [4180, 37, 55, 122])
def test_random_ops_preserve_chains_pins_and_namespaces(seed):
    """Seeds at which a release that decrements before it has checked every
    key corrupts another pin's refs (4180 is the example the reference
    test's hypothesis database replays)."""
    _random_ops(seed)


def test_random_ops_over_a_seeded_range():
    for seed in range(300):
        _random_ops(seed)


def _chain_table():
    """A published 3-page chain with two pins on its first two pages and
    one on the whole chain."""
    table = PageTable(_PS)
    prompt = _prompt(0, blocks=3)
    for b in range(1, 4):
        assert table.publish(prompt[:b * _PS], snapshot=b)
    short = table.acquire(prompt[:2 * _PS] + (99,)).keys
    table.acquire(prompt[:2 * _PS] + (99,))
    whole = table.acquire(prompt + (99,)).keys
    assert len(short) == 2 and len(whole) == 3
    return table, short, whole


def test_over_release_leaves_every_refcount_as_it_was():
    """Releasing the whole chain twice: the second release finds the last
    key at refcount 0 and raises, and no refcount has moved, so the other
    pins on the shorter keys still release."""
    table, short, whole = _chain_table()
    table.release(whole)
    before = table.refcounts(None)
    assert before[("", whole[-1])] == 0 and before[("", whole[0])] == 2
    with pytest.raises(ValueError, match="released more than acquired"):
        table.release(whole)
    assert table.refcounts(None) == before
    table.release(short)
    table.release(short)
    assert all(n == 0 for n in table.refcounts(None).values())


def test_a_repeated_key_needs_as_many_refs():
    """A key listed n times in one release needs n refs: four releases of a
    key held three times raise and leave its refcount as it was; two drop
    two, and three of a key held three times drop all three."""
    table, short, _ = _chain_table()
    first = short[0]
    assert table.refcounts()[first] == 3
    with pytest.raises(ValueError, match="released more than acquired"):
        table.release([first] * 4)
    assert table.refcounts()[first] == 3
    table.release([first, first])
    assert table.refcounts()[first] == 1
    table.release([short[1]] * 3)
    assert table.refcounts()[short[1]] == 0
