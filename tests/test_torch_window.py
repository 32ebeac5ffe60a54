"""Sliding-window configs on the port's paged backend (ring block tables).

Ports ``tests/test_sliding_window.py`` and
``tests/test_open_loop.py::test_eager_window_recycling_holds_no_dead_pages``
to the port's engine, on the granite smoke config with a window set (and
h2o-danube3's smoke config, window 16, as a cluster tenant), float32 with
the JAX package's weights (``tests/torch_serve.py``):

* windowed paged serving equals the lane ring cache (``paged=False``) bit
  for bit inside the port, at windows smaller than, equal to and not a
  multiple of the page size, and after ``preempt()`` + replay with ring
  recycling in flight;
* its schedule (engine steps, ``pages_recycled``, ``window``,
  ``table_entries_per_slot``, reused prompt tokens) and the journal's
  recycle records equal the sync JAX engine's on the same trace, and its
  tokens equal the JAX engine's wherever the margins are clear;
* a slot holds O(window) pages, prefix adoption is clamped to the pages
  the window can still see, dead ring pages are recycled the moment they
  fall out of the window, and a window past the device length degenerates
  to global attention;
* a windowed tenant of a ``ServeCluster`` under a ``PowerBudget`` keeps
  the budget, recycles onto the shared free list and equals the same
  engine alone;
* stale pages stay out of the softmax: with every free page of the pool
  (pages recycled out of windows, pages never used) filled with NaN after
  every step, the plain version's tokens are the same bits and every
  step's logits finite.
"""

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.serve.cluster import PowerBudget as JaxBudget
from repro.serve.cluster import ServeCluster as JaxCluster
from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve import sim as jsim
from torch_serve import hold_tokens, tokens_of, weights

torch = configs = registry = E = sim = cluster_mod = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file (see ``tests/test_torch_engine.py``)."""
    global torch, configs, registry, E, sim, cluster_mod
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.serve import cluster as cluster_mod
    from repro_torch.serve import engine as E
    from repro_torch.serve import sim
    torch.set_num_threads(1)


def requests(n, *, prompt_len, new_tokens, prefix="r", make=None):
    """``n`` deterministic requests with distinct prompts (the reference
    suite's ``make_requests``), as the port's or the JAX package's
    ``Request`` (``make``)."""
    make = make or E.Request
    return [make(f"{prefix}{i}",
                 [(7 * i + j) % 251 + 1 for j in range(prompt_len)],
                 new_tokens) for i in range(n)]


def jax_engine(model, **kw):
    jcfg, jparams, _, _ = model
    clock = jsim.FakeClock()
    return JaxEngine(jcfg, jparams, clock=clock, async_dispatch=False,
                     **kw), clock


def port_engine(model, **kw):
    _, _, cfg, params = model
    clock = sim.FakeClock()
    return E.ContinuousBatchingEngine(cfg, params, clock=clock,
                                      device="cpu", **kw), clock


SCHEDULE = ("steps", "pages_recycled", "window", "table_entries_per_slot",
            "prompt_tokens_reused", "stalls", "rematches", "backend")


def same_schedule(got, want) -> None:
    gs, ws = got.stats(), want.stats()
    for key in SCHEDULE:
        assert gs[key] == ws[key], (key, gs[key], ws[key])
    for req in want.completed:
        g, w = got.journal.get(req.id), want.journal.get(req.id)
        assert (g.recycled, g.prefix_reused, g.rematched) == \
            (w.recycled, w.prefix_reused, w.rematched), req.id


def test_supports_paged_covers_sliding_window_but_not_moe():
    swa = configs.smoke("h2o_danube3_4b")
    assert swa.sliding_window and registry.supports_paged(swa)
    assert not registry.supports_paged(configs.smoke("grok_1_314b"))
    assert jreg.supports_paged(jconfigs.smoke("h2o_danube3_4b"))


@pytest.mark.parametrize("window", [4, 8, 12])
def test_windowed_paged_equals_lane_ring_and_the_jax_engine(window):
    """Window smaller than (4), equal to (8) and not a multiple of (12) the
    8-token page: paged ≡ lane ring bit for bit in the port, and the
    schedule, recycles and tokens of the sync JAX engine."""
    model = weights(window=window)
    kw = dict(slots=2, max_len=36, page_size=8)

    def trace(mod, make):
        return mod.staggered_trace(
            requests(4, prompt_len=14, new_tokens=12, make=make), gap=1.0)

    paged, clock = port_engine(model, **kw)
    sim.Simulator(paged, trace(sim, E.Request), clock).run()
    lanes, lclock = port_engine(model, paged=False, **kw)
    sim.Simulator(lanes, trace(sim, E.Request), lclock).run()
    jeng, jclock = jax_engine(model, **kw)
    jsim.Simulator(jeng, trace(jsim, JaxRequest), jclock).run()

    assert paged.stats()["backend"] == "paged"
    assert lanes.stats()["backend"] == "lanes"
    assert paged.stats()["window"] == window
    assert tokens_of(paged) == tokens_of(lanes)
    # 14 + 12 = 26 positions (4 blocks) cross every ring: it recycled
    assert paged.pages_recycled > 0
    same_schedule(paged, jeng)
    hold_tokens(model, jeng, tokens_of(paged), 36)


def test_slot_holds_o_window_pages():
    """A slot's block table is a ring of ceil(window / page_size) + 1
    entries, the private pool provisions slots x that, and a long request
    never holds more: O(window), not O(seq)."""
    eng, _ = port_engine(weights(window=16), slots=1, max_len=44,
                         page_size=8)
    bound = -(-16 // 8) + 1                       # 3
    assert eng._np_slot == bound
    assert eng.stats()["table_entries_per_slot"] == bound
    assert eng._pool.n_pages == 1 * bound + 16 * 1
    eng.submit(E.Request("long", list(range(1, 21)), 20))
    high = 0
    while eng.busy:
        eng.step()
        slot = eng.slots[0]
        if slot is not None:
            high = max(high, len(slot.pages_by_block))
            assert len(slot.pages_by_block) <= bound
    # 40 positions = 5 pages of history; the ring held at most 3
    assert high == bound
    assert eng.pages_recycled >= 2
    # drained: every ring page went back to the pool or the table's residency
    assert eng._pool.in_use == eng.pages.resident


def test_prefix_sharing_is_clamped_to_the_window():
    """A shared prefix longer than the window admits pre-consumed, but the
    slot pins only the chain pages the window can still see; tokens equal
    the lane ring's and the reused counts the JAX engine's."""
    model = weights(window=16)
    prefix = [(3 * j) % 97 + 1 for j in range(24)]     # 3 pages > window

    def reqs(make):
        return [make(f"shared{i}", prefix + [(17 * i + 5 * j) % 239 + 1
                                             for j in range(3)], 6)
                for i in range(4)]

    def staggered(reqs, arrival):
        return [arrival(4.0 * i, r) for i, r in enumerate(reqs)]

    kw = dict(max_len=40, page_size=8, slots=2)
    eng, clock = port_engine(model, **kw)
    sim.Simulator(eng, staggered(reqs(E.Request), sim.Arrival), clock).run()
    lane, lclock = port_engine(model, paged=False, **kw)
    sim.Simulator(lane, staggered(reqs(E.Request), sim.Arrival),
                  lclock).run()
    jeng, jclock = jax_engine(model, **kw)
    jsim.Simulator(jeng, staggered(reqs(JaxRequest), jsim.Arrival),
                   jclock).run()
    assert tokens_of(eng) == tokens_of(lane)
    assert eng.prompt_tokens_reused > 0
    same_schedule(eng, jeng)

    # one admission: the match covers blocks 0-2 (24 tokens), the window
    # only ever sees positions >= 24 + 1 - 16 = 9, so block 0 is dropped
    eng.submit(E.Request("probe", prefix + [7, 8, 9], 2))
    eng.step()
    slot = next(s for s in eng.slots if s is not None)
    assert slot.request.id == "probe"
    assert 0 not in slot.pages_by_block
    assert min(len(k) for k in slot.page_keys) > 8   # block 0's key released
    eng.run_until_idle()
    assert eng._pool.in_use == eng.pages.resident


@pytest.mark.parametrize("async_dispatch", [False, True])
def test_recycling_survives_preempt_and_replay(async_dispatch):
    """Ring recycling under way, then ``preempt()``: the replay gives every
    token bit for bit (the journal cross-checks), each run's recycles are
    journaled, and the sync run's recycle count equals the JAX engine's
    driven the same way."""
    model = weights(window=8)
    kw = dict(slots=2, max_len=32, page_size=8)

    def trace(mod, make):
        return mod.staggered_trace(
            requests(3, prompt_len=12, new_tokens=14, make=make), gap=1.0)

    base, bclock = port_engine(model, **kw)
    sim.Simulator(base, trace(sim, E.Request), bclock).run()

    eng, clock = port_engine(model, async_dispatch=async_dispatch, **kw)
    driver = sim.Simulator(eng, trace(sim, E.Request), clock)
    jeng, jclock = jax_engine(model, **kw)
    jdriver = jsim.Simulator(jeng, trace(jsim, JaxRequest), jclock)
    for d, e, c in ((driver, eng, clock), (jdriver, jeng, jclock)):
        for _ in range(20):                # mid-flight, recycling begun
            d._deliver_due()
            e.step()
            c.advance(1.0)
        assert e.pages_recycled > 0
        assert e.preempt()                 # something was in flight
        d.run()
    assert tokens_of(eng) == tokens_of(base)
    rec = eng.journal.get(eng.completed[-1].id)
    assert rec.completed and rec.recycled > 0
    if not async_dispatch:
        same_schedule(eng, jeng)


def test_window_past_the_device_length_degenerates_to_global():
    """A window wider than the device cache clamps to it: the ring covers
    everything, nothing recycles, and the tokens equal the lane backend's
    (which clamps its ring alike)."""
    model = weights(window=4096)
    eng, clock = port_engine(model, slots=2, max_len=24, page_size=8)
    lane, lclock = port_engine(model, slots=2, max_len=24, page_size=8,
                               paged=False)
    for e, c in ((eng, clock), (lane, lclock)):
        sim.Simulator(e, sim.staggered_trace(
            requests(3, prompt_len=6, new_tokens=6), gap=1.0), c).run()
    assert tokens_of(eng) == tokens_of(lane)
    assert eng.stats()["window"] == eng.device_len == 24
    assert eng.pages_recycled == 0


def test_eager_recycling_holds_no_dead_pages():
    """After every step no slot holds a ring page wholly below its window:
    the dead page is back in the pool at the boundary crossing."""
    window = 8
    eng, _ = port_engine(weights(window=window), slots=1, max_len=36,
                         page_size=8)
    eng.submit(E.Request("w0", [(11 * j) % 239 + 1 for j in range(10)], 20))
    ps = eng._ps
    while eng.busy:
        eng.step()
        for slot in eng.slots:
            if slot is None or not slot.pages_by_block:
                continue
            first_needed = max(0, slot.fed + 1 - window) // ps
            dead = [b for b in slot.pages_by_block if b < first_needed]
            assert not dead, (dead, slot.fed)
    assert eng.pages_recycled >= 2
    assert len(tokens_of(eng)["w0"]) == 20


def test_windowed_tenant_in_a_cluster_under_a_power_budget():
    """h2o-danube3 (window 16) beside granite on one ServeCluster (shared
    pool and table) under a 2-bank budget: paged, the budget never
    exceeded, recycles onto the shared free list, tokens equal the same
    engine alone; the cluster's schedule equals the JAX cluster's."""
    dense, swa = weights("granite_3_2b"), weights("h2o_danube3_4b")

    def reqs(prefix, make):
        # 10 + 16 = 26 positions: past the 16-token window
        return requests(4, prompt_len=10, new_tokens=16, prefix=prefix,
                        make=make)

    def run(port: bool):
        mod = sim if port else jsim
        make = E.Request if port else JaxRequest
        clock = mod.FakeClock()
        if port:
            cl = cluster_mod.ServeCluster(
                pool_pages=48, page_size=8, clock=clock, device="cpu",
                power_budget=cluster_mod.PowerBudget(max_awake_banks=2))
        else:
            cl = JaxCluster(pool_pages=48, page_size=8, clock=clock,
                            power_budget=JaxBudget(max_awake_banks=2))
        for name, m in (("dense", dense), ("swa", swa)):
            cfg, params = (m[2], m[3]) if port else (m[0], m[1])
            cl.add_engine(cfg, params, name=name, slots=3, max_len=40)
        trace = (mod.tag_engine(mod.staggered_trace(reqs("d", make),
                                                    gap=1.0), "dense")
                 + mod.tag_engine(mod.staggered_trace(reqs("s", make),
                                                      gap=1.0), "swa"))
        driver = mod.ClusterSimulator(cl, trace, clock)
        high = 0
        for _ in range(10_000):            # by hand: the budget each round
            driver._deliver_due()
            if cl.busy:
                cl.step()
                clock.advance(1.0)
            elif driver.pending:
                clock.advance_to(driver.pending[0].time)
            else:
                break
            high = max(high, cl.awake_banks())
        return cl, high

    cl, high = run(True)
    jcl, _ = run(False)
    assert high <= 2
    assert cl.engines["swa"].stats()["backend"] == "paged"
    assert cl.engines["swa"].pages_recycled > 0
    for name in ("dense", "swa"):
        same_schedule(cl.engines[name], jcl.engines[name])
    assert cl.power_stalls == jcl.power_stalls > 0
    hold_tokens(swa, jcl.engines["swa"], tokens_of(cl.engines["swa"]), 40)

    iso, iclock = port_engine(swa, slots=3, max_len=40, page_size=8)
    sim.Simulator(iso, sim.staggered_trace(reqs("s", E.Request), gap=1.0),
                  iclock).run()
    assert tokens_of(cl.engines["swa"]) == tokens_of(iso)


def poisoning(eng, seen: list):
    """Wrap ``eng``'s paged step so that before every launch each page on
    the pool's free list (pages recycled out of a window, pages never
    handed out) holds NaN in every layer's K and V, and every launch's
    logits are checked finite."""
    real = eng._pstep
    arena, pool = eng._arena, eng._pool

    def step(params, pool_k, pool_v, tables, lengths, *rest):
        free = torch.tensor(sorted(pool._free), dtype=torch.long)
        if len(free):
            arena.k[:, free] = float("nan")
            arena.v[:, free] = float("nan")
            seen.append(len(free))
        used = np.unique(np.asarray(tables)[np.asarray(rest[3])])
        assert not set(used.tolist()) & set(pool._free)
        return real(params, pool_k, pool_v, tables, lengths, *rest)

    orig = E.registry.decode_step_paged

    def checked(*args, **kw):
        logits, k, v = orig(*args, **kw)
        mask = kw.get("append_mask")
        rows = logits if mask is None else logits[mask.bool()]
        assert bool(torch.isfinite(rows).all()), "NaN reached a live lane"
        return logits, k, v

    eng._pstep = step
    return checked


def test_poisoned_free_pages_stay_out_of_the_softmax(monkeypatch):
    """Pages recycled out of a window go back to the free list, and a page
    handed to a slot holds its last owner's bytes past the slot's length.
    With every free page NaN before every launch (prefix sharing on, so
    adopted pages are disowned too), the windowed engine's tokens equal an
    unpoisoned run's bit for bit and every live lane's logits stay
    finite: the ring gather reads only positions in [n - window, n)."""
    model = weights(window=12)
    prefix = [(5 * j) % 113 + 1 for j in range(20)]
    reqs = lambda: [E.Request(f"p{i}", prefix + [(3 * i + j) % 211 + 1   # noqa: E731
                                                 for j in range(2 + i)], 14)
                    for i in range(5)]
    kw = dict(slots=3, max_len=48, page_size=4, page_capacity=8)
    want_eng, clock = port_engine(model, **kw)
    sim.Simulator(want_eng, sim.staggered_trace(reqs(), gap=2.0), clock).run()

    eng, clock = port_engine(model, **kw)
    seen = []
    monkeypatch.setattr(E.registry, "decode_step_paged", poisoning(eng, seen))
    sim.Simulator(eng, sim.staggered_trace(reqs(), gap=2.0), clock).run()
    assert tokens_of(eng) == tokens_of(want_eng)
    assert eng.pages_recycled > 0 and eng.prompt_tokens_reused > 0
    assert seen and min(seen) >= 1
