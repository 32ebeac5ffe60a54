"""The port engine's platform surface and energy meter, against the JAX
engine and against itself.

On the ``granite_3_2b`` smoke config at ``dtype="float32"`` with the JAX
package's weights carried across (as ``tests/test_torch_engine.py`` sets it
up), on seeded traces and a fake clock that advances between steps:

* the port's ``EnergyMeter`` is a copy: fed the same charges and ticks as
  the reference's, it gives the same floats;
* the port engine schedules each trace as the reference sync paged engine
  does (checked first: equal step, token, stall and re-match counts), on
  traces without sharing, with sharing after publication, and on a shared
  cold prefix where siblings stall on a dedup claim and re-match mid-flight;
  its meter totals and every ``Request.energy_uj`` equal the reference's
  within 1e-12 relative, and its admit/complete interrupt counts and final
  bank states equal the reference's;
* a metered engine gives the same completions as an unmetered one, the
  meter conserves (``total == attributed + overhead``, ``attributed ==
  sum of Request.energy_uj``) and its totals never decrease, and
  ``set_operating_point`` changes joules, not tokens.
"""

import dataclasses
import random

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.serve import energy_meter as JM
from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.sharding import params as JP

torch = configs = params_from_numpy = EM = None  # bound by _port
ContinuousBatchingEngine = Request = Platform = XHeepConfig = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, configs, params_from_numpy, EM
    global ContinuousBatchingEngine, Request, Platform, XHeepConfig
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.core.platform import Platform, XHeepConfig
    from repro_torch.serve import energy_meter as EM
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request
    torch.set_num_threads(1)


MAX_LEN, REL = 32, 1e-12


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jconfigs.smoke("granite_3_2b"), dtype="float32")
    cfg = dataclasses.replace(configs.smoke("granite_3_2b"), dtype="float32")
    jparams = JP.init_tree(jreg.decls(jcfg), jax.random.key(0))
    jparams["embed"] = jparams["embed"] * 10.0
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def trace():
    """Six requests sharing a 9-token prefix (two full 4-token pages), as
    ``tests/test_torch_engine.py`` serves them."""
    rng = np.random.default_rng(2)
    prefix = [int(t) for t in rng.integers(1, 256, 9)]
    return [(f"r{i}", prefix + [int(t) for t in rng.integers(1, 256, 1 + i % 4)],
             4 + i % 3) for i in range(6)]


def drive(eng, reqs, dt=0.25, on_step=None):
    """Submit ``reqs`` and step ``eng`` to idle on a fake clock that moves
    ``dt`` between steps (so the meter's retention ticks count)."""
    now = [0.0]
    eng.clock = lambda: now[0]
    for r in reqs:
        assert eng.submit(r)
    while eng.step():
        now[0] += dt
        if on_step is not None:
            on_step(eng)
    return eng


def run_port(cfg, params, reqs=None, **kw):
    kw = {"slots": 3, "max_len": MAX_LEN, "page_size": 4, "prefill_chunk": 4,
          **kw}
    reqs = [Request(*r) for r in (reqs or trace())]
    return drive(ContinuousBatchingEngine(cfg, params, device="cpu", **kw),
                 reqs), reqs


def tokens(eng):
    return {r.id: tuple(r.tokens) for r in eng.completed}


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


# ---------------------------------------------------------------------------
# The meter itself is a copy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("point,gate", [("max", True), ("nominal", True),
                                        ("max", False)])
def test_meter_equals_the_references_on_the_same_charges(point, gate):
    rng = random.Random(7)
    got, want = (EM.EnergyMeter(point=point, gate_idle_banks=gate),
                 JM.EnergyMeter(point=point, gate_idle_banks=gate))
    reqs = [[JaxRequest(f"q{i}", [1], 1) for i in range(4)] for _ in range(2)]
    now = 0.0
    for step in range(60):
        if step == 30:
            got.set_point("nominal")
            want.set_point("nominal")
        now += rng.choice([0.0, 0.1, 0.35])
        residents = [(i, rng.choice([0.5, 1.0]), rng.uniform(0, 3))
                     for i in range(rng.randint(0, 4))]
        idle = rng.randint(0, 3)
        charges = [(i, rng.choice(["prefill", "decode"]), rng.randint(1, 4),
                    rng.uniform(0, 4)) for i in range(rng.randint(0, 4))]
        for meter, rs in ((got, reqs[0]), (want, reqs[1])):
            meter.tick(now, [(rs[i], w, p) for i, w, p in residents], idle)
            meter.charge_step([(rs[i], k, n, p) for i, k, n, p in charges],
                              idle)
    assert got.stats() == want.stats()
    assert [r.energy_uj for r in reqs[0]] == [r.energy_uj for r in reqs[1]]
    assert (EM.PAGES_PER_BANK, EM.PAGE_RETENTION_UW, EM.HOST_DISPATCH_CYCLES) \
        == (JM.PAGES_PER_BANK, JM.PAGE_RETENTION_UW, JM.HOST_DISPATCH_CYCLES)


# ---------------------------------------------------------------------------
# The engine against the reference engine
# ---------------------------------------------------------------------------

# (slots, page_size): one slot with the page table (prefix adoption after
# publication, shared pages at 1/refcount), three slots without sharing,
# and two and three slots with the page table on the shared cold prefix
# (siblings stall on the first one's claim, then re-match its pages)
SCHEDULES = [(1, 4), (3, None), (2, None), (3, 4), (2, 4)]


@pytest.mark.parametrize("slots,page_size", SCHEDULES)
def test_meter_matches_the_reference_engine(model, slots, page_size):
    jcfg, jparams, cfg, params = model
    kw = {"slots": slots, "max_len": MAX_LEN, "page_size": page_size,
          "prefill_chunk": 4}
    jreqs = [JaxRequest(*r) for r in trace()]
    jeng = drive(JaxEngine(jcfg, jparams, async_dispatch=False, paged=True,
                           **kw), jreqs)
    eng, reqs = run_port(cfg, params, **kw)
    js, st = jeng.stats(), eng.stats()
    # the reference schedules this trace as the port does
    for key in ("steps", "tokens_generated", "prompt_tokens_processed",
                "prompt_tokens_reused", "stalls", "rematches",
                "rematched_tokens"):
        assert st[key] == js[key], key
    assert (js["stalls"] > 0) == (slots > 1 and page_size is not None)
    assert tokens(eng) == tokens(jeng)
    # ... so the meters agree
    want, got = js["energy"], st["energy"]
    assert sorted(got) == sorted(want) and got["point"] == want["point"]
    for key, value in want.items():
        if key != "point":
            assert rel(got[key], value) <= REL, (key, got[key], value)
    assert want["retention_uj"] > 0 and want["idle_uj"] > 0
    for r, jr in zip(reqs, jreqs):
        assert r.id == jr.id and rel(r.energy_uj, jr.energy_uj) <= REL
    # interrupts and the final bank states
    assert eng.platform.interrupts.counts == jeng.platform.interrupts.counts
    assert eng.platform.interrupts.counts == {"serve.admit": 6,
                                              "serve.complete": 6}
    assert {k: v.value for k, v in eng.platform.power.states.items()} == \
        {k: v.value for k, v in jeng.platform.power.states.items()}


def test_page_shares_split_by_refcount(model):
    """With the page table, a slot that adopted the resident prefix holds
    pages with refcount > 1 (table residency + pins) and pays a fraction."""
    _, _, cfg, params = model
    shares = []

    def watch(eng):
        for s in eng.slots:
            if s is not None and s.page_keys:
                shares.append((eng._page_share(s), len(s.pages_by_block)))

    eng = ContinuousBatchingEngine(cfg, params, slots=1, max_len=MAX_LEN,
                                   device="cpu", page_size=4, prefill_chunk=4)
    drive(eng, [Request(*r) for r in trace()], on_step=watch)
    assert shares and all(share < held for share, held in shares)
    assert eng._pool.refcounts() == {
        i: int(r) for i, r in enumerate(eng._pool._refs) if r}


# ---------------------------------------------------------------------------
# The engine against itself
# ---------------------------------------------------------------------------


def test_metering_never_changes_tokens_and_conserves(model):
    _, _, cfg, params = model
    plain, _ = run_port(cfg, params, metered=False)
    totals = []

    def watch(eng):
        e = eng.stats()["energy"]
        totals.append(e)
        assert rel(e["total_uj"], e["attributed_uj"] + e["overhead_uj"]) <= 1e-12
        live = sum(r.energy_uj for r in reqs)
        assert rel(e["attributed_uj"], live) <= 1e-9

    reqs = [Request(*r) for r in trace()]
    eng = drive(ContinuousBatchingEngine(cfg, params, slots=3, max_len=MAX_LEN,
                                         device="cpu", page_size=4,
                                         prefill_chunk=4), reqs, on_step=watch)
    assert tokens(eng) == tokens(plain)
    assert "energy" not in plain.stats() and "energy" in eng.stats()
    assert all(r.energy_uj > 0 for r in reqs)
    assert all(r.energy_uj == 0.0 for r in plain.completed)
    for key in totals[0]:
        if key not in ("point", "projected_uj_per_token"):
            seq = [t[key] for t in totals]
            assert all(b >= a for a, b in zip(seq, seq[1:])), key
    with pytest.raises(ValueError, match="metered=False"):
        plain.set_operating_point("nominal")


def test_operating_point_changes_joules_not_tokens(model):
    _, _, cfg, params = model
    fast, _ = run_port(cfg, params)
    slow, _ = run_port(cfg, params, operating_point="nominal")
    switched = ContinuousBatchingEngine(cfg, params, slots=3, max_len=MAX_LEN,
                                        device="cpu", page_size=4,
                                        prefill_chunk=4)
    drive(switched, [Request(*r) for r in trace()],
          on_step=lambda e: e.steps == 5 and e.set_operating_point("nominal"))
    assert tokens(fast) == tokens(slow) == tokens(switched)
    f, s, w = (e.stats()["energy"] for e in (fast, slow, switched))
    assert (f["point"], s["point"], w["point"]) == ("max", "nominal", "nominal")
    assert w["dvfs_switches"] == 1 and f["dvfs_switches"] == 0
    assert s["projected_uj_per_token"] < f["projected_uj_per_token"]
    assert s["decode_uj"] < w["decode_uj"] < f["decode_uj"]
    ungated, _ = run_port(cfg, params, gate_idle_banks=False)
    assert tokens(ungated) == tokens(fast)
    assert ungated.stats()["energy"]["idle_uj"] > f["idle_uj"]


def test_banks_gate_and_interrupts_fire(model):
    _, _, cfg, params = model
    seen = []
    platform = Platform(XHeepConfig(n_banks=2))
    platform.interrupts.connect("serve.complete", lambda r: seen.append(r.id))
    # a shared platform's banks are left as they are at construction
    eng = ContinuousBatchingEngine(cfg, params, slots=3, max_len=MAX_LEN,
                                   device="cpu", platform=platform,
                                   metered=False)
    assert platform.power.state("bank0").value == "on"
    assert eng._slot_bank == ["bank0", "bank1", "bank0"]
    reqs = [Request(*r) for r in trace()]
    admitted = []
    platform.interrupts.connect("serve.admit", lambda r: admitted.append(r.id))
    drive(eng, reqs)
    assert admitted == [r.id for r in reqs]
    assert sorted(seen) == sorted(r.id for r in reqs)
    assert seen == [r.id for r in eng.completed]
    # every slot released its bank: the last holder gated it
    assert {platform.power.state(f"bank{i}").value for i in range(2)} == \
        {"clock_gated"}
    own = ContinuousBatchingEngine(cfg, params, slots=2, max_len=MAX_LEN,
                                   device="cpu")
    assert {s.value for n, s in own.platform.power.states.items()
            if n.startswith("bank")} == {"clock_gated"}
