"""Fault injection and crash recovery on the port's serving stack.

Ports ``tests/test_chaos.py``. Under any injected schedule (device-step
failures, corrupted tokens, NaN logits, allocation failures, engine
crashes, bank power-faults, prefix-match drops) every completed request's
tokens equal the fault-free run's bit for bit, no request is lost and none
completes twice; two same-seed chaos runs inject the same schedule and give
the same everything. As in the reference suite the port's cluster runs its
engine with async dispatch; the same plan with sync dispatch gives the same
fault counters, schedule and (where margins are clear) tokens as the JAX
cluster with sync dispatch (the JAX engine's async path has an aliasing race,
ROADMAP.md queue 3, so it is compared sync only). Smoke configs in float32
with the JAX package's weights (``tests/torch_serve.py``).
"""

import dataclasses

import pytest

from repro.runtime.ft import FTConfig as JaxFTConfig
from repro.serve import chaos as jchaos
from repro.serve import cluster as JC
from repro.serve import sim as jsim
from repro.serve.engine import Request as JaxRequest
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from torch_serve import hold_tokens, tokens_of, weights

torch = E = sim = C = chaos = ft = metrics = None       # bound by _port
SamplingParams = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file (see ``tests/test_torch_engine.py``)."""
    global torch, E, sim, C, chaos, ft, metrics, SamplingParams
    torch = pytest.importorskip("torch")
    from repro_torch.runtime import ft
    from repro_torch.serve import chaos, metrics
    from repro_torch.serve import cluster as C
    from repro_torch.serve import engine as E
    from repro_torch.serve import sim
    from repro_torch.serve.sampling import SamplingParams
    torch.set_num_threads(1)


DEVICE = dict(lane_batch=4, device_len=48)


def side_of(port: bool):
    """(sim, cluster, chaos, Request, SamplingParams, FTConfig) of the port
    or of the JAX package."""
    if port:
        return sim, C, chaos, E.Request, SamplingParams, ft.FTConfig
    return jsim, JC, jchaos, JaxRequest, JaxSamplingParams, JaxFTConfig


def make_cluster(port=True, **kw):
    s, c = side_of(port)[:2]
    clock = s.FakeClock()
    if port:
        kw["device"] = "cpu"
    return c.ServeCluster(page_size=8, clock=clock, **kw), clock


def add(cl, port=True, arch="granite_3_2b", *, name, window=None, **kw):
    m = weights(arch, window=window)
    cfg, params = (m[2], m[3]) if port else (m[0], m[1])
    kw = {"slots": 2, "max_len": 40, **DEVICE, **kw}
    return cl.add_engine(cfg, params, name=name, **kw)


def make_requests(port, n, *, prompt_len, new_tokens, prefix="r"):
    make = side_of(port)[3]
    return [make(f"{prefix}{i}", [(7 * i + j) % 251 + 1
                                  for j in range(prompt_len)], new_tokens)
            for i in range(n)]


def drive(spec=None, seed=7, n=8, *, port=True, async_dispatch=True,
          **cluster_kw):
    """``tests/test_chaos.py``'s ``_drive``: one engine ``e0`` (2 slots,
    prefill chunk 2), ``n`` staggered requests, under ``FaultPlan(seed,
    spec)`` (none without ``spec``)."""
    s, _, ch = side_of(port)[:3]
    plan = ch.FaultPlan(seed, ch.FaultSpec(**spec)) if spec else None
    cl, clock = make_cluster(port, pool_pages=48, chaos=plan, **cluster_kw)
    add(cl, port, name="e0", prefill_chunk=2, page_size=8,
        async_dispatch=async_dispatch and port)
    trace = s.tag_engine(s.staggered_trace(
        make_requests(port, n, prompt_len=5, new_tokens=4), gap=1.0), "e0")
    s.ClusterSimulator(cl, trace, clock).run()
    return cl, plan


@pytest.fixture(scope="module")
def fault_free():
    return tokens_of(drive()[0].engines["e0"])


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------


def test_fault_spec_validates_probabilities():
    with pytest.raises(ValueError, match="probability"):
        chaos.FaultSpec(step_fail=1.5)
    with pytest.raises(ValueError, match="probability"):
        chaos.FaultSpec(engine_crash=-0.1)


def test_fault_plan_streams_are_seeded_and_scoped():
    spec = chaos.FaultSpec(step_fail=0.5, engine_crash=0.5)
    a, b = chaos.FaultPlan(11, spec), chaos.FaultPlan(11, spec)
    seq_a = [a.crash("e0") for _ in range(50)]
    assert seq_a == [b.crash("e0") for _ in range(50)]
    assert a.counts == b.counts
    c = chaos.FaultPlan(11, spec)
    seq_c = [c.crash("e1") for _ in range(50)]
    assert [b.crash("e1") for _ in range(50)] == seq_c
    j = jchaos.FaultPlan(11, jchaos.FaultSpec(step_fail=0.5,
                                              engine_crash=0.5))
    assert [j.crash("e0") for _ in range(50)] == seq_a


def test_fault_plan_budget_caps_and_zero_never_draws():
    capped = chaos.FaultPlan(0, chaos.FaultSpec(step_fail=1.0),
                             budget={"step_fail": 2})
    fired = 0
    for _ in range(10):
        try:
            capped.launch("e")
        except chaos.DeviceStepFault:
            fired += 1
    assert fired == 2 and capped.counts["step_fail"] == 2
    plan = chaos.FaultPlan(0, chaos.FaultSpec())
    plan.launch("e")
    plan.alloc("e")
    assert plan.deliver_token("e", 7) == 7
    assert not plan.crash("e") and not plan.bank("e")
    assert not plan.drop_prefix("ns") and plan._rngs == {}


# ---------------------------------------------------------------------------
# Every fault kind: outputs bit for bit, schedules as the reference's
# ---------------------------------------------------------------------------


FAULT_KEYS = ("step_faults", "alloc_faults", "token_faults", "replays",
              "retries", "crashes", "bank_faults", "rebuilds", "injected",
              "watchdog_events")


@pytest.mark.parametrize("kind,p", [
    ("step_fail", 0.15), ("token_corrupt", 0.1), ("nan_logits", 0.1),
    ("alloc_fail", 0.35), ("engine_crash", 0.05), ("bank_fault", 0.08),
    ("prefix_drop", 0.3),
])
def test_each_fault_kind_keeps_outputs_bit_identical(kind, p, fault_free):
    cl, plan = drive({kind: p})
    assert plan.counts[kind] > 0, "the fault under test never fired"
    assert tokens_of(cl.engines["e0"]) == fault_free
    faults = cl.stats()["faults"]
    assert faults["injected"] == plan.counts
    if kind == "step_fail":
        assert faults["step_faults"] == plan.counts[kind]
        assert faults["retries"] > 0
    if kind == "alloc_fail":
        assert faults["alloc_faults"] == plan.counts[kind]
    if kind in ("token_corrupt", "nan_logits"):
        assert faults["token_faults"] == plan.counts[kind]
        assert faults["replays"] > 0
    if kind == "engine_crash":
        assert faults["crashes"] == faults["rebuilds"] == plan.counts[kind]
        assert cl.platform.interrupts.count(C.CRASH_LINE) == plan.counts[kind]
    if kind == "bank_fault":
        assert cl.platform.interrupts.count(C.BANK_FAULT_LINE) == \
            faults["bank_faults"] > 0
    # sync dispatch: the reference's schedule, fault for fault
    sync, _ = drive({kind: p}, async_dispatch=False)
    want, _ = drive({kind: p}, port=False)
    got, ref = sync.stats()["faults"], want.stats()["faults"]
    for key in FAULT_KEYS:
        assert got[key] == ref[key], (key, got[key], ref[key])
    assert tokens_of(sync.engines["e0"]) == fault_free
    assert sync.stats()["engines"]["e0"]["steps"] == \
        want.stats()["engines"]["e0"]["steps"]
    hold_tokens(weights(), want.engines["e0"],
                tokens_of(sync.engines["e0"]), 48)


STORM = dict(step_fail=0.05, token_corrupt=0.05, nan_logits=0.03,
             alloc_fail=0.05, engine_crash=0.02, bank_fault=0.04,
             prefix_drop=0.2)


def test_fault_storm_no_lost_no_double_completed(fault_free):
    cl, plan = drive(STORM, seed=3)
    eng = cl.engines["e0"]
    assert tokens_of(eng) == fault_free
    done = [r.id for r in eng.completed]
    assert len(done) == len(set(done)) == 8
    assert not eng.queue and eng.active == 0
    assert sum(plan.counts.values()) > 0
    got = drive(STORM, seed=3, async_dispatch=False)[0].stats()["faults"]
    want = drive(STORM, seed=3, port=False)[0].stats()["faults"]
    assert {k: got[k] for k in FAULT_KEYS} == {k: want[k] for k in FAULT_KEYS}


def test_same_seed_chaos_runs_are_bit_identical():
    spec = dict(step_fail=0.05, token_corrupt=0.05, engine_crash=0.02,
                bank_fault=0.04)

    def once():
        cl, _ = drive(spec, seed=3)
        return (tokens_of(cl.engines["e0"]), cl.stats()["faults"],
                [msg for _, msg in cl.watchdog.events])

    tok1, faults1, events1 = once()
    tok2, faults2, events2 = once()
    assert tok1 == tok2 and faults1 == faults2
    assert events1 == events2 and len(events1) > 0


def test_persistent_corruption_raises_instead_of_livelocking():
    m = weights()
    eng = E.ContinuousBatchingEngine(
        m[2], m[3], slots=1, max_len=16, device="cpu",
        chaos=chaos.FaultPlan(0, chaos.FaultSpec(token_corrupt=1.0)))
    eng.submit(E.Request("r", [1, 2], 2))
    with pytest.raises(RuntimeError, match="quarantined"):
        eng.run_until_idle()


def test_transient_fault_streak_past_budget_raises():
    plan = chaos.FaultPlan(0, chaos.FaultSpec(step_fail=1.0))
    cl, _ = make_cluster(pool_pages=48, chaos=plan, max_fault_streak=3)
    add(cl, name="e0", slots=1)
    cl.submit("e0", E.Request("r", [1, 2], 2))
    with pytest.raises(RuntimeError, match="consecutive step faults"):
        cl.run_until_idle()


def test_corrupted_token_never_journaled_then_replays():
    m = weights()

    def run(**kw):
        clock = sim.FakeClock()
        eng = E.ContinuousBatchingEngine(m[2], m[3], slots=2, max_len=16,
                                         clock=clock, device="cpu", **kw)
        sim.Simulator(eng, sim.staggered_trace(
            make_requests(True, 4, prompt_len=3, new_tokens=4), gap=1.0),
            clock).run()
        return eng

    base = run()
    plan = chaos.FaultPlan(0, chaos.FaultSpec(token_corrupt=0.2))
    eng = run(chaos=plan, async_dispatch=True)
    assert plan.counts["token_corrupt"] > 0
    assert eng.token_faults == plan.counts["token_corrupt"]
    assert eng.replays > 0
    assert tokens_of(eng) == tokens_of(base)
    for rec in eng.journal.completed():
        assert all(0 <= t < eng.cfg.vocab for t in rec.generated)


# ---------------------------------------------------------------------------
# Crash recovery and the watchdog
# ---------------------------------------------------------------------------


def crash_cluster(port=True, async_dispatch=True):
    """Engine ``g`` (granite, 2 slots, chunk 2): shared-prefix greedy and
    sampled requests; engine ``w`` (granite with an 8-token window): two
    requests running past the window."""
    s, _, _, make, sp_cls, _ = side_of(port)
    cl, clock = make_cluster(port, pool_pages=64)
    add(cl, port, name="g", namespace="granite", prefill_chunk=2,
        page_size=8, async_dispatch=async_dispatch and port)
    add(cl, port, name="w", namespace="swa", window=8)
    prefix = [(13 * j) % 241 + 1 for j in range(16)]
    g = [make(f"s{i}", prefix + [(17 * i + 5 * j) % 239 + 1
                                 for j in range(3)], 5) for i in range(3)]
    g += [make(f"x{i}", [(5 * i + j) % 200 + 1 for j in range(4)], 6,
               sampling=sp_cls(temperature=0.9, top_k=20, top_p=0.9,
                               seed=5)) for i in range(3)]
    w = [make(f"w{i}", [(3 * i + j) % 150 + 1 for j in range(12)], 16)
         for i in range(2)]
    trace = (list(s.tag_engine(s.staggered_trace(g, gap=1.0), "g"))
             + list(s.tag_engine(s.staggered_trace(w, gap=1.0), "w")))
    trace.sort(key=lambda a: a.time)
    return cl, clock, trace


@pytest.mark.parametrize("async_dispatch", [True, False])
def test_crash_restore_bit_identical_and_reconciled(async_dispatch):
    """Kill both engines with sampled, windowed and shared-prefix work in
    flight: the journal rebuild completes every request with the
    fault-free tokens, the pool's references reconcile exactly, and the
    rebuilt engines reuse the cluster's arena and the same parameter
    tensors. The sync run equals the JAX cluster's sync run."""
    base, bclock, btrace = crash_cluster(async_dispatch=async_dispatch)
    sim.ClusterSimulator(base, btrace, bclock).run()
    want = {n: tokens_of(e) for n, e in base.engines.items()}
    assert len(want["g"]) == 6 and len(want["w"]) == 2

    def crashed(port):
        s = side_of(port)[0]
        cl, clock, trace = crash_cluster(port, async_dispatch)
        driver = s.ClusterSimulator(cl, trace, clock)
        for _ in range(12):                # partway: work in flight
            driver._deliver_due()
            if cl.busy:
                cl.step()
            clock.advance(1.0)
        assert cl.engines["g"].active > 0 and cl.engines["w"].active > 0
        return cl, driver

    cl, driver = crashed(True)
    old = dict(cl.engines)
    arenas = {n: e._arena for n, e in old.items()}
    owners = cl.pool.owners()
    assert sum(owners.values()) == cl.pool.in_use
    cl.crash_engine("g")
    cl.crash_engine("w")
    # the dead tenants' slots are swept: only the table's residency is left
    assert cl.pool.in_use == cl.table.resident
    assert cl.crashes == cl.rebuilds == 2
    assert cl.platform.interrupts.count(C.CRASH_LINE) == 2
    for name, eng in cl.engines.items():
        assert eng is not old[name] and eng.params is old[name].params
        assert eng._arena is arenas[name]
    driver.run()
    got = {n: tokens_of(e) for n, e in cl.engines.items()}
    assert got == want
    assert cl.engines["w"].pages_recycled > 0
    for eng in cl.engines.values():
        ids = [r.id for r in eng.completed]
        assert len(ids) == len(set(ids))
    assert cl.pool.in_use == cl.table.resident
    assert sum(cl.pool.owners().values()) == cl.pool.in_use
    cl.table.clear()
    assert cl.pool.in_use == 0
    if not async_dispatch:
        jcl, jdriver = crashed(False)
        jcl.crash_engine("g")
        jcl.crash_engine("w")
        jdriver.run()
        for name in ("g", "w"):
            a, b = cl.engines[name].stats(), jcl.engines[name].stats()
            for key in ("steps", "stalls", "pages_recycled", "replays",
                        "prompt_tokens_reused"):
                assert a[key] == b[key], (name, key)
            m = weights(window=8 if name == "w" else None)
            hold_tokens(m, jcl.engines[name], got[name], 48)


def test_crash_with_delayed_rebuild_restarts_via_step_loop():
    base, bclock, btrace = crash_cluster()
    sim.ClusterSimulator(base, btrace, bclock).run()
    want = {n: tokens_of(e) for n, e in base.engines.items()}
    cl, clock, trace = crash_cluster()
    driver = sim.ClusterSimulator(cl, trace, clock)
    for _ in range(10):
        driver._deliver_due()
        if cl.busy:
            cl.step()
        clock.advance(1.0)
    assert cl.engines["g"].busy
    cl.crash_engine("g", rebuild=False)
    assert "g" in cl.stats()["faults"]["down"]
    assert cl.busy
    driver.run()
    assert cl.rebuilds == 1
    assert {n: tokens_of(e) for n, e in cl.engines.items()} == want


def test_watchdog_heartbeat_timeout_escalates_to_crash():
    base, _ = drive(n=4)
    want = tokens_of(base.engines["e0"])
    cl, clock = make_cluster(pool_pages=48, watchdog=ft.FTConfig(
        heartbeat_timeout_s=3.0, backoff_base_s=1.0))
    add(cl, name="e0", prefill_chunk=2, page_size=8, async_dispatch=True)
    driver = sim.ClusterSimulator(cl, sim.tag_engine(sim.staggered_trace(
        make_requests(True, 4, prompt_len=5, new_tokens=4), gap=1.0), "e0"),
        clock)
    for _ in range(4):
        driver._deliver_due()
        cl.step()
        clock.advance(1.0)
    assert cl.engines["e0"].busy
    cl._backoff["e0"] = 100                # wedge it: no heartbeat
    before = cl.crashes
    for _ in range(6):
        driver._deliver_due()
        cl.step()
        clock.advance(1.0)
    assert cl.crashes == before + 1
    assert any("heartbeat timeout" in msg for _, msg in cl.watchdog.events)
    driver.run()
    assert tokens_of(cl.engines["e0"]) == want


def test_degraded_engine_sheds_blown_heads_without_policy():
    cl, clock = make_cluster(pool_pages=48, watchdog=ft.FTConfig(),
                             degrade_streak=3)
    add(cl, name="e0", slots=1)
    blown = E.Request("late", [1, 2, 3], 2, slo=metrics.SLO(ttft=2.0))
    blown.arrival_time = 0.0
    clock.t = 10.0
    cl.submit("e0", blown)
    cl._fault_streak["e0"] = 3
    cl.step()
    assert cl.sheds == 1 and cl.engines["e0"].shed == 1
    assert not cl.engines["e0"].queue


def test_replayed_request_exempt_from_shedding():
    cl, clock = make_cluster(pool_pages=48, watchdog=ft.FTConfig(),
                             policy=C.SchedPolicy(shed_busted=True))
    eng = add(cl, name="e0", slots=1)
    req = E.Request("r", [1, 2, 3], 4, slo=metrics.SLO(ttft=2.0))
    cl.submit("e0", req)
    cl.step()
    assert eng.journal.has("r")
    cl.crash_engine("e0")
    clock.t = 50.0
    cl.run_until_idle()
    eng = cl.engines["e0"]
    assert cl.sheds == 0 and eng.shed == 0
    assert [r.id for r in eng.completed] == ["r"]


def test_bank_fault_requeues_fifo_and_gates_the_bank():
    cl, _ = make_cluster(pool_pages=48)
    eng = add(cl, name="e0")
    for r in make_requests(True, 2, prompt_len=3, new_tokens=4):
        cl.submit("e0", r)
    cl.step()
    assert eng.active == 2
    banks = {eng._slot_bank[i] for i, s in enumerate(eng.slots)
             if s is not None}
    cl._apply_bank_fault("e0")
    assert cl.bank_faults == 1
    assert cl.platform.interrupts.count(C.BANK_FAULT_LINE) == 1
    if len(banks) == 1:
        assert [r.id for r in eng.queue] == ["r0", "r1"]
    else:
        assert [r.id for r in eng.queue] == ["r0"]
    cl.run_until_idle()
    assert sorted(r.id for r in eng.completed) == ["r0", "r1"]


def test_chaos_on_a_windowed_engine_keeps_its_ring():
    """A windowed tenant under every fault kind: its recycles and tokens
    equal the fault-free run's and no ring page leaks."""
    def run(plan):
        cl, clock = make_cluster(pool_pages=48, chaos=plan)
        add(cl, name="w", window=8, prefill_chunk=2)
        trace = sim.tag_engine(sim.staggered_trace(
            make_requests(True, 5, prompt_len=10, new_tokens=12), gap=1.0),
            "w")
        sim.ClusterSimulator(cl, trace, clock).run()
        return cl

    base = run(None)
    plan = chaos.FaultPlan(5, chaos.FaultSpec(**STORM))
    cl = run(plan)
    assert sum(plan.counts.values()) > 0
    assert tokens_of(cl.engines["w"]) == tokens_of(base.engines["w"])
    assert cl.engines["w"].pages_recycled > 0
    assert cl.pool.in_use == cl.table.resident
    assert dataclasses.asdict(plan.spec) == STORM
