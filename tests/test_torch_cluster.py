"""The port's serving stack above the engine: loadgen, metrics, the
watchdog, the cluster and its simulator, against the JAX package and
against itself.

Ports ``tests/test_cluster.py`` and ``tests/test_open_loop.py`` (its
windowed case is in ``tests/test_torch_window.py``). The host modules are
held to the JAX package's exactly, on the same seeds: ``poisson_times``,
``bursty_times``, ``diurnal_times`` and ``open_loop_trace`` field for
field, ``FaultPlan`` draws, ``percentile``, ``SLO.deadline`` and
``ServeMetrics`` summaries, and ``FTController`` under a seeded sequence of
operations. The cluster runs on the smoke configs in float32 with the JAX
package's weights (``tests/torch_serve.py``), against the JAX cluster
driven alike with sync dispatch: its schedule (engine steps, stalls,
admission and power stalls, sheds, SLO preemptions, reclaims,
``ClusterSimReport`` fields, every request's TTFT and TPOT and the metrics'
percentiles) exactly, its tokens where the margins are clear. Inside the
port, bit for bit: each tenant's tokens equal the same engine alone, and
two same-seed runs are identical. Also: the budget is never exceeded and a
budget deadlock raises, fair reclaim, namespace isolation, and the
``PagePool`` invariants under a random two-tenant interleaving.
"""

import dataclasses
import itertools
import random

import pytest

from repro.runtime import ft as jft
from repro.serve import chaos as jchaos
from repro.serve import cluster as JC
from repro.serve import loadgen as jload
from repro.serve import metrics as jmetrics
from repro.serve import sim as jsim
from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from torch_serve import hold_tokens, tokens_of, weights

torch = E = sim = C = load = metrics = ft = chaos = paged = None  # by _port
SamplingParams = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file (see ``tests/test_torch_engine.py``)."""
    global torch, E, sim, C, load, metrics, ft, chaos, paged, SamplingParams
    torch = pytest.importorskip("torch")
    from repro_torch.runtime import ft
    from repro_torch.serve import chaos, loadgen as load, metrics, paged
    from repro_torch.serve import cluster as C
    from repro_torch.serve import engine as E
    from repro_torch.serve import sim
    from repro_torch.serve.sampling import SamplingParams
    torch.set_num_threads(1)


# every engine of these tests pads its device shapes alike, so the JAX
# side compiles one paged step per config
DEVICE = dict(lane_batch=4, device_len=48)


class Side:
    """One package's serving stack: ``Side(True)`` the port's (on the
    CPU), ``Side(False)`` the JAX package's (sync dispatch)."""

    def __init__(self, port: bool):
        self.port = port
        self.sim = sim if port else jsim
        self.C = C if port else JC
        self.load = load if port else jload
        self.metrics = metrics if port else jmetrics
        self.Request = E.Request if port else JaxRequest
        self.SamplingParams = SamplingParams if port else JaxSamplingParams

    def cluster(self, *, pool_pages=48, page_size=8, budget=None,
                policy=None, **kw):
        clock = self.sim.FakeClock()
        if budget is not None:
            kw["power_budget"] = self.C.PowerBudget(**budget)
        if policy is not None:
            kw["policy"] = self.C.SchedPolicy(**policy)
        if self.port:
            kw["device"] = "cpu"
        return self.C.ServeCluster(pool_pages=pool_pages, page_size=page_size,
                                   clock=clock, **kw), clock

    def add(self, cl, arch="granite_3_2b", *, name, seed=0, slots=2,
            max_len=40, **kw):
        m = weights(arch, seed=seed)
        cfg, params = (m[2], m[3]) if self.port else (m[0], m[1])
        return cl.add_engine(cfg, params, name=name, slots=slots,
                             max_len=max_len, **{**DEVICE, **kw})

    def requests(self, n, *, prompt_len=3, new_tokens=4, prefix="r"):
        return [self.Request(f"{prefix}{i}",
                             [(7 * i + j) % 251 + 1
                              for j in range(prompt_len)], new_tokens)
                for i in range(n)]

    def shared(self, prefix, n=4, *, prefix_len=16, tail_len=3,
               new_tokens=4):
        return [self.Request(
            f"{prefix}{i}", [(13 * j) % 241 + 1 for j in range(prefix_len)]
            + [(17 * i + 5 * j) % 239 + 1 for j in range(tail_len)],
            new_tokens) for i in range(n)]

    def alone(self, arch, reqs, *, seed=0, slots=2, max_len=40, **kw):
        """The same model serving ``reqs`` (all at once) alone on its own
        pool and table: the per-engine bit-identity baseline."""
        m = weights(arch, seed=seed)
        cfg, params = (m[2], m[3]) if self.port else (m[0], m[1])
        clock = self.sim.FakeClock()
        extra = {"device": "cpu"} if self.port else {}
        engine = E.ContinuousBatchingEngine if self.port else JaxEngine
        eng = engine(cfg, params, slots=slots, max_len=max_len, clock=clock,
                     page_size=8, **{**DEVICE, **kw, **extra})
        self.sim.Simulator(eng, self.sim.burst_trace(reqs), clock).run()
        return tokens_of(eng)


@pytest.fixture(scope="module")
def sides():
    return Side(True), Side(False)


ENGINE_KEYS = ("steps", "tokens_generated", "prompt_tokens_processed",
               "prompt_tokens_reused", "stalls", "admission_stalls",
               "rematches", "rematched_tokens", "pages_recycled", "shed",
               "rejected", "completed", "replays")
CLUSTER_KEYS = ("steps", "power_stalls", "dvfs_throttles", "energy_sheds",
                "wrr_stalls", "sheds", "slo_preempts", "reclaims",
                "awake_banks")


def same_cluster(got, want) -> None:
    """The port's cluster scheduled as the JAX one did: cluster counters,
    every tenant's counters, completion order, every request's timestamps,
    the pool's and table's numbers."""
    gs, ws = got.stats(), want.stats()
    for key in CLUSTER_KEYS:
        assert gs[key] == ws[key], (key, gs[key], ws[key])
    assert set(gs["engines"]) == set(ws["engines"])
    for name in ws["engines"]:
        g, w = gs["engines"][name], ws["engines"][name]
        for key in ENGINE_KEYS:
            assert g[key] == w[key], (name, key, g[key], w[key])
        for a, b in zip(got.engines[name].completed,
                        want.engines[name].completed, strict=True):
            assert a.id == b.id
            assert (a.arrival_time, a.admit_time, a.first_token_time,
                    a.finish_time, a.slo_preempts) == \
                (b.arrival_time, b.admit_time, b.first_token_time,
                 b.finish_time, b.slo_preempts), a.id
    for key in ("allocated", "freed", "high_water", "in_use", "by_owner"):
        assert gs["pool"][key] == ws["pool"][key], key
    assert gs["table"]["by_namespace"] == ws["table"]["by_namespace"]


def hold_cluster_tokens(got, want, max_len=48) -> None:
    for name, eng in want.engines.items():
        cfg = eng.cfg
        arch = {"granite-smoke": "granite_3_2b",
                "stablelm-smoke": "stablelm_3b",
                "h2o-danube3-smoke": "h2o_danube3_4b"}[cfg.name]
        seed = 1 if eng.namespace in ("m1", "other") else 0
        hold_tokens(weights(arch, seed=seed), eng,
                    tokens_of(got.engines[name]), max_len)


# ---------------------------------------------------------------------------
# The host modules against the reference's, exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal"])
@pytest.mark.parametrize("seed", [0, 7, "mix"])
def test_arrival_processes_equal_the_reference(process, seed):
    kw = {"bursty": dict(burst=4), "diurnal": dict(period=50.0,
                                                   amplitude=0.5),
          "poisson": {}}[process]
    got = list(itertools.islice(
        getattr(load, f"{process}_times")(5.0, seed=seed, **kw), 400))
    want = list(itertools.islice(
        getattr(jload, f"{process}_times")(5.0, seed=seed, **kw), 400))
    assert got == want
    assert all(a <= b for a, b in zip(got, got[1:]))


def _tenants(side):
    return [
        side.load.TenantSpec(engine="a", share=3.0, prompt_len=(6, 12),
                             new_tokens=(2, 9), prefix_len=4, prefix_seed=5,
                             slo=side.metrics.SLO(ttft=10.0, tpot=2.0)),
        side.load.TenantSpec(engine="b", share=1.0, prompt_len=(4, 8),
                             sampling=side.SamplingParams(0.8, 50, 0.9),
                             energy_cap_uj_per_token=3.5),
        side.load.TenantSpec(engine="c", share=0.5, prompt_len=(1, 30),
                             prefix_len=40, prefix_seed=5, vocab=17),
    ]


def _digest(trace):
    out = []
    for a in trace:
        r = a.request
        out.append((a.time, a.engine, r.id, r.prompt, r.max_new_tokens,
                    dataclasses.astuple(r.slo) if r.slo else None,
                    r.sampling.astuple() if r.sampling else None,
                    r.energy_cap_uj_per_token))
    return out


@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal"])
def test_open_loop_trace_equals_the_reference(sides, process):
    """1000 arrivals field for field: times, tenants, prompts (shared
    prefixes clamped), lengths, SLOs, sampling seeds, energy caps."""
    port, jax_ = sides
    kw = dict(n_requests=1000, rate=20.0, seed=11, process=process,
              burst=6, period=30.0, amplitude=0.7)
    got = _digest(port.load.open_loop_trace(_tenants(port), **kw))
    want = _digest(jax_.load.open_loop_trace(_tenants(jax_), **kw))
    assert got == want
    assert {g[1] for g in got} == {"a", "b", "c"}
    head = list(itertools.islice(port.load.open_loop_trace(
        _tenants(port), **{**kw, "n_requests": 10**6}), 5))
    assert _digest(head) == got[:5]        # lazy and prefix-stable


def test_loadgen_validation_matches_the_reference(sides):
    for side in sides:
        good = [side.load.TenantSpec(engine="a")]
        with pytest.raises(ValueError, match="at least one TenantSpec"):
            next(side.load.open_loop_trace([], n_requests=1, rate=1.0))
        with pytest.raises(ValueError, match="arrival process"):
            next(side.load.open_loop_trace(good, n_requests=1, rate=1.0,
                                           process="uniform"))
        with pytest.raises(ValueError, match="share"):
            side.load.TenantSpec(engine="a", share=0.0)
        with pytest.raises(ValueError, match="prompt_len"):
            side.load.TenantSpec(engine="a", prompt_len=(0, 4))
        with pytest.raises(ValueError, match="energy_cap"):
            side.load.TenantSpec(engine="a", energy_cap_uj_per_token=0.0)
        with pytest.raises(ValueError, match="rate"):
            next(side.load.poisson_times(0.0, seed=1))
        with pytest.raises(ValueError, match="amplitude"):
            next(side.load.diurnal_times(1.0, seed=1, amplitude=2.0))


def _draws(mod, seed):
    spec = mod.FaultSpec(step_fail=0.3, token_corrupt=0.2, nan_logits=0.2,
                         alloc_fail=0.25, engine_crash=0.1, bank_fault=0.15,
                         prefix_drop=0.4)
    plan = mod.FaultPlan(seed, spec, budget={"engine_crash": 3})
    rng = random.Random(seed)
    out = []
    for _ in range(600):
        scope = rng.choice(["e0", "e1", "granite", ""])
        point = rng.choice(["launch", "deliver", "alloc", "drop", "crash",
                            "bank"])
        try:
            if point == "launch":
                plan.launch(scope)
                out.append("ok")
            elif point == "deliver":
                out.append(plan.deliver_token(scope, rng.randrange(256)))
            elif point == "alloc":
                plan.alloc(scope or None)
                out.append("ok")
            elif point == "drop":
                out.append(plan.drop_prefix(scope))
            elif point == "crash":
                out.append(plan.crash(scope))
            else:
                out.append(plan.bank(scope))
        except (mod.DeviceStepFault, mod.AllocFault) as e:
            out.append((type(e).__name__, str(e)))
    return out, plan.counts


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_plan_draws_equal_the_reference(seed):
    got, got_counts = _draws(chaos, seed)
    want, want_counts = _draws(jchaos, seed)
    assert got == want and got_counts == want_counts
    assert got_counts["engine_crash"] <= 3 and sum(got_counts.values()) > 50


def _stamped(side, rng, i):
    slo = rng.choice([None, side.metrics.SLO(ttft=4.0, tpot=2.0),
                      side.metrics.SLO(ttft=3.0), side.metrics.SLO(tpot=1.5)])
    n = rng.randint(1, 7)
    req = side.Request(f"q{i}", [1, 2], n, slo=slo)
    req.tokens = list(range(1, n + 1))
    req.arrival_time = rng.random() * 10
    req.first_token_time = req.arrival_time + rng.random() * 8
    req.finish_time = req.first_token_time + rng.random() * 12
    req.energy_uj = rng.random() * 40
    return req


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_the_reference(sides, seed):
    """Nearest-rank percentiles, SLO deadlines and ``ServeMetrics``
    summaries over 300 randomly stamped requests, exactly."""
    port, jax_ = sides
    got, want = port.metrics.ServeMetrics(), jax_.metrics.ServeMetrics()
    rng_a, rng_b = random.Random(seed), random.Random(seed)
    for i in range(300):
        a, b = _stamped(port, rng_a, i), _stamped(jax_, rng_b, i)
        assert port.metrics.met_slo(a) == jax_.metrics.met_slo(b)
        got.observe(a)
        want.observe(b)
    assert got.summary(elapsed=37.5) == want.summary(elapsed=37.5)
    xs = [random.Random(seed + 10).random() for _ in range(51)]
    for q in (0.5, 1, 25, 50, 90, 99, 99.9, 100):
        assert metrics.percentile(xs, q) == jmetrics.percentile(xs, q)
    for ttft, tpot, arr, n in [(4.0, 2.0, 10.0, 5), (None, 2.0, 1.0, 1),
                               (3.0, None, 0.5, 9), (None, None, 2.0, 3)]:
        assert metrics.SLO(ttft, tpot).deadline(arr, n) == \
            jmetrics.SLO(ttft, tpot).deadline(arr, n)
    with pytest.raises(ValueError):
        metrics.percentile([], 99)
    with pytest.raises(ValueError):
        metrics.SLO(ttft=0.0)


def test_percentile_is_exact_nearest_rank():
    xs = [4.0, 1.0, 3.0, 2.0]
    assert metrics.percentile(xs, 50) == 2.0
    assert metrics.percentile(xs, 75) == 3.0
    assert metrics.percentile(xs, 99) == 4.0
    assert metrics.percentile([5.0], 50) == 5.0


def _ft_run(mod, seed):
    clock = jsim.FakeClock()
    ctl = mod.FTController(3, mod.FTConfig(heartbeat_timeout_s=5.0,
                                           straggler_streak=2,
                                           max_restarts=4), clock=clock)
    rng = random.Random(seed)
    out = []
    for _ in range(300):
        op = rng.choice(["beat", "beat", "time", "time", "fail", "tick",
                         "tick", "add", "delay", "plan", "shares", "wait"])
        w = rng.choice(sorted(ctl.workers))
        if op == "beat":
            ctl.report_heartbeat(w)
        elif op == "time":
            ctl.report_step_time(w, rng.choice([1.0, 1.1, 3.0, 0.9]))
        elif op == "fail":
            ctl.report_failure(w, "chaos")
        elif op == "tick":
            out.append(ctl.tick())
        elif op == "add":
            out.append(ctl.add_worker())
        elif op == "delay":
            out.append(ctl.restart_delay())
        elif op == "plan":
            out.append(ctl.rescale_plan((len(ctl.workers), 2), axis=0))
        elif op == "shares":
            out.append(ctl.microbatch_shares(17))
        else:
            clock.advance(rng.choice([0.5, 2.0, 6.0]))
        out.append(sorted((i, w.state.value, w.slow_streak)
                          for i, w in ctl.workers.items()))
    return out, ctl.events, ctl.healthy_workers()


@pytest.mark.parametrize("seed", [0, 5])
def test_ft_controller_equals_the_reference(seed):
    assert _ft_run(ft, seed) == _ft_run(jft, seed)


def test_cluster_journal_keeps_engines_separate():
    cj = ft.ClusterJournal(horizon=2)
    for name in ("a", "b"):
        j = cj.journal(name)
        assert cj.journal(name) is j and j.horizon == 2
        j.open(f"{name}0", [1, 2], 2)
        j.open(f"{name}1", [1, 2], 2)
        j.complete(f"{name}0")
    assert cj.engines() == ["a", "b"]
    assert {n: [r.request_id for r in rs]
            for n, rs in cj.incomplete().items()} == {"a": ["a1"],
                                                      "b": ["b1"]}
    assert [r.request_id for r in cj.completed()["a"]] == ["a0"]


# ---------------------------------------------------------------------------
# Tenancy: two models, one pool
# ---------------------------------------------------------------------------


def test_two_models_one_pool_equal_each_alone_and_the_reference(sides):
    """granite and stablelm on one pool and table, both paged: each
    tenant's tokens equal the same model alone, the schedule the JAX
    cluster's."""
    clusters = {}
    for side in sides:
        cl, clock = side.cluster()
        eg = side.add(cl, name="granite")
        es = side.add(cl, "stablelm_3b", name="stablelm")
        assert eg._pool is cl.pool and es.pages is cl.table
        trace = (side.sim.tag_engine(side.sim.burst_trace(side.shared("g")),
                                     "granite")
                 + side.sim.tag_engine(side.sim.burst_trace(
                     side.shared("s")), "stablelm"))
        rep = side.sim.ClusterSimulator(cl, trace, clock).run()
        assert rep.tokens_generated == 2 * 4 * 4
        clusters[side.port] = cl
    port, jax_ = sides
    cl = clusters[True]
    assert cl.engines["granite"].stats()["backend"] == "paged"
    assert cl.engines["stablelm"].stats()["backend"] == "paged"
    assert tokens_of(cl.engines["granite"]) == port.alone(
        "granite_3_2b", port.shared("g"))
    assert tokens_of(cl.engines["stablelm"]) == port.alone(
        "stablelm_3b", port.shared("s"))
    assert cl.engines["granite"].prompt_tokens_reused > 0
    assert set(cl.table.resident_by_ns()) == {"granite-smoke",
                                              "stablelm-smoke"}
    same_cluster(cl, clusters[False])
    hold_cluster_tokens(cl, clusters[False])


def test_cross_engine_replica_prefix_reuse(sides):
    port = sides[0]
    cl, _ = port.cluster()
    ea = port.add(cl, name="rep-a", namespace="granite")
    eb = port.add(cl, name="rep-b", namespace="granite")
    for r in port.shared("a"):
        cl.submit("rep-a", r)
    cl.run_until_idle()
    published = cl.table.stats["published"]
    assert published > 0
    for r in port.shared("b"):
        cl.submit("rep-b", r)
    cl.run_until_idle()
    assert cl.table.stats["published"] == published
    assert cl.journal.journal("rep-b").get("b0").prefix_reused == 16
    assert eb.prompt_tokens_reused >= 4 * 16
    assert tokens_of(ea) == port.alone("granite_3_2b", port.shared("a"))
    assert tokens_of(eb) == port.alone("granite_3_2b", port.shared("b"))


def test_namespaces_isolate_different_weights(sides):
    port = sides[0]
    cl, _ = port.cluster()
    port.add(cl, name="m0", namespace="m0", seed=0)
    eb = port.add(cl, name="m1", namespace="m1", seed=1)
    for r in port.shared("a"):
        cl.submit("m0", r)
    cl.run_until_idle()
    for r in port.shared("b"):
        cl.submit("m1", r)
    cl.run_until_idle()
    assert cl.journal.journal("m1").get("b0").prefix_reused == 0
    by_ns = cl.table.resident_by_ns()
    assert by_ns["m0"] > 0 and by_ns["m1"] > 0
    assert tokens_of(eb) == port.alone("granite_3_2b", port.shared("b"),
                                       seed=1)


def test_tenancy_is_checked(sides):
    """Namespace peers share config and weights exactly; duplicate names
    and lane-only families raise; a replica group is a target of its own,
    whose name no engine may take (``tests/test_torch_tp.py`` serves
    them)."""
    port = sides[0]
    cl, _ = port.cluster()
    port.add(cl, name="a", namespace="shared", seed=0)
    with pytest.raises(ValueError, match="different model"):
        port.add(cl, name="b", namespace="shared", seed=1)
    with pytest.raises(ValueError, match="different model"):
        port.add(cl, "stablelm_3b", name="c", namespace="shared")
    port.add(cl, "stablelm_3b", name="d")
    with pytest.raises(ValueError, match="duplicate target name"):
        port.add(cl, name="a", namespace="granite")
    with pytest.raises(ValueError, match="paged"):
        port.add(cl, "mamba2_370m", name="ssm")
    m = weights()
    assert cl.add_replica_group(m[2], m[3], name="g", slots=1, max_len=8,
                                meshes=[None]) == ["g/r0"]
    assert cl.route("g", port.requests(1)[0]) == "g/r0"
    with pytest.raises(ValueError, match="last replica"):
        cl.drain_replica("g", "g/r0")
    with pytest.raises(ValueError, match="duplicate target name"):
        port.add(cl, name="g")
    assert cl.targets == {"a", "d", "g", "g/r0"}


def test_cluster_runs_on_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.ServeCluster(pool_pages=8)
    cl = C.ServeCluster(pool_pages=8, device="cpu")
    m = weights()
    eng = cl.add_engine(m[2], m[3], name="g", slots=1, max_len=16)
    assert eng.device == torch.device("cpu")
    assert cl.pool.bytes_by_device().keys() == {"cpu"}
    assert cl.pool.device_pages == cl.pool.n_pages + 1


# ---------------------------------------------------------------------------
# Power-budget backpressure
# ---------------------------------------------------------------------------


def _budget_run(side, **budget):
    cl, clock = side.cluster(budget=budget or dict(max_awake_banks=1))
    side.add(cl, name="x", namespace="granite")
    side.add(cl, name="y", namespace="granite")
    driver = side.sim.ClusterSimulator(
        cl, side.sim.tag_engine(side.sim.burst_trace(side.shared("a")), "x")
        + side.sim.tag_engine(side.sim.burst_trace(side.shared("b")), "y"),
        clock)
    high = 0
    while cl.busy or driver.pending:
        driver._deliver_due()
        if cl.busy:
            cl.step()
            clock.advance(1.0)
        high = max(high, cl.awake_banks())
    return cl, high


def test_power_budget_stalls_never_exceeds(sides):
    port, jax_ = sides
    cl, high = _budget_run(port)
    jcl, jhigh = _budget_run(jax_)
    assert high == jhigh == 1
    assert cl.power_stalls > 0
    ea, eb = cl.engines["x"], cl.engines["y"]
    assert ea.admission_stalls + eb.admission_stalls >= cl.power_stalls
    assert tokens_of(ea) == port.alone("granite_3_2b", port.shared("a"))
    assert tokens_of(eb) == port.alone("granite_3_2b", port.shared("b"))
    same_cluster(cl, jcl)


def test_power_budget_preempt_replay_bit_identical(sides):
    port = sides[0]
    cl, _ = port.cluster(budget=dict(max_awake_banks=1))
    ea = port.add(cl, name="x", namespace="granite")
    eb = port.add(cl, name="y", namespace="granite")
    for r in port.shared("a"):
        cl.submit("x", r)
    for r in port.shared("b"):
        cl.submit("y", r)
    for _ in range(5):
        cl.step()
    requeued = cl.preempt()
    assert any(requeued.values())
    assert all(e.active == 0 for e in cl.engines.values())
    assert cl.table.pinned == 0
    cl.run_until_idle()
    assert tokens_of(ea) == port.alone("granite_3_2b", port.shared("a"))
    assert tokens_of(eb) == port.alone("granite_3_2b", port.shared("b"))


def test_power_veto_skips_to_a_slot_on_an_awake_bank(sides):
    from repro_torch.core.platform import Platform, XHeepConfig

    port = sides[0]
    platform = Platform(XHeepConfig(n_banks=2))
    for i in range(2):
        platform.power.clock_gate(f"bank{i}")
    cl, _ = port.cluster(platform=platform,
                         budget=dict(max_awake_banks=1))
    eng = port.add(cl, name="x", slots=4)
    for r in port.shared("p", 3):
        cl.submit("x", r)
    cl.step()
    assert [i for i, s in enumerate(eng.slots) if s is not None] == [0, 2]
    assert cl.awake_banks() == 1 and cl.power_stalls > 0
    cl.run_until_idle()
    assert len(eng.completed) == 3


def test_budget_deadlock_raises_and_budget_validates(sides):
    port = sides[0]
    cl, _ = port.cluster(budget=dict(budget_uw=-1.0))
    port.add(cl, name="x")
    cl.submit("x", E.Request("r", [1, 2], 1))
    with pytest.raises(RuntimeError, match="budget deadlock"):
        cl.run_until_idle()
    with pytest.raises(ValueError, match="max_awake_banks, budget_uw, or"):
        C.PowerBudget()
    with pytest.raises(ValueError, match=">= 1"):
        C.PowerBudget(max_awake_banks=0)
    with pytest.raises(ValueError, match="max_uj_per_token"):
        C.PowerBudget(max_uj_per_token=0.0)
    with pytest.raises(ValueError, match="unknown operating point"):
        C.PowerBudget(max_awake_banks=1, throttle_point="turbo")
    with pytest.raises(ValueError, match="unknown scheduler"):
        C.SchedPolicy(scheduler="fifo")


def test_dvfs_throttle_and_energy_shed_match_the_reference(sides):
    """The budget's energy levers: a throttle point admits the first
    violation on a throttled meter, and a joules-per-token cap sheds fresh
    heads; the counts and the meters' joules equal the reference's."""
    runs = {}
    for side in sides:
        cl, clock = side.cluster(budget=dict(max_awake_banks=1,
                                             throttle_point="nominal",
                                             max_uj_per_token=6.0))
        side.add(cl, name="x", slots=3)
        reqs = side.requests(8, prompt_len=5, new_tokens=6)
        for r in reqs[4:]:
            r.energy_cap_uj_per_token = 2.0
        side.sim.ClusterSimulator(cl, side.sim.tag_engine(
            side.sim.staggered_trace(reqs, gap=1.5), "x"), clock).run()
        runs[side.port] = cl
    cl, jcl = runs[True], runs[False]
    assert cl.dvfs_throttles == jcl.dvfs_throttles > 0
    assert cl.energy_sheds == jcl.energy_sheds
    same_cluster(cl, jcl)
    assert cl.stats()["energy"] == pytest.approx(jcl.stats()["energy"],
                                                 rel=1e-12)


def test_wrr_weight_paces_admissions_per_round(sides):
    port = sides[0]
    cl, _ = port.cluster()
    paced = port.add(cl, name="paced", slots=4, weight=1)
    for r in port.shared("p"):
        cl.submit("paced", r)
    cl.step()
    assert paced.active == 1 and paced.admission_stalls > 0
    cl.step()
    assert paced.active == 2 and cl.wrr_stalls > 0
    cl.run_until_idle()
    assert len(paced.completed) == 4
    seqs = [cl.journal.journal("paced").get(f"p{i}").arrival_seq
            for i in range(4)]
    assert seqs == sorted(seqs)
    cl2, _ = port.cluster()
    eager = port.add(cl2, name="eager", slots=4)
    for r in port.shared("e"):
        cl2.submit("eager", r)
    cl2.step()
    assert eager.active == 4 and eager.admission_stalls == 0


# ---------------------------------------------------------------------------
# Shared-pool pressure
# ---------------------------------------------------------------------------


def test_pool_pressure_reclaims_fairly(sides):
    """A 17-page pool for two tenants whose waves publish 3 pages a
    request: idle residency is reclaimed heaviest namespace first, the
    pool is never overdrawn, tokens equal each tenant alone, and the
    reclaims and schedule equal the reference's."""
    runs = {}
    for side in sides:
        cl, clock = side.cluster(pool_pages=17)
        side.add(cl, name="x", namespace="granite")
        side.add(cl, name="y", namespace="other", seed=1)
        trace = (side.sim.tag_engine(side.sim.burst_trace(
            side.requests(6, prompt_len=25, prefix="a")), "x")
            + side.sim.tag_engine(side.sim.burst_trace(
                side.requests(6, prompt_len=25, prefix="b")), "y"))
        side.sim.ClusterSimulator(cl, trace, clock).run()
        runs[side.port] = cl
    port = sides[0]
    cl = runs[True]
    assert sum(cl.reclaims.values()) > 0
    assert cl.pool.in_use <= cl.pool.n_pages
    assert tokens_of(cl.engines["x"]) == port.alone(
        "granite_3_2b", port.requests(6, prompt_len=25, prefix="a"))
    assert tokens_of(cl.engines["y"]) == port.alone(
        "granite_3_2b", port.requests(6, prompt_len=25, prefix="b"), seed=1)
    same_cluster(cl, runs[False])
    assert sum(cl.pool.owners().values()) == cl.pool.in_use


@pytest.mark.parametrize("seed", range(6))
def test_pool_invariants_random_two_tenant_interleaving(seed):
    """``tests/test_cluster.py``'s property on the port's PagePool: random
    alloc, cross-tenant adopt and release never leak or go negative, and
    the tenants' counts sum to the pool's occupancy."""
    rng = random.Random(seed)
    n_pages = rng.randint(2, 9)
    pool = paged.PagePool(n_pages, 4)
    refs, held = {}, {"a": [], "b": []}
    for _ in range(rng.randint(1, 120)):
        code = rng.randint(0, 10**6)
        tenant = "a" if (code // 7) % 2 == 0 else "b"
        op = code % 3
        if op == 0:
            if pool.free_count:
                idx = pool.alloc(tenant)
                assert idx != pool.null and refs.get(idx, 0) == 0
                refs[idx] = 1
                held[tenant].append(idx)
            else:
                with pytest.raises(RuntimeError, match="exhausted"):
                    pool.alloc(tenant)
        elif op == 1:
            live = sorted(i for i, c in refs.items() if c > 0)
            if live:
                idx = live[code % len(live)]
                pool.retain(idx)
                refs[idx] += 1
                held[tenant].append(idx)
        elif held[tenant]:
            idx = held[tenant].pop(code % len(held[tenant]))
            pool.release(idx)
            refs[idx] -= 1
        assert pool.in_use + pool.free_count == pool.n_pages
        assert pool.refcounts() == {i: c for i, c in refs.items() if c > 0}
        assert sum(pool.owners().values()) == pool.in_use
    with pytest.raises(ValueError):
        pool.retain(pool.null)
    for tenant in held:
        for idx in held[tenant]:
            pool.release(idx)
    assert pool.in_use == 0 and not pool.owners()
    assert pool.stats["allocated"] == pool.stats["freed"]
    with pytest.raises(ValueError, match="released more"):
        pool.release(0)


def test_alloc_fault_hook_leaves_the_pool_untouched():
    pool = paged.PagePool(4, 4)
    pool.fault_hook = chaos.FaultPlan(0, chaos.FaultSpec(alloc_fail=1.0)).alloc
    with pytest.raises(chaos.AllocFault):
        pool.alloc("x")
    assert pool.free_count == 4 and pool.stats["allocated"] == 0


# ---------------------------------------------------------------------------
# The simulator
# ---------------------------------------------------------------------------


def test_cluster_sim_one_clock_per_engine_reports(sides):
    reports = {}
    for side in sides:
        cl, clock = side.cluster()
        side.add(cl, name="granite")
        side.add(cl, "stablelm_3b", name="stablelm")
        trace = (side.sim.tag_engine(side.sim.staggered_trace(
            side.shared("g", 3), gap=2.0), "granite")
            + side.sim.tag_engine(side.sim.staggered_trace(
                side.shared("s", 3), gap=3.0), "stablelm"))
        reports[side.port] = side.sim.ClusterSimulator(cl, trace,
                                                       clock).run()
        with pytest.raises(ValueError, match="untagged arrival"):
            side.sim.ClusterSimulator(
                cl, side.sim.staggered_trace(side.shared("u", 1)), clock)
    rep, jrep = reports[True], reports[False]
    assert [r.id for r in rep.completed["granite"]] == ["g0", "g1", "g2"]
    assert rep.tokens_generated == 6 * 4 and rep.throughput > 0
    for f in ("elapsed", "steps", "tokens_generated", "rejected", "shed",
              "energy_uj", "throughput", "tokens_per_joule"):
        assert getattr(rep, f) == getattr(jrep, f), f
    finish = [r.finish_time for r in rep.completed["granite"]]
    assert finish == sorted(finish)


def test_cluster_trace_validation(sides):
    port = sides[0]
    cl, clock = port.cluster()
    port.add(cl, name="g", namespace="granite")

    def arr(rid, t=0.0, engine="g"):
        return sim.Arrival(t, E.Request(rid, [1, 2], 1), engine)

    with pytest.raises(ValueError, match="unknown engine"):
        sim.ClusterSimulator(cl, [arr("z0", engine="nope")], clock)
    with pytest.raises(ValueError, match="untagged arrival"):
        sim.ClusterSimulator(cl, [arr("z1", engine=None)], clock)

    def bad_tag():
        yield arr("ok0")
        yield arr("z2", t=1.0, engine="nope")

    with pytest.raises(ValueError, match="unknown engine"):
        sim.ClusterSimulator(cl, bad_tag(), clock).run()

    def backwards():
        yield arr("ok1", t=5.0)
        yield arr("ok2", t=1.0)

    with pytest.raises(ValueError, match="backwards"):
        sim.ClusterSimulator(cl, backwards(), clock).run()
    driver = sim.ClusterSimulator(cl, [arr("s1", t=2.0), arr("s0", t=0.0)],
                                  clock)
    assert driver.pending[0].time == 0.0
    assert len(driver.run().completed["g"]) == 2
    with pytest.raises(ValueError, match="clock"):
        sim.ClusterSimulator(cl, [], sim.FakeClock())


def test_async_engines_are_charged_their_overlapped_cost(sides):
    """An async tenant pays the depth-1 pipeline cost in the cluster
    simulator, equal to the single-engine Simulator's and to the JAX
    cluster's sync accounting where both are sync; tokens equal sync's."""
    port, jax_ = sides

    def cluster_run(side, async_dispatch):
        cl, clock = side.cluster()
        eng = side.add(cl, name="g", namespace="granite",
                       async_dispatch=async_dispatch)
        trace = side.sim.tag_engine(side.sim.staggered_trace(
            side.requests(6, prompt_len=3, new_tokens=6), gap=1.0), "g")
        rep = side.sim.ClusterSimulator(cl, trace, clock, step_time=1.0,
                                        dispatch_time=1.0).run()
        return rep, tokens_of(eng)

    def solo_run(async_dispatch):
        m = weights()
        clock = sim.FakeClock()
        eng = E.ContinuousBatchingEngine(
            m[2], m[3], slots=2, max_len=40, clock=clock, device="cpu",
            async_dispatch=async_dispatch, **DEVICE)
        rep = sim.Simulator(eng, sim.staggered_trace(
            port.requests(6, prompt_len=3, new_tokens=6), gap=1.0), clock,
            step_time=1.0, dispatch_time=1.0).run()
        return rep, tokens_of(eng)

    sync_rep, sync_toks = cluster_run(port, False)
    async_rep, async_toks = cluster_run(port, True)
    jrep, _ = cluster_run(jax_, False)
    assert sync_toks == async_toks
    assert async_rep.elapsed < sync_rep.elapsed
    assert sync_rep.elapsed == jrep.elapsed and sync_rep.steps == jrep.steps
    for async_dispatch, rep in ((False, sync_rep), (True, async_rep)):
        solo_rep, solo_toks = solo_run(async_dispatch)
        assert rep.elapsed == solo_rep.elapsed
        assert rep.tokens_generated == solo_rep.tokens_generated
        assert solo_toks == sync_toks


# ---------------------------------------------------------------------------
# Open-loop traffic and the SLO-aware scheduler
# ---------------------------------------------------------------------------


SLO_POLICY = dict(scheduler="drr", shed_busted=True, preempt_busted=True)


def _open_loop(side, policy, *, n=160, rate=40.0, seed=5, sampled=False):
    """A fresh overloaded two-replica cluster (granite, one namespace) and
    a third tenant (stablelm) under a seeded bursty open-loop trace.
    Returns (report, cluster, metrics summary)."""
    cl, clock = side.cluster(pool_pages=64, policy=policy)
    for name in ("rep-a", "rep-b"):
        side.add(cl, name=name, namespace="granite", slots=2,
                 queue_capacity=6, prefill_chunk=4)
    side.add(cl, "stablelm_3b", name="alt", slots=2, queue_capacity=6,
             prefill_chunk=4)
    slo = side.metrics.SLO(ttft=12.0, tpot=4.0)
    sp = side.SamplingParams(0.8, 50, 0.9) if sampled else None
    tenants = [side.load.TenantSpec(engine=name, prompt_len=(4, 10),
                                    new_tokens=(3, 6), prefix_len=4,
                                    prefix_seed=2, slo=slo)
               for name in ("rep-a", "rep-b")]
    tenants.append(side.load.TenantSpec(engine="alt", share=0.5,
                                        prompt_len=(6, 14),
                                        new_tokens=(2, 8), prefix_len=8,
                                        prefix_seed=3, slo=slo,
                                        sampling=sp))
    trace = side.load.open_loop_trace(tenants, n_requests=n, rate=rate,
                                      seed=seed, process="bursty", burst=4)
    rep = side.sim.ClusterSimulator(cl, trace, clock).run()
    m = side.metrics.ServeMetrics()
    for eng in cl.engines.values():
        m.observe_all(eng.completed)
    return rep, cl, m.summary(elapsed=rep.elapsed)


def _rep_fields(rep):
    return (rep.elapsed, rep.steps, rep.tokens_generated, rep.rejected,
            rep.shed, rep.energy_uj,
            {n: [r.id for r in rs] for n, rs in rep.completed.items()})


@pytest.mark.parametrize("policy", ["slo", "wrr"])
def test_open_loop_cluster_equals_the_reference(sides, policy):
    """The headline comparison: 200 bursty open-loop arrivals (a sampled
    tenant among them) through three tenants under the SLO-aware policy
    (DRR, TTFT shed, deadline preempt) and under flat WRR. The
    ``ClusterSimReport``, every counter, every request's timestamps and
    the metrics' summary (TTFT/TPOT percentiles, attainment, goodput,
    joules) equal the JAX cluster's exactly; tokens where margins are
    clear."""
    pol = SLO_POLICY if policy == "slo" else None
    rep, cl, summary = _open_loop(sides[0], pol, n=200, sampled=True)
    jrep, jcl, jsummary = _open_loop(sides[1], pol, n=200, sampled=True)
    assert _rep_fields(rep) == _rep_fields(jrep)
    assert summary == jsummary
    same_cluster(cl, jcl)
    assert rep.rejected > 0
    if policy == "slo":
        assert cl.sheds > 0 and cl.sheds == rep.shed
    hold_cluster_tokens(cl, jcl)


def test_open_loop_same_seed_runs_are_bit_identical(sides):
    first = _open_loop(sides[0], SLO_POLICY)
    second = _open_loop(sides[0], SLO_POLICY)

    def digest(rep, cl, summary):
        toks = {}
        for eng in cl.engines.values():
            toks.update(tokens_of(eng))
        return (_rep_fields(rep), cl.sheds, cl.slo_preempts, summary,
                sorted(toks.items()))

    assert digest(*first) == digest(*second)
    assert first[0].rejected > 0 and first[0].tokens_generated > 0


def test_overload_builds_queues_then_drains_and_slo_beats_wrr(sides):
    """Flat WRR under overload sheds nothing, bounces most arrivals and
    drains; the SLO-aware policy sheds doomed work and turns more of its
    tokens into SLO-met ones (attainment and goodput)."""
    flat_rep, flat_cl, flat = _open_loop(sides[0], None, n=240, rate=60.0)
    assert flat_rep.shed == 0 and flat_cl.sheds == 0
    assert flat_rep.rejected > flat["completed"]
    assert not flat_cl.busy
    assert flat["ttft_p99"] > 3 * flat["ttft_p50"] or flat["ttft_p99"] > 12.0
    slo_rep, slo_cl, slo = _open_loop(sides[0], SLO_POLICY, n=240, rate=60.0)
    assert slo_rep.shed > 0 and slo_cl.sheds == slo_rep.shed
    assert slo["slo_attainment"] > flat["slo_attainment"]
    assert slo["goodput"] > flat["goodput"]


def test_slo_preempt_and_requeue_is_bit_identical(sides):
    """A deadline-busted decode is demoted to the back of the queue,
    journaled, replayed after its followers, and finishes with the tokens
    of an undisturbed run alone; the JAX cluster demotes it alike."""
    runs = {}
    for side in sides:
        cl, clock = side.cluster(policy=dict(preempt_busted=True))
        side.add(cl, name="g", namespace="granite", slots=1)
        doomed = side.Request("long", [3, 4, 5], 16,
                              slo=side.metrics.SLO(ttft=4.0, tpot=0.5))
        reqs = [doomed] + side.requests(2, prompt_len=3, prefix="f")
        side.sim.ClusterSimulator(cl, side.sim.tag_engine(
            side.sim.burst_trace(reqs), "g"), clock).run()
        runs[side.port] = (cl, doomed)
    (cl, doomed), (jcl, _) = runs[True], runs[False]
    assert cl.slo_preempts == 1 and doomed.slo_preempts == 1
    assert cl.journal.journal("g").get("long").slo_preempts == 1
    order = [r.id for r in cl.engines["g"].completed]
    assert order.index("long") > order.index("f0")
    port = sides[0]
    want = port.alone("granite_3_2b", [port.Request("long", [3, 4, 5], 16)]
                      + port.requests(2, prompt_len=3, prefix="f"), slots=1)
    assert tokens_of(cl.engines["g"]) == want
    same_cluster(cl, jcl)


def test_cold_prefill_dedup_across_engines(sides):
    """Two same-namespace replicas given one cold prompt in one burst: the
    table's claims make the second stall on the first's pages and adopt
    them, as the reference's do."""
    runs = {}
    prompt = [(13 * j) % 241 + 1 for j in range(17)]
    for side in sides:
        cl, clock = side.cluster()
        side.add(cl, name="x", namespace="granite", slots=1,
                 prefill_chunk=4)
        side.add(cl, name="y", namespace="granite", slots=1,
                 prefill_chunk=4)
        trace = (side.sim.tag_engine(side.sim.burst_trace(
            [side.Request("xa", prompt, 4)]), "x")
            + side.sim.tag_engine(side.sim.burst_trace(
                [side.Request("yb", prompt, 4)]), "y"))
        side.sim.ClusterSimulator(cl, trace, clock).run()
        runs[side.port] = cl
    cl = runs[True]
    ea, eb = cl.engines["x"], cl.engines["y"]
    assert ea.stalls + eb.stalls > 0
    assert ea.prompt_tokens_processed + eb.prompt_tokens_processed < 34
    assert ea.prompt_tokens_reused + eb.prompt_tokens_reused >= 8
    port = sides[0]
    ref = port.alone("granite_3_2b", [port.Request("xa", prompt, 4)],
                     slots=1, prefill_chunk=4)["xa"]
    assert tokens_of(ea)["xa"] == ref and tokens_of(eb)["yb"] == ref
    same_cluster(cl, runs[False])


def test_occupancy_and_step_cost(sides):
    port = sides[0]
    cl, _ = port.cluster()
    eng = port.add(cl, name="g", slots=3, prefill_chunk=4)
    for r in port.requests(4, prompt_len=6):
        cl.submit("g", r)
    assert eng.occupancy() == {"slots": 3, "active": 0, "slots_free": 3,
                               "queued": 4, "pool_free": 48,
                               "pool_in_use": 0, "pool_pages_held": 0}
    cl.step()
    occ = eng.occupancy()
    assert (occ["active"], occ["queued"]) == (3, 1)
    assert occ["pool_pages_held"] == cl.pool.in_use_by("g") > 0
    assert eng.step_cost() == 3 * 2          # 6-token prompts, 4 fed
    cl.run_until_idle()
    assert eng.step_cost() == 0


def test_drr_lone_head_dearer_than_a_round_raises_as_the_reference(sides):
    """A reference quirk the port keeps (ROADMAP.md queue 3): under deficit
    round-robin an idle tenant starts with no credit and banks quantum x
    weight a round, so a lone head dearer than that stalls a round in
    which nothing else runs, and the cluster reports a budget deadlock in
    both packages; a quantum that covers the head serves it."""
    for side in sides:
        cl, _ = side.cluster(policy=dict(scheduler="drr"))
        side.add(cl, name="g", slots=1)                 # 16 credits a round
        cl.submit("g", side.Request("dear", list(range(1, 15)), 4))
        with pytest.raises(RuntimeError, match="budget deadlock"):
            cl.step()
        cl, _ = side.cluster(policy=dict(scheduler="drr", quantum=32))
        eng = side.add(cl, name="g", slots=1)
        cl.submit("g", side.Request("dear", list(range(1, 15)), 4))
        cl.run_until_idle()
        assert [r.id for r in eng.completed] == ["dear"]
