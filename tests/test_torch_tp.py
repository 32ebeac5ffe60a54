"""The port's tensor-parallel paged serving and replica groups.

One process drives every shard, as the reference's one process drives its
mesh; the meshes here repeat ``"cpu"``, the port's counterpart of the
reference tests' forced host devices (``tests/test_serve_tp.py``). On the
smoke configs in float32 with the JAX package's weights (the embedding
x 10, ``tests/torch_serve.py``):

* inside the port, bit for bit: the tp 2 engine's tokens equal the tp 1
  engine's for every paged config, greedy and two sampled streams, sync
  and async dispatch, with chunked prefill and prefix sharing; tp 4 on
  ``stablelm_3b`` (4 KV heads) too;
* against the JAX package: logits teacher-forced through the port's tp 2
  decode equal the JAX package's paged decode within the parity
  tolerances (float32 2e-5 on float32 pools, bf16 6e-2), and in a child
  process with 2 forced host devices the port's tp 2 engine gives the JAX
  package's tp 2 engine's tokens where the margins are clear;
* the layout: wq/wk/wv split into contiguous head slices, the other
  leaves placed once a distinct device, the placement cache, one arena of
  Kh/tp heads a shard (bytes per mesh position 1/tp of tp 1's), the paged
  op called layers x tp times a one-token step at (B, H/tp, D) on
  (., Kh/tp, D) pages;
* the rejections, with the reference's messages: Kh not divisible by tp,
  the lane families, MQA, tp < 1, ``paged=False``;
* replica groups: a 2 x tp 2 group equals the standalone engine bit for
  bit, homes a shared prefix on one member, repeats itself on a second
  drive; a mid-flight drain migrates losslessly and evicts the victim's
  namespace; a crash rebuild keeps the member's mesh.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.models import transformer as jtransformer
from torch_serve import tokens_of, weights

torch = E = C = paged = sim = transformer = registry = None  # by _port
mesh_mod = SamplingParams = REGISTRY = None

TESTS = str(pathlib.Path(__file__).resolve().parent)
PAGED = [a for a in jconfigs.names()
         if jreg.supports_paged(jconfigs.smoke(a))]
UNPAGED = [a for a in jconfigs.names()
           if not jreg.supports_paged(jconfigs.smoke(a))]
ENGINE = dict(slots=2, max_len=32, page_size=4, prefill_chunk=2)


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file (see ``tests/test_torch_engine.py``)."""
    global torch, E, C, paged, sim, transformer, registry, mesh_mod
    global SamplingParams, REGISTRY
    torch = pytest.importorskip("torch")
    from repro_torch.core.xaif import REGISTRY
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import registry, transformer
    from repro_torch.serve import cluster as C
    from repro_torch.serve import engine as E
    from repro_torch.serve import paged, sim
    from repro_torch.serve.sampling import SamplingParams
    torch.set_num_threads(1)


def cpu_mesh(tp: int):
    return mesh_mod.serve_tp_mesh(tp, ["cpu"] * tp)


def requests(vocab: int):
    """Four requests, two of them sampled (``tests/test_serve_tp.py``'s
    streams), two sharing a page of prompt."""
    rng = np.random.default_rng(3)
    shared = [int(t) for t in rng.integers(1, vocab, 4)]
    prompts = [shared + [int(t) for t in rng.integers(1, vocab, 1 + i)]
               for i in range(2)]
    prompts += [[int(t) for t in rng.integers(1, vocab, 5)] for _ in range(2)]
    reqs = [E.Request(f"r{i}", p, 4) for i, p in enumerate(prompts)]
    reqs[1].sampling = SamplingParams(temperature=0.8, top_p=0.9, seed=7)
    reqs[3].sampling = SamplingParams(temperature=1.1, top_k=5, seed=11)
    return reqs


def serve(cfg, params, mesh=None, **kw):
    """(engine, tokens by id) of :func:`requests` served to the end."""
    eng = E.ContinuousBatchingEngine(cfg, params, device="cpu", mesh=mesh,
                                     **{**ENGINE, **kw})
    for r in requests(cfg.vocab):
        assert eng.submit(r)
    eng.run_until_idle()
    return eng, tokens_of(eng)


@pytest.fixture
def count_paged():
    """Every call of op ``"paged_attention"`` under ``"cuda"`` (the plain
    version here), as (q shape, pool shape), while the test runs."""
    spec = REGISTRY.get("paged_attention", "cuda")
    calls = []

    def counted(q, k_pool, *args, **kw):
        calls.append((tuple(q.shape), tuple(k_pool.shape)))
        return spec.fn(q, k_pool, *args, **kw)

    REGISTRY.register(dataclasses.replace(spec, fn=counted),
                      allow_override=True)
    try:
        yield calls
    finally:
        REGISTRY.register(spec, allow_override=True)


# -- tp against tp 1, bit for bit -------------------------------------------


@pytest.mark.parametrize("async_dispatch", [False, True],
                         ids=["sync", "async"])
@pytest.mark.parametrize("arch", PAGED)
def test_tp2_bit_identical_to_tp1(arch, async_dispatch):
    """Greedy and two sampled streams, chunked prefill, a shared page of
    prompt: the head-sharded engine gives the one-device engine's tokens
    bit for bit (``tests/test_serve_tp.py:44-75`` on the port)."""
    _, _, cfg, params = weights(arch)
    one, want = serve(cfg, params, async_dispatch=async_dispatch)
    two, got = serve(cfg, params, cpu_mesh(2), async_dispatch=async_dispatch)
    assert got == want and len(want) == 4
    assert two.tp == 2 and one.tp == 1
    for key in ("steps", "token_steps", "prompt_tokens_reused", "stalls"):
        assert two.stats()[key] == one.stats()[key], key


@pytest.mark.parametrize("async_dispatch", [False, True],
                         ids=["sync", "async"])
def test_tp4_bit_identical_on_four_kv_heads(async_dispatch):
    _, _, cfg, params = weights("stablelm_3b")
    assert cfg.n_kv_heads == 4
    _, want = serve(cfg, params, async_dispatch=async_dispatch)
    eng, got = serve(cfg, params, cpu_mesh(4), async_dispatch=async_dispatch)
    assert got == want and eng.tp == 4


def test_preempted_tp_engine_replays_bit_for_bit():
    """A tp 2 engine preempted mid-flight replays its requests, checked
    token by token against its journal, to the undisturbed tokens."""
    _, _, cfg, params = weights("granite_3_2b")
    _, want = serve(cfg, params, cpu_mesh(2), async_dispatch=True)
    eng = E.ContinuousBatchingEngine(cfg, params, device="cpu",
                                     mesh=cpu_mesh(2), async_dispatch=True,
                                     **ENGINE)
    for r in requests(cfg.vocab):
        eng.submit(r)
    for _ in range(5):
        eng.step()
    assert eng.preempt()
    eng.run_until_idle()
    assert tokens_of(eng) == want


def test_paged_calls_run_per_shard(count_paged):
    """layers x tp paged calls a one-token step, each on one shard's
    heads: q (B, H/tp, D) against (P, ps, Kh/tp, D) pages."""
    _, _, cfg, params = weights("stablelm_3b")
    for tp in (1, 2, 4):
        count_paged.clear()
        eng, _ = serve(cfg, params, cpu_mesh(tp) if tp > 1 else None,
                       prefill_chunk=1)
        steps = eng.stats()["token_steps"]
        assert len(count_paged) == cfg.n_layers * tp * steps
        d = cfg.resolved_head_dim
        qs = {q for q, _ in count_paged}
        pools = {p[1:] for _, p in count_paged}
        assert qs == {(eng.n_lanes, cfg.n_heads // tp, d)}
        assert pools == {(ENGINE["page_size"], cfg.n_kv_heads // tp, d)}


# -- tp against the JAX package ---------------------------------------------


def forced(jcfg, jparams, cfg, params, seqs, dtype, tp):
    """Logits of ``seqs`` teacher-forced through the JAX package's paged
    decode (one device) and the port's tp ``tp`` decode, on pools of
    ``dtype`` in both: (steps, lanes, vocab) each, and the mask of the
    steps each lane takes."""
    b, n, ps = len(seqs), max(len(s) for s in seqs), 4
    per = -(-n // ps)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jk, jv = jtransformer.paged_pool_init(jcfg, b * per + 1, ps, dtype=jdt)
    shards = paged.place_params(cfg, params, cpu_mesh(tp))
    pools = [transformer.paged_pool_init(cfg, b * per + 1, ps, dtype=dtype,
                                         device="cpu", tp=tp)
             for _ in range(tp)]
    pk, pv = [k for k, _ in pools], [v for _, v in pools]
    tables = np.arange(b * per, dtype=np.int32).reshape(b, per)
    step = jax.jit(lambda k, v, t, ln, tok, m: jreg.decode_step_paged(
        jparams, jcfg, k, v, t, ln, tok, append_mask=m))
    want, got, masks = [], [], []
    for t in range(n - 1):
        tok = np.array([s[t] if t < len(s) else 0 for s in seqs], np.int32)
        mask = np.array([t < len(s) - 1 for s in seqs])
        lengths = np.full((b,), t, np.int32)
        logits, jk, jv = step(jk, jv, tables, lengths, tok, mask)
        want.append(np.asarray(logits, np.float32))
        with torch.inference_mode():
            got.append(registry.decode_step_paged(
                shards, cfg, pk, pv, torch.from_numpy(tables),
                torch.from_numpy(lengths), torch.from_numpy(tok),
                append_mask=torch.from_numpy(mask))[0].float().numpy())
        masks.append(mask)
    return np.stack(want), np.stack(got), np.stack(masks)


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in PAGED]
                         + [("granite_3_2b", "bfloat16"),
                            ("h2o_danube3_4b", "bfloat16")])
def test_tp2_teacher_forced_logits_match_jax(arch, dtype):
    jcfg, jparams, cfg, params = weights(arch)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    rng = np.random.default_rng(5)
    seqs = [[int(t) for t in rng.integers(1, cfg.vocab, n)]
            for n in (12, 19, 7)]
    tdt = getattr(torch, dtype)
    jl, tl, mask = forced(jcfg, jparams, cfg, params, seqs, tdt, 2)
    tol = {"float32": 2e-5, "bfloat16": 6e-2}[dtype]
    err = np.abs(jl - tl)[mask].max()
    assert err < tol * max(1.0, np.abs(jl[mask]).max()), err


_JAX_TP2 = """
import sys
sys.path.insert(0, {tests!r})
import jax
assert len(jax.devices()) == 2, jax.devices()
import torch
torch.set_num_threads(1)
from repro.launch.mesh import serve_tp_mesh as jmesh
from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.launch.mesh import serve_tp_mesh
from repro_torch.serve.engine import ContinuousBatchingEngine, Request
from torch_serve import hold_tokens, tokens_of, weights

model = weights("granite_3_2b")
jcfg, jparams, cfg, params = model
rows = [(f"r{{i}}", [(7 * i + j) % 251 + 1 for j in range(5 + i)], 5)
        for i in range(4)]
kw = dict(slots=2, max_len=32, page_size=4, prefill_chunk=2)
jeng = JaxEngine(jcfg, jparams, mesh=jmesh(2), **kw)
assert jeng.tp == 2
for r in rows:
    assert jeng.submit(JaxRequest(*r))
jeng.run_until_idle()
for async_dispatch in (False, True):
    eng = ContinuousBatchingEngine(cfg, params, device="cpu",
                                   mesh=serve_tp_mesh(2, ["cpu"] * 2),
                                   async_dispatch=async_dispatch, **kw)
    for r in rows:
        assert eng.submit(Request(*r))
    eng.run_until_idle()
    hold_tokens(model, jeng, tokens_of(eng), 32)
    assert eng.steps == jeng.steps, (eng.steps, jeng.steps)
print("PORT_TP2_HELD")
"""


def test_tp2_engine_held_to_jax_tp2_engine(subproc):
    """In a child process with 2 forced host devices: the JAX package's
    tp 2 engine (``shard_map`` over a real 2-device mesh) and the port's
    tp 2 engine, sync and async, give the same tokens where the margins
    are clear, on the same schedule."""
    out = subproc(_JAX_TP2.format(tests=TESTS), devices=2)
    assert "PORT_TP2_HELD" in out


# -- layout -----------------------------------------------------------------


def test_placement_splits_heads_and_shares_replicated_leaves():
    _, _, cfg, params = weights("granite_3_2b")
    mesh = cpu_mesh(2)
    shards = paged.place_params(cfg, params, mesh)
    assert paged.place_params(cfg, params, mesh) is shards       # cached
    a0, a1 = (s["blocks"]["l0"]["attn"] for s in shards)
    full = params["blocks"]["l0"]["attn"]
    for name, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                        ("wv", cfg.n_kv_heads)):
        n = heads // 2
        assert a0[name].is_contiguous() and a1[name].is_contiguous()
        assert torch.equal(a0[name], full[name][:, :, :n])
        assert torch.equal(a1[name], full[name][:, :, n:])
    # replicated leaves: on their own device they are the leaves themselves
    assert a0["wo"] is full["wo"] and a1["wo"] is full["wo"]
    assert shards[0]["embed"] is shards[1]["embed"] is params["embed"]
    # a recycled id() never returns another tree's placement
    other = weights("granite_3_2b", seed=1)[3]
    key = (id(other), mesh, "model")
    saved = paged._PLACED_PARAMS.get(key)
    paged._PLACED_PARAMS[key] = (params, shards)
    try:
        placed = paged.place_params(cfg, other, mesh)
        assert placed is not shards
        assert placed[0]["embed"] is other["embed"]
    finally:
        paged._PLACED_PARAMS.pop(key)
        if saved is not None:
            paged._PLACED_PARAMS[key] = saved


@pytest.mark.parametrize("tp", [2, 4])
def test_arena_splits_kv_heads(tp):
    """Every mesh position holds Kh/tp heads of every page: its bytes are
    1/tp of the one-device arena's, under ``"cpu#i"`` keys."""
    _, _, cfg, _ = weights("stablelm_3b")
    one = paged.PagePool(8, 4)
    one.arena(cfg, "cpu")
    whole = one.bytes_by_device()["cpu"]
    pool = paged.PagePool(8, 4)
    mesh = cpu_mesh(tp)
    arena = pool.arena(cfg, mesh)
    assert pool.arena(cfg, cpu_mesh(tp)) is arena     # equal meshes, one arena
    assert arena.mesh == mesh and len(arena.k) == tp
    assert all(t.shape[3] == cfg.n_kv_heads // tp for t in arena.k + arena.v)
    assert pool.bytes_by_device() == {f"cpu#{i}": whole // tp
                                      for i in range(tp)}
    assert pool.device_pages == 9


def test_engine_arena_and_stats_on_a_mesh():
    _, _, cfg, params = weights("granite_3_2b")
    eng, _ = serve(cfg, params, cpu_mesh(2))
    assert eng.stats()["tp"] == 2 and eng.device == torch.device("cpu")
    assert isinstance(eng._arena.k, list) and len(eng._arena.k) == 2
    assert set(eng._pool.bytes_by_device()) == {"cpu#0", "cpu#1"}


# -- rejections -------------------------------------------------------------


def test_indivisible_kv_heads_rejected():
    _, _, cfg, params = weights("granite_3_2b")
    assert cfg.n_kv_heads == 2
    with pytest.raises(ValueError, match=r"n_kv_heads 2 % tp 4 != 0"):
        E.ContinuousBatchingEngine(cfg, params, device="cpu",
                                   mesh=cpu_mesh(4), **ENGINE)


@pytest.mark.parametrize("arch", UNPAGED)
def test_lane_families_rejected(arch):
    """MoE, SSM and hybrid configs raise the reference's error at
    construction, never a quiet fall back to lanes."""
    from repro_torch import configs
    from repro_torch.sharding.params import init_tree

    cfg = configs.smoke(arch)
    params = init_tree(registry.decls(cfg), 0, "cpu")
    for paged_arg in (None, False):
        with pytest.raises(ValueError, match="cannot serve tensor-parallel"):
            E.ContinuousBatchingEngine(cfg, params, slots=2, max_len=32,
                                       device="cpu", mesh=cpu_mesh(2),
                                       paged=paged_arg)


def test_mqa_tp_below_one_and_lanes_rejected():
    _, _, cfg, params = weights("granite_3_2b")
    mqa = dataclasses.replace(cfg, n_kv_heads=1, n_heads=4)
    with pytest.raises(ValueError, match="MQA has a single shared KV head"):
        paged.place_params(mqa, params, cpu_mesh(2))
    with pytest.raises(ValueError, match="tp must be >= 1"):
        paged.place_params(cfg, params,
                           mesh_mod.make_mesh((0,), ("model",), []))
    with pytest.raises(ValueError, match="paged-backend feature"):
        E.ContinuousBatchingEngine(cfg, params, slots=2, max_len=32,
                                   device="cpu", mesh=cpu_mesh(2),
                                   paged=False)
    grid = mesh_mod.make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    with pytest.raises(ValueError, match="every other axis"):
        paged.place_params(cfg, params, grid)


# -- replica groups ---------------------------------------------------------


ARCH = "granite_3_2b"
GROUP = dict(slots=3, max_len=40, lane_batch=4, device_len=48)


def group_requests():
    """Six requests sharing a 16-token prefix and six distinct ones, every
    second distinct one sampled (``tests/test_serve_tp.py``'s trace)."""
    shared = sim.shared_prefix_requests(6, prefix_len=16, tail_len=3,
                                        new_tokens=5, id_prefix="s")
    distinct = [E.Request(f"d{i}", [(7 * i + j) % 251 + 1 for j in range(5)],
                          5) for i in range(6)]
    for r in distinct[::2]:
        r.sampling = SamplingParams(temperature=0.9, top_k=7)
    return shared + distinct


def standalone():
    _, _, cfg, params = weights(ARCH)
    clock = sim.FakeClock()
    eng = E.ContinuousBatchingEngine(cfg, params, device="cpu", clock=clock,
                                     page_size=8, **GROUP)
    sim.Simulator(eng, sim.burst_trace(group_requests()), clock).run()
    return tokens_of(eng)


def group_cluster(name="gran", slots=3):
    _, _, cfg, params = weights(ARCH)
    clock = sim.FakeClock()
    cl = C.ServeCluster(pool_pages=96, page_size=8, clock=clock,
                        device="cpu")
    members = cl.add_replica_group(
        cfg, params, name=name, meshes=mesh_mod.replica_meshes(
            2, 2, ["cpu"] * 4), **{**GROUP, "slots": slots})
    return cl, clock, members


def test_replica_group_bit_identical_and_split():
    """2 x tp 2 replicas behind one group name: the standalone engine's
    tokens, both replicas served, the shared prefix homed on one member,
    every member tp 2, and the same trace driven twice lands every
    request on the same member with the same tokens."""
    want = standalone()

    def drive():
        cl, clock, members = group_cluster()
        trace = sim.tag_engine(sim.burst_trace(group_requests()), "gran")
        sim.ClusterSimulator(cl, trace, clock).run()
        toks = {}
        for n in members:
            toks.update(tokens_of(cl.engines[n]))
        by_member = {n: sorted(r.id for r in cl.engines[n].completed)
                     for n in members}
        return cl, members, toks, by_member

    cl, members, got, by_member = drive()
    assert got == want
    assert all(by_member.values()), by_member
    homes = [n for n, ids in by_member.items()
             if any(i.startswith("s") for i in ids)]
    assert len(homes) == 1, by_member
    assert cl.targets == {"gran", *members}
    assert {cl.engines[n].tp for n in members} == {2}
    assert cl.stats()["groups"] == {"gran": members}
    # one mesh of repeated devices for both members: one split arena
    assert set(cl.pool.bytes_by_device()) == {"cpu#0", "cpu#1"}
    _, _, got2, by_member2 = drive()
    assert got2 == got and by_member2 == by_member


def test_drain_replica_migrates_bit_identically():
    """Mid-flight drain: the victim's journal records and queue move to
    the sibling, every migrated request finishes with the standalone
    tokens, and the victim's namespace is evicted."""
    want = standalone()
    cl, clock, members = group_cluster("g2", slots=2)
    for r in group_requests():
        r.arrival_time = clock.t
        assert cl.submit("g2", r)
    for _ in range(4):
        cl.step()
    victim = members[0]
    pre_done = {r.id for r in cl.engines[victim].completed}
    moved = cl.drain_replica("g2", victim)
    assert victim not in cl.engines
    assert victim not in cl.stats()["groups"]["g2"]
    assert cl.migrations > 0 and sum(len(v) for v in moved.values()) > 0
    cl.run_until_idle()
    got = tokens_of(cl.engines[members[1]])
    for rid in pre_done:
        got.setdefault(rid, want[rid])
    assert got == want
    assert not any(ns.endswith("@r0") for ns in cl.table.resident_by_ns())
    assert cl.targets == {"g2", members[1]}


def test_crash_rebuild_keeps_the_member_mesh():
    cl, clock, members = group_cluster()
    for r in group_requests():
        r.arrival_time = clock.t
        assert cl.submit("gran", r)
    for _ in range(3):
        cl.step()
    old = cl.engines[members[1]]
    new = cl.crash_engine(members[1])
    assert new is not old and new.mesh is old.mesh and new.tp == 2
    assert new._arena is old._arena
    cl.run_until_idle()
    got = {}
    for n in members:
        got.update(tokens_of(cl.engines[n]))
    assert got == standalone()
