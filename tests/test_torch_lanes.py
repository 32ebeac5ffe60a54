"""The port engine's lane backend: against the JAX engine's, and against
itself.

On the granite, h2o-danube (sliding window: the lane cache is a ring),
grok-1 (every layer MoE, top-2), llama4 (MoE every second layer, top-1,
shared expert), mamba2 and recurrentgemma (RG-LRU and a local-attention
ring) smoke configs in their own dtype (bf16), with the JAX package's
weights carried across (the attention at its true fan-in and the embedding
x 10, as ``tests/test_torch_transformer.py`` and
``tests/test_torch_mamba2.py`` set them up), on a staggered trace of six
requests sharing a 9-token prefix (two 4-token pages):

* teacher-forced, each request in a lane of its own joining at its own
  step (so the lanes sit at different positions), the port's lane decode
  gives the JAX decode's logits within 6e-2 (``ROADMAP.md``'s bf16 parity
  bound) at every position;
* the port's lane engine (prefill chunk 1 and 4) gives the JAX engine's
  completions (``paged=False``, sync dispatch) wherever the reference's
  top-1/top-2 margin is clear of the difference between the packages:
  each request equals the reference's up to its first step whose margin
  is not above twice that step's largest logit difference plus a bf16
  ulp, and at least a third of all emitted steps get there;
* inside the port, bit for bit: chunked prefill equals unchunked, metered
  equals unmetered, lanes padded by ``lane_batch``/``device_len`` equal
  unpadded ones (and their logits agree within 2e-5), granite on lanes
  equals granite on the paged backend, and a lane meter equals the
  reference's (lanes never stall on a sibling, so both engines schedule
  alike);
* the port's three hazards: a lane masked in a chunk step keeps its KV
  ring, SSM state and RG-LRU state bit for bit; a published snapshot is a
  copy that later steps leave alone; and lane-wise MoE routing drops no
  slot at 16 lanes where the batched ``layers.moe`` drops, its packed
  (E, 16, d) call equal to routing each lane alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import registry as jreg
from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.sharding import params as JP

torch = configs = params_from_numpy = registry = None  # bound by _port
griffin = transformer = L = engine_mod = None
ContinuousBatchingEngine = Request = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, configs, params_from_numpy, registry, griffin, transformer
    global L, engine_mod, ContinuousBatchingEngine, Request
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import griffin, registry, transformer
    from repro_torch.models import layers as L
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request
    torch.set_num_threads(1)


ARCHS = ["granite_3_2b", "h2o_danube3_4b", "grok_1_314b",
         "llama4_maverick_400b", "mamba2_370m", "recurrentgemma_2b"]
TOL = 6e-2                       # bf16 logits, ROADMAP.md's parity bound
SLOTS, MAX_LEN, PS = 3, 32, 4
ARRIVALS = (0, 0, 0, 0, 3, 5)    # the step at which each request arrives


def _weights(arch):
    """(jax cfg, jax params, port cfg, port params): the JAX package's init
    from key 1 in the smoke config's dtype, the attention at its true
    fan-in and the embedding x 10, in both packages."""
    jcfg, cfg = jconfigs.smoke(arch), configs.smoke(arch)
    jparams = JP.init_tree(jreg.decls(jcfg), jax.random.key(1))
    if cfg.dtype == "bfloat16":
        jparams = JP.cast_tree(jparams, jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jparams)
    if cfg.family == "hybrid":
        scaled = griffin.true_fan_in(tree, cfg)
    elif cfg.family == "ssm":
        scaled = dict(tree)
    else:
        scaled = transformer.true_fan_in(tree, cfg)
    scaled["embed"] = scaled["embed"] * 10.0
    tree = jax.tree.map(lambda new, old: np.asarray(new).astype(old.dtype),
                        scaled, tree)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, params_from_numpy(
        tree, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _weights(request.param)


def trace():
    """Six requests sharing a 9-token prefix (two full 4-token pages)."""
    rng = np.random.default_rng(2)
    prefix = [int(t) for t in rng.integers(1, 256, 9)]
    return [(f"r{i}", prefix + [int(t) for t in rng.integers(1, 256, 1 + i % 4)],
             4 + i % 3) for i in range(6)]


def drive(eng, make_request, reqs=None):
    """Submit each request of ``reqs`` (default :func:`trace`) at its step
    of ``ARRIVALS`` and step ``eng`` until it is idle with nothing left to
    arrive; returns the completions by id."""
    pending = list(zip(ARRIVALS, reqs or trace()))
    step = 0
    while True:
        while pending and pending[0][0] <= step:
            assert eng.submit(make_request(*pending.pop(0)[1]))
        if not eng.step() and not pending:
            break
        step += 1
    return {r.id: tuple(r.tokens) for r in eng.completed}


def run_port(cfg, params, **kw):
    kw = {"slots": SLOTS, "max_len": MAX_LEN, "page_size": PS,
          "prefill_chunk": 4, "paged": False, **kw}
    eng = ContinuousBatchingEngine(cfg, params, device="cpu", **kw)
    return eng, drive(eng, Request)


@pytest.fixture(scope="module")
def jax_completions(model):
    """The JAX engine on lanes (sync dispatch) on the staggered trace."""
    jcfg, jparams, _, _ = model
    jeng = JaxEngine(jcfg, jparams, slots=SLOTS, max_len=MAX_LEN,
                     page_size=PS, prefill_chunk=4, async_dispatch=False,
                     paged=False)
    want = drive(jeng, JaxRequest)
    assert jeng.stats()["backend"] == "lanes"
    assert jeng.stats()["prompt_tokens_reused"] > 0
    return want


def teacher_forced(model, seqs):
    """Every sequence teacher-forced in a lane of its own of one port lane
    cache, lane b joining at step b (so the lanes sit at different
    positions; a lane not yet joined or done is masked with ``keep``), and
    through the JAX decode in a batch-1 cache of its own (the reference
    engine's ``vmap`` lane). Returns per lane the (steps, vocab) logits of
    both packages, the step t predicting ``seq[t + 1]``."""
    jcfg, jparams, cfg, params = model
    n = len(seqs)
    lens = np.array([len(s) - 1 for s in seqs])
    cache = registry.cache_init(cfg, n, MAX_LEN, device="cpu", lanes=True)
    jcaches = [jreg.cache_init(jcfg, 1, MAX_LEN) for _ in seqs]
    jstep = jax.jit(lambda c, t: jreg.decode_step(jparams, jcfg, c, t))
    want = [[] for _ in seqs]
    got = [[] for _ in seqs]
    for t in range(int((lens + np.arange(n)).max())):
        pos = t - np.arange(n)
        fed = (pos >= 0) & (pos < lens)
        toks = np.array([s[p] if f else 0 for s, p, f in zip(seqs, pos, fed)],
                        np.int32)
        with torch.inference_mode():
            logits, _ = registry.decode_step(params, cfg, cache,
                                             torch.from_numpy(toks)[:, None],
                                             keep=torch.from_numpy(fed))
        for b in np.flatnonzero(fed):
            jl, jcaches[b] = jstep(jcaches[b], toks[b:b + 1, None])
            want[b].append(np.asarray(jl[0], np.float32))
            got[b].append(logits[b].float().numpy())
    assert [int(p) for p in cache.pos] == list(lens)
    return [np.stack(w) for w in want], [np.stack(g) for g in got]


@pytest.mark.parametrize("chunk", [1, 4])
def test_lane_engine_matches_the_jax_engine(model, jax_completions, chunk):
    _, _, cfg, params = model
    reqs = trace()
    want = jax_completions
    eng, got = run_port(cfg, params, prefill_chunk=chunk)
    assert sorted(got) == sorted(want) == [r[0] for r in reqs]
    st = eng.stats()
    assert st["backend"] == "lanes" and st["table_entries_per_slot"] is None
    assert st["prompt_tokens_reused"] > 0 and st["pages"]["cow_copies"] > 0
    assert "pool" not in st

    seqs = [list(r[1]) + list(want[r[0]]) for r in reqs]
    jl, tl = teacher_forced(model, seqs)
    clear_steps = 0
    for (rid, prompt, n_new), w, g in zip(reqs, jl, tl):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                   err_msg=f"{cfg.name} {rid}")
        # a step's margin is clear when it exceeds twice the two packages'
        # largest logit difference at that step plus one bf16 ulp of the
        # top logit (the port's own rounding on another batch of lanes)
        first = len(prompt) - 1
        top2 = np.sort(w[first:], -1)[:, -2:]
        gap = np.abs(g - w)[first:].max(-1)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(top2[:, 1]))) - 7)
        clear = top2[:, 1] - top2[:, 0] > 2 * gap + ulp
        k = n_new if clear.all() else int(np.argmin(clear))
        clear_steps += k
        assert got[rid][:k] == want[rid][:k], (cfg.name, rid, k)
    assert clear_steps >= sum(r[2] for r in reqs) // 3, clear_steps


def test_teacher_forced_lanes_keep_their_own_positions(model):
    """The staggered teacher-forcing's lanes sit at other positions in one
    step, masked lanes among them: each lane's logits equal, bit for bit,
    those of the same sequence fed to every lane of a cache of as many
    lanes in step (rows of a batched step do not depend on each other)."""
    _, _, cfg, params = model
    seqs = [list(r[1]) + [7, 8, 9] for r in trace()[:3]]
    _, together = teacher_forced(model, seqs)
    for seq, rows in zip(seqs, together):
        cache = registry.cache_init(cfg, len(seqs), MAX_LEN, device="cpu",
                                    lanes=True)
        aligned = []
        with torch.inference_mode():
            for tok in seq[:-1]:
                logits, _ = registry.decode_step(
                    params, cfg, cache, torch.full((len(seqs), 1), tok))
                aligned.append(logits[0].float().numpy())
        np.testing.assert_array_equal(rows, np.stack(aligned), cfg.name)


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------


def test_chunked_prefill_is_bitwise_unchunked(model):
    _, _, cfg, params = model
    _, chunked = run_port(cfg, params, prefill_chunk=4)
    _, unchunked = run_port(cfg, params, prefill_chunk=1)
    assert chunked == unchunked


def test_metering_never_changes_lane_tokens(model):
    _, _, cfg, params = model
    metered, got = run_port(cfg, params)
    plain, want = run_port(cfg, params, metered=False)
    assert got == want
    en = metered.stats()["energy"]
    per_request = sum(r.energy_uj for r in metered.completed)
    assert abs(en["total_uj"] - en["attributed_uj"] - en["overhead_uj"]) \
        <= 1e-12 * en["total_uj"]
    assert abs(en["attributed_uj"] - per_request) <= 1e-9 * per_request
    assert "energy" not in plain.stats()


@pytest.mark.parametrize("arch", ["granite_3_2b", "grok_1_314b",
                                  "mamba2_370m", "recurrentgemma_2b"])
def test_padded_lanes_equal_unpadded(arch):
    """``lane_batch=8`` with 2 slots (6 lanes riding idle) and
    ``device_len=48`` give the 2-lane engine's tokens bit for bit, and the
    two lanes' logits of one teacher-forced step agree within 2e-5 (the
    batch of 8 may sum its products in another order)."""
    cfg = configs.smoke(arch)
    from repro_torch.sharding.params import init_tree
    params = init_tree(registry.decls(cfg), 0, "cpu")
    kw = {"slots": 2, "max_len": MAX_LEN, "page_size": PS, "prefill_chunk": 4,
          "paged": False}
    plain = ContinuousBatchingEngine(cfg, params, device="cpu", **kw)
    padded = ContinuousBatchingEngine(cfg, params, device="cpu", lane_batch=8,
                                      device_len=48, **kw)
    assert (plain.n_lanes, padded.n_lanes) == (2, 8)
    assert padded.device_len == 48
    assert drive(padded, Request) == drive(plain, Request)

    seq = trace()[0][1]
    logits = []
    for lanes, dlen in ((2, MAX_LEN), (8, 48)):
        cache = registry.cache_init(cfg, lanes, dlen, device="cpu", lanes=True)
        with torch.inference_mode():
            for tok in seq:
                out, _ = registry.decode_step(
                    params, cfg, cache, torch.full((lanes, 1), tok))
        logits.append(out[:2].float())
    torch.testing.assert_close(logits[1], logits[0], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("chunk", [1, 4])
def test_granite_lanes_equal_paged(chunk):
    """Paged ≡ lanes (``tests/test_engine.py:328``): granite's tokens on
    the lane backend equal the paged backend's, and the paged backend's
    with its block tables padded by ``lane_batch`` and ``device_len``."""
    _, _, cfg, params = _weights("granite_3_2b")
    _, lanes = run_port(cfg, params, prefill_chunk=chunk)
    paged, want = run_port(cfg, params, prefill_chunk=chunk, paged=None)
    assert paged.stats()["backend"] == "paged"
    assert lanes == want
    padded, on_padded = run_port(cfg, params, prefill_chunk=chunk,
                                 paged=True, lane_batch=8, device_len=48)
    assert padded.stats()["table_entries_per_slot"] == 48 // PS
    assert on_padded == want


def test_lane_meter_matches_the_reference_engine():
    """On lanes the reference engine never stalls a slot on a sibling, so
    it schedules the trace as the port does: equal counters, tokens and
    joules (every total and every ``Request.energy_uj`` within 1e-12
    relative), interrupts and bank states."""
    jcfg, jparams, cfg, params = _weights("grok_1_314b")
    now = [0.0]
    clock = lambda: now[0]
    kw = {"slots": SLOTS, "max_len": MAX_LEN, "page_size": PS,
          "prefill_chunk": 4, "paged": False, "clock": clock}
    jeng = JaxEngine(jcfg, jparams, async_dispatch=False, **kw)
    eng = ContinuousBatchingEngine(cfg, params, device="cpu", **kw)
    done = []
    for e, make in ((jeng, JaxRequest), (eng, Request)):
        now[0] = 0.0
        reqs = [make(*r) for r in trace()]
        for r in reqs:
            assert e.submit(r)
        while e.step():
            now[0] += 0.25
        done.append(reqs)
    js, st = jeng.stats(), eng.stats()
    for key in ("steps", "tokens_generated", "prompt_tokens_processed",
                "prompt_tokens_reused"):
        assert st[key] == js[key], key
    assert st["pages"]["cow_copies"] == js["pages"]["cow_copies"] > 0
    want, got = js["energy"], st["energy"]
    for key, value in want.items():
        if key != "point":
            assert abs(got[key] - value) <= 1e-12 * max(abs(value), 1e-300), key
    for jr, r in zip(*done):
        assert r.tokens == jr.tokens
        assert abs(r.energy_uj - jr.energy_uj) <= 1e-12 * jr.energy_uj
    assert eng.platform.interrupts.counts == jeng.platform.interrupts.counts
    assert {k: v.value for k, v in eng.platform.power.states.items()} == \
        {k: v.value for k, v in jeng.platform.power.states.items()}


def test_lane_cache_is_copies_of_the_template():
    cfg = configs.smoke("mamba2_370m")
    one = registry.cache_init(cfg, 1, MAX_LEN, device="cpu")
    one.state.normal_()
    one.pos = torch.tensor(5, dtype=torch.int32)
    cache = registry.cache_init(cfg, 3, MAX_LEN, device="cpu", lanes=True)
    assert tuple(cache.pos.shape) == (3,) and cache.state.shape[1] == 3
    registry.lane_write(cache, 1, one)
    back = registry.lane_read(cache, 1)
    assert torch.equal(back.state, one.state) and int(back.pos) == 5
    assert back.pos.dim() == 0
    assert torch.equal(cache.state[:, 0], torch.zeros_like(cache.state[:, 0]))
    back.state.add_(1.0)                     # a copy: the lane is untouched
    assert torch.equal(cache.state[:, 1:2], one.state)
    assert registry.cache_bytes(one) == sum(
        t.numel() * t.element_size()
        for t in (one.conv_x, one.conv_B, one.conv_C, one.state, one.pos))


# ---------------------------------------------------------------------------
# The three hazards of an in-place port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "mamba2_370m",
                                  "recurrentgemma_2b"])
def test_masked_lane_is_untouched_by_a_chunk_step(arch):
    """Lane 1 is masked (count 0) through a chunk step that feeds lanes 0
    and 2: its every field (KV ring past its window, SSM state and conv
    tails, RG-LRU state) stays bit for bit; lane 2, fed 2 of the 4
    iterations, equals two plain steps of a copy of the cache."""
    cfg = configs.smoke(arch)
    from repro_torch.sharding.params import init_tree
    params = init_tree(registry.decls(cfg), 0, "cpu")
    cache = registry.cache_init(cfg, 3, MAX_LEN, device="cpu", lanes=True)
    rng = np.random.default_rng(3)
    with torch.inference_mode():
        for _ in range(20):              # past the smoke windows of 16
            registry.decode_step(params, cfg, cache, torch.from_numpy(
                rng.integers(0, cfg.vocab, (3, 1))))
        before = registry.lane_read(cache, 1)
        twin = type(cache)(**{f.name: getattr(cache, f.name).clone()
                              for f in dataclasses.fields(cache)})
        toks = rng.integers(0, cfg.vocab, (3, 4)).astype(np.int32)
        step = engine_mod.lane_chunk_fn(cfg, 4)
        greedy = np.zeros((3,), np.float32)
        nxt, _ = step(params, cache, toks, np.array([4, 0, 2], np.int32),
                      np.zeros((3,), bool), None, np.ones((3,), bool),
                      torch.zeros((3, 2), dtype=torch.int64), greedy,
                      np.zeros((3,), np.int32), np.ones((3,), np.float32))
        for j in range(2):
            logits, _ = registry.decode_step(params, cfg, twin,
                                             torch.from_numpy(toks[:, j:j + 1]))
    after = registry.lane_read(cache, 1)
    lane2, want2 = registry.lane_read(cache, 2), registry.lane_read(twin, 2)
    for f in dataclasses.fields(before):
        assert torch.equal(getattr(after, f.name), getattr(before, f.name)), f.name
        assert torch.equal(getattr(lane2, f.name), getattr(want2, f.name)), f.name
    assert int(nxt[2]) == int(torch.argmax(logits[2]))
    assert [int(p) for p in cache.pos] == [24, 20, 22]


def test_published_snapshots_are_copies():
    """Every snapshot the lane engine publishes stays bit for bit as it
    was published while the engine runs on, and shares no storage with
    the lane cache."""
    _, _, cfg, params = _weights("recurrentgemma_2b")
    eng = ContinuousBatchingEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                                   page_size=PS, prefill_chunk=4,
                                   device="cpu", paged=False)
    seen = {}
    real = eng.pages.publish

    def publish(key, snapshot, ns=""):
        seen[tuple(key)] = (snapshot, {f.name: getattr(snapshot, f.name).clone()
                                       for f in dataclasses.fields(snapshot)})
        return real(key, snapshot, ns)

    eng.pages.publish = publish
    drive(eng, Request)
    assert len(seen) >= 2 and eng.stats()["pages"]["cow_copies"] > 0
    lane_ptrs = {getattr(eng._cache, f.name).untyped_storage().data_ptr()
                 for f in dataclasses.fields(eng._cache)}
    for key, (snap, copy) in seen.items():
        for name, t in copy.items():
            assert torch.equal(getattr(snap, name), t), (key, name)
            assert (getattr(snap, name).untyped_storage().data_ptr()
                    not in lane_ptrs)


def test_lane_moe_drops_no_slot_where_batched_routing_does():
    """16 lanes, 8 experts, top-2, more than 8 lanes routed to expert 0:
    the batched ``layers.moe`` shares a capacity of 8 slots an expert and
    drops; routing each lane on its own (``layers.moe_lanes``, one packed
    (E, 16, d) buffer) drops none and equals ``layers.moe`` on each lane
    alone, the dense oracle, and the reference's ``layers.moe`` under
    ``vmap`` over the lanes."""
    import dataclasses

    from repro_torch.core.xaif import REGISTRY
    from repro_torch.sharding.params import init_tree
    e, k, d, f, b = 8, 2, 16, 32, 16
    decls = L.moe_decls(d, f, e)
    p = init_tree(decls, 0, "cpu")
    p["router"] = p["router"].clone()
    p["router"][:, 0] += 3.0                 # x > 0: every lane picks 0
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (b, 1, d)).astype(np.float32)).abs()
    kw = {"n_exp": e, "top_k": k}
    _, _, eidx = L.route(x.reshape(b, d), p["router"], k)
    assert int((eidx == 0).sum()) > 8
    assert L.capacity(b, k, 1.25, e) == 8 and L.capacity(1, k, 1.25, e) == 1

    calls = []
    # the models reach the expert FFN through the XAIF registry: count the
    # calls of the accelerator registered there
    spec = REGISTRY.get("moe_ffn", "cuda")

    def counted(xg, *a, **kw2):
        calls.append(tuple(xg.shape))
        return spec.fn(xg, *a, **kw2)

    REGISTRY.register(dataclasses.replace(spec, fn=counted),
                      allow_override=True)
    try:
        lanes = L.moe_lanes(x, p, **kw)
    finally:
        REGISTRY.register(spec, allow_override=True)
    assert calls == [(e, b, d)]
    batched, _ = L.moe(x, p, **kw)
    alone = torch.cat([L.moe(x[i:i + 1], p, **kw)[0] for i in range(b)])
    oracle = L.moe_dense_ref(x, p, **kw)
    torch.testing.assert_close(lanes, alone, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lanes, oracle, atol=1e-5, rtol=1e-5)
    dropped = (batched - oracle).abs().amax(-1)[:, 0] > 1e-4
    assert bool(dropped.any())

    jp = {n: jnp.asarray(t.numpy()) for n, t in p.items()}
    want = jax.vmap(lambda xi: JL.moe(xi, jp, n_exp=e, top_k=k)[0])(
        jnp.asarray(x.numpy())[:, None])
    np.testing.assert_allclose(lanes.numpy(), np.asarray(want)[:, 0],
                               atol=2e-5, rtol=2e-5)
