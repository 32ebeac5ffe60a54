"""The port engine's async dispatch, sampled decoding, journal, preemption
and dedup claims: against the JAX engine, and against itself.

On the granite (paged backend), grok-1 and mamba2 (lane backend) smoke
configs in float32 with the JAX package's weights carried across (the
attention at its true fan-in and the embedding x 10, as
``tests/test_torch_lanes.py`` sets them up), on six requests sharing a
9-token prefix (two 4-token pages) that all arrive at once, so that on the
paged backend siblings stall on the first one's dedup claim and re-match
its pages mid-flight; half the requests sampled (temperature 0.8, top_k 50,
top_p 0.9, seed 100 + i) and half greedy, or all sampled:

* the port's ``RequestJournal`` keeps the reference's records and raises
  its errors under a seeded random sequence of operations, and passes the
  reference's journal tests (``tests/test_engine.py:467``,
  ``tests/test_sampling.py:229``);
* the port's engine gives the sync JAX engine's stats (``steps``,
  ``sampled_requests``, ``stalls``, ``rematches``, ``rematched_tokens``,
  ``prompt_tokens_reused``, ``replays``) exactly, and its tokens wherever
  the margins are clear: each request's tokens equal the reference's up to
  its first step whose margin (greedy: the top-2 gap of the logits;
  sampled: the top-2 gap of the filtered, scaled logits plus the step's
  Gumbel noise, with both packages' filters keeping the same tokens) is
  not above twice that step's largest difference between the packages
  plus an ulp, and at least half of all emitted steps get there. The
  margins come from teacher-forcing the reference's tokens through both
  packages' lane decode, the keys from the request's chain (the port's
  splits are JAX's bit for bit, ``tests/test_torch_sampling.py``);
* inside the port, bit for bit: sync ≡ async, paged ≡ lanes, chunk 1 ≡
  chunk 4, the greedy lanes of a mixed batch ≡ an all-greedy run,
  ``preempt()`` twice under async dispatch with chunk 4 ≡ undisturbed,
  ``preempt_slot(0, front=False)`` ≡ undisturbed, a token refused at
  retire (outside the vocabulary) ≡ undisturbed after its replay, and
  rewriting the engine's host arrays after a launch and before its retire
  changes no token; a journal pre-opened with a divergent prior run
  quarantines the request, replays it, and raises after ``max_replays``.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.runtime.ft import RequestJournal as JaxJournal
from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro.sharding import params as JP

torch = configs = params_from_numpy = registry = griffin = transformer = None
S = ContinuousBatchingEngine = Request = RequestJournal = None  # by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file (see ``tests/test_torch_engine.py``)."""
    global torch, configs, params_from_numpy, registry, griffin, transformer
    global S, ContinuousBatchingEngine, Request, RequestJournal
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import griffin, registry, transformer
    from repro_torch.runtime.ft import RequestJournal
    from repro_torch.serve import sampling as S
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request
    torch.set_num_threads(1)
    saved = S.THREEFRY_PARTITIONABLE
    S.THREEFRY_PARTITIONABLE = bool(jax.config.jax_threefry_partitionable)
    yield
    S.THREEFRY_PARTITIONABLE = saved


ARCHS = ["granite_3_2b", "grok_1_314b", "mamba2_370m"]
SLOTS, MAX_LEN, PS = 3, 32, 4
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)


def _weights(arch):
    """(jax cfg, jax params, port cfg, port params) in float32: the JAX
    package's init from key 1, the attention at its true fan-in and the
    embedding x 10, in both packages."""
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype="float32")
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    tree = jax.tree.map(np.asarray,
                        JP.init_tree(jreg.decls(jcfg), jax.random.key(1)))
    if cfg.family == "hybrid":
        scaled = griffin.true_fan_in(tree, cfg)
    elif cfg.family == "ssm":
        scaled = dict(tree)
    else:
        scaled = transformer.true_fan_in(tree, cfg)
    scaled["embed"] = scaled["embed"] * 10.0
    tree = jax.tree.map(lambda new, old: np.asarray(new).astype(old.dtype),
                        scaled, tree)
    return (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(tree, "cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _weights(request.param)


@pytest.fixture(scope="module")
def granite():
    return _weights("granite_3_2b")


def sampling_of(i, kind):
    """Request ``i``'s (temperature, top_k, top_p, seed), or None for a
    greedy one: every request sampled (``"sampled"``), every second one
    (``"mixed"``) or none (``"greedy"``)."""
    if kind == "sampled" or (kind == "mixed" and i % 2 == 0):
        return (SAMPLED["temperature"], SAMPLED["top_k"], SAMPLED["top_p"],
                100 + i)
    return None


def trace():
    """Six requests sharing a 9-token prefix (two full 4-token pages)."""
    rng = np.random.default_rng(2)
    prefix = [int(t) for t in rng.integers(1, 256, 9)]
    return [(f"r{i}", prefix + [int(t) for t in rng.integers(1, 256, 1 + i % 4)],
             4 + i % 3) for i in range(6)]


def requests(kind, make=None, params_cls=None):
    make = make or Request
    params_cls = params_cls or S.SamplingParams
    out = []
    for i, (rid, prompt, n) in enumerate(trace()):
        sp = sampling_of(i, kind)
        out.append(make(rid, prompt, n,
                        sampling=params_cls(*sp) if sp else None))
    return out


def run_port(cfg, params, kind="mixed", steps=None, **kw):
    """Serve :func:`trace` (every request submitted at once) on the port's
    engine; ``steps(engine, n)`` runs after engine step ``n``. Returns the
    engine and its completions by id."""
    kw = {"slots": SLOTS, "max_len": MAX_LEN, "page_size": PS,
          "prefill_chunk": 4, **kw}
    eng = ContinuousBatchingEngine(cfg, params, device="cpu", **kw)
    for r in requests(kind):
        assert eng.submit(r)
    n = 0
    while eng.step():
        n += 1
        if steps is not None:
            steps(eng, n)
    assert not eng.busy and eng._pending is None
    return eng, {r.id: tuple(r.tokens) for r in eng.completed}


STATS = ("steps", "tokens_generated", "sampled_requests", "stalls",
         "rematches", "rematched_tokens", "prompt_tokens_reused", "replays")


# ---------------------------------------------------------------------------
# The journal against the reference's
# ---------------------------------------------------------------------------


def _journal_ops(seed, n=400):
    """A seeded sequence of journal operations over a few request ids."""
    rng = random.Random(seed)
    ids = [f"q{i}" for i in range(5)]
    kinds = ["open", "open", "token", "token", "token", "prefix", "rematch",
             "recycle", "slo", "complete", "evict", "transfer"]
    ops = []
    for _ in range(n):
        rid, kind = rng.choice(ids), rng.choice(kinds)
        if kind == "open":
            sp = rng.choice([None, (0.8, 0, 0.9, 3), (0.5, 10, 1.0, 4)])
            ops.append((kind, rid, [1, 2, rng.randint(3, 9)], 4, sp))
        elif kind == "token":
            ops.append((kind, rid, rng.randint(0, 3)))
        elif kind == "prefix":
            ops.append((kind, rid, rng.randint(0, 8),
                        [(1, 2, 3, 4)] * rng.randint(0, 2)))
        else:
            ops.append((kind, rid, rng.randint(1, 3)))
    return ops


def _apply(journal, op):
    kind, rid = op[:2]
    if kind == "open":
        return journal.open(rid, op[2], op[3], sampling=op[4]).request_id
    if kind == "token":
        return journal.record_token(rid, op[2])
    if kind == "prefix":
        return journal.note_prefix(rid, op[2], op[3])
    if kind == "rematch":
        return journal.note_rematch(rid, op[2])
    if kind == "recycle":
        return journal.note_recycle(rid, op[2])
    if kind == "slo":
        return journal.note_slo_preempt(rid)
    if kind == "complete":
        return journal.complete(rid)
    if kind == "evict":
        return journal.evict(rid)
    rec = journal.transfer(rid)            # hand it over and take it back
    return journal.adopt(rec).arrival_seq


@pytest.mark.parametrize("seed,horizon", [(0, None), (1, 2), (2, 0), (3, 5)])
def test_journal_matches_the_reference_under_random_ops(seed, horizon):
    got, want = RequestJournal(horizon=horizon), JaxJournal(horizon=horizon)
    raised = 0
    for op in _journal_ops(seed):
        results = []
        for journal in (got, want):
            try:
                results.append(("ok", _apply(journal, op)))
            except (KeyError, ValueError, RuntimeError) as e:
                results.append((type(e).__name__, str(e)))
        assert results[0] == results[1], op
        raised += results[0][0] != "ok"
        assert got.size() == want.size()
    assert raised > 0 and got.auto_evicted == want.auto_evicted
    for a, b in ((got.incomplete(), want.incomplete()),
                 (got.completed(), want.completed())):
        assert [dataclasses.asdict(r) for r in a] == \
            [dataclasses.asdict(r) for r in b]


def test_journal_detects_replay_divergence():
    """``tests/test_engine.py:467`` on the port's journal."""
    j = RequestJournal()
    j.open("r", [1, 2], max_new_tokens=3)
    j.record_token("r", 10)
    j.record_token("r", 11)
    j.open("r", [1, 2], max_new_tokens=3)      # preempted -> replay
    j.record_token("r", 10)                    # matches original: fine
    with pytest.raises(RuntimeError, match="replay divergence"):
        j.record_token("r", 99)                # diverges from original 11


def test_journal_records_sampling_and_rejects_conflicting_reopen():
    """``tests/test_sampling.py:229`` on the port's journal."""
    j = RequestJournal()
    sp = S.SamplingParams(temperature=0.8, top_p=0.9, seed=42).astuple()
    rec = j.open("r", [1, 2], 4, sampling=sp)
    assert rec.sampling == sp
    assert j.open("r", [1, 2], 4, sampling=sp) is rec      # replay: same id
    with pytest.raises(ValueError):
        j.open("r", [1, 2], 4, sampling=None)
    assert j.open("g", [1, 2], 4).sampling is None


# ---------------------------------------------------------------------------
# The engine against the sync JAX engine
# ---------------------------------------------------------------------------


def jax_run(jcfg, jparams, kind, **kw):
    kw = {"slots": SLOTS, "max_len": MAX_LEN, "page_size": PS,
          "prefill_chunk": 4, **kw}
    eng = JaxEngine(jcfg, jparams, async_dispatch=False, **kw)
    for r in requests(kind, JaxRequest, JaxSamplingParams):
        assert eng.submit(r)
    eng.run_until_idle()
    return eng, {r.id: tuple(r.tokens) for r in eng.completed}


_JSTEPS: dict = {}


def forced_logits(model, seq):
    """(steps, vocab) logits of ``seq`` teacher-forced through a batch-1
    lane cache in each package (JAX's, the port's), step t predicting
    ``seq[t + 1]``."""
    jcfg, jparams, cfg, params = model
    if jcfg not in _JSTEPS:
        _JSTEPS[jcfg] = jax.jit(
            lambda p, c, t: jreg.decode_step(p, jcfg, c, t))
    jstep = _JSTEPS[jcfg]
    jcache = jreg.cache_init(jcfg, 1, MAX_LEN)
    cache = registry.cache_init(cfg, 1, MAX_LEN, device="cpu", lanes=True)
    want, got = [], []
    for tok in seq[:-1]:
        jl, jcache = jstep(jparams, jcache, jnp.asarray([[tok]], jnp.int32))
        want.append(np.asarray(jl[0], np.float32))
        with torch.inference_mode():
            logits, _ = registry.decode_step(params, cfg, cache,
                                             torch.tensor([[tok]]))
        got.append(logits[0].float().numpy())
    return np.stack(want), np.stack(got)


def clear_prefix(model, prompt, tokens, sp):
    """How many of a request's emitted steps, from the first, have a margin
    clear of the two packages' difference (see the module docstring)."""
    w, g = forced_logits(model, list(prompt) + list(tokens))
    w, g = w[len(prompt) - 1:], g[len(prompt) - 1:]
    key = S.seed_key(sp[3] if sp else 0)[None]
    for t in range(len(tokens)):
        carry, use = S.split_keys(key)
        key = carry
        if sp is None:
            zw, zg = w[t], g[t]
        else:
            zw, zg = (S.scores(torch.from_numpy(x[None]), use, *sp[:3])[0]
                      .numpy() for x in (w[t], g[t]))
            if not (np.isfinite(zw) == np.isfinite(zg)).all():
                return t                   # the filters keep other tokens
        live = np.isfinite(zw)
        top2 = np.sort(zw[live])[-2:]
        gap = np.abs(zg[live] - zw[live]).max()
        ulp = np.spacing(np.float32(max(abs(top2[1]), 1.0)))
        if not top2[1] - top2[0] > 2 * gap + ulp:
            return t
    return len(tokens)


def against_jax(model, kind):
    """The port's engine and the sync JAX engine on :func:`trace`: equal
    stats, and equal tokens up to each request's first unclear margin."""
    jcfg, jparams, cfg, params = model
    jeng, want = jax_run(jcfg, jparams, kind)
    eng, got = run_port(cfg, params, kind)
    js, st = jeng.stats(), eng.stats()
    for key in STATS:
        assert st[key] == js[key], (key, st[key], js[key])
    assert st["backend"] == js["backend"]
    assert st["sampled_requests"] == (6 if kind == "sampled" else 3)
    if cfg.family == "dense":
        assert st["stalls"] > 0 and st["rematches"] > 0
    assert sorted(got) == sorted(want)
    clear = emitted = 0
    for i, (rid, prompt, n) in enumerate(trace()):
        k = clear_prefix(model, prompt, want[rid], sampling_of(i, kind))
        assert got[rid][:k] == want[rid][:k], (cfg.name, rid, k)
        clear, emitted = clear + k, emitted + n
    assert clear >= emitted // 2, (clear, emitted)


def test_mixed_trace_matches_the_sync_jax_engine(model):
    against_jax(model, "mixed")


def test_sampled_trace_matches_the_sync_jax_engine(granite):
    against_jax(granite, "sampled")


# ---------------------------------------------------------------------------
# Inside the port, bit for bit
# ---------------------------------------------------------------------------


def test_sync_async_chunking_and_backends_agree(model):
    _, _, cfg, params = model
    base_eng, base = run_port(cfg, params)
    variants = [dict(async_dispatch=True), dict(prefill_chunk=1),
                dict(prefill_chunk=1, async_dispatch=True)]
    if cfg.family == "dense":
        variants += [dict(paged=False), dict(paged=False, async_dispatch=True),
                     dict(page_size=None)]
    for kw in variants:
        eng, got = run_port(cfg, params, **kw)
        assert got == base, kw
        assert eng.stats()["sampled_requests"] == 3
    assert base != run_port(cfg, params, "greedy")[1]   # sampling samples
    assert base_eng.stats()["journal"]["in_flight"] == 0
    # handing off the completions releases their journal records
    assert len(base_eng.drain_completed()) == 6
    assert base_eng.journal.size()["records"] == 0


def test_greedy_lanes_of_a_mixed_batch_equal_an_all_greedy_run(model):
    _, _, cfg, params = model
    _, mixed = run_port(cfg, params, "mixed", async_dispatch=True)
    _, greedy = run_port(cfg, params, "greedy")
    for i, rid in enumerate(sorted(mixed)):
        if sampling_of(i, "mixed") is None:
            assert mixed[rid] == greedy[rid], rid
    assert mixed != greedy


def test_preempt_twice_under_async_replays_bit_for_bit(model):
    _, _, cfg, params = model
    _, want = run_port(cfg, params)
    cuts = []

    def preempt(eng, n):
        if n in (3, 7):
            cuts.append([r.id for r in eng.preempt()])

    eng, got = run_port(cfg, params, steps=preempt, async_dispatch=True,
                        prefill_chunk=4)
    assert got == want
    assert all(cuts) and len(cuts) == 2
    assert eng.stats()["journal"]["in_flight"] == 0
    assert any(eng.journal.get(rid).prior for rid in cuts[0])


def test_preempt_slot_to_the_back_replays_bit_for_bit(granite):
    _, _, cfg, params = granite
    _, want = run_port(cfg, params)
    moved = []

    def demote(eng, n):
        if n == 4:
            moved.append(eng.preempt_slot(0, front=False))

    eng, got = run_port(cfg, params, steps=demote)
    assert moved[0] is not None and moved[0].id == "r0"
    assert eng.journal.get("r0").prior or eng.journal.get("r0").prefix_reused
    assert got == want


def test_refused_token_replays_bit_for_bit(granite):
    """A token outside the vocabulary at retire is never delivered: its
    request is quarantined and replays from its journal record, and the
    run's tokens equal an undisturbed one's."""
    _, _, cfg, params = granite
    _, want = run_port(cfg, params, async_dispatch=True)

    class Landed:
        def synchronize(self):
            pass

    def corrupting(eng):
        real = eng._stage

        def stage(meta, nxt):
            launched = real(meta, nxt)
            if eng.steps == 5 and meta.emitted:
                host = nxt.clone()
                host[meta.emitted[0][0]] = cfg.vocab + 3
                launched.host, launched.done = host, Landed()
            return launched

        eng._stage = stage

    eng, got = run_port(cfg, params, async_dispatch=True,
                        steps=lambda e, n: n == 1 and corrupting(e))
    assert (eng.token_faults, eng.replays) == (1, 1)
    assert got == want


def test_divergent_journal_quarantines_then_raises(granite):
    """A journal pre-opened with another run's tokens for ``r0``: every
    replay diverges at its first token, is quarantined and requeued, until
    ``max_replays`` is spent and the engine raises (the reference's
    livelock guard)."""
    _, _, cfg, params = granite
    journal = RequestJournal()
    rid, prompt, n = trace()[0]
    journal.open(rid, prompt, n, sampling=sampling_of(0, "mixed"))
    _, want = run_port(cfg, params)
    for tok in want[rid]:
        journal.record_token(rid, (tok + 1) % cfg.vocab)
    eng = ContinuousBatchingEngine(cfg, params, device="cpu", slots=SLOTS,
                                   max_len=MAX_LEN, page_size=PS,
                                   prefill_chunk=4, journal=journal)
    eng.max_replays = 3
    for r in requests("mixed"):
        assert eng.submit(r)
    with pytest.raises(RuntimeError, match="quarantined 4 times"):
        eng.run_until_idle()
    assert eng.token_faults == 4 and eng.replays == 3
    assert journal.get(rid).generated == []


@pytest.mark.parametrize("async_dispatch", [False, True])
def test_rewriting_host_arrays_in_flight_changes_no_token(granite,
                                                          async_dispatch):
    """Between each launch and its retire, the engine's sampling arrays,
    the keys the launch was given and the launch's own token, feedback and
    emit arrays are overwritten (the engine's arrays are put back before
    the next dispatch reads them): the tokens stay the same bits."""
    _, _, cfg, params = granite
    _, want = run_port(cfg, params, async_dispatch=async_dispatch)
    saved = []

    def scribbling(eng):
        launch, retire = eng._launch, eng._retire

        def scribbled_launch(toks, counts, feedback, emit):
            keys = eng._keys
            nxt = launch(toks, counts, feedback, emit)
            saved.append((eng._temp.copy(), eng._topk.copy(),
                          eng._topp.copy()))
            for a in (eng._temp, eng._topk, eng._topp, toks, feedback, emit):
                a[...] = 1
            keys.fill_(7)
            return nxt

        def restoring_retire(launched):
            while saved:
                eng._temp[:], eng._topk[:], eng._topp[:] = saved.pop()
            return retire(launched)

        eng._launch, eng._retire = scribbled_launch, restoring_retire

    eng = ContinuousBatchingEngine(cfg, params, device="cpu", slots=SLOTS,
                                   max_len=MAX_LEN, page_size=PS,
                                   prefill_chunk=4,
                                   async_dispatch=async_dispatch)
    scribbling(eng)
    for r in requests("mixed"):
        assert eng.submit(r)
    eng.run_until_idle()
    assert {r.id: tuple(r.tokens) for r in eng.completed} == want
