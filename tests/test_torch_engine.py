"""The port's serving engine: against the JAX engine, and against itself.

On the ``granite_3_2b`` smoke config at ``dtype="float32"`` (the KV pool is
bf16 in both packages, as the reference engine keeps it), on the same
weights and a seeded shared-prefix trace:

* the port engine's completions equal the JAX engine's (sync dispatch,
  paged backend). First the test teacher-forces the JAX engine's sequences
  through both packages' paged decode and checks that their logits differ
  by less than ``GAP`` = 1e-3 (float32 everywhere but the bf16 pool, whose
  rounding of a K/V entry can flip) while every emitted step's top-1/top-2
  margin exceeds ``MARGIN`` = 1e-2, so equal tokens are the right
  expectation;
* inside the port, bitwise: chunked prefill equals unchunked, prefix
  adoption equals no page table, and the batched engine equals each
  request served alone;
* the constructor's validation, backpressure, the backend choice (the
  lane backend's own tests are in ``tests/test_torch_lanes.py``), the
  constructor arguments of tensor parallelism (``mesh``, ``tp_axis``; its
  own tests are in ``tests/test_torch_tp.py``), and those earlier slices
  brought (async
  dispatch, the journal, sampled requests: ``tests/test_torch_async.py``;
  a shared pool and table, the scheduler's hooks, fault injection and
  windowed configs on the paged backend: ``tests/test_torch_cluster.py``,
  ``tests/test_torch_chaos.py``, ``tests/test_torch_window.py``).
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.sharding import params as JP

torch = configs = params_from_numpy = registry = None  # bound by _port
ContinuousBatchingEngine = Request = SamplingParams = RequestJournal = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, configs, params_from_numpy, registry
    global ContinuousBatchingEngine, Request, SamplingParams, RequestJournal
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import registry
    from repro_torch.runtime.ft import RequestJournal
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request
    from repro_torch.serve.sampling import SamplingParams
    torch.set_num_threads(1)


GAP, MARGIN = 1e-3, 1e-2
# max_len 32 gathers 32 positions per slot with 4-token and with 16-token
# pages alike, so the engines compared bitwise run the same arithmetic
SLOTS, MAX_LEN, PS = 3, 32, 4


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jconfigs.smoke("granite_3_2b"), dtype="float32")
    cfg = dataclasses.replace(configs.smoke("granite_3_2b"), dtype="float32")
    jparams = JP.init_tree(jreg.decls(jcfg), jax.random.key(0))
    # logits of O(1), as at full width (the smoke embedding's 0.02 std
    # gives logits of O(0.1), where greedy margins fall to rounding level)
    jparams["embed"] = jparams["embed"] * 10.0
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def trace():
    """Six requests sharing a 9-token prefix (two full 4-token pages)."""
    rng = np.random.default_rng(2)
    prefix = [int(t) for t in rng.integers(1, 256, 9)]
    return [(f"r{i}", prefix + [int(t) for t in rng.integers(1, 256, 1 + i % 4)],
             4 + i % 3) for i in range(6)]


def run_port(cfg, params, reqs, **kw):
    kw = {"slots": SLOTS, "max_len": MAX_LEN, "page_size": PS,
          "prefill_chunk": 4, **kw}
    eng = ContinuousBatchingEngine(cfg, params, device="cpu", **kw)
    for r in reqs:
        assert eng.submit(Request(*r))
    eng.run_until_idle()
    return eng, {r.id: tuple(r.tokens) for r in eng.completed}


def teacher_forced_logits(jcfg, jparams, cfg, params, seqs):
    """Teacher-force ``seqs`` through the JAX paged decode and the port's
    (bf16 pools, as in the engines). Returns both packages' logits at every
    step, (steps, lanes, vocab), and a (steps, lanes) mask of the steps each
    lane takes."""
    b, n = len(seqs), max(len(s) for s in seqs)
    per = -(-n // PS)
    jk, jv = jreg.paged_pool_init(jcfg, b * per + 1, PS)
    tk, tv = registry.paged_pool_init(cfg, b * per + 1, PS, device="cpu")
    tables = np.arange(b * per, dtype=np.int32).reshape(b, per)
    step = jax.jit(lambda pk, pv, t, ln, tok, m: jreg.decode_step_paged(
        jparams, jcfg, pk, pv, t, ln, tok, append_mask=m))
    want, got, masks = [], [], []
    for t in range(n - 1):
        tok = np.array([s[t] if t < len(s) else 0 for s in seqs], np.int32)
        mask = np.array([t < len(s) - 1 for s in seqs])
        lengths = np.full((b,), t, np.int32)
        logits, jk, jv = step(jk, jv, tables, lengths, tok, mask)
        want.append(np.asarray(logits))
        got.append(registry.decode_step_paged(
            params, cfg, tk, tv, torch.from_numpy(tables),
            torch.from_numpy(lengths), torch.from_numpy(tok),
            append_mask=torch.from_numpy(mask))[0].numpy())
        masks.append(mask)
    return np.stack(want), np.stack(got), np.stack(masks)


def test_completions_match_the_jax_engine(model):
    jcfg, jparams, cfg, params = model
    reqs = trace()
    jeng = JaxEngine(jcfg, jparams, slots=SLOTS, max_len=MAX_LEN, page_size=PS,
                     prefill_chunk=4, async_dispatch=False, paged=True)
    for r in reqs:
        assert jeng.submit(JaxRequest(*r))
    jeng.run_until_idle()
    want = {r.id: tuple(r.tokens) for r in jeng.completed}
    ids = [r[0] for r in reqs]
    seqs = [list(r[1]) + list(want[r[0]]) for r in reqs]
    jl, tl, mask = teacher_forced_logits(jcfg, jparams, cfg, params, seqs)
    assert np.abs(jl - tl)[mask].max() < GAP
    top2 = np.sort(jl, -1)[..., -2:]
    emits = np.zeros_like(mask)
    for i, r in enumerate(reqs):
        emits[len(r[1]) - 1:len(seqs[i]) - 1, i] = True
    assert emits.sum() == sum(r[2] for r in reqs)
    margins = (top2[..., 1] - top2[..., 0])[emits]
    assert margins.min() > MARGIN, margins.min()

    eng, got = run_port(cfg, params, reqs)
    assert got == want
    assert sorted(got) == sorted(ids)
    assert eng.stats()["prompt_tokens_reused"] > 0


def test_chunked_prefill_is_bitwise_unchunked(model):
    _, _, cfg, params = model
    _, chunked = run_port(cfg, params, trace(), prefill_chunk=4)
    _, unchunked = run_port(cfg, params, trace(), prefill_chunk=1)
    assert chunked == unchunked


def test_prefix_adoption_is_bitwise_no_page_table(model):
    _, _, cfg, params = model
    shared, got = run_port(cfg, params, trace())
    plain, want = run_port(cfg, params, trace(), page_size=None)
    assert shared.stats()["prompt_tokens_reused"] > 0
    assert plain.stats()["prompt_tokens_reused"] == 0 and "pages" not in plain.stats()
    assert got == want


def test_engine_is_bitwise_sequential_decode(model):
    _, _, cfg, params = model
    _, batched = run_port(cfg, params, trace())
    alone = {}
    for r in trace():
        alone.update(run_port(cfg, params, [r], page_size=None)[1])
    assert batched == alone


def test_admission_is_fifo_with_backpressure(model):
    _, _, cfg, params = model
    eng = ContinuousBatchingEngine(cfg, params, slots=1, max_len=MAX_LEN,
                                   device="cpu", queue_capacity=2)
    reqs = [Request(f"q{i}", [5 + i, 6, 7], 2) for i in range(3)]
    assert eng.submit(reqs[0]) and eng.submit(reqs[1])
    assert not eng.submit(reqs[2]) and eng.rejected == 1
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(Request("q0", [1], 1))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request("long", [1] * MAX_LEN, 1))
    eng.run_until_idle()
    assert [r.id for r in eng.completed] == ["q0", "q1"]
    assert [len(r.tokens) for r in eng.completed] == [2, 2]
    assert [r.id for r in eng.drain_completed()] == ["q0", "q1"]
    assert eng.submit(Request("q0", [9], 1))       # drained ids are reusable
    st = eng.stats()
    assert st["tokens_generated"] == 4 and st["pool"]["in_use"] == 0


def test_later_slices_raise_not_implemented(model):
    _, _, cfg, params = model
    kw = {"slots": 2, "max_len": MAX_LEN, "device": "cpu"}
    ContinuousBatchingEngine(cfg, params, tp_axis="model",
                             **kw)                 # defaults are accepted
    # the lane backend is ported: paged=False, lane_batch and device_len
    # are accepted, and a windowed config is served on lanes
    lanes = ContinuousBatchingEngine(cfg, params, paged=False, lane_batch=4,
                                     device_len=2 * MAX_LEN, **kw)
    assert lanes.stats()["backend"] == "lanes" and lanes.n_lanes == 4
    # async dispatch and the journal are ported
    journal = RequestJournal(horizon=4)
    eng = ContinuousBatchingEngine(cfg, params, async_dispatch=True,
                                   journal=journal, **kw)
    assert eng.journal is journal and eng.stats()["async_dispatch"]
    assert ContinuousBatchingEngine(
        cfg, params, journal_horizon=8, **kw).journal.horizon == 8
    # tensor parallelism is ported: a mesh shards the paged decode, a
    # mesh without the tp axis and a mesh on lanes raise
    from repro_torch.launch.mesh import serve_tp_mesh
    mesh = serve_tp_mesh(2, ["cpu"] * 2)
    tp = ContinuousBatchingEngine(cfg, params, mesh=mesh, **kw)
    assert tp.tp == 2 and tp.stats()["tp"] == 2 and tp.mesh is mesh
    with pytest.raises(ValueError, match="has no axis 'x'"):
        ContinuousBatchingEngine(cfg, params, mesh=mesh, tp_axis="x", **kw)
    with pytest.raises(ValueError, match="paged-backend feature"):
        ContinuousBatchingEngine(cfg, params, mesh=mesh, paged=False, **kw)
    with pytest.raises(TypeError):
        ContinuousBatchingEngine(cfg, params, no_such_arg=1, **kw)
    moe = configs.smoke("grok_1_314b")
    with pytest.raises(NotImplementedError, match="no paged KV decode"):
        ContinuousBatchingEngine(moe, params, paged=True, **kw)
    # the scheduler's surface is ported: a shared pool and table, the
    # admission hook, reclaim and a fault plan are accepted
    from repro_torch.serve.chaos import FaultPlan, FaultSpec
    from repro_torch.serve.paged import PagePool
    from repro_torch.serve.pages import PageTable
    pool, table = PagePool(32, PS), PageTable(PS, capacity_pages=32)
    tenant = ContinuousBatchingEngine(
        cfg, params, pool=pool, page_table=table, namespace="g",
        admission_hook=lambda *a: True, reclaim=lambda e: None,
        chaos=FaultPlan(0, FaultSpec()), **kw)
    assert tenant.stats()["backend"] == "paged" and tenant._pool is pool
    assert tenant.stats()["pool"]["shared"]
    with pytest.raises(ValueError, match="shared pool"):
        ContinuousBatchingEngine(cfg, params, pool=pool, paged=False, **kw)
    # a windowed config is served on the paged backend (ring tables), and
    # on lanes when asked
    swa = dataclasses.replace(cfg, sliding_window=16)
    ring = ContinuousBatchingEngine(swa, params, **kw).stats()
    assert (ring["backend"], ring["window"]) == ("paged", 16)
    assert ring["table_entries_per_slot"] == -(-16 // 16) + 1
    assert ContinuousBatchingEngine(swa, params, paged=False,
                                    **kw).stats()["backend"] == "lanes"
    # sampled decoding is ported: a sampled request is served
    eng.submit(Request("s", [1, 2], 2, sampling=SamplingParams(0.7)))
    eng.run_until_idle()
    assert [len(r.tokens) for r in eng.completed] == [2]
    assert eng.stats()["sampled_requests"] == 1
    assert journal.get("s").sampling == SamplingParams(0.7).astuple()
    with pytest.raises(ValueError, match="at least one"):
        ContinuousBatchingEngine(cfg, params, **{**kw, "slots": 0})


def test_engine_needs_the_card_unless_asked_for_cpu(model):
    _, _, cfg, params = model
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(cfg, params, slots=1, max_len=MAX_LEN)
