"""The port's Griffin hybrid (serving) against ``repro.models.griffin``.

On the recurrentgemma smoke config (5 layers: one (rec, rec, attn) triple
and a (rec, rec) tail, attention window 16), with weights made by the JAX
package and bridged (``repro_torch.bridge``), in float32 and in bfloat16:

* the pieces on identical inputs: ``causal_conv1d`` with and without a
  state, and ``rglru_gates``, at the reference's kernel tolerances (float32
  2e-5, bfloat16 3e-2; JAX runs them op by op, as the port does);
* the whole ``prefill`` against ``griffin.prefill`` (jitted) with
  ``scan_impl`` "chunked" and "pallas" (the Pallas kernel in interpret
  mode), on a prompt shorter than the window (12: the attention caches are
  zero-padded) and one longer (40: a ring holding position p at slot
  ``p % 16``): the logits and every ``GriffinCache`` field;
* 24 teacher-forced ``decode_step``s after a 12-token prompt (the ring
  wraps at step 4) against JAX's, logits at every step and the final cache,
  and the greedy tokens wherever the reference's top-1/top-2 margin is
  clear of the tolerance;
* the structure of the path: each prefill goes through the RG-LRU scan
  once per recurrent layer and the flash forward once per attention layer,
  and a decode step through neither; the serve driver runs on the CPU.

Whole-model tolerance: 6e-2 (atol and rtol), as
``tests/test_torch_transformer.py`` holds bf16 logits. Griffin's
activations are bfloat16 whatever the params' dtype (the reference gathers
the embedding from a bf16 cast of the table), so float32 params get the
same bound. XLA fuses elementwise chains and rounds to bf16 at other places
than PyTorch's op-by-op execution; those differences of a few bf16 ulps
pass through five layers. Two changes to the reference's random init keep
that from being amplified past any bound (both packages get the same
changed weights): the attention projections are scaled to their true
fan-in (the reference's ``fan_in`` makes wk and wv of shape (64, 1, 16)
std 1, so the scores are large, the softmax nearly one-hot, and a bf16 ulp
on a score moves its output by O(1); ROADMAP queue 3), and the embedding
is scaled by 10 (logits of O(10), whose top-1/top-2 margins clear the
tolerance, as ``tests/test_torch_engine.py`` does). At the reference's
init the same comparison differs by 10-40% of each tensor's size in the
layers after the first attention layer.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.kernels.rglru.ops  # noqa: F401  (XAIF registration of "pallas")
from repro import configs as jconfigs
from repro.models import griffin as jg
from repro.models import layers as JL
from repro.models import registry as jreg
from repro.sharding import params as JP

torch = configs = params_from_numpy = registry = griffin = L = None
attn_ops = rglru_ops = launch_serve = build_serve = None  # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, configs, params_from_numpy, registry, griffin, L
    global attn_ops, rglru_ops, launch_serve, build_serve
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import griffin, registry
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import build_serve
    torch.set_num_threads(1)


ARCH = "recurrentgemma_2b"
TOL = {"float32": 2e-5, "bfloat16": 3e-2}      # pieces
MODEL_TOL = 6e-2                               # whole model, bf16 activations
FIELDS = ("conv", "h", "k", "v")


def _np(t):
    return t.float().numpy()


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def _rescaled(jparams, cfg, embed_scale=10.0):
    """The JAX params as numpy, attention projections at their true fan-in
    (``griffin.true_fan_in``) and the embedding times ``embed_scale``;
    leaves keep their dtypes."""
    tree = jax.tree.map(np.asarray, jparams)
    scaled = griffin.true_fan_in(tree, cfg)
    scaled["embed"] = scaled["embed"] * embed_scale
    return jax.tree.map(lambda new, old: np.asarray(new).astype(old.dtype),
                        scaled, tree)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    """(jax cfg, jax params, port cfg, port params) for one params dtype."""
    jcfg = jconfigs.smoke(ARCH)
    cfg = configs.smoke(ARCH)
    jparams = JP.init_tree(jreg.decls(jcfg), jax.random.key(1))
    if request.param == "bfloat16":
        jparams = JP.cast_tree(jparams, jnp.bfloat16)
    tree = _rescaled(jparams, cfg)
    return (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(tree, "cpu"))


def _prompt(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_decls_match_jax(smoke):
    get = jconfigs.smoke if smoke else jconfigs.get
    jd = jreg.decls(get(ARCH))
    pd = registry.decls((configs.smoke if smoke else configs.get)(ARCH))
    shapes = lambda tree: jax.tree.map(lambda d: tuple(d.shape), tree,
                                       is_leaf=lambda x: hasattr(x, "shape"))
    from repro_torch.sharding.params import tree_map
    assert tree_map(lambda d: tuple(d.shape), pd) == shapes(jd)
    if not smoke:
        assert configs.get(ARCH).param_count() == 2_682_191_360
        assert griffin.plan(configs.get(ARCH)) == (8, ["rec", "rec"])


def test_full_width_cache_shapes():
    conv, h, kv = griffin.GriffinCache.shapes(configs.get(ARCH), 8, 4160)
    assert conv == (18, 8, 3, 2560) and h == (18, 8, 2560)
    assert kv == (8, 8, 2048, 1, 256)
    cache = registry.cache_init(configs.smoke(ARCH), 2, 20, device="cpu")
    assert cache.conv.dtype == cache.k.dtype == torch.bfloat16
    assert cache.h.dtype == torch.float32 and int(cache.pos) == 0
    assert tuple(cache.k.shape) == (1, 2, 16, 1, 16)


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_jax(dtype, with_state):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    w = (rng.normal(size=(4, 24)) * 0.5).astype(np.float32)
    st = rng.normal(size=(2, 3, 24)).astype(np.float32) if with_state else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want, want_st = JL.causal_conv1d(
        jnp.asarray(x, jd), jnp.asarray(w, jd),
        None if st is None else jnp.asarray(st, jd))
    got, got_st = L.causal_conv1d(
        torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
        None if st is None else torch.from_numpy(st).to(td))
    assert got.dtype == got_st.dtype == td
    _close(got, want, TOL[dtype])
    _close(got_st, want_st, 0.0)                # a copy of input rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_gates_match_jax(dtype):
    cfg = configs.smoke(ARCH)
    jp = JP.init_tree(jg._rglru_decls(64, cfg.n_heads), jax.random.key(2))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 10, 64)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    # nonzero biases, so the test sees where they enter, and a few a_param
    # above 20, where F.softplus's threshold would part from jax's softplus
    jp["b_r"] = jnp.asarray(rng.normal(size=64) * 0.5, jnp.float32)
    jp["b_i"] = jnp.asarray(rng.normal(size=64) * 0.5, jnp.float32)
    jp["a_param"] = jp["a_param"].at[:4].set(jnp.asarray([20.5, 25.0, 30.0,
                                                          40.0]))
    wa, wb = jg.rglru_gates(jnp.asarray(x, jd), jp, cfg.rglru_c)
    ta, tb = griffin.rglru_gates(torch.from_numpy(x).to(td),
                                 params_from_numpy(jax.tree.map(np.asarray, jp),
                                                   "cpu"), cfg.rglru_c)
    assert ta.dtype == tb.dtype == torch.float32
    _close(ta, wa, TOL[dtype])
    _close(tb, wb, TOL[dtype])


def test_embedding_scale_is_rounded_to_bf16_as_in_jax():
    """At d_model 2560 the reference multiplies by sqrt(2560) rounded to
    bf16 (50.5, not 50.596...); the smoke config's sqrt(64) = 8 is exact
    and would not tell the two apart."""
    cfg = configs.get(ARCH)
    table = np.random.default_rng(0).normal(size=(6, cfg.d_model))
    table = table.astype(np.float32)
    toks = np.array([[0, 3, 5]], np.int32)
    want = (jnp.asarray(table).astype(jnp.bfloat16)[toks]
            * jnp.asarray(np.sqrt(cfg.d_model), jnp.bfloat16))
    got = griffin._embed({"embed": torch.from_numpy(table)}, cfg,
                         torch.from_numpy(toks).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# Prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [12, 40], ids=["zero-padded", "ring"])
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_prefill_matches_jax(model, impl, s):
    jcfg, jparams, cfg, params = model
    jcfg = dataclasses.replace(jcfg, scan_impl=impl)
    toks = _prompt(cfg, 2, s)
    max_len = s + 24
    want_logits, want = jax.jit(lambda p, t: jreg.prefill(
        p, jcfg, tokens=t, max_len=max_len))(jparams, toks)
    logits, cache = registry.prefill(params, cfg, torch.from_numpy(toks),
                                     max_len=max_len)
    assert logits.shape == (2, cfg.padded_vocab)
    _close(logits, want_logits, MODEL_TOL, "logits")
    for f in FIELDS:
        got, ref_f = getattr(cache, f), getattr(want, f)
        assert tuple(got.shape) == ref_f.shape, f
        assert str(got.dtype).split(".")[1] == str(ref_f.dtype), f
        _close(got, ref_f, MODEL_TOL, f)
    assert int(cache.pos) == int(want.pos) == s


def test_teacher_forced_decode_matches_jax(model):
    """24 decode steps after a 12-token prompt: positions 12-35 on a ring
    of 16, which wraps at step 4."""
    jcfg, jparams, cfg, params = model
    s, steps = 12, 24
    toks = _prompt(cfg, 2, s + steps, seed=5)
    jl, jcache = jax.jit(lambda p, t: jreg.prefill(
        p, jcfg, tokens=t, max_len=s + steps))(jparams, toks[:, :s])
    logits, cache = registry.prefill(params, cfg, torch.from_numpy(toks[:, :s]),
                                     max_len=s + steps)
    jstep = jax.jit(lambda p, c, t: jreg.decode_step(p, jcfg, c, t))
    margins, agree = [], 0
    for t in range(steps):
        want, jcache = jstep(jparams, jcache, toks[:, s + t:s + t + 1])
        before = cache
        logits, cache = registry.decode_step(
            params, cfg, cache, torch.from_numpy(toks[:, s + t:s + t + 1]))
        assert cache is before                    # written in place
        _close(logits, want, MODEL_TOL, f"step {t}")
        ref_logits = np.asarray(want, np.float32)
        top2 = np.sort(ref_logits, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * MODEL_TOL * (1 + np.abs(top2[:, 1]))
        got_tok = torch.argmax(logits, -1).numpy()
        assert (got_tok[clear] == ref_logits.argmax(-1)[clear]).all(), t
        agree += int(clear.sum())
        margins.append(top2[:, 1] - top2[:, 0])
    assert agree >= steps                # most steps' tokens were compared
    for f in FIELDS:
        _close(getattr(cache, f), getattr(jcache, f), MODEL_TOL, f)
    assert int(cache.pos) == int(jcache.pos) == s + steps


# ---------------------------------------------------------------------------
# The path: kernels per call, the registry, the driver
# ---------------------------------------------------------------------------


def test_prefill_scans_and_attends_once_per_layer_and_decode_never():
    """The structure ``chip_smoke.py`` counts on the card (18 scans and 8
    flash forwards per full-width prefill, none per decode step), counted
    here at the dispatch points: 4 recurrent layers and 1 attention layer."""
    cfg = configs.smoke(ARCH)
    from repro_torch.sharding.params import init_tree
    params = init_tree(registry.decls(cfg), 0, "cpu", dtype=torch.bfloat16)
    calls = {"scan": 0, "flash": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    sv = build_serve(cfg, 2, 24, prefill_len=20, device="cpu")
    with mock.patch.object(rglru_ops, "_scan", count("scan", rglru_ops._scan)), \
            mock.patch.object(attn_ops, "_forward",
                              count("flash", attn_ops._forward)):
        logits, cache = sv.prefill_fn(params, torch.zeros((2, 20),
                                                          dtype=torch.long))
        assert calls == {"scan": 4, "flash": 1}
        for _ in range(3):
            logits, cache = sv.decode_fn(params, cache,
                                         torch.argmax(logits, -1)[:, None])
        assert calls == {"scan": 4, "flash": 1}
    assert not logits.requires_grad and torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="prefill tokens"):
        sv.prefill_fn(params, torch.zeros((2, 19), dtype=torch.long))


def test_other_families_raise_on_the_serve_path():
    for arch, item in (("musicgen_large", "embeds inputs"),):
        cfg = configs.smoke(arch)
        with pytest.raises(NotImplementedError, match=item):
            registry.prefill({}, cfg, torch.zeros((1, 4), dtype=torch.long))
        with pytest.raises(NotImplementedError, match=item):
            registry.decode_step({}, cfg, None,
                                 torch.zeros((1, 1), dtype=torch.long))
        with pytest.raises(NotImplementedError, match=item):
            registry.cache_init(cfg, 1, 8, device="cpu")
    assert not registry.supports_paged(configs.smoke(ARCH))


def test_serve_needs_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_serve(configs.smoke(ARCH), 2, 24)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "recurrentgemma-2b", "--smoke"])


def test_launcher_runs_on_cpu(capsys):
    run = launch_serve.main(["--arch", "recurrentgemma-2b", "--smoke",
                             "--device", "cpu", "--batch", "2",
                             "--prompt-len", "20", "--steps", "5"])
    out = capsys.readouterr().out
    assert "prefill 2 x 20 tokens" in out and "tok/s" in out
    assert "not measured (cpu)" in out
    assert tuple(run.tokens.shape) == (2, 5) and len(run.decode_s) == 5
    assert ((run.tokens >= 0) & (run.tokens < run.cfg.vocab)).all()
    assert int(run.cache.pos) == 25 and run.peak_bytes is None
    # the launcher's greedy tokens are the argmax of a fresh teacher-forced
    # run on the same params and prompt
    sv = run.serve
    logits, cache = sv.prefill_fn(run.params, run.prompt)
    for t in range(5):
        tok = torch.argmax(logits, -1)
        assert torch.equal(tok, run.tokens[:, t]), t
        logits, cache = sv.decode_fn(run.params, cache, tok[:, None])
