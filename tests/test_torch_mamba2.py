"""The port's Mamba-2 (serving) against ``repro.models.mamba2``, and short
prompts on the serve driver in both recurrent families.

On the mamba2 smoke config (2 layers, d_model 64, 8 heads of dim 16, state
16, chunk 8, conv width 4), with weights made by the JAX package and
bridged (``repro_torch.bridge``), in float32 and in bfloat16:

* the SSM arithmetic on identical inputs (``_ssm_math``: the threshold-free
  softplus, ``A = -exp(A_log)``, dA, the dt-scaled x, B and C over heads);
* the whole ``prefill`` against ``mamba2.prefill`` (jitted) with
  ``scan_impl`` "chunked" (S 12 and 16) and "pallas" (S 16: the Pallas
  wrapper asserts ``S % chunk == 0``), the logits and every ``SSMCache``
  field;
* 24 teacher-forced ``decode_step``s after a 12-token prompt against JAX's,
  logits at every step and the final cache, and the greedy tokens wherever
  the reference's top-1/top-2 margin is clear of the tolerance;
* the structure of the path: each prefill goes through the SSD scan once
  per layer, whatever ``scan_impl`` says, and a decode step never; the
  serve driver runs on the CPU.

Short prompts (both families, recurrentgemma too): a prefill of s = 1 ... w
tokens (w the conv width) followed by decode steps gives what s + k decode
steps from ``cache_init`` give, and where JAX runs (s >= w - 1; shorter
prompts make the reference's next decode step fail) what JAX gives: for
recurrentgemma's decode steps, each package within the bound of a float64
run of the port, since their two bf16 roundings add up to just past it.

Whole-model tolerance: 6e-2 (atol and rtol), as
``tests/test_torch_griffin.py`` holds bf16 logits: activations are bf16
whatever the params' dtype, and XLA rounds fused elementwise chains at
other places than PyTorch's op-by-op execution (and a prefill at other
places than stepwise decoding). The embedding is scaled by 10 in both
packages' weights, so logits are O(10) and greedy margins clear the
tolerance; recurrentgemma's attention projections are at their true
fan-in, as in its own tests.
"""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.kernels.ssd.ops  # noqa: F401  (XAIF registration of "pallas")
from repro import configs as jconfigs
from repro.models import mamba2 as jm
from repro.models import registry as jreg
from repro.sharding import params as JP

torch = configs = params_from_numpy = registry = mamba2 = griffin = None
ssd_ops = launch_serve = build_serve = None  # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, configs, params_from_numpy, registry, mamba2, griffin
    global ssd_ops, launch_serve, build_serve
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import griffin, mamba2, registry
    from repro_torch.serve.engine import build_serve
    torch.set_num_threads(1)


ARCH = "mamba2_370m"
MODEL_TOL = 6e-2                  # whole model, bf16 activations
FIELDS = ("conv_x", "conv_B", "conv_C", "state")


def _np(t):
    return t.float().numpy()


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def _weights(arch, dtype="bfloat16"):
    """(jax cfg, jax params, port cfg, port params): the JAX package's init
    from key 1, cast to ``dtype``, the embedding x 10 (and recurrentgemma's
    attention at its true fan-in), in both packages."""
    jcfg, cfg = jconfigs.smoke(arch), configs.smoke(arch)
    jparams = JP.init_tree(jreg.decls(jcfg), jax.random.key(1))
    if dtype == "bfloat16":
        jparams = JP.cast_tree(jparams, jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jparams)
    scaled = griffin.true_fan_in(tree, cfg) if cfg.family == "hybrid" else \
        dict(tree)
    scaled["embed"] = scaled["embed"] * 10.0
    tree = jax.tree.map(lambda new, old: np.asarray(new).astype(old.dtype),
                        scaled, tree)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, params_from_numpy(
        tree, "cpu")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    return _weights(ARCH, request.param)


def _prompt(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# Declarations, cache, pieces
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
        assert configs.get(ARCH).param_count() == 368_227_840


def test_full_width_cache_shapes():
    conv_x, conv_bc, state = mamba2.SSMCache.shapes(configs.get(ARCH), 8)
    assert conv_x == (48, 8, 3, 2048) and conv_bc == (48, 8, 3, 128)
    assert state == (48, 8, 32, 64, 128)
    cache = registry.cache_init(configs.smoke(ARCH), 2, 20, device="cpu")
    assert cache.conv_x.dtype == cache.conv_B.dtype == torch.bfloat16
    assert cache.state.dtype == torch.float32 and int(cache.pos) == 0
    assert tuple(cache.state.shape) == (2, 2, 8, 16, 16)
    assert not registry.supports_paged(configs.smoke(ARCH))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_math_matches_jax(dtype):
    """On identical inputs, with dt_bias large enough in two heads that
    ``F.softplus``'s threshold at 20 would part from jax's softplus, and a
    nonzero A_log."""
    cfg, jcfg = configs.smoke(ARCH), jconfigs.smoke(ARCH)
    rng = np.random.default_rng(4)
    b, s, di, n, h = 2, 6, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    xin, Braw, Craw = (rng.normal(size=(b, s, k)).astype(np.float32)
                       for k in (di, n, n))
    dt_raw = rng.normal(size=(b, s, h)).astype(np.float32)
    lp = {"dt_bias": (rng.normal(size=h) * 0.5).astype(np.float32),
          "A_log": (rng.normal(size=h) * 0.5).astype(np.float32)}
    lp["dt_bias"][:2] = [21.0, 30.0]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jm._ssm_math(*(jnp.asarray(a, jd) for a in (xin, Braw, Craw,
                                                        dt_raw)),
                        {k: jnp.asarray(v) for k, v in lp.items()}, jcfg)
    got = mamba2._ssm_math(*(torch.from_numpy(a).to(td)
                             for a in (xin, Braw, Craw, dt_raw)),
                           {k: torch.from_numpy(v) for k, v in lp.items()},
                           cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[1] == str(w.dtype)
        _close(g, w, 2e-5 if dtype == "float32" else 3e-2)
    assert got[3].stride(2) == got[4].stride(2) == 0     # B, C not copied


# ---------------------------------------------------------------------------
# Prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,s", [("chunked", 12), ("chunked", 16),
                                    ("pallas", 16)])
def test_prefill_matches_jax(model, impl, s):
    jcfg, jparams, cfg, params = model
    jcfg = dataclasses.replace(jcfg, scan_impl=impl)
    toks = _prompt(cfg, 2, s)
    want_logits, want = jax.jit(lambda p, t: jreg.prefill(
        p, jcfg, tokens=t, max_len=s + 8))(jparams, toks)
    logits, cache = registry.prefill(params, cfg, torch.from_numpy(toks),
                                     max_len=s + 8)
    assert logits.shape == (2, cfg.padded_vocab)
    _close(logits, want_logits, MODEL_TOL, "logits")
    for f in FIELDS:
        got, ref_f = getattr(cache, f), getattr(want, f)
        assert tuple(got.shape) == ref_f.shape, f
        assert str(got.dtype).split(".")[1] == str(ref_f.dtype), f
        _close(got, ref_f, MODEL_TOL, f)
    assert int(cache.pos) == int(want.pos) == s


def _decode_against_jax(jcfg, jparams, cfg, params, toks, s, steps,
                        logits, cache, jcache):
    """Teacher-force ``steps`` tokens through both packages from their
    caches; returns the port's and JAX's last caches and how many greedy
    tokens were compared."""
    jstep = jax.jit(lambda p, c, t: jreg.decode_step(p, jcfg, c, t))
    agree = 0
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
    return cache, jcache, agree


def test_teacher_forced_decode_matches_jax(model):
    jcfg, jparams, cfg, params = model
    s, steps = 12, 24
    toks = _prompt(cfg, 2, s + steps, seed=5)
    _, jcache = jax.jit(lambda p, t: jreg.prefill(
        p, jcfg, tokens=t, max_len=s + steps))(jparams, toks[:, :s])
    logits, cache = registry.prefill(params, cfg, torch.from_numpy(toks[:, :s]),
                                     max_len=s + steps)
    cache, jcache, agree = _decode_against_jax(
        jcfg, jparams, cfg, params, toks, s, steps, logits, cache, jcache)
    # greedy tokens were compared at a good share of the 2 x 24 positions
    # (15 here: the margin rule needs |top1 - top2| > 0.12 (1 + |top1|))
    assert agree >= steps // 2
    for f in FIELDS:
        _close(getattr(cache, f), getattr(jcache, f), MODEL_TOL, f)
    assert int(cache.pos) == int(jcache.pos) == s + steps


# ---------------------------------------------------------------------------
# The path: the scan per call, the registry, the driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_impl", ["chunked", "ref", "pallas"])
def test_prefill_scans_once_per_layer_and_decode_never(scan_impl):
    """The structure ``chip_smoke.py`` counts on the card (48 SSD launches
    per full-width prefill, none per decode step), counted here at the
    dispatch point on the 2-layer smoke model, whatever ``scan_impl``
    says."""
    cfg = dataclasses.replace(configs.smoke(ARCH), scan_impl=scan_impl)
    from repro_torch.sharding.params import init_tree
    params = init_tree(registry.decls(cfg), 0, "cpu", dtype=torch.bfloat16)
    calls, real = [], ssd_ops._scan

    def counted(*a):
        calls.append(a)
        return real(*a)

    sv = build_serve(cfg, 2, 24, prefill_len=20, device="cpu")
    with mock.patch.object(ssd_ops, "_scan", counted):
        logits, cache = sv.prefill_fn(params, torch.zeros((2, 20),
                                                          dtype=torch.long))
        assert len(calls) == cfg.n_layers == 2
        x, dA, B, C, chunk = calls[0]
        assert x.dtype == dA.dtype == torch.float32 and chunk == 8
        assert B.dtype == torch.bfloat16 and B.stride(2) == 0
        for _ in range(3):
            logits, cache = sv.decode_fn(params, cache,
                                         torch.argmax(logits, -1)[:, None])
        assert len(calls) == 2
    assert not logits.requires_grad and torch.isfinite(logits).all()
    assert int(cache.pos) == 23


def test_serve_needs_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.cache_init(configs.smoke(ARCH), 2, 24)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "mamba2-370m", "--smoke"])


def test_launcher_runs_on_cpu(capsys):
    run = launch_serve.main(["--arch", "mamba2-370m", "--smoke",
                             "--device", "cpu", "--batch", "2",
                             "--prompt-len", "20", "--steps", "5"])
    out = capsys.readouterr().out
    assert "mamba2-smoke on cpu: prefill 2 x 20 tokens" in out
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


# ---------------------------------------------------------------------------
# Short prompts, both recurrent families
# ---------------------------------------------------------------------------

SHORT = ["mamba2_370m", "recurrentgemma_2b"]
SHORT_STEPS = 3


@pytest.fixture(scope="module")
def short_models():
    return {arch: _weights(arch) for arch in SHORT}


def _cache_fields(cache):
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)
            if f.name != "pos"}


@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("arch", SHORT)
def test_short_prompt_prefill_then_decode_equals_stepwise(short_models,
                                                          arch, s):
    """Prefill of s tokens, then 3 decode steps, against s + 3 decode steps
    from ``cache_init`` (the conv width is 4 in both smoke configs, so s 1
    and 2 are shorter than the conv tail): logits after each of the last 4
    positions, and the final caches."""
    _, _, cfg, params = short_models[arch]
    assert cfg.ssm_conv_width == 4
    k = SHORT_STEPS
    toks = torch.from_numpy(_prompt(cfg, 2, s + k, seed=s)).long()
    logits, cache = registry.prefill(params, cfg, toks[:, :s], max_len=s + k)
    got = [logits]
    for t in range(k):
        logits, cache = registry.decode_step(params, cfg, cache,
                                             toks[:, s + t:s + t + 1])
        got.append(logits)
    ref_cache = registry.cache_init(cfg, 2, s + k, device="cpu")
    want = []
    for t in range(s + k):
        logits, ref_cache = registry.decode_step(params, cfg, ref_cache,
                                                 toks[:, t:t + 1])
        want.append(logits)
    for i, (g, w) in enumerate(zip(got, want[s - 1:])):
        _close(g, _np(w), MODEL_TOL, f"position {s - 1 + i}")
    want_fields = _cache_fields(ref_cache)
    for name, t in _cache_fields(cache).items():
        assert t.shape == want_fields[name].shape, name
        _close(t, _np(want_fields[name]), MODEL_TOL, name)
    assert int(cache.pos) == int(ref_cache.pos) == s + k


@pytest.mark.parametrize("s", [3, 4])
@pytest.mark.parametrize("arch", SHORT)
def test_short_prompt_matches_jax(short_models, arch, s):
    """Where the reference runs (s >= conv width - 1), the port's prefill
    of a short prompt matches JAX's: the logits and every cache field, the
    conv tails included. For mamba2 the 3 decode steps that read the tail
    are compared too (the two packages agree to a bf16 ulp or two there);
    recurrentgemma's are held to JAX through a float64 yardstick by
    :func:`test_griffin_short_prompt_decode_matches_jax`."""
    jcfg, jparams, cfg, params = short_models[arch]
    k = SHORT_STEPS
    toks = _prompt(cfg, 2, s + k, seed=s)
    want, jcache = jax.jit(lambda p, t: jreg.prefill(
        p, jcfg, tokens=t, max_len=s + k))(jparams, toks[:, :s])
    logits, cache = registry.prefill(params, cfg, torch.from_numpy(toks[:, :s]),
                                     max_len=s + k)
    _close(logits, want, MODEL_TOL, "prefill logits")
    for name, t in _cache_fields(cache).items():
        _close(t, getattr(jcache, name), MODEL_TOL, name)
    if cfg.family == "ssm":
        cache, jcache, _ = _decode_against_jax(
            jcfg, jparams, cfg, params, toks, s, k, logits, cache, jcache)
        for name, t in _cache_fields(cache).items():
            _close(t, getattr(jcache, name), MODEL_TOL, name)


@contextlib.contextmanager
def _griffin_in_float64():
    """The port's Griffin with every bf16 and float32 boundary widened to
    float64 (the RG-LRU scan through its float64 plain version): the
    rounding-free yardstick of the test below, on the same weights."""
    from repro_torch.kernels.rglru import ref as rglru_ref
    from repro_torch.models import layers as L
    f64 = torch.float64
    with mock.patch.object(griffin, "BF16", f64), \
            mock.patch.object(griffin, "F32", f64), \
            mock.patch.object(L, "F32", f64), \
            mock.patch.object(griffin, "linear_scan",
                              lambda a, b, h0=None, impl=None:
                              rglru_ref.rglru(a, b, h0)):
        yield


def _serve_steps(params, cfg, toks, s, k):
    """Prefill of ``toks[:, :s]``, then ``k`` teacher-forced decode steps:
    ``(the k + 1 logits, the final cache)``."""
    toks = torch.from_numpy(toks).long()
    logits, cache = registry.prefill(params, cfg, toks[:, :s], max_len=s + k)
    out = [logits]
    for t in range(k):
        logits, cache = registry.decode_step(params, cfg, cache,
                                             toks[:, s + t:s + t + 1])
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("s", [3, 4])
def test_griffin_short_prompt_decode_matches_jax(short_models, s):
    """recurrentgemma's decode steps after a short prompt, the steps that
    read the prefill's conv tail, held to JAX through a float64 run of the
    port on the same (bf16-valued) weights: the port's bf16 logits and
    JAX's are each within 6e-2 of it at every step, and so are the final
    caches. JAX's structure is thereby held to the port's independently
    of both packages' bf16 rounding: a conv tail or ring slot wrong in the
    port would put JAX far from the yardstick.

    The two bf16 runs are not compared with each other directly. Each
    rounds about 3e-2 (in |got - want| / (1 + |want|)) away from the
    yardstick, and after 4 tokens the two roundings add up to just past
    6e-2 on one logit of 512 in the third step (0.077 on a logit of 0.27;
    after the 12-token prompt of ``tests/test_torch_griffin.py`` they stay
    under the bound). ``pytest -s`` prints the three distances a step."""
    jcfg, jparams, cfg, params = short_models["recurrentgemma_2b"]
    k = SHORT_STEPS
    toks = _prompt(cfg, 2, s + k, seed=s)
    want, jcache = jax.jit(lambda p, t: jreg.prefill(
        p, jcfg, tokens=t, max_len=s + k))(jparams, toks[:, :s])
    want = [want]
    jstep = jax.jit(lambda p, c, t: jreg.decode_step(p, jcfg, c, t))
    for t in range(k):
        logits, jcache = jstep(jparams, jcache, toks[:, s + t:s + t + 1])
        want.append(logits)
    got, cache = _serve_steps(params, cfg, toks, s, k)
    from repro_torch.sharding.params import tree_map
    params64 = tree_map(lambda a: a.to(torch.float64), params)
    with _griffin_in_float64():
        wide, wcache = _serve_steps(params64, cfg, toks, s, k)
    v = cfg.vocab
    dist = lambda a, b: float((np.abs(a - b) / (1 + np.abs(b))).max())
    for i, w in enumerate(wide):
        assert w.dtype == torch.float64
        ref_w = w.numpy()[:, :v]
        port, ref_j = _np(got[i])[:, :v], np.array(want[i], np.float64)[:, :v]
        print(f"griffin, {s}-token prompt, position {s - 1 + i}: "
              f"|got - want| / (1 + |want|) port vs float64 "
              f"{dist(port, ref_w):.4f}, jax vs float64 "
              f"{dist(ref_j, ref_w):.4f}, port vs jax {dist(port, ref_j):.4f}")
        _close(got[i][:, :v], ref_w, MODEL_TOL, f"port, position {s - 1 + i}")
        _close(torch.from_numpy(np.array(want[i], np.float32)[:, :v]),
               ref_w, MODEL_TOL, f"jax, position {s - 1 + i}")
    for name, t in _cache_fields(wcache).items():
        assert t.dtype == torch.float64, name
        _close(getattr(cache, name), t.numpy(), MODEL_TOL, f"port {name}")
        _close(torch.from_numpy(np.array(getattr(jcache, name), np.float32)),
               t.numpy(), MODEL_TOL, f"jax {name}")
    assert int(cache.pos) == int(wcache.pos) == int(jcache.pos) == s + k


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b"])
def test_launcher_takes_a_two_token_prompt(arch, capsys):
    run = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "2",
                             "--steps", "3"])
    assert "prefill 2 x 2 tokens" in capsys.readouterr().out
    assert tuple(run.tokens.shape) == (2, 3) and int(run.cache.pos) == 5
    assert torch.isfinite(run.logits.float()).all()
