"""Teacher-forced paged decode and the serve driver's prefill and decode:
the port against ``repro.models.registry``.

The same weights (made by the JAX package, bridged with
``repro_torch.bridge``) and the same token stream go through both packages'
``decode_step_paged`` for 8 steps, on three lanes with ragged lengths: the
lanes join at steps 0, 2 and 5 and ride the batch idle (append masked,
logits ignored) before that. Logits of the active lanes are compared at
every step, on four smoke configs: granite (GQA), stablelm (MHA), nemotron
(squared ReLU) and musicgen (sinusoidal positions, tanh-gelu).

The serve driver's path (``registry.prefill`` and ``decode_step`` over a
``KVCache``) for the dense and MoE families: ``prefill`` against JAX's
(last logits and the KV cache), then teacher-forced ``decode_step`` logits,
on the granite, h2o-danube (sliding window), grok (every layer MoE, top-2)
and llama4 (MoE every second layer, top-1, shared expert) smoke configs,
the JAX side with its expert FFN chunked and through the Pallas kernel
(interpret mode). A decode step after a prefill equals the last position
of a longer prefill inside the port (at a capacity that drops nothing, as
``tests/test_models.py:86-91`` sets it), and ``launch.serve`` runs grok,
llama4 and granite on the CPU.

Tolerances: float32 (float32 pool) 2e-5: the frameworks differ only in
summation order, which through a few layers and the LM head stays well
inside it. bfloat16 (bf16 pool, the serving setting) 6e-2: each framework
rounds its bf16 intermediates at other places (XLA keeps fused elementwise
chains in float32), so the residual stream drifts by a few bf16 ulps; the
logits are O(1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.sharding import params as JP

import repro.kernels  # noqa: F401  (XAIF registration of "pallas")

torch = configs = params_from_numpy = registry = None
transformer = launch_serve = None  # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, configs, params_from_numpy, registry, transformer
    global launch_serve
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import registry, transformer
    torch.set_num_threads(1)


TOL = {"float32": 2e-5, "bfloat16": 6e-2}
ARCHS = ["granite_3_2b", "stablelm_3b", "nemotron_4_15b", "musicgen_large"]
STEPS, PS, JOIN = 8, 4, (0, 2, 5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_logits_match_jax(arch, dtype):
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(configs.smoke(arch), dtype=dtype)
    jparams = JP.init_tree(jreg.decls(jcfg), jax.random.key(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")

    rng = np.random.default_rng(7)
    b = len(JOIN)
    n_pages = -(-STEPS // PS)
    tables = rng.permutation(b * n_pages).reshape(b, n_pages).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab, size=(STEPS, b)).astype(np.int32)
    shape = (cfg.n_layers, b * n_pages + 1, PS, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    pool_dtype = {"float32": (jnp.float32, torch.float32),
                  "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jk = jv = jnp.zeros(shape, pool_dtype[0])
    tk, tv = (torch.zeros(shape, dtype=pool_dtype[1]) for _ in range(2))
    step = jax.jit(lambda p, pk, pv, t, ln, tok, m: jreg.decode_step_paged(
        p, jcfg, pk, pv, t, ln, tok, append_mask=m))

    for t in range(STEPS):
        mask = np.array([t >= j for j in JOIN])
        lengths = np.array([max(0, t - j) for j in JOIN], np.int32)
        want, jk, jv = step(jparams, jk, jv, tables, lengths, tokens[t], mask)
        got, tk2, tv2 = registry.decode_step_paged(
            params, cfg, tk, tv, torch.from_numpy(tables),
            torch.from_numpy(lengths), torch.from_numpy(tokens[t]),
            append_mask=torch.from_numpy(mask))
        assert tk2 is tk and tv2 is tv              # the pool is written in place
        assert got.shape == (b, cfg.padded_vocab)
        np.testing.assert_allclose(
            got.float().numpy()[mask], np.asarray(want, np.float32)[mask],
            atol=TOL[dtype], rtol=TOL[dtype], err_msg=f"{arch} step {t}")


def test_unported_families_raise():
    """Every family is ported: the VLM family's declarations (the last to
    come) are the transformer's, at the reference's parameter count; an
    unknown family raises."""
    for arch in ("internvl2_76b",):
        decls = registry.decls(configs.smoke(arch))
        assert set(decls) == {"embed", "blocks", "ln_f", "head"}
        assert configs.get(arch).param_count() == \
            jconfigs.get(arch).param_count()
    bad = dataclasses.replace(configs.smoke("granite_3_2b"), family="vision")
    with pytest.raises(ValueError, match="unknown family"):
        registry.decls(bad)


def test_full_width_granite_param_count():
    cfg = configs.get("granite_3_2b")
    assert cfg.param_count() == 2_533_531_648
    assert cfg.param_count() == jconfigs.get("granite_3_2b").param_count()


# ---------------------------------------------------------------------------
# The serve driver: prefill and decode_step over a KVCache
# ---------------------------------------------------------------------------

# (arch, the JAX side's moe_impl): granite and h2o-danube (sliding window
# 16: a 20-token prompt fills the ring, and decode wraps it) are dense
SERVE_CASES = [("granite_3_2b", "chunked"), ("h2o_danube3_4b", "chunked"),
               ("grok_1_314b", "chunked"), ("grok_1_314b", "pallas"),
               ("llama4_maverick_400b", "chunked"),
               ("llama4_maverick_400b", "pallas")]
SERVE_STEPS = 6
# The KV cache is bf16 in both packages, whatever the activations' dtype
# (the reference's ``cdtype``). In float32 a K or V value that the two
# frameworks compute a few float32 ulps apart can round to neighbouring
# bf16 values, one bf16 ulp (2^-8 relative) apart: CACHE_TOL. From the step
# such an entry first differs, the float32 logits are held at FLIP_TOL
# instead of TOL (grok smoke, one V entry a bf16 ulp apart: 3.3e-5).
CACHE_TOL = {"float32": 1e-2, "bfloat16": 6e-2}
FLIP_TOL = {"float32": 1e-4, "bfloat16": TOL["bfloat16"]}


def _serve_model(arch, dtype, moe_impl="chunked"):
    """(jax cfg, jax params, port cfg, port params): the smoke config in
    ``dtype``, weights made by the JAX package (cast to bf16 for bf16) with
    the attention projections at their true fan-in
    (``transformer.true_fan_in``, ROADMAP queue 3: at the reference's init
    wk has std 0.7 and the keys of the second layer are O(10), so the bf16
    rounding differences of the first layer's output come back as several
    bf16 ulps of those keys)."""
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype=dtype,
                               moe_impl=moe_impl)
    cfg = dataclasses.replace(configs.smoke(arch), dtype=dtype)
    jparams = JP.init_tree(jreg.decls(jcfg), jax.random.key(1))
    if dtype == "bfloat16":
        jparams = JP.cast_tree(jparams, jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jparams)
    tree = jax.tree.map(lambda new, old: np.asarray(new).astype(old.dtype),
                        transformer.true_fan_in(tree, cfg), tree)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, params_from_numpy(
        tree, "cpu")


def _prompt_len(cfg):
    return 20 if cfg.sliding_window else 12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,moe_impl", SERVE_CASES)
def test_serve_driver_prefill_and_decode_match_jax(arch, moe_impl, dtype):
    jcfg, jparams, cfg, params = _serve_model(arch, dtype, moe_impl)
    s = _prompt_len(cfg)
    max_len = s + SERVE_STEPS
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, size=(2, s + SERVE_STEPS)).astype(np.int32)
    jprefill = jax.jit(lambda p, t: jreg.prefill(p, jcfg, tokens=t,
                                                 max_len=max_len))
    jstep = jax.jit(lambda p, c, t: jreg.decode_step(p, jcfg, c, t))

    def check_cache(cache, jcache, what):
        """Caches within CACHE_TOL; True where an entry differs."""
        flipped = False
        for name in ("k", "v"):
            got_c = getattr(cache, name).float().numpy()
            want_c = np.asarray(getattr(jcache, name), np.float32)
            np.testing.assert_allclose(got_c, want_c, atol=CACHE_TOL[dtype],
                                       rtol=CACHE_TOL[dtype],
                                       err_msg=f"{arch} {what} cache {name}")
            flipped |= bool((got_c != want_c).any())
        return flipped

    want, jcache = jprefill(jparams, toks[:, :s])
    got, cache = registry.prefill(params, cfg, torch.from_numpy(toks[:, :s]),
                                  max_len=max_len)
    assert isinstance(cache, transformer.KVCache) and int(cache.pos) == s
    assert cache.k.dtype == torch.bfloat16 and cache.k.shape == jcache.k.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype],
                               err_msg=f"{arch} prefill")
    flipped = check_cache(cache, jcache, "prefill")

    for t in range(SERVE_STEPS):
        tok = toks[:, s + t:s + t + 1]
        want, jcache = jstep(jparams, jcache, tok)
        got, cache2 = registry.decode_step(params, cfg, cache,
                                           torch.from_numpy(tok))
        assert cache2 is cache                      # written in place
        flipped |= check_cache(cache, jcache, f"step {t}")
        tol = FLIP_TOL[dtype] if flipped else TOL[dtype]
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32),
            atol=tol, rtol=tol, err_msg=f"{arch} step {t}")
    assert int(cache.pos) == int(jcache.pos) == max_len


@pytest.mark.parametrize("arch", ["granite_3_2b", "h2o_danube3_4b",
                                  "grok_1_314b", "llama4_maverick_400b"])
def test_decode_after_prefill_equals_a_longer_prefill(arch):
    """Inside the port, on the smoke config (bf16 activations, so the bf16
    cache holds K and V as the prefill computed them): the logits of a
    decode step after an S-token prefill equal the last position of an
    (S + 1)-token prefill, at the bf16 bound. At capacity factor 8.0 no
    slot is dropped, so each token's expert output does not depend on the
    others routed with it (as ``tests/test_models.py:86-91`` sets it)."""
    cfg = dataclasses.replace(configs.smoke(arch), moe_capacity_factor=8.0)
    from repro_torch.sharding.params import init_tree
    params = init_tree(registry.decls(cfg), 0, "cpu")
    s = _prompt_len(cfg)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, s + 2)))
    with torch.inference_mode():
        _, cache = registry.prefill(params, cfg, toks[:, :s], max_len=s + 2)
        for i in range(2):
            step, cache = registry.decode_step(params, cfg, cache,
                                               toks[:, s + i:s + i + 1])
            full, _ = registry.prefill(params, cfg, toks[:, :s + i + 1],
                                       max_len=s + 2)
            torch.testing.assert_close(step.float(), full.float(),
                                       atol=TOL["bfloat16"],
                                       rtol=TOL["bfloat16"])


def test_kv_cache_shapes():
    cfg = configs.smoke("h2o_danube3_4b")          # window 16
    cache = registry.cache_init(cfg, 2, 40, device="cpu")
    assert tuple(cache.k.shape) == (cfg.n_layers, 2, 16, cfg.n_kv_heads,
                                    cfg.resolved_head_dim)
    assert cache.k.dtype == cache.v.dtype == torch.bfloat16
    assert int(cache.pos) == 0 and cache.pos.dtype == torch.int32
    grok = configs.get("grok_1_314b")
    assert transformer.KVCache.cache_len(grok, 1088) == 1088
    assert not registry.supports_paged(grok)        # the engine refuses MoE


@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-maverick-400b-a17b",
                                  "granite-3-2b"])
def test_serve_launcher_runs_on_cpu(arch, capsys):
    run = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "12",
                             "--steps", "4"])
    out = capsys.readouterr().out
    assert "prefill 2 x 12 tokens" in out and "tok/s" in out
    assert "not measured (cpu)" in out
    assert tuple(run.tokens.shape) == (2, 4) and int(run.cache.pos) == 16
    assert all(leaf.dtype == torch.bfloat16
               for leaf in jax.tree.leaves(run.params))
    assert bool(torch.isfinite(run.logits.float()).all())
