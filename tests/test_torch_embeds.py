"""Embeds inputs (the audio and VLM families' stubbed front ends): the port
against the JAX package.

musicgen-smoke (sinusoidal positions, tanh-gelu, MHA) and internvl2-smoke
(rope, swiglu, GQA) take precomputed embeddings (``embed_inputs=False``) in
place of tokens. The same weights (made by the JAX package, carried across
with ``repro_torch.bridge``) and the same numpy embeddings go through both
packages: the training forward's logits, the serve driver's prefill from
embeddings followed by teacher-forced decode steps on tokens, and the
train loss with every leaf's gradient against ``jax.grad``. The
recurrent families take the same ``embeds`` argument (no configuration of
theirs uses it): griffin-smoke's and mamba2-smoke's forward from
embeddings against the JAX package's. Also the data pipeline's
``embed_dim`` batches, the serve driver and the launchers on embeddings.

The configs run in float32. With float32 embeddings the activations are
float32: logits at 2e-5. With bf16 embeddings the activations are bf16 (the
reference's ``_embed`` keeps the embeddings' dtype, and the sinusoidal
table is cast to it before the add): logits at 6e-2, as
``tests/test_torch_transformer.py``'s bf16 bound. Both relative to the
logits' scale (``atol`` = tol x max(1, max |logit|)), as
``tests/test_torch_train.py`` holds them. The train loss and gradients are
held at ``tests/test_torch_train.py``'s float32 step bounds for the
reference init: loss 1e-5, each leaf's gradient 2e-4 in norm (the bound
that file puts on the whole gradient's norm).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.sharding import params as JP
from repro.train import trainer as jtrainer

torch = configs = params_from_numpy = registry = transformer = None
lm = trainer = tree_leaves = launch_serve = launch_train = None
build_serve = None  # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, configs, params_from_numpy, registry, transformer, lm
    global trainer, tree_leaves, launch_serve, launch_train, build_serve
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.data import lm
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import registry, transformer
    from repro_torch.serve.engine import build_serve
    from repro_torch.sharding.params import tree_leaves
    from repro_torch.train import trainer
    torch.set_num_threads(1)


ARCHS = ["musicgen_large", "internvl2_76b"]
TOL = {"float32": 2e-5, "bfloat16": 6e-2}
# tests/test_torch_train.py's STEP_TOL["reference"]: loss, gradient norm
LOSS_TOL, GRAD_TOL = 1e-5, 2e-4
# the KV cache is bf16 in both packages; see tests/test_torch_transformer.py
CACHE_TOL = {"float32": 1e-2, "bfloat16": 6e-2}
FLIP_TOL = {"float32": 1e-4, "bfloat16": TOL["bfloat16"]}


def _np(t):
    return t.detach().float().numpy()


def _models(arch, seed=1):
    """(jax cfg, jax params, port cfg, port params): the smoke config in
    float32 on the JAX package's weights."""
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype="float32",
                               attn_impl="chunked")
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    jparams = JP.init_tree(jreg.decls(jcfg), jax.random.key(seed))
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def _embeds(shape, dtype, seed=3):
    """The same embeddings for both packages: (jax array, torch tensor), in
    float32 or rounded to bf16 by each (round to nearest even: the same
    bits)."""
    e = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if dtype == "float32":
        return jnp.asarray(e), torch.from_numpy(e)
    return jnp.asarray(e, jnp.bfloat16), torch.from_numpy(e).to(torch.bfloat16)


def _close(got, want, tol, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=msg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_from_embeds_match_jax(arch, dtype):
    jcfg, jparams, cfg, params = _models(arch)
    assert not registry.uses_token_inputs(cfg)
    jemb, emb = _embeds((2, 24, cfg.d_model), dtype)
    want, _ = jreg.forward(jparams, jcfg, embeds=jemb)
    got, aux = registry.forward(params, cfg, embeds=emb)
    assert got.shape == (2, 24, cfg.padded_vocab) and aux.item() == 0.0
    assert got.dtype == emb.dtype == getattr(torch, str(want.dtype))
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_from_embeds_then_decode_match_jax(arch, dtype):
    """The serve driver's path: a prefill of 12 embeddings (last logits and
    the bf16 KV cache), then 4 teacher-forced decode steps on tokens."""
    jcfg, jparams, cfg, params = _models(arch)
    s, steps = 12, 4
    max_len = s + steps
    jemb, emb = _embeds((2, s, cfg.d_model), dtype)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(2, steps)).astype(np.int32)

    def check_cache(cache, jcache, what):
        flipped = False
        for name in ("k", "v"):
            got_c = getattr(cache, name).float().numpy()
            want_c = np.asarray(getattr(jcache, name), np.float32)
            np.testing.assert_allclose(got_c, want_c, atol=CACHE_TOL[dtype],
                                       rtol=CACHE_TOL[dtype],
                                       err_msg=f"{arch} {what} cache {name}")
            flipped |= bool((got_c != want_c).any())
        return flipped

    want, jcache = jreg.prefill(jparams, jcfg, embeds=jemb, max_len=max_len)
    got, cache = registry.prefill(params, cfg, embeds=emb, max_len=max_len)
    assert isinstance(cache, transformer.KVCache) and int(cache.pos) == s
    _close(got, want, TOL[dtype], f"{arch} prefill")
    flipped = check_cache(cache, jcache, "prefill")
    jstep = jax.jit(lambda p, c, t: jreg.decode_step(p, jcfg, c, t))
    for t in range(steps):
        tok = toks[:, t:t + 1]
        want, jcache = jstep(jparams, jcache, tok)
        got, _ = registry.decode_step(params, cfg, cache, torch.from_numpy(tok))
        flipped |= check_cache(cache, jcache, f"step {t}")
        _close(got, want, FLIP_TOL[dtype] if flipped else TOL[dtype],
               f"{arch} step {t}")
    assert int(cache.pos) == int(jcache.pos) == max_len


@pytest.mark.parametrize("arch,accum", [("musicgen_large", 2),
                                        ("internvl2_76b", 1)])
def test_train_loss_and_leaf_grads_from_embeds_match_jax(arch, accum):
    """The loss and the gradients a step hands its optimizer
    (``trainer.make_grad_fn``, averaged over the microbatches, which carry
    the embeddings) against the reference's loss and ``jax.grad`` averaged
    the same way, on float32 embeddings."""
    jcfg, jparams, cfg, params = _models(arch)
    rng = np.random.default_rng(4)
    batch = {"embeds": rng.normal(size=(accum, 2, 16, cfg.d_model)).astype(
                 np.float32),
             "labels": rng.integers(0, cfg.vocab, size=(accum, 2, 16)).astype(
                 np.int32)}
    tc = jtrainer.TrainConfig(accum=accum)
    jloss = jtrainer.make_loss_fn(jcfg, tc)
    jmb = [{k: jnp.asarray(v[i]) for k, v in batch.items()}
           for i in range(accum)]
    jl, jg = zip(*(jax.value_and_grad(lambda p, mb: jloss(p, mb)[0])(
        jparams, mb) for mb in jmb))
    want = [np.asarray(sum(gs) / accum, np.float64)
            for gs in zip(*(jax.tree.leaves(g) for g in jg))]
    grad_fn = trainer.make_grad_fn(
        cfg, trainer.TrainConfig(**dataclasses.asdict(tc)))
    loss, _, grads = grad_fn(params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(np.mean(jl)),
                               rtol=LOSS_TOL)
    got = [g.double().numpy() for g in tree_leaves(grads)]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        # the embedding table gets no gradient from embeddings: zero in both
        assert np.isfinite(g).all() and np.isfinite(w).all()
    errs = [float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
            if np.any(w) else float(np.abs(g).max()) for g, w in zip(got, want)]
    assert max(errs) <= GRAD_TOL, errs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "mamba2_370m"])
def test_recurrent_forward_from_embeds_matches_jax(arch, dtype):
    """griffin and mamba2 take the same ``embeds`` argument: the
    activations take the embeddings' dtype (griffin scales them by
    sqrt(d_model) rounded to it)."""
    jcfg = jconfigs.smoke(arch)
    cfg = configs.smoke(arch)
    jparams = JP.init_tree(jreg.decls(jcfg), jax.random.key(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jemb, emb = _embeds((2, 24, cfg.d_model), dtype)
    want, _ = jax.jit(lambda p, e: jreg.forward(p, jcfg, embeds=e))(jparams,
                                                                   jemb)
    got, _ = registry.forward(params, cfg, embeds=emb)
    assert got.dtype == emb.dtype
    _close(got, want, TOL[dtype], arch)


def test_one_of_tokens_and_embeds():
    _, _, cfg, params = _models("internvl2_76b")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="exactly one"):
        registry.forward(params, cfg, tokens=tokens,
                         embeds=torch.zeros(1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="exactly one"):
        registry.prefill(params, cfg)
    assert registry.uses_token_inputs(configs.smoke("granite_3_2b"))


def test_vlm_decls_match_the_reference():
    """The VLM family's parameter tree: the reference's keys and shapes, at
    smoke size and at internvl2-76b's full width."""
    for cfg, jcfg in ((configs.smoke("internvl2_76b"),
                       jconfigs.smoke("internvl2_76b")),
                      (configs.get("internvl2_76b"),
                       jconfigs.get("internvl2_76b"))):
        want = jax.tree.leaves(jax.tree.map(
            lambda d: tuple(d.shape), jreg.decls(jcfg),
            is_leaf=lambda d: hasattr(d, "shape")), is_leaf=lambda x:
            isinstance(x, tuple))
        got = [tuple(d.shape) for d in tree_leaves(registry.decls(cfg))]
        assert got == want
        assert cfg.param_count() == jcfg.param_count()


def test_lm_pipeline_embeds_branch():
    c = lm.LMDataConfig(vocab=64, seq=10, global_batch=6, accum=3, seed=2,
                        embed_dim=8)
    b = lm.LMPipeline(c).batch_at(5)
    assert set(b) == {"embeds", "labels"}
    assert b["embeds"].shape == (3, 2, 10, 8)
    assert b["embeds"].dtype == torch.bfloat16
    assert b["labels"].shape == (3, 2, 10)
    again = lm.LMPipeline(c).batch_at(5)
    assert torch.equal(b["embeds"], again["embeds"])
    assert not torch.equal(b["embeds"], lm.LMPipeline(c).batch_at(6)["embeds"])
    # the labels are the token pipeline's
    toks = lm.LMPipeline(dataclasses.replace(c, embed_dim=None)).batch_at(5)
    assert torch.equal(b["labels"], toks["labels"])
    std = b["embeds"].float().std().item()
    assert 0.7 < std < 1.3


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-76b"])
def test_serve_launcher_runs_on_embeddings(arch, capsys):
    run = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "12",
                             "--steps", "4"])
    out = capsys.readouterr().out
    assert "prefill 2 x 12 embeddings" in out and "tok/s" in out
    assert tuple(run.prompt.shape) == (2, 12, run.cfg.d_model)
    assert run.prompt.dtype == torch.bfloat16
    assert tuple(run.tokens.shape) == (2, 4) and int(run.cache.pos) == 16
    assert ((run.tokens >= 0) & (run.tokens < run.cfg.vocab)).all()


def test_build_serve_checks_the_embeddings_shape():
    cfg = configs.smoke("musicgen_large")
    sv = build_serve(cfg, 2, 16, prefill_len=8, device="cpu")
    with pytest.raises(ValueError, match="prefill embeddings"):
        sv.prefill_fn({}, torch.zeros((2, 8), dtype=torch.long))
    with pytest.raises(ValueError, match="prefill embeddings"):
        sv.prefill_fn({}, torch.zeros((2, 8, cfg.d_model + 1)))


def test_train_launcher_trains_on_embeddings(capsys):
    run = launch_train.main(["--arch", "musicgen-large", "--smoke",
                             "--device", "cpu", "--steps", "3",
                             "--global-batch", "4", "--seq", "16"])
    assert len(run.losses) == 3 and all(np.isfinite(run.losses))
    assert run.data.cfg.embed_dim == run.cfg.d_model
    assert "step     2" in capsys.readouterr().out
