"""The port's training path against the JAX package's.

Same numpy weights (made by the JAX package, bridged with
``repro_torch.bridge``), same numpy batches, through both packages: the
cross-entropy with its z-loss, one update of each optimizer, the training
forward (``attn_impl="chunked"`` in the reference: its custom-VJP flash
forward, or the banded path for sliding windows), and whole train steps
with and without gradient accumulation. Also the data pipeline's structure
and determinism, and the training entry point end to end on the CPU.

Tolerances:
- float32 forward logits 2e-5, as the reference's kernel tests: the two
  frameworks differ only in summation order and in their float32
  transcendentals (XLA's exp, sin and cos are its own approximations).
- bfloat16 forward logits 6e-2: each framework rounds its bf16
  intermediates at other places (XLA keeps fused elementwise chains in
  float32), so the residual stream drifts by a few bf16 ulps
  (as ``tests/test_torch_transformer.py``).
- Both logit tolerances are relative to the logits' scale: ``atol`` is the
  tolerance times ``max(1, max |logit|)``. These differences grow with the
  size of the whole output, not with each element's: with h2o-danube3's
  untied head the logits reach 2.6, and the JAX package's own two float32
  paths (``attn_impl`` "ref" and "chunked") differ by up to 3.0e-5 there.
- float32 train steps, at two inits of the same weights. At the
  reference's init the gradients of this smoke model are poorly
  conditioned in float32: its ``ParamDecl`` takes ``shape[-2]`` as the
  fan-in, which for the 3-d attention projections is a head count or the
  head dim, so q and k come out several times too large. Against a float64
  computation of the same gradients, the port's largest embedding
  gradient (27.2) is off by 1.8e-2 and the JAX package's by 1.3e-2: two
  float32 runs agree to about 1e-4 in the norm. There: loss 1e-5, grad
  norm 2e-4 (relative). With the attention projections rescaled to their
  true fan-in (the same numpy weights into both packages) the gradients
  are well conditioned: loss and grad norm 1e-6. In both, updated params
  agree to 2e-6 in all but 1% (reference init) or 0.1% (true fan-in) of
  the elements, and within ``2 * lr`` in every one: AdamW's first update
  is ``lr * g / (|g| + eps)``, about ``lr`` per element whatever the
  gradient's size, so an element whose gradient is below float32 noise
  may step either way in either package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import registry as jreg
from repro.sharding import params as JP
from repro.train import optim as jopt
from repro.train import trainer as jtrainer

torch = configs = params_from_numpy = registry = None  # bound by _port
L = lm = optim = trainer = transformer = tree_leaves = train_main = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, configs, params_from_numpy, registry, L, lm, optim
    global trainer, transformer, tree_leaves, train_main
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.data import lm
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import layers as L
    from repro_torch.models import registry, transformer
    from repro_torch.sharding.params import tree_leaves
    from repro_torch.train import optim, trainer
    torch.set_num_threads(1)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_values_and_grads_match_jax(z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 5, 40)) * 3).astype(np.float32)
    logits[..., 37:] = -1e30                       # padded vocab, masked
    labels = rng.integers(0, 37, size=(2, 5)).astype(np.int32)

    def jloss(x):
        return JL.cross_entropy(x, jnp.asarray(labels), z_loss).mean()

    want, wgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss = L.cross_entropy(x, torch.from_numpy(labels).long(), z_loss).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(wgrad), atol=1e-7)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


def _opt_tree(rng, dtype):
    """Leaves of every kind the optimizers treat apart: a stacked matrix
    (factored by Adafactor), a stacked vector (factored over the layer axis,
    as the reference's stacked norm scales are), a vector, a 2x1 matrix."""
    shapes = {"blocks": {"w": (3, 6, 5), "ln": (3, 6)}, "b": (7,),
              "col": (2, 1)}
    tree = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                        shapes, is_leaf=lambda s: isinstance(s, tuple))
    return jax.tree.map(lambda a: a.astype(dtype), tree)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "lion"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_updates_match_jax(name, dtype):
    """Two updates from the same numpy params and grads; params and the
    float32 master agree. The grads are large enough that the clip binds.
    bf16 params are compared after rounding both to bf16: one bf16 ulp."""
    rng = np.random.default_rng(1)
    npd = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    params = _opt_tree(rng, npd)
    grads = [_opt_tree(rng, npd) for _ in range(2)]
    jo = jopt.get(name)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    to = optim.get(name)
    tp = params_from_numpy(params, "cpu")
    ts = to.init(tp)
    for g in grads:
        jp, js, jm = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                               jnp.asarray(3e-2, jnp.float32))
        tp2, ts2, tm = to.update(params_from_numpy(g, "cpu"), ts, tp, 3e-2)
        assert tp2 is tp and ts2 is ts                 # updated in place
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        tol = 1e-6 if dtype == "float32" else 2 ** -7 * np.abs(
            np.asarray(want, np.float32)).max()
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=tol)
    if "master" in js:
        for got, want in zip(tree_leaves(ts["master"]),
                             jax.tree.leaves(js["master"])):
            np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
    if "grad_norm" in jm:
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert ts["step"] == int(js["step"])


def test_clip_scales_in_place_and_rounds_to_the_grad_dtype():
    g = {"a": torch.full((4,), 3.0, dtype=torch.bfloat16), "b": torch.ones(3)}
    a = g["a"]
    out, norm = optim.clip_by_global_norm(g, 1.0)
    assert out["a"] is a and a.dtype == torch.bfloat16
    assert norm.item() == pytest.approx(np.sqrt(4 * 9 + 3))
    np.testing.assert_allclose(_np(a), np.float32(3 / np.sqrt(39)), rtol=2 ** -8)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _models(arch, dtype, remat="none", seed=1):
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype=dtype,
                               attn_impl="chunked", remat="none")
    cfg = dataclasses.replace(configs.smoke(arch), dtype=dtype, remat=remat)
    jparams = JP.init_tree(jreg.decls(jcfg), jax.random.key(seed))
    if dtype == "bfloat16":
        jparams = JP.cast_tree(jparams, jnp.bfloat16)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


FWD_TOL = {"float32": 2e-5, "bfloat16": 6e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite_3_2b", "h2o_danube3_4b"])
def test_forward_logits_match_jax(arch, dtype):
    """granite (GQA, causal) and h2o-danube3 (sliding window 16, over 40
    positions), at the reference's init (logits up to about 0.6)."""
    jcfg, cfg, jparams, params = _models(arch, dtype)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 40))
    want, _ = jreg.forward(jparams, jcfg, tokens=jnp.asarray(tokens, jnp.int32))
    got, aux = registry.forward(params, cfg, torch.from_numpy(tokens))
    assert got.shape == (2, 40, cfg.padded_vocab) and aux.item() == 0.0
    want = np.asarray(want, np.float32)
    tol = FWD_TOL[dtype]
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def test_remat_full_gives_the_same_logits_and_grads():
    """Checkpointing each layer changes what is stored, not what is
    computed: logits and gradients equal the unrematerialised run's."""
    _, cfg, _, params = _models("granite_3_2b", "float32")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 24)))
    out = {}
    for remat in ("none", "full"):
        p = {k: (v.clone().requires_grad_() if k == "embed" else v)
             for k, v in params.items()}
        logits, _ = registry.forward(p, dataclasses.replace(cfg, remat=remat),
                                     tokens)
        (logits[..., :256] ** 2).mean().backward()
        out[remat] = (logits.detach(), p["embed"].grad)
    assert torch.equal(out["none"][0], out["full"][0])
    torch.testing.assert_close(out["none"][1], out["full"][1], rtol=0, atol=1e-7)


def test_unported_paths_raise():
    """MoE training still raises. Embeds inputs and the audio family train
    (``tests/test_torch_embeds.py`` holds them to the JAX package); passing
    tokens and embeds together raises (remat "dots" is ported:
    tests/test_torch_train_recurrent.py holds it)."""
    _, cfg, _, params = _models("granite_3_2b", "float32")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="MoE training"):
        registry.forward(params, configs.smoke("grok_1_314b"), tokens)
    logits, _ = registry.forward(params, cfg, embeds=torch.zeros(1, 4, 64))
    assert tuple(logits.shape) == (1, 4, cfg.padded_vocab)
    with pytest.raises(ValueError, match="exactly one"):
        registry.forward(params, cfg, tokens, embeds=torch.zeros(1, 4, 64))
    _, audio, _, audio_params = _models("musicgen_large", "float32")
    logits, _ = registry.forward(audio_params, audio,
                                 embeds=torch.zeros(1, 4, audio.d_model))
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def _batch(accum, mb, seq, vocab, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(accum, mb, seq + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


# loss and grad-norm rtol, and the share of param elements allowed past
# 2e-6, per init (see the module docstring)
STEP_TOL = {"reference": (1e-5, 2e-4, 1e-2), "true_fan_in": (1e-6, 1e-6, 1e-3)}


@pytest.mark.parametrize("init", ["reference", "true_fan_in"])
@pytest.mark.parametrize("accum,remat", [(1, "none"), (2, "full")])
def test_train_step_matches_jax(accum, remat, init):
    """One float32 AdamW step on identical params and batches: loss, grad
    norm and every updated param agree; params are written in place."""
    jcfg, cfg, jparams, _ = _models("granite_3_2b", "float32", remat)
    jcfg = dataclasses.replace(jcfg, remat=remat)
    jparams = jax.tree.map(np.asarray, jparams)
    if init == "true_fan_in":
        jparams = transformer.true_fan_in(jparams, cfg)
    params = params_from_numpy(jparams, "cpu")
    jparams = jax.tree.map(jnp.asarray, jparams)
    tc = jtrainer.TrainConfig(accum=accum)
    batch = _batch(accum, 2, 24, cfg.vocab)
    jstep, jo = jtrainer.make_train_step(jcfg, tc)
    jnew, _, jm = jstep(jparams, jo.init(jparams),
                        jax.tree.map(jnp.asarray, batch))
    tstep, to = trainer.make_train_step(
        cfg, trainer.TrainConfig(**dataclasses.asdict(tc)))
    leaves = tree_leaves(params)
    new, state, m = tstep(params, to.init(params),
                          {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert all(a is b for a, b in zip(tree_leaves(new), leaves))
    assert state["step"] == 1
    loss_tol, norm_tol, share = STEP_TOL[init]
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=loss_tol)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=norm_tol)
    diffs = np.concatenate([np.abs(_np(got) - np.asarray(want)).ravel()
                            for got, want in zip(tree_leaves(new),
                                                 jax.tree.leaves(jnew))])
    assert diffs.max() <= 2 * tc.lr, diffs.max()
    assert (diffs > 2e-6).mean() < share, (diffs > 2e-6).mean()


# ---------------------------------------------------------------------------
# Data and entry point
# ---------------------------------------------------------------------------


def test_lm_pipeline_structure():
    cfg = lm.LMDataConfig(vocab=300, seq=33, global_batch=6, accum=3, seed=5)
    b = lm.LMPipeline(cfg).batch_at(7)
    assert b["tokens"].shape == b["labels"].shape == (3, 2, 33)
    full = torch.cat([b["tokens"], b["labels"][..., -1:]], dim=-1)
    assert torch.equal(full[..., 1:], b["labels"])      # labels = shift by one
    evens, odds = full[..., 0::2], full[..., 1::2]
    assert torch.equal(odds, (evens[..., :odds.shape[-1]] * 7 + 13) % 300)
    assert int(full.min()) >= 0 and int(full.max()) < 300


def test_lm_pipeline_is_a_pure_function_of_seed_and_step():
    mk = lambda seed: lm.LMPipeline(lm.LMDataConfig(vocab=50, seq=16,
                                                    global_batch=4, seed=seed))
    a, b = mk(0), mk(0)
    assert torch.equal(a.batch_at(3)["tokens"], b.batch_at(3)["tokens"])
    assert torch.equal(b.batch_at(3)["tokens"], a.batch_at(3)["tokens"])
    assert not torch.equal(a.batch_at(3)["tokens"], a.batch_at(4)["tokens"])
    assert not torch.equal(a.batch_at(3)["tokens"], mk(1).batch_at(3)["tokens"])


def test_train_launcher_runs_on_the_cpu_and_the_loss_falls(capsys):
    """The smoke model learns the stream's bigram (the odd token is a
    function of the even one): over 150 steps the loss falls clearly. Each
    step's line carries its loss and its gradient norm, and the run returns
    the same numbers."""
    run = train_main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                      "--steps", "150", "--global-batch", "8", "--seq", "64",
                      "--accum", "2", "--lr", "1e-2"])
    lines = [line.split() for line in capsys.readouterr().out.splitlines()
             if line.startswith("step")]
    losses = [float(w[3]) for w in lines]
    assert [w[4] for w in lines] == ["grad_norm"] * 150
    assert len(losses) == 150 and all(np.isfinite(losses))
    np.testing.assert_allclose(losses, run.losses, atol=5e-5)
    np.testing.assert_allclose([float(w[5]) for w in lines], run.grad_norms,
                               atol=5e-5)
    assert all(np.isfinite(run.grad_norms)) and len(run.seconds) == 150
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.1, losses


def test_train_launcher_true_fan_in_init(capsys):
    """``--init true-fan-in`` trains from the rescaled attention
    projections: the first step's loss equals the loss function's on
    ``true_fan_in`` of the same seeded init."""
    from repro_torch.sharding.params import init_tree
    argv = ["--smoke", "--device", "cpu", "--steps", "1", "--global-batch",
            "4", "--seq", "32", "--accum", "1", "--seed", "3"]
    run = train_main(argv + ["--init", "true-fan-in"])
    cfg = run.cfg
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    params = init_tree(registry.decls(cfg), 3, "cpu", dtype=dtype)
    scaled = transformer.true_fan_in(params, cfg)
    attn = scaled["blocks"]["l0"]["attn"]
    ref_attn = params["blocks"]["l0"]["attn"]
    d, h = cfg.d_model, cfg.n_heads
    assert torch.equal(attn["wq"], ref_attn["wq"] * (h / d) ** 0.5)
    assert torch.equal(attn["ln"], ref_attn["ln"])
    assert scaled["embed"] is params["embed"]
    mb = {k: v[0] for k, v in run.data.batch_at(0).items()}
    loss_fn = trainer.make_loss_fn(cfg, trainer.TrainConfig())
    with torch.no_grad():
        want = loss_fn(scaled, mb)[0].item()
        other = loss_fn(params, mb)[0].item()
    np.testing.assert_allclose(run.losses[0], want, rtol=1e-6)
    assert abs(run.losses[0] - other) > 1e-4


def test_train_launcher_raises_on_a_non_finite_grad_norm(capsys):
    """A step whose loss or gradient norm is not finite stops the run: with
    an absurd learning rate the first update sends the params past float32's
    range, and the second step's gradient norm is not finite."""
    with pytest.raises(FloatingPointError, match="grad norm"):
        train_main(["--smoke", "--device", "cpu", "--steps", "3",
                    "--global-batch", "2", "--seq", "16", "--accum", "1",
                    "--lr", "1e30"])
    out = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("step")]
    assert 1 <= len(out) <= 3 and "done" not in out[-1]


def test_train_launcher_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--smoke", "--steps", "1"])
