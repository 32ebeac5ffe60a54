"""The port's training of the hybrid (Griffin) and SSM (Mamba-2) families
against the JAX package's.

Same numpy weights (made by the JAX package, bridged with
``repro_torch.bridge``), same numpy batches, through both packages: the
training forward's logits (``registry.forward`` against ``jreg.forward``:
the reference's ``linear_scan_blocked``, ``attention_banded`` and
``ssd_chunked``, all three differentiated by ``jax.grad``), one AdamW step
with and without gradient accumulation and remat, remat ``"dots"`` against
``"none"`` for the dense, hybrid and SSM smoke configs, the kernel
launches a train step makes (``chip_smoke.train_launches``, which the card
checks exactly, against the calls counted here), and the training entry
point on the CPU.

Griffin's weights get their attention projections at their true fan-in
(``registry.true_fan_in``), as the port's Griffin tests do: at the
reference's init its wk and wv of shape (64, 1, 16) have std 1 and a
bf16 ulp on a score moves the output by O(1) (ROADMAP queue 3). Mamba-2
has no attention projections; its weights are the reference's.

Tolerances. Both families run bf16 activations whatever the params'
dtype, and the two frameworks round their bf16 intermediates at other
places (XLA keeps fused elementwise chains in float32), so:
- logits 6e-2, relative to the logits' scale (``atol`` is 6e-2 times
  ``max(1, max |logit|)``), as ``tests/test_torch_train.py`` holds bf16;
- the gradients one step hands AdamW, leaf by leaf
  (``chip_smoke.RECURRENT_GRAD_TOL``, which the card's gradients against
  the CPU's are held to as well): the 2-norm of each leaf's difference
  within 0.15 (Griffin) or 0.05 (Mamba-2) of the reference's norm
  (measured here: at most 6.4e-2 and 1.5e-2). This is the check that sees
  a wrong gradient on a small leaf (the RG-LRU's ``a_param``, a conv's
  taps, a norm's scale), which the step's parameters cannot: AdamW's
  first update is about lr times the gradient's sign;
- one AdamW step (``chip_smoke.RECURRENT_STEP_TOL``, which the card's
  step against the CPU's is held to as well): loss 1e-3 and grad norm 1e-2
  relative; parameters within 2 lr everywhere and within 2e-6 in all but
  5% of the elements. The gradients agree to bf16's precision, and AdamW's
  first update moves each element by about lr whatever its gradient's
  size, so an element whose gradient is below the bf16 noise may step
  either way (measured here: 1.7% of Griffin's elements and 0.3% of
  Mamba-2's move by more than 2e-6).
Remat changes what is stored, not what is computed: ``"dots"`` and
``"full"`` give the logits of ``"none"`` bit for bit and its gradients to
1e-7.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.sharding import params as JP
from repro.train import trainer as jtrainer

torch = configs = params_from_numpy = registry = None  # bound by _port
trainer = tree_leaves = train_main = None


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()       # train_launches and the step tolerance
ARCHS = ["recurrentgemma_2b", "mamba2_370m"]
FWD_TOL = 6e-2


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file (as ``test_torch_train.py`` does)."""
    global torch, configs, params_from_numpy, registry, trainer
    global tree_leaves, train_main
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import registry
    from repro_torch.sharding.params import tree_leaves
    from repro_torch.train import trainer
    torch.set_num_threads(1)


def _np(t):
    return t.detach().float().numpy()


def _models(arch, remat="none", seed=1):
    """(jax cfg, numpy params, port cfg): float32 smoke weights made by the
    JAX package, Griffin's attention at its true fan-in."""
    jcfg = dataclasses.replace(jconfigs.smoke(arch), remat=remat)
    cfg = dataclasses.replace(configs.smoke(arch), remat=remat)
    tree = jax.tree.map(np.asarray, JP.init_tree(jreg.decls(jcfg),
                                                 jax.random.key(seed)))
    tree = registry.true_fan_in(tree, cfg)
    return jcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), tree), cfg


def _batch(accum, mb, seq, vocab, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(accum, mb, seq + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    """40 positions (past Griffin's window of 16, over five of Mamba-2's
    chunks of 8): the port's training forward against ``jreg.forward``."""
    jcfg, tree, cfg = _models(arch)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 40))
    want, _ = jreg.forward(jax.tree.map(jnp.asarray, tree), jcfg,
                           tokens=jnp.asarray(tokens, jnp.int32))
    got, aux = registry.forward(params_from_numpy(tree, "cpu"), cfg,
                                torch.from_numpy(tokens))
    assert got.shape == (2, 40, cfg.padded_vocab) and aux.item() == 0.0
    assert got.dtype == torch.bfloat16          # bf16 activations
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=FWD_TOL,
                               atol=FWD_TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("accum,remat", [(1, "none"), (2, "full")])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, accum, remat):
    """One float32-params AdamW step on identical params and batches: loss,
    grad norm and every updated param agree at the stated tolerances;
    params are written in place."""
    jcfg, tree, cfg = _models(arch, remat)
    params = params_from_numpy(tree, "cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    tc = jtrainer.TrainConfig(accum=accum)
    batch = _batch(accum, 2, 24, cfg.vocab)
    jstep, jo = jtrainer.make_train_step(jcfg, tc)
    jnew, _, jm = jstep(jparams, jo.init(jparams),
                        jax.tree.map(jnp.asarray, batch))
    tstep, to = trainer.make_train_step(
        cfg, trainer.TrainConfig(**dataclasses.asdict(tc)))
    leaves = tree_leaves(params)
    new, state, m = tstep(params, to.init(params),
                          {k: torch.from_numpy(v).long()
                           for k, v in batch.items()})
    assert all(a is b for a, b in zip(tree_leaves(new), leaves))
    assert state["step"] == 1
    loss_tol, norm_tol, share = cs.RECURRENT_STEP_TOL
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=loss_tol)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=norm_tol)
    diffs = np.concatenate([np.abs(_np(got) - np.asarray(want)).ravel()
                            for got, want in zip(tree_leaves(new),
                                                 jax.tree.leaves(jnew))])
    assert diffs.max() <= 2 * tc.lr, diffs.max()
    assert (diffs > 2e-6).mean() < share, (diffs > 2e-6).mean()


@pytest.mark.parametrize("accum,remat", [(1, "none"), (2, "full")])
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_gradients_match_jax(arch, accum, remat):
    """The gradients a step hands its optimizer (``trainer.make_grad_fn``,
    averaged over the microbatches) against ``jax.grad`` of the
    reference's loss averaged the same way, leaf by leaf at
    ``chip_smoke.RECURRENT_GRAD_TOL``; every leaf's gradient is finite and
    not all zero on both sides."""
    jcfg, tree, cfg = _models(arch, remat)
    tc = jtrainer.TrainConfig(accum=accum)
    batch = _batch(accum, 2, 24, cfg.vocab)
    jloss = jtrainer.make_loss_fn(jcfg, tc)
    jparams = jax.tree.map(jnp.asarray, tree)
    jgrads = [jax.grad(lambda p, mb: jloss(p, mb)[0])(
        jparams, {k: jnp.asarray(v[i]) for k, v in batch.items()})
        for i in range(accum)]
    want = [np.asarray(sum(gs) / accum, np.float64)
            for gs in zip(*(jax.tree.leaves(g) for g in jgrads))]
    grad_fn = trainer.make_grad_fn(
        cfg, trainer.TrainConfig(**dataclasses.asdict(tc)))
    _, _, grads = grad_fn(params_from_numpy(tree, "cpu"),
                          {k: torch.from_numpy(v).long()
                           for k, v in batch.items()})
    got = [g.double().numpy() for g in tree_leaves(grads)]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and np.any(g != 0)
        assert np.isfinite(w).all() and np.any(w != 0)
    errs = cs.leaf_grad_errs(got, want)
    worst = int(np.argmax(errs))
    assert errs[worst] <= cs.RECURRENT_GRAD_TOL[cfg.family], (worst, errs)


@pytest.mark.parametrize("arch", ["granite_3_2b"] + ARCHS)
def test_remat_dots_and_full_give_the_logits_and_grads_of_none(arch):
    """Remat ``"dots"`` (matmul outputs without batch dimensions kept, the
    rest recomputed) and ``"full"`` against ``"none"``, on the dense,
    hybrid and SSM smoke configs: equal logits, gradients of every leaf to
    1e-7."""
    _, tree, cfg = _models(arch)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 24)))
    key, n = registry.stacked(cfg)
    out = {}
    for remat in ("none", "dots", "full"):
        params = params_from_numpy(tree, "cpu")
        tr, leaves = trainer._layer_leaves(params, key, n)
        logits, _ = registry.forward(tr, dataclasses.replace(cfg, remat=remat),
                                     tokens)
        grads = torch.autograd.grad((logits[..., :cfg.vocab].float() ** 2)
                                    .mean(), leaves, allow_unused=True)
        out[remat] = (logits.detach(), grads)
    for remat in ("dots", "full"):
        assert torch.equal(out["none"][0], out[remat][0]), remat
        for g, w in zip(out[remat][1], out["none"][1]):
            if w is None:
                assert g is None
            else:
                torch.testing.assert_close(g, w, rtol=0, atol=1e-7)


def test_dots_policy_keeps_products_without_batch_dims():
    """The policy's matrix products: ``mm``/``addmm`` and a ``bmm`` over a
    batch of one are kept; a batched ``bmm`` is recomputed."""
    from repro_torch.models import transformer
    aten = torch.ops.aten
    one, many = torch.zeros(1, 2, 2), torch.zeros(3, 2, 2)
    assert transformer._no_batch_dot(aten.mm.default, (one[0], one[0]))
    assert transformer._no_batch_dot(aten.addmm.default, (one[0],))
    assert transformer._no_batch_dot(aten.bmm.default, (one, one))
    assert not transformer._no_batch_dot(aten.bmm.default, (many, many))
    assert not transformer._no_batch_dot(aten.add.Tensor, (one, one))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launches_are_the_calls_a_step_makes(arch):
    """``chip_smoke.train_launches``, which the card's train phases check
    exactly, against the scan, attention and SSD calls one train step of 2
    microbatches makes on the CPU with remat ``"full"`` (the triples' and
    blocks' forwards twice, Griffin's tail once) and with ``"none"``."""
    from unittest import mock

    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.rglru import ref as rref
    from repro_torch.kernels.ssd import ref as sref
    names = {"scan": (rref, "rglru"), "scan_bwd": (rref, "rglru_bwd"),
             "flash_fwd": (attn_ops, "_forward"),
             "flash_bwd": (attn_ops, "_backward"),
             "ssd": (sref, "ssd_chunked"), "ssd_bwd": (sref, "ssd_bwd")}
    for remat in ("full", "none"):
        _, tree, cfg = _models(arch, remat)
        params = params_from_numpy(tree, "cpu")
        counts = {k: 0 for k in names}

        def counted(key, fn):
            def call(*a, **kw):
                counts[key] += 1
                return fn(*a, **kw)
            return call

        patches = [mock.patch.object(mod, attr, counted(k, getattr(mod, attr)))
                   for k, (mod, attr) in names.items()]
        step, opt = trainer.make_train_step(cfg, trainer.TrainConfig(accum=2))
        batch = {k: torch.from_numpy(v).long()
                 for k, v in _batch(2, 2, 24, cfg.vocab).items()}
        for p in patches:
            p.start()
        try:
            step(params, opt.init(params), batch)
        finally:
            for p in patches:
                p.stop()
        # the plain backward of the SSD recomputes ssd_chunked once a call
        if cfg.family == "ssm":
            counts["ssd"] -= counts["ssd_bwd"]
        want = cs.train_launches(cfg, 2, 1)
        assert {k: counts[k] for k in want} == want, (remat, counts, want)
        assert all(counts[k] == 0 for k in names if k not in want), counts


def test_registry_stacked_and_true_fan_in():
    """The stacked entry a trainer splits by layer, per family; mamba2's
    true-fan-in init is its reference init (no attention projections)."""
    for arch, want in (("granite_3_2b", ("blocks", 3)),
                       ("recurrentgemma_2b", ("triples", 1)),
                       ("mamba2_370m", ("blocks", 2)),
                       ("recurrentgemma_2b_full", ("triples", 8))):
        cfg = (configs.get("recurrentgemma_2b") if arch.endswith("_full")
               else configs.smoke(arch))
        assert registry.stacked(cfg) == want, arch
    _, tree, cfg = _models("mamba2_370m")
    assert registry.true_fan_in(tree, cfg) is tree


@pytest.mark.parametrize("arch,steps", [("recurrentgemma-2b", 60),
                                        ("mamba2-370m", 60)])
def test_train_launcher_runs_on_the_cpu_and_the_loss_falls(arch, steps,
                                                           capsys):
    """``python -m repro_torch.launch.train --arch ... --smoke --device
    cpu``: each step's line carries its loss and gradient norm, the run
    returns the same numbers, and the smoke model learns the stream's
    bigram (the loss falls clearly)."""
    run = train_main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", str(steps), "--global-batch", "8", "--seq",
                      "32", "--accum", "2", "--lr", "1e-2", "--init",
                      "true-fan-in"])
    lines = [line.split() for line in capsys.readouterr().out.splitlines()
             if line.startswith("step")]
    losses = [float(w[3]) for w in lines]
    assert len(losses) == steps and all(np.isfinite(losses))
    np.testing.assert_allclose(losses, run.losses, atol=5e-5)
    assert all(np.isfinite(run.grad_norms))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.1, losses
