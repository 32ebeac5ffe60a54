"""The port's MoE training against the JAX package's.

Same numpy inputs and weights (made by the JAX package, bridged with
``repro_torch.bridge``) through both packages:

* the grouped matmul's backward: the plain ``grouped_matmul_dx`` and
  ``grouped_matmul_dw`` against ``jax.vjp`` of the reference's
  ``jnp.einsum("ecd,edf->ecf")`` on regular and ragged shapes (float32
  2e-5, bf16 3e-2), ``gradcheck`` of the CPU autograd path in float64,
  and the backward computing only the gradients asked for;
* ``layers.moe``'s gradients (x, router, the three expert weights, the
  shared expert) against ``jax.grad`` of ``L.moe`` with the aux term, on
  the grok and llama4 smoke shapes, at capacity factor 1.0 (slots
  dropped) and 8.0 (none), in float32 and bf16;
* the training forward's logits and aux (``registry.forward`` against
  ``jreg.forward``), the gradients a step hands its optimizer leaf by
  leaf, and one AdamW and one Adafactor step, with and without gradient
  accumulation and remat; remat ``"dots"`` and ``"full"`` against
  ``"none"``; the kernel calls a step makes against
  ``chip_smoke.train_launches``; the train launcher on the CPU;
* the optimizer's slicing of a leaf into its matrices against the
  whole-leaf arithmetic.

Tolerances. The model runs bf16 activations, and the two frameworks round
bf16 intermediates at other places, so the whole-model checks take
``tests/test_torch_train_recurrent.py``'s: logits 6e-2 of their scale; one
step's loss 1e-3 and grad norm 1e-2 relative, params within 2 lr and
within 2e-6 in all but 5% of the elements
(``chip_smoke.RECURRENT_STEP_TOL``); the gradients leaf by leaf within
``chip_smoke.MOE_GRAD_TOL`` (0.05) of the reference's 2-norm (measured
here: at most 1.7e-2 with the attention at its true fan-in).

Routing is a discontinuity: a token whose top-k router probabilities lie
within the two frameworks' bf16 noise of each other may take another
expert in each, and then its gradients differ by O(1). The batches here
(seed 8) route every token with a margin of at least 2e-3 between its
k-th and (k+1)-th probability on every MoE call, which each test asserts
(measured: seeds whose smallest margin is below about 1.5e-3 can flip a
token; ``ROUTER_MARGIN``).
"""

import dataclasses
import importlib.util
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import registry as jreg
from repro.sharding import params as JP
from repro.train import optim as joptim
from repro.train import trainer as jtrainer

torch = configs = params_from_numpy = registry = trainer = None  # by _port
tree_leaves = tree_map = train_main = L = ops = ref = kernel = optim = None


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()       # train_launches, the tolerances
ARCHS = ["grok_1_314b", "llama4_maverick_400b"]
FWD_TOL = 6e-2
GMM_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
LAYER_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
BATCH_SEED = 8
ROUTER_MARGIN = 2e-3
# the aux loss is E x sum(mean router probability x load): its
# probabilities come from bf16 activations, so it carries their noise
# (measured: 1.03e-3 relative on llama4's smoke config)
AUX_TOL = 1e-2
# float32 rounding of two updated parameters, each up to about 4 in size
PARAM_SLACK = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file (as ``test_torch_train.py`` does)."""
    global torch, configs, params_from_numpy, registry, trainer
    global tree_leaves, tree_map, train_main, L, ops, ref, kernel, optim
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.kernels.moe import kernel, ops, ref
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import layers as L
    from repro_torch.models import registry
    from repro_torch.sharding.params import tree_leaves, tree_map
    from repro_torch.train import optim, trainer
    torch.set_num_threads(1)


def _arr(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


# ---------------------------------------------------------------------------
# The grouped matmul's backward
# ---------------------------------------------------------------------------

GMM_SHAPES = [(4, 16, 32, 64), (2, 128, 64, 128), (8, 8, 16, 16),
              (3, 37, 45, 77), (1, 1, 1, 1), (2, 200, 64, 136)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", GMM_SHAPES)
def test_plain_dx_dw_match_jax_vjp(e, c, d, f, dtype):
    """dx = dy w^T and dw = x^T dy against ``jax.vjp`` of the reference's
    einsum; the autograd path gives the plain versions' bits."""
    x, w, dy = (_arr((e, c, d), 1, 0.5), _arr((e, d, f), 2, 0.5),
                _arr((e, c, f), 3, 0.5))
    _, vjp = jax.vjp(lambda a, b: jnp.einsum("ecd,edf->ecf", a, b),
                     _jax(x, dtype), _jax(w, dtype))
    want_dx, want_dw = vjp(_jax(dy, dtype))
    tx, tw, tdy = (_torch(a, dtype) for a in (x, w, dy))
    got_dx = ref.grouped_matmul_dx(tdy, tw)
    got_dw = ref.grouped_matmul_dw(tx, tdy)
    assert got_dx.dtype == got_dw.dtype == getattr(torch, dtype)
    assert got_dx.shape == (e, c, d) and got_dw.shape == (e, d, f)
    tol = GMM_TOL[dtype]
    for got, want in ((got_dx, want_dx), (got_dw, want_dw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    tx.requires_grad_()
    tw.requires_grad_()
    ops.grouped_matmul(tx, tw).backward(tdy)
    assert torch.equal(tx.grad, got_dx) and torch.equal(tw.grad, got_dw)


def test_gradcheck_of_the_cpu_autograd_path_in_float64():
    """The plain versions keep float64 throughout, so ``gradcheck`` holds
    the autograd function's backward to finite differences."""
    x = torch.from_numpy(_arr((2, 5, 4), 4)).double().requires_grad_()
    w = torch.from_numpy(_arr((2, 4, 3), 5)).double().requires_grad_()
    assert ops.grouped_matmul(x, w).dtype == torch.float64
    assert torch.autograd.gradcheck(ops.grouped_matmul, (x, w))


def test_backward_computes_only_the_gradients_asked_for(monkeypatch):
    calls = []
    for name in ("grouped_matmul_dx", "grouped_matmul_dw"):
        real = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda a, b, n=name, r=real:
                            calls.append(n) or r(a, b))
    x = torch.from_numpy(_arr((2, 5, 4), 4))
    w = torch.from_numpy(_arr((2, 4, 3), 5))
    for needs, want in (((True, False), ["grouped_matmul_dx"]),
                        ((False, True), ["grouped_matmul_dw"]),
                        ((True, True), ["grouped_matmul_dx",
                                        "grouped_matmul_dw"])):
        calls.clear()
        a, b = (t.clone().requires_grad_(n) for t, n in zip((x, w), needs))
        ops.grouped_matmul(a, b).sum().backward()
        assert calls == want, (needs, calls)


@pytest.mark.parametrize("shape,dtype,aligned,want", [
    ((2560, 6144, 32768), "bfloat16", True, "wgmma"),   # grok gate/up
    ((2560, 32768, 6144), "bfloat16", True, "wgmma"),   # grok down
    ((17, 64, 128), "bfloat16", True, "wgmma"),
    ((16, 64, 128), "bfloat16", True, "bf16"),          # C <= 16
    ((64, 60, 128), "bfloat16", True, "bf16"),          # D off 8
    ((64, 64, 129), "bfloat16", True, "bf16"),          # F off 8
    ((64, 64, 128), "bfloat16", False, "bf16"),         # base off 16 B
    ((64, 64, 128), "float32", True, "f32"),
])
def test_plan_bwd_routes(shape, dtype, aligned, want):
    assert kernel.plan_bwd(*shape, getattr(torch, dtype), aligned,
                           True) == want


def test_bwd_wrappers_refuse_before_building():
    dy, w, x = (torch.zeros(s) for s in ((2, 4, 8), (2, 6, 8), (2, 4, 6)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.grouped_matmul_dx_cuda(dy, w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.grouped_matmul_dw_cuda(x, dy)
    with pytest.raises(ValueError, match=r"want dy \(E, C, F\) and w"):
        kernel.grouped_matmul_dx_cuda(dy, torch.zeros((2, 6, 7)))
    with pytest.raises(ValueError, match=r"want x \(E, C, D\) and dy"):
        kernel.grouped_matmul_dw_cuda(x, torch.zeros((2, 5, 8)))
    with pytest.raises(ValueError, match=r"want dy \(E, C, F\)"):
        kernel.grouped_matmul_dx_cuda(torch.zeros((4, 8)), w)
    assert kernel._lib is None


# ---------------------------------------------------------------------------
# The MoE layer's gradients
# ---------------------------------------------------------------------------


def _layer(arch, dtype, seed=3):
    cfg = configs.smoke(arch)
    jd = JL.moe_decls(cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.mlp_type,
                      shared=cfg.moe_shared_expert)
    jp = JP.init_tree(jd, jax.random.key(seed))
    jp = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), jp)
    return cfg, jp, _arr((2, 32, cfg.d_model), seed + 1)


@pytest.mark.parametrize("cf", [1.0, 8.0], ids=["cf1-drops", "cf8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_gradients_match_jax(arch, dtype, cf):
    """``jax.grad`` of ``sum(out * r) + 10 aux`` through the reference's
    ``L.moe`` (its chunked einsums) against autograd through the port's:
    the gradients of x and of every weight (router, w_gate, w_up, w_down,
    the shared expert's), each within the dtype's tolerance of its
    scale."""
    cfg, jp, x = _layer(arch, dtype)
    r = _arr(x.shape, 5)
    kw = dict(n_exp=cfg.moe_experts, top_k=cfg.moe_top_k, capacity_factor=cf,
              kind=cfg.mlp_type)

    def jloss(xx, p):
        o, aux = JL.moe(xx, p, impl="chunked", **kw)
        return jnp.sum(o.astype(jnp.float32) * r) + 10.0 * aux

    want_x, want_p = jax.grad(jloss, argnums=(0, 1))(_jax(x, dtype), jp)
    tp = tree_map(lambda t: t.requires_grad_(),
                  params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    tx = _torch(x, dtype).requires_grad_()
    out, aux = L.moe(tx, tp, **kw)
    ((out.float() * torch.from_numpy(r)).sum() + 10.0 * aux).backward()
    got = [tx.grad] + [t.grad for t in tree_leaves(tp)]
    want = [want_x] + jax.tree.leaves(want_p)
    assert len(got) == (5 if arch.startswith("grok") else 8)
    tol = LAYER_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        w = np.asarray(w, np.float32)
        assert np.any(w != 0)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol,
                                   atol=tol * max(1.0, np.abs(w).max()))
    # cf 1.0 drops slots at these shapes; 8.0 none
    t = x.shape[0] * x.shape[1]
    cap = L.capacity(t, cfg.moe_top_k, cf, cfg.moe_experts)
    _, _, eidx = L.route(tx.detach().reshape(t, -1), tp["router"].detach(),
                         cfg.moe_top_k)
    counts = np.bincount(eidx.reshape(-1).numpy(), minlength=cfg.moe_experts)
    dropped = int(np.clip(counts - cap, 0, None).sum())
    assert (dropped > 0) == (cf == 1.0), (cap, counts)


# ---------------------------------------------------------------------------
# The model: forward, gradients, a train step
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().float().numpy()


def _models(arch, remat="none", seed=1):
    """(jax cfg, numpy params, port cfg): float32 smoke weights made by the
    JAX package, the attention at its true fan-in (at the reference's init
    bf16 noise through the attention alone moves the gradients by up to
    0.14 of their norm at this size)."""
    jcfg = dataclasses.replace(jconfigs.smoke(arch), remat=remat)
    cfg = dataclasses.replace(configs.smoke(arch), remat=remat)
    tree = jax.tree.map(np.asarray, JP.init_tree(jreg.decls(jcfg),
                                                 jax.random.key(seed)))
    tree = registry.true_fan_in(tree, cfg)
    return jcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), tree), cfg


def _batch(accum, mb, seq, vocab, seed=BATCH_SEED):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(accum, mb, seq + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _margins():
    """A patch of ``L.route`` recording each call's smallest gap between a
    token's k-th and (k+1)-th router probability, and the list."""
    seen, real = [], L.route

    def route(xt, router, top_k):
        out = real(xt, router, top_k)
        top = out[0].detach().sort(-1, descending=True).values
        seen.append((top[:, top_k - 1] - top[:, top_k]).min().item())
        return out

    return mock.patch.object(L, "route", route), seen


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_jax(arch):
    jcfg, tree, cfg = _models(arch)
    tokens = _batch(1, 2, 24, cfg.vocab)["tokens"][0]
    want, want_aux = jreg.forward(jax.tree.map(jnp.asarray, tree), jcfg,
                                  tokens=jnp.asarray(tokens))
    patch, margins = _margins()
    with patch:
        got, aux = registry.forward(params_from_numpy(tree, "cpu"), cfg,
                                    torch.from_numpy(tokens).long())
    n_moe = sum(j % cfg.moe_interleave == cfg.moe_interleave - 1
                for j in range(cfg.n_layers))
    assert len(margins) == n_moe and min(margins) >= ROUTER_MARGIN, margins
    assert got.shape == (2, 24, cfg.padded_vocab)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=FWD_TOL,
                               atol=FWD_TOL * max(1.0, np.abs(want).max()))
    assert float(want_aux) > 0
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=AUX_TOL)


def _jax_grads(jcfg, tree, batch, tc):
    """The reference's gradients averaged over the microbatches, as its
    train step takes them."""
    jloss = jtrainer.make_loss_fn(jcfg, tc)
    jparams = jax.tree.map(jnp.asarray, tree)
    accum = batch["tokens"].shape[0]
    grads = [jax.grad(lambda p, mb: jloss(p, mb)[0])(
        jparams, {k: jnp.asarray(v[i]) for k, v in batch.items()})
        for i in range(accum)]
    return [np.asarray(sum(gs) / accum, np.float64)
            for gs in zip(*(jax.tree.leaves(g) for g in grads))]


@pytest.mark.parametrize("accum,remat", [(1, "none"), (2, "full")])
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_gradients_match_jax(arch, accum, remat):
    """The gradients a step hands its optimizer (``trainer.make_grad_fn``:
    cross-entropy, z-loss and ``aux_weight`` x aux) against ``jax.grad`` of
    the reference's loss, leaf by leaf at ``chip_smoke.MOE_GRAD_TOL``;
    every leaf's gradient finite and not all zero on both sides."""
    jcfg, tree, cfg = _models(arch, remat)
    tc = jtrainer.TrainConfig(accum=accum)
    batch = _batch(accum, 2, 24, cfg.vocab)
    want = _jax_grads(jcfg, tree, batch, tc)
    patch, margins = _margins()
    with patch:
        _, metrics, grads = trainer.make_grad_fn(
            cfg, trainer.TrainConfig(**dataclasses.asdict(tc)))(
            params_from_numpy(tree, "cpu"), _tbatch(batch))
    assert min(margins) >= ROUTER_MARGIN, margins
    assert metrics["aux"].item() > 0
    got = [g.double().numpy() for g in tree_leaves(grads)]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and np.any(g != 0)
        assert np.isfinite(w).all() and np.any(w != 0)
    errs = cs.leaf_grad_errs(got, want)
    worst = int(np.argmax(errs))
    assert errs[worst] <= cs.MOE_GRAD_TOL, (worst, errs)


@pytest.mark.parametrize("accum,remat", [(1, "none"), (2, "full")])
@pytest.mark.parametrize("optimizer,act", [("adamw", "bfloat16"),
                                           ("adamw", "float32"),
                                           ("adafactor", "float32")])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, optimizer, act, accum, remat):
    """One float32-params step on identical params and batches, with
    activations in ``act``: loss and ce, grad norm and every updated param
    agree at ``chip_smoke.RECURRENT_STEP_TOL``, aux at ``AUX_TOL``; params
    are written in place. Every param moves by at most 2 lr from the
    reference's, plus the float32 rounding of the two updated values
    (``PARAM_SLACK``), and by more than 2e-6 in under 5% of the elements.
    AdamW's first update is about lr times the gradient's sign, so with
    bf16 activations the elements past 2e-6 are the few whose gradient is
    below the bf16 noise. Adafactor's is the gradient over its factored
    RMS, linear in the gradient: with bf16 activations it carries the
    gradients' bf16 noise into every element (measured: half the elements
    past 2e-6, each leaf's update within 1-5% of the reference's 2-norm,
    a norm scale's up to 35% where near-zero gradients flip an unfactored
    update's sign), so it is held with float32 activations, where the two
    frameworks differ by summation order alone."""
    jcfg, tree, cfg = _models(arch, remat)
    jcfg = dataclasses.replace(jcfg, dtype=act)
    cfg = dataclasses.replace(cfg, dtype=act)
    params = params_from_numpy(tree, "cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    tc = jtrainer.TrainConfig(optimizer=optimizer, accum=accum)
    batch = _batch(accum, 2, 24, cfg.vocab)
    jstep, jo = jtrainer.make_train_step(jcfg, tc)
    jnew, _, jm = jstep(jparams, jo.init(jparams),
                        jax.tree.map(jnp.asarray, batch))
    tstep, to = trainer.make_train_step(
        cfg, trainer.TrainConfig(**dataclasses.asdict(tc)))
    leaves = tree_leaves(params)
    new, state, m = tstep(params, to.init(params), _tbatch(batch))
    assert all(a is b for a, b in zip(tree_leaves(new), leaves))
    assert state["step"] == 1
    loss_tol, norm_tol, share = cs.RECURRENT_STEP_TOL
    for key in ("loss", "ce"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                   rtol=loss_tol, err_msg=key)
    np.testing.assert_allclose(m["aux"].item(), float(jm["aux"]),
                               rtol=AUX_TOL)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=norm_tol)
    diffs = np.concatenate([np.abs(_np(got) - np.asarray(want)).ravel()
                            for got, want in zip(tree_leaves(new),
                                                 jax.tree.leaves(jnew))])
    assert diffs.max() <= 2 * tc.lr + PARAM_SLACK, diffs.max()
    assert (diffs > 2e-6).mean() < share, (diffs > 2e-6).mean()


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_dots_and_full_give_the_logits_and_grads_of_none(arch):
    """Remat ``"dots"`` (the router's product kept; the grouped matmuls,
    with their expert batch dimension, recomputed) and ``"full"`` against
    ``"none"``: equal logits and aux, gradients of every leaf to 1e-7."""
    _, tree, cfg = _models(arch)
    tokens = torch.from_numpy(_batch(1, 2, 24, cfg.vocab)["tokens"][0]).long()
    key, n = registry.stacked(cfg)
    out = {}
    for remat in ("none", "dots", "full"):
        params = params_from_numpy(tree, "cpu")
        tr, leaves = trainer._layer_leaves(params, key, n)
        logits, aux = registry.forward(
            tr, dataclasses.replace(cfg, remat=remat), tokens)
        loss = (logits[..., :cfg.vocab].float() ** 2).mean() + aux
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out[remat] = (logits.detach(), aux.detach(), grads)
    for remat in ("dots", "full"):
        assert torch.equal(out["none"][0], out[remat][0]), remat
        assert torch.equal(out["none"][1], out[remat][1]), remat
        for g, w in zip(out[remat][2], out["none"][2]):
            assert w is not None
            torch.testing.assert_close(g, w, rtol=0, atol=1e-7)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_launches_are_the_calls_a_step_makes(arch, remat):
    """``chip_smoke.train_launches`` for the MoE family, which the card's
    MoE train phase checks exactly, against the grouped-matmul forward,
    dx and dw calls and the attention forward and backward calls one
    train step of 2 microbatches makes on the CPU: an MoE layer's three
    products twice under remat (forward and recompute) and once without,
    six backward products (dx and dw of each) either way."""
    from repro_torch.kernels.attention import ops as attn_ops
    names = {"gmm": [(ref, "grouped_matmul")],
             "gmm_bwd": [(ref, "grouped_matmul_dx"),
                         (ref, "grouped_matmul_dw")],
             "flash_fwd": [(attn_ops, "_forward")],
             "flash_bwd": [(attn_ops, "_backward")]}
    _, tree, cfg = _models(arch, remat)
    params = params_from_numpy(tree, "cpu")
    counts = {k: 0 for k in names}

    def counted(key, fn):
        def call(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return call

    patches = [mock.patch.object(mod, attr, counted(k, getattr(mod, attr)))
               for k, pairs in names.items() for mod, attr in pairs]
    step, opt = trainer.make_train_step(cfg, trainer.TrainConfig(accum=2))
    batch = _tbatch(_batch(2, 2, 24, cfg.vocab))
    for p in patches:
        p.start()
    try:
        step(params, opt.init(params), batch)
    finally:
        for p in patches:
            p.stop()
    want = cs.train_launches(cfg, 2, 1)
    assert counts == want, (remat, counts, want)


@pytest.mark.parametrize("arch,optimizer", [
    ("grok-1-314b", "adafactor"), ("llama4-maverick-400b-a17b", "adamw")])
def test_train_launcher_runs_moe_on_the_cpu_and_the_loss_falls(
        arch, optimizer, capsys):
    """``python -m repro_torch.launch.train --arch ... --smoke --device
    cpu``: the MoE family trains; each step's line carries its loss and
    gradient norm, the run returns the same numbers, and the loss falls
    clearly."""
    run = train_main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "60", "--global-batch", "8", "--seq", "32",
                      "--accum", "2", "--lr", "1e-2", "--init", "true-fan-in",
                      "--optimizer", optimizer])
    lines = [line.split() for line in capsys.readouterr().out.splitlines()
             if line.startswith("step")]
    losses = [float(w[3]) for w in lines]
    assert len(losses) == 60 and all(np.isfinite(losses))
    np.testing.assert_allclose(losses, run.losses, atol=5e-5)
    assert all(np.isfinite(run.grad_norms))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.1, losses


# ---------------------------------------------------------------------------
# The optimizer's slices
# ---------------------------------------------------------------------------


def _leaves(seed=0):
    """A tree with a stacked 4-d leaf of small matrices, one of matrices
    past the slice size (patched small), a 2-d and a 1-d leaf."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (2, 3, 16, 24), "b": (1, 4, 40, 56), "c": (24, 40),
              "d": (40,)}
    return {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for k, s in shapes.items()}


def test_slices_cut_leaves_into_views_of_whole_matrices(monkeypatch):
    monkeypatch.setattr(optim, "_SLICE_ELEMS", 1000)
    t = _leaves()
    rows = [r for r, in optim._slices([t["a"]])]
    # 16 x 24 = 384 elements a matrix: two to a slice, 6 matrices
    assert [tuple(r.shape) for r in rows] == [(2, 16, 24)] * 3
    assert all(r.data_ptr() == t["a"].data_ptr() + i * 2 * 384 * 4
               for i, r in enumerate(rows))
    vr, vc = torch.zeros((1, 4, 40)), torch.zeros((1, 4, 56))
    cut = optim._slices([t["b"], vr, vc], [2, 1, 1])
    assert [tuple(x.shape for x in s) for s in cut] == \
        [((1, 40, 56), (1, 40), (1, 56))] * 4
    assert optim._slices([t["c"], t["c"]])[0][0] is t["c"]
    # a tensor that is not contiguous cuts every tensor one matrix a slice
    tt = t["a"].transpose(0, 1)
    cut = optim._slices([tt, torch.zeros_like(tt).contiguous()])
    assert [tuple(x.shape for x in s) for s in cut] == [((16, 24),) * 2] * 6


def _whole_adamw(g, m, v, w, lr, step, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    """The update on whole leaves (the slicing's reference)."""
    t = np.float32(step)
    c1 = float(np.float32(1.0) - np.float32(b1) ** t)
    c2 = float(np.float32(1.0) - np.float32(b2) ** t)
    g = g.float()
    m = m * b1 + g * (1 - b1)
    v = (v * b2).addcmul(g, g, value=1 - b2)
    u = (m / c1) / (torch.sqrt(v / c2) + eps)
    return m, v, w - float(np.float32(lr)) * (u + wd * w)


def test_sliced_adamw_is_the_whole_leaf_arithmetic_bit_for_bit(monkeypatch):
    """Without clipping AdamW is elementwise: the sliced update equals the
    whole-leaf one bit for bit, moments, master and params."""
    monkeypatch.setattr(optim, "_SLICE_ELEMS", 1000)
    params, grads = _leaves(1), _leaves(2)
    opt = optim.adamw(clip=0.0)
    state = opt.init(params)
    want = {k: _whole_adamw(grads[k], state["m"][k], state["v"][k],
                            state["master"][k], 1e-2, 1) for k in params}
    opt.update(grads, state, params, 1e-2)
    for k, (m, v, w) in want.items():
        assert torch.equal(state["m"][k], m) and torch.equal(state["v"][k], v)
        assert torch.equal(state["master"][k], w) and torch.equal(params[k], w)


def test_sliced_global_norm_and_clip_match_the_whole_leaf(monkeypatch):
    monkeypatch.setattr(optim, "_SLICE_ELEMS", 1000)
    grads = _leaves(3)
    want = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values()))
    norm = optim.global_norm(grads)
    torch.testing.assert_close(norm.double(), want, rtol=1e-6, atol=0)
    whole = {k: (g * torch.clamp(1.0 / norm, max=1.0)) for k, g in
             grads.items()}
    clipped, before = optim.clip_by_global_norm(grads, 1.0)
    assert before is not None and clipped is grads
    for k, g in grads.items():            # elementwise: bit for bit
        assert torch.equal(g, whole[k]), k


@pytest.mark.parametrize("slice_elems", [1000, 1 << 26])
def test_sliced_adafactor_matches_the_reference(monkeypatch, slice_elems):
    """Adafactor sliced by matrices against the JAX package's whole-leaf
    update on the same params and gradients, two steps: the factored
    moments (per matrix, as the reference's), the master and the params
    within float32 rounding (the update's RMS is summed over the slices),
    the grad norm likewise."""
    monkeypatch.setattr(optim, "_SLICE_ELEMS", slice_elems)
    params, jopt, opt = _leaves(4), joptim.adafactor(), optim.adafactor()
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jstate, state = jopt.init(jparams), opt.init(params)
    for step in range(2):
        grads = _leaves(5 + step)
        jg = {k: jnp.asarray(v.numpy()) for k, v in grads.items()}
        jparams, jstate, jm = jopt.update(jg, jstate, jparams,
                                          jnp.asarray(1e-2, jnp.float32))
        params, state, m = opt.update(grads, state, params, 1e-2)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for name in ("vr", "vc", "master"):
            for k in params:
                np.testing.assert_allclose(state[name][k].numpy(),
                                           np.asarray(jstate[name][k]),
                                           rtol=2e-6, atol=1e-7,
                                           err_msg=f"{name} {k}")
        for k in params:
            np.testing.assert_allclose(params[k].numpy(),
                                       np.asarray(jparams[k]), rtol=2e-6,
                                       atol=1e-7, err_msg=k)
