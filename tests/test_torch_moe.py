"""The port's MoE layer and grouped matmul against the JAX package.

The same numpy inputs (and weights made by the JAX package, bridged with
``repro_torch.bridge``) go through ``repro.kernels.moe`` (the Pallas kernel
in interpret mode, and its oracle ``ref``), ``repro.models.layers.moe`` and
the port:

* the plain ``grouped_matmul`` against the Pallas kernel on the reference's
  cases (``tests/test_kernels.py:137-150``) at its tolerances (float32
  1e-4, bfloat16 5e-2 against the float32 oracle), and against the oracle
  at a ragged shape the Pallas wrapper refuses;
* ``moe_ffn`` against the Pallas ``ops.moe_ffn`` and ``ref.moe_ffn``: the
  float32 products and sum, one rounding, and the SiLU rounded at each
  step as XLA rounds it in bf16 (equal bit for bit in bf16);
* ``layers.moe`` against ``L.moe`` (output, aux loss and the routing) at
  the grok smoke shapes (4 experts, top-2) and the llama4 smoke shapes
  (top-1, shared expert), at capacity factor 1.25 and at one that drops
  slots, with the reference's expert FFN chunked and through Pallas;
  against ``moe_dense_ref`` where nothing is dropped; ties in the router
  choose the lowest experts, as ``lax.top_k`` does;
* ``init_tree`` drawing straight in bf16 with a bounded float32 transient;
* the wrapper's routing (CPU to the plain version, CUDA to the kernel,
  any other device raises) and the XAIF registration; the CUDA kernel
  against the plain version on the card (tests that skip here, and
  ``chip_smoke.py``).

Whole-layer tolerances: float32 2e-5 (the frameworks differ only in
summation order), bfloat16 6e-2 (XLA rounds fused elementwise chains at
other places than PyTorch's op-by-op execution), as
``tests/test_torch_transformer.py`` holds bf16 logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

import repro.kernels  # noqa: F401  (XAIF registration of "pallas")
from repro import configs as jconfigs
from repro.kernels.moe import ops as jops
from repro.kernels.moe import ref as jref
from repro.kernels.moe.kernel import grouped_matmul as pallas_gmm
from repro.models import layers as JL
from repro.sharding import params as JP

torch = configs = params_from_numpy = kernel = ops = ref = L = None
P = registry = None  # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, configs, params_from_numpy, kernel, ops, ref, L, P
    global registry
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.kernels.moe import kernel, ops, ref
    from repro_torch.models import layers as L
    from repro_torch.models import registry
    from repro_torch.sharding import params as P
    torch.set_num_threads(1)


GMM_CASES = [(4, 16, 32, 64), (2, 128, 64, 128), (8, 8, 16, 16)]
GMM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}      # tests/test_kernels.py:147
TOL = {"float32": 2e-5, "bfloat16": 6e-2}          # whole layer


def _arr(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# Grouped matmul and the expert FFN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e,c,d,f", GMM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_grouped_matmul_matches_the_pallas_kernel(e, c, d, f, dtype):
    x, w = _arr((e, c, d), 1, 0.3), _arr((e, d, f), 2, 0.3)
    pallas = pallas_gmm(_jax(x, dtype), _jax(w, dtype), c_block=min(8, c),
                        f_block=min(16, f), d_block=min(16, d))
    oracle = jref.grouped_matmul(_jax(x, dtype).astype(jnp.float32),
                                 _jax(w, dtype).astype(jnp.float32))
    got = ops.grouped_matmul(_torch(x, dtype), _torch(w, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (e, c, f)
    _close(got, oracle, GMM_TOL[dtype])
    _close(got, pallas, GMM_TOL[dtype])
    if dtype == "bfloat16":
        # float32 sums rounded once, as the Pallas kernel rounds them
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(pallas, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_grouped_matmul_takes_a_ragged_shape(dtype):
    """C 37, D 45, F 77: no block size divides them, so the Pallas wrapper
    refuses the shape; the port's plain version (and the kernel) take it."""
    x, w = _arr((3, 37, 45), 3), _arr((3, 45, 77), 4, 45 ** -0.5)
    with pytest.raises(AssertionError):
        pallas_gmm(jnp.asarray(x), jnp.asarray(w), c_block=8, f_block=16,
                   d_block=16)
    oracle = jref.grouped_matmul(_jax(x, dtype).astype(jnp.float32),
                                 _jax(w, dtype).astype(jnp.float32))
    got = ref.grouped_matmul(_torch(x, dtype), _torch(w, dtype))
    _close(got, oracle, GMM_TOL[dtype])


# grok-1's four expert-FFN shapes (chip_smoke.GMM_PATH) and their plans:
# route, splits of D, float32 workspace bytes
GROK_PLANS = [((8, 2560, 6144, 32768), ("wgmma", 1, 0)),
              ((8, 2560, 32768, 6144), ("wgmma", 1, 0)),
              ((8, 8, 6144, 32768), ("splitd", 1, 0)),
              ((8, 8, 32768, 6144), ("splitd", 4, 4 * 8 * 8 * 6144 * 4))]


@pytest.mark.parametrize("shape,want", GROK_PLANS)
def test_plan_routes_grok_expert_ffn_shapes(shape, want):
    """bf16 prefill (C 2560) on wgmma; decode (C 8) on split D, with D cut
    into chunks until E x F tiles x S fills about 4 waves of 132 SMs (the
    down projection's 384 tiles need S 4; gate/up's 2048 none)."""
    e, c, d, f = shape
    p = kernel.plan(e, c, d, f, torch.bfloat16)
    assert (p.route, p.splits, p.workspace_bytes) == want
    if p.route == "splitd":
        assert e * -(-f // 128) * p.splits >= 4 * 132


@pytest.mark.parametrize("shape,x_aligned,w_aligned", [
    ((8, 2560, 6144, 32768), False, True),
    ((8, 8, 32768, 6144), True, False),
    ((8, 2560, 6140, 32768), True, True),      # D off a multiple of 8
    ((8, 8, 6144, 32764), True, True),         # F off a multiple of 8
    ((3, 37, 45, 77), True, True)])
def test_plan_sends_what_tma_cannot_take_to_mma_sync(shape, x_aligned,
                                                     w_aligned):
    """TMA reads 16-byte aligned bases and rows; anything else stays on the
    mma.sync kernel, and float32 on the CUDA cores, whatever the shape."""
    p = kernel.plan(*shape, torch.bfloat16, x_aligned, w_aligned)
    assert p == kernel.Plan("mma", 1, 0)
    assert kernel.plan(*shape, torch.float32, x_aligned, w_aligned) == \
        kernel.Plan("f32", 1, 0)


def test_split_d_chunks_cover_d():
    """Every split-D plan cuts D into S chunks of the C entry's
    ``split_chunk`` (a multiple of the 64-deep step), none of them empty,
    and asks for a workspace only when it splits."""
    for e in (1, 3, 8):
        for f in (8, 136, 6144):
            for d in (8, 56, 64, 72, 1008, 4096, 6144, 32768):
                p = kernel.plan(e, 8, d, f, torch.bfloat16)
                chunk = -(-(-(-d // p.splits)) // 64) * 64
                assert p.route == "splitd" and 1 <= p.splits <= 65535
                assert (p.splits - 1) * chunk < d <= p.splits * chunk
                assert p.workspace_bytes == (
                    p.splits * e * 8 * f * 4 if p.splits > 1 else 0)


def test_split_d_arithmetic_matches_pallas_and_float64():
    """The split-D route's arithmetic emulated on the CPU at E 2, C 8,
    D 4096, F 256 (S 8 chunks of 512): a float32 partial per chunk, the
    partials added in split order, one bf16 rounding. Within the
    reference's bf16 tolerance of the Pallas kernel (interpret mode), and
    within the bf16 bound of float64: one rounding (2^-8 |y|) plus
    float32's summation error ((chunk + S) 2^-24 sum |x| |w|, doubled)."""
    e, c, d, f = 2, 8, 4096, 256
    p = kernel.plan(e, c, d, f, torch.bfloat16)
    assert (p.route, p.splits) == ("splitd", 8)
    chunk = d // p.splits
    x, w = _arr((e, c, d), 21), _arr((e, d, f), 22, d ** -0.5)
    xt, wt = _torch(x, "bfloat16").float(), _torch(w, "bfloat16").float()
    total = None
    for k in range(0, d, chunk):
        part = torch.einsum("ecd,edf->ecf", xt[..., k:k + chunk],
                            wt[:, k:k + chunk])
        total = part if total is None else total + part
    emu = total.to(torch.bfloat16)
    pallas = pallas_gmm(_jax(x, "bfloat16"), _jax(w, "bfloat16"), c_block=8,
                        f_block=256, d_block=512)
    _close(emu, pallas, GMM_TOL["bfloat16"])
    f64 = torch.einsum("ecd,edf->ecf", xt.double(), wt.double())
    mag = torch.einsum("ecd,edf->ecf", xt.double().abs(), wt.double().abs())
    bound = 2 ** -8 * f64.abs() + 2 * (chunk + p.splits) * 2 ** -24 * mag
    assert bool(((emu.double() - f64).abs() <= bound).all())


def _ffn_params(e=4, d=32, f=64):
    return {"w_gate": _arr((e, d, f), 11, 0.1), "w_up": _arr((e, d, f), 12, 0.1),
            "w_down": _arr((e, f, d), 13, 0.1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_pallas_and_the_oracle(dtype):
    xg = _arr((4, 16, 32), 10, 0.4)
    p = _ffn_params()
    jp = {k: _jax(v, dtype) for k, v in p.items()}
    tp = {k: _torch(v, dtype) for k, v in p.items()}
    pallas = jops.moe_ffn(_jax(xg, dtype), jp)              # interpret mode
    oracle = jref.moe_ffn(_jax(xg, dtype), jp)
    got = ops.moe_ffn(_torch(xg, dtype), tp)
    assert got.dtype == getattr(torch, dtype) and got.shape == (4, 16, 32)
    tol = 1e-5 if dtype == "float32" else GMM_TOL[dtype]
    _close(got, pallas, tol)
    _close(got, oracle, tol)
    _close(ref.moe_ffn(_torch(xg, dtype), tp), pallas, tol)
    if dtype == "bfloat16":
        # one rounding a product and XLA's rounding of the SiLU
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(pallas, np.float32))


def test_moe_ffn_casts_the_weights_to_the_tokens_dtype():
    xg = _torch(_arr((4, 8, 32), 14, 0.4), "bfloat16")
    p = {k: _torch(v, "float32") for k, v in _ffn_params().items()}
    got = ops.moe_ffn(xg, p)
    want = ops.moe_ffn(xg, {k: v.to(torch.bfloat16) for k, v in p.items()})
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

ARCHS = ["grok_1_314b", "llama4_maverick_400b"]


def _layer(arch, dtype, seed=3):
    """(cfg, jax params, port params, x as numpy) for one MoE layer of the
    smoke config, weights made by the JAX package."""
    cfg = configs.smoke(arch)
    jd = JL.moe_decls(cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.mlp_type,
                      shared=cfg.moe_shared_expert)
    jp = JP.init_tree(jd, jax.random.key(seed))
    jp = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = _arr((2, 24, cfg.d_model), seed + 1)
    return cfg, jp, tp, x


def _jax_route(x, router, top_k):
    xt = jnp.asarray(x).reshape(-1, x.shape[-1]).astype(jnp.float32)
    probs = jax.nn.softmax(xt @ router.astype(jnp.float32), axis=-1)
    return np.asarray(lax.top_k(probs, top_k)[1])


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "drops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_jax(arch, dtype, cf, impl):
    cfg, jp, tp, x = _layer(arch, dtype)
    kw = dict(n_exp=cfg.moe_experts, top_k=cfg.moe_top_k, capacity_factor=cf,
              kind=cfg.mlp_type)
    want, want_aux = JL.moe(_jax(x, dtype), jp, impl=impl, **kw)
    got, got_aux = L.moe(_torch(x, dtype), tp, **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    _close(got, want, TOL[dtype])
    np.testing.assert_allclose(got_aux.item(), float(want_aux), rtol=1e-5)

    xt = _torch(x, dtype).reshape(-1, cfg.d_model)
    _, _, eidx = L.route(xt, tp["router"], cfg.moe_top_k)
    want_idx = _jax_route(_jax(x, dtype), jp["router"], cfg.moe_top_k)
    np.testing.assert_array_equal(eidx.numpy(), want_idx)
    t = x.shape[0] * x.shape[1]
    cap = L.capacity(t, cfg.moe_top_k, cf, cfg.moe_experts)
    counts = np.bincount(want_idx.reshape(-1), minlength=cfg.moe_experts)
    dropped = int(np.clip(counts - cap, 0, None).sum())
    if cf < 1:
        assert dropped > 0, (cap, counts)       # the case drops slots


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_equals_the_dense_oracle_without_drops(arch):
    cfg, jp, tp, x = _layer(arch, "float32")
    kw = dict(n_exp=cfg.moe_experts, top_k=cfg.moe_top_k, kind=cfg.mlp_type)
    got, _ = L.moe(_torch(x, "float32"), tp, capacity_factor=8.0, **kw)
    dense = L.moe_dense_ref(_torch(x, "float32"), tp, **kw)
    torch.testing.assert_close(got, dense, atol=1e-5, rtol=1e-5)
    _close(dense, JL.moe_dense_ref(jnp.asarray(x), jp, **kw), TOL["float32"])


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_router_ties_choose_the_lowest_experts_as_jax_does(top_k):
    """A zero router gives every expert the same probability; ``lax.top_k``
    then takes experts 0 ... k-1 (``torch.topk`` on the CPU need not), and
    the stable dispatch keeps token order within an expert."""
    e, d = 6, 16
    x = _arr((2, 5, d), 21)
    router = np.zeros((d, e), np.float32)
    want = _jax_route(jnp.asarray(x), jnp.asarray(router), top_k)
    probs, gates, eidx = L.route(torch.from_numpy(x).reshape(-1, d),
                                 torch.from_numpy(router), top_k)
    assert (want == np.arange(top_k)).all()
    np.testing.assert_array_equal(eidx.numpy(), want)
    torch.testing.assert_close(gates, torch.full((10, top_k), 1 / top_k))
    # and through the whole layer, at a capacity that drops the later tokens
    p = {"router": router, "w_gate": _arr((e, d, 8), 22, 0.3),
         "w_up": _arr((e, d, 8), 23, 0.3), "w_down": _arr((e, 8, d), 24, 0.3)}
    kw = dict(n_exp=e, top_k=top_k, capacity_factor=1.0)
    want_out, _ = JL.moe(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                         **kw)
    got_out, _ = L.moe(torch.from_numpy(x),
                       {k: torch.from_numpy(v) for k, v in p.items()}, **kw)
    _close(got_out, want_out, TOL["float32"])


def test_capacity_follows_the_reference_formula():
    # int() truncates before the round-up to a multiple of 8; at least 8,
    # at most the token count
    assert L.capacity(8192, 2, 1.25, 8) == 2560       # grok-1's prefill
    assert L.capacity(8, 2, 1.25, 8) == 8             # its decode step
    assert L.capacity(24, 2, 1.25, 4) == 16           # int(15.0) -> 16
    assert L.capacity(100, 1, 1.3, 4) == 32           # int(32.5) = 32
    assert L.capacity(4, 2, 1.25, 4) == 4
    assert L.capacity(1000, 2, 0.01, 8) == 8


# ---------------------------------------------------------------------------
# Weights drawn in bf16
# ---------------------------------------------------------------------------


def test_bf16_init_tree_leaves_have_the_decl_shape_and_std(monkeypatch):
    """``init_tree(..., dtype=bfloat16)`` draws every leaf straight in
    bf16; the float32 transient is a slice of ``DRAW_CHUNK`` elements, so
    a leaf drawn in many slices has the decl's std all through."""
    monkeypatch.setattr(P, "DRAW_CHUNK", 1000)       # many slices a leaf
    cfg = configs.smoke("grok_1_314b")
    decls = registry.decls(cfg)
    params = P.init_tree(decls, 0, "cpu", dtype=torch.bfloat16)
    for d, leaf in zip(P.tree_leaves(decls), P.tree_leaves(params)):
        assert leaf.dtype == torch.bfloat16 and tuple(leaf.shape) == d.shape
        if d.init == "ones":
            assert bool((leaf == 1).all())
            continue
        std = (d.scale or 0.02) if d.init == "normal" else d.shape[-2] ** -0.5
        flat = leaf.float().reshape(-1)
        assert abs(flat.std().item() / std - 1) < 0.05, (d, flat.std())
        assert abs(flat.mean().item()) < 0.05 * std * 10
        if flat.numel() >= 2000:
            # no slice left undrawn: every 1000-element slice has spread
            tail = flat[: flat.numel() // 1000 * 1000].reshape(-1, 1000)
            assert bool((tail.std(dim=1) > 0.5 * std).all())
    # the default dtype is the decl's (float32)
    assert P.init_tree(decls, 0, "cpu")["embed"].dtype == torch.float32


def test_grok_full_width_param_counts_match_jax():
    full = configs.get("grok_1_314b")
    assert full.param_count() == jconfigs.get("grok_1_314b").param_count()
    assert full.param_count() == 316_489_340_928
    cut = dataclasses.replace(full, n_layers=4)
    assert cut.param_count() == 21_290_539_008


# ---------------------------------------------------------------------------
# Dispatch, registration, the card
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    real = ref.grouped_matmul
    monkeypatch.setattr(ref, "grouped_matmul",
                        lambda x, w: calls.append(1) or real(x, w))
    before = kernel.launches
    xg = torch.from_numpy(_arr((4, 16, 32), 10, 0.4))
    ops.moe_ffn(xg, {k: torch.from_numpy(v) for k, v in _ffn_params().items()})
    assert calls == [1, 1, 1]                      # gate, up, down
    assert kernel.launches == before and kernel._lib is None


def test_dispatch_refusals():
    x = torch.zeros((2, 4, 8))
    w = torch.zeros((2, 8, 4))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ops.grouped_matmul(x.to("meta"), w.to("meta"))
    # the launching wrapper refuses what the kernel does not take, before
    # it builds anything
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.grouped_matmul_cuda(x, w)
    with pytest.raises(ValueError, match=r"want x \(E, C, D\)"):
        kernel.grouped_matmul_cuda(x, torch.zeros((2, 7, 4)))
    with pytest.raises(ValueError, match=r"want x \(E, C, D\)"):
        kernel.grouped_matmul_cuda(x, torch.zeros((3, 8, 4)))
    with pytest.raises(ValueError, match="1 <= E"):
        kernel.grouped_matmul_cuda(torch.zeros((2, 0, 8)), w)
    assert kernel._lib is None


def test_registered_under_cuda():
    from repro_torch.core.xaif import REGISTRY

    import repro_torch.kernels  # noqa: F401
    spec = REGISTRY.get("moe_ffn", "cuda")
    assert spec.fn is ops.moe_ffn and spec.power_domain.name == "acc_moe"
    assert [p.name for p in spec.master_ports] == [
        "tokens_in", "w_gate", "w_up", "w_down", "tokens_out"]
    assert spec.slave_ports[0].name == "routing_config"
    xg = torch.from_numpy(_arr((4, 16, 32), 10, 0.4))
    p = {k: torch.from_numpy(v) for k, v in _ffn_params().items()}
    torch.testing.assert_close(REGISTRY.dispatch("moe_ffn", "cuda", xg, p),
                               ops.moe_ffn(xg, p), rtol=0, atol=0)


@pytest.mark.parametrize("e,c,d,f", GMM_CASES + [(3, 37, 45, 77), (1, 1, 1, 1),
                                                 (2, 200, 64, 136)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(e, c, d, f, dtype):
    """The CUDA kernel against the plain version on the card (skips
    here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = _torch(_arr((e, c, d), 1), dtype).cuda()
    w = _torch(_arr((e, d, f), 2, d ** -0.5), dtype).cuda()
    before = kernel.launches
    got = ops.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _close(got.cpu(), ref.grouped_matmul(x, w).cpu().float().numpy(),
           GMM_TOL[dtype])
