"""The port's flash attention against ``repro.kernels.attention`` and the
reference training path's custom VJP (``repro.models.layers``).

The plain forward is held to both JAX impls (the naive ``ref.attention`` and
the Pallas kernel in interpret mode, as the JAX tests run it) on the
reference's ``ATTN_CASES`` (``tests/test_kernels.py:21-27``), at the
reference's tolerances: float32 2e-5, bfloat16 3e-2. ``lse`` is held to
``layers._flash_fwd_impl``; the forward at head dim 256 (MQA, a window:
the hybrid family's prefill) to ``attention_chunked`` and
``attention_banded``; the plain backward, and the autograd function
around both, to ``jax.grad`` through ``layers.attention_chunked`` at atol
2e-4 (``tests/test_kernels.py:61``); the autograd function to
``torch.autograd.gradcheck`` in float64. The CUDA kernels are held to the
plain versions on the card by the tests that skip here and by
``chip_smoke.py``.
"""

import math
import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.attention import ops as jops
from repro.kernels.attention import ref as jref
from repro.models import layers as JL

torch = build_mod = kernel = ops = ref = None  # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, build_mod, kernel, ops, ref
    torch = pytest.importorskip("torch")
    from repro_torch.kernels import build as build_mod
    from repro_torch.kernels.attention import kernel, ops, ref
    torch.set_num_threads(1)


# B, S, H, K, D, window, causal (tests/test_kernels.py:21-27)
ATTN_CASES = [
    (2, 64, 4, 2, 16, None, True),
    (1, 48, 4, 4, 48, None, True),     # MHA, unaligned D
    (2, 40, 8, 2, 16, 24, True),       # SWA, ragged S
    (1, 96, 4, 1, 64, None, False),    # MQA, non-causal
    (2, 64, 4, 2, 120, None, True),    # danube-style head_dim 120
]
# the edges of the CUDA bf16 backward's tiles (64 keys a dK/dV block, 64
# query rows a step at D <= 64 and 32 at D <= 128; 64 queries a dQ block):
# B, S, H, K, D, window, causal, with S as (Sq, Sk) where they differ
EDGE_CASES = [
    pytest.param(2, 80, 4, 2, 8, None, True, id="d8"),
    pytest.param(1, 200, 4, 2, 120, None, True, id="d120_ragged"),
    pytest.param(2, 200, 4, 2, 64, None, True, id="ragged_three_tiles"),
    pytest.param(1, 300, 8, 2, 32, None, True, id="g4_five_key_tiles"),
    pytest.param(2, 230, 4, 1, 64, 40, True, id="window_inside_tile"),
    pytest.param(1, 200, 4, 2, 128, 50, True, id="d128_window_inside_tile"),
    pytest.param(1, (72, 136), 4, 2, 64, None, False, id="noncausal_sq_lt_sk"),
    pytest.param(1, (150, 70), 4, 4, 16, None, False, id="noncausal_sq_gt_sk"),
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
GRAD_ATOL = 2e-4


def _inputs(b, s, h, k, d, seed=7):
    """q, k, v, do from a seed; ``s`` is S or (Sq, Sk)."""
    sq, sk = s if isinstance(s, tuple) else (s, s)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    kk = rng.normal(size=(b, sk, k, d)).astype(np.float32)
    vv = rng.normal(size=(b, sk, k, d)).astype(np.float32)
    do = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    return q, kk, vv, do


def _torch(a, dtype="float32"):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,k,d,win,causal", ATTN_CASES)
def test_plain_forward_matches_jax(b, s, h, k, d, win, causal, dtype, impl):
    q, kk, vv, _ = _inputs(b, s, h, k, d)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, kk, vv))
    if impl == "ref":
        want = jref.attention(jq, jk, jv, causal=causal, window=win)
    else:
        want = jops.flash_attention(jq, jk, jv, causal=causal, window=win,
                                    q_block=16, kv_block=16)
    got = ops.flash_attention(_torch(q, dtype), _torch(kk, dtype),
                              _torch(vv, dtype), causal=causal, window=win)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# recurrentgemma's attention at smoke length: head dim 256, MQA, a window
D256 = (2, 80, 4, 1, 256, 24, True)      # B, S, H, K, D, window, causal


@pytest.mark.parametrize("impl", ["chunked", "banded"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_d256_matches_jax(dtype, impl):
    """The forward at head dim 256 (the hybrid family's prefill) against the
    reference's two windowed paths: ``attention_chunked`` and the banded
    O(S * window) path the reference's prefill takes."""
    b, s, h, k, d, win, causal = D256
    q, kk, vv, _ = _inputs(b, s, h, k, d, seed=2)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, kk, vv))
    if impl == "chunked":
        want = JL.attention_chunked(jq, jk, jv, causal=causal, window=win,
                                    q_block=16, kv_block=16)
    else:
        want = JL.attention_banded(jq, jk, jv, window=win, q_block=16)
    got = ops.flash_attention(_torch(q, dtype), _torch(kk, dtype),
                              _torch(vv, dtype), causal=causal, window=win)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_kernel_head_dim_limits():
    """The CUDA forward and backward both take D up to 256 and refuse 264;
    the shape checks come before the device check, so they show on the
    CPU."""
    def qkv(d):
        return [torch.zeros((1, 8, 2, d)) for _ in range(3)]

    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernel.flash_attention_fwd_cuda(*qkv(256))        # D 256 is taken
    with pytest.raises(ValueError, match="D <= 256"):
        kernel.flash_attention_fwd_cuda(*qkv(264))
    q, k, v = qkv(256)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernel.flash_attention_bwd_cuda(q, k, v, q, torch.zeros(1, 2, 8), q)
    q, k, v = qkv(264)
    with pytest.raises(ValueError, match="D <= 256"):
        kernel.flash_attention_bwd_cuda(q, k, v, q, torch.zeros(1, 2, 8), q)


# recurrentgemma's training attention at smoke length: head dim 256, G 4 or
# 10 query heads a KV head, a window shorter than S
D256_GRAD = [pytest.param(2, 80, 4, 1, 256, 24, id="g4"),
             pytest.param(1, 70, 10, 1, 256, 32, id="g10")]


@pytest.mark.parametrize("impl", ["chunked", "banded"])
@pytest.mark.parametrize("b,s,h,k,d,win", D256_GRAD)
def test_plain_backward_d256_matches_jax_vjp(b, s, h, k, d, win, impl):
    """The backward at head dim 256 (the hybrid family's training) through
    ``ops.flash_attention``'s autograd on the plain versions, against
    ``jax.vjp`` of the reference's two windowed paths:
    ``attention_banded``, which its training forward takes
    (``layers.py:303-305``), and ``attention_chunked``. float32, 2e-5
    (KV repeated over the group in JAX, summed over it here)."""
    q, kk, vv, do = _inputs(b, s, h, k, d, seed=5)
    if impl == "chunked":
        fn = lambda q_, k_, v_: JL.attention_chunked(
            q_, k_, v_, causal=True, window=win, q_block=16, kv_block=16)
    else:
        fn = lambda q_, k_, v_: JL.attention_banded(q_, k_, v_, window=win,
                                                    q_block=16)
    g = h // k
    rep = lambda t: jnp.repeat(t, g, axis=2)     # layers.attention's repeat
    _, vjp = jax.vjp(lambda q_, k_, v_: fn(q_, rep(k_), rep(v_)),
                     *(jnp.asarray(a) for a in (q, kk, vv)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, kk, vv)]
    o = ops.flash_attention(*leaves, causal=True, window=win)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    for name, gt, w in zip("qkv", got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("b,s,h,k,d,win,causal", ATTN_CASES)
def test_lse_matches_flash_fwd_impl(b, s, h, k, d, win, causal):
    q, kk, vv, _ = _inputs(b, s, h, k, d)
    _, jlse = JL._flash_fwd_impl(jnp.asarray(q), jnp.asarray(kk),
                                 jnp.asarray(vv), jnp.asarray(s, jnp.int32),
                                 causal, win, 0, 16, 16)
    want = np.asarray(jlse).reshape(b, h, -1)[:, :, :s]   # (B,K,G,Sq_pad)
    _, lse = ref.flash_attention_ref(_torch(q), _torch(kk), _torch(vv),
                                     causal=causal, window=win)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    np.testing.assert_allclose(lse.numpy(), want, atol=TOL["float32"],
                               rtol=TOL["float32"])


def _jax_grads(q, kk, vv, do, causal, win):
    def loss(q, k, v):
        o = JL.attention_chunked(q, k, v, causal=causal, window=win,
                                 q_block=16, kv_block=16)
        return jnp.sum(o * jnp.asarray(do))

    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv))


@pytest.mark.parametrize("b,s,h,k,d,win,causal", ATTN_CASES + EDGE_CASES)
def test_plain_backward_matches_jax_grad(b, s, h, k, d, win, causal):
    q, kk, vv, do = _inputs(b, s, h, k, d)
    tq, tk, tv = _torch(q), _torch(kk), _torch(vv)
    o, lse = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=win)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, _torch(do),
                                      causal=causal, window=win)
    for name, g, w in zip("qkv", got, _jax_grads(q, kk, vv, do, causal, win)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", [ATTN_CASES[0], ATTN_CASES[2]],
                         ids=["gqa_causal", "gqa_window"])
def test_autograd_matches_jax_grad(case):
    """The autograd function (forward saving lse, backward from it) gives
    the reference's gradients through ``Tensor.backward``."""
    b, s, h, k, d, win, causal = case
    q, kk, vv, do = _inputs(b, s, h, k, d, seed=3)
    tq, tk, tv = (_torch(a).requires_grad_() for a in (q, kk, vv))
    o = ops.flash_attention(tq, tk, tv, causal=causal, window=win)
    (o * _torch(do)).sum().backward()
    for name, t, w in zip("qkv", (tq, tk, tv),
                          _jax_grads(q, kk, vv, do, causal, win)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("s,h,k,d,win,causal", [
    (12, 4, 2, 8, None, True),
    (12, 4, 2, 8, 5, True),
    (10, 2, 1, 8, None, False),
], ids=["gqa_causal", "gqa_window", "mqa_noncausal"])
def test_gradcheck_float64(s, h, k, d, win, causal):
    gen = torch.Generator().manual_seed(0)
    args = [torch.randn((1, s, n, d), generator=gen, dtype=torch.float64,
                        requires_grad=True) for n in (h, k, k)]
    assert torch.autograd.gradcheck(
        lambda q, kk, vv: ops.flash_attention(q, kk, vv, causal=causal,
                                              window=win), args)


def test_dispatch_raises_off_cuda_and_cpu():
    meta = [torch.empty((1, 8, 2, 8), device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ops.flash_attention(*meta)
    cpu = [torch.randn(1, 8, 2, 8) for _ in range(3)]
    before = (kernel.launches_fwd, kernel.launches_bwd)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernel.flash_attention_fwd_cuda(*cpu)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernel.flash_attention_bwd_cuda(*cpu, cpu[0], torch.zeros(1, 2, 8),
                                        cpu[0])
    assert (kernel.launches_fwd, kernel.launches_bwd) == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the card's machine has nvcc")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(kernel, "_BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.build()


def test_shared_build_keys_the_library_by_source_hash(monkeypatch, tmp_path):
    """The shared recipe: one library per source content, the compiler's
    report kept as ``.log``, an unchanged source not rebuilt."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "nvcc"
    calls = tmp_path / "calls"
    fake.write_text('#!/bin/sh\necho call >> "%s"\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\necho "ptxas info: 0 bytes spill"\n' % calls)
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bindir) + os.pathsep + os.environ["PATH"])
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    lib = build_mod.build(src, "k", tmp_path / "build")
    assert lib.exists() and lib.name.startswith("libk_")
    assert "ptxas info" in lib.with_suffix(".log").read_text()
    assert build_mod.build(src, "k", tmp_path / "build") == lib
    src.write_text("// two\n")
    lib2 = build_mod.build(src, "k", tmp_path / "build")
    assert lib2 != lib and lib2.exists()
    assert calls.read_text().count("call") == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,k,d,win,causal", ATTN_CASES + EDGE_CASES)
def test_cuda_kernels_match_plain(b, s, h, k, d, win, causal, dtype):
    """The CUDA forward and backward against the plain versions on the
    card (skips here). The backward's tolerance is the forward's for
    float32; in bfloat16 each gradient rounds once more. bfloat16 takes
    the tensor-core forward; a second forward call and a second backward
    call give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, kk, vv, do = (_torch(a, dtype).cuda() for a in _inputs(b, s, h, k, d))
    mma0 = kernel.launches_fwd_mma
    o, lse = kernel.flash_attention_fwd_cuda(q, kk, vv, causal=causal,
                                             window=win)
    assert kernel.launches_fwd_mma - mma0 == (dtype == "bfloat16")
    wo, wlse = ref.flash_attention_ref(q, kk, vv, causal=causal, window=win)
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), wo.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, wlse, atol=2e-5, rtol=2e-5)
    o2, lse2 = kernel.flash_attention_fwd_cuda(q, kk, vv, causal=causal,
                                               window=win)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    got = kernel.flash_attention_bwd_cuda(q, kk, vv, wo, wlse, do,
                                          causal=causal, window=win)
    want = ref.flash_attention_bwd_ref(q, kk, vv, wo, wlse, do, causal=causal,
                                       window=win)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=GRAD_ATOL
                                   if dtype == "float32" else tol, rtol=tol)
    again = kernel.flash_attention_bwd_cuda(q, kk, vv, wo, wlse, do,
                                            causal=causal, window=win)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_aligned_copies_only_misaligned_views():
    """The tensor-core kernels load rows 16 bytes at a time: the wrapper
    passes an aligned tensor as it is and copies a view at an odd offset."""
    base = torch.zeros(64, dtype=torch.bfloat16)
    aligned = base[:32]
    assert kernel._aligned(aligned) is aligned
    view = base[1:33]
    assert view.data_ptr() % 16 and view.is_contiguous()
    copy = kernel._aligned(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)


def test_cuda_forward_takes_a_misaligned_view():
    """q, k and v as views 2 bytes off 16-byte alignment: the bf16 forward
    (tensor cores, 16-byte loads) gives the bits it gives on aligned copies
    (skips here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, s, h, k, d, win, causal = ATTN_CASES[0]
    aligned = [_torch(a, "bfloat16").cuda()
               for a in _inputs(b, s, h, k, d)[:3]]
    views = []
    for t in aligned:
        base = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = base[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 and view.is_contiguous()
        views.append(view)
    mma0 = kernel.launches_fwd_mma
    got = kernel.flash_attention_fwd_cuda(*views, causal=causal, window=win)
    want = kernel.flash_attention_fwd_cuda(*aligned, causal=causal,
                                           window=win)
    assert kernel.launches_fwd_mma - mma0 == 2
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_forward_d256_matches_plain(dtype):
    """The CUDA forward at head dim 256 (bf16 on the tensor cores, float32
    on the CUDA cores with V staged over K's buffer) against the plain
    version on the card (skips here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, s, h, k, d, win, causal = D256
    q, kk, vv, _ = (_torch(a, dtype).cuda()
                    for a in _inputs(b, s, h, k, d, seed=2))
    o, lse = kernel.flash_attention_fwd_cuda(q, kk, vv, causal=causal,
                                             window=win)
    wo, wlse = ref.flash_attention_ref(q, kk, vv, causal=causal, window=win)
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), wo.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, wlse, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# The bound chip_smoke.py holds the CUDA kernels to
# ---------------------------------------------------------------------------

LONG = (1, 1024, 4, 2, 64)      # B, S, H, K, D: 16 KV tiles of 64, causal


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scores64(q, kk, weight):
    """Causal float64 scores (B, H, Sq, Sk) with log(weight) added per key."""
    g = q.shape[2] // kk.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(),
                     kk.double().repeat_interleave(g, 2))
    s = s / q.shape[-1] ** 0.5 + weight.log()
    n = s.shape[-1]
    return s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1),
                         float("-inf"))


def _kernel64(q, kk, vv, o, lse, do, weight):
    """What a kernel computes, in float64 and rounded to bf16, when it
    weighs each key's softmax term by ``weight``: all ones is a right
    kernel (another summation order, more precision), a tile of zeros one
    that drops that KV tile, a tile of twos one that adds it twice. The
    backward takes the forward's ``o`` and ``lse``, as the kernel does."""
    b, n, h, d = q.shape
    kh = kk.shape[2]
    g = h // kh
    s = _scores64(q, kk, weight)
    vr, kr = (x.double().repeat_interleave(g, 2) for x in (vv, kk))
    o64 = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vr)
    p = (s - lse.double()[..., None]).exp()
    do, o = do.double(), o.double()
    delta = (do * o).sum(-1).transpose(1, 2)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, vr) - delta[..., None])
    ds = ds / d ** 0.5
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.double())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dk, dv = (x.reshape(b, n, kh, g, d).sum(3) for x in (dk, dv))
    return [x.to(torch.bfloat16) for x in (o64, dq, dk, dv)]


@pytest.fixture(scope="module")
def long_case():
    """bf16 unit inputs at S 1024 with ``do`` at a mean loss's scale (1 /
    8192), their plain forward and backward, and chip_smoke's bounds."""
    b, s, h, k, d = LONG
    q, kk, vv, do = (_torch(a, "bfloat16") for a in _inputs(b, s, h, k, d))
    do = (do.float() / 8192).to(torch.bfloat16)
    o, lse = ref.flash_attention_ref(q, kk, vv, causal=True)
    want = [o, *ref.flash_attention_bwd_ref(q, kk, vv, o, lse, do,
                                            causal=True)]
    cs = _chip_smoke()
    tols = [(cs.TOL["bfloat16"],) * 2] + [cs.GRAD_TOL["bfloat16"]] * 3
    return (q, kk, vv, o, lse, do), want, tols, cs


def test_scaled_bound_passes_a_right_kernel(long_case):
    inputs, want, tols, cs = long_case
    got = _kernel64(*inputs, torch.ones(LONG[1], dtype=torch.float64))
    for g, w, (atol, rtol) in zip(got, want, tols):
        err, scale = cs.close_scaled(g, w, atol, rtol)
        assert scale < 1 and err <= atol * scale + rtol * w.float().abs().max()


@pytest.mark.parametrize("tile", [1, 8, 15])
@pytest.mark.parametrize("weight", [0.0, 2.0], ids=["dropped", "doubled"])
def test_scaled_bound_rejects_a_wrong_kv_tile(long_case, tile, weight):
    """A kernel that drops one KV tile, or adds it twice, fails the bound in
    o and in each gradient, early, middle or last tile alike."""
    inputs, want, tols, cs = long_case
    w64 = torch.ones(LONG[1], dtype=torch.float64)
    w64[tile * 64:(tile + 1) * 64] = weight
    got = _kernel64(*inputs, w64)
    for g, w, (atol, rtol) in zip(got, want, tols):
        with pytest.raises(AssertionError, match="max abs err"):
            cs.close_scaled(g, w, atol, rtol)


def test_scaled_bound_rejects_zero_gradients(long_case):
    _, want, tols, cs = long_case
    for w, (atol, rtol) in zip(want[1:], tols[1:]):
        with pytest.raises(AssertionError, match="max abs err"):
            cs.close_scaled(torch.zeros_like(w), w, atol, rtol)


def _split_bf16(x):
    """``x`` as the bf16 backward carries P and dS into its products: hi
    (x cut to its top 16 bits, a bf16 value) + lo (the rest, rounded to
    bf16)."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi + (x - hi).to(torch.bfloat16).float()


def _emulated_bwd(q, kk, vv, o, lse, do, split):
    """The bf16 backward's arithmetic, causal, one KV head (K = 1), one
    query head at a time: float32 products of the bf16 inputs, each
    gradient rounded to bf16 once. ``split``: the kernels', P and dS as
    hi + lo A operands, dS formed from P's hi + lo (as the dK/dV kernel
    forms it; the dQ kernel's float32 P differs from that by about 2^-17);
    else FlashAttention-2's, dS from float32 P, each rounded to bf16
    once."""
    b, s, h, d = q.shape
    qf, kf, vf, dof, of = (x.float()[0] for x in (q, kk, vv, do, o))
    kf, vf = kf[:, 0], vf[:, 0]
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    dq, dk, dv = torch.zeros(s, h, d), torch.zeros(s, d), torch.zeros(s, d)
    for j in range(h):
        sc = qf[:, j] @ kf.T / d ** 0.5
        p = torch.where(keep, torch.exp(sc - lse[0, j][:, None]), 0.0)
        delta = (dof[:, j] * of[:, j]).sum(-1)
        pa = _split_bf16(p) if split else p.to(torch.bfloat16).float()
        ds = (pa if split else p) * (dof[:, j] @ vf.T - delta[:, None])
        ds = ds / d ** 0.5
        ds = _split_bf16(ds) if split else ds.to(torch.bfloat16).float()
        dv += pa.T @ dof[:, j]
        dk += ds.T @ qf[:, j]
        dq[:, j] = ds @ kf
    return [x.reshape(shape).to(torch.bfloat16) for x, shape in
            ((dq, q.shape), (dk, kk.shape), (dv, vv.shape))]


def test_split_rounding_of_p_and_ds_keeps_the_card_bound():
    """Why the bf16 backward splits P and dS into bf16 hi + lo: at a long
    causal shape, one bf16 rounding of each (FlashAttention-2's A operands)
    takes most of chip_smoke's gradient bound (``close_scaled`` at
    ``GRAD_TOL["bfloat16"]``; at granite's S 4096 it fails it), since the
    first rows' large terms meet a scale set by the many small late rows;
    hi + lo leaves the gradients' own bf16 rounding. Prints the worst
    err / bound of each gradient under ``pytest -s``."""
    b, s, h, k, d = 1, 2048, 4, 1, 64
    q, kk, vv, do = (_torch(a, "bfloat16") for a in _inputs(b, s, h, k, d))
    o, lse = ref.flash_attention_ref(q, kk, vv, causal=True)
    want = ref.flash_attention_bwd_ref(q, kk, vv, o, lse, do, causal=True)
    atol, rtol = _chip_smoke().GRAD_TOL["bfloat16"]

    def worst(split):
        got = _emulated_bwd(q, kk, vv, o, lse, do, split)
        out = []
        for g, w in zip(got, want):
            g, w = g.float(), w.float()
            scale = min(1.0, w.square().mean().sqrt().item())
            out.append(((g - w).abs() / (atol * scale + rtol * w.abs()))
                       .max().item())
        return out

    one, split = worst(False), worst(True)
    print(f"worst err / bound of dq, dk, dv at S {s}: one bf16 rounding "
          f"{one}, hi + lo {split}")
    assert max(split) < 0.3, split
    assert max(one) > 0.6, one


def _emulated_fwd(q, kk, vv, split, kt=64, window=None):
    """The bf16 forward's arithmetic, causal, one KV head (K = 1), one query
    head at a time: float32 scores of the bf16 inputs in base 2 (scale *
    log2 e folded in), an online softmax over ``kt``-key steps (64 at D <=
    128, 32 at D 256) under the causal mask and ``window``, with the
    normaliser summed from float32 P, and P carried into P V as the kernel
    carries it (``split``: bf16 hi + lo; else one bf16 rounding,
    FlashAttention-2's); o rounded to bf16 once, lse in nats. Any D: the
    kernel's zero padding of D adds nothing."""
    b, s, h, d = q.shape
    qf, kf, vf = (x.float()[0] for x in (q, kk, vv))
    kf, vf = kf[:, 0], vf[:, 0]
    scale_l2 = math.log2(math.e) / d ** 0.5
    qpos = torch.arange(s)[:, None]
    o, lse = torch.zeros(s, h, d), torch.zeros(h, s)
    for j in range(h):
        m = torch.full((s,), -1e30)
        l, acc = torch.zeros(s), torch.zeros(s, d)
        for k0 in range(0, s, kt):
            kpos = torch.arange(k0, min(k0 + kt, s))[None]
            sc = (qf[:, j] @ kf[k0:k0 + kt].T) * scale_l2
            keep = qpos >= kpos
            if window is not None:
                keep &= qpos - kpos < window
            sc = torch.where(keep, sc, torch.tensor(-1e30))
            m_new = torch.maximum(m, sc.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(sc - m_new[:, None])
            l = l * corr + p.sum(-1)
            pa = _split_bf16(p) if split else p.to(torch.bfloat16).float()
            acc = acc * corr[:, None] + pa @ vf[k0:k0 + kt]
            m = m_new
        lc = l.clamp_min(1e-30)
        o[:, j] = acc / lc[:, None]
        lse[j] = m * math.log(2) + lc.log()
    return o[None].to(torch.bfloat16), lse[None]


def test_split_rounding_of_p_keeps_the_forward_and_its_backward_in_bound():
    """Why the bf16 forward carries P into P V as bf16 hi + lo: at a long
    causal shape one bf16 rounding of P (FlashAttention-2's) takes most of
    o's bound (``close_scaled`` at ``TOL["bfloat16"]``), and the backward
    fed by that o (its delta = rowsum(dO o)) misses dq's bound at
    ``GRAD_TOL["bfloat16"]``; hi + lo leaves o's own rounding. The
    emulated forward's o and lse feed the emulated hi + lo backward, and
    both are held to the plain versions on the plain forward's outputs.
    Prints the worst err / bound of o, dq, dk, dv under ``pytest -s``."""
    b, s, h, k, d = 1, 2048, 4, 1, 64
    q, kk, vv, do = (_torch(a, "bfloat16") for a in _inputs(b, s, h, k, d))
    o, lse = ref.flash_attention_ref(q, kk, vv, causal=True)
    want = [o, *ref.flash_attention_bwd_ref(q, kk, vv, o, lse, do,
                                            causal=True)]
    cs = _chip_smoke()
    tols = [(cs.TOL["bfloat16"],) * 2] + [cs.GRAD_TOL["bfloat16"]] * 3

    def worst(split):
        eo, lse_e = _emulated_fwd(q, kk, vv, split)
        np.testing.assert_allclose(lse_e.numpy(), lse.numpy(), atol=2e-5,
                                   rtol=2e-5)
        got = [eo, *_emulated_bwd(q, kk, vv, eo, lse_e, do, True)]
        out = []
        for g, w, (atol, rtol) in zip(got, want, tols):
            g, w = g.float(), w.float()
            scale = min(1.0, w.square().mean().sqrt().item())
            out.append(((g - w).abs() / (atol * scale + rtol * w.abs()))
                       .max().item())
        return out

    one, split = worst(False), worst(True)
    print(f"worst err / bound of o, dq, dk, dv at S {s}: one bf16 rounding "
          f"of P {one}, hi + lo {split}")
    assert max(split) < 0.3, split
    assert max(one) > 1, one


def test_emulated_d256_forward_keeps_the_card_bound():
    """The bf16 forward at D 256 as the tensor-core kernel computes it (a
    32-key step, P as hi + lo) at the hybrid family's geometry (MQA with
    G 10, a window) holds the plain version at chip_smoke's bounds: o by
    ``close_scaled`` at ``TOL["bfloat16"]``, lse within 2e-5 + 2e-5 |lse|.
    Prints the worst err / bound of o and lse under ``pytest -s``."""
    b, s, h, k, d, win = 1, 1024, 10, 1, 256, 512
    q, kk, vv, _ = (_torch(a, "bfloat16") for a in _inputs(b, s, h, k, d,
                                                            seed=5))
    o, lse = ref.flash_attention_ref(q, kk, vv, causal=True, window=win)
    eo, else_ = _emulated_fwd(q, kk, vv, True, kt=32, window=win)
    cs = _chip_smoke()
    tol = cs.TOL["bfloat16"]
    _, scale = cs.close_scaled(eo, o, tol, tol)
    cs.close(else_, lse, cs.TOL["float32"])
    w = o.float()
    worst_o = ((eo.float() - w).abs() / (tol * scale + tol * w.abs())).max()
    t32 = cs.TOL["float32"]
    worst_lse = ((else_ - lse).abs() / (t32 + t32 * lse.abs())).max()
    print(f"emulated D 256 forward (32-key steps, hi + lo P) at B {b}, S {s}, "
          f"H {h}, K {k}, window {win}: worst err / bound o "
          f"{worst_o.item():.3f}, lse {worst_lse.item():.3f}")


def _emulated_bwd_d256(q, kk, vv, o, lse, do, window, qt=64, kt=16):
    """The bf16 backward at D 256 as its kernels compute it, causal with
    ``window``, any B, H and K: for each query head, float32 shares of dK
    and dV added up over steps of ``qt`` query rows (the dK/dV kernel's
    step), P^T and dS^T carried as bf16 hi + lo with dS formed from P's hi
    + lo; dQ over steps of ``kt`` keys (the dQ kernel's), dS from float32
    P, carried as hi + lo. Then each KV head's dK and dV: its G query
    heads' shares summed in head order in float32 and rounded to bf16 once
    (the sum kernel's order), as dQ is rounded once."""
    b, s, h, d = q.shape
    kh = kk.shape[2]
    g = h // kh
    qf, kf, vf, dof, of = (x.float() for x in (q, kk, vv, do, o))
    qpos, kpos = torch.arange(s)[:, None], torch.arange(s)[None]
    keep = (qpos >= kpos) & (qpos - kpos < window)
    dq = torch.zeros(b, s, h, d)
    dk, dv = torch.zeros(b, s, kh, d), torch.zeros(b, s, kh, d)
    for i in range(b):
        for j in range(h):
            kj, vj = kf[i, :, j // g], vf[i, :, j // g]
            qj, doj = qf[i, :, j], dof[i, :, j]
            p = torch.where(keep, torch.exp(qj @ kj.T / d ** 0.5
                                            - lse[i, j][:, None]), 0.0)
            delta = (doj * of[i, :, j]).sum(-1)[:, None]
            dp = doj @ vj.T
            pa = _split_bf16(p)
            dsa = _split_bf16(pa * (dp - delta) / d ** 0.5)
            share_k, share_v = torch.zeros(s, d), torch.zeros(s, d)
            for r in range(0, s, qt):
                share_v += pa[r:r + qt].T @ doj[r:r + qt]
                share_k += dsa[r:r + qt].T @ qj[r:r + qt]
            dk[i, :, j // g] += share_k         # head order: j ascending
            dv[i, :, j // g] += share_v
            dsq = _split_bf16(p * (dp - delta) / d ** 0.5)
            for c in range(0, s, kt):
                dq[i, :, j] += dsq[:, c:c + kt] @ kj[c:c + kt]
    return [x.to(torch.bfloat16) for x in (dq, dk, dv)]


@pytest.mark.parametrize("b,s,h,k,d,win", D256_GRAD)
def test_emulated_d256_backward_matches_jax_vjp(b, s, h, k, d, win):
    """The D 256 backward's arithmetic (:func:`_emulated_bwd_d256`: per-head
    float32 shares, hi + lo P and dS, the head-order sum, one bf16
    rounding) on bf16 inputs against ``jax.vjp`` of the reference's
    ``attention_banded`` on the same values in float32, each gradient at
    chip_smoke's bf16 bound (``close_scaled`` at ``GRAD_TOL["bfloat16"]``),
    at G 4 and G 10. o and lse come from the plain forward in float32, as
    the reference's VJP forms them: o rounded to bf16 moves delta =
    rowsum(dO o) by the forward's rounding, and on it the float32 plain
    backward misses this bound too (dq by 1.2x at G 4)."""
    q, kk, vv, do = (_torch(a, "bfloat16") for a in _inputs(b, s, h, k, d,
                                                            seed=5))
    o, lse = ref.flash_attention_ref(q.float(), kk.float(), vv.float(),
                                     causal=True, window=win)
    got = _emulated_bwd_d256(q, kk, vv, o, lse, do, win)
    rep = lambda t: jnp.repeat(t, h // k, axis=2)
    _, vjp = jax.vjp(lambda q_, k_, v_: JL.attention_banded(
        q_, rep(k_), rep(v_), window=win, q_block=16),
        *(jnp.asarray(x.float().numpy()) for x in (q, kk, vv)))
    want = vjp(jnp.asarray(do.float().numpy()))
    cs = _chip_smoke()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = torch.from_numpy(np.array(w))
        assert g.shape == w.shape, (name, g.shape, w.shape)
        cs.close_scaled(g, w, *cs.GRAD_TOL["bfloat16"])


def test_emulated_d256_backward_keeps_the_card_bound():
    """The same arithmetic at a longer MQA shape (recurrentgemma's geometry:
    H 10, K 1, a window) against the float64 plain backward on the same
    bf16 inputs and forward outputs, as chip_smoke holds the card's every
    call of a training microbatch: each gradient within ``close_scaled``
    at ``GRAD_TOL["bfloat16"]``. Prints the worst err / bound of dq, dk, dv
    under ``pytest -s``."""
    b, s, h, k, d, win = 1, 1024, 10, 1, 256, 512
    q, kk, vv, do = (_torch(a, "bfloat16") for a in _inputs(b, s, h, k, d,
                                                            seed=5))
    o, lse = ref.flash_attention_ref(q, kk, vv, causal=True, window=win)
    got = _emulated_bwd_d256(q, kk, vv, o, lse, do, win)
    want = ref.flash_attention_bwd_ref(
        *(t.double() for t in (q, kk, vv, o, lse, do)), causal=True,
        window=win)
    cs = _chip_smoke()
    atol, rtol = cs.GRAD_TOL["bfloat16"]
    worst = []
    for g, w in zip(got, want):
        _, scale = cs.close_scaled(g, w, atol, rtol)
        g, w = g.double(), w.double()
        worst.append(((g - w).abs() / (atol * scale + rtol * w.abs()))
                     .max().item())
    print(f"emulated D 256 backward (per-head float32 shares over 64-row "
          f"query steps, hi + lo P and dS, head-order sum) at B {b}, S {s}, "
          f"H {h}, K {k}, window {win}: worst err / bound of dq, dk, dv "
          f"{[round(x, 4) for x in worst]}")
    assert max(worst) < 0.5, worst
