"""The port's SSD scan against ``repro.kernels.ssd`` and
``repro.models.mamba2``.

The plain chunked version (``repro_torch.kernels.ssd.ref.ssd_chunked``),
reached through the dispatching ``ops.ssd`` on CPU tensors, is held to the
JAX sequential oracle ``ssd_ref``, to ``ssd_chunked`` and to the Pallas
kernel in interpret mode (``repro.kernels.ssd.ops.ssd``, as the JAX tests
run it) on the reference's cases (``tests/test_kernels.py:68-89``), with
the reference's inputs and tolerances: float32 1e-4, bfloat16 x 5e-2. The
port's own oracle ``ssd_ref`` is held to JAX's the same way. Also: a
ragged S (which the Pallas wrapper does not take, so against
``ssd_chunked`` only), ``segsum`` with its ``-inf``, B and C broadcast over
the heads with stride 0, the oracle in float64, and the dispatch's
refusals. The backward (``ops.ssd``'s autograd function on the plain
``ref.ssd_bwd``) is held to ``jax.vjp`` of ``ssd_chunked``, the function
the reference trains through, at S a multiple of the chunk and not, with
B and C shared by the heads as the model passes them (both sides
broadcast one head's B and C, so their gradients sum over the heads), in
float32 at 2e-5; a ``compute_dtype`` other than float32 is refused. The CUDA kernels are held to the plain versions on the
card by the tests that skip here, ``tests/test_torch_ssd_cuda.py`` and
``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.ssd import ops as jops
from repro.models import mamba2 as jm

torch = kernel = ops = ref = None  # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, kernel, ops, ref
    torch = pytest.importorskip("torch")
    from repro_torch.kernels.ssd import kernel, ops, ref
    torch.set_num_threads(1)


# b, s, h, p, n, chunk (tests/test_kernels.py:68-72)
CASES = [(2, 64, 4, 16, 16, 16), (1, 128, 2, 32, 8, 32), (2, 32, 8, 8, 64, 8)]
RAGGED = [(2, 37, 3, 16, 16, 16), (1, 100, 2, 32, 8, 32), (1, 5, 2, 8, 4, 8)]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}           # tests/test_kernels.py:83


def _inputs(b, s, h, p, n, seed=7):
    """The reference test's draws: x ~ N(0, 0.5^2), dA = -|N(0, 0.1^2)|,
    B and C ~ N(0, 0.3^2), float32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)) * 0.5
    dA = -np.abs(rng.normal(size=(b, s, h)) * 0.1)
    B = rng.normal(size=(b, s, h, n)) * 0.3
    C = rng.normal(size=(b, s, h, n)) * 0.3
    return tuple(a.astype(np.float32) for a in (x, dA, B, C))


def _torch(arrays, x_dtype="float32"):
    x, dA, B, C = (torch.from_numpy(a) for a in arrays)
    return x.to(getattr(torch, x_dtype)), dA, B, C


def _jax(impl, arrays, chunk, x_dtype="float32"):
    x, dA, B, C = (jnp.asarray(a) for a in arrays)
    x = x.astype(getattr(jnp, x_dtype))
    if impl == "ref":
        return jax.jit(jm.ssd_ref)(x, dA, B, C)
    if impl == "chunked":
        return jax.jit(lambda *a: jm.ssd_chunked(*a, chunk=chunk))(x, dA, B, C)
    return jops.ssd(x, dA, B, C, chunk=chunk)     # Pallas, interpret mode


def _close(got, want, tol):
    y, st = got
    wy, wst = want
    assert y.shape == wy.shape and st.shape == wst.shape
    assert str(y.dtype).split(".")[1] == str(wy.dtype)
    assert st.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(wy, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(wst), atol=tol, rtol=tol)


@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_plain_matches_jax(b, s, h, p, n, chunk, dtype, impl):
    arrays = _inputs(b, s, h, p, n)
    got = ops.ssd(*_torch(arrays, dtype), chunk=chunk)
    _close(got, _jax(impl, arrays, chunk, dtype), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_oracle_matches_jax_oracle(b, s, h, p, n, chunk, dtype):
    arrays = _inputs(b, s, h, p, n, seed=3)
    got = ref.ssd_ref(*_torch(arrays, dtype))
    _close(got, _jax("ref", arrays, chunk, dtype), TOL[dtype])


@pytest.mark.parametrize("b,s,h,p,n,chunk", RAGGED)
def test_ragged_s_matches_jax_chunked(b, s, h, p, n, chunk):
    """S not a multiple of the chunk: ``ssd_hm`` asserts ``S % chunk ==
    0``, so only ``ssd_chunked`` (which pads with identity steps) and the
    oracle take it."""
    arrays = _inputs(b, s, h, p, n, seed=5)
    got = ops.ssd(*_torch(arrays), chunk=chunk)
    _close(got, _jax("chunked", arrays, chunk), TOL["float32"])
    _close(got, _jax("ref", arrays, chunk), TOL["float32"])


def test_segsum_matches_jax():
    x = np.random.default_rng(1).normal(size=(2, 3, 9)).astype(np.float32)
    want = np.asarray(jm.segsum(jnp.asarray(x)))
    got = ref.segsum(torch.from_numpy(x)).numpy()
    assert np.isneginf(got[np.isneginf(want)]).all()
    assert np.isneginf(got).sum() == np.isneginf(want).sum() == 2 * 3 * 36
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], atol=1e-6)


def test_head_broadcast_b_and_c():
    """B and C of one head expanded over the heads (stride 0, as the model
    passes them) give what the same values copied per head give."""
    x, dA, B, C = _torch(_inputs(2, 40, 4, 16, 16))
    Bh = B[:, :, :1].expand(-1, -1, 4, -1)
    Ch = C[:, :, :1].expand(-1, -1, 4, -1)
    assert Bh.stride(2) == 0
    got = ops.ssd(x, dA, Bh, Ch, chunk=16)
    want = ops.ssd(x, dA, Bh.contiguous(), Ch.contiguous(), chunk=16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _close(got, _jax("ref", [a.numpy() for a in (x, dA, Bh.contiguous(),
                                                  Ch.contiguous())], 16),
           TOL["float32"])


def test_oracle_in_float64():
    """Given float64 inputs the oracle and the chunked version compute in
    float64 (the card's checks use them as yardsticks): equal to a float64
    numpy loop, and the float32 chunked version within float32 rounding of
    it."""
    x, dA, B, C = (a.astype(np.float64) for a in _inputs(1, 48, 2, 8, 4))
    state = np.zeros((1, 2, 8, 4))
    want = np.empty_like(x)
    for t in range(x.shape[1]):
        state = (state * np.exp(dA[:, t])[..., None, None]
                 + x[:, t, :, :, None] * B[:, t, :, None, :])
        want[:, t] = (state * C[:, t, :, None, :]).sum(-1)
    y, st = ref.ssd_ref(*(torch.from_numpy(a) for a in (x, dA, B, C)))
    assert y.dtype == st.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(st.numpy(), state, rtol=1e-12, atol=1e-14)
    y, st = ops.ssd(*(torch.from_numpy(a) for a in (x, dA, B, C)), chunk=16)
    assert y.dtype == st.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(st.numpy(), state, rtol=1e-12, atol=1e-14)
    y32, _ = ops.ssd(*(torch.from_numpy(a).float() for a in (x, dA, B, C)),
                     chunk=16)
    np.testing.assert_allclose(y32.double().numpy(), want, atol=1e-5)


def test_dispatch_refusals():
    x, dA, B, C = _torch(_inputs(1, 8, 2, 4, 4))
    with pytest.raises(NotImplementedError, match="init_state"):
        ops.ssd(x, dA, B, C, chunk=4, init_state=torch.zeros((1, 2, 4, 4)))
    meta = [t.to("meta") for t in (x, dA, B, C)]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ops.ssd(*meta, chunk=4)
    before = kernel.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernel.ssd_cuda(x, dA, B, C, chunk=4)
    with pytest.raises(ValueError, match="p <= 64, n <= 128"):
        kernel.ssd_cuda(x, dA, torch.zeros((1, 8, 2, 129)),
                        torch.zeros((1, 8, 2, 129)), chunk=4)
    assert kernel.launches == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the card's machine has nvcc")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(kernel, "_BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.build()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES + RAGGED)
def test_cuda_kernel_matches_plain(b, s, h, p, n, chunk, dtype):
    """The CUDA kernel against the plain version on the card (skips here),
    at the reference's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, dA, B, C = (t.cuda() for t in _torch(_inputs(b, s, h, p, n), dtype))
    before = kernel.launches
    y, st = ops.ssd(x, dA, B, C, chunk=chunk)
    assert kernel.launches == before + 1
    wy, wst = ref.ssd_chunked(x, dA, B, C, chunk=chunk)
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st, wst, atol=tol, rtol=tol)


def test_cuda_kernel_takes_bf16_head_broadcast_b_and_c():
    """The model's inputs: float32 x, bfloat16 B and C expanded over the
    heads with stride 0 (skips here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, dA, B, C = (t.cuda() for t in _torch(_inputs(2, 300, 4, 64, 128)))
    Bh, Ch = (t[:, :, :1].to(torch.bfloat16).expand(-1, -1, 4, -1)
              for t in (B, C))
    y, st = ops.ssd(x, dA, Bh, Ch, chunk=256)
    wy, wst = ref.ssd_chunked(x, dA, Bh, Ch, chunk=256)
    torch.testing.assert_close(y, wy, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, wst, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The CUDA kernels' routes, and the tensor-core route's arithmetic emulated
# on the CPU
# ---------------------------------------------------------------------------

M2_SCALE = (1, 1024, 4, 64, 128, 256)   # b, s, h, p, n, chunk at the model's decay


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bc_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk,bc_heads", [
    (8, 4096, 32, 64, 128, 256, 1),     # mamba2-370m's prefill
    (2, 37, 3, 16, 16, 16, 3),          # a ragged last chunk, B and C per head
    (1, 1, 2, 8, 4, 8, 1),              # S 1
    (1, 100, 2, 33, 5, 1024, 2),        # chunk past S, Q not a multiple of 64
])
def test_plan_routes_by_dtype_and_shape(b, s, h, p, n, chunk, bc_heads,
                                        bc_dtype, x_dtype):
    """bf16 B and C take the tensor cores whatever x is, float32 B and C
    the CUDA cores; chunks of min(chunk, s); the tc route's workspace holds
    the chunk states, the cumsums and the scores of the distinct B/C
    heads."""
    pl = kernel.plan(b, s, h, p, n, chunk, getattr(torch, x_dtype),
                     getattr(torch, bc_dtype), bc_heads)
    q = min(chunk, s)
    nc = -(-s // q)
    assert (pl.chunk, pl.n_chunks, pl.bc_heads) == (q, nc, bc_heads)
    if bc_dtype == "float32":
        assert (pl.route, pl.workspace_bytes) == ("fma", 0)
        return
    q_pad = -(-q // 64) * 64
    assert pl.route == "tc"
    assert pl.workspace_bytes == (b * h * nc * (p * n * 4 + q * 8)
                                  + b * bc_heads * nc * q_pad * q_pad * 4)
    assert set(kernel.ROUTES) == {"fma", "tc"}


def test_plan_prefill_workspace_and_refusals():
    """At mamba2-370m's prefill shape the workspace is 134,217,728 B of
    chunk states, 8,388,608 B of cumsums and 33,554,432 B of scores; B/C
    heads other than 1 or h are refused."""
    pl = kernel.plan(8, 4096, 32, 64, 128, 256, torch.float32, torch.bfloat16,
                     1)
    assert pl.workspace_bytes == 134_217_728 + 8_388_608 + 33_554_432
    assert kernel.plan(8, 4096, 32, 64, 128, 256, torch.float32,
                       torch.bfloat16).bc_heads == 32
    with pytest.raises(ValueError, match="neither 1 nor h"):
        kernel.plan(1, 8, 4, 8, 4, 8, torch.float32, torch.bfloat16, 2)


@pytest.mark.parametrize("make,width", [
    (lambda: torch.zeros(2, 8, 3, 64), 16),                        # float32 rows of 256 B
    (lambda: torch.zeros(2, 8, 3, 33), 4),                         # float32 rows of 132 B
    (lambda: torch.zeros(2, 8, 1, 128, dtype=torch.bfloat16).expand(2, 8, 4, 128), 16),
    (lambda: torch.zeros(2, 8, 1, 4, dtype=torch.bfloat16).expand(2, 8, 4, 4), 8),
    (lambda: torch.zeros(2, 8, 3, 5, dtype=torch.bfloat16), 2),    # odd bf16 rows
    (lambda: torch.zeros(2, 8, 3, 65)[..., 1:], 4),                # a base 4 B past 16
])
def test_copy_width_divides_base_strides_and_rows(make, width):
    """The tc route's copies: the widest of 16, 8, 4 or 2 bytes dividing
    the base address, the (b, s, h) strides and a row's bytes."""
    t = make()
    assert kernel._copy_width(t) == width
    elt = t.element_size()
    for v in (t.data_ptr(), *(st * elt for st in t.stride()[:3]),
              t.shape[3] * elt):
        assert v % width == 0


def _tf32(v):
    """float32 -> TF32 (10 mantissa bits), to nearest with ties away from
    zero, by the kernel's integer rounding: add half a TF32 ulp to the
    bits, clear the 13 low bits."""
    i = v.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _split(v, split):
    """``(hi, lo)``: the kernel's split of a float32 operand into two TF32
    values; with ``split`` False, one TF32 rounding and no lo."""
    hi = _tf32(v)
    return hi, (_tf32(v - hi) if split else torch.zeros_like(v))


def _emulate_tc(x, dA, B, C, chunk, split=True):
    """The tensor-core route's arithmetic on the CPU in float32, in its
    order: chunk states, states passed in order, chunk outputs. The cumsum
    of dA is float64 within a chunk; TF32 operands are rounded by bit mask;
    bf16 B and C (and bf16 x) are exact in TF32; every float32 operand is
    split in hi + lo and its product taken as lo.hi + hi.lo + hi.hi (two
    products against a bf16 operand), or, with ``split`` False, as one TF32
    product. Returns ``(y in x's dtype, final state float32)``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    f32 = torch.float32
    xf, Bf, Cf = (torch.nn.functional.pad(t.to(f32), (0, 0, 0, 0, 0, pad))
                  for t in (x, B, C))
    dAf = torch.nn.functional.pad(dA.to(f32), (0, 0, 0, pad))
    xq = xf.reshape(b, nc, q, h, p)
    Bq, Cq = (t.reshape(b, nc, q, h, n) for t in (Bf, Cf))
    a = torch.cumsum(dAf.reshape(b, nc, q, h).double(), dim=2)    # float64
    a_last = a[:, :, -1:]
    ein = torch.einsum
    # (a) each chunk's own state, (x w_end)^T B: two products against bf16 B
    xw = xq * torch.exp((a_last - a).to(f32))[..., None]
    hi, lo = _split(xw, split)
    own = ein("bcjhp,bcjhn->bchpn", lo, Bq) + ein("bcjhp,bcjhn->bchpn", hi, Bq)
    # (b) the states entering each chunk, in chunk order
    decay_c = torch.exp(a_last[:, :, 0].to(f32))                  # (b, nc, h)
    s_in, st = [], torch.zeros((b, h, p, n), dtype=f32)
    for c in range(nc):
        s_in.append(st)
        st = st * decay_c[:, c, :, None, None] + own[:, c]
    s_in = torch.stack(s_in, dim=1)                               # (b, nc, h, p, n)
    # (c) the outputs: exp(a_i) C_i . S_in (two products against bf16 C),
    # then the scores C.B^T (bf16 products, exact, summed in float32)
    # decayed by 2^(log2(e) (a_i - a_j)) where j <= i, times x (three
    # products; two with bf16 x)
    a2 = a * (1 / np.log(2.0))
    sh, sl = _split(s_in, split)
    inter = ein("bcihn,bchpn->bcihp", Cq, sl) + ein("bcihn,bchpn->bcihp", Cq, sh)
    inter = inter * torch.exp2(a2.to(f32))[..., None]
    g = ein("bcihn,bcjhn->bchij", Cq, Bq)
    diff = (a2[:, :, :, None, :] - a2[:, :, None, :, :]).permute(0, 1, 4, 2, 3)
    lower = torch.ones((q, q), dtype=torch.bool).tril()
    sc = torch.where(lower, g * torch.exp2(diff.to(f32).clamp(max=0)), 0.0)
    s_hi, s_lo = _split(sc, split)
    x_hi, x_lo = ((xq, torch.zeros_like(xq)) if x.dtype == torch.bfloat16
                  else _split(xq, split))
    intra = (ein("bchij,bcjhp->bcihp", s_lo, x_hi)
             + ein("bchij,bcjhp->bcihp", s_hi, x_lo)
             + ein("bchij,bcjhp->bcihp", s_hi, x_hi))
    y = (inter + intra).reshape(b, nc * q, h, p)[:, :s]
    return y.to(x.dtype), st


def _bf16_values(a):
    """float32 numpy values rounded to bf16 (the model's B and C)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_emulated_tc_route_matches_jax(b, s, h, p, n, chunk, dtype, impl):
    """The tensor-core route's arithmetic (bf16 B and C, TF32 splits, the
    chunk-parallel order) against JAX's ``ssd_chunked`` and the Pallas
    kernel in interpret mode, on the reference's cases with B and C rounded
    to bf16, at the reference's tolerances."""
    x, dA, B, C = _inputs(b, s, h, p, n)
    arrays = (x, dA, _bf16_values(B), _bf16_values(C))
    tx, tdA, tB, tC = _torch(arrays, dtype)
    got = _emulate_tc(tx, tdA, tB.to(torch.bfloat16), tC.to(torch.bfloat16),
                      chunk)
    _close(got, _jax(impl, arrays, chunk, dtype), TOL[dtype])


def _scaled_ratio(got, want, tol):
    """The largest error over chip_smoke's ``close_scaled`` allowance,
    tol * min(1, rms|want|) + tol * |want|: under 1 passes."""
    scale = min(1.0, want.square().mean().sqrt().item())
    return ((got.double() - want).abs() / (tol * scale + tol * want.abs())).max().item()


def test_emulated_tc_route_at_model_decay_against_float64():
    """At the model's scale (dA = -softplus(N(0, 1)), bf16 B and C shared
    by the heads, s 1024, p 64, n 128, chunk 256) the route's arithmetic
    is within the card's float64 check (1e-4 under ``close_scaled``) with a
    wide margin, and one TF32 product for each float32 operand misses it:
    why every float32 operand is split."""
    b, s, h, p, n, chunk = M2_SCALE
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(b, s, h, p)) * 0.5).float()
    dA = -torch.nn.functional.softplus(torch.from_numpy(
        rng.normal(size=(b, s, h))).float())
    B, C = (torch.from_numpy(rng.normal(size=(b, s, 1, n)) * 0.3).float()
            .to(torch.bfloat16).expand(b, s, h, n) for _ in range(2))
    wy, wst = ref.ssd_chunked(x.double(), dA, B, C, chunk=chunk)
    ratios = {}
    for split in (True, False):
        y, st = _emulate_tc(x, dA, B, C, chunk, split=split)
        ratios[split] = max(_scaled_ratio(y, wy, 1e-4),
                            _scaled_ratio(st, wst, 1e-4))
    print(f"error over the float64 check's allowance: split TF32 "
          f"{ratios[True]:.4f}, one TF32 product {ratios[False]:.2f}")
    assert ratios[True] < 0.1, ratios
    assert ratios[False] > 1.0, ratios


@pytest.mark.parametrize("shared", [False, True], ids=["per_head", "shared"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 64, 4, 16, 16, 16),
                                             (2, 37, 3, 16, 8, 16),
                                             (1, 70, 2, 8, 4, 32)])
def test_backward_matches_jax_vjp_of_ssd_chunked(b, s, h, p, n, chunk,
                                                 shared):
    """Gradients of x, dA, B and C for cotangents of y and the final state,
    against ``jax.vjp`` of ``ssd_chunked`` on the same inputs (S 37 and 70
    leave a ragged last chunk); with ``shared`` B and C are one head's,
    broadcast over the heads on both sides, and their gradients are the
    sums over the heads. float32, 2e-5."""
    x, dA, B, C = _inputs(b, s, h, p, n, seed=19)
    if shared:
        B, C = B[:, :, 0], C[:, :, 0]
    rng = np.random.default_rng(23)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dst = rng.normal(size=(b, h, p, n)).astype(np.float32)

    def bcast(t, xp):
        return xp.broadcast_to(t[:, :, None], (b, s, h, n)) if shared else t

    def jfn(x, dA, B, C):
        return jm.ssd_chunked(x, dA, bcast(B, jnp), bcast(C, jnp),
                              chunk=chunk)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, dA, B, C)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dst)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, dA, B, C)]
    tx, tdA, tB, tC = leaves
    if shared:
        tB, tC = (t[:, :, None].expand(b, s, h, n) for t in (tB, tC))
    y, st = ops.ssd(tx, tdA, tB, tC, chunk=chunk)
    got = torch.autograd.grad((y, st), leaves, (torch.from_numpy(dy),
                                                torch.from_numpy(dst)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)


def test_plain_backward_in_float64_matches_the_oracle():
    """``ref.ssd_bwd`` in float64 against autograd of the sequential oracle
    in float64, and its dB and dC per head for expanded B and C."""
    x, dA, B, C = (torch.from_numpy(a).double()
                   for a in _inputs(2, 45, 3, 8, 6, seed=29))
    Bh = B[:, :, :1].expand(-1, -1, 3, -1)
    rng = np.random.default_rng(31)
    dy = torch.from_numpy(rng.normal(size=tuple(x.shape)))
    dst = torch.from_numpy(rng.normal(size=(2, 3, 8, 6)))
    got = ref.ssd_bwd(x, dA, Bh, C, dy, dst, chunk=16)
    assert all(g.dtype == torch.float64 for g in got)
    assert got[2].shape == (2, 45, 3, 6)
    leaves = [t.clone().requires_grad_() for t in (x, dA, Bh.contiguous(), C)]
    y, st = ref.ssd_ref(*leaves)
    want = torch.autograd.grad((y, st), leaves, (dy, dst))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-10,
                                   rtol=1e-10)


def test_compute_dtype_other_than_float32_is_refused():
    """``compute_dtype`` float32 is the only one the scan takes (the
    reference's default, which every config uses); bfloat16, which the
    reference's training forward could pass (``mamba2.py:253-254``), and
    anything else raise on the CPU as on the card."""
    x, dA, B, C = _torch(_inputs(1, 16, 2, 8, 4, seed=37))
    y, _ = ops.ssd(x, dA, B, C, chunk=8, compute_dtype=torch.float32)
    assert y.shape == x.shape
    for dtype in (torch.bfloat16, torch.float16):
        with pytest.raises(ValueError, match="float32 only"):
            ops.ssd(x, dA, B, C, chunk=8, compute_dtype=dtype)


def test_backward_wrapper_refuses_cpu_tensors():
    x, dA, B, C = _torch(_inputs(1, 16, 2, 8, 4))
    before = kernel.launches_bwd
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernel.ssd_bwd_cuda(x, dA, B, C, x, torch.zeros(1, 2, 8, 4))
    assert kernel.launches_bwd == before


# the float32 operands of the backward's tensor-core route, each split in
# hi + lo TF32 halves: x, dy, the state kernel's x e and dy f, the chunk
# states' gradients G and the entering states H_in, the decayed scores M
# and the decayed dy.x products LX
BWD_OPERANDS = ("x", "dy", "xe_dyf", "G", "H_in", "M", "LX")


def _tc_products(eq, u, v, split_u, split_v):
    """``einsum(eq, u, v)`` as the route takes it on TF32 ``mma.sync``: an
    operand with ``split_*`` None is exact in TF32 (bf16), True is split in
    hi + lo (the lo products first, then hi.hi; lo.lo is dropped), False
    takes one TF32 rounding."""
    ein = torch.einsum
    uh, ul = (u, None) if split_u is None else _split(u, split_u)
    vh, vl = (v, None) if split_v is None else _split(v, split_v)
    lo = None
    if ul is not None:
        lo = ein(eq, ul, vh)
    if vl is not None:
        lo = ein(eq, uh, vl) if lo is None else lo + ein(eq, uh, vl)
    hi = ein(eq, uh, vh)
    return hi if lo is None else lo + hi


def _emulate_tc_bwd(x, dA, B, C, dy, dstate, unsplit=()):
    """The backward's tensor-core route (bf16 B and C) on the CPU in
    float32, in its order: chunks of ``kernel.BWD_CHUNK``, the cumsum of dA
    float64 within a chunk; the state kernel's chunk states U = (x e)^T B
    and gradients D = (dy f)^T C (e = exp(a_end - a), f = exp(a); two
    products against bf16), passed forward (H_in) and backward (G) along
    the row; then each chunk's dx, dB (rows s) and dC (rows l): the
    inter-chunk terms B G^T, x G and dy H_in first (F and w from their
    accumulators), C B^T exact in float32, x.dy (three products), the
    decay 2^(log2(e) (a_l - a_s)) where s <= l, and the decayed M and LX
    times dy, C and B; d(dA) from the row and column sums of T = M (x.dy),
    reverse-summed. Every float32 operand is split in hi + lo, but those
    named in ``unsplit`` (of :data:`BWD_OPERANDS`), which take one TF32
    product. Returns ``(dx in x's dtype, ddA, dB, dC)``, dB and dC per
    head."""
    f32, F = torch.float32, torch.nn.functional
    sp = {name: name not in unsplit for name in BWD_OPERANDS}
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = kernel.BWD_CHUNK
    nc = -(-s // q)
    pad = nc * q - s

    def chunks(t):               # (b, s, h, k) -> (b, h, nc, q, k) float32
        t = F.pad(t.to(f32), (0, 0, 0, 0, 0, pad))
        return t.reshape(b, nc, q, h, -1).permute(0, 3, 1, 2, 4)

    xq, yq, Bq, Cq = (chunks(t) for t in (x, dy, B, C))
    dAq = F.pad(dA.to(f32), (0, 0, 0, pad)).reshape(b, nc, q, h)
    a = torch.cumsum(dAq.permute(0, 3, 1, 2).double(), dim=-1)  # (b, h, nc, q)
    a_last = a[..., -1:]
    valid = (torch.arange(nc * q) < s).reshape(nc, q)
    ev = torch.where(valid, torch.exp((a_last - a).to(f32)), 0.0)
    fv = torch.where(valid, torch.exp(a.to(f32)), 0.0)
    ein = torch.einsum
    # the state kernel and the pass along the row
    U = _tc_products("bhcjp,bhcjn->bhcpn", xq * ev[..., None], Bq,
                     sp["xe_dyf"], None)
    D = _tc_products("bhcjp,bhcjn->bhcpn", yq * fv[..., None], Cq,
                     sp["xe_dyf"], None)
    dec = torch.exp(a_last[..., 0].to(f32))                  # (b, h, nc)
    h_in, carry = [], torch.zeros((b, h, p, n), dtype=f32)
    for c in range(nc):
        h_in.append(carry)
        carry = carry * dec[:, :, c, None, None] + U[:, :, c]
    grads, g = [], dstate.to(f32)
    for c in range(nc - 1, -1, -1):
        grads.append(g)
        g = g * dec[:, :, c, None, None] + D[:, :, c]
    H = torch.stack(h_in, dim=2)                             # (b, h, nc, p, n)
    G = torch.stack(grads[::-1], dim=2)
    # the grad kernel: rows s (dx, dB) ...
    dxG = _tc_products("bhcsn,bhcpn->bhcsp", Bq, G, None, sp["G"])
    dBG = _tc_products("bhcsp,bhcpn->bhcsn", xq, G, sp["x"], sp["G"])
    Fs = ev * (xq * dxG).sum(-1)
    xd = _tc_products("bhclp,bhcsp->bhcls", yq, xq, sp["dy"], sp["x"])
    cb = ein("bhcln,bhcsn->bhcls", Cq, Bq)
    a2 = a * (1 / np.log(2.0))
    diff = (a2[..., :, None] - a2[..., None, :]).to(f32)     # [l, s]
    lower = torch.ones((q, q), dtype=torch.bool).tril()
    L = torch.where(lower, torch.exp2(diff.clamp(max=0)), 0.0)
    M, LX = cb * L, xd * L
    T = M * xd
    dx = ev[..., None] * dxG + _tc_products("bhcls,bhclp->bhcsp", M, yq,
                                            sp["M"], sp["dy"])
    dB = ev[..., None] * dBG + _tc_products("bhcls,bhcln->bhcsn", LX, Cq,
                                            sp["LX"], None)
    # ... and rows l (dC)
    dCH = _tc_products("bhclp,bhcpn->bhcln", yq, H, sp["dy"], sp["H_in"])
    w = (dCH * Cq).sum(-1)
    dC = fv[..., None] * dCH + _tc_products("bhcls,bhcsn->bhcln", LX, Bq,
                                            sp["LX"], None)
    da = T.sum(-1) - T.sum(-2) + fv * w - Fs
    da[..., -1] += dec * (G * H).sum((-1, -2)) + Fs.sum(-1)
    ddA = da.flip(-1).cumsum(-1).flip(-1)

    def rows(t):                 # (b, h, nc, q, k) -> (b, s, h, k)
        return t.permute(0, 2, 3, 1, 4).reshape(b, nc * q, h, -1)[:, :s]

    return (rows(dx).to(x.dtype), rows(ddA[..., None])[..., 0], rows(dB),
            rows(dC))


@pytest.mark.parametrize("shared", [False, True], ids=["per_head", "shared"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 64, 4, 16, 16, 16),
                                             (2, 37, 3, 16, 8, 16),
                                             (1, 70, 2, 8, 4, 32),
                                             (1, 130, 2, 16, 8, 64)])
def test_emulated_tc_backward_matches_jax_vjp(b, s, h, p, n, chunk, shared):
    """The backward's tensor-core arithmetic (bf16 B and C, chunks of 64,
    TF32 splits, the fused pass, the kernel's order) against ``jax.vjp``
    of ``ssd_chunked`` on the cases of
    ``test_backward_matches_jax_vjp_of_ssd_chunked`` (and S 130: three
    chunks of 64, the last ragged), B and C rounded to bf16, per head and
    shared by the heads (their gradients summed over the heads), float32 at
    2e-5."""
    x, dA, B, C = _inputs(b, s, h, p, n, seed=19)
    B, C = _bf16_values(B), _bf16_values(C)
    if shared:
        B, C = B[:, :, :1], C[:, :, :1]
    rng = np.random.default_rng(23)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dst = rng.normal(size=(b, h, p, n)).astype(np.float32)
    Bx, Cx = (np.broadcast_to(t, (b, s, h, n)) for t in (B, C))
    _, vjp = jax.vjp(lambda *a: jm.ssd_chunked(*a, chunk=chunk),
                     *(jnp.asarray(a) for a in (x, dA, Bx, Cx)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dst)))
    tB, tC = (torch.from_numpy(np.ascontiguousarray(t)).to(torch.bfloat16)
              .expand(b, s, h, n) for t in (B, C))
    got = _emulate_tc_bwd(torch.from_numpy(x), torch.from_numpy(dA), tB, tC,
                          torch.from_numpy(dy), torch.from_numpy(dst))
    if shared:
        got = (*got[:2], *(g.sum(2, keepdim=True) for g in got[2:]))
        want = (*want[:2], *(np.asarray(w).sum(2, keepdims=True)
                             for w in want[2:]))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)


@functools.lru_cache(maxsize=1)
def _model_scale_backward():
    """mamba2-370m's scale on the CPU (:data:`M2_SCALE` without its
    chunk): float32 x and dy, dA = -softplus(N(0, 1)) (the cumsum near
    -50 at the end of a chunk of 64), bf16 B and C shared by the heads, the
    final state's gradient N(0, 0.1^2); and the plain backward in float64
    on them, computed once for the tests that share them (which do not
    modify them)."""
    b, s, h, p, n, chunk = M2_SCALE
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(b, s, h, p)) * 0.5).float()
    dA = -torch.nn.functional.softplus(torch.from_numpy(
        rng.normal(size=(b, s, h))).float())
    B, C = (torch.from_numpy(rng.normal(size=(b, s, 1, n)) * 0.3).float()
            .to(torch.bfloat16).expand(b, s, h, n) for _ in range(2))
    dy = torch.from_numpy(rng.normal(size=(b, s, h, p)) * 0.5).float()
    dst = torch.from_numpy(rng.normal(size=(b, h, p, n)) * 0.1).float()
    want = ref.ssd_bwd(x.double(), dA, B, C, dy, dst, chunk=chunk)
    return (x, dA, B, C, dy, dst), want


def _bwd_ratio(got, want):
    return max(_scaled_ratio(g, w, 1e-4) for g, w in zip(got, want))


def test_emulated_tc_backward_at_model_decay_against_float64():
    """At the model's scale and decay the backward route's arithmetic is
    within a tenth of the card's float64 check (1e-4 under
    ``close_scaled``) for dx, d(dA), dB and dC."""
    args, want = _model_scale_backward()
    ratio = _bwd_ratio(_emulate_tc_bwd(*args), want)
    print(f"backward, error over the float64 check's allowance: split TF32 "
          f"{ratio:.4f}")
    assert ratio < 0.1, ratio


@pytest.mark.parametrize("operand", BWD_OPERANDS)
def test_emulated_tc_backward_needs_every_split(operand):
    """One TF32 product for a single float32 operand of the backward route
    (the others split) misses the float32 check at the model's decay: why
    the kernel splits each of them."""
    args, want = _model_scale_backward()
    ratio = _bwd_ratio(_emulate_tc_bwd(*args, unsplit=(operand,)), want)
    print(f"backward, one TF32 product for {operand}: {ratio:.2f} of the "
          f"float64 check's allowance")
    assert ratio > 1.0, (operand, ratio)


@pytest.mark.parametrize("bc_dtype,route", [("bfloat16", "tc"),
                                            ("float32", "fma")])
def test_backward_plan_routes_by_b_dtype(bc_dtype, route):
    """The backward's route by B's dtype alone, in chunks of 64, and its
    workspace at mamba2-370m's training microbatch: chunk states and state
    gradients, each chunk's decay, and the tc route's row counters."""
    b, s, h, p, n = 2, 4096, 32, 64, 128
    pl = kernel.plan_bwd(b, s, h, p, n, getattr(torch, bc_dtype))
    assert (pl.route, pl.chunk, pl.n_chunks) == (route, kernel.BWD_CHUNK, 64)
    assert kernel.BWD_CHUNK == 64
    assert pl.workspace_bytes == (2 * b * h * 64 * p * n * 4 + b * h * 64 * 4
                                  + (b * h * 4 if route == "tc" else 0))
    assert kernel.plan_bwd(1, 65, 2, 8, 4, torch.bfloat16).n_chunks == 2
