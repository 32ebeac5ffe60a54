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
refusals. The CUDA kernel is held to the plain version on the card by the
tests that skip here and by ``chip_smoke.py``.
"""

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
