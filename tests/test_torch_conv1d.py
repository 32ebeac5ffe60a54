"""The port's depthwise causal conv1d (the CGRA) against the JAX package.

The same numpy inputs go through ``repro.kernels.conv1d`` (the Pallas
kernel in interpret mode, and its oracle ``ref.conv1d``) and the port's
plain version (``repro_torch.kernels.conv1d.ref``), on the reference's
cases (``tests/test_kernels.py:167-169``) and its tolerances: float32 1e-5,
bfloat16 5e-2 against the float32 oracle.

The port follows the oracle (``layers.causal_conv1d``) at every width. It
is held to the Pallas kernel only at W >= 2: at W = 1 the kernel's halo
slice ``prev[-(width - 1):]`` is ``prev[-0:]``, the whole previous block
(``src/repro/kernels/conv1d/kernel.py:26``), so tap 0 reads the halo and
the kernel disagrees with its own oracle (checked below; the JAX package
is not edited).

Also: a stride-0 input (the seizure CNN's channel broadcast), the
wrapper's routing (CPU to the plain version, CUDA to the kernel, any other
device raises), and the CUDA kernel against the plain version on the card
(tests that skip here, and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import repro.kernels  # noqa: F401  (XAIF registration of "pallas")
from repro.kernels.conv1d import ops as jops
from repro.kernels.conv1d import ref as jref

torch = ops = ref = kernel = None  # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, ops, ref, kernel
    torch = pytest.importorskip("torch")
    from repro_torch.kernels.conv1d import kernel, ops, ref
    torch.set_num_threads(1)


CASES = [(2, 64, 32, 4), (1, 256, 128, 4), (3, 32, 16, 2), (1, 64, 64, 8)]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}          # tests/test_kernels.py:175


def _inputs(b, s, d, w, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    taps = (rng.normal(size=(w, d)) * 0.4).astype(np.float32)
    return x, taps


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,d,w", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_the_pallas_kernel(b, s, d, w, dtype):
    x, taps = _inputs(b, s, d, w)
    want = jops.conv1d(_jax(x, dtype), _jax(taps, dtype))   # interpret mode
    got = ops.conv1d(_torch(x, dtype), _torch(taps, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, d)
    _close(got.float().numpy(), want, TOL[dtype])


@pytest.mark.parametrize("w", range(1, 9))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_the_oracle_at_every_width(w, dtype):
    x, taps = _inputs(2, 37, 13, w, seed=w)
    want = jref.conv1d(_jax(x, "float32"), _jax(taps, "float32"))
    got = ref.conv1d(_torch(x, dtype), _torch(taps, dtype))
    _close(got.float().numpy(), want, TOL[dtype])
    if dtype == "float32":
        # same products and sums in the same order: equal bit for bit
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pallas_kernel_is_wrong_at_width_one_and_the_port_follows_the_oracle():
    x, taps = _inputs(1, 512, 128, 1)
    oracle = np.asarray(jref.conv1d(jnp.asarray(x), jnp.asarray(taps)))
    pallas = np.asarray(jops.conv1d(jnp.asarray(x), jnp.asarray(taps)))
    assert np.abs(pallas - oracle).max() > 0.1        # the reference quirk
    got = ops.conv1d(torch.from_numpy(x), torch.from_numpy(taps)).numpy()
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, x * taps[0])


def test_stride_zero_input_equals_its_dense_copy():
    """The seizure CNN's CGRA path broadcasts one input channel over the
    output channels with stride 0 (``expand``), as JAX's
    ``broadcast_to``."""
    rng = np.random.default_rng(3)
    col = rng.normal(size=(1, 256, 1)).astype(np.float32)
    taps = rng.normal(size=(4, 16)).astype(np.float32)
    xb = torch.from_numpy(col).expand(1, 256, 16)
    assert xb.stride(2) == 0
    got = ops.conv1d(xb, torch.from_numpy(taps))
    dense = ops.conv1d(xb.contiguous(), torch.from_numpy(taps))
    torch.testing.assert_close(got, dense, rtol=0, atol=0)
    want = jops.conv1d(jnp.broadcast_to(jnp.asarray(col), (1, 256, 16)),
                       jnp.asarray(taps))
    _close(got.numpy(), want, TOL["float32"])


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    real = ref.conv1d
    monkeypatch.setattr(ref, "conv1d", lambda x, w: calls.append(1) or real(x, w))
    before = kernel.launches
    x, taps = _inputs(1, 16, 8, 3)
    ops.conv1d(torch.from_numpy(x), torch.from_numpy(taps))
    assert calls == [1] and kernel.launches == before and kernel._lib is None


def test_dispatch_refusals():
    x, taps = (torch.from_numpy(a) for a in _inputs(1, 16, 8, 3))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ops.conv1d(x.to("meta"), taps.to("meta"))
    before = kernel.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernel.conv1d_cuda(x, taps)
    with pytest.raises(ValueError, match=r"width 9 outside \[1, 8\]"):
        kernel.conv1d_cuda(x, torch.zeros((9, 8)))
    with pytest.raises(ValueError, match=r"want x \(B, S, D\) and w \(W, D\)"):
        kernel.conv1d_cuda(x, torch.zeros((3, 7)))
    assert kernel.launches == before and kernel._lib is None


def test_registered_as_the_cgra_under_cuda():
    import repro_torch.kernels  # noqa: F401
    from repro_torch.core.xaif import REGISTRY

    spec = REGISTRY.get("conv1d", "cuda")
    assert spec is ops.SPEC and spec.fn is ops.conv1d
    x, taps = (torch.from_numpy(a) for a in _inputs(1, 16, 8, 3))
    torch.testing.assert_close(REGISTRY.dispatch("conv1d", "cuda", x, taps),
                               ref.conv1d(x, taps), rtol=0, atol=0)


@pytest.mark.parametrize("b,s,d,w", CASES + [(2, 37, 13, 1), (1, 1, 5, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(b, s, d, w, dtype):
    """The CUDA kernel against the plain version on the card (skips here);
    float32 bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, taps = (_torch(a, dtype).cuda() for a in _inputs(b, s, d, w))
    got = kernel.conv1d_cuda(x, taps)
    want = ref.conv1d(x.float(), taps.float())
    _close(got.float().cpu().numpy(), want.cpu().numpy(), TOL[dtype])
    if dtype == "float32":
        assert torch.equal(got, want)


def test_cuda_kernel_takes_a_stride_zero_input():
    """The CGRA path's broadcast input, read through its strides on the
    card (skips here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    col = torch.randn((1, 1024, 1), device="cuda").expand(1, 1024, 32)
    taps = torch.randn((4, 32), device="cuda")
    assert torch.equal(kernel.conv1d_cuda(col, taps), ref.conv1d(col, taps))
