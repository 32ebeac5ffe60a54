"""The port's RG-LRU scan against ``repro.kernels.rglru`` and
``repro.models.griffin.linear_scan_ref``.

The plain version (``repro_torch.kernels.rglru.ref``), reached through the
dispatching ``ops.rglru`` on CPU tensors, is held to the JAX sequential scan
and to the Pallas kernel in interpret mode (as the JAX tests run it) on the
reference's cases (``tests/test_kernels.py:110``), at the reference's
tolerance: atol 1e-5. Also: the ``h0`` fold, a ragged S and W and the
edges of the CUDA kernels' tiles (``chip_smoke.RGLRU_EDGES``; the Pallas
wrapper does not take them, so against ``linear_scan_ref`` only), and the
plain version in float64. The backward (``ops.rglru``'s autograd function
on the plain ``ref.rglru_bwd``) is held to ``jax.vjp`` of
``linear_scan_blocked``, the function the reference trains through, with
and without ``h0``, within one block, across blocks and on the same
edges, at 2e-5. ``kernel.vec_bytes`` is checked without a card. The CUDA
kernels are held to the plain versions on the card by the tests that skip here,
``tests/test_torch_rglru_cuda.py`` and ``chip_smoke.py``.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.rglru import ops as jops
from repro.models import griffin as jg

torch = kernel = ops = ref = None  # bound by _port


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()          # the kernels' tile and its edges
EDGES = [pytest.param(*case, id="b{}_s{}_w{}".format(*case))
         for case in cs.RGLRU_EDGES]


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, kernel, ops, ref
    torch = pytest.importorskip("torch")
    from repro_torch.kernels.rglru import kernel, ops, ref
    torch.set_num_threads(1)


CASES = [(2, 64, 32), (1, 128, 128), (3, 32, 64)]   # B, S, W
ATOL = 1e-5                                          # tests/test_kernels.py:118


def _inputs(b, s, w, seed=7):
    """a in [0, 0.95] and b ~ N(0, 0.5^2), as the reference's test draws
    them; h0 ~ N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)
    a = np.clip(np.abs(rng.normal(size=(b, s, w)) * 0.3), 0, 0.95)
    bb = rng.normal(size=(b, s, w)) * 0.5
    h0 = rng.normal(size=(b, w)) * 0.5
    return a.astype(np.float32), bb.astype(np.float32), h0.astype(np.float32)


def _jax(impl, a, bb, h0=None):
    args = (jnp.asarray(a), jnp.asarray(bb),
            None if h0 is None else jnp.asarray(h0))
    if impl == "ref":
        return jax.jit(jg.linear_scan_ref)(*args)
    return jops.rglru(*args)          # the Pallas kernel, interpret mode


def _close(got, want):
    y, h = got
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == np.shape(want[0]) and h.shape == np.shape(want[1])
    np.testing.assert_allclose(y.numpy(), np.asarray(want[0]), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want[1]), atol=ATOL)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("b,s,w", CASES)
def test_plain_matches_jax(b, s, w, impl):
    a, bb, _ = _inputs(b, s, w)
    got = ops.rglru(torch.from_numpy(a), torch.from_numpy(bb))
    _close(got, _jax(impl, a, bb))


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_h0_is_folded_into_the_first_step(impl):
    a, bb, h0 = _inputs(2, 64, 32, seed=3)
    tb = torch.from_numpy(bb)
    got = ops.rglru(torch.from_numpy(a), tb, torch.from_numpy(h0))
    _close(got, _jax(impl, a, bb, h0))
    assert torch.equal(tb, torch.from_numpy(bb))      # the caller's b is kept


@pytest.mark.parametrize("b,s,w", [pytest.param(2, 200, 48, id="b2_s200_w48")]
                         + EDGES)
def test_ragged_s_and_w_match_linear_scan_ref(b, s, w):
    """S 200 and W 48, and the edges of the CUDA kernels' tiles: no block
    divides them (the Pallas wrapper asserts ``S % min(128, S) == 0``);
    the port takes any shape."""
    a, bb, h0 = _inputs(b, s, w, seed=5)
    got = ops.rglru(torch.from_numpy(a), torch.from_numpy(bb),
                    torch.from_numpy(h0))
    _close(got, _jax("ref", a, bb, h0))


def test_plain_version_in_float64():
    """Given float64 inputs the plain version computes in float64 (the
    card's float64 check uses it as the yardstick): equal to a float64
    numpy loop, and its float32 result within float32 rounding of it."""
    a, bb, h0 = (x.astype(np.float64) for x in _inputs(2, 96, 16, seed=9))
    h = h0.copy()
    want = np.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + bb[:, t]
        want[:, t] = h
    y, hf = ref.rglru(torch.from_numpy(a), torch.from_numpy(bb),
                      torch.from_numpy(h0))
    assert y.dtype == torch.float64
    np.testing.assert_array_equal(y.numpy(), want)
    np.testing.assert_array_equal(hf.numpy(), h)
    y32, _ = ref.rglru(torch.from_numpy(a).float(), torch.from_numpy(bb).float(),
                       torch.from_numpy(h0).float())
    np.testing.assert_allclose(y32.double().numpy(), want, atol=ATOL)


def test_dispatch_casts_to_float32():
    """As the reference's wrapper: a and b are cast to float32 before the
    scan, so bfloat16 gates give the float32 scan of their values."""
    a, bb, _ = _inputs(1, 32, 16)
    ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, bb))
    y, h = ops.rglru(ta, tb)
    wy, wh = ref.rglru(ta.float(), tb.float())
    assert y.dtype == torch.float32
    assert torch.equal(y, wy) and torch.equal(h, wh)


def test_dispatch_raises_off_cuda_and_cpu():
    meta = [torch.empty((1, 8, 4), device="meta") for _ in range(2)]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ops.rglru(*meta)
    cpu = [torch.rand(1, 8, 4) for _ in range(2)]
    before = kernel.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernel.rglru_scan_cuda(*cpu)
    assert kernel.launches == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the card's machine has nvcc")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(kernel, "_BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.build()


@pytest.mark.parametrize("b,s,w", CASES + [(2, 200, 48), (1, 1, 3)])
def test_cuda_kernel_matches_plain(b, s, w):
    """The CUDA kernel against the plain version on the card (skips here).
    Both round the multiply and the add separately, so they agree bit for
    bit; the test holds them to the reference's 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a, bb, h0 = (torch.from_numpy(x).cuda() for x in _inputs(b, s, w))
    before = kernel.launches
    y, h = ops.rglru(a, bb, h0)
    assert kernel.launches == before + 1
    wy, wh = ref.rglru(a, bb, h0)
    torch.testing.assert_close(y, wy, atol=ATOL, rtol=0)
    torch.testing.assert_close(h, wh, atol=ATOL, rtol=0)


def _cotangents(b, s, w, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, w)).astype(np.float32),
            rng.normal(size=(b, w)).astype(np.float32))


@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
@pytest.mark.parametrize("b,s,w", [pytest.param(2, 64, 32, id="one_block"),
                                   pytest.param(2, 300, 16, id="two_blocks")]
                         + EDGES)
def test_backward_matches_jax_vjp_of_linear_scan_blocked(b, s, w, with_h0):
    """Gradients of a, b (and h0) for cotangents of y and h_final: the
    port's autograd function on the plain reverse scan against ``jax.vjp``
    of ``linear_scan_blocked`` (block 256: S 300 crosses a block and is
    padded), float32, 2e-5; also on the edges of the CUDA kernels'
    tiles."""
    a, bb, h0 = _inputs(b, s, w, seed=13)
    dy, dh = _cotangents(b, s, w)
    args = [a, bb] + ([h0] if with_h0 else [])
    _, vjp = jax.vjp(jg.linear_scan_blocked, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in args]
    y, h = ops.rglru(*leaves)
    got = torch.autograd.grad((y, h), leaves,
                              (torch.from_numpy(dy), torch.from_numpy(dh)))
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=2e-5,
                                   rtol=2e-5)


def test_plain_backward_is_the_reverse_scan():
    """``ref.rglru_bwd`` written out against a float64 numpy loop: g_t =
    dy_t + a_{t+1} g_{t+1} from g_{S-1} = dy_{S-1} + dh, db = g, da_t = g_t
    y_{t-1}; and float64 inputs keep it in float64."""
    a, bb, _ = (x.astype(np.float64) for x in _inputs(2, 40, 8, seed=17))
    dy, dh = (x.astype(np.float64) for x in _cotangents(2, 40, 8))
    y, _ = ref.rglru(torch.from_numpy(a), torch.from_numpy(bb))
    g = dh + dy[:, -1]
    want_a, want_b = np.zeros_like(a), np.zeros_like(a)
    for t in range(39, -1, -1):
        if t < 39:
            g = dy[:, t] + a[:, t + 1] * g
        want_b[:, t] = g
        want_a[:, t] = g * y.numpy()[:, t - 1] if t else 0.0
    da, db = ref.rglru_bwd(torch.from_numpy(a), y, torch.from_numpy(dy),
                           torch.from_numpy(dh))
    assert da.dtype == torch.float64
    np.testing.assert_allclose(da.numpy(), want_a, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(db.numpy(), want_b, rtol=1e-12, atol=1e-12)


def test_backward_refuses_cpu_tensors_on_the_kernel():
    """The backward kernel's wrapper takes CUDA tensors only, and counts
    no launch for a refusal."""
    a = torch.rand(1, 8, 4)
    before = kernel.launches_bwd
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernel.rglru_scan_bwd_cuda(a, a, a, torch.zeros(1, 4))
    assert kernel.launches_bwd == before


def test_vec_bytes_takes_16_only_where_rows_and_addresses_allow():
    """16-byte copies need W % 4 == 0 and every input on 16 bytes; the C
    entry refuses 16 otherwise, so the wrapper must pick 4 there."""
    x = torch.zeros(1, 8, 48)
    assert kernel.vec_bytes(48, x, x) == 16
    assert kernel.vec_bytes(17, torch.zeros(1, 8, 17)) == 4
    off = torch.zeros(1 + 8 * 48)[1:].view(1, 8, 48)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    assert kernel.vec_bytes(48, x, off) == 4
