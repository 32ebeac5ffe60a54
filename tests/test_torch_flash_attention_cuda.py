"""The CUDA flash forward and backward at head dims above 128 against their
plain versions on the card: the edges of the bf16 tensor-core kernels' D
256 tiles (64 queries a block, 16 a warp, 32 keys a forward step, 16 a dQ
step; 64 keys and one query head a dK/dV block, 64 queries a step, the G
heads' float32 shares summed in head order) and of the float32 backward's
staged tiles, and the routes. Every test skips without a card.

This file imports no JAX, so that it also runs on the card's machine:
``python -m pytest -q tests/test_torch_flash_attention_cuda.py``. Its
inputs come from numpy seeds, the cases (``FLASH256_EDGES``) and bounds
from ``chip_smoke.py``: the reference's tolerances (float32 2e-5, bfloat16
3e-2), o at a bound scaled to its size (``close_scaled``), lse at 2e-5 +
2e-5 |lse|; dq, dk and dv at ``GRAD_TOL`` under ``close_scaled``, through
its one-call check ``flash_check``.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = kernel = ref = None  # bound by _port


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()       # its bounds and the D 256 tile's edge cases
D256_EDGES = [pytest.param(*case, id=f"d{case[5]}_sq{case[1]}_sk{case[2]}_"
                           f"h{case[3]}_k{case[4]}_w{case[6]}_"
                           f"{'causal' if case[7] else 'full'}")
              for case in cs.FLASH256_EDGES]


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file (as ``test_torch_flash_attention.py`` does)."""
    global torch, kernel, ref
    torch = pytest.importorskip("torch")
    from repro_torch.kernels.attention import kernel, ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _qkv(b, sq, sk, h, k, d, dtype, seed=11):
    rng = np.random.default_rng(seed)
    shapes = [(b, sq, h, d), (b, sk, k, d), (b, sk, k, d)]
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(getattr(torch, dtype)).cuda() for s in shapes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,k,d,win,causal", D256_EDGES)
def test_cuda_forward_d256_edges_match_plain(card, b, sq, sk, h, k, d, win,
                                             causal, dtype):
    """bf16 on the tensor cores (32-key steps, D zero-padded to the next
    multiple of 16), float32 on the CUDA cores, against the plain version;
    a second call gives the same bits."""
    q, kk, vv = _qkv(b, sq, sk, h, k, d, dtype)
    o, lse = kernel.flash_attention_fwd_cuda(q, kk, vv, causal=causal,
                                             window=win)
    wo, wlse = ref.flash_attention_ref(q, kk, vv, causal=causal, window=win)
    cs.close_scaled(o, wo, cs.TOL[dtype], cs.TOL[dtype])
    cs.close(lse, wlse, cs.TOL["float32"])
    again = kernel.flash_attention_fwd_cuda(q, kk, vv, causal=causal,
                                            window=win)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


def test_cuda_forward_d256_route(card):
    """A bf16 call at D 256 runs the tensor-core kernel (the C entry's
    route raises ``launches_fwd_mma`` by one); a float32 call does not."""
    args = dict(causal=True, window=24)
    q, kk, vv = _qkv(1, 80, 80, 4, 1, 256, "bfloat16")
    mma0, fwd0 = kernel.launches_fwd_mma, kernel.launches_fwd
    kernel.flash_attention_fwd_cuda(q, kk, vv, **args)
    assert (kernel.launches_fwd_mma - mma0, kernel.launches_fwd - fwd0) == (1, 1)
    q, kk, vv = (x.float() for x in (q, kk, vv))
    kernel.flash_attention_fwd_cuda(q, kk, vv, **args)
    assert (kernel.launches_fwd_mma - mma0, kernel.launches_fwd - fwd0) == (1, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,k,d,win,causal", D256_EDGES)
def test_cuda_backward_d256_edges_match_plain(card, b, sq, sk, h, k, d, win,
                                              causal, dtype):
    """The backward above D 128: bf16 on the tensor cores (dK and dV in one
    launch over query heads and key tiles, their shares summed over G in
    head order with no atomics; 16-key dQ steps), float32 on the CUDA cores
    (one staging tile), against the plain backward; two calls give the
    same bits."""
    q, kk, vv = _qkv(b, sq, sk, h, k, d, dtype)
    do = _qkv(b, sq, sq, h, h, d, dtype, seed=12)[0]
    cs.flash_check(torch, kernel, ref, q, kk, vv, do, causal, win, dtype)
    o, lse = kernel.flash_attention_fwd_cuda(q, kk, vv, causal=causal,
                                             window=win)
    first, second = (kernel.flash_attention_bwd_cuda(
        q, kk, vv, o, lse, do, causal=causal, window=win) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_cuda_backward_d256_route(card):
    """A bf16 backward at D 256 runs the D 256 kernels (the C entry's route
    raises ``launches_bwd_d256`` by one), with shares to sum (G 4) or
    without (G 1); float32 at D 256 and bf16 at D 128 do not."""
    calls = [(1, 4, 1, 256, "bfloat16", 1), (1, 2, 2, 256, "bfloat16", 1),
             (1, 4, 1, 256, "float32", 0), (1, 4, 1, 128, "bfloat16", 0)]
    for b, h, k, d, dtype, on_route in calls:
        q, kk, vv = _qkv(b, 80, 80, h, k, d, dtype)
        do = _qkv(b, 80, 80, h, h, d, dtype, seed=12)[0]
        o, lse = kernel.flash_attention_fwd_cuda(q, kk, vv, causal=True,
                                                 window=24)
        r0, b0 = kernel.launches_bwd_d256, kernel.launches_bwd
        kernel.flash_attention_bwd_cuda(q, kk, vv, o, lse, do, causal=True,
                                        window=24)
        launched = (kernel.launches_bwd_d256 - r0, kernel.launches_bwd - b0)
        assert launched == (on_route, 1), (h, k, d, dtype, launched)


def test_cuda_backward_d256_through_autograd(card):
    """``ops.flash_attention`` at D 256 on the card: one forward and one
    backward launch, gradients of the plain path's size on the CPU."""
    from repro_torch.kernels.attention import ops
    q, kk, vv = _qkv(1, 70, 70, 10, 1, 256, "bfloat16")
    do = _qkv(1, 70, 70, 10, 10, 256, "bfloat16", seed=12)[0]
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in (q, kk, vv)]
        f0, b0 = kernel.launches_fwd, kernel.launches_bwd
        o = ops.flash_attention(*leaves, causal=True, window=24)
        grads[dev] = torch.autograd.grad(o, leaves, do.to(dev))
        launched = (kernel.launches_fwd - f0, kernel.launches_bwd - b0)
        assert launched == ((1, 1) if dev == "cuda" else (0, 0)), launched
    for g, w in zip(grads["cuda"], grads["cpu"]):
        cs.close_scaled(g.cpu(), w, *cs.GRAD_TOL["bfloat16"])
