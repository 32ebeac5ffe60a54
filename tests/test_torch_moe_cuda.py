"""The CUDA grouped matmul against its plain version on the card: the edges
of the bf16 routes' tiles (wgmma: 128 x 256 output tiles, 64-deep D steps,
persistent blocks; split D: 16 x 128 tiles, D in chunks of 64-deep steps),
the reference's and the ragged cases, and the route each call takes; the
backward's dx and dw kernels on the same cases (wgmma for bf16 at C > 16,
the CUDA cores for the rest), their launch counts and the autograd
function on the card. Every test skips without a card.

This file imports no JAX, so that it also runs on the card's machine:
``python -m pytest -q tests/test_torch_moe_cuda.py``. The cases
(``GMM_EDGES``, ``GMM_CASES``, ``GMM_RAGGED``), the bounds (float32 1e-4,
bfloat16 5e-2, ``|got - plain| <= tol + tol |plain|``) and the check of one
call (``gmm_case``, ``gmm_bwd_case``: the plain version, the C entry's
route against ``plan``'s or ``plan_bwd``'s, a second call's bits) come
from ``chip_smoke.py``.
"""

import importlib.util
import pathlib

import pytest

torch = kernel = ref = None  # bound by _port


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()       # its cases, bounds and one-call check
CASES = [pytest.param(*case, id="e{}_c{}_d{}_f{}".format(*case))
         for case in cs.GMM_EDGES + cs.GMM_CASES + cs.GMM_RAGGED]


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file (as ``test_torch_moe.py`` does)."""
    global torch, kernel, ref
    torch = pytest.importorskip("torch")
    from repro_torch.kernels.moe import kernel, ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def gen(card):
    g = torch.Generator(device="cuda")
    g.manual_seed(cs.SEED)
    return g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", CASES)
def test_cuda_gmm_matches_plain_on_its_route(gen, e, c, d, f, dtype):
    """bf16 at C <= 16 on the split-D route, larger C on wgmma, D or F off a
    multiple of 8 on mma.sync, float32 on the CUDA cores; each within the
    reference's tolerance of the plain version, two calls bit for bit."""
    cs.gmm_case(torch, gen, kernel, ref, e, c, d, f, getattr(torch, dtype))


def test_cuda_gmm_unaligned_input_takes_the_mma_route(gen):
    """x 2 bytes past a 16-byte boundary: TMA cannot read it, so the call
    runs on the mma.sync route, and gives the aligned (wgmma) result bit
    for bit."""
    x, w = cs.gmm_inputs(torch, gen, 2, 64, 64, 64, torch.bfloat16)
    xo = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")[1:]
    xo = xo.view(x.shape)
    xo.copy_(x)
    assert kernel.plan(2, 64, 64, 64, torch.bfloat16,
                       xo.data_ptr() % 16 == 0).route == "mma"
    yo, ran_o = cs.gmm_route(kernel, lambda: kernel.grouped_matmul_cuda(xo, w))
    ya, ran_a = cs.gmm_route(kernel, lambda: kernel.grouped_matmul_cuda(x, w))
    assert (ran_o, ran_a) == ("other", "wgmma")
    cs.close(ya, ref.grouped_matmul(x, w), cs.GMM_TOL["bfloat16"])
    assert torch.equal(yo, ya)


def test_cuda_gmm_counts_each_route(gen):
    """``launches`` counts every call; ``launches_wgmma`` and
    ``launches_splitd`` only those the C entry reports on their route."""
    before = (kernel.launches, kernel.launches_wgmma, kernel.launches_splitd)
    for c in (8, 129):
        x, w = cs.gmm_inputs(torch, gen, 2, c, 64, 136, torch.bfloat16)
        kernel.grouped_matmul_cuda(x, w)
    kernel.grouped_matmul_cuda(x.float(), w.float())
    after = (kernel.launches, kernel.launches_wgmma, kernel.launches_splitd)
    assert tuple(a - b for a, b in zip(after, before)) == (3, 1, 1)


# ---------------------------------------------------------------------------
# The backward: dx = dy w^T and dw = x^T dy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", CASES)
def test_cuda_gmm_backward_matches_plain_on_its_route(gen, e, c, d, f,
                                                      dtype):
    """dx and dw: bf16 at C > 16 on the wgmma route (the forward's kernel
    with the operands' majors swapped), the rest on the CUDA cores; each
    within the reference's tolerance of the plain version, two calls bit
    for bit (``chip_smoke.gmm_bwd_case``)."""
    cs.gmm_bwd_case(torch, gen, kernel, ref, e, c, d, f, getattr(torch, dtype))


def test_cuda_gmm_backward_off_alignment_takes_the_cuda_cores(gen):
    """x 2 bytes past a 16-byte boundary: TMA cannot read it, so dw runs on
    the CUDA cores' bf16 route, within the tolerance of the plain
    version."""
    x, w = cs.gmm_inputs(torch, gen, 2, 64, 64, 64, torch.bfloat16)
    dy = torch.randn((2, 64, 64), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    xo = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")[1:]
    xo = xo.view(x.shape).copy_(x)
    assert kernel.plan_bwd(64, 64, 64, torch.bfloat16,
                           xo.data_ptr() % 16 == 0) == "bf16"
    before = kernel.launches_bwd_wgmma
    got = kernel.grouped_matmul_dw_cuda(xo, dy)
    assert kernel.launches_bwd_wgmma == before
    cs.close(got, ref.grouped_matmul_dw(x, dy), cs.GMM_TOL["bfloat16"])


def test_cuda_gmm_backward_counts_each_route(gen):
    """``launches_bwd`` counts every dx and dw call, ``launches_bwd_wgmma``
    those the C entry reports on the wgmma route."""
    before = (kernel.launches_bwd, kernel.launches_bwd_wgmma)
    for c in (8, 129):
        x, w = cs.gmm_inputs(torch, gen, 2, c, 64, 136, torch.bfloat16)
        dy = torch.randn((2, c, 136), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        kernel.grouped_matmul_dx_cuda(dy, w)
        kernel.grouped_matmul_dw_cuda(x, dy)
    kernel.grouped_matmul_dw_cuda(x.float(), dy.float())
    after = (kernel.launches_bwd, kernel.launches_bwd_wgmma)
    assert tuple(a - b for a, b in zip(after, before)) == (5, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_autograd_runs_the_backward_kernels(gen, dtype):
    """``ops.grouped_matmul`` on the card: its backward launches dx and dw
    once each (only dx when w needs no gradient), and the gradients are the
    plain versions' within the tolerance."""
    from repro_torch.kernels.moe import ops
    dt = getattr(torch, dtype)
    x, w = cs.gmm_inputs(torch, gen, 3, 65, 72, 136, dt)
    dy = torch.randn((3, 65, 136), generator=gen, device="cuda", dtype=dt)
    tol = cs.GMM_TOL[dtype]
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = kernel.launches_bwd
    ops.grouped_matmul(xg, wg).backward(dy)
    assert kernel.launches_bwd == before + 2
    cs.close(xg.grad, ref.grouped_matmul_dx(dy, w), tol)
    cs.close(wg.grad, ref.grouped_matmul_dw(x, dy), tol)
    xg = x.clone().requires_grad_()
    ops.grouped_matmul(xg, w).backward(dy)
    assert kernel.launches_bwd == before + 3
