"""The CUDA RG-LRU scan and its backward against their plain versions on
the card: the reference's cases, a ragged S and W and one step, the edges
of the kernels' tile (``RGLRU_EDGES``) and inputs off 16-byte alignment,
bit for bit (both kernels round each step's multiply and add as the plain
versions do) and two calls bit for bit; the backward against float64, the
launch counts, and the gradients that the autograd wiring of ``ops.rglru``
gives h0, a and b through the kernels. Every test skips without a card.

This file imports no JAX, so that it also runs on the card's machine:
``python -m pytest -q tests/test_torch_rglru_cuda.py``. The cases
(``RGLRU_CASES``, ``RGLRU_EDGES``), the inputs, the one-call checks
(``rglru_case``, ``rglru_bwd_case``) and the bound (``RGLRU_TOL``, the
reference's 1e-5, under ``close_scaled``) come from ``chip_smoke.py``.
"""

import importlib.util
import pathlib

import pytest

torch = kernel = ops = ref = None  # bound by _port


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()       # its cases, bounds and one-call check
CASES = [pytest.param(*case, id="b{}_s{}_w{}".format(*case))
         for case in cs.RGLRU_CASES + cs.RGLRU_EDGES]


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file (as ``test_torch_rglru.py`` does)."""
    global torch, kernel, ops, ref
    torch = pytest.importorskip("torch")
    from repro_torch.kernels.rglru import kernel, ops, ref
    torch.set_num_threads(1)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda")
    g.manual_seed(cs.SEED)
    return g


@pytest.mark.parametrize("b,s,w", CASES)
def test_cuda_forward_matches_plain_bit_for_bit(gen, b, s, w):
    errs, exact = cs.rglru_case(torch, gen, kernel, ref, b, s, w)
    assert exact, errs


@pytest.mark.parametrize("b,s,w", CASES)
def test_cuda_backward_matches_plain_bit_for_bit(gen, b, s, w):
    errs, exact = cs.rglru_bwd_case(torch, gen, kernel, ref, b, s, w)
    assert exact, errs


@pytest.mark.parametrize("b,s,w", [(2, 131, 48), (1, 65, 2560)])
def test_cuda_off_16_byte_alignment_bit_for_bit(gen, b, s, w):
    """Inputs that start 4 bytes past a 16-byte boundary take the 4-byte
    copies (``vec_bytes``) and give the plain version's bits, both ways."""
    a, _ = cs.rglru_inputs(torch, gen, b, s, w)
    assert kernel.vec_bytes(w, a) == 16
    assert kernel.vec_bytes(w, cs.misaligned(torch, a)) == 4
    for case in (cs.rglru_case, cs.rglru_bwd_case):
        errs, exact = case(torch, gen, kernel, ref, b, s, w, offset=True)
        assert exact, (case.__name__, errs)


def test_cuda_backward_against_float64(gen):
    a, bb = cs.rglru_inputs(torch, gen, 2, 300, 96)
    y, _ = kernel.rglru_scan_cuda(a, bb)
    dy = torch.randn(a.shape, generator=gen, device="cuda")
    dh = torch.randn((2, 96), generator=gen, device="cuda")
    got = kernel.rglru_scan_bwd_cuda(a, y, dy, dh)
    want = ref.rglru_bwd(a.double(), y.double(), dy.double(), dh.double())
    for g, w in zip(got, want):
        assert (g.double() - w).abs().max().item() <= cs.RGLRU_TOL


def test_cuda_autograd_through_the_kernels(gen):
    """``ops.rglru`` with h0 on the card: the gradients of a, b and h0 come
    from the backward kernel (one launch) and equal the CPU's plain path's
    bit for bit."""
    a, bb = cs.rglru_inputs(torch, gen, 2, 70, 40)
    h0 = torch.randn((2, 40), generator=gen, device="cuda")
    dy = torch.randn(a.shape, generator=gen, device="cuda")
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in (a, bb, h0)]
        n0, b0 = kernel.launches, kernel.launches_bwd
        y, h = ops.rglru(*leaves)
        grads[dev] = torch.autograd.grad((y * dy.to(dev)).sum() + h.sum(),
                                         leaves)
        launched = (kernel.launches - n0, kernel.launches_bwd - b0)
        assert launched == ((1, 1) if dev == "cuda" else (0, 0)), launched
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert torch.equal(g.cpu(), w)
    assert all(bool((g != 0).any()) for g in grads["cuda"])


def test_cuda_backward_refuses_what_it_does_not_take(gen):
    a, bb = cs.rglru_inputs(torch, gen, 1, 8, 4)
    y, _ = kernel.rglru_scan_cuda(a, bb)
    dh = torch.zeros((1, 4), device="cuda")
    with pytest.raises(ValueError, match="of one shape"):
        kernel.rglru_scan_bwd_cuda(a, y[:, :4].contiguous(), y, dh)
    with pytest.raises(ValueError, match="dh must be"):
        kernel.rglru_scan_bwd_cuda(a, y, y, dh.double())
