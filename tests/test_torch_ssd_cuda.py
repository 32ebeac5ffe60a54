"""The CUDA SSD chunk scan against its plain version on the card: the edges
of the tensor-core route (bf16 B and C: S 1, ragged last chunks, chunks of
8, 100, 256 and 1024, P 8 to 64, N 4 to 128, odd P and N), contiguous and
expanded over the heads with stride 0, in float32 and bf16 x; the CUDA-core
route (float32 B and C) on the reference's cases; the route each call
takes, its launch counts and a second call's bits; and the model's decay
against float64. The backward kernels on the same cases and edges against
the plain backward (``ref.ssd_bwd``), at the model's decay against
float64, and through ``ops.ssd``'s autograd with B and C shared by the
heads; the backward's tensor-core route (bf16 B and C) at the edges of its
chunks (``SSD_BWD_EDGES``), its route and launch counts. Every test skips
without a card.

This file imports no JAX, so that it also runs on the card's machine:
``python -m pytest -q tests/test_torch_ssd_cuda.py``. The cases
(``SSD_EDGES``, ``SSD_CASES``, ``SSD_RAGGED``), the bounds (float32 1e-4,
bfloat16 x 5e-2, under ``close_scaled``) and the checks of one call
(``ssd_case``: the plain version, the C entry's route against ``plan``'s,
a second call's bits; ``ssd_bwd_case`` for the backward) come from
``chip_smoke.py``.
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
EDGES = [pytest.param(*case, id="b{}_s{}_h{}_p{}_n{}_q{}".format(*case))
         for case in cs.SSD_EDGES]
CASES = [pytest.param(*case, id="b{}_s{}_h{}_p{}_n{}_q{}".format(*case))
         for case in cs.SSD_CASES + cs.SSD_RAGGED]


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file (as ``test_torch_ssd.py`` does)."""
    global torch, kernel, ref
    torch = pytest.importorskip("torch")
    from repro_torch.kernels.ssd import kernel, ref
    torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def gen(card):
    g = torch.Generator(device="cuda")
    g.manual_seed(cs.SEED)
    return g


@pytest.mark.parametrize("shared", [False, True], ids=["per_head", "shared"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", EDGES)
def test_cuda_ssd_tc_route_edges(gen, b, s, h, p, n, chunk, dtype, shared):
    """bf16 B and C, contiguous or expanded over the heads with stride 0:
    the tensor-core route, within the reference's tolerance of the plain
    version, two calls bit for bit."""
    _, _, route = cs.ssd_case(torch, gen, kernel, ref, b, s, h, p, n, chunk,
                              getattr(torch, dtype), torch.bfloat16, shared)
    assert route == "tc"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_cuda_ssd_float32_bc_keep_the_cuda_core_route(gen, b, s, h, p, n,
                                                      chunk, dtype):
    """float32 B and C: the first port's kernel, as before."""
    _, _, route = cs.ssd_case(torch, gen, kernel, ref, b, s, h, p, n, chunk,
                              getattr(torch, dtype), torch.float32)
    assert route == "fma"


def test_cuda_ssd_counts_calls_and_tc_calls(gen):
    """Each call adds one to ``launches`` (three kernels on the tc route),
    and those the C entry reports on the tc route to ``launches_tc``."""
    x, dA, B, C = cs.ssd_inputs(torch, gen, 1, 70, 2, 16, 16,
                                bc_dtype=torch.bfloat16)
    n0, t0 = kernel.launches, kernel.launches_tc
    kernel.ssd_cuda(x, dA, B, C, chunk=32)
    kernel.ssd_cuda(x, dA, B.float(), C.float(), chunk=32)
    assert (kernel.launches - n0, kernel.launches_tc - t0) == (2, 1)


def test_cuda_ssd_model_decay_against_float64(gen):
    """The model's decay (dA = -softplus(N(0, 1)), the cumsum near -200 at
    a chunk's end), bf16 B and C shared by the heads, s 1024, chunk 256:
    within 1e-4 of the plain version in float64 under ``close_scaled``, on
    the tensor-core route."""
    b, s, h, p, n, chunk = 2, 1024, 4, 64, 128, 256
    x, _, B, C = cs.ssd_inputs(torch, gen, b, s, h, p, n,
                               bc_dtype=torch.bfloat16, heads_share_bc=True)
    dA = cs.model_decay(torch, gen, b, s, h)
    (ey, es), route = cs.ssd_route(kernel, lambda: cs.ssd_check(
        torch, kernel, ref, x, dA, B, C, chunk, cs.SSD_TOL["float32"],
        f64=True))
    assert route == "tc"
    assert ey[0] <= 1e-3 and es[0] <= 1e-3, (ey, es)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_cuda_ssd_backward_float32_bc(gen, b, s, h, p, n, chunk, dtype):
    """float32 B and C: dx, ddA, dB, dC within the forward's tolerance of
    the plain backward, two calls bit for bit."""
    cs.ssd_bwd_case(torch, gen, kernel, ref, b, s, h, p, n, chunk,
                    getattr(torch, dtype), torch.float32)


@pytest.mark.parametrize("shared", [False, True], ids=["per_head", "shared"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", EDGES)
def test_cuda_ssd_backward_edges(gen, b, s, h, p, n, chunk, dtype, shared):
    """bf16 B and C, per head or expanded over the heads with stride 0 (dB
    and dC come back per head): the backward's chunks of 64 cut S 1,
    ragged ends and P, N of every size the forward takes."""
    cs.ssd_bwd_case(torch, gen, kernel, ref, b, s, h, p, n, chunk,
                    getattr(torch, dtype), torch.bfloat16, shared)


def test_cuda_ssd_backward_model_decay_against_float64(gen):
    """The model's decay and dtypes (float32 x, bf16 B and C shared by the
    heads), s 1024: within 1e-4 of the plain backward in float64 under
    ``close_scaled``."""
    errs = cs.ssd_bwd_case(torch, gen, kernel, ref, 2, 1024, 4, 64, 128, 256,
                           torch.float32, torch.bfloat16, True, decay=True,
                           f64=True)
    assert set(errs) == {"dx", "ddA", "dB", "dC"}


def test_cuda_ssd_autograd_sums_shared_b_and_c_over_heads(gen):
    """``ops.ssd`` on the card with B and C expanded over the heads: one
    forward and one backward launch, and the gradients of x, dA and the
    unexpanded B and C equal the CPU's plain path's within the forward's
    tolerance for their dtype (B's and C's are bf16: autograd rounds each
    head's float32 gradient to bf16 before the expand sums them)."""
    from repro_torch.kernels.ssd import ops
    x, dA, B, C = cs.ssd_inputs(torch, gen, 2, 70, 4, 16, 32,
                                bc_dtype=torch.bfloat16, heads_share_bc=True)
    Braw, Craw = B[:, :, 0].contiguous(), C[:, :, 0].contiguous()
    dy = torch.randn(x.shape, generator=gen, device="cuda")
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in (x, dA, Braw, Craw)]
        xs, das, bs, cs_ = leaves
        n0, b0 = kernel.launches, kernel.launches_bwd
        y, st = ops.ssd(xs, das, bs[:, :, None].expand(2, 70, 4, 32),
                        cs_[:, :, None].expand(2, 70, 4, 32), chunk=32)
        grads[dev] = torch.autograd.grad((y * dy.to(dev)).sum() + st.sum(),
                                         leaves)
        launched = (kernel.launches - n0, kernel.launches_bwd - b0)
        assert launched == ((1, 1) if dev == "cuda" else (0, 0)), launched
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert g.dtype == w.dtype
        tol = cs.SSD_TOL[str(w.dtype).split(".")[1]]
        cs.close_scaled(g.cpu(), w, tol, tol)


BWD_EDGES = [pytest.param(*case, id="b{}_s{}_h{}_p{}_n{}".format(*case))
             for case in cs.SSD_BWD_EDGES]


@pytest.mark.parametrize("shared", [False, True], ids=["per_head", "shared"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n", BWD_EDGES)
def test_cuda_ssd_backward_tc_route_edges(gen, b, s, h, p, n, dtype, shared):
    """bf16 B and C on the backward's tensor-core route, at the edges of its
    chunks of 64 and 16-row warp tiles (``SSD_BWD_EDGES``: S 1, a ragged
    end, exactly one chunk, one step past it, a ragged third chunk; P and N
    from 4 to the forward's 64 and 128, odd ones), per head and shared by
    the heads, float32 and bf16 x: within the forward's tolerance of the
    plain backward, the route by the C entry's report, a second call bit
    for bit and the row counters left at zero."""
    cs.ssd_bwd_case(torch, gen, kernel, ref, b, s, h, p, n, kernel.BWD_CHUNK,
                    getattr(torch, dtype), torch.bfloat16, shared)


def test_cuda_ssd_backward_counts_calls_and_tc_calls(gen):
    """Each backward call adds one to ``launches_bwd``, and those the C entry
    reports on the tensor-core route (bf16 B and C) to
    ``launches_bwd_tc``; float32 B and C keep the CUDA-core kernels."""
    x, dA, B, C = cs.ssd_inputs(torch, gen, 1, 70, 2, 16, 16,
                                bc_dtype=torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device="cuda")
    dst = torch.zeros((1, 2, 16, 16), device="cuda")
    n0, t0 = kernel.launches_bwd, kernel.launches_bwd_tc
    kernel.ssd_bwd_cuda(x, dA, B, C, dy, dst)
    kernel.ssd_bwd_cuda(x, dA, B.float(), C.float(), dy, dst)
    assert (kernel.launches_bwd - n0, kernel.launches_bwd_tc - t0) == (2, 1)
