"""The split-KV CUDA paged attention against its plain version on the card:
the edges of the design (single-split and merged slots in one call, one
slot at 4096 positions, G 1 to 16, every load width, rings whose window is
not a multiple of the page size, page ids outside the pool in unused
entries, a slot of length 0, h2o-danube3-4b's windowed decode shape with
D 120), each in all four dtype pairs, and the reference's cases; the
tensor-parallel shards' shapes (granite-3-2b's heads at tp 2 and 4,
``TP_SHARDS``), each call repeated bit for bit with the counters zeroed,
and the shards' calls, one after another on one stream, bit for bit the
heads of the one-device call. Every test skips without a card.

This file imports no JAX, so that it also runs on the card's machine:
``python -m pytest -q tests/test_torch_paged_attention_cuda.py``. The cases
(``PAGED_EDGES``, ``PAGED_CASES``, ``DTYPE_PAIRS``), the bounds (float32
2e-5, bfloat16 3e-2 by q's dtype, ``|got - plain| <= tol + tol |plain|``)
and the check of one call (``paged_case``: the plain version, a second
call's bits, the merge's counters left zeroed) come from ``chip_smoke.py``.
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
EDGES = [pytest.param(*edge, id="b{}_h{}_k{}_d{}_ps{}_len{}_w{}_np{}".format(
    *edge[:5], "-".join(map(str, edge[5])), *edge[6:]))
    for edge in cs.PAGED_EDGES]
PAIRS = [pytest.param(q, kv, id=f"q_{q}-pool_{kv}") for q, kv in cs.DTYPE_PAIRS]


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file (as ``test_torch_paged_attention.py`` does)."""
    global torch, kernel, ref
    torch = pytest.importorskip("torch")
    from repro_torch.kernels.paged_attention import kernel, ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def gen(card):
    g = torch.Generator(device="cuda")
    g.manual_seed(cs.SEED)
    return g


@pytest.mark.parametrize("q_dt,kv_dt", PAIRS)
@pytest.mark.parametrize("b,h,kh,d,ps,lengths,window,np_slot", EDGES)
def test_split_kv_edges_match_plain(gen, b, h, kh, d, ps, lengths, window,
                                    np_slot, q_dt, kv_dt):
    """Within the reference's tolerance of the plain version, two calls bit
    for bit, the counters zero after both."""
    cs.paged_case(torch, gen, kernel, ref, b, h, kh, d, ps, lengths, window,
                  np_slot, getattr(torch, q_dt), getattr(torch, kv_dt))


@pytest.mark.parametrize("q_dt,kv_dt", PAIRS)
@pytest.mark.parametrize("b,h,kh,d,max_len,ps,window", cs.PAGED_CASES)
def test_reference_cases_match_plain(gen, b, h, kh, d, max_len, ps, window,
                                     q_dt, kv_dt):
    """The reference's cases (tests/test_paged_attention.py) at random
    lengths; the window case over a ring of ceil(window / ps) + 1 entries."""
    q, kp, vp, tables, lengths = cs.pool_case(
        torch, gen, b, h, kh, d, max_len, ps, window, getattr(torch, q_dt),
        getattr(torch, kv_dt), ring=window is not None)
    got = kernel.paged_attention_cuda(q, kp[0], vp[0], tables, lengths,
                                      window=window)
    want = ref.paged_attention(q, kp[0], vp[0], tables, lengths, window=window)
    cs.close(got, want, cs.TOL[q_dt])


def test_one_launch_a_call_and_the_plan_it_runs(gen):
    """``launches`` counts one per call, merged or not; the workspace is
    the plan's and the counters cover every (slot, KV head) of the call."""
    before = kernel.launches
    for edge in cs.PAGED_EDGES[:2]:
        cs.paged_case(torch, gen, kernel, ref, *edge, torch.bfloat16,
                      torch.bfloat16)
    assert kernel.launches - before == 4
    p = kernel.plan(1, 32, 8, 64, 256, 16, None, torch.bfloat16,
                    torch.bfloat16)
    assert (p.n_split, p.n_counters) == (64, 8)
    assert kernel.counter_buffer(torch.device("cuda", 0)).numel() >= 8


TP_LENGTHS = (1, 17, 63, 64, 65, 100, 159, 160)   # the tp phase's max_len 160


@pytest.mark.parametrize("q_dt,kv_dt", PAIRS)
@pytest.mark.parametrize("b,h,kh,d", cs.TP_SHARDS,
                         ids=lambda v: str(v))
def test_tp_shard_shapes_match_plain(gen, b, h, kh, d, q_dt, kv_dt):
    """A tensor-parallel shard's call (granite-3-2b's heads at tp 2 and 4,
    16-token pages, 10-entry tables): within the tolerance of the plain
    version, two calls bit for bit, the counters zero after both."""
    cs.paged_case(torch, gen, kernel, ref, b, h, kh, d, 16, TP_LENGTHS, None,
                  10, getattr(torch, q_dt), getattr(torch, kv_dt))


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_calls_equal_the_one_device_call(gen, tp):
    """The shards of a tp decode call the kernel one after another on one
    device's stream, sharing its merge counters: each call leaves them
    zero, and the shards' outputs, concatenated in mesh order, are the
    one-device call's bit for bit (each query head reads only its own KV
    head; the split plan does not depend on the head counts)."""
    b, h, kh, d = 8, 32, 8, 64
    q, kp, vp, tables, lengths = cs.pool_case(
        torch, gen, b, h, kh, d, 160, 16, None, torch.bfloat16,
        torch.bfloat16)
    full = kernel.paged_attention_cuda(q, kp[0], vp[0], tables, lengths)
    parts = []
    for i in range(tp):
        hs = slice(i * h // tp, (i + 1) * h // tp)
        ks = slice(i * kh // tp, (i + 1) * kh // tp)
        parts.append(kernel.paged_attention_cuda(
            q[:, hs].contiguous(), kp[0][:, :, ks].contiguous(),
            vp[0][:, :, ks].contiguous(), tables, lengths))
        torch.cuda.synchronize()
        counters = kernel.counter_buffer(q.device)
        assert counters is None or not bool(counters.any())
    assert torch.equal(torch.cat(parts, 1), full)
