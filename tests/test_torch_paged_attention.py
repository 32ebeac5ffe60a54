"""The port's paged attention against ``repro.kernels.paged_attention``.

The plain PyTorch version is held to both JAX impls (``ref`` and the Pallas
kernel in interpret mode, as the JAX tests run it) on the reference's
``PAGED_CASES``; the in-place append to its masked-lane and ring-wrap
semantics; and the dispatch to its no-fallback rule. Tolerances are the
reference's own: float32 2e-5, bfloat16 3e-2 (tests/test_paged_attention.py).
The CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py``, by ``test_cuda_kernel_matches_plain`` below and by
``tests/test_torch_paged_attention_cuda.py``, which skip without a card.
Here the kernel's cut (``kernel.plan``) is checked at the path's shapes, and
its split-and-merge arithmetic, emulated in float32, is held to the JAX
kernel in interpret mode and to float64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.paged_attention import ops as jops

torch = configs = device_mod = registry = None  # bound by _port
kernel = ops = ref = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, configs, device_mod, kernel, ops, ref, registry
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch import device as device_mod
    from repro_torch.kernels.paged_attention import kernel, ops, ref
    from repro_torch.models import registry
    torch.set_num_threads(1)


# B, H, K, D, max_len, ps, window (tests/test_paged_attention.py:54-60)
PAGED_CASES = [
    (3, 4, 2, 16, 32, 8, None),
    (2, 4, 4, 48, 24, 4, None),      # MHA, unaligned D, tiny pages
    (1, 8, 1, 64, 64, 16, None),     # MQA
    (4, 4, 2, 16, 40, 8, 12),        # sliding window
    (2, 6, 3, 32, 33, 16, None),     # max_len not a page multiple
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@functools.partial(jax.jit, static_argnames=("impl", "window"))
def _jax_paged(q, kp, vp, tables, lengths, *, impl, window=None):
    return jops.paged_attention(q, kp, vp, tables, lengths, window=window,
                                impl=impl)


@functools.partial(jax.jit, static_argnames=("impl", "window"))
def _jax_append(q, k_new, v_new, kp, vp, tables, lengths, *, impl, window):
    return jops.paged_decode_append(q, k_new, v_new, kp, vp, tables, lengths,
                                    impl=impl, window=window)


def make_pool(rng, b, max_len, kh, d, ps):
    """Disjoint per-slot page chains over a shuffled pool, ragged lengths
    (numpy, float32)."""
    np_slot = -(-max_len // ps)
    pool_pages = b * np_slot + 1            # spare page stays unreferenced
    tables = rng.permutation(pool_pages)[:b * np_slot].reshape(b, np_slot)
    kp = rng.normal(size=(pool_pages, ps, kh, d)).astype(np.float32)
    vp = rng.normal(size=(pool_pages, ps, kh, d)).astype(np.float32)
    lengths = rng.integers(1, max_len + 1, size=(b,))
    return kp, vp, tables.astype(np.int32), lengths.astype(np.int32)


def _both(arrays, dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    j = [jnp.asarray(a, jd if a.dtype == np.float32 else a.dtype) for a in arrays]
    t = [torch.from_numpy(a).to(td) if a.dtype == np.float32
         else torch.from_numpy(a) for a in arrays]
    return j, t


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,k,d,max_len,ps,win", PAGED_CASES)
def test_plain_matches_jax(b, h, k, d, max_len, ps, win, dtype, impl):
    rng = np.random.default_rng(11)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp, vp, tables, lengths = make_pool(rng, b, max_len, k, d, ps)
    (jq, jkp, jvp, jt, jl), (tq, tkp, tvp, tt, tl) = _both(
        [q, kp, vp, tables, lengths], dtype)
    want = _jax_paged(jq, jkp, jvp, jt, jl, impl=impl, window=win)
    got = ops.paged_attention(tq, tkp, tvp, tt, tl, window=win)
    assert got.dtype == tq.dtype and got.shape == (b, h, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_append_masks_idle_lanes_and_matches_jax():
    """Active lanes land at (tables[b, len // ps], len % ps) and attend
    over it; a masked lane leaves the pool bitwise untouched."""
    rng = np.random.default_rng(5)
    b, h, kh, d, ps, max_len = 3, 4, 2, 16, 8, 32
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp, vp, tables, _ = make_pool(rng, b, max_len, kh, d, ps)
    lengths = np.array([0, 9, 31], np.int32)   # page start / middle / end
    k_new = rng.normal(size=(b, kh, d)).astype(np.float32)
    v_new = rng.normal(size=(b, kh, d)).astype(np.float32)
    mask = np.array([True, False, True])
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    o, kp2, vp2 = ops.paged_decode_append(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        tkp, tvp, torch.from_numpy(tables), torch.from_numpy(lengths),
        append_mask=torch.from_numpy(mask))
    assert kp2 is tkp and vp2 is tvp                  # written in place
    for bi, (ln, m) in enumerate(zip(lengths, mask)):
        page, off = tables[bi, ln // ps], ln % ps
        if m:
            np.testing.assert_array_equal(kp2[page, off].numpy(), k_new[bi])
            np.testing.assert_array_equal(vp2[page, off].numpy(), v_new[bi])
    untouched = np.ones(kp.shape[:2], bool)
    for bi in (0, 2):
        untouched[tables[bi, lengths[bi] // ps], lengths[bi] % ps] = False
    np.testing.assert_array_equal(kp2.numpy()[untouched], kp[untouched])
    np.testing.assert_array_equal(vp2.numpy()[untouched], vp[untouched])
    jo, _, _ = jops.paged_decode_append(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lengths), append_mask=jnp.asarray(mask), impl="ref")
    live = np.array([0, 2])
    np.testing.assert_allclose(o.numpy()[live], np.asarray(jo)[live],
                               atol=2e-5, rtol=2e-5)


def test_ring_append_wraps_into_the_reused_entry():
    """Past the ring, the append lands in the page the wrapped entry points
    at: offset ``len % ps`` of page ``tables[(len // ps) % NP]``."""
    rng = np.random.default_rng(6)
    h, kh, d, ps, window = 4, 2, 8, 4, 4
    kp = torch.from_numpy(rng.normal(size=(5, ps, kh, d)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(5, ps, kh, d)).astype(np.float32))
    tables = torch.tensor([[3, 1]], dtype=torch.int32)  # entry 0 holds block 2
    lengths = torch.tensor([9], dtype=torch.int32)      # block 2, offset 1
    q = torch.randn(1, h, d)
    kn, vn = torch.randn(1, kh, d), torch.randn(1, kh, d)
    ops.paged_decode_append(q, kn, vn, kp, vp, tables, lengths, window=window)
    assert torch.equal(kp[3, 1], kn[0]) and torch.equal(vp[3, 1], vn[0])


@pytest.mark.parametrize("window", [3, 6, 9])
def test_ring_decode_chain_matches_jax(window):
    """Decoding through a ring block table (ceil(window/ps)+1 entries, the
    tail entry wrapping, page ids reused) matches both JAX impls at every
    step, for windows smaller than and not multiples of the page size."""
    rng = np.random.default_rng(window)
    h, kh, d, ps, steps = 4, 2, 8, 4, 14
    r = -(-window // ps) + 1
    ids = r + 2                       # rotating live ids; row `ids` = null
    shape = (ids + 1, ps, kh, d)
    jpool = {impl: (jnp.zeros(shape), jnp.zeros(shape)) for impl in ("ref", "pallas")}
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    tables = np.full((1, r), ids, np.int32)
    for n in range(steps):
        blk = n // ps
        if n % ps == 0:
            tables[0, blk % r] = blk % ids
        q = rng.normal(size=(1, h, d)).astype(np.float32)
        kn = rng.normal(size=(1, kh, d)).astype(np.float32)
        vn = rng.normal(size=(1, kh, d)).astype(np.float32)
        lengths = np.array([n], np.int32)
        got, _, _ = ops.paged_decode_append(
            torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
            tk, tv, torch.from_numpy(tables), torch.from_numpy(lengths),
            window=window)
        for impl in ("ref", "pallas"):
            want, jk, jv = _jax_append(
                jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), *jpool[impl],
                jnp.asarray(tables), jnp.asarray(lengths), window=window,
                impl=impl)
            jpool[impl] = (jk, jv)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=2e-5, rtol=2e-5,
                                       err_msg=f"{impl} step {n}")


def test_dispatch_never_falls_back():
    """The wrapper takes the plain version only for CPU tensors: a tensor on
    any other device raises, and the CUDA kernel's wrapper refuses tensors
    that are not on a CUDA device instead of computing them."""
    meta = [torch.empty((2, 4, 16), device="meta"),
            torch.empty((5, 8, 2, 16), device="meta"),
            torch.empty((5, 8, 2, 16), device="meta"),
            torch.zeros((2, 2), dtype=torch.int32, device="meta"),
            torch.ones((2,), dtype=torch.int32, device="meta")]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ops.paged_attention(*meta)
    cpu = [torch.randn(2, 4, 16), torch.randn(5, 8, 2, 16),
           torch.randn(5, 8, 2, 16), torch.zeros((2, 2), dtype=torch.int32),
           torch.ones((2,), dtype=torch.int32)]
    before = kernel.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernel.paged_attention_cuda(*cpu)
    assert kernel.launches == before


def test_cuda_request_without_a_card_raises(monkeypatch, tmp_path):
    """``device=None`` asks for the card: without one it raises instead of
    running on the CPU; so does building the kernel without ``nvcc``."""
    if torch.cuda.is_available():
        assert device_mod.resolve(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.paged_pool_init(configs.smoke("granite_3_2b"), 4, 4)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(kernel, "_BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.build()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,k,d,max_len,ps,win", PAGED_CASES)
def test_cuda_kernel_matches_plain(b, h, k, d, max_len, ps, win, dtype):
    """The CUDA kernel against the plain version on the card (skips here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(11)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp, vp, tables, lengths = make_pool(rng, b, max_len, k, d, ps)
    _, ts = _both([q, kp, vp, tables, lengths], dtype)
    tq, tkp, tvp, tt, tl = [t.cuda() for t in ts]
    got = kernel.paged_attention_cuda(tq, tkp, tvp, tt, tl, window=win)
    want = ref.paged_attention(tq, tkp, tvp, tt, tl, window=win)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


# the split-KV kernel's cut (kernel.plan) at the path's shapes: (B, H, K, D,
# NP, ps, window) -> (split_len, n_split, workspace bytes). Granite-3-2b's
# decode shape (lengths up to 1024), the serve phase's (10-entry tables),
# one slot at its 4096-token context, and a ring of window 256.
PLAN_SHAPES = [
    ((8, 32, 8, 64, 64, 16, None), (64, 16, 8 * 8 * 16 * (2 * 4 + 4 * 64) * 4)),
    ((8, 32, 8, 64, 10, 16, None), (64, 3, 8 * 8 * 3 * (2 * 4 + 4 * 64) * 4)),
    ((1, 32, 8, 64, 256, 16, None), (64, 64, 1 * 8 * 64 * (2 * 4 + 4 * 64) * 4)),
    ((8, 32, 8, 64, 17, 16, 256), (64, 4, 8 * 8 * 4 * (2 * 4 + 4 * 64) * 4)),
]


@pytest.mark.parametrize("shape,want", PLAN_SHAPES)
def test_plan_at_the_path_shapes(shape, want):
    """L a multiple of the page size, enough splits for the longest range
    the table holds, 16-byte loads at D 64 bf16, one float32 (m, l, acc[G][D])
    per split of each (slot, KV head), one counter per (slot, KV head)."""
    b, h, k, d, np_, ps, window = shape
    p = kernel.plan(*shape, torch.bfloat16, torch.bfloat16)
    assert (p.split_len, p.n_split, 4 * p.work_floats) == want
    assert p.split_len % ps == 0 and p.vec_bytes == 16 and p.tile == 64
    span = np_ * ps if window is None else min(np_ * ps, window)
    assert (p.n_split - 1) * p.split_len < span <= p.n_split * p.split_len
    assert p.n_counters == b * k


def test_plan_narrows_the_load_to_what_rows_and_pools_allow():
    """D 36 and D 100 in bf16 (72- and 200-byte rows) take 8-byte loads,
    D 34 4-byte and odd D 2-byte ones; a pool 8 bytes off a 16-byte
    boundary takes 8; float32 rows of 144 and 400 bytes keep 16; a call
    whose longest range fits one split needs no workspace."""
    bf, f32 = torch.bfloat16, torch.float32
    width = lambda d, dt, align=16: kernel.plan(  # noqa: E731
        8, 32, 8, d, 64, 16, None, bf, dt, align).vec_bytes
    assert [width(d, bf) for d in (64, 36, 100, 34, 33)] == [16, 8, 8, 4, 2]
    assert [width(d, f32) for d in (36, 100, 33)] == [16, 16, 4]
    assert width(64, bf, align=8) == 8
    one = kernel.plan(3, 8, 2, 64, 4, 8, None, f32, f32)
    assert (one.n_split, one.work_floats, one.n_counters) == (1, 0, 0)
    # pages longer than a split's target: one page a split, in tiles
    long = kernel.plan(2, 8, 2, 128, 4, 256, None, f32, f32)
    assert long.split_len == 256 and long.tile < 64


@pytest.mark.parametrize("np_,ps,window", [(1024, 16, None), (600, 7, None),
                                           (4096, 16, 100_000)])
def test_plan_caps_the_splits(np_, ps, window):
    """Past 64 splits of 64 positions the split grows by whole pages
    instead, so the merge never weighs more than 64 splits."""
    p = kernel.plan(2, 32, 8, 64, np_, ps, window, torch.bfloat16,
                    torch.bfloat16)
    span = np_ * ps if window is None else min(np_ * ps, window)
    assert p.n_split <= kernel.MAX_SPLITS and p.split_len % ps == 0
    assert (p.n_split - 1) * p.split_len < span <= p.n_split * p.split_len
    assert p.split_len - ps < -(-span // kernel.MAX_SPLITS)


def _emulate_split_kv(q, kp, vp, tables, lengths, window, split_len):
    """The kernel's arithmetic in float32 (numpy): per split of
    ``split_len`` positions its (m, l, acc) by the online softmax from
    m = -1e30, a slot with one split normalised directly, several merged in
    split order. Returns o in float32, before the cast to q's dtype."""
    f32 = np.float32
    b, h, d = q.shape
    _, ps, kh, _ = kp.shape
    n_entries = tables.shape[1]
    g = h // kh
    scale = f32(1.0 / np.sqrt(d))
    out = np.zeros((b, h, d), f32)
    for bi in range(b):
        n = max(int(lengths[bi]), 0)
        lo = hi = 0
        if n > 0 and window is not None:
            cur = (n - 1) // ps
            start = max(0, n - window)
            lo = max(start, max(start // ps, cur - n_entries + 1, 0) * ps)
            hi = n
        elif n > 0:
            hi = min(n, n_entries * ps)
        n_active = max(1, -(-(hi - lo) // split_len))
        for k in range(kh):
            qg = q[bi, k * g:(k + 1) * g].astype(f32)
            parts = []
            for s in range(n_active):
                pos = np.arange(lo + s * split_len,
                                min(hi, lo + (s + 1) * split_len))
                blk = pos // ps
                page = tables[bi, blk % n_entries if window else blk]
                kr = kp[page, pos % ps, k].astype(f32)
                vr = vp[page, pos % ps, k].astype(f32)
                sc = (qg @ kr.T) * scale
                m = np.maximum(f32(-1e30), sc.max(axis=1, initial=f32(-1e30)))
                p = np.exp(sc - m[:, None])
                parts.append((m, p.sum(axis=1), p @ vr))
            if n_active == 1:
                m, l, acc = parts[0]
                o = acc / np.maximum(l, f32(1e-30))[:, None]
            else:
                mx = np.max([m for m, _, _ in parts], axis=0)
                num, den = np.zeros((g, d), f32), np.zeros(g, f32)
                for m, l, acc in parts:
                    w = np.exp(m - mx)
                    num += acc * w[:, None]
                    den += l * w
                o = num / np.maximum(den, f32(1e-30))[:, None]
            out[bi, k * g:(k + 1) * g] = o
    return out


def _attend_f64(q, kp, vp, tables, lengths, window):
    """Softmax attention in float64 over each slot's positions: ``[0,
    len)`` through a contiguous table, the last ``window`` through a ring
    (whose entries cover the window)."""
    b, h, d = q.shape
    _, ps, kh, _ = kp.shape
    out = np.zeros((b, h, d))
    for bi in range(b):
        n = int(lengths[bi])
        pos = np.arange(max(0, n - window) if window else 0, n)
        blk = pos // ps
        page = tables[bi, blk % tables.shape[1] if window else blk]
        kr = kp[page, pos % ps].astype(np.float64)          # (n, K, D)
        vr = vp[page, pos % ps].astype(np.float64)
        for hi in range(h):
            s = kr[:, hi // (h // kh)] @ q[bi, hi].astype(np.float64) / np.sqrt(d)
            p = np.exp(s - s.max())
            out[bi, hi] = p @ vr[:, hi // (h // kh)] / p.sum()
    return out


@pytest.mark.parametrize("n", [7, 8, 9, 26])      # L - 1, L, L + 1, 3L + 2
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 19])
def test_split_and_merge_emulation_matches_jax(n, dtype, window):
    """The kernel's split-and-merge arithmetic (L 8 at ps 4, so slots of
    one, two and four splits) against the JAX kernel in interpret mode at
    the reference's tolerance, and against float64 at float32's: its sums
    are float32 on the same (bf16-rounded) inputs."""
    rng = np.random.default_rng(n)
    b, h, kh, d, ps, split_len = 3, 8, 2, 64, 4, 8
    lengths = np.array([n, 1, 3 * split_len + 2], np.int32)
    np_slot = -(-window // ps) + 1 if window else -(-lengths.max() // ps) + 1
    n_pages = b * np_slot + 1
    tables = rng.permutation(n_pages)[:b * np_slot].reshape(b, np_slot)
    tables = tables.astype(np.int32)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(n_pages, ps, kh, d)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, kh, d)).astype(np.float32)
    (jq, jkp, jvp, jt, jl), _ = _both([q, kp, vp, tables, lengths], dtype)
    q, kp, vp = (np.asarray(x, np.float32) for x in (jq, jkp, jvp))  # rounded
    got = _emulate_split_kv(q, kp, vp, tables, lengths, window, split_len)
    want = _jax_paged(jq, jkp, jvp, jt, jl, impl="pallas", window=window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    exact = _attend_f64(q, kp, vp, tables, lengths, window)
    np.testing.assert_allclose(got, exact, atol=TOL["float32"],
                               rtol=TOL["float32"])
