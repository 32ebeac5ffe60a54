"""The port's paged attention against ``repro.kernels.paged_attention``.

The plain PyTorch version is held to both JAX impls (``ref`` and the Pallas
kernel in interpret mode, as the JAX tests run it) on the reference's
``PAGED_CASES``; the in-place append to its masked-lane and ring-wrap
semantics; and the dispatch to its no-fallback rule. Tolerances are the
reference's own: float32 2e-5, bfloat16 3e-2 (tests/test_paged_attention.py).
The CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py`` and by ``test_cuda_kernel_matches_plain`` below, which
skips without a card.
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
