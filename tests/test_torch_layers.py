"""The port's decode-path layers against ``repro.models.layers``.

Same numpy inputs through both packages. Tolerances: float32 2e-5 (the two
frameworks differ only in summation order); bfloat16 3e-2, the reference's
own kernel tolerance (tests/test_paged_attention.py:71), since each
framework rounds its bf16 intermediates at other places.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import layers as JL

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
torch = TL = None  # bound by the _port fixture


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, TL
    torch = pytest.importorskip("torch")
    from repro_torch.models import layers as TL
    torch.set_num_threads(1)


def _pair(a: np.ndarray, dtype: str):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _check(got, want, dtype: str):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.fixture
def rng():
    return np.random.default_rng(3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(rng, dtype):
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    _check(TL.rmsnorm(tx, torch.from_numpy(scale), 1e-6),
           JL.rmsnorm(jx, jnp.asarray(scale), 1e-6), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(rng, dtype):
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 7))
    jx, tx = _pair(x, dtype)
    got = TL.rope(tx, torch.from_numpy(pos), 1e4)
    assert got.dtype == tx.dtype
    _check(got, JL.rope(jx, jnp.asarray(pos), 1e4), dtype)


def test_sinusoidal(rng):
    pos = rng.integers(0, 900, size=(3, 4))
    _check(TL.sinusoidal(torch.from_numpy(pos), 64),
           JL.sinusoidal(jnp.asarray(pos), 64), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "squared_relu"])
def test_mlp(rng, kind, dtype):
    d, f = 32, 48
    x = rng.normal(size=(2, 3, d)).astype(np.float32)
    p = {k: (rng.normal(size=v.shape) / np.sqrt(v.shape[0])).astype(np.float32)
         for k, v in TL.mlp_decls(d, f, kind).items()}
    jx, tx = _pair(x, dtype)
    jp = {k: _pair(v, dtype)[0] for k, v in p.items()}
    tp = {k: _pair(v, dtype)[1] for k, v in p.items()}
    _check(TL.mlp(tx, tp, kind), JL.mlp(jx, jp, kind), dtype)


class _Cfg:
    def __init__(self, vocab, pad, tie):
        self.vocab, self.tie_embeddings = vocab, tie
        self.padded_vocab = -(-vocab // pad) * pad if pad else vocab


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tie,pad", [(True, 0), (False, 0), (True, 16)])
def test_lm_head(rng, tie, pad, dtype):
    cfg = _Cfg(vocab=50, pad=pad, tie=tie)
    d = 24
    x = rng.normal(size=(2, 1, d)).astype(np.float32)
    w = (rng.normal(size=(cfg.padded_vocab, d)) * 0.2).astype(np.float32)
    params = {"embed": w} if tie else {"head": np.ascontiguousarray(w.T)}
    jx, tx = _pair(x, dtype)
    want = JL.lm_head(jx, {k: jnp.asarray(v) for k, v in params.items()}, cfg)
    got = TL.lm_head(tx, {k: torch.from_numpy(v) for k, v in params.items()},
                     cfg)
    assert got.shape[-1] == cfg.padded_vocab
    _check(got, want, dtype)
    if pad:
        assert bool((got[..., cfg.vocab:] == TL.NEG_INF).all())


@pytest.mark.parametrize("causal,window,kv_len", [(True, None, None),
                                                  (True, 3, None),
                                                  (False, None, 5)])
def test_attention_ref(rng, causal, window, kv_len):
    q = rng.normal(size=(2, 6, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 6, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 6, 2, 8)).astype(np.float32)
    want = JL.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window, kv_len=kv_len)
    got = TL.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal, window=window,
                           kv_len=kv_len)
    _check(got, want, "float32")
