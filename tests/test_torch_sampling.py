"""The port's sampler against JAX's.

``repro_torch.serve.sampling`` copies the reference's raw-key threefry PRNG
and its ``sample`` in torch ops. On the same keys:

* splits and 32-bit random bits equal ``jax.random.split`` /
  ``jax.random.bits`` bit for bit, in both of JAX's threefry modes (the
  test switches ``jax_threefry_partitionable`` and the port's
  ``THREEFRY_PARTITIONABLE`` together, and restores both), for seeds
  0, 1, 2**32 - 1, 2**32 + 5 and a large one, at odd and even lengths;
* uniforms equal ``jax.random.uniform``'s bit for bit;
* Gumbel noise is within 2 float32 ulp of ``jax.random.gumbel``'s, the
  ulp taken at max(|g|, 1): both compute ``-log(-log(u))`` from the same
  ``u``, and the logs of the two libraries differ by an ulp;
* the reference's sampling-math cases (``tests/test_sampling.py:45-114``)
  hold on both packages;
* ``sample`` gives JAX's token on 1000 seeded draws of (logits, key,
  temperature, top_k, top_p), wherever the top-2 margin of the filtered,
  scaled logits plus the Gumbel noise exceeds 1e-5 of the top value (or
  1e-5 when that is below 1); at least 99% of the draws are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.serve import sampling as R

torch = S = None  # bound by _port

SEEDS = [0, 1, 2**32 - 1, 2**32 + 5, 987654321012]
LENGTHS = [1, 2, 5, 64, 257]


@pytest.fixture(scope="module", autouse=True)
def _port():
    global torch, S
    torch = pytest.importorskip("torch")
    from repro_torch.serve import sampling as S
    torch.set_num_threads(1)


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def mode(request, monkeypatch):
    """Both packages in one threefry mode for the test, restored after."""
    saved = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    monkeypatch.setattr(S, "THREEFRY_PARTITIONABLE", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", saved)


def jkey(seed):
    return jnp.asarray(R.seed_key(seed))


def pkey(seed):
    return S.seed_key(seed)[None]


def words(x):
    return np.asarray(x).astype(np.int64)


def test_seed_keys_are_the_references():
    for seed in SEEDS:
        assert words(S.seed_key(seed)).tolist() == words(R.seed_key(seed)).tolist()
    assert words(S.seed_key(7)).tolist() == words(jax.random.PRNGKey(7)).tolist()
    assert tuple(S.zero_keys(3).shape) == (3, 2)
    assert not S.zero_keys(3).any()


@pytest.mark.parametrize("seed", SEEDS)
def test_splits_and_bits_equal_jax(mode, seed):
    carry, use = S.split_keys(pkey(seed))
    want = words(jax.random.split(jkey(seed)))
    assert words(carry[0]).tolist() == want[0].tolist()
    assert words(use[0]).tolist() == want[1].tolist()
    # a chain of splits, batched over the seeds, stays on JAX's
    keys = torch.stack([S.seed_key(s) for s in SEEDS])
    jk = [jkey(s) for s in SEEDS]
    for _ in range(3):
        keys, _ = S.split_keys(keys)
        jk = [jax.random.split(k)[0] for k in jk]
    assert words(keys).tolist() == [words(k).tolist() for k in jk]
    for n in LENGTHS:
        got = words(S.random_bits(pkey(seed), n)[0])
        want = words(jax.random.bits(jkey(seed), (n,), jnp.uint32))
        np.testing.assert_array_equal(got, want, f"seed {seed} n {n}")


@pytest.mark.parametrize("seed", SEEDS)
def test_uniforms_equal_jax_bit_for_bit(mode, seed):
    for n in LENGTHS:
        got = S.uniform(pkey(seed), n)[0].numpy()
        want = np.asarray(jax.random.uniform(jkey(seed), (n,), jnp.float32))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        tiny = np.finfo(np.float32).tiny
        got = S.uniform(pkey(seed), n, tiny, 1.0)[0].numpy()
        want = np.asarray(jax.random.uniform(jkey(seed), (n,), jnp.float32,
                                             tiny, 1.0))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulp_of_jax(mode, seed):
    n = 4096
    got = S.gumbel(pkey(seed), n)[0].numpy().astype(np.float64)
    want = np.asarray(jax.random.gumbel(jkey(seed), (n,), jnp.float32),
                      np.float64)
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) <= 2 * ulp).all(), np.abs(got - want).max()


# ---------------------------------------------------------------------------
# The reference's sampling-math cases, on both packages
# ---------------------------------------------------------------------------


def _draw_jax(logits, seed, temp, top_k, top_p):
    return int(R.sample(jnp.asarray(logits), jax.random.PRNGKey(seed), temp,
                        top_k, top_p))


def _draw_torch(logits, seed, temp, top_k, top_p):
    return int(S.sample(torch.from_numpy(np.asarray(logits)), S.seed_key(seed),
                        temp, top_k, top_p))


@pytest.fixture(params=["jax", "torch"])
def draw(request):
    return {"jax": _draw_jax, "torch": _draw_torch}[request.param]


def _logits(n: int = 32, seed: int = 0):
    return np.random.default_rng(seed).normal(size=(n,)).astype(np.float32)


def test_zero_temperature_is_exact_argmax(draw):
    logits = _logits()
    want = int(np.argmax(logits))
    for seed in (0, 1, 12345):
        assert draw(logits, seed, 0.0, 5, 0.5) == want


def test_top_k_one_is_argmax_at_any_temperature(draw):
    logits = _logits(seed=3)
    want = int(np.argmax(logits))
    for seed in range(8):
        assert draw(logits, seed, 5.0, 1, 1.0) == want


def test_tiny_top_p_keeps_only_the_top_token(draw):
    logits = _logits(seed=4)
    want = int(np.argmax(logits))
    for seed in range(8):
        assert draw(logits, seed, 2.0, 0, 1e-6) == want


def test_top_k_restricts_support(draw):
    logits = _logits(seed=5)
    allowed = set(np.argsort(logits)[-4:].tolist())
    for seed in range(24):
        assert draw(logits, seed, 8.0, 4, 1.0) in allowed


def test_top_p_restricts_support_to_the_nucleus(draw):
    logits = np.zeros((16,), np.float32)
    logits[7] = 8.0
    for seed in range(16):
        assert draw(logits, seed, 1.0, 0, 0.5) == 7


def test_same_key_reproduces_different_keys_vary(draw):
    logits = _logits(seed=6)
    a = draw(logits, 11, 2.0, 0, 1.0)
    assert draw(logits, 11, 2.0, 0, 1.0) == a
    assert len({draw(logits, s, 2.0, 0, 1.0) for s in range(24)}) > 1


def test_split_keys_matches_scalar_split_convention():
    keys = torch.stack([S.seed_key(s) for s in (1, 2, 3)])
    carry, use = S.split_keys(keys)
    for i in range(3):
        parts = words(jax.random.split(jkey(i + 1)))
        assert words(carry[i]).tolist() == parts[0].tolist()
        assert words(use[i]).tolist() == parts[1].tolist()


def test_sampling_params_validation():
    assert S.GREEDY.greedy and S.GREEDY.astuple() == (0.0, 0, 1.0, 0)
    assert not S.SamplingParams(temperature=0.5).greedy
    sp = S.SamplingParams(0.8, 40, 0.9, 3)
    assert sp.astuple() == R.SamplingParams(0.8, 40, 0.9, 3).astuple()
    for bad in (dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5), dict(seed=-1)):
        with pytest.raises(ValueError):
            S.SamplingParams(**bad)


# ---------------------------------------------------------------------------
# sample against JAX's on seeded draws
# ---------------------------------------------------------------------------


def test_sample_equals_jax_on_seeded_draws(mode):
    rng = np.random.default_rng(0)
    n, v = 1000, 256
    logits = (rng.standard_normal((n, v))
              * rng.uniform(0.5, 4.0, (n, 1))).astype(np.float32)
    keys = np.stack([R.seed_key(int(s)) for s in rng.integers(0, 2**40, n)])
    temp = rng.choice([0.0, 0.3, 0.8, 1.0, 1.7], n).astype(np.float32)
    top_k = rng.choice([0, 1, 5, 50, 300], n).astype(np.int32)
    top_p = rng.choice([1.0, 0.95, 0.9, 0.5, 0.1], n).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(R.sample))(logits, keys, temp, top_k,
                                                   top_p))
    args = [torch.from_numpy(a) for a in (logits, keys.astype(np.int64), temp,
                                          top_k, top_p)]
    got = S.sample(*args).numpy()
    # the margin the draw is decided by, on the port's own numbers
    z = S.scores(args[0], args[1], args[2], args[3], args[4])
    top2 = torch.topk(z, 2, -1).values.numpy()
    margin = (top2[:, 0] - top2[:, 1]) / np.maximum(np.abs(top2[:, 0]), 1.0)
    clear = (margin > 1e-5) | (temp == 0)
    assert clear.mean() >= 0.99, clear.mean()
    np.testing.assert_array_equal(got[clear], want[clear])
    assert got.dtype == np.int32 and (temp > 0).sum() > 700
    # greedy rows are the exact argmax; sampled rows do sample
    np.testing.assert_array_equal(got[temp == 0],
                                  logits[temp == 0].argmax(-1))
    assert (got[temp > 0] != logits[temp > 0].argmax(-1)).any()


def test_draw_splits_once_and_carries_where_emitting():
    """``draw``: the carried key where ``emit`` is set, the old key
    elsewhere; a launch with no sampled lane is the argmax, which is
    ``sample``'s token at temperature 0."""
    keys = torch.stack([S.seed_key(s) for s in (5, 6, 7)])
    logits = torch.from_numpy(_logits(96).reshape(3, 32))
    emit = np.array([True, False, True])
    temp = np.zeros((3,), np.float32)
    tok, new = S.draw(logits, keys, emit, temp, np.zeros((3,), np.int32),
                      np.ones((3,), np.float32))
    carry, _ = S.split_keys(keys)
    assert torch.equal(new[0], carry[0]) and torch.equal(new[1], keys[1])
    assert torch.equal(new[2], carry[2])
    assert torch.equal(tok, S.greedy(logits))
    temp[1] = 0.9
    tok, _ = S.draw(logits, keys, emit, temp, np.zeros((3,), np.int32),
                    np.ones((3,), np.float32))
    _, use = S.split_keys(keys)
    want = S.sample(logits, use, torch.from_numpy(temp), 0, 1.0)
    assert torch.equal(tok, want) and tok[0] == S.greedy(logits)[0]


def test_categorical_equals_jax(mode):
    """``categorical`` is ``jax.random.categorical``: the argmax of the
    Gumbel noise plus the logits, on every row whose top-2 gap is clear."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((64, 100)).astype(np.float32)
    seeds = [int(s) for s in rng.integers(0, 2**40, 64)]
    keys = torch.stack([S.seed_key(s) for s in seeds])
    got = S.categorical(keys, torch.from_numpy(logits)).numpy()
    want = np.array([int(jax.random.categorical(jkey(s), jnp.asarray(row)))
                     for s, row in zip(seeds, logits)])
    z = (S.gumbel(keys, 100) + torch.from_numpy(logits)).numpy()
    top2 = np.sort(z, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-5 * np.maximum(np.abs(top2[:, 1]), 1)
    assert clear.mean() >= 0.99
    np.testing.assert_array_equal(got[clear], want[clear])
