"""Deterministic per-request sampling for the port's serving engine.

Port of ``src/repro/serve/sampling.py``: :class:`SamplingParams` and
:data:`GREEDY` as in the reference, the raw threefry keys of JAX's PRNG
(:func:`seed_key`, :func:`zero_keys`, :func:`split_keys`) and
:func:`sample` (temperature, top-k, top-p, then ``categorical``), in torch
integer and float ops. The keys, splits and random bits are JAX's bit for
bit, so a request's sampled stream is the reference's wherever the logits
agree; the floats (softmax, cumsum, logs) are held to JAX within rounding.

* **Keys.** A key is the reference's raw ``(2,)`` uint32 threefry key,
  held as two uint32 words in an int64 tensor (torch's uint32 lacks shifts
  and adds on some backends); every word op masks with ``0xFFFFFFFF``.
* **The mode.** JAX splits keys and draws bits one of two ways, chosen by
  ``jax_threefry_partitionable``: the *partitionable* one
  (``_threefry_split_foldlike`` and ``_threefry_random_bits_partitionable``
  in ``jax/_src/prng.py``, 32-bit words ``bits1 ^ bits2``) and the
  *original* one (``_threefry_split_original``,
  ``_threefry_random_bits_original``). :data:`THREEFRY_PARTITIONABLE`
  selects it for the whole module; it defaults to partitionable, as in jax
  0.9.0. Set it to the mode of the jax a run is compared with.
* **The chain.** The engine splits each lane's key once a launch: row 0 of
  the split is carried to the lane's next emitting launch, row 1 draws
  this launch's token, and the carried half is kept only where the launch
  emits a token, so a chain's position equals the tokens produced.

Greedy decode is the zero-temperature case: ``temperature == 0`` returns the
exact argmax of the raw logits (:func:`greedy`), so a greedy lane of a mixed
batch gets the tokens it gets in an all-greedy batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["GREEDY", "SamplingParams", "THREEFRY_PARTITIONABLE",
           "categorical", "draw", "greedy", "gumbel", "random_bits", "sample",
           "scores", "seed_key", "split_keys", "threefry_2x32", "uniform",
           "zero_keys"]

# JAX's jax_threefry_partitionable: True is jax 0.9.0's default
THREEFRY_PARTITIONABLE = True

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny
_ONE_BITS = 0x3F800000                 # float32 1.0
_NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls (hashable, journal-friendly).

    ``temperature == 0`` is exact greedy decode: ``top_k``/``top_p``/``seed``
    are then inert. ``top_k == 0`` disables the top-k filter; ``top_p ==
    1.0`` disables the nucleus filter; top-k applies first, then top-p over
    the survivors. ``seed`` names the request's own PRNG chain.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError("temperature cannot be negative")
        if self.top_k < 0:
            raise ValueError("top_k cannot be negative")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.seed < 0:
            raise ValueError("seed cannot be negative")

    @property
    def greedy(self) -> bool:
        """True when this is the zero-temperature (argmax) degenerate."""
        return self.temperature == 0.0

    def astuple(self) -> tuple:
        """The journal form: ``(temperature, top_k, top_p, seed)``."""
        return (float(self.temperature), int(self.top_k),
                float(self.top_p), int(self.seed))


GREEDY = SamplingParams()


# ---------------------------------------------------------------------------
# Threefry-2x32 and JAX's raw-key PRNG
# ---------------------------------------------------------------------------


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry_2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash, 20 rounds (``_threefry2x32_lowering`` in
    ``jax/_src/prng.py``), on uint32 words held in int64 tensors that
    broadcast together. Returns the two hashed words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def _hash_iota(keys: torch.Tensor, n: int):
    """Each row's key hashed over the counts ``0 .. n - 1`` as
    ``threefry_2x32`` of ``prng.py`` does for the original mode: the counts
    padded to even and cut in halves, the two output halves joined and cut
    back to ``n``. ``keys`` (..., 2); returns (..., n)."""
    half = (n + 1) // 2
    counts = torch.arange(2 * half, dtype=torch.int64, device=keys.device)
    counts[n:] = 0
    y1, y2 = threefry_2x32(keys[..., 0:1], keys[..., 1:2], counts[:half],
                           counts[half:])
    return torch.cat([y1, y2], -1)[..., :n]


def _hash_pairs(keys: torch.Tensor, n: int):
    """The partitionable mode's hash: counts ``(0, i)`` for ``i < n`` (the
    high and low words of a 64-bit iota; ``n < 2**32``). Returns the two
    (..., n) word arrays."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    return threefry_2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(lo),
                         lo)


def seed_key(seed: int) -> torch.Tensor:
    """The raw threefry key of ``seed`` (``jax.random.PRNGKey``'s ``(2,)``
    layout: the high then the low 32 bits), made on the host."""
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64)


def zero_keys(n_lanes: int, device=None) -> torch.Tensor:
    """Initial per-lane key state: every lane at ``seed_key(0)`` (lanes
    are re-seeded at admission; idle lanes never consume their key)."""
    return torch.zeros((n_lanes, 2), dtype=torch.int64, device=device)


def split_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a ``(..., 2)`` key batch into ``(carry, use)`` halves: row 0
    and row 1 of ``jax.random.split(key)`` for each key, in the mode of
    :data:`THREEFRY_PARTITIONABLE`."""
    if THREEFRY_PARTITIONABLE:
        y1, y2 = _hash_pairs(keys, 2)
        parts = torch.stack([y1, y2], -1)              # (..., 2 keys, 2)
    else:
        parts = _hash_iota(keys, 4).unflatten(-1, (2, 2))
    return parts[..., 0, :], parts[..., 1, :]


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each ``(..., 2)`` key:
    (..., n) uint32 words in int64."""
    if THREEFRY_PARTITIONABLE:
        y1, y2 = _hash_pairs(keys, n)
        return y1 ^ y2
    return _hash_iota(keys, n)


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for each
    key, bit for bit (``_uniform`` in ``jax/_src/random.py``): 23 random
    mantissa bits under the exponent of 1.0, minus 1, scaled and shifted,
    and never below ``minval``."""
    bits = (random_bits(keys, n) >> 9) | _ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # float32 scalars (a device tensor made from a number would wait for
    # the device); each op rounds once, as XLA's do
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(floats * float(hi - lo) + float(lo), float(lo))


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` in its default ``"low"``
    mode for each key: ``-log(-log(u))``, ``u`` uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, n, _F32_TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` for each row: the argmax of
    Gumbel noise plus the float32 logits (the first maximal index)."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, -1)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis as int32; the first maximal index wins a
    tie (``torch.argmax`` documents this, as ``jnp.argmax`` does)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _filtered(logits, temperature, top_k, top_p) -> torch.Tensor:
    """The reference's scaled logits after its top-k and top-p masks, in
    float32, (B, V)."""
    scaled = logits.float() / torch.clamp_min(temperature, 1e-6)[:, None]
    v = scaled.shape[-1]
    # top-k: logits below the kth-largest are masked (k == 0 keeps all);
    # the index clamps as jnp indexing does
    desc = torch.sort(scaled, -1, descending=True).values
    kth = desc.gather(-1, (top_k.long() - 1).clamp(0, v - 1)[:, None])
    kth = torch.where(top_k[:, None] > 0, kth, _NEG_INF)
    scaled = torch.where(scaled < kth, _NEG_INF, scaled)
    # top-p over the survivors: the smallest prefix of the descending
    # probabilities whose exclusive cumsum is below top_p
    # (jax.nn.softmax: exp(x - max) / sum)
    e = torch.exp(scaled - scaled.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    ps = torch.sort(probs, -1, descending=True).values
    exclusive = torch.cumsum(ps, -1) - ps
    pmin = torch.where(exclusive < top_p[:, None], ps, float("inf")).amin(
        -1, keepdim=True)
    cut = (top_p[:, None] < 1.0) & (probs < pmin)
    return torch.where(cut, _NEG_INF, scaled)


def _per_row(x, dtype, b: int, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=dev).reshape(-1).expand(b)


def scores(logits: torch.Tensor, keys: torch.Tensor, temperature, top_k,
           top_p) -> torch.Tensor:
    """What :func:`sample` takes the argmax of for a sampled row: the
    float32 logits (B, V) over ``max(temperature, 1e-6)``, the top-k and
    top-p masks at ``-inf``, plus the row's Gumbel noise under its key of
    ``keys`` (B, 2). The top-2 gap of a row says how far its draw is from
    a tie. ``temperature``, ``top_k`` and ``top_p`` are (B,) or
    scalars."""
    b, dev = logits.shape[0], logits.device
    scaled = _filtered(logits, _per_row(temperature, torch.float32, b, dev),
                       _per_row(top_k, torch.int64, b, dev),
                       _per_row(top_p, torch.float32, b, dev))
    return gumbel(keys.to(dev), logits.shape[-1]) + scaled


def sample(logits: torch.Tensor, keys: torch.Tensor, temperature,
           top_k, top_p) -> torch.Tensor:
    """One token id a row of ``logits`` (B, V) (or one (V,) vector), the
    reference's ``sample`` row by row: the logits over
    ``max(temperature, 1e-6)`` in float32, the top-k and top-p masks, then
    ``categorical`` (the argmax of :func:`scores`) under the row's key of
    ``keys`` (B, 2); a row at ``temperature == 0`` returns the exact argmax
    of its raw logits. ``temperature``, ``top_k`` and ``top_p`` are (B,)
    tensors or scalars. Every row is computed alone, so a row's token never
    depends on its neighbours' values. Returns (B,) int32 (a 0-d tensor
    for a vector)."""
    one = logits.dim() == 1
    if one:
        logits, keys = logits[None], keys.reshape(1, 2)
    temperature = _per_row(temperature, torch.float32, logits.shape[0],
                           logits.device)
    sampled = torch.argmax(scores(logits, keys, temperature, top_k, top_p),
                           -1).to(torch.int32)
    out = torch.where(temperature > 0.0, sampled, greedy(logits))
    return out[0] if one else out


def draw(logits: torch.Tensor, keys: torch.Tensor, emit, temperature, top_k,
         top_p) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch's tokens and carried keys, as the reference's step
    functions draw them: each lane's key splits once, row 1 samples the
    lane's token from ``logits`` (B, V) (:func:`sample`) and row 0 is kept
    where ``emit`` (B,) is set. ``emit``, ``temperature``, ``top_k`` and
    ``top_p`` are host arrays; ``keys`` (B, 2) may live on the host, where
    the split then runs (it depends on nothing the device computes). A
    launch without a sampled lane takes the argmax alone, which is what
    :func:`sample` gives at temperature 0. Returns ``(tokens (B,) int32 on
    the logits' device, keys)``."""
    carry, use = split_keys(keys)
    emit = torch.as_tensor(np.asarray(emit, bool)).to(keys.device)
    keys = torch.where(emit[:, None], carry, keys)
    if not (np.asarray(temperature) > 0).any():
        return greedy(logits), keys
    dev = logits.device

    def put(x):
        return torch.as_tensor(x).to(dev, non_blocking=True)

    return sample(logits, put(use), put(temperature), put(top_k),
                  put(top_p)), keys
