"""Open-loop, trace-driven load generation for the serving simulator.

Port of ``src/repro/serve/loadgen.py`` (host-only): the same seeded,
string-keyed ``random.Random`` streams drawn in the same order, so for the
same arguments the port's arrivals equal the reference's field for field.
The scripted traces in :mod:`repro_torch.serve.sim` are *closed-loop-ish*: a
handful of hand-placed arrivals sized to the engine under test. Real
traffic is **open-loop** — users arrive according to their own process and
do not wait for the system to have capacity, so when offered load exceeds
capacity, queues genuinely build, latency rises, and admission control has
to shed work. This module generates such traffic at 10⁵–10⁶ request
scale, *lazily* (a generator of :class:`~repro_torch.serve.sim.Arrival`, never a
materialised list) and *deterministically* (one seeded ``random.Random``
per stream; string-seeded, so the sequence is stable across processes and
platforms — same seed ⇒ bit-identical trace).

Three arrival processes:

* :func:`poisson_times` — homogeneous Poisson (i.i.d. exponential gaps):
  the memoryless baseline.
* :func:`bursty_times` — compound Poisson: burst *events* arrive at rate
  ``rate / burst`` and each releases ~``burst`` same-instant requests.
  The mean rate matches the Poisson stream but the instantaneous rate
  spikes — the workload that hammers queue capacity and cold-prefill
  dedup (many identical prefixes arriving in one burst).
* :func:`diurnal_times` — nonhomogeneous Poisson with sinusoidal
  intensity ``rate·(1 + amplitude·sin(2πt/period))`` via Lewis–Shedler
  thinning: the day/night load curve, for testing schedulers across
  under- and over-provisioned phases of one trace.

The request *mix* is a list of :class:`TenantSpec` — each tenant routes
to one cluster engine with a relative traffic ``share``, draws prompt and
output lengths uniformly from its own ranges, optionally prepends a
shared per-tenant prompt prefix (the prefix-cache workload; two tenants
with the same ``prefix_seed`` and ``prefix_len`` share tokens, which is
how replicas of one model exercise cross-engine prefix sharing), and
optionally attaches an :class:`~repro_torch.serve.metrics.SLO` for the
SLO-aware scheduler and the goodput accounting to read.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Iterator, Sequence

from repro_torch.serve.engine import Request
from repro_torch.serve.metrics import SLO
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.sim import Arrival

__all__ = ["TenantSpec", "bursty_times", "diurnal_times", "open_loop_trace",
           "poisson_times"]

ARRIVAL_PROCESSES = ("poisson", "bursty", "diurnal")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's slice of an open-loop workload mix.

    ``engine`` is the cluster engine name the tenant's requests route to;
    ``share`` its relative weight in the mix. ``prompt_len`` and
    ``new_tokens`` are inclusive uniform ranges. The first
    ``prefix_len`` prompt tokens are a fixed per-``prefix_seed`` sequence
    (clamped to leave at least one fresh prompt token), so requests of
    one tenant — and of any tenant sharing the same ``prefix_seed`` —
    hit the prefix cache. ``slo`` (optional) rides on every generated
    request as ``Request.slo``. ``sampling`` (optional) turns the
    tenant's traffic stochastic: each generated request carries a copy of
    the :class:`~repro_torch.serve.sampling.SamplingParams` with a fresh
    per-request ``seed`` drawn from the trace's mix RNG — deterministic
    per trace seed, distinct per request, and drawn *only* for sampling
    tenants, so a purely greedy trace consumes no seed draws.
    ``energy_cap_uj_per_token`` (optional) rides on every generated
    request as ``Request.energy_cap_uj_per_token`` — the energy-aware
    admission policy sheds the tenant's traffic when the target engine's
    projected marginal joules/token exceeds it.
    """

    engine: str
    share: float = 1.0
    prompt_len: tuple[int, int] = (4, 24)
    new_tokens: tuple[int, int] = (2, 12)
    prefix_len: int = 0
    prefix_seed: int = 0
    slo: SLO | None = None
    vocab: int = 240
    sampling: SamplingParams | None = None
    energy_cap_uj_per_token: float | None = None

    def __post_init__(self):
        if self.share <= 0:
            raise ValueError("tenant share must be positive")
        if (self.energy_cap_uj_per_token is not None
                and self.energy_cap_uj_per_token <= 0):
            raise ValueError("energy_cap_uj_per_token must be positive")
        for name, (lo, hi) in (("prompt_len", self.prompt_len),
                               ("new_tokens", self.new_tokens)):
            if lo < 1 or hi < lo:
                raise ValueError(f"{name} range must satisfy 1 <= lo <= hi, "
                                 f"got ({lo}, {hi})")
        if self.prefix_len < 0:
            raise ValueError("prefix_len cannot be negative")
        if self.vocab < 2:
            raise ValueError("vocab must be >= 2")

    def prefix_tokens(self) -> tuple[int, ...]:
        """The tenant's fixed shared-prefix tokens (deterministic in
        ``prefix_seed``; equal seeds ⇒ equal tokens, the cross-tenant
        sharing contract)."""
        return tuple((29 * self.prefix_seed + 13 * j) % self.vocab + 1
                     for j in range(self.prefix_len))


def poisson_times(rate: float, *, seed, start: float = 0.0) -> Iterator[float]:
    """Homogeneous Poisson arrival times (exponential inter-arrival
    gaps), yielded lazily and forever — slice what you need."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    rng = random.Random(f"{seed}-poisson")
    t = start
    while True:
        t += rng.expovariate(rate)
        yield t


def bursty_times(rate: float, *, seed, burst: int = 8,
                 start: float = 0.0) -> Iterator[float]:
    """Compound-Poisson bursts: events at rate ``rate / burst``, each
    releasing ``1..2·burst-1`` same-instant arrivals (mean ``burst``), so
    the long-run mean rate is ``rate`` while the instantaneous rate
    spikes — the queue-building, dedup-hammering workload."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    if burst < 1:
        raise ValueError("burst must be >= 1")
    rng = random.Random(f"{seed}-bursty")
    t = start
    while True:
        t += rng.expovariate(rate / burst)
        for _ in range(rng.randint(1, 2 * burst - 1)):
            yield t


def diurnal_times(rate: float, *, seed, period: float = 200.0,
                  amplitude: float = 0.8,
                  start: float = 0.0) -> Iterator[float]:
    """Nonhomogeneous Poisson with intensity ``rate·(1 +
    amplitude·sin(2πt/period))`` via Lewis–Shedler thinning (candidates
    at the peak rate, accepted with probability ``λ(t)/λ_peak``) — the
    day/night curve. Deterministic for a fixed seed."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError("amplitude must be in [0, 1]")
    if period <= 0:
        raise ValueError("period must be positive")
    rng = random.Random(f"{seed}-diurnal")
    peak = rate * (1.0 + amplitude)
    t = start
    while True:
        t += rng.expovariate(peak)
        lam = rate * (1.0 + amplitude * math.sin(2 * math.pi * t / period))
        if rng.random() * peak <= lam:
            yield t


def open_loop_trace(tenants: Sequence[TenantSpec], *, n_requests: int,
                    rate: float, seed=0, process: str = "poisson",
                    burst: int = 8, period: float = 200.0,
                    amplitude: float = 0.8,
                    start: float = 0.0) -> Iterator[Arrival]:
    """Lazily generate ``n_requests`` open-loop arrivals over a tenant mix.

    Yields time-ordered, engine-tagged :class:`~repro_torch.serve.sim.Arrival`
    objects one at a time — 10⁶ requests cost no memory beyond the ones
    currently in flight. ``rate`` is the aggregate mean arrival rate (all
    tenants combined) fed to the chosen arrival ``process`` (``"poisson"``,
    ``"bursty"``, or ``"diurnal"``); each arrival then draws its tenant by
    ``share`` and its lengths from that tenant's ranges, all from one
    seeded RNG.

    Deterministic: a fixed ``(tenants, kwargs)`` pair yields a
    bit-identical stream on every call. :class:`Request` objects are
    engine-mutated, so to drive two identical runs call this twice — never
    replay one trace's request objects.
    """
    tenants = tuple(tenants)
    if not tenants:
        raise ValueError("open_loop_trace needs at least one TenantSpec")
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    if process == "poisson":
        times = poisson_times(rate, seed=seed, start=start)
    elif process == "bursty":
        times = bursty_times(rate, seed=seed, burst=burst, start=start)
    elif process == "diurnal":
        times = diurnal_times(rate, seed=seed, period=period,
                              amplitude=amplitude, start=start)
    else:
        raise ValueError(f"unknown arrival process {process!r} "
                         f"(one of {ARRIVAL_PROCESSES})")
    rng = random.Random(f"{seed}-mix")
    indices = list(range(len(tenants)))
    shares = [t.share for t in tenants]
    prefixes = [t.prefix_tokens() for t in tenants]
    for i in range(n_requests):
        t_arr = next(times)
        k = rng.choices(indices, weights=shares)[0]
        spec = tenants[k]
        plen = rng.randint(*spec.prompt_len)
        ntok = rng.randint(*spec.new_tokens)
        # the final prompt token is always fresh (its logits seed
        # generation), so the shared prefix is clamped to plen - 1
        prefix = prefixes[k][:min(spec.prefix_len, plen - 1)]
        tail = [rng.randint(1, spec.vocab)
                for _ in range(plen - len(prefix))]
        sampling = None
        if spec.sampling is not None:
            # the seed draw happens only for sampling tenants, so a trace
            # with no sampling tenant draws no seeds at all
            sampling = dataclasses.replace(spec.sampling,
                                           seed=rng.getrandbits(31))
        req = Request(id=f"{spec.engine}-{i}",
                      prompt=list(prefix) + tail,
                      max_new_tokens=ntok, slo=spec.slo, sampling=sampling,
                      energy_cap_uj_per_token=spec.energy_cap_uj_per_token)
        yield Arrival(t_arr, req, spec.engine)
