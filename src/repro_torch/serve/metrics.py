"""Latency metrics and SLO accounting for open-loop serving simulations.

Port of ``src/repro/serve/metrics.py`` (host-only, the same definitions and
arithmetic, so the port's percentiles and summaries equal the reference's
for the same timestamps). The open-loop harness (:mod:`repro_torch.serve.loadgen` driving
:class:`repro_torch.serve.sim.ClusterSimulator`) measures what a serving system
actually promises its users: not raw throughput, but *latency under load*
and *goodput* — tokens delivered inside each request's service-level
objective. This module is the measurement layer:

* :class:`SLO` — per-request latency targets (attach one to
  ``Request.slo``; the cluster scheduler and this module both read it).
* :func:`percentile` — exact nearest-rank percentiles (no interpolation:
  the reported p99 is a latency some real request actually experienced).
* :func:`request_ttft` / :func:`request_tpot` / :func:`met_slo` — pure
  per-request derivations from the engine's timestamps
  (``arrival_time`` → ``first_token_time`` → ``finish_time``).
* :class:`ServeMetrics` — an accumulator over finished requests that
  reports p50/p99 TTFT, p50/p99 per-token latency, SLO attainment, and
  goodput.

Definitions (simulated-clock units throughout):

* **TTFT** (time to first token): ``first_token_time - arrival_time``.
  Measured from *arrival*, not admission — queueing delay under overload
  is the user-visible part.
* **TPOT** (time per output token): ``(finish_time - first_token_time) /
  (n_tokens - 1)`` — the mean inter-token latency after the first token
  (``0.0`` for single-token outputs).
* **SLO attainment**: fraction of finished requests *carrying an SLO*
  that met every target they set (``1.0`` when no request carries one).
* **Goodput**: tokens from SLO-meeting finished requests per unit of
  simulated time (a request without an SLO always counts as good).
  Rejected and shed requests deliver zero tokens, so overload shows up
  as a goodput gap even before latency percentiles are read.

Everything here is pure host arithmetic on journaled timestamps — same
seed, same trace, same metrics, bit-identical.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

__all__ = ["SLO", "ServeMetrics", "met_slo", "percentile", "request_tpot",
           "request_ttft"]


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request latency targets in simulated-clock units.

    ``ttft`` caps the time from arrival to the first generated token;
    ``tpot`` caps the mean per-output-token latency after the first
    token. ``None`` means "don't care" for that component; a request with
    neither set is unconstrained (always counted as meeting its SLO).
    """

    ttft: float | None = None
    tpot: float | None = None

    def __post_init__(self):
        for name, v in (("ttft", self.ttft), ("tpot", self.tpot)):
            if v is not None and v <= 0:
                raise ValueError(f"SLO {name} must be positive, got {v}")

    def deadline(self, arrival_time: float, max_new_tokens: int) -> float:
        """Latest finish time at which the request can still meet every
        target it set: ``arrival + ttft + tpot * (max_new_tokens - 1)``
        (unset components contribute nothing; ``inf`` when neither is
        set). The cluster's preemption policy compares the clock against
        this to spot requests that are already doomed."""
        if self.ttft is None and self.tpot is None:
            return math.inf
        t = arrival_time
        if self.ttft is not None:
            t += self.ttft
        if self.tpot is not None:
            t += self.tpot * max(0, max_new_tokens - 1)
        return t


def percentile(values: Sequence[float], q: float) -> float:
    """Exact nearest-rank percentile: the smallest element such that at
    least ``q`` percent of the data is ≤ it. No interpolation — the
    returned p99 is a latency some request actually experienced. Raises
    on an empty sequence (an empty p99 is a harness bug, not a 0.0)."""
    if not values:
        raise ValueError("percentile of an empty sequence")
    if not 0 < q <= 100:
        raise ValueError(f"q must be in (0, 100], got {q}")
    xs = sorted(values)
    k = max(0, math.ceil(q / 100 * len(xs)) - 1)
    return float(xs[k])


def request_ttft(request) -> float:
    """Time to first token of a finished request (arrival → first
    generated token). Raises if the engine's timestamps are missing —
    an unfinished request has no TTFT to report."""
    if request.arrival_time is None or request.first_token_time is None:
        raise ValueError(f"request {request.id!r} has no TTFT timestamps")
    return request.first_token_time - request.arrival_time


def request_tpot(request) -> float:
    """Mean per-output-token latency after the first token of a finished
    request (``0.0`` for single-token outputs)."""
    n = len(request.tokens)
    if n <= 1:
        return 0.0
    if request.finish_time is None or request.first_token_time is None:
        raise ValueError(f"request {request.id!r} has no TPOT timestamps")
    return (request.finish_time - request.first_token_time) / (n - 1)


def met_slo(request) -> bool:
    """True when a finished request met every target of its ``slo``
    (requests without an SLO trivially meet it)."""
    slo = getattr(request, "slo", None)
    if slo is None:
        return True
    if slo.ttft is not None and request_ttft(request) > slo.ttft:
        return False
    if slo.tpot is not None and request_tpot(request) > slo.tpot:
        return False
    return True


class ServeMetrics:
    """Accumulate per-request latency observations into one report.

    Feed every finished request through :meth:`observe` (or a batch via
    :meth:`observe_all`), then read :meth:`summary`. The accumulator keeps
    the full TTFT/TPOT samples so the percentiles are exact, and the
    per-request derivations live in the module-level functions — the
    collector adds no statistics of its own.
    """

    def __init__(self):
        self.ttfts: list[float] = []
        self.tpots: list[float] = []
        self.energies: list[float] = []       # per-request attributed µJ
        self.good_tokens = 0
        self.total_tokens = 0
        self.slo_met = 0
        self.slo_total = 0

    def observe(self, request) -> None:
        """Record one finished request (its ``arrival_time`` /
        ``first_token_time`` / ``finish_time`` stamps must be set by the
        engine). A metered engine's ``energy_uj`` attribution is picked
        up automatically; unmetered runs contribute zeros and the energy
        summary fields stay absent."""
        self.ttfts.append(request_ttft(request))
        self.tpots.append(request_tpot(request))
        self.energies.append(float(getattr(request, "energy_uj", 0.0)))
        n = len(request.tokens)
        self.total_tokens += n
        ok = met_slo(request)
        if getattr(request, "slo", None) is not None:
            self.slo_total += 1
            self.slo_met += int(ok)
        if ok:
            self.good_tokens += n

    def observe_all(self, requests: Iterable) -> None:
        """Record a batch of finished requests."""
        for req in requests:
            self.observe(req)

    @property
    def count(self) -> int:
        """Finished requests observed so far."""
        return len(self.ttfts)

    def attainment(self) -> float:
        """Fraction of SLO-carrying finished requests that met their SLO
        (``1.0`` when none carried one)."""
        return self.slo_met / self.slo_total if self.slo_total else 1.0

    def summary(self, elapsed: float | None = None) -> dict:
        """One flat dict of the headline numbers: exact p50/p99 (and
        mean) TTFT, p50/p99 per-token latency, SLO attainment, and
        good/total token counts. Pass the run's simulated ``elapsed`` to
        additionally get ``goodput``/``throughput`` rates. Metered runs
        (any nonzero ``Request.energy_uj``) add per-request energy
        percentiles plus ``uj_per_token`` / ``tokens_per_joule`` —
        the serving rendition of the paper's Fig. 6 energy framing."""
        out = {
            "completed": self.count,
            "slo_requests": self.slo_total,
            "slo_attainment": self.attainment(),
            "good_tokens": self.good_tokens,
            "total_tokens": self.total_tokens,
        }
        if self.ttfts:
            out.update(
                ttft_p50=percentile(self.ttfts, 50),
                ttft_p99=percentile(self.ttfts, 99),
                ttft_mean=sum(self.ttfts) / len(self.ttfts),
                tpot_p50=percentile(self.tpots, 50),
                tpot_p99=percentile(self.tpots, 99),
            )
        total_uj = sum(self.energies)
        if total_uj > 0:
            out.update(
                energy_uj_p50=percentile(self.energies, 50),
                energy_uj_p99=percentile(self.energies, 99),
                energy_uj_total=total_uj,
            )
            if self.total_tokens:
                out["uj_per_token"] = total_uj / self.total_tokens
                out["tokens_per_joule"] = self.total_tokens / (total_uj * 1e-6)
        if elapsed:
            out["goodput"] = self.good_tokens / elapsed
            out["throughput"] = self.total_tokens / elapsed
        return out
