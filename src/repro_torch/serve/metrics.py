"""Latency and goodput accounting for the serve engine.

One :class:`ServeMetrics` per engine absorbs every :class:`Completion` and
keeps the numbers the benchmarks and the bucket tuner consume, in the same
shape as :mod:`repro_torch.core.metrics` (percentile math mirrors ``StepTimer``;
rates come from ``ThroughputCounter``, so ``interval_goodput()`` is the
read-and-reset window metric a :class:`~repro_torch.core.controller.Controller`
can use directly):

* **latency percentiles** — p50/p95/p99 of arrival-to-finish latency over
  a bounded sample window,
* **goodput** — completed tokens *within SLO* per second (the paper-adjacent
  metric: a token that arrives after its deadline is not service),
* **throughput** — all completed tokens per second, SLO or not.

Sample buffers are **reservoirs** (Vitter's algorithm R): a fixed-capacity
uniform sample over every completion ever observed, so a long-lived server
— or a fleet merge over many replicas — never grows the buffers past
``window`` while percentiles stay nearest-rank over an unbiased sample.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Mapping

from repro_torch.core.metrics import ThroughputCounter, nearest_rank
from repro_torch.serve.request import Completion

__all__ = ["ServeMetrics"]

#: Counter fields carried by ``state()`` and summed by ``merge()``.
_COUNTERS = ("completed", "completed_tokens", "goodput_tokens",
             "slo_met", "slo_missed", "shed")


class _Reservoir:
    """Fixed-capacity uniform sample over everything ever offered.

    Below capacity it retains everything (percentiles are then exact);
    past capacity each new value replaces a random retained one with
    probability ``capacity / seen`` (algorithm R), keeping the retained
    set a uniform sample of the full stream.  The RNG is seeded, so a
    replayed stream reproduces the same sample.
    """

    __slots__ = ("capacity", "samples", "seen", "_rng")

    def __init__(self, capacity: int, seed: int = 0x5EED):
        self.capacity = max(1, int(capacity))
        self.samples: list[float] = []
        self.seen = 0
        self._rng = random.Random(seed)

    def add(self, x: float) -> None:
        self.seen += 1
        if len(self.samples) < self.capacity:
            self.samples.append(x)
            return
        j = self._rng.randrange(self.seen)
        if j < self.capacity:
            self.samples[j] = x

    def extend(self, xs) -> None:
        for x in xs:
            self.add(x)

    def load(self, samples, seen=None) -> None:
        """Restore a retained sample (state round-trip / merge), keeping a
        uniform subsample when it exceeds capacity."""
        xs = list(samples)
        if len(xs) > self.capacity:
            xs = self._rng.sample(xs, self.capacity)
        self.samples = xs
        self.seen = max(len(xs),
                        int(seen) if seen is not None else len(xs))

    def list(self) -> list[float]:
        return list(self.samples)

    def __len__(self) -> int:
        return len(self.samples)


class ServeMetrics:
    """Completion accounting: percentiles, counters, goodput windows.

    Completions carrying a ``tenant`` additionally feed a lazily created
    per-tenant child ``ServeMetrics`` (same window), so multi-tenant
    engines get per-tenant goodput/percentile breakdowns from
    :meth:`summary` and tenant-resolved fleet aggregation through
    :meth:`state`/:meth:`merge` without any extra wiring.  ``tenant_slos``
    labels each child with its own SLO for reporting (``within_slo`` is
    decided upstream, per request, by the engine).
    """

    def __init__(self, slo_s: float | None = None, window: int = 2048,
                 clock: Callable[[], float] = time.perf_counter,
                 tenant_slos: "Mapping[str, float] | None" = None):
        self.slo_s = slo_s
        self.window = int(window)
        self.tenant_slos = dict(tenant_slos or {})
        self._tenants: dict[str, "ServeMetrics"] = {}
        self._clock = clock
        self._lock = threading.Lock()
        self._latencies = _Reservoir(window, seed=0x5EED)
        self._queue_delays = _Reservoir(window, seed=0x5EED + 1)
        self._ttfts = _Reservoir(window, seed=0x5EED + 2)
        self.completed = 0
        self.completed_tokens = 0
        self.goodput_tokens = 0      # lifetime tokens of in-SLO completions
        self.slo_met = 0
        self.slo_missed = 0
        self.shed = 0
        #: rate counters (reset-and-read windows, like the runtime's tput)
        self.goodput = ThroughputCounter(clock)     # in-SLO tokens/s
        self.throughput = ThroughputCounter(clock)  # all completed tokens/s

    # -- feeding ---------------------------------------------------------------
    def observe(self, completion: Completion) -> None:
        with self._lock:
            self._latencies.add(completion.latency_s)
            qd = completion.queue_delay_s
            if qd is not None:
                self._queue_delays.add(qd)
            if completion.first_token_t is not None:
                # arrival -> first token: under phased execution this spans
                # queueing plus the whole (chunked) prefill, the latency
                # prefill/decode disaggregation trades against goodput.
                self._ttfts.add(completion.first_token_t
                                - completion.arrival_t)
            self.completed += 1
            self.completed_tokens += completion.tokens
            if completion.within_slo:
                self.slo_met += 1
                self.goodput_tokens += completion.tokens
            else:
                self.slo_missed += 1
        self.throughput.add(completion.tokens)
        if completion.within_slo:
            self.goodput.add(completion.tokens)
        tenant = getattr(completion, "tenant", None)
        if tenant is not None:
            self._tenant_child(tenant).observe(
                dataclasses.replace(completion, tenant=None))

    def _tenant_child(self, tenant: str) -> "ServeMetrics":
        with self._lock:
            child = self._tenants.get(tenant)
            if child is None:
                child = ServeMetrics(
                    slo_s=self.tenant_slos.get(tenant, self.slo_s),
                    window=self.window, clock=self._clock)
                self._tenants[tenant] = child
        return child

    def observe_shed(self, n: int = 1, tenant: str | None = None) -> None:
        with self._lock:
            self.shed += n
        if tenant is not None:
            self._tenant_child(tenant).observe_shed(n)

    def tenants(self) -> dict[str, "ServeMetrics"]:
        """Snapshot of the per-tenant children (shared references)."""
        with self._lock:
            return dict(self._tenants)

    # -- reading ---------------------------------------------------------------
    def percentile(self, p: float) -> float:
        """Latency percentile in seconds over the sample window (NaN when
        empty) — the shared nearest-rank convention
        (:func:`repro_torch.core.metrics.nearest_rank`)."""
        with self._lock:
            xs = self._latencies.list()
        return nearest_rank(xs, p)

    def interval_goodput(self) -> float:
        """In-SLO tokens/s since the previous call (read-and-reset): the
        per-dwell window metric the bucket tuner's Controller observes."""
        rate = self.goodput.read()
        self.goodput.reset()
        return rate

    def ttft_percentile(self, p: float) -> float:
        """Time-to-first-token percentile in seconds (NaN when empty)."""
        with self._lock:
            xs = self._ttfts.list()
        return nearest_rank(xs, p)

    # -- fleet aggregation -----------------------------------------------------
    def state(self) -> dict:
        """Portable snapshot: sample windows plus lifetime counters — the
        wire format a fleet replica ships to the router front so
        :meth:`merge` can aggregate across processes.

        ``window`` travels on the wire so a merge of replicas running
        bigger-than-default reservoirs is not silently subsampled back to
        2048, and per-tenant children travel under ``tenants``."""
        with self._lock:
            out = {
                "slo_s": self.slo_s,
                "window": self.window,
                "latencies": self._latencies.list(),
                "latencies_seen": self._latencies.seen,
                "queue_delays": self._queue_delays.list(),
                "queue_delays_seen": self._queue_delays.seen,
                "ttfts": self._ttfts.list(),
                "ttfts_seen": self._ttfts.seen,
                **{f: getattr(self, f) for f in _COUNTERS},
            }
            tenants = dict(self._tenants)
        if tenants:
            out["tenants"] = {t: child.state()
                              for t, child in sorted(tenants.items())}
        return out

    @classmethod
    def from_state(cls, state: Mapping, window: int | None = None,
                   clock: Callable[[], float] = time.perf_counter
                   ) -> "ServeMetrics":
        """Rebuild a :class:`ServeMetrics` from a :meth:`state` snapshot
        (rate counters restart — only samples and counters travel).  The
        rebuilt buffers stay bounded at ``window`` even when the snapshot
        carries more samples (a fleet merge): a uniform subsample is kept.
        Snapshots without ``*_seen`` or ``window`` fields (older wire
        formats) are accepted — ``seen`` then defaults to the sample
        count and ``window`` to the 2048 default."""
        if window is None:
            window = int(state.get("window", 2048))
        m = cls(slo_s=state.get("slo_s"), window=window, clock=clock)
        for field, res in (("latencies", m._latencies),
                           ("queue_delays", m._queue_delays),
                           ("ttfts", m._ttfts)):
            res.load(state.get(field, ()), seen=state.get(f"{field}_seen"))
        for f in _COUNTERS:
            setattr(m, f, int(state.get(f, 0)))
        for t, sub in (state.get("tenants") or {}).items():
            m._tenants[t] = cls.from_state(sub, clock=clock)
        return m

    @classmethod
    def merge(cls, *others: "ServeMetrics | Mapping") -> "ServeMetrics":
        """Fleet-level aggregate of per-replica metrics: counters are
        summed and percentiles are nearest-rank over the *combined* sample
        windows (not an average of per-replica percentiles, which has no
        rank semantics).  Accepts live :class:`ServeMetrics` instances or
        :meth:`state` snapshots interchangeably; ``slo_s`` survives only
        when every input agrees on it.  The merged reservoir ``window``
        is the max across inputs (a replica that sampled at 8192 is not
        squeezed back through a 2048 default), and per-tenant breakdowns
        merge tenant-by-tenant."""
        states = [m.state() if isinstance(m, ServeMetrics) else dict(m)
                  for m in others]
        slos = {s.get("slo_s") for s in states}
        merged: dict = {
            "slo_s": slos.pop() if len(slos) == 1 else None,
            "window": max((int(s.get("window", 2048)) for s in states),
                          default=2048),
            "latencies": [], "queue_delays": [], "ttfts": [],
            **{f: 0 for f in _COUNTERS},
        }
        for s in states:
            for samples in ("latencies", "queue_delays", "ttfts"):
                merged[samples].extend(s.get(samples, ()))
                merged[f"{samples}_seen"] = (
                    merged.get(f"{samples}_seen", 0)
                    + int(s.get(f"{samples}_seen", len(s.get(samples, ())))))
            for f in _COUNTERS:
                merged[f] += int(s.get(f, 0))
        by_tenant: dict[str, list] = {}
        for s in states:
            for t, sub in (s.get("tenants") or {}).items():
                by_tenant.setdefault(t, []).append(sub)
        if by_tenant:
            merged["tenants"] = {t: cls.merge(*subs).state()
                                 for t, subs in sorted(by_tenant.items())}
        return cls.from_state(merged)

    def summary(self) -> dict:
        with self._lock:
            n = len(self._latencies)
            n_ttft = len(self._ttfts)
            completed = self.completed
            tokens = self.completed_tokens
            good = self.goodput_tokens
            met, missed, shed = self.slo_met, self.slo_missed, self.shed
        with self._lock:
            tenants = dict(self._tenants)
        out = {
            "completed": completed,
            "completed_tokens": tokens,
            "goodput_tokens": good,
            "slo_met": met,
            "slo_missed": missed,
            "shed": shed,
            "slo_s": self.slo_s,
            "latency_window": n,
            "latency_seen": self._latencies.seen,
            "latency_p50_ms": round(self.percentile(50) * 1e3, 3)
            if n else None,
            "latency_p95_ms": round(self.percentile(95) * 1e3, 3)
            if n else None,
            "latency_p99_ms": round(self.percentile(99) * 1e3, 3)
            if n else None,
            "ttft_p50_ms": round(self.ttft_percentile(50) * 1e3, 3)
            if n_ttft else None,
            "ttft_p95_ms": round(self.ttft_percentile(95) * 1e3, 3)
            if n_ttft else None,
        }
        if tenants:
            out["tenants"] = {t: child.summary()
                              for t, child in sorted(tenants.items())}
        return out
