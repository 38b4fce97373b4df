"""End-to-end performance metrics plumbing (paper §3: "overall system
performance metrics ... implicitly factor in any overheads").

The policy compares specialization configurations by a single scalar metric
(throughput by default).  These helpers are what the fixed code uses to
produce that scalar.
"""
from __future__ import annotations

import collections
import itertools
import math
import threading
import time
from typing import Deque

__all__ = ["AtomicCounter", "ThroughputCounter", "ThroughputWindow", "EWMA",
           "ChangeDetector", "StepTimer", "nearest_rank"]


def nearest_rank(samples, p: float) -> float:
    """Nearest-rank percentile ``p`` (0-100) of ``samples``; NaN when
    empty.  The one convention shared by every latency report in this
    repo (``StepTimer``, the serve metrics)."""
    if not samples:
        return math.nan
    xs = sorted(samples)
    idx = min(len(xs) - 1, max(0, int(round(p / 100 * (len(xs) - 1)))))
    return xs[idx]


class AtomicCounter:
    """Lock-free monotonic counter.

    ``itertools.count.__next__`` increments in C, so a ``bump()`` is atomic
    under the GIL without taking a lock — the dispatch fast path and the
    async compile workers can all bump concurrently with no lost updates
    and no contention.  ``value()`` is exact (the count iterator exposes its
    next value through the pickle protocol).
    """

    __slots__ = ("_it",)

    def __init__(self):
        self._it = itertools.count()

    def bump(self) -> int:
        """Increment; returns the pre-increment value (a lock-free ticket)."""
        return next(self._it)

    def value(self) -> int:
        # __reduce__ returns (count, (next_value,)); next_value == #bumps.
        return self._it.__reduce__()[1][0]

    def __int__(self) -> int:
        return self.value()

    def __repr__(self) -> str:
        return f"AtomicCounter({self.value()})"


class ThroughputCounter:
    """Thread-safe event counter -> events/second over a sliding window.

    The fixed code bumps it once per processed request/step/token
    (paper Fig 2b ``tput_counter++``); the policy reads & resets it.
    ``add(1)`` is lock-free (an :class:`AtomicCounter` bump) so it is safe
    on the dispatch fast path; only the rare policy-side ``reset``/``read``
    take the lock.
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._counter = AtomicCounter()
        self._base = 0
        self._start = self._clock()

    def add(self, n: int = 1) -> None:
        self._counter.bump()          # lock-free fast path (n == 1)
        if n != 1:
            with self._lock:          # rare bulk add: O(1) base adjustment
                self._base -= n - 1

    def reset(self) -> None:
        with self._lock:
            self._base = self._counter.value()
            self._start = self._clock()

    def read(self) -> float:
        """Events/sec since last reset."""
        with self._lock:
            dt = self._clock() - self._start
            n = self._counter.value() - self._base
            return n / dt if dt > 0 else 0.0

    def count(self) -> int:
        with self._lock:
            return self._counter.value() - self._base

    def total(self) -> int:
        """Lifetime event count (unaffected by resets)."""
        return self._counter.value()


class ThroughputWindow:
    """Bounded window of per-dwell throughput observations for one
    specialization context.

    The Controller records one observation per dwell window per context
    (``observe(rate)``); readers get the recent-history view (``last()``,
    ``summary()``) that per-context status reporting and stats calls
    consume.  Thread-safe: observations come from the controller thread
    while ``summary()`` may be read by stats calls.
    """

    def __init__(self, maxlen: int = 64, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: Deque[tuple[float, float]] = collections.deque(
            maxlen=maxlen)

    def observe(self, rate: float) -> None:
        with self._lock:
            self._samples.append((self._clock(), float(rate)))

    def last(self) -> float | None:
        with self._lock:
            return self._samples[-1][1] if self._samples else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def summary(self) -> dict:
        with self._lock:
            samples = [r for _, r in self._samples]
        if not samples:
            return {"n": 0, "mean": None, "last": None}
        return {"n": len(samples), "mean": sum(samples) / len(samples),
                "last": samples[-1]}


class EWMA:
    """Exponentially-weighted moving average."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.value: float | None = None

    def update(self, x: float) -> float:
        self.value = x if self.value is None else (
            self.alpha * x + (1 - self.alpha) * self.value)
        return self.value


class ChangeDetector:
    """Detects a "large change" in the observed metric (paper §6.3: the
    FastClick policy "triggers an exploration whenever it detects a large
    change (>= 25%) in the measured throughput").

    Also doubles as straggler/degradation detection at scale: a persistently
    slow step time is indistinguishable from a workload change and triggers
    re-exploration.
    """

    def __init__(self, threshold: float = 0.25, alpha: float = 0.3,
                 warmup: int = 3):
        self.threshold = threshold
        self.ewma = EWMA(alpha)
        self.warmup = warmup
        self._n = 0

    def seed(self, value: float) -> None:
        """Pre-warm the baseline at a known level (e.g. measured during a
        canary) so the very next observation is already change-checked —
        without this, a regression landing inside the warmup window after a
        promotion would silently become the new baseline."""
        self.ewma.value = float(value)
        self._n = self.warmup + 1

    def update(self, metric: float) -> bool:
        """Feed one observation; returns True if a change was detected."""
        prev = self.ewma.value
        self.ewma.update(metric)
        self._n += 1
        if prev is None or self._n <= self.warmup:
            return False
        if prev <= 0:
            return metric > 0
        rel = abs(metric - prev) / prev
        if rel >= self.threshold:
            # restart the baseline at the new level
            self.ewma.value = metric
            self._n = 0
            return True
        return False


class StepTimer:
    """Wall-clock step timer with percentile summary (host side)."""

    def __init__(self, window: int = 256, clock=time.perf_counter):
        self._clock = clock
        self._samples: Deque[float] = collections.deque(maxlen=window)
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc):
        self._samples.append(self._clock() - self._t0)
        self._t0 = None

    def mean(self) -> float:
        return sum(self._samples) / len(self._samples) if self._samples else math.nan

    def percentile(self, p: float) -> float:
        return nearest_rank(self._samples, p)

    def clear(self) -> None:
        self._samples.clear()
