"""Admission queue with backpressure, plus open-loop arrival support.

The queue is the boundary between clients and the serve loop: ``submit``
stamps arrival time and applies the backpressure policy when the bounded
depth is hit (``reject`` refuses the newcomer; ``shed-oldest`` drops the
longest-waiting request to admit it — the classic tail-drop vs head-drop
choice).  ``take`` hands the scheduler-ordered head of the queue to the
batcher.  All operations are thread-safe: clients may submit from other
threads while the engine loop drains.

Open-loop arrivals (the evaluation mode the companion papers call for:
arrival times are *exogenous*, they do not wait on service) are driven by
:class:`OpenLoopSource` — a pre-computed ``(arrival_offset, Request)``
schedule pumped against the wall clock each engine iteration.
:func:`pseudo_poisson_times` builds the deterministic pseudo-Poisson
schedule (seeded exponential interarrivals, piecewise-constant rate ramp)
the serve benchmark replays identically for every engine configuration.
"""
from __future__ import annotations

import collections
import hashlib
import logging
import random
import threading
import time
from typing import Callable, Iterable, Sequence

from repro_torch.serve.request import Request

logger = logging.getLogger("repro_torch.serve.queue")

__all__ = ["AdmissionQueue", "OpenLoopSource", "pseudo_poisson_times",
           "substream_seed"]

#: Backpressure policies: refuse the newcomer, or drop the oldest waiter.
_POLICIES = ("reject", "shed-oldest")


class AdmissionQueue:
    """Thread-safe bounded admission queue.

    ``depth=None`` means unbounded (no backpressure).  ``on_shed(request)``
    is invoked for every request the queue drops (rejected newcomers and
    shed waiters alike) — exceptions it raises are counted
    (``shed_errors``) and swallowed, never propagated into the submit path.
    """

    def __init__(self, depth: int | None = None, policy: str = "reject",
                 clock: Callable[[], float] = time.perf_counter,
                 on_shed: Callable[[Request], None] | None = None):
        if policy not in _POLICIES:
            raise ValueError(f"unknown backpressure policy {policy!r}; "
                             f"expected one of {_POLICIES}")
        if depth is not None and depth <= 0:
            raise ValueError(f"queue depth must be positive, got {depth!r}")
        self.depth = depth
        self.policy = policy
        self.clock = clock
        self.on_shed = on_shed
        self._lock = threading.Lock()
        self._waiting: collections.deque[Request] = collections.deque()
        self._closed = False
        # plain ints, mutated under the lock
        self.submitted = 0
        self.accepted = 0
        self.rejected = 0
        self.shed = 0
        self.shed_errors = 0

    # -- client side -----------------------------------------------------------
    def submit(self, request: Request) -> bool:
        """Offer a request; returns False when backpressure refused it."""
        now = self.clock()
        dropped: Request | None = None
        with self._lock:
            self.submitted += 1
            if self._closed:
                self.rejected += 1
                dropped = request
            elif self.depth is not None and len(self._waiting) >= self.depth:
                if self.policy == "reject":
                    self.rejected += 1
                    dropped = request
                else:                           # shed-oldest: head-drop
                    dropped = self._waiting.popleft()
                    self.shed += 1
                    request.arrival_t = now
                    self._waiting.append(request)
                    self.accepted += 1
            else:
                request.arrival_t = now
                self._waiting.append(request)
                self.accepted += 1
        if dropped is not None:
            self._note_shed(dropped)
        return dropped is not request

    def _note_shed(self, request: Request) -> None:
        request.shed = True
        if self.on_shed is None:
            return
        try:
            self.on_shed(request)
        except Exception as e:
            with self._lock:
                self.shed_errors += 1
            logger.warning("on_shed callback failed for %r (%s: %s)",
                           request, type(e).__name__, e)

    def close(self) -> None:
        """Stop admitting; subsequent submits are rejected."""
        with self._lock:
            self._closed = True

    # -- engine side -----------------------------------------------------------
    def take(self, n: int,
             key: Callable[[Request], object] | None = None,
             where: Callable[[Request], bool] | None = None) -> list[Request]:
        """Pop up to ``n`` waiting requests, smallest ``key`` first
        (``None`` = FIFO).  ``where`` restricts eligibility (the
        multi-tenant batcher serves one tenant per step and must leave
        other tenants' requests queued).  The remainder keeps its
        *arrival* order — the shed-oldest policy's head-drop must keep
        meaning "longest waiting", not "whatever the last scheduler sort
        left in front"."""
        if n <= 0:
            return []
        with self._lock:
            if not self._waiting:
                return []
            pool = self._waiting if where is None \
                else [r for r in self._waiting if where(r)]
            if not pool:
                return []
            if key is None:
                out = list(pool)[:n]
            else:
                out = sorted(pool, key=key)[:n]
            chosen = {id(r) for r in out}
            self._waiting = collections.deque(
                r for r in self._waiting if id(r) not in chosen)
            return out

    def waiting_tenants(self) -> set:
        """Distinct ``tenant`` values across waiting requests (a snapshot:
        what the multi-tenant batcher treats as runnable backlog)."""
        with self._lock:
            return {r.tenant for r in self._waiting}

    def peek_tenant(self, tenant) -> list[Request]:
        """Snapshot of one tenant's waiting requests (not removed) — lets
        a scheduler without the tenant-service protocol rank an all-queued
        tenant against tenants with rows in flight."""
        with self._lock:
            return [r for r in self._waiting if r.tenant == tenant]

    def flush(self) -> list[Request]:
        """Drop every waiting request (drain timeout); returns them."""
        with self._lock:
            out = list(self._waiting)
            self._waiting.clear()
            self.shed += len(out)
        for req in out:
            self._note_shed(req)
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._waiting)

    def stats(self) -> dict:
        with self._lock:
            return {
                "waiting": len(self._waiting),
                "depth": self.depth,
                "policy": self.policy,
                "submitted": self.submitted,
                "accepted": self.accepted,
                "rejected": self.rejected,
                "shed": self.shed,
                "shed_errors": self.shed_errors,
            }


def pseudo_poisson_times(phases: Sequence[tuple[float, float]],
                         seed: int = 0) -> list[float]:
    """Deterministic pseudo-Poisson arrival offsets with a rate ramp.

    ``phases`` is ``[(duration_s, rate_per_s), ...]`` — interarrival gaps
    within a phase are seeded exponential draws at that phase's rate, so
    replaying the same seed gives every engine configuration the *same*
    arrival process (open-loop comparisons stay apples-to-apples).

    Each phase restarts the exponential clock at its own boundary: the
    Poisson process is memoryless, so the overshoot drawn at the previous
    phase's rate is discarded rather than carried across (carrying it
    biases every phase's first interarrival toward the *old* rate — a
    slow->fast ramp would chronically under-deliver the burst's head).
    """
    rng = random.Random(seed)
    out: list[float] = []
    phase_start = 0.0
    for duration, rate in phases:
        phase_end = phase_start + duration
        if rate > 0:
            t = phase_start
            while True:
                t += rng.expovariate(rate)
                if t >= phase_end:
                    break
                out.append(t)
        phase_start = phase_end
    return out


def substream_seed(root_seed: int, replica_id: int | str) -> int:
    """Per-replica seed substream derived from one root seed.

    A fleet of N replicas fed from the same ``--seed`` must not replay
    byte-identical arrival schedules — that would synchronize every
    replica's bursts and make "N replicas" indistinguishable from one
    replica at N× rate.  Hashing ``(root_seed, replica_id)`` gives each
    replica an independent-looking but fully deterministic substream:
    the same pair always yields the same seed, different replicas yield
    different seeds, and no two substreams share RNG state.
    """
    digest = hashlib.sha256(f"{root_seed}:{replica_id}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


class OpenLoopSource:
    """Replays a pre-built ``(arrival_offset_s, Request)`` schedule against
    the wall clock: each ``pump(now)`` submits every request whose offset
    has elapsed, whether or not the queue kept up (that is what makes the
    load open-loop).  Refused submits are the queue's problem — the source
    never retries.

    ``queue`` is anything with ``submit(request) -> bool`` — an
    :class:`AdmissionQueue`, or a fleet front like
    :class:`~repro_torch.serve.fleet.ReplicaRouter` that spreads the same
    open-loop schedule across replicas."""

    def __init__(self, queue: AdmissionQueue,
                 schedule: Iterable[tuple[float, Request]],
                 start_t: float | None = None):
        self.queue = queue
        self._pending = collections.deque(
            sorted(schedule, key=lambda tr: tr[0]))
        self.start_t = start_t          # set on first pump when None
        self.offered = 0

    def pump(self, now: float) -> int:
        """Submit all requests due by ``now``; returns how many."""
        if self.start_t is None:
            self.start_t = now
        n = 0
        while self._pending and \
                self.start_t + self._pending[0][0] <= now:
            _, req = self._pending.popleft()
            self.queue.submit(req)
            self.offered += 1
            n += 1
        return n

    @property
    def exhausted(self) -> bool:
        return not self._pending

    def next_due(self, now: float) -> float | None:
        """Seconds until the next arrival (None when exhausted)."""
        if not self._pending:
            return None
        start = self.start_t if self.start_t is not None else now
        return max(0.0, start + self._pending[0][0] - now)
