"""Pluggable scheduling policies: which waiting requests join the batch.

A scheduler is an ordering over the admission queue — ``key(now, slo_s)``
returns the sort key :meth:`AdmissionQueue.take` uses to pick the next
joiners.  Three classic policies ship:

* :class:`FCFS`             — arrival order (the fairness baseline),
* :class:`ShortestJobFirst` — fewest remaining decode tokens first
  (minimizes mean latency; can starve long jobs under overload),
* :class:`DeadlineAware`    — earliest absolute deadline first (EDF:
  the SLO-aware policy; requests without a deadline sort last),
* :class:`DeficitRoundRobin` — weighted-fair service *across tenants*
  (DRR): one greedy tenant cannot starve another's SLO.

All keys tie-break by arrival time then request id, so the order is total
and deterministic.

A scheduler may additionally implement the **tenant-service protocol**
(``pick(runnable)`` / ``charge(tenant, tokens)``): the multi-tenant
batcher asks ``pick`` which tenant the next step serves, and the engine
``charge``\\ s the picked tenant for the tokens it actually produced.
Schedulers without the protocol still work with tenants — the batcher
then serves whichever tenant owns the globally best-ranked request
(plain FCFS across tenants, with its starvation behavior intact).
"""
from __future__ import annotations

from typing import Callable, Iterable, Mapping

from repro_torch.serve.request import Request

__all__ = ["Scheduler", "FCFS", "ShortestJobFirst", "DeadlineAware",
           "DeficitRoundRobin", "make_scheduler", "SCHEDULERS"]


class Scheduler:
    """Ordering policy protocol; subclasses implement :meth:`key`."""

    name = "base"

    def key(self, now: float,
            slo_s: float | None = None) -> Callable[[Request], tuple]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class FCFS(Scheduler):
    name = "fcfs"

    def key(self, now, slo_s=None):
        return lambda r: (r.arrival_t if r.arrival_t is not None else now,
                          r.rid)


class ShortestJobFirst(Scheduler):
    """Smallest remaining work first: remaining prefill + remaining decode
    (``Request.remaining_work``).  Under chunked prefill the prompt is real
    step cost, not a fixed admission toll, so a 2048-token prompt with a
    4-token budget is a *long* job — ranking by decode budget alone would
    wrongly jump it ahead of a 16-token prompt wanting 32 tokens."""

    name = "sjf"

    def key(self, now, slo_s=None):
        return lambda r: (r.remaining_work,
                          r.arrival_t if r.arrival_t is not None else now,
                          r.rid)


class DeadlineAware(Scheduler):
    """Earliest-deadline-first over each request's absolute deadline
    (its own ``deadline_s``, else the engine-wide SLO).  Equal deadlines
    break toward smaller remaining work — among requests equally urgent,
    finishing the cheap one first loses less of the other's slack."""

    name = "deadline"

    def key(self, now, slo_s=None):
        return lambda r: (r.deadline_t(slo_s), r.remaining_work,
                          r.arrival_t if r.arrival_t is not None else now,
                          r.rid)


class DeficitRoundRobin(Scheduler):
    """Weighted-fair tenant service via Deficit Round Robin.

    Each tenant carries a **deficit counter** in token units.  Every time
    the batcher asks :meth:`pick` which tenant the next step serves, all
    *runnable* tenants (active rows or queued backlog) are replenished by
    ``quantum * weight`` and the richest one is served; the engine then
    :meth:`charge`\\ s it for the tokens the step actually produced.  Over
    any busy interval each tenant's service share converges to its weight
    share, regardless of how much traffic the others pour in — the
    classic DRR isolation guarantee, with tokens standing in for bytes.

    Credit is clamped to ``burst_rounds`` quanta on both sides: an idle
    tenant cannot bank unbounded credit and then monopolize the engine
    (positive cap), and a tenant that just served a huge burst is not
    locked out forever (negative cap).  Tenants absent from ``weights``
    get weight 1.0, so the scheduler needs no up-front roster.

    Within the picked tenant, requests join in arrival order
    (:meth:`key` is FCFS) — DRR decides *who* is served, not *which* of
    their requests goes first.
    """

    name = "drr"

    def __init__(self, weights: Mapping[str, float] | None = None,
                 quantum: int = 32, burst_rounds: int = 4):
        if quantum <= 0:
            raise ValueError(f"quantum must be positive, got {quantum}")
        if burst_rounds <= 0:
            raise ValueError(
                f"burst_rounds must be positive, got {burst_rounds}")
        self.weights = {str(k): float(v)
                        for k, v in dict(weights or {}).items()}
        for name, w in self.weights.items():
            if w <= 0:
                raise ValueError(
                    f"tenant {name!r} has non-positive weight {w}")
        self.quantum = int(quantum)
        self.burst_rounds = int(burst_rounds)
        self.deficit: dict = {}
        self.picks: dict = {}        # tenant -> times served (telemetry)

    def weight(self, tenant) -> float:
        return self.weights.get(tenant, 1.0)

    def _cap(self, tenant) -> float:
        return self.burst_rounds * self.quantum * self.weight(tenant)

    def pick(self, runnable: Iterable):
        """Choose the tenant the next step serves.

        Replenishes every runnable tenant's deficit, zeroes the idle
        ones (an idle tenant banks nothing — DRR's "empty queue resets
        the counter" rule), and returns the richest runnable tenant.
        Deficit ties break toward the tenant with the least weighted
        service so far, then by name — a plain name tie-break would let
        one tenant win every capped-deficit round and starve the rest."""
        tenants = sorted(runnable, key=lambda t: (t is None, str(t)))
        if not tenants:
            raise ValueError("pick() needs at least one runnable tenant")
        live = set(tenants)
        for t in list(self.deficit):
            if t not in live:
                self.deficit[t] = 0.0
        for t in tenants:
            self.deficit[t] = min(
                self.deficit.get(t, 0.0) + self.quantum * self.weight(t),
                self._cap(t))
        best = max(tenants,
                   key=lambda t: (self.deficit[t],
                                  -self.picks.get(t, 0) / self.weight(t),
                                  str(t)))
        self.picks[best] = self.picks.get(best, 0) + 1
        return best

    def charge(self, tenant, tokens: int) -> None:
        """Debit served tokens against the tenant's deficit (floored at
        the negative burst cap so one oversize step cannot lock a tenant
        out indefinitely)."""
        if tokens <= 0:
            return
        self.deficit[tenant] = max(
            self.deficit.get(tenant, 0.0) - float(tokens), -self._cap(tenant))

    def key(self, now, slo_s=None):
        return lambda r: (r.arrival_t if r.arrival_t is not None else now,
                          r.rid)

    def stats(self) -> dict:
        return {"deficit": {str(t): round(d, 3)
                            for t, d in sorted(self.deficit.items(),
                                               key=lambda kv: str(kv[0]))},
                "picks": {str(t): n
                          for t, n in sorted(self.picks.items(),
                                             key=lambda kv: str(kv[0]))},
                "quantum": self.quantum,
                "weights": dict(self.weights)}

    def __repr__(self) -> str:
        return (f"DeficitRoundRobin(weights={self.weights}, "
                f"quantum={self.quantum})")


SCHEDULERS: dict[str, type[Scheduler]] = {
    cls.name: cls
    for cls in (FCFS, ShortestJobFirst, DeadlineAware, DeficitRoundRobin)
}


def make_scheduler(name: str, **kwargs) -> Scheduler:
    """Instantiate a scheduler by CLI name
    (``fcfs``/``sjf``/``deadline``/``drr``).  ``kwargs`` forward to the
    constructor — e.g. ``make_scheduler("drr", weights={...})``."""
    try:
        return SCHEDULERS[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}; expected one of "
                         f"{sorted(SCHEDULERS)}") from None
