"""ReplicaRouter: an open-loop front that spreads traffic across replicas.

The router duck-types as the ``queue`` of an
:class:`~repro_torch.serve.queue.OpenLoopSource` (it only needs
``submit(request) -> bool``), so the same pre-built pseudo-Poisson
schedule that drives one engine drives a fleet unchanged — the routing
policy decides which replica each due request lands on:

* ``round-robin`` — cycle the replicas; stateless and fair under
  homogeneous load.
* ``jsq`` — join-shortest-queue by each replica's *reported* depth
  (waiting + in-flight; subprocess replicas report depth over their
  stdout protocol, so the number is as fresh as the last report, not
  exact — the classic power-of-reporting tradeoff).
* ``spill`` — deadline-aware: each request gets a round-robin home
  replica and stays there unless the home's reported backlog exceeds
  what the request's deadline can absorb (``depth * est_wait_s`` vs the
  deadline, or a static ``max_depth`` for deadline-less requests), in
  which case it spills to the shortest queue.

A replica is anything with ``submit(request) -> bool`` and
``depth() -> int``: an in-process :class:`LocalReplica` wrapping a
:class:`~repro_torch.serve.engine.ServeEngine`, or the subprocess-backed
:class:`~repro_torch.serve.fleet.worker.SubprocessReplica`.
"""
from __future__ import annotations

import logging
from typing import Callable, Sequence

from repro_torch.serve.request import Request

logger = logging.getLogger("repro_torch.serve.fleet.router")

__all__ = ["ReplicaRouter", "LocalReplica", "RoundRobin",
           "JoinShortestQueue", "DeadlineSpill", "ROUTING_POLICIES",
           "make_routing_policy"]


class LocalReplica:
    """In-process replica: wraps a ServeEngine (tests, single-host fleets)."""

    def __init__(self, engine, name: str = "local"):
        self.engine = engine
        self.name = name

    def submit(self, request: Request) -> bool:
        return self.engine.submit(request)

    def depth(self) -> int:
        return len(self.engine.queue) + len(self.engine.active)


class RoundRobin:
    """Cycle replicas in order."""

    def __init__(self):
        self._i = 0

    def choose(self, request: Request, replicas: Sequence) -> int:
        i = self._i % len(replicas)
        self._i += 1
        return i


class JoinShortestQueue:
    """Pick the replica with the smallest reported depth (ties break to
    the lowest index — deterministic under equal load)."""

    def choose(self, request: Request, replicas: Sequence) -> int:
        return min(range(len(replicas)), key=lambda i: (replicas[i].depth(), i))


class DeadlineSpill:
    """Round-robin home replica with deadline-aware spill.

    The home replica keeps per-replica locality (warm contexts, steady
    bucket shapes); a request only leaves home when home's backlog would
    blow its deadline: ``depth * est_wait_s > margin * deadline_s``.
    Requests without a deadline spill on the static ``max_depth`` bound.
    """

    def __init__(self, est_wait_s: float = 0.05, margin: float = 0.5,
                 max_depth: int = 32):
        self._rr = RoundRobin()
        self.est_wait_s = float(est_wait_s)
        self.margin = float(margin)
        self.max_depth = int(max_depth)
        self.spills = 0

    def _overloaded(self, request: Request, depth: int) -> bool:
        if request.deadline_s is not None:
            return depth * self.est_wait_s > self.margin * request.deadline_s
        return depth > self.max_depth

    def choose(self, request: Request, replicas: Sequence) -> int:
        home = self._rr.choose(request, replicas)
        if not self._overloaded(request, replicas[home].depth()):
            return home
        self.spills += 1
        return min(range(len(replicas)),
                   key=lambda i: (replicas[i].depth(), i))


ROUTING_POLICIES: dict[str, Callable] = {
    "round-robin": RoundRobin,
    "jsq": JoinShortestQueue,
    "spill": DeadlineSpill,
}


def make_routing_policy(name: str, **kwargs):
    try:
        cls = ROUTING_POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown routing policy {name!r}; expected one of "
                         f"{tuple(ROUTING_POLICIES)}") from None
    return cls(**kwargs)


class ReplicaRouter:
    """The fleet front: routes each submitted request to one replica.

    ``policy`` is a name from :data:`ROUTING_POLICIES` or a policy
    instance (anything with ``choose(request, replicas) -> index``).
    """

    def __init__(self, replicas: Sequence, policy="jsq", **policy_kwargs):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.replicas = list(replicas)
        self.policy = (make_routing_policy(policy, **policy_kwargs)
                       if isinstance(policy, str) else policy)
        self.routed = [0] * len(self.replicas)
        self.refused = [0] * len(self.replicas)

    def submit(self, request: Request) -> bool:
        """Route and submit one request (the ``OpenLoopSource`` queue
        contract); refusals are counted per replica, never retried — the
        load stays open-loop."""
        i = self.policy.choose(request, self.replicas)
        ok = self.replicas[i].submit(request)
        self.routed[i] += 1
        if not ok:
            self.refused[i] += 1
        return ok

    def depths(self) -> list[int]:
        return [r.depth() for r in self.replicas]

    def stats(self) -> dict:
        out = {
            "replicas": len(self.replicas),
            "policy": type(self.policy).__name__,
            "routed": list(self.routed),
            "refused": list(self.refused),
            "depths": self.depths(),
        }
        if isinstance(self.policy, DeadlineSpill):
            out["spills"] = self.policy.spills
        return out
