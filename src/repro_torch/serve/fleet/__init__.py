"""Fleet-scale serving: replica router + shared specialization plane
(the port of ``repro.serve.fleet``).

One :class:`~repro_torch.serve.engine.ServeEngine` per process is the
throughput ceiling, and every new replica would re-pay the full
exploration cost its Controller spends before settling.  This package
scales both out:

* :class:`ReplicaRouter` (:mod:`repro_torch.serve.fleet.router`) — an
  open-loop front that spreads one arrival schedule across N replicas
  with pluggable policies (round-robin, join-shortest-queue by reported
  depth, deadline-aware spill).  Replicas are in-process
  (:class:`LocalReplica`) or subprocess workers
  (:class:`~repro_torch.serve.fleet.worker.SubprocessReplica` driving
  :mod:`repro_torch.serve.fleet.worker`).
* :class:`SpecPlane` (:mod:`repro_torch.serve.fleet.plane`) — shared
  specialization state: replicas publish per-context settled winners
  (atomic one-record files; freshest-wins conflict resolution with a
  goodput tiebreak) and subscribe on a poll interval, seeding remote
  winners through ``handler.seed_spec_state`` so a remotely-tuned
  context starts in EXPLOIT.  With a shared *portable* variant cache
  the warm start is also compile-free: replicas 2..N skip both the
  search and the compiles replica 1 paid for.

``launch/serve.py --replicas N`` runs the LM serving stack this way,
each worker on its own CUDA device context (``--device`` is passed to
the workers; a worker never falls back to the host).

Note :class:`~repro_torch.serve.fleet.worker.SubprocessReplica` is imported
from :mod:`repro_torch.serve.fleet.worker` directly — this package root stays
import-light for the worker subprocesses themselves.
"""
from repro_torch.serve.fleet.plane import SpecPlane
from repro_torch.serve.fleet.router import (ROUTING_POLICIES,
                                            DeadlineSpill,
                                            JoinShortestQueue, LocalReplica,
                                            ReplicaRouter, RoundRobin,
                                            make_routing_policy)

__all__ = [
    "SpecPlane",
    "ReplicaRouter", "LocalReplica", "RoundRobin", "JoinShortestQueue",
    "DeadlineSpill", "ROUTING_POLICIES", "make_routing_policy",
]
