"""Continuous batcher: join-on-arrival packing into bucketed shapes.

Every engine iteration the batcher packs the next step's batch: in-flight
requests stay (retire-on-completion happens in the engine), waiting
requests join up to the batch cap, and the batch dimension is padded up to
a **bucket boundary** so the number of distinct compiled shapes stays
bounded.  The bucket a batch pads to is the key the handler's
``context_fn`` sees — each bucket is a specialization context with its own
dispatch snapshot and its own Controller search.

**Bucket boundaries are themselves a specialization point.**  A bucketing
*scheme* (named tuple of boundaries) is declared as an enum spec point on a
tiny registered "plan" handler (:func:`bucket_plan_builder`), and
:class:`BucketTuner` drives it with the ordinary
:class:`~repro_torch.core.controller.Controller` against observed goodput — so
batch-shape bucketing is tuned online by exactly the machinery that tunes
kernel implementations, and the winning scheme persists/restores through
``spec_state.json`` like any other tuned config.  The tradeoff being
searched: fine buckets pad less (less wasted compute per step) but split
traffic across more contexts and more compiles; coarse buckets amortize
compiles but burn FLOPs on padding.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Mapping, Sequence

from repro_torch.serve.queue import AdmissionQueue
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import Scheduler

logger = logging.getLogger("repro_torch.serve.batcher")

__all__ = ["PackedBatch", "ContinuousBatcher", "bucket_plan_builder",
           "BucketTuner", "default_schemes"]

#: Spec-point label for the bucketing scheme (the batcher's one knob).
BUCKET_POINT = "bucket_scheme"


def default_schemes(max_batch: int) -> dict[str, tuple[int, ...]]:
    """The standard scheme menu for a given batch cap:

    * ``single`` — one bucket: everything pads to ``max_batch`` (the
      fixed-shape baseline),
    * ``coarse`` — two buckets (quarter cap, cap),
    * ``pow2``   — powers of two up to the cap (tight packing).
    """
    pow2 = []
    b = 1
    while b < max_batch:
        pow2.append(b)
        b *= 2
    pow2.append(max_batch)
    out = {"single": (max_batch,), "pow2": tuple(pow2)}
    quarter = max(1, max_batch // 4)
    if quarter < max_batch:
        out["coarse"] = (quarter, max_batch)
    return out


@dataclasses.dataclass
class PackedBatch:
    """One engine step's batch: the rows and the bucket they pad to.

    Under phased execution (prefill/decode disaggregation) a step runs
    only one phase's rows: ``requests`` holds the rows this step executes,
    ``in_flight`` every live row (the engine's full active set), and
    ``phase`` which specialization context family the step dispatches
    into.  Legacy (phase-blind) packing leaves ``in_flight`` as None and
    ``phase`` as "decode" — everything executes every step.
    """

    requests: list[Request]          # rows this step executes, slot order
    size: int                        # padded batch dimension (bucket)
    joined: list[Request]            # subset of requests that joined now
    scheme: str                      # bucketing scheme that sized it
    phase: str = "decode"            # "prefill" | "decode"
    in_flight: "list[Request] | None" = None   # all live rows (phased)
    tenant: "str | None" = None      # tenant this step serves (multi-tenant)

    @property
    def pad(self) -> int:
        return self.size - len(self.requests)

    @property
    def all_rows(self) -> list[Request]:
        return self.in_flight if self.in_flight is not None \
            else self.requests


class ContinuousBatcher:
    """Packs the next step's batch (see module docstring).

    ``schemes`` maps scheme name -> ascending bucket boundaries; every
    scheme's largest boundary must equal ``max_batch`` (the cap is a
    resource limit, not a tunable).  ``scheme`` picks the fixed scheme;
    attach a :class:`BucketTuner` to tune it online instead.
    """

    def __init__(self, max_batch: int,
                 schemes: Mapping[str, Sequence[int]] | None = None,
                 scheme: str | None = None):
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got {max_batch}")
        self.max_batch = int(max_batch)
        schemes = dict(schemes) if schemes is not None \
            else default_schemes(self.max_batch)
        self.schemes: dict[str, tuple[int, ...]] = {}
        for name, bounds in schemes.items():
            bounds = tuple(sorted(int(b) for b in bounds))
            if not bounds or bounds[-1] != self.max_batch:
                raise ValueError(
                    f"scheme {name!r} must top out at max_batch="
                    f"{self.max_batch}, got boundaries {bounds}")
            if bounds[0] <= 0:
                raise ValueError(f"scheme {name!r} has a non-positive "
                                 f"boundary: {bounds}")
            self.schemes[name] = bounds
        self.default_scheme = scheme if scheme is not None \
            else next(iter(self.schemes))
        if self.default_scheme not in self.schemes:
            raise ValueError(f"unknown scheme {self.default_scheme!r}; "
                             f"have {sorted(self.schemes)}")
        self._fixed_scheme = self.default_scheme
        self._tuner: "BucketTuner | None" = None
        #: phased packing alternation state, keyed by tenant (None for
        #: the single-tenant legacy path)
        self._prefill_turns: dict = {}

    # -- scheme selection ------------------------------------------------------
    def set_scheme(self, name: str) -> None:
        """Pin the bucketing scheme (mid-stream re-tunes only affect future
        packs; rows already in flight keep decoding)."""
        if name not in self.schemes:
            raise ValueError(f"unknown scheme {name!r}; "
                             f"have {sorted(self.schemes)}")
        self._fixed_scheme = name

    def bind_tuner(self, tuner: "BucketTuner") -> None:
        self._tuner = tuner

    def current_scheme(self) -> str:
        if self._tuner is not None:
            return self._tuner.active_scheme()
        return self._fixed_scheme

    def bucket(self, n: int, scheme: str | None = None) -> int:
        """Smallest boundary >= n under the (current) scheme."""
        bounds = self.schemes[scheme if scheme is not None
                              else self.current_scheme()]
        for b in bounds:
            if n <= b:
                return b
        return bounds[-1]

    # -- packing ---------------------------------------------------------------
    def pack(self, active: Sequence[Request], queue: AdmissionQueue,
             scheduler: Scheduler, now: float,
             slo_s: float | None = None,
             phased: bool = False) -> PackedBatch:
        """Build the next step's batch: keep in-flight rows, join waiting
        requests (scheduler order) up to the cap, pad to the bucket.

        With ``phased=True`` the step executes a single phase's rows:
        in-flight rows partition into prefilling and decoding, and when
        both phases have work the batcher strictly alternates between
        them — chunked prefill of long prompts interleaves with decode
        steps instead of starving them (and vice versa).  The phase a
        step runs is the first element of the handler's ``(phase,
        bucket)`` context key, so each phase dispatches through its own
        specialization contexts.

        When requests carry **tenants**, each step serves exactly one
        tenant (tenants run different models — their rows cannot share a
        handler call).  The tenant is chosen by the scheduler's
        ``pick(runnable)`` hook when it has one (DRR's weighted-fair
        rotation) and otherwise by whichever tenant owns the globally
        best-ranked request under the scheduler's ordinary key — FCFS
        across tenants, starvation and all.  ``in_flight`` always holds
        *every* live row across tenants; ``batch.tenant`` names the
        served one.  Tenant-free traffic takes the exact legacy path.
        """
        rows = list(active)
        tenant_keys = {r.tenant for r in rows}
        if hasattr(queue, "waiting_tenants"):
            tenant_keys |= queue.waiting_tenants()
        if tenant_keys - {None}:
            return self._pack_tenants(rows, tenant_keys, queue, scheduler,
                                      now, slo_s, phased)
        capacity = self.max_batch - len(rows)
        joined: list[Request] = []
        if capacity > 0 and len(queue):
            joined = queue.take(capacity, key=scheduler.key(now, slo_s))
            for req in joined:
                req.service_t = now
            rows.extend(joined)
        scheme = self.current_scheme()
        if not phased:
            size = self.bucket(len(rows), scheme) if rows else 0
            return PackedBatch(requests=rows, size=size, joined=joined,
                               scheme=scheme)
        phase, selected, _ = self._split_phase(rows, None)
        size = self.bucket(len(selected), scheme) if selected else 0
        return PackedBatch(requests=selected, size=size, joined=joined,
                           scheme=scheme, phase=phase, in_flight=rows)

    def _split_phase(self, rows: list[Request],
                     tenant: "str | None") -> tuple[str, list[Request], bool]:
        """Partition one tenant's rows into the phase this step runs,
        alternating per tenant (each tenant's prefill/decode interleave is
        independent — a flood of prefills from one tenant must not eat
        another's decode turns)."""
        pre = [r for r in rows if r.prefilling]
        dec = [r for r in rows if not r.prefilling]
        turn = self._prefill_turns.get(tenant, True)
        if pre and (turn or not dec):
            phase, selected = "prefill", pre
        else:
            phase, selected = "decode", dec
        if pre and dec:
            self._prefill_turns[tenant] = not turn
        else:
            self._prefill_turns[tenant] = True  # next arrival: prefill first
        return phase, selected, turn

    def _pack_tenants(self, rows: list[Request], tenant_keys: set,
                      queue: AdmissionQueue, scheduler: Scheduler,
                      now: float, slo_s: "float | None",
                      phased: bool) -> PackedBatch:
        """Multi-tenant pack: pick the served tenant, join only its
        waiters, bucket only its rows.  Other tenants' in-flight rows ride
        along in ``in_flight`` so the engine's active set stays whole."""
        groups: dict = {t: [r for r in rows if r.tenant == t]
                        for t in tenant_keys}
        waiting = queue.waiting_tenants() \
            if hasattr(queue, "waiting_tenants") else set()
        runnable = [t for t in sorted(tenant_keys,
                                      key=lambda t: (t is None, str(t)))
                    if groups.get(t) or t in waiting]
        scheme = self.current_scheme()
        if not runnable:
            return PackedBatch(requests=[], size=0, joined=[], scheme=scheme,
                               in_flight=rows)
        keyfn = scheduler.key(now, slo_s)
        pick = getattr(scheduler, "pick", None)
        if pick is not None:
            serving = pick(runnable)
        else:
            # No tenant-service protocol: serve the tenant owning the
            # globally best-ranked request (peeking waiters too, so an
            # all-queued tenant can still win a slot).
            def best(t):
                cand = list(groups.get(t, ()))
                cand.extend(queue.peek_tenant(t)
                            if hasattr(queue, "peek_tenant") else ())
                return min((keyfn(r) for r in cand), default=None)

            ranked = [(best(t), str(t)) for t in runnable]
            serving = runnable[min(range(len(runnable)),
                                   key=lambda i: (ranked[i][0] is None,
                                                  ranked[i]))]
        srows = list(groups.get(serving, ()))
        capacity = self.max_batch - len(srows)
        joined: list[Request] = []
        if capacity > 0:
            joined = queue.take(capacity, key=keyfn,
                                where=lambda r: r.tenant == serving)
            for req in joined:
                req.service_t = now
            srows.extend(joined)
        all_rows = rows + joined
        if not phased:
            size = self.bucket(len(srows), scheme) if srows else 0
            return PackedBatch(requests=srows, size=size, joined=joined,
                               scheme=scheme, in_flight=all_rows,
                               tenant=serving)
        phase, selected, _ = self._split_phase(srows, serving)
        size = self.bucket(len(selected), scheme) if selected else 0
        return PackedBatch(requests=selected, size=size, joined=joined,
                           scheme=scheme, phase=phase, in_flight=all_rows,
                           tenant=serving)


def bucket_plan_builder(schemes: Sequence[str],
                        default: str) -> Callable:
    """Handler builder declaring the bucketing scheme as an enum spec point.

    The traced body is the identity — the *choice* is what matters: the
    runtime gives it a variant per scheme, the Controller explores them by
    observed goodput, and ``active_config()[BUCKET_POINT]`` is what the
    batcher reads each pack.  Registering it as a real handler is what buys
    persistence for free: the winning scheme rides ``spec_state.json`` and
    the variant cache exactly like a kernel config.
    """
    choices = tuple(schemes)

    def builder(spec):
        spec.enum(BUCKET_POINT, default, choices, guarded=False)

        def plan(tick):
            return tick

        return plan

    return builder


class BucketTuner:
    """Tunes the batcher's bucketing scheme online with a Controller.

    Registers a ``bucket_plan`` handler on ``runtime`` whose only spec
    point is the scheme enum, and drives it with a per-context
    :class:`~repro_torch.core.controller.Controller` whose metric is the served
    **goodput** (in-SLO tokens/s, read from the engine's
    :class:`~repro_torch.serve.metrics.ServeMetrics` once per dwell window).  The
    engine calls :meth:`step` once per non-idle iteration; the batcher
    reads :meth:`active_scheme` each pack, so a re-tune lands between
    steps and in-flight requests are never dropped.
    """

    def __init__(self, batcher: ContinuousBatcher, runtime=None,
                 metric: Callable[[], float] = lambda: 0.0,
                 dwell: int = 25,
                 name: str = "bucket_plan",
                 policy: "Callable | None" = None,
                 change_detector=None,
                 initial_scheme: str | None = None,
                 wait_compiles: bool = False,
                 plan_handler=None):
        from repro_torch.core.controller import Controller
        from repro_torch.core.metrics import ChangeDetector
        from repro_torch.core.policy import ExhaustiveSweep
        from repro_torch.core.runtime import DEFAULT_CONTEXT

        self.batcher = batcher
        self.metric = metric
        schemes = list(batcher.schemes)
        if plan_handler is None:
            if runtime is None:
                raise ValueError("BucketTuner needs a runtime (to register "
                                 "the plan handler) or a plan_handler")
            plan_handler = runtime.register(
                name, bucket_plan_builder(schemes, batcher.default_scheme))
        self.handler = plan_handler
        candidates = [{BUCKET_POINT: s} for s in schemes]
        initial_configs = None
        if initial_scheme is not None:
            if initial_scheme not in batcher.schemes:
                logger.warning("restored bucket scheme %r unknown; "
                               "exploring fresh", initial_scheme)
            else:
                initial_configs = {
                    DEFAULT_CONTEXT: {BUCKET_POINT: initial_scheme}}
        self.controller = Controller(
            self.handler,
            policy if policy is not None
            else (lambda: ExhaustiveSweep(candidates)),
            metric=lambda view: self.metric(),
            dwell=dwell,
            change_detector=(change_detector if change_detector is not None
                             else (lambda: ChangeDetector(0.5))),
            wait_compiles=wait_compiles,
            prefetch=0,
            initial_configs=initial_configs)
        self._tick = 0              # the plan handler's (ignored) argument
        batcher.bind_tuner(self)

    def active_scheme(self) -> str:
        cfg = self.handler.active_config()
        scheme = cfg.get(BUCKET_POINT)
        if scheme is None or scheme not in self.batcher.schemes:
            return self.batcher.default_scheme
        return scheme

    def step(self) -> None:
        """One engine iteration: tick the plan handler (its throughput
        counter is the Controller's dwell clock) and advance the search."""
        self.handler(self._tick)
        self.controller.step()

    def settled(self) -> bool:
        return self.controller.settled()

    def best_scheme(self) -> str | None:
        cfg, _ = self.controller.best()
        if cfg is None:
            return None
        return cfg.get(BUCKET_POINT)

    def status(self) -> dict:
        out = {"active": self.active_scheme(),
               "best": self.best_scheme(),
               "settled": self.settled(),
               "boundaries": {
                   name: list(bounds)
                   for name, bounds in self.batcher.schemes.items()}}
        return out
