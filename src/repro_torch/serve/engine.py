"""The continuous-batching serve engine: the framework's production entry
point.

One :class:`ServeEngine` wires the serve subsystem together around the
specialization runtime::

    clients -> AdmissionQueue -> Scheduler -> ContinuousBatcher
                   (backpressure)  (ordering)   (join/retire/pad)
                                                      |
                                    PackedBatch (bucket = context key)
                                                      |
                            Handler (per-context dispatch snapshot)
                                                      |
                       Controller / BucketTuner  <-  ServeMetrics
                      (per-bucket spec search)    (latency, goodput)

Each iteration (:meth:`step`): pump open-loop arrivals, pack the next batch
(in-flight rows stay, scheduler-ordered joiners fill the gap, the batch
pads to the current bucket scheme's boundary), execute it through the
handler — the padded size is the handler's ``context_fn`` key, so every
bucket dispatches through its own specialization context — then retire
requests whose token budget is spent, feed their completions to the
metrics, and advance the per-bucket :class:`Controller` and the
:class:`BucketTuner`.

``drain()`` serves out everything in flight (graceful shutdown);
``shutdown()`` drains, persists the tuned per-context configurations
(``spec_state.json`` — including the tuned bucket scheme, which lives on
the ``bucket_plan`` handler) and releases the compile pipeline.  With a
persistent variant cache, a restarted engine resumes every context's tuned
config with zero recompiles.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Protocol

from repro_torch.core import telemetry
from repro_torch.serve.batcher import BucketTuner, ContinuousBatcher, PackedBatch
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import AdmissionQueue, OpenLoopSource
from repro_torch.serve.request import Completion, Request
from repro_torch.serve.scheduler import FCFS, Scheduler

logger = logging.getLogger("repro_torch.serve.engine")

__all__ = ["ServeEngine", "BatchExecutor"]


class BatchExecutor(Protocol):
    """Model-side adapter: run one step for a packed batch.

    ``execute(batch)`` runs the step and may return per-request produced
    token counts (aligned with ``batch.requests``); returning None means
    "one token each" (the legacy decode-only contract — the engine
    credits ``generated`` itself).  Phased executors return 0 for rows
    still mid-prefill and set ``phased = True`` so the engine packs
    prefill and decode steps separately.  The optional ``retire(request)``
    hook is called when a request leaves the batch (free its slot/cache
    state).
    """

    def execute(self, batch: PackedBatch) -> "list[int] | None": ...


class ServeEngine:
    """Continuous-batching serve loop over a specialization handler.

    ``handler`` is the model's registered trampoline (its ``context_fn``
    should key on the padded batch size so buckets map to specialization
    contexts); ``controller`` its per-context spec search (optional);
    ``batcher``/``scheduler``/``queue`` default to a pow2-bucket batcher
    with FCFS over an unbounded queue.  ``executor`` adapts packed batches
    to actual handler calls.  ``tuner`` (a :class:`BucketTuner`) makes the
    bucket boundaries themselves a tuned spec point.
    """

    def __init__(
        self,
        handler,                             # repro_torch.core.runtime.Handler
        controller=None,                     # repro_torch.core.controller.Controller
        batcher: ContinuousBatcher | None = None,
        scheduler: Scheduler | None = None,
        *,
        executor: BatchExecutor | Callable[[PackedBatch], None] | None = None,
        queue: AdmissionQueue | None = None,
        tuner: BucketTuner | None = None,
        kv_tuner=None,                       # repro_torch.serve.kv.KVTuner
        metrics: ServeMetrics | None = None,
        slo_s: float | None = None,
        tenant_slos: "dict[str, float] | None" = None,
        max_batch: int = 8,
        clock: Callable[[], float] = time.perf_counter,
        on_completion: Callable[[Completion], None] | None = None,
        shadow=None,                         # repro_torch.serve.shadow.ShadowEvaluator
    ):
        if executor is None:
            raise ValueError("ServeEngine needs an executor (the adapter "
                             "that turns a PackedBatch into handler calls)")
        self.handler = handler
        self.controller = controller
        self.batcher = batcher if batcher is not None \
            else ContinuousBatcher(max_batch)
        self.scheduler = scheduler if scheduler is not None else FCFS()
        self.queue = queue if queue is not None else AdmissionQueue()
        self.tuner = tuner
        self.kv_tuner = kv_tuner
        self.slo_s = slo_s
        #: per-tenant default SLOs (a tenant's requests without their own
        #: ``deadline_s`` fall back here before the engine-wide ``slo_s``)
        self.tenant_slos = dict(tenant_slos or {})
        self.clock = clock
        self.metrics = metrics if metrics is not None \
            else ServeMetrics(slo_s=slo_s, clock=clock,
                              tenant_slos=self.tenant_slos)
        if callable(executor) and not hasattr(executor, "execute"):
            executor = _FnExecutor(executor)
        self.executor = executor
        #: phased executors partition steps into prefill and decode
        self.phased = bool(getattr(executor, "phased", False))
        self.on_completion = on_completion
        #: optional shadow evaluator: candidates re-execute mirrored live
        #: calls on idle ticks (off the hot path, bounded per-tick budget)
        self.shadow = shadow
        #: requests currently in the running batch, in slot order
        self.active: list[Request] = []
        self.steps = 0
        self.idle_ticks = 0
        self.shadow_pairs = 0
        self.tokens_generated = 0
        self.padded_rows = 0            # wasted rows (padding) across steps
        self.bucket_steps: dict[int, int] = {}
        self.phase_steps: dict[str, int] = {}
        self.tenant_steps: dict[str, int] = {}
        self._draining = False
        self._last_depth = -1        # last queue depth put on the event bus

    # -- client side -----------------------------------------------------------
    def submit(self, request: Request) -> bool:
        """Offer one request to the admission queue."""
        return self.queue.submit(request)

    # -- one iteration ----------------------------------------------------------
    def step(self, source: OpenLoopSource | None = None) -> int:
        """One engine iteration; returns tokens produced (0 = idle tick).

        An idle tick (nothing waiting, nothing in flight) does no handler
        call and does not advance the controllers — dwell windows measure
        service, not silence.
        """
        now = self.clock()
        if source is not None:
            source.pump(now)
        batch = self.batcher.pack(self.active, self.queue, self.scheduler,
                                  now, slo_s=self.slo_s, phased=self.phased)
        if not batch.requests:
            self.idle_ticks += 1
            if self.shadow is not None:
                # Idle capacity funds shadow evaluation: mirrored call
                # pairs run off the hot path under a bounded per-tick
                # budget, then the controller collects any verdicts (a
                # shadow-stage context advances without live traffic).
                self.shadow_pairs += self.shadow.step()
                if self.controller is not None:
                    self.controller.step()
            return 0
        _tb = telemetry.bus()
        if _tb is not None:
            prev = {id(r) for r in self.active}
            for req in batch.all_rows:
                if id(req) not in prev:
                    _tb.emit("serve.schedule", track=f"bucket:{batch.size}",
                             rid=req.rid, bucket=batch.size,
                             phase=batch.phase,
                             queue_delay_s=(round(now - req.arrival_t, 6)
                                            if req.arrival_t is not None
                                            else None))
            depth = len(self.queue)
            if depth != self._last_depth:
                self._last_depth = depth
                _tb.emit("serve.queue_depth", "counter", depth=depth,
                         in_flight=len(batch.all_rows))
        self.active = list(batch.all_rows)
        charge = getattr(self.scheduler, "charge", None)
        prefill_before = sum(r.prompt_consumed for r in batch.requests) \
            if charge is not None else 0
        produced = self.executor.execute(batch)
        if produced is not None and len(produced) != len(batch.requests):
            raise RuntimeError(
                f"executor {type(self.executor).__name__} returned "
                f"{len(produced)} per-request token counts for a batch of "
                f"{len(batch.requests)} requests — execute() must align "
                "its result with batch.requests (or return None for the "
                "one-token-each contract)")
        t_after = self.clock()
        tokens = 0
        finished: list[Request] = []
        for i, req in enumerate(batch.requests):
            n = 1 if produced is None else int(produced[i])
            if n > 0:
                if req.first_token_t is None:
                    req.first_token_t = t_after
                req.generated += n
                tokens += n
            if req.done:
                finished.append(req)
        if charge is not None and batch.tenant is not None:
            # DRR accounting: the served tenant pays for what the step
            # actually did — decode tokens produced plus prompt tokens
            # prefilled (prefill is service too, just not output).
            served = tokens + (sum(r.prompt_consumed
                                   for r in batch.requests) - prefill_before)
            if served > 0:
                charge(batch.tenant, served)
        for req in finished:
            self._retire(req, t_after)
        self.steps += 1
        self.tokens_generated += tokens
        self.padded_rows += batch.pad
        self.bucket_steps[batch.size] = \
            self.bucket_steps.get(batch.size, 0) + 1
        self.phase_steps[batch.phase] = \
            self.phase_steps.get(batch.phase, 0) + 1
        if batch.tenant is not None:
            self.tenant_steps[batch.tenant] = \
                self.tenant_steps.get(batch.tenant, 0) + 1
        if self.controller is not None:
            self.controller.step()
        if self.tuner is not None:
            self.tuner.step()
        if self.kv_tuner is not None:
            self.kv_tuner.step()
        return tokens

    def _retire(self, req: Request, now: float) -> None:
        self.active.remove(req)
        req.finish_t = now
        retire = getattr(self.executor, "retire", None)
        if retire is not None:
            retire(req)
        default_slo = self.tenant_slos.get(req.tenant, self.slo_s) \
            if req.tenant is not None else self.slo_s
        completion = Completion.from_request(req, default_slo_s=default_slo)
        self.metrics.observe(completion)
        _tb = telemetry.bus()
        if _tb is not None:
            # Request span on the serve track: ts is back-dated by the
            # measured latency so the span covers arrival -> finish.
            dur = completion.latency_s * 1e6
            qd = completion.queue_delay_s
            _tb.emit("serve.request", "span", track="serve",
                     ts=telemetry.now_us() - dur, dur=dur, rid=req.rid,
                     tokens=completion.tokens,
                     prompt_tokens=completion.prompt_tokens,
                     slo_met=completion.within_slo,
                     queue_delay_s=(round(qd, 6) if qd is not None
                                    else None))
        if self.on_completion is not None:
            self.on_completion(completion)

    # -- loops ------------------------------------------------------------------
    def run(self, *, source: OpenLoopSource | None = None,
            duration_s: float | None = None, max_steps: int | None = None,
            idle_sleep_s: float = 5e-4) -> dict:
        """Serve until the workload is done or a budget runs out.

        Stops when ``duration_s``/``max_steps`` is reached, or — with a
        ``source`` — when the schedule is exhausted and everything admitted
        has been served.  Without any bound it serves until the queue and
        the running batch are both empty.
        """
        t0 = self.clock()
        while True:
            if duration_s is not None and self.clock() - t0 >= duration_s:
                break
            if max_steps is not None and self.steps >= max_steps:
                break
            produced = self.step(source=source)
            if produced == 0:
                if (source is None or source.exhausted) and \
                        not self.active and not len(self.queue):
                    break
                if self.active:
                    continue      # a 0-token prefill step still did work
                if idle_sleep_s:
                    wait = idle_sleep_s
                    if source is not None:
                        due = source.next_due(self.clock())
                        if due is not None:
                            wait = min(max(due, 0.0), 0.01)
                    time.sleep(wait)
        return {"wall_s": self.clock() - t0, "steps": self.steps}

    def drain(self, timeout_s: float | None = None,
              shed_on_timeout: bool = True) -> bool:
        """Serve out everything queued and in flight (graceful shutdown).

        Admission closes; returns True when fully drained.  On timeout the
        remainder is shed (counted, callbacks fired) rather than abandoned
        mid-state, so the caller can still checkpoint and exit cleanly.
        """
        self._draining = True
        self.queue.close()
        t0 = self.clock()
        while self.active or len(self.queue):
            if timeout_s is not None and self.clock() - t0 >= timeout_s:
                if shed_on_timeout:
                    shed_t = self.clock()
                    flushed = self.queue.flush()   # counted in queue stats
                    retire = getattr(self.executor, "retire", None)
                    for req in self.active:
                        req.shed = True
                        if req.finish_t is None:
                            # well-formed telemetry span: the request's
                            # lifetime ends at the shed, not never
                            req.finish_t = shed_t
                        if retire is not None:
                            retire(req)            # free slot/cache state
                    # metrics count only the in-flight sheds; the flushed
                    # waiters are already in queue.stats()["shed"].
                    by_tenant: dict = {}
                    for req in self.active:
                        by_tenant[req.tenant] = \
                            by_tenant.get(req.tenant, 0) + 1
                    for t, n in by_tenant.items():
                        self.metrics.observe_shed(n, tenant=t)
                    _tb = telemetry.bus()
                    if _tb is not None:
                        _tb.emit("serve.shed", track="serve",
                                 in_flight=len(self.active),
                                 flushed=len(flushed))
                    logger.warning("drain timed out; shed %d requests",
                                   len(flushed) + len(self.active))
                    self.active.clear()
                return False
            self.step()
        self._draining = False           # fully drained: no longer mid-drain
        return True

    def shutdown(self, state_dir: str | None = None,
                 drain_timeout_s: float | None = 30.0) -> None:
        """Drain, close the shadow tap, stop compile workers.

        ``state_dir`` (persisting the tuned per-context configurations to
        ``<state_dir>/spec_state.json``) is not ported yet and raises.
        """
        if state_dir is not None:
            raise NotImplementedError(
                "persisting spec_state is not ported yet (ROADMAP M3: "
                "checkpoint/store.py)")
        self.drain(timeout_s=drain_timeout_s)
        runtime = self.handler.runtime
        if self.shadow is not None:
            self.shadow.close()
        runtime.shutdown()

    # -- telemetry ---------------------------------------------------------------
    def stats(self) -> dict:
        out = {
            "steps": self.steps,
            "idle_ticks": self.idle_ticks,
            "tokens_generated": self.tokens_generated,
            "padded_rows": self.padded_rows,
            "in_flight": len(self.active),
            "bucket_steps": dict(sorted(self.bucket_steps.items())),
            "phase_steps": dict(sorted(self.phase_steps.items())),
            "draining": self._draining,
            "queue": self.queue.stats(),
            "serve": self.metrics.summary(),
        }
        if self.tenant_steps:
            out["tenant_steps"] = dict(sorted(self.tenant_steps.items()))
        sched_stats = getattr(self.scheduler, "stats", None)
        if callable(sched_stats):
            out["scheduler"] = sched_stats()
        if self.tuner is not None:
            out["buckets"] = self.tuner.status()
        if self.kv_tuner is not None:
            out["kv"] = self.kv_tuner.status()
        if self.shadow is not None:
            out["shadow"] = {"pairs": self.shadow_pairs,
                             **self.shadow.stats()}
        fn = getattr(self.controller, "safety_status", None)
        if callable(fn):
            out["safety"] = fn()
        return out


class _FnExecutor:
    """Adapter for plain-callable executors."""

    def __init__(self, fn: Callable[[PackedBatch], None]):
        self._fn = fn

    def execute(self, batch: PackedBatch) -> None:
        self._fn(batch)
