"""CompileService: the pipelined variant-compilation engine (paper §6.4).

The paper's premise is that online specialization pays off only when variant
generation is cheap and **off the critical path** (Fig 10/11, Table 4).  The
seed runtime compiled variants serially on one worker with no dedup and no
way to abandon work the policy had already moved past.  This service
replaces that with a small build farm:

* **priority queue** — activation requests (the policy just selected this
  config) outrank speculative prefetches (the policy *will probably* select
  it soon), so the dwell-critical build is never stuck behind speculation.
* **multi-worker** — ``workers`` threads drain the queue concurrently; XLA
  compilation releases the GIL for most of its runtime, so wall-clock
  scales with workers (benchmarks/fig10_compile_scaling.py measures this).
* **dedup** — concurrent requests for the same (handler, variant key)
  coalesce onto one in-flight build; a later activation *promotes* a
  pending speculative entry instead of compiling twice.
* **stale cancellation** — when the policy moves on, still-queued requests
  for abandoned configs are cancelled before a worker wastes a compile on
  them (``cancel_pending``).
* **telemetry** — every request records queue wait, builder time, XLA
  compile time, and persistent-cache hits, feeding
  ``benchmarks/table4_compile_time.py`` and ``BENCH_serve.json``.

With ``workers=0`` the service degrades to synchronous inline execution
(the ``async_compile=False`` runtime mode used throughout the tests);
speculative requests are skipped in that mode since there is no pipeline
to overlap them with.
"""
from __future__ import annotations

import collections
import heapq
import itertools
import logging
import threading
import time
from concurrent.futures import CancelledError, Future
from typing import Any, Callable

from . import telemetry
from .metrics import nearest_rank

logger = logging.getLogger("repro_torch.core.compile_service")

__all__ = ["CompileService", "CompileRequest",
           "PRIORITY_ACTIVATE", "PRIORITY_SPECULATIVE"]

#: request classes; lower value pops first
PRIORITY_ACTIVATE = 0
PRIORITY_SPECULATIVE = 10


def _mean_compile_s(records: list[dict]) -> float | None:
    """THE rule for what counts as an observed compile cost: records with a
    measured ``compile_s`` that were not cache hits.  Both the per-config
    telemetry (:meth:`CompileService.cost_estimates`) and the Controller's
    budget gate (:meth:`CompileService.estimate_compile_s`) go through
    here, so they can never diverge."""
    xs = [r["compile_s"] for r in records
          if r.get("compile_s") is not None and not r.get("cache_hit")]
    return sum(xs) / len(xs) if xs else None


class CompileRequest:
    """One unit of build work; shared by every submitter that deduped onto it."""

    __slots__ = ("handler", "key", "config", "build", "priority",
                 "speculative", "future", "status", "enqueued_t",
                 "started_t", "done_t", "build_time_s", "compile_time_s",
                 "cache_hit")

    def __init__(self, handler: str, key: Any, config: dict,
                 build: Callable[[], Any], priority: int, speculative: bool):
        self.handler = handler
        self.key = key
        self.config = dict(config)
        self.build = build
        self.priority = priority
        self.speculative = speculative
        self.future: Future = Future()
        self.status = "pending"        # pending|running|done|failed|cancelled
        self.enqueued_t = time.perf_counter()
        self.started_t: float | None = None
        self.done_t: float | None = None
        self.build_time_s: float | None = None
        self.compile_time_s: float | None = None
        self.cache_hit: bool | None = None

    def record(self) -> dict:
        wait = ((self.started_t or self.done_t or time.perf_counter())
                - self.enqueued_t)
        return {
            "handler": self.handler,
            "config": dict(self.config),
            "speculative": self.speculative,
            "status": self.status,
            "wait_s": wait,
            "build_s": self.build_time_s,
            "compile_s": self.compile_time_s,
            "cache_hit": self.cache_hit,
        }


class CompileService:
    """Priority-queued, deduplicating, cancellable variant build farm."""

    def __init__(self, workers: int = 2,
                 thread_name_prefix: str = "iridescent-compile"):
        self.workers = max(0, int(workers))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._heap: list[tuple[int, int, CompileRequest]] = []
        self._seq = itertools.count()
        self._inflight: dict[tuple[str, Any], CompileRequest] = {}
        # bounded: a weeks-long serve loop streams requests through here
        self._history: collections.deque[dict] = collections.deque(
            maxlen=4096)
        self._shutdown = False
        # aggregate counters (includes inline compiles reported by handlers)
        self._agg = {"xla_compiles": 0, "cache_hits": 0, "cancelled": 0,
                     "total_compile_s": 0.0, "total_build_s": 0.0}
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"{thread_name_prefix}-{i}")
            for i in range(self.workers)
        ]
        for t in self._threads:
            t.start()

    # -- submission ------------------------------------------------------------
    def submit(self, handler: str, key: Any, config: dict,
               build: Callable[[], Any], priority: int = PRIORITY_ACTIVATE,
               speculative: bool = False) -> CompileRequest:
        """Enqueue a build (or coalesce onto the matching in-flight one)."""
        with self._cv:
            if self._shutdown:
                raise RuntimeError("CompileService is shut down")
            existing = self._inflight.get((handler, key))
            if existing is not None and existing.status in ("pending",
                                                            "running"):
                # Dedup.  An activation request promotes a pending
                # speculative build to the front of the queue.
                if priority < existing.priority and \
                        existing.status == "pending":
                    existing.priority = priority
                    existing.speculative = existing.speculative and speculative
                    heapq.heappush(self._heap,
                                   (priority, next(self._seq), existing))
                    self._cv.notify()
                if not speculative:
                    existing.speculative = False
                return existing
            req = CompileRequest(handler, key, config, build, priority,
                                 speculative)
            if self.workers == 0:
                if speculative:
                    # No pipeline to overlap with: skip speculation.
                    req.status = "cancelled"
                    req.future.cancel()
                    self._history.append(req.record())
                    self._agg["cancelled"] += 1
                    return req
                self._inflight[(handler, key)] = req
            else:
                self._inflight[(handler, key)] = req
                heapq.heappush(self._heap, (priority, next(self._seq), req))
                self._cv.notify()
            _tb = telemetry.bus()
            if _tb is not None:
                _tb.emit("compile.queued", handler=handler,
                         config=repr(config), speculative=speculative,
                         priority=priority, queue_depth=len(self._heap))
        if self.workers == 0:
            self._run(req)               # synchronous inline execution
        return req

    # -- cancellation -----------------------------------------------------------
    def cancel_pending(self, handler: str | None = None,
                       keep_keys: set | None = None,
                       speculative_only: bool = False,
                       max_priority: int | None = None,
                       key_filter: Callable[[Any], bool] | None = None) -> int:
        """Cancel still-queued requests the policy has moved past.

        ``speculative_only`` restricts to speculative prefetches;
        ``max_priority`` restricts to requests at that priority or more
        urgent (e.g. ``PRIORITY_ACTIVATE`` to cancel stale activations
        while leaving speculative prefetches queued); ``key_filter``
        restricts to requests whose key matches the predicate (handlers use
        it to scope cancellation to one specialization context).  Running
        builds are never interrupted (XLA compiles are not abortable); they
        simply complete into the variant cache.  Returns the number
        cancelled.
        """
        cancelled = []
        with self._cv:
            for (h, key), req in list(self._inflight.items()):
                if req.status != "pending":
                    continue
                if handler is not None and h != handler:
                    continue
                if keep_keys is not None and key in keep_keys:
                    continue
                if speculative_only and not req.speculative:
                    continue
                if max_priority is not None and req.priority > max_priority:
                    continue
                if key_filter is not None and not key_filter(key):
                    continue
                req.status = "cancelled"
                req.future.cancel()
                del self._inflight[(h, key)]
                self._history.append(req.record())
                self._agg["cancelled"] += 1
                cancelled.append(req)
            if cancelled:
                self._cv.notify_all()
        _tb = telemetry.bus()
        if _tb is not None:
            for req in cancelled:
                _tb.emit("compile.cancelled", handler=req.handler,
                         config=repr(req.config),
                         speculative=req.speculative)
        return len(cancelled)

    # -- waiting ----------------------------------------------------------------
    def drain(self, handler: str | None = None,
              timeout: float | None = None) -> bool:
        """Block until every pending/running request (for ``handler``) is
        finished or cancelled.  Returns False on timeout."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cv:
            while True:
                busy = [r for (h, _), r in self._inflight.items()
                        if (handler is None or h == handler)
                        and r.status in ("pending", "running")]
                if not busy:
                    return True
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(timeout=remaining)

    # -- telemetry ---------------------------------------------------------------
    def note_compile(self, compile_s: float | None, cache_hit: bool,
                     build_s: float | None = None) -> None:
        """Aggregate one variant compile (also called for inline compiles
        that bypass the queue, so stats cover every variant built)."""
        with self._lock:
            if cache_hit:
                self._agg["cache_hits"] += 1
            else:
                self._agg["xla_compiles"] += 1
                if compile_s is not None:
                    self._agg["total_compile_s"] += compile_s
            if build_s is not None:
                self._agg["total_build_s"] += build_s

    def telemetry(self) -> list[dict]:
        """Per-request records (completed requests), oldest first."""
        with self._lock:
            return [dict(r) for r in self._history]

    # -- cost estimation (Table 4 telemetry, surfaced per config) ----------------
    def _scoped_records(self, handler: str | None) -> list[dict]:
        """History records for ``handler`` (all of them; see
        :func:`_mean_compile_s` for the single place that decides which of
        these count as a real compile)."""
        with self._lock:
            records = [dict(r) for r in self._history]
        return [r for r in records
                if handler is None or r.get("handler") == handler]

    def cost_estimates(self, handler: str | None = None) -> dict:
        """Per-config compile-cost summaries from the request history —
        the Table-4 telemetry surfaced per configuration, for dashboards
        and benchmark reports.  The Controller's budget gate consumes the
        same history (and the same ``_mean_compile_s`` rule) through the
        scalar :meth:`estimate_compile_s`.

        Returns ``{config repr: {"n", "mean_compile_s", "cache_hits"}}``.
        """
        from repro_torch.core.points import config_key
        by_cfg: dict[tuple, list[dict]] = {}
        cfg_of: dict[tuple, dict] = {}
        for r in self._scoped_records(handler):
            key = config_key(r.get("config") or {})
            by_cfg.setdefault(key, []).append(r)
            cfg_of.setdefault(key, dict(r.get("config") or {}))
        return {
            repr(cfg_of[key]): {
                "n": len(recs),
                "cache_hits": sum(1 for r in recs if r.get("cache_hit")),
                "mean_compile_s": _mean_compile_s(recs),
            }
            for key, recs in by_cfg.items()
        }

    def estimate_compile_s(self, handler: str | None = None,
                           config: dict | None = None) -> float | None:
        """Expected XLA compile seconds for a candidate.

        Preference order: the mean of past compiles of this exact config,
        then the handler's mean, then the global mean; ``None`` when no
        compile has ever been observed (the caller should not gate on a
        guess it does not have).
        """
        from repro_torch.core.points import config_key
        scoped = self._scoped_records(handler)
        if config is not None:
            ckey = config_key(config)
            exact = _mean_compile_s(
                [r for r in scoped
                 if config_key(r.get("config") or {}) == ckey])
            if exact is not None:
                return exact
        mean = _mean_compile_s(scoped)
        if mean is not None:
            return mean
        with self._lock:
            agg_n = self._agg["xla_compiles"]
            agg_total = self._agg["total_compile_s"]
        return agg_total / agg_n if agg_n else None

    def stats(self) -> dict:
        """Aggregate counters plus the live-service view `status.py` and
        the serve-bench report share: queue depth, in-flight builds, cache
        hit-rate, and the p50 of observed build/compile times (from the
        same bounded ``_history`` that feeds table4)."""
        with self._lock:
            pending = sum(1 for r in self._inflight.values()
                          if r.status == "pending")
            running = sum(1 for r in self._inflight.values()
                          if r.status == "running")
            agg = dict(self._agg)
            records = [dict(r) for r in self._history]
        done = [r for r in records if r.get("status") == "done"]
        builds = [r["build_s"] for r in done if r.get("build_s") is not None]
        compiles = [r["compile_s"] for r in done
                    if r.get("compile_s") is not None
                    and not r.get("cache_hit")]
        built = agg["xla_compiles"] + agg["cache_hits"]
        p50_build = nearest_rank(builds, 50) if builds else None
        p50_compile = nearest_rank(compiles, 50) if compiles else None
        return {**agg, "workers": self.workers,
                "pending": pending, "running": running,
                "completed": len(records),
                "queue_depth": pending, "in_flight": running,
                "cache_hit_rate": (round(agg["cache_hits"] / built, 4)
                                   if built else None),
                "build_p50_s": (round(p50_build, 6)
                                if p50_build is not None else None),
                "compile_p50_s": (round(p50_compile, 6)
                                  if p50_compile is not None else None)}

    # -- internals ---------------------------------------------------------------
    def _emit_build(self, req: CompileRequest, span_ts: float) -> None:
        _tb = telemetry.bus()
        if _tb is None:
            return
        rec = req.record()
        done_t = req.done_t if req.done_t is not None else time.perf_counter()
        _tb.emit("compile.build", "span", ts=span_ts,
                 dur=(done_t - req.started_t) * 1e6,
                 handler=req.handler, config=repr(req.config),
                 status=req.status, cache_hit=req.cache_hit,
                 speculative=req.speculative,
                 wait_s=round(rec["wait_s"], 6),
                 compile_s=req.compile_time_s, build_s=req.build_time_s)

    def _run(self, req: CompileRequest) -> None:
        req.started_t = time.perf_counter()
        req.status = "running"
        span_ts = telemetry.perf_to_us(req.started_t)
        try:
            result = req.build()
            req.status = "done"
        except BaseException as e:
            req.status = "failed"
            req.done_t = time.perf_counter()
            with self._cv:
                self._inflight.pop((req.handler, req.key), None)
                self._history.append(req.record())
                self._cv.notify_all()
            self._emit_build(req, span_ts)
            req.future.set_exception(e)
            return
        req.done_t = time.perf_counter()
        # Builds annotate their Variant with timing/cache info; fold it in.
        req.build_time_s = getattr(result, "build_time_s", None)
        req.compile_time_s = getattr(result, "compile_time_s", None)
        req.cache_hit = bool(getattr(result, "from_cache", False))
        with self._cv:
            self._inflight.pop((req.handler, req.key), None)
            self._history.append(req.record())
            self._cv.notify_all()
        self._emit_build(req, span_ts)
        req.future.set_result(result)

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._shutdown:
                    self._cv.wait()
                if self._shutdown and not self._heap:
                    return
                _, _, req = heapq.heappop(self._heap)
                if req.status != "pending":
                    continue          # cancelled, or a stale dup heap entry
                req.status = "running"   # claim under the lock
            self._run(req)

    def shutdown(self, wait: bool = True) -> None:
        with self._cv:
            self._shutdown = True
            # Drop work nobody will ever observe.
            for (h, key), req in list(self._inflight.items()):
                if req.status == "pending" and req.speculative:
                    req.status = "cancelled"
                    req.future.cancel()
                    del self._inflight[(h, key)]
                    self._history.append(req.record())
                    self._agg["cancelled"] += 1
            self._cv.notify_all()
        if wait:
            for t in self._threads:
                t.join(timeout=60.0)
