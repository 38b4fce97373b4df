"""Shadow evaluation: mirror live calls against candidates off the hot path.

The :class:`ShadowEvaluator` installs the handler's shadow tap
(:meth:`~repro_torch.core.runtime.Handler.set_shadow_tap`) to capture a sampled
slice of real call arguments per context, then — on the serve engine's
idle ticks, under a bounded per-tick budget — re-executes those samples
against the candidate variant *and* the incumbent, timing both and
discarding the results.  A candidate's verdict compares its median
latency against the incumbent's measured on identical arguments, so the
in-SLO judgment is self-calibrating (host speed, batch shape, and data
distribution cancel out) and the candidate accumulates its K observations
without ever serving a user request.

Captured arguments are cloned at capture time and again before every
shadow call: the LM serve step writes its KV cache in place, so a shadow
re-execution must never see the live call's buffers — nor a sample be
overwritten by the first shadow execution.
"""
from __future__ import annotations

import collections
import logging
import statistics
import time
from typing import Any

import torch

from repro_torch import compat
from repro_torch.core import telemetry

logger = logging.getLogger("repro_torch.serve.shadow")

__all__ = ["ShadowEvaluator"]


def _clone(tree):
    """Copy tensor leaves so a shadow call can never write into or alias
    a buffer another execution still owns."""
    return compat.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def _wait(tree) -> None:
    """Block until the device has produced every tensor in ``tree``."""
    devices = {x.device for x in compat.tree_leaves(tree)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class _ShadowCtx:
    """Per-context capture buffer + the candidate under evaluation."""

    __slots__ = ("samples", "tick", "rotate", "candidate", "incumbent",
                 "cand_times", "inc_times", "attempts")

    def __init__(self, max_samples: int):
        self.samples: collections.deque = collections.deque(
            maxlen=max_samples)
        self.tick = 0
        self.rotate = 0
        self.candidate: dict | None = None
        self.incumbent: dict | None = None
        self.cand_times: list[float] = []
        self.inc_times: list[float] = []
        self.attempts = 0


class ShadowEvaluator:
    """Mirrors a sample of live calls and replays them against candidates.

    Protocol (driven by :class:`~repro_torch.core.safety.SafetyController`):
    ``begin(key, candidate, incumbent)`` registers a candidate for one
    context; ``step(budget)`` — the engine idle-tick hook — runs up to
    ``budget`` timed candidate/incumbent call pairs; ``verdict(key)``
    returns ``{"metric", "in_slo", ...}`` once ``k`` pairs are measured
    (or the attempt budget is exhausted — then ``in_slo=False``: a
    candidate is never admitted on missing evidence); ``clear(key)``
    retires the candidate.

    ``shared_args`` names positional arguments the handler only reads
    (the serve step's weights): samples hold them by reference instead of
    cloning them, which at full model width saves a copy of the weights
    per sample.
    """

    def __init__(self, handler, *, sample_frac: float = 0.25, k: int = 3,
                 tolerance: float = 1.5, budget_per_tick: int = 1,
                 max_samples: int = 4, max_attempts: int = 256,
                 clock=time.perf_counter, shared_args: tuple = ()):
        if k < 1:
            raise ValueError(f"k must be >= 1: {k}")
        self.handler = handler
        self.sample_period = (max(1, round(1.0 / sample_frac))
                              if sample_frac > 0 else 0)
        self.k = int(k)
        self.tolerance = float(tolerance)
        self.budget_per_tick = max(1, int(budget_per_tick))
        self.max_samples = max(1, int(max_samples))
        self.max_attempts = max(self.k, int(max_attempts))
        self.clock = clock
        self.shared_args = frozenset(shared_args)
        self._ctx: dict[Any, _ShadowCtx] = {}
        self.calls = 0                    # shadow executions (pairs are 2)
        self.dropped_samples = 0
        handler.set_shadow_tap(self._tap)

    def _clone_args(self, args: tuple) -> tuple:
        return tuple(a if i in self.shared_args else _clone(a)
                     for i, a in enumerate(args))

    def close(self) -> None:
        """Remove the tap; the handler's fast path is restored."""
        self.handler.clear_shadow_tap()

    # -- capture (runs on the live dispatch path) --------------------------------
    def _st(self, key: Any) -> _ShadowCtx:
        st = self._ctx.get(key)
        if st is None:
            st = self._ctx[key] = _ShadowCtx(self.max_samples)
        return st

    def _tap(self, key: Any, args: tuple, kwargs: dict) -> None:
        if self.sample_period == 0:
            return
        st = self._st(key)
        tick = st.tick
        st.tick += 1
        if tick % self.sample_period:
            return
        st.samples.append((self._clone_args(args), _clone(dict(kwargs))))

    # -- candidate lifecycle ------------------------------------------------------
    def begin(self, key: Any, candidate: dict, incumbent: dict) -> None:
        st = self._st(key)
        st.candidate = dict(candidate)
        st.incumbent = dict(incumbent or {})
        st.cand_times = []
        st.inc_times = []
        st.attempts = 0
        _tb = telemetry.bus()
        if _tb is not None:
            _tb.emit("shadow.begin", track=key, candidate=repr(st.candidate),
                     incumbent=repr(st.incumbent), samples=len(st.samples))

    def clear(self, key: Any) -> None:
        st = self._ctx.get(key)
        if st is not None:
            st.candidate = None
            st.incumbent = None
            st.cand_times = []
            st.inc_times = []
            st.attempts = 0

    def pending(self) -> list:
        """Contexts with a candidate still accumulating observations."""
        return [k for k, st in self._ctx.items()
                if st.candidate is not None and not self._done(st)]

    def _done(self, st: _ShadowCtx) -> bool:
        return (min(len(st.cand_times), len(st.inc_times)) >= self.k
                or st.attempts >= self.max_attempts)

    # -- evaluation (runs on engine idle ticks) ----------------------------------
    def step(self, budget: int | None = None) -> int:
        """Run up to ``budget`` mirrored call pairs across pending
        contexts (round-robin); returns the number of pairs executed."""
        budget = self.budget_per_tick if budget is None else int(budget)
        executed = 0
        keys = self.pending()
        i = 0
        while executed < budget and keys:
            key = keys[i % len(keys)]
            if self._run_pair(key):
                executed += 1
                i += 1
            else:
                keys.remove(key)
        return executed

    def _run_pair(self, key: Any) -> bool:
        st = self._ctx.get(key)
        if st is None or st.candidate is None or self._done(st):
            return False
        if not st.samples:
            return False                  # no captured arguments yet
        view = self.handler.context(key)
        if not (view.has_variant(st.candidate)
                and view.has_variant(st.incumbent)):
            return False                  # candidate build still in flight
        samples = list(st.samples)
        sample = samples[st.rotate % len(samples)]
        st.rotate += 1
        st.attempts += 1
        args, kwargs = sample
        try:
            t0 = self.clock()
            out = view.shadow_call(st.candidate, self._clone_args(args),
                                   _clone(kwargs))
            _wait(out)
            st.cand_times.append(self.clock() - t0)
            del out
            t0 = self.clock()
            out = view.shadow_call(st.incumbent, self._clone_args(args),
                                   _clone(kwargs))
            _wait(out)
            st.inc_times.append(self.clock() - t0)
            del out
        except Exception as e:
            # A sample can go stale (e.g. its buffers were consumed); drop
            # it (by identity — array equality is ambiguous) and move on.
            for idx, s in enumerate(st.samples):
                if s is sample:
                    del st.samples[idx]
                    break
            self.dropped_samples += 1
            logger.debug("shadow pair failed for %r: %s: %s", key,
                         type(e).__name__, e)
            _tb = telemetry.bus()
            if _tb is not None:
                _tb.emit("shadow.sample_drop", track=key,
                         error=type(e).__name__)
            return True                   # consumed budget regardless
        self.calls += 2
        _tb = telemetry.bus()
        if _tb is not None:
            _tb.emit("shadow.pair", track=key,
                     candidate_s=round(st.cand_times[-1], 6),
                     incumbent_s=round(st.inc_times[-1], 6),
                     pairs=min(len(st.cand_times), len(st.inc_times)))
        return True

    # -- verdict ------------------------------------------------------------------
    def verdict(self, key: Any) -> dict | None:
        """The candidate's judgment, or ``None`` while still measuring."""
        st = self._ctx.get(key)
        if st is None or st.candidate is None:
            return None
        measured = min(len(st.cand_times), len(st.inc_times))
        if measured >= self.k:
            cand = statistics.median(st.cand_times)
            inc = statistics.median(st.inc_times)
            return {
                "metric": (1.0 / cand) if cand > 0 else 0.0,
                "in_slo": cand <= self.tolerance * max(inc, 1e-12),
                "candidate_s": cand,
                "incumbent_s": inc,
                "pairs": measured,
                "measured": True,
            }
        if st.attempts >= self.max_attempts:
            # Could not measure within the attempt budget: fail safe — a
            # candidate is never admitted on missing evidence.
            return {"metric": 0.0, "in_slo": False, "candidate_s": None,
                    "incumbent_s": None, "pairs": measured,
                    "measured": False}
        return None

    def stats(self) -> dict:
        return {
            "contexts": len(self._ctx),
            "pending": len(self.pending()),
            "calls": self.calls,
            "dropped_samples": self.dropped_samples,
            "samples": sum(len(st.samples) for st in self._ctx.values()),
        }
