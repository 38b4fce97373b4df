"""Safe online exploration: shadow evaluation, canary activation, rollback.

The base :class:`~repro_torch.core.controller.Controller` activates every
candidate directly on production calls — at fleet scale one pathological
variant is a goodput outage, not an experiment.  This module wraps that
lifecycle in three safety stages:

* **shadow** — a candidate is built off-path and measured by re-executing
  mirrored live calls (see :class:`repro_torch.serve.shadow.ShadowEvaluator`);
  it accumulates K in-SLO observations without serving a user request.
* **canary** — the elected winner is admitted to a small slice of live
  traffic through the runtime's second dispatch slot
  (:meth:`~repro_torch.core.runtime.Handler.set_canary`) and promoted to full
  activation only after N consecutive in-SLO dwells
  (:class:`CanaryGate`).
* **rollback** — every promotion records the previous incumbent as the
  context's last-known-good; when the ChangeDetector fires on a
  regression after a promotion, the context atomically reverts
  (:meth:`~repro_torch.core.runtime.Handler.revert_to`) and the offending
  config is quarantined (:class:`Quarantine`) — never re-proposed this
  process lifetime, and published to the fleet
  :class:`~repro_torch.serve.fleet.SpecPlane` so other replicas skip it too.

:class:`SafetyController` is a drop-in Controller replacement; the serve
driver constructs it by default (``--no-safety`` restores the direct
activation behavior).
"""
from __future__ import annotations

import logging
import math
import threading
import time
from typing import Any, Mapping

from repro_torch.core.controller import Controller, _CtxCtl
from repro_torch.core.metrics import EWMA
from repro_torch.core.points import Config, config_key
from repro_torch.core.policy import Phase
from repro_torch.core.runtime import encode_context_key

logger = logging.getLogger("repro_torch.core.safety")

__all__ = ["CanaryGate", "Quarantine", "SafetyController"]


class Quarantine:
    """Registry of configs that must never serve again, keyed per
    (handler, context).  Thread-safe: the fleet plane poll loop absorbs
    remote quarantine entries concurrently with the controller's checks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, Any], dict[tuple, dict]] = {}

    def add(self, handler: str, context: Any, config: Config) -> bool:
        """Quarantine ``config``; returns False if it already was."""
        key = config_key(config)
        with self._lock:
            ctx = self._entries.setdefault((handler, context), {})
            if key in ctx:
                return False
            ctx[key] = dict(config)
            return True

    def blocked(self, handler: str, context: Any, config: Config) -> bool:
        with self._lock:
            ctx = self._entries.get((handler, context))
            return ctx is not None and config_key(config) in ctx

    def configs(self, handler: str, context: Any) -> list[dict]:
        with self._lock:
            ctx = self._entries.get((handler, context))
            return [dict(c) for c in ctx.values()] if ctx else []

    def by_context(self, handler: str) -> dict[Any, list[dict]]:
        """``{context_key: [config, ...]}`` for one handler (what the fleet
        plane publishes alongside winners)."""
        with self._lock:
            return {c: [dict(v) for v in m.values()]
                    for (h, c), m in self._entries.items()
                    if h == handler and m}

    def __len__(self) -> int:
        with self._lock:
            return sum(len(m) for m in self._entries.values())


class CanaryGate:
    """Canary admission policy: a candidate serves ``fraction`` of live
    traffic and is promoted only after ``promote_after`` *consecutive*
    dwells whose metric stays within ``tolerance`` of the incumbent's
    baseline; ``patience`` failed dwells reject it instead."""

    def __init__(self, fraction: float = 0.1, promote_after: int = 2,
                 tolerance: float = 0.75, patience: int = 6):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"canary fraction must be in (0, 1]: {fraction}")
        if promote_after < 1:
            raise ValueError(f"promote_after must be >= 1: {promote_after}")
        self.fraction = float(fraction)
        self.promote_after = int(promote_after)
        self.tolerance = float(tolerance)
        self.patience = max(1, int(patience))

    def start(self) -> "_CanaryRun":
        return _CanaryRun(self)


class _CanaryRun:
    """Dwell-by-dwell state of one canary probation."""

    __slots__ = ("gate", "ok", "bad")

    def __init__(self, gate: CanaryGate):
        self.gate = gate
        self.ok = 0
        self.bad = 0

    def observe(self, rate: float, baseline: float | None) -> str | None:
        """Feed one canary-dwell metric; returns ``"promote"``,
        ``"reject"``, or ``None`` (keep dwelling).  With no baseline yet
        (fresh context) a dwell counts as in-SLO: there is nothing to
        regress from."""
        in_slo = (baseline is None or baseline <= 0
                  or rate >= self.gate.tolerance * baseline)
        if in_slo:
            self.ok += 1
            if self.ok >= self.gate.promote_after:
                return "promote"
        else:
            self.ok = 0
            self.bad += 1
            if self.bad >= self.gate.patience:
                return "reject"
        return None


class _SafeCtx:
    """Per-context safety state riding alongside the base _CtxCtl."""

    __slots__ = ("stage", "baseline", "last_known_good", "incumbent", "run",
                 "promoted", "shadow_rejected")

    def __init__(self, baseline_alpha: float):
        self.stage = "live"                  # live | shadow | canary
        #: EWMA of the incumbent's settled live metric (the in-SLO bar
        #: canary dwells are judged against)
        self.baseline = EWMA(baseline_alpha)
        self.last_known_good: dict | None = None
        self.incumbent: dict | None = None   # active config when canary began
        self.run: _CanaryRun | None = None
        self.promoted = False                # a promotion happened and stands
        self.shadow_rejected: set = set()    # config keys that failed shadow


class SafetyController(Controller):
    """Controller with the shadow → canary → promote → rollback lifecycle.

    ``shadow`` is a duck-typed evaluator (``begin(key, candidate,
    incumbent)`` / ``verdict(key) -> {"metric", "in_slo", ...} | None`` /
    ``clear(key)``) — normally a
    :class:`~repro_torch.serve.shadow.ShadowEvaluator`; with ``shadow=None``
    candidates explore on live traffic as before, but the canary gate and
    auto-rollback still apply.  All base Controller kwargs pass through.
    """

    def __init__(self, handler=None, policy=None, *,
                 shadow=None, gate: CanaryGate | None = None,
                 canary_frac: float = 0.1, promote_after: int = 2,
                 canary_tolerance: float = 0.75, canary_patience: int = 6,
                 baseline_alpha: float = 0.3,
                 quarantine: Quarantine | None = None,
                 initial_last_known_good: Mapping[Any, Config] | None = None,
                 **kwargs):
        self.shadow = shadow
        self.gate = gate if gate is not None else CanaryGate(
            canary_frac, promote_after, canary_tolerance, canary_patience)
        self.baseline_alpha = float(baseline_alpha)
        self._initial_lkg = {k: dict(v) for k, v in
                             (initial_last_known_good or {}).items()
                             if v is not None}
        self._safe: dict[Any, _SafeCtx] = {}
        self.rollbacks = 0
        self.promotions = 0
        self.shadow_rejections = 0
        self.canary_rejections = 0
        super().__init__(handler, policy,
                         quarantine=(quarantine if quarantine is not None
                                     else Quarantine()),
                         **kwargs)

    # -- per-context safety state -----------------------------------------------
    def _st(self, ctl: _CtxCtl) -> _SafeCtx:
        key = ctl.view.key
        st = self._safe.get(key)
        if st is None:
            st = _SafeCtx(self.baseline_alpha)
            lkg = self._initial_lkg.get(key)
            if lkg is None:
                lkg = self._initial_lkg.get(encode_context_key(key))
            if lkg is not None:
                st.last_known_good = dict(lkg)
            self._safe[key] = st
        return st

    def _admit(self, key: Any) -> _CtxCtl:
        ctl = super()._admit(key)
        st = self._st(ctl)
        if (ctl.phase is Phase.EXPLOIT and ctl.pending is not None
                and st.last_known_good is None):
            # Warm start: a previous run already proved this config; it is
            # the context's last-known-good until something better promotes.
            st.last_known_good = dict(ctl.pending)
        return ctl

    # -- lifecycle hook overrides -------------------------------------------------
    def _begin_candidate(self, ctl: _CtxCtl, cfg: Config) -> None:
        st = self._st(ctl)
        if self.shadow is None:
            st.stage = "live"
            super()._begin_candidate(ctl, cfg)
            return
        # Shadow stage: build the candidate off-path and let the evaluator
        # mirror live calls against it; the incumbent keeps serving 100%.
        st.stage = "shadow"
        ctl.pending = dict(cfg)
        ctl.phase = Phase.EXPLORE
        ctl.view.build(cfg, wait=self.wait_compiles)
        self.shadow.begin(ctl.view.key, dict(cfg), ctl.view.active_config())

    def _begin_exploit(self, ctl: _CtxCtl, best: dict | None,
                       metric: float) -> None:
        st = self._st(ctl)
        if best is not None and config_key(best) in st.shadow_rejected:
            # A shadow-failed candidate must never be elected, even if its
            # shadow metric topped the board.
            best, metric = None, -math.inf
        active = ctl.view.active_config()
        if best is None or config_key(best) == config_key(active):
            st.stage = "live"
            super()._begin_exploit(ctl, best, metric)
            if self.shadow is not None and st.baseline.value is not None:
                # The baseline tracked the active config through the shadow
                # stage: arm the detector at that level so a regression in
                # the very next dwell is already change-checked.
                ctl.change.seed(st.baseline.value)
            return
        # Canary stage: the winner gets a slice of live traffic first.
        st.stage = "canary"
        st.incumbent = dict(active)
        st.run = self.gate.start()
        ctl.pending = dict(best)
        ctl.phase = Phase.EXPLORE
        ctl.view.prefetch(())
        ctl.view.set_canary(best, self.gate.fraction,
                            wait=self.wait_compiles)
        self._emit("safety.canary_admit", ctl, config=repr(best),
                   incumbent=repr(active), fraction=self.gate.fraction,
                   baseline=st.baseline.value)
        logger.info("safety[%r]: canarying %s at %.0f%% of traffic",
                    ctl.view.key, best, 100.0 * self.gate.fraction)

    def _advance(self, ctl: _CtxCtl) -> None:
        st = self._st(ctl)
        if st.stage == "shadow":
            self._advance_shadow(ctl, st)
        elif st.stage == "canary":
            self._advance_canary(ctl, st)
        else:
            super()._advance(ctl)

    # -- shadow stage -------------------------------------------------------------
    def _dwell_tick(self, ctl: _CtxCtl) -> float | None:
        """One live dwell window (same accounting as the base _advance
        head); returns the windowed metric or None if still dwelling."""
        calls = ctl.view.tput.count()
        if calls < self.dwell:
            return None
        now = time.perf_counter()
        dt = now - ctl.mark_t
        if calls and dt > 0:
            spc = dt / calls
            ctl.sec_per_call = (spc if ctl.sec_per_call is None
                                else 0.5 * spc + 0.5 * ctl.sec_per_call)
        rate = self.metric(ctl.view)
        ctl.view.window.observe(rate)
        ctl.view.tput.reset()
        ctl.mark_t = now
        return rate

    def _advance_shadow(self, ctl: _CtxCtl, st: _SafeCtx) -> None:
        rate = self._dwell_tick(ctl)
        if rate is not None:
            # The incumbent serves all live traffic while shadowing: these
            # dwells keep its baseline fresh for the canary gate.
            st.baseline.update(rate)
        verdict = self.shadow.verdict(ctl.view.key)
        if verdict is None:
            return                       # still accumulating observations
        cfg = dict(ctl.pending) if ctl.pending is not None else None
        self.shadow.clear(ctl.view.key)
        st.stage = "live"
        if cfg is not None:
            ctl.policy.observe(cfg, verdict["metric"])
            ctl.history.append((Phase.EXPLORE, dict(cfg),
                                verdict["metric"]))
            self._emit("safety.shadow_verdict", ctl, config=repr(cfg),
                       metric=verdict.get("metric"),
                       in_slo=bool(verdict.get("in_slo")),
                       pairs=verdict.get("pairs"))
            if not verdict["in_slo"]:
                st.shadow_rejected.add(config_key(cfg))
                self.shadow_rejections += 1
                logger.info("safety[%r]: candidate %s failed shadow "
                            "evaluation (%s)", ctl.view.key, cfg, verdict)
        self._next(ctl)

    # -- canary stage -------------------------------------------------------------
    def _advance_canary(self, ctl: _CtxCtl, st: _SafeCtx) -> None:
        rate = self._dwell_tick(ctl)
        if rate is None:
            return
        ctl.history.append((Phase.EXPLORE,
                            dict(ctl.pending) if ctl.pending else None,
                            rate))
        decision = st.run.observe(rate, st.baseline.value) if st.run else None
        if decision == "promote":
            self._promote(ctl, st)
        elif decision == "reject":
            self._reject_canary(ctl, st)

    def _promote(self, ctl: _CtxCtl, st: _SafeCtx) -> None:
        # Record the incumbent as last-known-good *before* the swap: this
        # is what a rollback restores.
        st.last_known_good = (dict(st.incumbent)
                              if st.incumbent is not None else {})
        promoted = ctl.view.promote_canary(wait=self.wait_compiles)
        if promoted is None:
            # The canary build never armed (superseded); treat as a failed
            # probation without quarantining — nothing misbehaved.
            self._reject_canary(ctl, st, quarantine=False)
            return
        st.stage = "live"
        st.run = None
        st.promoted = True
        ctl.pending = dict(promoted)
        ctl.phase = Phase.EXPLOIT
        self.promotions += 1
        if st.baseline.value is not None:
            # Arm the detector at the incumbent's level: a regression right
            # after promotion must not hide inside the warmup window.
            ctl.change.seed(st.baseline.value)
        self._emit("safety.promote", ctl, config=repr(promoted),
                   last_known_good=repr(st.last_known_good),
                   baseline=st.baseline.value)
        logger.info("safety[%r]: promoted %s after %d in-SLO canary dwells",
                    ctl.view.key, promoted, self.gate.promote_after)

    def _reject_canary(self, ctl: _CtxCtl, st: _SafeCtx,
                       quarantine: bool = True) -> None:
        cfg = dict(ctl.pending) if ctl.pending is not None else None
        ctl.view.clear_canary()
        self._emit("safety.canary_reject", ctl, config=repr(cfg),
                   quarantined=bool(cfg is not None and quarantine),
                   baseline=st.baseline.value)
        if cfg is not None and quarantine:
            self.quarantine.add(self.handler.name, ctl.view.key, cfg)
            self.canary_rejections += 1
            self._emit("safety.quarantine", ctl, config=repr(cfg),
                       reason="canary_reject")
            logger.warning("safety[%r]: canary %s failed probation; "
                           "quarantined", ctl.view.key, cfg)
        st.stage = "live"
        st.run = None
        ctl.phase = Phase.EXPLOIT
        ctl.pending = (dict(st.incumbent)
                       if st.incumbent is not None else None)
        if st.baseline.value is not None:
            ctl.change.seed(st.baseline.value)

    # -- settled-phase hooks ------------------------------------------------------
    def _note_exploit(self, ctl: _CtxCtl, rate: float) -> None:
        self._st(ctl).baseline.update(rate)

    def _on_change(self, ctl: _CtxCtl, rate: float,
                   prev: float | None) -> None:
        st = self._st(ctl)
        regression = prev is not None and prev > 0 and rate < prev
        if regression and st.promoted and st.last_known_good is not None:
            active = ctl.view.active_config()
            lkg = st.last_known_good
            if config_key(active) != config_key(lkg):
                # Auto-rollback: atomically revert to last-known-good and
                # quarantine the config that regressed after promotion.
                self.quarantine.add(self.handler.name, ctl.view.key, active)
                ctl.view.revert_to(lkg, wait=self.wait_compiles)
                ctl.pending = dict(lkg)
                ctl.phase = Phase.EXPLOIT
                st.stage = "live"
                st.promoted = False
                self.rollbacks += 1
                # Re-arm the detector at the pre-regression level so the
                # recovery back to it does not read as another change.
                ctl.change.seed(prev)
                self._emit("safety.rollback", ctl, config=repr(active),
                           restored=repr(lkg), metric=round(rate, 6),
                           prev=round(prev, 6))
                self._emit("safety.quarantine", ctl, config=repr(active),
                           reason="rollback")
                logger.warning(
                    "safety[%r]: regression after promotion (%.3f -> %.3f); "
                    "reverted to last-known-good %s and quarantined %s",
                    ctl.view.key, prev, rate, lkg, active)
                return
        super()._on_change(ctl, rate, prev)

    # -- introspection / persistence ---------------------------------------------
    def quarantined_configs(self) -> dict:
        """Per-context quarantine lists (what the fleet plane publishes)."""
        if self.handler is None:
            return {}
        return self.quarantine.by_context(self.handler.name)

    def last_known_good(self) -> dict:
        """Encoded context key -> last-known-good config (v3 state field)."""
        return {encode_context_key(k): dict(st.last_known_good)
                for k, st in self._safe.items()
                if st.last_known_good is not None}

    def safety_state(self) -> dict:
        """The payload ``save_spec_state(..., safety=...)`` persists for
        this controller's handler."""
        return {
            "last_known_good": self.last_known_good(),
            "quarantined": {encode_context_key(k): v for k, v in
                            self.quarantined_configs().items()},
        }

    def safety_status(self) -> dict:
        per_ctx = {}
        for key, ctl in self._ctls.items():
            st = self._safe.get(key)
            if st is None:
                continue
            per_ctx[encode_context_key(key)] = {
                "stage": st.stage,
                "promoted": st.promoted,
                "last_known_good": (dict(st.last_known_good)
                                    if st.last_known_good is not None
                                    else None),
                "baseline": st.baseline.value,
                "quarantined": self.quarantine.configs(
                    self.handler.name, key) if self.handler else [],
            }
        return {
            "rollbacks": self.rollbacks,
            "promotions": self.promotions,
            "shadow_rejections": self.shadow_rejections,
            "canary_rejections": self.canary_rejections,
            "quarantined": len(self.quarantine),
            "contexts": per_ctx,
        }
