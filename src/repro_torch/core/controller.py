"""Controller: the unified, per-context explore/exploit driver.

Every launch script used to hand-roll the same loop: propose a candidate,
specialize, dwell, read a metric, observe, repeat, then exploit the winner
and watch for workload change.  The Controller owns that lifecycle — once
per **specialization context** (see ``IridescentRuntime.register(...,
context_fn=...)``): a serve loop mixing decode batch sizes 1/8/64 gets one
independent search per batch-shape class instead of thrashing a single
global specialization between them.

Two modes:

* **online** — ``Controller(handler, policy, ...)``; call :meth:`step`
  once per processed item.  Contexts are admitted as traffic reaches them;
  each runs propose → specialize → observe against its own throughput
  counter, settles into EXPLOIT on the policy's ``best()``, and re-explores
  when its :class:`~repro_torch.core.metrics.ChangeDetector` fires.
* **offline** — ``Controller(policy=..., measure=fn)`` + :meth:`run`; the
  propose → measure → observe loop for drivers whose metric is a synchronous
  measurement (e.g. the dry-run hillclimber), with no handler involved.

**Budgeted exploration** (ROADMAP): with ``budget=r`` the controller
consults the CompileService's Table-4 telemetry
(:meth:`~repro_torch.core.compile_service.CompileService.estimate_compile_s`)
before enqueueing a candidate and skips those whose expected compile cost
exceeds ``r x`` the context's expected dwell time — a candidate that costs
more to build than the window that would measure it cannot pay for itself.
Already-built variants are never skipped (their marginal cost is ~0).

``policy`` may be a :class:`~repro_torch.core.policy.Policy` instance or a
zero-argument factory; each context gets its own fresh policy (its own
arm-set / sweep state), so observations never leak between workload
classes.
"""
from __future__ import annotations

import copy
import logging
import math
import time
from typing import Any, Callable, Mapping

from repro_torch.core import telemetry
from repro_torch.core.metrics import ChangeDetector
from repro_torch.core.points import Config, config_key
from repro_torch.core.policy import ContextualBandit, CostAwareUCB, Phase, Policy

logger = logging.getLogger("repro_torch.core.controller")

__all__ = ["Controller"]

#: hard cap on proposals consumed per _next() call (defensive: a policy
#: endlessly re-proposing one over-budget candidate must not spin forever)
_MAX_PROPOSALS_PER_ADVANCE = 10000


class _CtxCtl:
    """Per-context controller state: one policy, one lifecycle."""

    __slots__ = ("view", "policy", "change", "phase", "pending", "history",
                 "skipped", "vetoed", "floored", "explorations", "mark_t",
                 "sec_per_call")

    def __init__(self, view, policy: Policy, change: ChangeDetector):
        self.view = view
        self.policy = policy
        self.change = change
        self.phase = Phase.EXPLORE
        self.pending: dict | None = None
        self.history: list[tuple[Phase, dict | None, float]] = []
        self.skipped: list[dict] = []
        #: config keys the budget gate refused (for this context's lifetime)
        self.vetoed: set = set()
        #: vetoed keys already fed one floor observation (never feed two:
        #: a second -inf would NaN a bandit's running mean)
        self.floored: set = set()
        self.explorations = 1
        self.mark_t = time.perf_counter()
        self.sec_per_call: float | None = None


class Controller:
    def __init__(
        self,
        handler=None,                    # repro_torch.core.runtime.Handler
        policy: "Policy | Callable[[], Policy] | None" = None,
        *,
        metric: Callable[[Any], float] | None = None,
        dwell: int = 50,
        budget: float | None = None,
        change_detector: "ChangeDetector | Callable[[], ChangeDetector] | None" = None,
        prefetch: int = 2,
        wait_compiles: bool = True,
        measure: Callable[[Config], float] | None = None,
        initial_configs: Mapping[Any, Config] | None = None,
        cost_fn: Callable[[Config], float | None] | None = None,
        sec_per_call_prior: float | None = None,
        candidates: "list[Config] | None" = None,
        cost_weight: float = 1.0,
        reexplore_decay: float = 0.5,
        quarantine=None,
    ):
        if handler is None and measure is None:
            raise ValueError("Controller needs a handler (online mode) or "
                             "a measure callable (offline mode)")
        self.handler = handler
        self.dwell = int(dwell)
        self.budget = budget
        self.prefetch = max(0, int(prefetch))
        self.wait_compiles = wait_compiles
        self.measure = measure
        self.metric = metric or (lambda view: view.tput.read())
        self.initial_configs = dict(initial_configs or {})
        #: seconds/call assumed before a context's first measured dwell —
        #: lets the budget gate act on the very first candidate; without
        #: it the gate stays off until one dwell has been timed.
        self.sec_per_call_prior = sec_per_call_prior
        #: confidence scale applied to the incumbent policy's statistics
        #: when a workload change triggers re-exploration (decayed prior:
        #: smaller = closer to a from-scratch restart)
        self.reexplore_decay = float(reexplore_decay)
        #: quarantine registry consulted before proposing/electing configs
        #: (duck-typed: ``blocked(handler_name, context_key, config)``)
        self.quarantine = quarantine
        self._change_factory = self._as_factory(
            change_detector if change_detector is not None else ChangeDetector(),
            ChangeDetector)
        if cost_fn is not None:
            self._cost_fn = cost_fn
        elif handler is not None:
            svc = handler.runtime.compile_service
            self._cost_fn = (lambda cfg: svc.estimate_compile_s(
                handler.name, config=cfg))
        else:
            self._cost_fn = lambda cfg: None
        if policy is None:
            policy = self._default_policy_factory(candidates, cost_weight)
        self._policy_factory = self._as_factory(policy, Policy)
        self._ctls: dict[Any, _CtxCtl] = {}
        self._offline: tuple[Policy, list] | None = None

    def _default_policy_factory(self, candidates, cost_weight: float):
        """Default policy when only a candidate list is given: with a
        compile ``budget``, :class:`CostAwareUCB` folds the same Table-4
        cost telemetry the veto gate consults into the acquisition score
        (the veto still applies on top as a hard ceiling); without one,
        a plain :class:`ContextualBandit`."""
        if candidates is None:
            raise ValueError("Controller requires a policy (instance or "
                             "zero-arg factory) or a candidates= list")
        cands = [dict(c) for c in candidates]
        if self.budget is None:
            return lambda: ContextualBandit(cands)
        dwell_s = (self.dwell * self.sec_per_call_prior
                   if self.sec_per_call_prior else 1.0)
        return lambda: CostAwareUCB(cands, cost_fn=self._cost_fn,
                                    dwell_s=dwell_s,
                                    cost_weight=cost_weight)

    @staticmethod
    def _as_factory(obj, cls) -> Callable:
        """Instance -> deepcopy-per-context factory; callable passes through.

        Giving each context a *fresh* copy of the pristine instance keeps
        per-context search state (arm statistics, sweep queues, change
        baselines) independent across workload classes.
        """
        if isinstance(obj, cls):
            pristine = copy.deepcopy(obj)

            def factory():
                fresh = copy.deepcopy(pristine)
                if hasattr(fresh, "reset"):
                    fresh.reset()
                return fresh

            return factory
        if callable(obj):
            return obj
        raise TypeError(f"expected a {cls.__name__} or factory, got {obj!r}")

    # -- telemetry ---------------------------------------------------------------
    def _emit(self, name: str, ctl: _CtxCtl, **payload) -> None:
        """One decision event on the flight recorder (one branch when the
        bus is disabled)."""
        _tb = telemetry.bus()
        if _tb is None:
            return
        handler = self.handler.name if self.handler is not None else None
        _tb.emit(name, track=ctl.view.key, handler=handler,
                 phase=ctl.phase.value, **payload)

    def _score_snapshot(self, ctl: _CtxCtl, limit: int = 16) -> list:
        """The election evidence: the most recent (phase, config, metric)
        observations that fed the policy's decision."""
        return [[ph.value, repr(cfg), round(m, 6)]
                for ph, cfg, m in ctl.history[-limit:]]

    # -- context admission -------------------------------------------------------
    def _initial_config_for(self, key: Any) -> dict | None:
        if key in self.initial_configs:
            cfg = self.initial_configs[key]
            return dict(cfg) if cfg is not None else None
        from repro_torch.core.runtime import encode_context_key
        enc = encode_context_key(key)
        if enc in self.initial_configs:
            cfg = self.initial_configs[enc]
            return dict(cfg) if cfg is not None else None
        if self.handler is not None:
            return self.handler.seeded_config(key)
        return None

    def _admit(self, key: Any) -> _CtxCtl:
        view = self.handler.context(key)
        ctl = _CtxCtl(view, self._policy_factory(), self._change_factory())
        ctl.sec_per_call = self.sec_per_call_prior
        self._emit("controller.admit", ctl)
        if self.quarantine is not None:
            name = self.handler.name
            ctl.policy.set_exclude(
                lambda cfg, _k=key: self.quarantine.blocked(name, _k, cfg))
        self._ctls[key] = ctl
        init = self._initial_config_for(key)
        if init is not None and self.handler.stale(init, key):
            # Points renamed or choices changed since it was saved: the
            # handler's space rejects it, so the context explores afresh.
            init = None
        if init is not None and self._quarantined(ctl, init):
            logger.warning("controller[%s/%r]: restored config %s is "
                           "quarantined; exploring fresh", self.handler.name,
                           key, init)
            init = None
        if init is not None:
            # A previous run already paid for this context's search: start
            # exploiting its winner; the ChangeDetector re-triggers
            # exploration if the workload has shifted since.  Best-effort,
            # like every restore path: a stale config (points renamed,
            # choices changed) falls back to a fresh exploration instead of
            # crashing the serving loop.
            try:
                view.specialize(init, wait=self.wait_compiles)
            except Exception as e:
                logger.warning(
                    "controller[%s/%r]: restored config %s no longer valid "
                    "(%s: %s); exploring fresh", self.handler.name, key,
                    init, type(e).__name__, e)
            else:
                ctl.pending = dict(init)
                ctl.phase = Phase.EXPLOIT
                view.tput.reset()
                ctl.mark_t = time.perf_counter()
                logger.info("controller[%s/%r]: warm start, exploiting %s",
                            self.handler.name, key, init)
                return ctl
        self._next(ctl)
        return ctl

    # -- candidate selection (with compile-cost budgeting) -----------------------
    def _over_budget(self, ctl: _CtxCtl, cfg: Config) -> bool:
        if self.budget is None or ctl.sec_per_call is None:
            return False
        if ctl.view.has_variant(cfg):
            return False                 # already built: marginal cost ~0
        est = self._cost_fn(cfg)
        if est is None:
            return False                 # no telemetry yet: never gate blind
        dwell_s = self.dwell * ctl.sec_per_call
        return est > self.budget * dwell_s

    def _quarantined(self, ctl: _CtxCtl, cfg: Config) -> bool:
        """Whether the quarantine registry blocks ``cfg`` for this context
        (a config rolled back after a bad promotion is never re-proposed)."""
        if self.quarantine is None:
            return False
        name = self.handler.name if self.handler is not None else ""
        return self.quarantine.blocked(name, ctl.view.key, cfg)

    def _next(self, ctl: _CtxCtl) -> None:
        """Advance the context's policy to its next candidate (skipping
        over-budget and quarantined ones) or into EXPLOIT."""
        exhausted = False
        for _ in range(_MAX_PROPOSALS_PER_ADVANCE):
            cfg = ctl.policy.propose()
            if cfg is None:
                exhausted = True
                break
            key = config_key(cfg)
            if key not in ctl.vetoed and not self._over_budget(ctl, cfg) \
                    and not self._quarantined(ctl, cfg):
                self._begin_candidate(ctl, cfg)
                break
            if key not in ctl.vetoed:
                ctl.vetoed.add(key)
                ctl.skipped.append(dict(cfg))
                logger.info("controller[%r]: skipping %s (over budget or "
                            "quarantined)", ctl.view.key, cfg)
                continue
            if key not in ctl.floored:
                # The policy re-proposed a vetoed candidate (e.g. a bandit
                # whose unseen-arm queue only advances on observe): feed
                # one floor observation so it moves on to the other arms.
                # Exactly once — see the `floored` slot comment.
                ctl.floored.add(key)
                ctl.policy.observe(cfg, -math.inf)
                continue
            # Still re-proposing an already-floored candidate: the policy
            # has nothing else to offer.
            exhausted = True
            break
        else:
            exhausted = True
        if exhausted:
            best, metric = ctl.policy.best()
            if best is not None and (config_key(best) in ctl.vetoed
                                     or self._quarantined(ctl, best)):
                # Never elect a config the budget gate refused to build or
                # that the safety layer quarantined.
                best, metric = None, -math.inf
            self._begin_exploit(ctl, best, metric)
        ctl.view.tput.reset()
        ctl.mark_t = time.perf_counter()

    # -- lifecycle transition hooks (the safety layer overrides these) -----------
    def _begin_candidate(self, ctl: _CtxCtl, cfg: Config) -> None:
        """Start measuring ``cfg``: activate it on live traffic and dwell.
        (The safety layer overrides this to evaluate in shadow instead.)"""
        ctl.pending = dict(cfg)
        self._emit("controller.propose", ctl, config=repr(cfg))
        ctl.view.specialize(cfg, wait=self.wait_compiles)
        if self.prefetch:
            # Overlap this candidate's dwell window with the builds of the
            # next ones (speculative pipeline).
            ctl.view.prefetch(ctl.policy.peek(self.prefetch))
        ctl.phase = Phase.EXPLORE

    def _begin_exploit(self, ctl: _CtxCtl, best: dict | None,
                       metric: float) -> None:
        """Exploration exhausted: activate the elected winner and settle.
        (The safety layer overrides this to stage a canary first.)"""
        if best is not None:
            ctl.view.specialize(best, wait=self.wait_compiles)
        # Entering EXPLOIT: any still-queued speculative builds are for
        # candidates the policy has moved past — cancel them.
        ctl.view.prefetch(())
        ctl.phase = Phase.EXPLOIT
        ctl.pending = dict(best) if best is not None else None
        self._emit("controller.settle", ctl, config=repr(best),
                   metric=(None if metric == -math.inf
                           else round(metric, 6)),
                   scores=self._score_snapshot(ctl))
        logger.info("controller[%r]: exploiting %s (metric=%.3f)",
                    ctl.view.key, best, metric)

    # -- the per-iteration hook --------------------------------------------------
    def step(self) -> None:
        """Call once per processed item (the fixed code's loop hook).

        Scans the handler's contexts; any context that has accumulated a
        full dwell window of calls advances its lifecycle.  New contexts are
        admitted on their first observed call.
        """
        if self.handler is None:
            raise RuntimeError("offline controller (measure=...): use run()")
        for key in self.handler.contexts():
            ctl = self._ctls.get(key)
            if ctl is None:
                view = self.handler.context(key)
                if view.calls() == 0:
                    continue             # no traffic yet: don't explore it
                ctl = self._admit(key)
            self._advance(ctl)

    def _advance(self, ctl: _CtxCtl) -> None:
        calls = ctl.view.tput.count()
        if calls < self.dwell:
            return
        now = time.perf_counter()
        dt = now - ctl.mark_t
        if calls and dt > 0:
            spc = dt / calls
            ctl.sec_per_call = (spc if ctl.sec_per_call is None
                                else 0.5 * spc + 0.5 * ctl.sec_per_call)
        rate = self.metric(ctl.view)
        ctl.view.window.observe(rate)
        if ctl.phase is Phase.EXPLORE:
            ctl.policy.observe(ctl.pending, rate)
            ctl.history.append((Phase.EXPLORE, dict(ctl.pending), rate))
            self._emit("controller.observe", ctl,
                       config=repr(ctl.pending), metric=round(rate, 6))
            self._next(ctl)
            return
        # EXPLOIT: watch for workload change.
        ctl.view.tput.reset()
        ctl.mark_t = now
        ctl.history.append((Phase.EXPLOIT,
                            dict(ctl.pending) if ctl.pending is not None
                            else None, rate))
        self._note_exploit(ctl, rate)
        prev = ctl.change.ewma.value
        if ctl.change.update(rate):
            self._on_change(ctl, rate, prev)

    def _note_exploit(self, ctl: _CtxCtl, rate: float) -> None:
        """Hook: one settled-phase observation (the safety layer tracks its
        in-SLO baseline here)."""

    def _on_change(self, ctl: _CtxCtl, rate: float,
                   prev: float | None) -> None:
        """The ChangeDetector fired during EXPLOIT.  Re-explore from a
        decayed prior: the incumbent's observation history survives (scaled
        by ``reexplore_decay``), so a transient single-dwell blip widens
        confidence bounds instead of restarting the search from scratch.
        (The safety layer overrides this to roll back first on regression.)"""
        logger.info("controller[%r]: change detected (metric=%.3f) — "
                    "re-exploring", ctl.view.key, rate)
        self._emit("controller.reexplore", ctl, metric=round(rate, 6),
                   prev=(round(prev, 6) if prev is not None else None))
        ctl.explorations += 1
        ctl.policy.decay(self.reexplore_decay)
        self._next(ctl)

    # -- offline mode ------------------------------------------------------------
    def run(self, max_steps: int = 100000) -> tuple[dict | None, float]:
        """Drive the policy synchronously against ``measure(config)`` until
        it is exhausted; returns ``(best config, best metric)``.

        This is the propose → measure → observe loop the launch drivers used
        to hand-roll; ``measure`` does whatever "try this configuration"
        means for the driver (a dry-run lowering, a timed probe, ...).
        """
        if self.measure is None:
            raise RuntimeError("online controller: use step(); run() needs "
                               "Controller(measure=...)")
        policy = self._policy_factory()
        history: list[tuple[dict, float]] = []
        for _ in range(max_steps):
            cfg = policy.propose()
            if cfg is None:
                break
            m = self.measure(cfg)
            policy.observe(cfg, m)
            history.append((dict(cfg), m))
        self._offline = (policy, history)
        return policy.best()

    # -- introspection -----------------------------------------------------------
    def contexts(self) -> list:
        return list(self._ctls)

    def settled(self, context: Any = None) -> bool:
        """Whether exploration has finished (every admitted context is in
        EXPLOIT; with ``context``, just that one).  Gate spec-state saves on
        this so a mid-sweep candidate never becomes the next restart's
        "winner"."""
        if context is not None:
            ctl = self._ctls.get(context)
            return ctl is not None and ctl.phase is Phase.EXPLOIT
        return bool(self._ctls) and all(c.phase is Phase.EXPLOIT
                                        for c in self._ctls.values())

    def best(self, context: Any = None) -> tuple[dict | None, float]:
        if self._offline is not None and context is None and not self._ctls:
            return self._offline[0].best()
        from repro_torch.core.runtime import DEFAULT_CONTEXT
        key = DEFAULT_CONTEXT if context is None else context
        ctl = self._ctls.get(key)
        if ctl is None:
            return None, -math.inf
        best, metric = ctl.policy.best()
        if best is None and ctl.pending is not None:
            # Warm start: the context exploits a restored config the policy
            # never proposed; report it with the latest observed rate.
            last = ctl.view.window.last()
            return dict(ctl.pending), (last if last is not None else -math.inf)
        return best, metric

    def settled_winners(self) -> dict:
        """Per-context ``(config, metric)`` for contexts settled in EXPLOIT
        — the publish hook of the fleet spec plane
        (:class:`~repro_torch.serve.fleet.SpecPlane`): only settled winners are
        shareable evidence, a mid-sweep candidate must never become another
        replica's warm start.  The metric is the policy's best observation,
        falling back to the context's latest windowed rate for warm-started
        contexts whose policy never proposed (no observations yet)."""
        out = {}
        for key, ctl in self._ctls.items():
            if ctl.phase is not Phase.EXPLOIT:
                continue
            cfg, metric = ctl.policy.best()
            if ctl.pending is not None:
                cfg = ctl.pending
            if cfg is None:
                continue
            if metric == -math.inf:
                last = ctl.view.window.last()
                metric = last if last is not None else 0.0
            out[key] = (dict(cfg), float(metric))
        return out

    def best_configs(self) -> dict:
        """Per-context winners (pending exploit config, else policy best)."""
        out = {}
        for key, ctl in self._ctls.items():
            cfg = ctl.pending if ctl.phase is Phase.EXPLOIT else None
            if cfg is None:
                cfg = ctl.policy.best()[0]
            out[key] = dict(cfg) if cfg is not None else None
        return out

    def histories(self) -> dict:
        """Per-context (phase, config, metric) observation logs."""
        return {key: list(ctl.history) for key, ctl in self._ctls.items()}

    @property
    def history(self) -> list:
        """Offline history, or the default context's online history."""
        if self._offline is not None:
            return list(self._offline[1])
        from repro_torch.core.runtime import DEFAULT_CONTEXT
        ctl = self._ctls.get(DEFAULT_CONTEXT)
        return list(ctl.history) if ctl is not None else []

    def status(self) -> dict:
        """Per-context lifecycle snapshot (phase, configs, skip counts)."""
        out = {}
        for key, ctl in self._ctls.items():
            best, best_metric = ctl.policy.best()
            out[key] = {
                "phase": ctl.phase.value,
                "active": ctl.view.active_config(),
                "pending": ctl.pending,
                "best": best,
                "best_metric": best_metric,
                "calls": ctl.view.calls(),
                "explorations": ctl.explorations,
                "skipped": len(ctl.skipped),
                "tput_window": ctl.view.window.summary(),
            }
        return out
