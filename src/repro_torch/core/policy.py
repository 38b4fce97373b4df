"""Specialization policies (paper §4.3).

The paper ships "a simple periodic exhaustive search strategy ... as a
library routine" and expects systems to compose custom strategies from
building blocks.  These are the building blocks:

* :class:`ExhaustiveSweep` — paper Fig 2b: try every configuration, dwell,
  keep the best by the end-to-end metric.
* :class:`CoordinateDescent` — tune one point at a time; scales to product
  spaces where exhaustive search is too slow (our hillclimbing driver).
* :class:`EpsilonGreedy` — keep exploiting the best, occasionally re-test.
* :class:`SuccessiveHalving` — racing: drop the losing half each rung.
* :class:`ContextualBandit` — UCB1 over a fixed candidate set (joint
  impl+tile configs); the Controller instantiates one per specialization
  context, so each workload class keeps its own arm statistics.
* :class:`ThompsonSampling` — posterior-sampling bandit (Gaussian or Beta
  posterior per arm), deterministic under an explicit seed; same
  per-context protocol as the UCB1 bandit.
* :class:`CostAwareUCB` — UCB1 whose acquisition score amortizes each
  arm's *expected compile cost* over the expected dwell window; the
  successor to the Controller's veto-only budget gate (cost shifts
  ordering and allocation instead of hard-excluding candidates).
* :class:`Explorer` — the legacy single-context lifecycle driver (handles
  instrument → explore → exploit and workload-change re-exploration, paper
  Fig 7/9).  New code should drive
  :class:`~repro_torch.core.controller.Controller`, which runs this lifecycle per
  workload context and adds compile-cost budgeting.
"""
from __future__ import annotations

import dataclasses
import enum
import logging
import math
import random
from typing import Any, Callable, Iterable, Mapping, Sequence

from repro_torch.core.metrics import ChangeDetector
from repro_torch.core.points import Config, SpecSpace, config_key

logger = logging.getLogger("repro_torch.core.policy")

__all__ = ["Policy", "ScoreBoard", "ExhaustiveSweep", "CoordinateDescent",
           "EpsilonGreedy", "SuccessiveHalving", "ContextualBandit",
           "CostAwareUCB", "ThompsonSampling", "Explorer", "Phase"]


class Policy:
    """Iterator protocol over candidate configurations.

    ``propose()`` returns the next configuration to try, or ``None`` when the
    exploration round is complete; ``observe(config, metric)`` feeds the
    measured end-to-end metric (higher is better); ``best()`` returns the
    winner so far.

    ``set_exclude(fn)`` installs a quarantine predicate: configs for which
    ``fn(config)`` is true are never proposed and never elected by
    ``best()`` (the safety layer uses this to keep rolled-back configs out
    of the candidate stream).  ``decay(factor)`` is the soft counterpart of
    ``reset()``: re-exploration after a detected change keeps a decayed
    prior over what was already learned instead of starting from scratch,
    so a transient blip does not throw away the incumbent's history.
    """

    _exclude_fn = None

    def set_exclude(self, fn) -> None:
        """Install a predicate marking configs that must never be proposed
        or elected (``None`` removes it)."""
        self._exclude_fn = fn

    def excluded(self, config: Config) -> bool:
        fn = self._exclude_fn
        return fn is not None and bool(fn(config))

    def decay(self, factor: float = 0.5) -> None:
        """Prepare for re-exploration while keeping a decayed prior.

        The base implementation falls back to a full ``reset()``; policies
        with observation state override this to shrink confidence by
        ``factor`` instead of discarding history.
        """
        self.reset()

    def reset(self) -> None:
        raise NotImplementedError

    def propose(self) -> dict | None:
        raise NotImplementedError

    def peek(self, n: int = 1) -> list[dict]:
        """Up to ``n`` upcoming candidates *without* consuming them.

        The Explorer hands these to ``Handler.prefetch`` so the compile
        pipeline builds them speculatively while the current candidate is
        still dwelling (paper §6.4: compilation off the critical path).
        Policies whose next proposal depends on unobserved metrics may
        return fewer than ``n`` (or none).
        """
        return []

    def observe(self, config: Config, metric: float) -> None:
        raise NotImplementedError

    def best(self) -> tuple[dict | None, float]:
        raise NotImplementedError


class ScoreBoard:
    """Freshest observation per config; ``best()`` breaks metric ties by
    first-observation order (the earliest config observed at the top metric
    wins — deterministic, and stable when re-observations refresh a score
    without changing it)."""

    def __init__(self):
        self.scores: dict[tuple, tuple[dict, float]] = {}

    def observe(self, config: Config, metric: float) -> None:
        key = config_key(config)
        prev = self.scores.get(key)
        # Keep the freshest observation (conditions drift over time) without
        # disturbing the insertion order that tie-breaking relies on.
        self.scores[key] = (dict(config), metric)
        del prev

    def best(self, exclude=None) -> tuple[dict | None, float]:
        entries = (self.scores.values() if exclude is None else
                   [cm for cm in self.scores.values() if not exclude(cm[0])])
        if not entries:
            return None, -math.inf
        # max() keeps the first of equal-metric entries in insertion order.
        cfg, metric = max(entries, key=lambda cm: cm[1])
        return dict(cfg), metric


#: Backwards-compatible private alias.
_ScoreBoard = ScoreBoard


class ExhaustiveSweep(Policy):
    """Try every candidate once (paper's library strategy)."""

    def __init__(self, candidates: Sequence[Config]):
        self.candidates = [dict(c) for c in candidates]
        self.reset()

    @classmethod
    def from_space(cls, space: SpecSpace, labels: Sequence[str] | None = None,
                   overrides: Mapping[str, Sequence[Any]] | None = None,
                   include_disabled: bool = False) -> "ExhaustiveSweep":
        return cls(space.configs(labels, overrides, include_disabled))

    def reset(self) -> None:
        self._queue = list(self.candidates)
        self._board = _ScoreBoard()

    def decay(self, factor: float = 0.5) -> None:
        # Re-sweep every candidate but keep the board: the incumbent's
        # standing survives a transient blip, and best() is answerable
        # immediately (no window where exploration has "forgotten" it).
        self._queue = list(self.candidates)

    def propose(self) -> dict | None:
        while self._queue:
            cfg = self._queue.pop(0)
            if not self.excluded(cfg):
                return cfg
        return None

    def peek(self, n: int = 1) -> list[dict]:
        out = [dict(c) for c in self._queue if not self.excluded(c)]
        return out[:n]

    def observe(self, config: Config, metric: float) -> None:
        self._board.observe(config, metric)

    def best(self) -> tuple[dict | None, float]:
        return self._board.best(exclude=self.excluded
                                if self._exclude_fn is not None else None)


class CoordinateDescent(Policy):
    """One point at a time: sweep a label's candidates with all other labels
    pinned at the incumbent, adopt the winner, move to the next label.
    Terminates after a full pass with no improvement (or ``max_passes``).

    Cost is sum(|axis|) per pass instead of prod(|axis|) — the practical
    choice for the multi-point spaces in our training steps.
    """

    def __init__(self, space: SpecSpace,
                 labels: Sequence[str] | None = None,
                 overrides: Mapping[str, Sequence[Any]] | None = None,
                 start: Config | None = None,
                 max_passes: int = 3,
                 rel_tol: float = 0.0):
        self.space = space
        self.labels = list(labels if labels is not None else space.labels())
        self.overrides = dict(overrides or {})
        self.start = dict(start or space.default_config())
        self.max_passes = max_passes
        self.rel_tol = rel_tol
        self.reset()

    def _axis(self, label: str) -> list:
        cands = list(self.overrides.get(label,
                                        self.space[label].candidates()))
        return cands

    def reset(self) -> None:
        self._incumbent = dict(self.start)
        self._incumbent_metric = -math.inf
        self._pass = 0
        self._label_i = 0
        self._axis_q: list[dict] = []
        self._improved_this_pass = False
        self._board = _ScoreBoard()
        self._done = False
        self._fill_axis()

    def _fill_axis(self) -> None:
        while self._label_i < len(self.labels):
            label = self.labels[self._label_i]
            axis = self._axis(label)
            q = []
            for v in axis:
                cfg = dict(self._incumbent)
                cfg[label] = v
                if config_key(cfg) != config_key(self._incumbent) or \
                        self._incumbent_metric == -math.inf:
                    q.append(cfg)
            if q:
                self._axis_q = q
                return
            self._label_i += 1
        # pass finished
        self._pass += 1
        if not self._improved_this_pass or self._pass >= self.max_passes:
            self._done = True
            return
        self._label_i = 0
        self._improved_this_pass = False
        self._fill_axis()

    def propose(self) -> dict | None:
        if self._done:
            return None
        if not self._axis_q:
            self._label_i += 1
            self._fill_axis()
            if self._done or not self._axis_q:
                return None
        return self._axis_q.pop(0)

    def peek(self, n: int = 1) -> list[dict]:
        # Only the remainder of the current axis is metric-independent; the
        # next axis re-pins to whatever incumbent wins this one.
        return [dict(c) for c in self._axis_q[:n]]

    def observe(self, config: Config, metric: float) -> None:
        self._board.observe(config, metric)
        if metric > self._incumbent_metric * (1 + self.rel_tol):
            if config_key(config) != config_key(self._incumbent):
                self._improved_this_pass = True
            self._incumbent = dict(config)
            self._incumbent_metric = metric

    def best(self) -> tuple[dict | None, float]:
        if self._incumbent_metric == -math.inf:
            return self._board.best()
        return dict(self._incumbent), self._incumbent_metric


class EpsilonGreedy(Policy):
    """Exploit the best-known config; with prob. eps re-test a random one."""

    def __init__(self, candidates: Sequence[Config], eps: float = 0.1,
                 seed: int = 0):
        self.candidates = [dict(c) for c in candidates]
        self.eps = eps
        self._rng = random.Random(seed)
        self.reset()

    def reset(self) -> None:
        self._board = _ScoreBoard()
        self._unseen = list(self.candidates)

    def propose(self) -> dict | None:
        if self._unseen:
            return self._unseen.pop(0)
        if self._rng.random() < self.eps:
            return dict(self._rng.choice(self.candidates))
        cfg, _ = self._board.best()
        return dict(cfg) if cfg is not None else None

    def peek(self, n: int = 1) -> list[dict]:
        return [dict(c) for c in self._unseen[:n]]

    def observe(self, config: Config, metric: float) -> None:
        self._board.observe(config, metric)

    def best(self) -> tuple[dict | None, float]:
        return self._board.best()


class SuccessiveHalving(Policy):
    """Racing: measure all survivors each rung, keep the top half."""

    def __init__(self, candidates: Sequence[Config], keep_frac: float = 0.5):
        self.candidates = [dict(c) for c in candidates]
        self.keep_frac = keep_frac
        self.reset()

    def reset(self) -> None:
        self._survivors = [dict(c) for c in self.candidates]
        self._queue = list(self._survivors)
        self._rung_scores: list[tuple[dict, float]] = []
        self._board = _ScoreBoard()

    def propose(self) -> dict | None:
        if not self._queue:
            if len(self._survivors) <= 1:
                return None
            self._rung_scores.sort(key=lambda cm: cm[1], reverse=True)
            keep = max(1, int(math.ceil(len(self._survivors) * self.keep_frac)))
            self._survivors = [c for c, _ in self._rung_scores[:keep]]
            self._rung_scores = []
            if len(self._survivors) <= 1:
                return None
            self._queue = [dict(c) for c in self._survivors]
        return self._queue.pop(0)

    def peek(self, n: int = 1) -> list[dict]:
        # Within a rung the measurement order is fixed; across rungs the
        # survivors depend on scores, so peeking stops at the rung edge.
        return [dict(c) for c in self._queue[:n]]

    def observe(self, config: Config, metric: float) -> None:
        self._board.observe(config, metric)
        self._rung_scores.append((dict(config), metric))

    def best(self) -> tuple[dict | None, float]:
        return self._board.best()


class ContextualBandit(Policy):
    """UCB1 bandit over a fixed candidate set (e.g. the joint impl+tile
    configuration space).

    The :class:`~repro_torch.core.controller.Controller` instantiates **one bandit
    per specialization context** (its policy-factory protocol), so every
    workload class keeps its own arm statistics — the "contextual" part is
    the per-context arm-set, not side information inside one instance.

    ``propose()`` first pulls every arm once (in candidate order), then
    maximizes ``mean + c * sqrt(2 ln N / n)``.  After ``rounds`` total
    proposals it returns ``None`` so the driver settles into EXPLOIT on
    ``best()`` (the arm with the highest running mean; ties break to the
    earliest candidate).  ``rounds=None`` keeps exploring forever.
    """

    def __init__(self, candidates: Sequence[Config], c: float = 1.0,
                 rounds: int | None = 0):
        self.candidates = [dict(cfg) for cfg in candidates]
        if not self.candidates:
            raise ValueError("ContextualBandit needs at least one candidate")
        self.c = float(c)
        #: rounds=0 (the default) means "auto": 4 pulls per arm.
        self.rounds = (4 * len(self.candidates) if rounds == 0 else rounds)
        self.reset()

    def reset(self) -> None:
        self._keys = [config_key(cfg) for cfg in self.candidates]
        self._pulls: dict[tuple, int] = {k: 0 for k in self._keys}
        self._means: dict[tuple, float] = {k: 0.0 for k in self._keys}
        self._observations = 0
        self._proposed = 0
        self._board = ScoreBoard()

    def decay(self, factor: float = 0.5) -> None:
        # Shrink confidence, keep what was learned: pulls scale down (never
        # below 1 for an observed arm, so means survive), the proposal
        # budget refills, and the UCB bonus widens — re-exploration starts
        # from a decayed prior instead of from scratch.
        for k, n in self._pulls.items():
            if n > 0:
                self._pulls[k] = max(1, int(round(n * factor)))
        self._observations = sum(self._pulls.values())
        self._proposed = 0

    def _unseen(self) -> list[dict]:
        return [cfg for cfg, k in zip(self.candidates, self._keys)
                if self._pulls[k] == 0 and not self.excluded(cfg)]

    def _ucb(self, key: tuple) -> float:
        n = self._pulls[key]
        if n == 0:
            return math.inf
        total = max(1, self._observations)
        return self._means[key] + self.c * math.sqrt(2 * math.log(total) / n)

    def propose(self) -> dict | None:
        if self.rounds is not None and self._proposed >= self.rounds:
            return None
        self._proposed += 1
        unseen = self._unseen()
        if unseen:
            return dict(unseen[0])
        allowed = [k for cfg, k in zip(self.candidates, self._keys)
                   if not self.excluded(cfg)]
        if not allowed:
            return None
        # max() keeps the earliest candidate among UCB ties.
        best_key = max(allowed, key=self._ucb)
        idx = self._keys.index(best_key)
        return dict(self.candidates[idx])

    def peek(self, n: int = 1) -> list[dict]:
        # Only the initial pull-each-arm-once phase is metric-independent.
        remaining = (None if self.rounds is None
                     else max(0, self.rounds - self._proposed))
        upcoming = self._unseen()
        if remaining is not None:
            upcoming = upcoming[:remaining]
        return [dict(cfg) for cfg in upcoming[:n]]

    def observe(self, config: Config, metric: float) -> None:
        key = config_key(config)
        if key not in self._pulls:        # tolerate out-of-set observations
            self._keys.append(key)
            self.candidates.append(dict(config))
            self._pulls[key] = 0
            self._means[key] = 0.0
        self._pulls[key] += 1
        self._observations += 1
        n = self._pulls[key]
        self._means[key] += (metric - self._means[key]) / n
        self._board.observe(config, metric)

    def arm_stats(self) -> list[dict]:
        """Per-arm pulls / running means (telemetry)."""
        return [{"config": dict(cfg), "pulls": self._pulls[k],
                 "mean": self._means[k]}
                for cfg, k in zip(self.candidates, self._keys)]

    def best(self) -> tuple[dict | None, float]:
        pulled = [(cfg, k) for cfg, k in zip(self.candidates, self._keys)
                  if self._pulls[k] > 0 and not self.excluded(cfg)]
        if not pulled:
            return None, -math.inf
        # max() keeps the earliest candidate among equal means.
        cfg, key = max(pulled, key=lambda ck: self._means[ck[1]])
        return dict(cfg), self._means[key]


class ThompsonSampling(Policy):
    """Thompson sampling over a fixed candidate set (ROADMAP: "wider policy
    library beyond UCB1").

    Each arm keeps a posterior over its metric; ``propose()`` samples every
    posterior and plays the argmax — exploration falls out of posterior
    uncertainty instead of an explicit bonus term.  Two posteriors:

    * ``"gaussian"`` (default) — unknown-mean Normal: arm mean ``m_k`` with
      sampling scale ``sqrt(var_hat / n_k)`` where ``var_hat`` pools the
      observed spread across all arms (Welford); before any spread is
      observed, ``prior_scale`` seeds the exploration width.  Works for
      unnormalized metrics like tokens/s.
    * ``"beta"`` — Beta(1 + successes, 1 + failures) for rewards in [0, 1]
      (metrics are clipped); the classic Bernoulli-bandit posterior.

    Deterministic given ``seed``: all draws come from one ``random.Random``,
    so the same observation sequence replays the same proposals.  Same
    protocol as :class:`ContextualBandit` (``propose``/``observe``/``peek``/
    ``best``; ``rounds=0`` = auto, 4x arms; ties break to the earliest
    candidate), so the :class:`~repro_torch.core.controller.Controller` can run
    one instance per specialization context via its policy-factory
    protocol.
    """

    def __init__(self, candidates: Sequence[Config], seed: int = 0,
                 rounds: int | None = 0, posterior: str = "gaussian",
                 prior_scale: float = 1.0):
        self.candidates = [dict(cfg) for cfg in candidates]
        if not self.candidates:
            raise ValueError("ThompsonSampling needs at least one candidate")
        if posterior not in ("gaussian", "beta"):
            raise ValueError(f"unknown posterior {posterior!r}; "
                             f"expected 'gaussian' or 'beta'")
        self.seed = seed
        self.posterior = posterior
        self.prior_scale = float(prior_scale)
        #: rounds=0 (the default) means "auto": 4 pulls per arm.
        self.rounds = (4 * len(self.candidates) if rounds == 0 else rounds)
        self.reset()

    def reset(self) -> None:
        self._rng = random.Random(self.seed)
        self._keys = [config_key(cfg) for cfg in self.candidates]
        self._pulls: dict[tuple, int] = {k: 0 for k in self._keys}
        self._means: dict[tuple, float] = {k: 0.0 for k in self._keys}
        self._m2: dict[tuple, float] = {k: 0.0 for k in self._keys}
        self._succ: dict[tuple, float] = {k: 0.0 for k in self._keys}
        self._observations = 0
        self._proposed = 0
        self._board = ScoreBoard()

    def decay(self, factor: float = 0.5) -> None:
        # Same decayed-prior contract as ContextualBandit.decay: keep means,
        # shrink confidence (pulls, Welford spread, Beta pseudo-counts) and
        # refill the proposal budget.
        for k, n in self._pulls.items():
            if n > 0:
                self._pulls[k] = max(1, int(round(n * factor)))
                self._m2[k] *= factor
                self._succ[k] *= factor
        self._observations = sum(self._pulls.values())
        self._proposed = 0

    def _unseen(self) -> list[dict]:
        return [cfg for cfg, k in zip(self.candidates, self._keys)
                if self._pulls[k] == 0 and not self.excluded(cfg)]

    def _pooled_std(self) -> float:
        """Pooled within-arm standard deviation (Welford M2 across arms);
        falls back to ``prior_scale`` until any arm has 2+ observations."""
        m2 = sum(self._m2.values())
        dof = sum(max(0, n - 1) for n in self._pulls.values())
        if dof == 0 or m2 <= 0.0:
            return self.prior_scale
        return math.sqrt(m2 / dof)

    def _sample(self, key: tuple) -> float:
        n = self._pulls[key]
        if self.posterior == "beta":
            a = 1.0 + self._succ[key]
            b = 1.0 + (n - self._succ[key])
            return self._rng.betavariate(a, b)
        scale = self._pooled_std() / math.sqrt(max(1, n))
        return self._rng.gauss(self._means[key], scale)

    def propose(self) -> dict | None:
        if self.rounds is not None and self._proposed >= self.rounds:
            return None
        self._proposed += 1
        unseen = self._unseen()
        if unseen:
            return dict(unseen[0])
        allowed = [k for cfg, k in zip(self.candidates, self._keys)
                   if not self.excluded(cfg)]
        if not allowed:
            return None
        # max() keeps the earliest candidate among equal draws.
        best_key = max(allowed, key=self._sample)
        idx = self._keys.index(best_key)
        return dict(self.candidates[idx])

    def peek(self, n: int = 1) -> list[dict]:
        # Only the initial pull-each-arm-once phase is deterministic without
        # burning posterior draws (peeking must not consume RNG state).
        remaining = (None if self.rounds is None
                     else max(0, self.rounds - self._proposed))
        upcoming = self._unseen()
        if remaining is not None:
            upcoming = upcoming[:remaining]
        return [dict(cfg) for cfg in upcoming[:n]]

    def observe(self, config: Config, metric: float) -> None:
        key = config_key(config)
        if key not in self._pulls:        # tolerate out-of-set observations
            self._keys.append(key)
            self.candidates.append(dict(config))
            self._pulls[key] = 0
            self._means[key] = 0.0
            self._m2[key] = 0.0
            self._succ[key] = 0.0
        if self.posterior == "beta":
            self._succ[key] += min(1.0, max(0.0, metric))
        self._pulls[key] += 1
        self._observations += 1
        n = self._pulls[key]
        delta = metric - self._means[key]
        self._means[key] += delta / n
        self._m2[key] += delta * (metric - self._means[key])
        self._board.observe(config, metric)

    def arm_stats(self) -> list[dict]:
        """Per-arm pulls / running means (telemetry)."""
        return [{"config": dict(cfg), "pulls": self._pulls[k],
                 "mean": self._means[k]}
                for cfg, k in zip(self.candidates, self._keys)]

    def best(self) -> tuple[dict | None, float]:
        pulled = [(cfg, k) for cfg, k in zip(self.candidates, self._keys)
                  if self._pulls[k] > 0 and not self.excluded(cfg)]
        if not pulled:
            return None, -math.inf
        # max() keeps the earliest candidate among equal means.
        cfg, key = max(pulled, key=lambda ck: self._means[ck[1]])
        return dict(cfg), self._means[key]


class CostAwareUCB(Policy):
    """UCB1 with compile-cost-aware acquisition (ROADMAP: successor to the
    veto-only budget gate).

    The Controller's ``budget`` gate *vetoes* candidates whose expected
    compile cost exceeds a multiple of the dwell window — a candidate is
    either affordable or invisible.  This policy folds the same telemetry
    (:meth:`~repro_torch.core.compile_service.CompileService.estimate_compile_s`
    via ``cost_fn``) into the acquisition score instead:

    ``score(arm) = ucb1(arm) - cost_weight * scale * compile_s / dwell_s``

    where the penalty applies only while the arm is *unbuilt* (cost is paid
    once; after the first pull — or when ``built_fn`` reports a cache hit —
    the arm competes on pure UCB1).  ``scale`` normalizes the dimensionless
    amortization ratio into metric units (the running mean |metric|, 1.0
    until anything is observed).  Consequences:

    * the initial pull-each-arm-once phase runs **cheapest-first** (stable
      by candidate order among equal costs), so measurement starts sooner;
    * when ``rounds`` is tighter than the arm count, the most expensive
      arms are the ones left unmeasured — graceful budget allocation where
      the veto gate was all-or-nothing;
    * unknown costs (``cost_fn`` returning ``None``) mean no penalty, so
      cold-telemetry behavior degrades to plain :class:`ContextualBandit`.

    Same propose/observe/peek/best protocol and conventions as the other
    bandits (``rounds=0`` = auto 4x arms; ties break to the earliest
    candidate; out-of-set observations tolerated; deepcopy-able for the
    Controller's policy-factory protocol).
    """

    def __init__(self, candidates: Sequence[Config], c: float = 1.0,
                 rounds: int | None = 0,
                 cost_fn: Callable[[Config], float | None] | None = None,
                 dwell_s: float = 1.0, cost_weight: float = 1.0,
                 built_fn: Callable[[Config], bool] | None = None):
        self.candidates = [dict(cfg) for cfg in candidates]
        if not self.candidates:
            raise ValueError("CostAwareUCB needs at least one candidate")
        self.c = float(c)
        self.cost_fn = cost_fn
        self.dwell_s = float(dwell_s)
        if self.dwell_s <= 0:
            raise ValueError(f"dwell_s must be positive, got {dwell_s!r}")
        self.cost_weight = float(cost_weight)
        self.built_fn = built_fn
        #: rounds=0 (the default) means "auto": 4 pulls per arm.
        self.rounds = (4 * len(self.candidates) if rounds == 0 else rounds)
        self.reset()

    def reset(self) -> None:
        self._keys = [config_key(cfg) for cfg in self.candidates]
        self._pulls: dict[tuple, int] = {k: 0 for k in self._keys}
        self._means: dict[tuple, float] = {k: 0.0 for k in self._keys}
        self._paid: set[tuple] = set()     # arms whose build cost is sunk
        self._observations = 0
        self._abs_sum = 0.0                # running sum of |metric| (scale)
        self._proposed = 0
        self._board = ScoreBoard()

    # -- cost model ------------------------------------------------------------
    def _scale(self) -> float:
        """Metric magnitude that converts the dimensionless compile/dwell
        ratio into metric units; 1.0 until anything is observed."""
        if self._observations == 0 or self._abs_sum == 0.0:
            return 1.0
        return self._abs_sum / self._observations

    def _penalty(self, cfg: Config, key: tuple) -> float:
        """Amortized compile cost of the arm in metric units (0 once the
        build is sunk — observed, or reported built by ``built_fn``)."""
        if key in self._paid:
            return 0.0
        if self.built_fn is not None and self.built_fn(cfg):
            return 0.0
        est = self.cost_fn(cfg) if self.cost_fn is not None else None
        if est is None or est <= 0.0:
            return 0.0
        return self.cost_weight * self._scale() * (est / self.dwell_s)

    def decay(self, factor: float = 0.5) -> None:
        # Decayed prior: keep means and sunk build costs (_paid), shrink
        # pull counts and the scale estimate, refill the proposal budget.
        old_obs = self._observations
        for k, n in self._pulls.items():
            if n > 0:
                self._pulls[k] = max(1, int(round(n * factor)))
        self._observations = sum(self._pulls.values())
        if old_obs > 0:
            self._abs_sum *= self._observations / old_obs
        self._proposed = 0

    def _unseen(self) -> list[tuple[dict, tuple]]:
        """Unpulled arms, cheapest amortized cost first (stable by candidate
        order among ties) — exploration starts on the affordable arms."""
        unseen = [(cfg, k) for cfg, k in zip(self.candidates, self._keys)
                  if self._pulls[k] == 0 and not self.excluded(cfg)]
        return sorted(unseen, key=lambda ck: self._penalty(ck[0], ck[1]))

    def _score(self, key: tuple) -> float:
        n = self._pulls[key]
        if n == 0:
            return math.inf
        total = max(1, self._observations)
        ucb = self._means[key] + self.c * math.sqrt(2 * math.log(total) / n)
        idx = self._keys.index(key)
        return ucb - self._penalty(self.candidates[idx], key)

    # -- protocol --------------------------------------------------------------
    def propose(self) -> dict | None:
        if self.rounds is not None and self._proposed >= self.rounds:
            return None
        self._proposed += 1
        unseen = self._unseen()
        if unseen:
            return dict(unseen[0][0])
        allowed = [k for cfg, k in zip(self.candidates, self._keys)
                   if not self.excluded(cfg)]
        if not allowed:
            return None
        # max() keeps the earliest candidate among score ties.
        best_key = max(allowed, key=self._score)
        idx = self._keys.index(best_key)
        return dict(self.candidates[idx])

    def peek(self, n: int = 1) -> list[dict]:
        # Only the initial cheapest-first pull phase is metric-independent.
        remaining = (None if self.rounds is None
                     else max(0, self.rounds - self._proposed))
        upcoming = [cfg for cfg, _ in self._unseen()]
        if remaining is not None:
            upcoming = upcoming[:remaining]
        return [dict(cfg) for cfg in upcoming[:n]]

    def observe(self, config: Config, metric: float) -> None:
        key = config_key(config)
        if key not in self._pulls:        # tolerate out-of-set observations
            self._keys.append(key)
            self.candidates.append(dict(config))
            self._pulls[key] = 0
            self._means[key] = 0.0
        self._paid.add(key)               # an observed arm was built
        self._pulls[key] += 1
        self._observations += 1
        self._abs_sum += abs(metric)
        n = self._pulls[key]
        self._means[key] += (metric - self._means[key]) / n
        self._board.observe(config, metric)

    def arm_stats(self) -> list[dict]:
        """Per-arm pulls / means / current amortized penalty (telemetry)."""
        return [{"config": dict(cfg), "pulls": self._pulls[k],
                 "mean": self._means[k], "penalty": self._penalty(cfg, k)}
                for cfg, k in zip(self.candidates, self._keys)]

    def best(self) -> tuple[dict | None, float]:
        pulled = [(cfg, k) for cfg, k in zip(self.candidates, self._keys)
                  if self._pulls[k] > 0 and not self.excluded(cfg)]
        if not pulled:
            return None, -math.inf
        # max() keeps the earliest candidate among equal means.
        cfg, key = max(pulled, key=lambda ck: self._means[ck[1]])
        return dict(cfg), self._means[key]


class Phase(enum.Enum):
    INSTRUMENT = "instrument"
    EXPLORE = "explore"
    EXPLOIT = "exploit"


class Explorer:
    """The lifecycle driver the fixed code embeds in its processing loop.

    Call :meth:`step` once per processed item/step.  The explorer dwells
    ``dwell`` iterations per candidate, reads the handler's throughput
    counter as the end-to-end metric, advances the policy, installs the
    winner, then watches for workload changes and re-explores (paper Fig 9:
    instrumentation phase ≈100 ms → exploration phase → exploit; re-trigger
    on ≥25% throughput change).
    """

    def __init__(
        self,
        handler,                       # repro_torch.core.runtime.Handler
        policy: Policy,
        dwell: int = 50,
        metric_fn: Callable[[], float] | None = None,
        change_detector: ChangeDetector | None = None,
        instrument_iters: int = 0,
        instrument_rate: float = 0.01,
        collectors: Mapping[str, Callable] | None = None,
        on_instrumented: Callable[["Explorer"], None] | None = None,
        wait_compiles: bool = True,
        skip_dwell_after_swap: int = 1,
        prefetch: int = 2,
        initial_config: Mapping[str, Any] | None = None,
    ):
        self.handler = handler
        self.policy = policy
        self.dwell = dwell
        self.metric_fn = metric_fn or (lambda: handler.tput.read())
        self.change = change_detector or ChangeDetector()
        self.instrument_iters = instrument_iters
        self.instrument_rate = instrument_rate
        self.collectors = dict(collectors or {})
        self.on_instrumented = on_instrumented
        self.wait_compiles = wait_compiles
        self.skip_dwell_after_swap = skip_dwell_after_swap
        #: speculatively compile the next N policy candidates while the
        #: current one dwells (paper §6.4: off-critical-path compilation);
        #: ignored by synchronous runtimes (no pipeline to overlap with).
        self.prefetch = max(0, int(prefetch))

        self.phase = Phase.INSTRUMENT if instrument_iters > 0 else Phase.EXPLORE
        self._iters = 0
        self._pending: dict | None = None
        self._explorations = 0
        self.history: list[tuple[Phase, dict | None, float]] = []
        if initial_config is not None:
            # A previous run already paid for the search (e.g. restored
            # spec state + warm variant cache): start exploiting its winner
            # and let the ChangeDetector trigger re-exploration if the
            # workload has shifted since.
            self._pending = dict(initial_config)
            self.handler.specialize(self._pending, wait=self.wait_compiles)
            self.phase = Phase.EXPLOIT
            self.handler.tput.reset()
        elif self.phase is Phase.INSTRUMENT:
            self.handler.enable_instrumentation(rate=instrument_rate,
                                                collectors=self.collectors)
        else:
            self._advance_policy()

    # -- internals -------------------------------------------------------------
    def _advance_policy(self) -> None:
        cfg = self.policy.propose()
        if cfg is None:
            best, metric = self.policy.best()
            if best is not None:
                self.handler.specialize(best, wait=self.wait_compiles)
            # Entering EXPLOIT: any still-queued speculative builds are for
            # candidates the policy has moved past — cancel them.
            self.handler.prefetch(())
            self.phase = Phase.EXPLOIT
            self._pending = dict(best) if best is not None else None
            logger.info("explorer: exploiting %s (metric=%.3f)", best, metric)
        else:
            self._pending = dict(cfg)
            self.handler.specialize(cfg, wait=self.wait_compiles)
            if self.prefetch:
                # Overlap this candidate's dwell window with the builds of
                # the next ones (speculative pipeline).
                self.handler.prefetch(self.policy.peek(self.prefetch))
            self.phase = Phase.EXPLORE
        self.handler.tput.reset()
        self._iters = 0

    def start_exploration(self) -> None:
        self._explorations += 1
        self.policy.reset()
        if self.instrument_iters > 0:
            self.phase = Phase.INSTRUMENT
            self.handler.recorders.clear()
            self.handler.enable_instrumentation(rate=self.instrument_rate,
                                                collectors=self.collectors)
            self.handler.tput.reset()
            self._iters = 0
        else:
            self._advance_policy()

    @property
    def explorations(self) -> int:
        return self._explorations

    # -- the per-iteration hook ---------------------------------------------------
    def step(self) -> None:
        self._iters += 1
        if self.phase is Phase.INSTRUMENT:
            if self._iters >= self.instrument_iters:
                self.handler.disable_instrumentation()
                if self.on_instrumented is not None:
                    self.on_instrumented(self)
                self._advance_policy()
            return
        if self.phase is Phase.EXPLORE:
            if self._iters >= self.dwell:
                metric = self.metric_fn()
                self.policy.observe(self._pending, metric)
                self.history.append((Phase.EXPLORE, dict(self._pending), metric))
                self._advance_policy()
            return
        # EXPLOIT: watch for workload change.
        if self._iters % self.dwell == 0:
            metric = self.metric_fn()
            self.handler.tput.reset()
            self.history.append((Phase.EXPLOIT, self._pending, metric))
            if self.change.update(metric):
                logger.info("explorer: change detected (metric=%.3f) — "
                            "re-exploring", metric)
                self.start_exploration()
