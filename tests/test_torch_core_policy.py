"""The reference's scenarios of ``tests/test_core_policy.py``, held against the
port: each test keeps its name there.

Policies + explorer lifecycle."""
import math

import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import (ChangeDetector, ContextualBandit, CoordinateDescent,  # noqa: E402
                              CostAwareUCB, EpsilonGreedy, ExhaustiveSweep,
                              ScoreBoard, SuccessiveHalving)
from repro_torch.core.points import EnumPoint, SpecSpace  # noqa: E402


def _space(axes: dict) -> SpecSpace:
    s = SpecSpace()
    for label, choices in axes.items():
        s.register(EnumPoint(label, choices[0], choices=tuple(choices)))
    return s


def _drive(policy, metric_fn):
    while True:
        cfg = policy.propose()
        if cfg is None:
            return policy.best()
        policy.observe(cfg, metric_fn(cfg))


def test_exhaustive_finds_argmax():
    space = _space({"b": (1, 2, 4, 8)})
    pol = ExhaustiveSweep.from_space(space, labels=["b"])
    best, metric = _drive(pol, lambda c: -abs(c["b"] - 4))
    assert best["b"] == 4 and metric == 0


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 100), min_size=2, max_size=6, unique=True))
def test_property_exhaustive_optimal(vals):
    space = _space({"x": tuple(vals)})
    pol = ExhaustiveSweep.from_space(space, labels=["x"])
    best, _ = _drive(pol, lambda c: float(c["x"]))
    assert best["x"] == max(vals)


def test_coordinate_descent_separable():
    space = _space({"a": (0, 1, 2, 3), "b": (0, 1, 2, 3), "c": (0, 1, 2)})
    pol = CoordinateDescent(space)
    best, _ = _drive(pol, lambda c: -((c.get("a") or 0) - 2) ** 2
                     - ((c.get("b") or 0) - 3) ** 2
                     - ((c.get("c") or 0) - 1) ** 2)
    assert (best["a"], best["b"], best["c"]) == (2, 3, 1)


def test_coordinate_descent_cheaper_than_exhaustive():
    space = _space({"a": tuple(range(8)), "b": tuple(range(8)),
                    "c": tuple(range(8))})
    pol = CoordinateDescent(space)
    evals = 0
    while True:
        cfg = pol.propose()
        if cfg is None:
            break
        evals += 1
        pol.observe(cfg, -(cfg.get("a") or 0))
    assert evals < 8 ** 3 / 4   # far below the 512-config product space


def test_epsilon_greedy_exploits():
    space = _space({"x": (1, 2, 3)})
    pol = EpsilonGreedy(space.configs(labels=["x"]), eps=0.0, seed=1)
    for _ in range(10):
        cfg = pol.propose()
        pol.observe(cfg, float(cfg["x"] == 2))
    assert pol.best()[0]["x"] == 2
    assert pol.propose()["x"] == 2   # pure exploitation now


def test_successive_halving_converges():
    cands = [{"x": i} for i in range(8)]
    pol = SuccessiveHalving(cands)
    best, _ = _drive(pol, lambda c: float(c["x"]))
    assert best["x"] == 7


def test_change_detector():
    cd = ChangeDetector(threshold=0.25, warmup=2)
    for _ in range(8):
        assert not cd.update(100.0)
    assert cd.update(10.0)        # -90% -> change
    for _ in range(8):
        assert not cd.update(10.0)   # re-baselined
    assert cd.update(20.0)        # +100% -> change


def test_change_detector_ignores_noise():
    cd = ChangeDetector(threshold=0.25, warmup=2)
    vals = [100, 102, 98, 101, 99, 103, 97, 100]
    assert not any(cd.update(v) for v in vals)


# --- peek(n) across all shipped policies ----------------------------------------

def test_exhaustive_peek_does_not_consume():
    pol = ExhaustiveSweep([{"x": i} for i in range(4)])
    assert pol.peek(2) == [{"x": 0}, {"x": 1}]
    assert pol.peek(10) == [{"x": i} for i in range(4)]   # clamped
    assert pol.propose() == {"x": 0}                      # unchanged by peek
    assert pol.peek(1) == [{"x": 1}]


def test_coordinate_descent_peek_stops_at_axis_edge():
    """Only the remainder of the current axis is metric-independent: the
    next axis re-pins to whatever incumbent wins this one."""
    space = _space({"a": (0, 1, 2), "b": (0, 1)})
    pol = CoordinateDescent(space)
    first = pol.propose()
    upcoming = pol.peek(10)
    assert upcoming                                        # rest of axis 'a'
    assert all(set(c) == set(first) for c in upcoming)
    assert all(c["b"] == first["b"] for c in upcoming)     # axis 'b' pinned
    # peeked configs come back from propose() in the same order
    for expect in upcoming:
        assert pol.propose() == expect


def test_epsilon_greedy_peek_covers_unseen_only():
    cands = [{"x": i} for i in range(3)]
    pol = EpsilonGreedy(cands, eps=0.0, seed=0)
    assert pol.peek(5) == cands                            # initial sweep
    for cfg in cands:
        assert pol.propose() == cfg
        pol.observe(cfg, float(cfg["x"]))
    assert pol.peek(5) == []      # exploitation: next pick is metric-driven


def test_successive_halving_peek_stops_at_rung_edge():
    cands = [{"x": i} for i in range(4)]
    pol = SuccessiveHalving(cands)
    assert pol.peek(10) == cands                           # full first rung
    for cfg in cands:
        assert pol.propose() == cfg
        pol.observe(cfg, float(cfg["x"]))
    assert pol.peek(10) == []     # survivors depend on this rung's scores


def test_contextual_bandit_peek_covers_unpulled_arms_only():
    pol = ContextualBandit([{"x": i} for i in range(3)], rounds=10)
    assert pol.peek(5) == [{"x": 0}, {"x": 1}, {"x": 2}]
    cfg = pol.propose()
    pol.observe(cfg, 1.0)
    assert pol.peek(5) == [{"x": 1}, {"x": 2}]
    for _ in range(2):
        pol.observe(pol.propose(), 1.0)
    assert pol.peek(5) == []      # all arms pulled: UCB is metric-driven


def test_peek_returns_copies():
    pol = ExhaustiveSweep([{"x": 0}])
    peeked = pol.peek(1)[0]
    peeked["x"] = 99
    assert pol.propose() == {"x": 0}                       # not aliased


# --- ScoreBoard / best() tie-breaking -------------------------------------------

def test_scoreboard_tie_breaks_to_first_observed():
    board = ScoreBoard()
    board.observe({"x": "late_tie"}, 1.0)
    board.observe({"x": "winner"}, 2.0)
    board.observe({"x": "tie"}, 2.0)                       # same metric, later
    assert board.best()[0] == {"x": "winner"}


def test_scoreboard_refresh_keeps_insertion_order():
    board = ScoreBoard()
    board.observe({"x": "a"}, 2.0)
    board.observe({"x": "b"}, 2.0)
    board.observe({"x": "a"}, 2.0)     # re-observation must not demote 'a'
    assert board.best()[0] == {"x": "a"}


@pytest.mark.parametrize("make", [
    lambda c: ExhaustiveSweep(c),
    lambda c: EpsilonGreedy(c, eps=0.0, seed=0),
    lambda c: SuccessiveHalving(c),
    lambda c: ContextualBandit(c, rounds=len(c)),
    lambda c: CostAwareUCB(c, rounds=len(c)),
])
def test_best_tie_break_deterministic_across_policies(make):
    """All shipped policies break best() ties to the earliest-observed
    candidate (candidate order), so equal-metric sweeps are reproducible."""
    cands = [{"x": i} for i in range(4)]
    pol = make(cands)
    while True:
        cfg = pol.propose()
        if cfg is None:
            break
        pol.observe(cfg, 1.0)                              # all metrics equal
        if isinstance(pol, EpsilonGreedy) and pol.peek(1) == []:
            break                  # eps=0 exploitation loops forever
    assert pol.best()[0] == cands[0]


def test_coordinate_descent_best_tie_keeps_incumbent():
    space = _space({"a": (0, 1, 2)})
    pol = CoordinateDescent(space)
    first = pol.propose()
    pol.observe(first, 1.0)
    while True:
        cfg = pol.propose()
        if cfg is None:
            break
        pol.observe(cfg, 1.0)      # ties: strictly-greater required to adopt
    assert pol.best()[0] == first


# -- Thompson sampling ---------------------------------------------------------

def test_thompson_finds_argmax_gaussian():
    from repro_torch.core import ThompsonSampling
    cands = [{"b": b} for b in (1, 2, 4, 8)]
    pol = ThompsonSampling(cands, seed=0, rounds=40)
    best, metric = _drive(pol, lambda c: float(c["b"]))
    assert best == {"b": 8} and metric == pytest.approx(8.0)


def test_thompson_beta_posterior_converges():
    from repro_torch.core import ThompsonSampling
    cands = [{"arm": i} for i in range(3)]
    pol = ThompsonSampling(cands, seed=1, rounds=60, posterior="beta")
    rewards = {0: 0.1, 1: 0.9, 2: 0.3}
    best, _ = _drive(pol, lambda c: rewards[c["arm"]])
    assert best == {"arm": 1}
    stats = {s["config"]["arm"]: s["pulls"] for s in pol.arm_stats()}
    assert stats[1] > stats[0] and stats[1] > stats[2]  # it exploited arm 1


def test_thompson_deterministic_under_seed():
    from repro_torch.core import ThompsonSampling
    cands = [{"x": i} for i in range(4)]

    def trace(seed):
        pol = ThompsonSampling(cands, seed=seed, rounds=24)
        out = []
        while True:
            cfg = pol.propose()
            if cfg is None:
                return out
            pol.observe(cfg, float(cfg["x"] % 3))
            out.append(cfg["x"])

    assert trace(7) == trace(7)               # same seed -> same proposals
    assert trace(7) != trace(8)               # different stream explores
    from copy import deepcopy
    pol = ThompsonSampling(cands, seed=7)
    clone = deepcopy(pol)                     # Controller's factory protocol
    clone.reset()
    assert [clone.propose() for _ in range(4)] == \
        [pol.propose() for _ in range(4)]


def test_thompson_peek_covers_unseen_without_burning_rng():
    from repro_torch.core import ThompsonSampling
    cands = [{"x": i} for i in range(3)]
    pol = ThompsonSampling(cands, seed=0, rounds=12)
    assert pol.peek(2) == cands[:2]
    before = pol._rng.getstate()
    pol.peek(3)
    assert pol._rng.getstate() == before      # peeking consumed no draws
    for cfg in cands:
        pol.observe(cfg, 1.0)
        pol.propose()
    assert pol.peek(2) == []                  # all arms pulled


def test_thompson_invalid_args():
    from repro_torch.core import ThompsonSampling
    with pytest.raises(ValueError):
        ThompsonSampling([])
    with pytest.raises(ValueError):
        ThompsonSampling([{"x": 1}], posterior="dirichlet")


# -- cost-aware UCB -------------------------------------------------------------

def _costs(table):
    return lambda cfg: table.get(cfg["x"])


def test_cost_aware_finds_argmax():
    cands = [{"x": i} for i in range(4)]
    pol = CostAwareUCB(cands, rounds=32,
                       cost_fn=_costs({0: 0.5, 1: 0.5, 2: 0.5, 3: 0.5}))
    best, metric = _drive(pol, lambda c: float(c["x"]))
    assert best == {"x": 3} and metric == 3.0


def test_cost_aware_explores_cheapest_first():
    cands = [{"x": "pricey"}, {"x": "cheap"}, {"x": "mid"}]
    pol = CostAwareUCB(cands, rounds=12,
                       cost_fn=_costs({"pricey": 5.0, "cheap": 0.1,
                                       "mid": 1.0}))
    order = []
    for _ in range(3):
        cfg = pol.propose()
        order.append(cfg["x"])
        pol.observe(cfg, 1.0)
    assert order == ["cheap", "mid", "pricey"]


def test_cost_aware_unknown_cost_keeps_candidate_order():
    # cost_fn=None (or returning None) => no penalty: the pull-once phase
    # degrades to ContextualBandit's candidate-order sweep.
    cands = [{"x": i} for i in range(3)]
    pol = CostAwareUCB(cands, rounds=6)
    order = []
    for _ in range(3):
        cfg = pol.propose()
        order.append(cfg["x"])
        pol.observe(cfg, 1.0)
    assert order == [0, 1, 2]


def test_cost_aware_tight_budget_skips_most_expensive():
    # rounds tighter than the arm count: the arms left unmeasured are the
    # most expensive ones (the veto gate's all-or-nothing, made gradual).
    cands = [{"x": i} for i in range(4)]
    pol = CostAwareUCB(cands, rounds=2,
                       cost_fn=_costs({0: 4.0, 1: 1.0, 2: 3.0, 3: 2.0}))
    seen = []
    while True:
        cfg = pol.propose()
        if cfg is None:
            break
        seen.append(cfg["x"])
        pol.observe(cfg, 1.0)
    assert seen == [1, 3]          # two cheapest; x=0 and x=2 never built


def test_cost_aware_penalty_sunk_after_observe():
    cands = [{"x": 0}, {"x": 1}]
    pol = CostAwareUCB(cands, rounds=8, cost_fn=_costs({0: 2.0, 1: 2.0}))
    stats = {s["config"]["x"]: s for s in pol.arm_stats()}
    assert stats[0]["penalty"] > 0 and stats[1]["penalty"] > 0
    for cfg in cands:
        pol.observe(cfg, 1.0)
    stats = {s["config"]["x"]: s for s in pol.arm_stats()}
    assert stats[0]["penalty"] == 0 and stats[1]["penalty"] == 0


def test_cost_aware_built_fn_zeroes_penalty():
    # A cache hit (built_fn True) is free even before any observation —
    # the warm-start story: remotely compiled arms explore without penalty.
    cands = [{"x": "hot"}, {"x": "cold"}]
    pol = CostAwareUCB(cands, rounds=8,
                       cost_fn=_costs({"hot": 9.0, "cold": 1.0}),
                       built_fn=lambda cfg: cfg["x"] == "hot")
    assert pol.propose() == {"x": "hot"}   # despite the 9x estimate
    stats = {s["config"]["x"]: s for s in pol.arm_stats()}
    assert stats["hot"]["penalty"] == 0 and stats["cold"]["penalty"] > 0


def test_cost_aware_peek_covers_cheap_phase_only():
    cands = [{"x": i} for i in range(3)]
    pol = CostAwareUCB(cands, rounds=10,
                       cost_fn=_costs({0: 3.0, 1: 1.0, 2: 2.0}))
    assert pol.peek(5) == [{"x": 1}, {"x": 2}, {"x": 0}]   # cheapest-first
    peeked = pol.peek(1)[0]
    peeked["x"] = 99                                       # copies, no alias
    cfg = pol.propose()
    assert cfg == {"x": 1}
    pol.observe(cfg, 1.0)
    assert pol.peek(5) == [{"x": 2}, {"x": 0}]
    for _ in range(2):
        pol.observe(pol.propose(), 1.0)
    assert pol.peek(5) == []       # pulled arms: scores are metric-driven


def test_cost_aware_auto_rounds_and_validation():
    pol = CostAwareUCB([{"x": 0}, {"x": 1}])
    assert pol.rounds == 8                                 # 4x arms
    with pytest.raises(ValueError):
        CostAwareUCB([])
    with pytest.raises(ValueError):
        CostAwareUCB([{"x": 0}], dwell_s=0.0)


def test_cost_aware_factory_deepcopy():
    from copy import deepcopy
    pol = CostAwareUCB([{"x": 0}, {"x": 1}], rounds=4,
                       cost_fn=_costs({0: 1.0, 1: 2.0}))
    pol.observe({"x": 0}, 5.0)
    clone = deepcopy(pol)          # Controller policy-factory protocol
    clone.reset()
    assert clone.best() == (None, -math.inf)
    assert pol.best()[0] == {"x": 0}
