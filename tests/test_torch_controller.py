"""The reference's scenarios of ``tests/test_controller.py``, held against the
port: each test keeps its name there.

Controller: the unified per-context explore/exploit driver (online and
offline modes), compile-cost budgeting, warm restarts, and the
ContextualBandit policy."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (ChangeDetector, ContextualBandit, Controller,  # noqa: E402
                              DEFAULT_CONTEXT, ExhaustiveSweep, IridescentRuntime,
                              Phase)


def _mm_builder(spec):
    B = spec.enum("B", 8, (4, 8, 16))

    def matmul(L, R):
        return (L @ R) * 1.0

    return matmul


def _batch_ctx(args, kwargs):
    return int(args[0].shape[0])


def make_rt(**kw):
    return IridescentRuntime(async_compile=False, **kw)


def _drive(handler, controller, shapes, iters):
    for _ in range(iters):
        for n in shapes:
            handler(torch.ones((n, n)), torch.eye(n))
        controller.step()


# --- online, single (default) context ------------------------------------------

def test_controller_explores_and_settles_on_best():
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    scores = {4: 1.0, 8: 3.0, 16: 2.0}
    ctl = Controller(
        h, ExhaustiveSweep([{"B": v} for v in (4, 8, 16)]),
        metric=lambda view: scores[view.active_config().get("B")],
        dwell=3, wait_compiles=True)
    _drive(h, ctl, [4], 30)
    assert ctl.settled()
    best, metric = ctl.best()
    assert best == {"B": 8} and metric == 3.0
    assert h.active_config() == {"B": 8}
    # no hand-rolled loop: history carries the full explore trace
    explored = [cfg["B"] for ph, cfg, _ in ctl.history
                if ph is Phase.EXPLORE]
    assert explored == [4, 8, 16]
    rt.shutdown()


def test_controller_change_detection_reexplores():
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    phase = {"flip": False}

    def metric(view):
        b = view.active_config().get("B")
        base = {4: 3.0, 8: 2.0, 16: 1.0}[b]
        return (4.0 - base) * 10 if phase["flip"] else base

    ctl = Controller(h, ExhaustiveSweep([{"B": v} for v in (4, 8, 16)]),
                     metric=metric, dwell=2, wait_compiles=True,
                     change_detector=ChangeDetector(0.5, warmup=1))
    _drive(h, ctl, [4], 20)
    assert ctl.settled() and ctl.best()[0] == {"B": 4}
    phase["flip"] = True                     # workload shift inverts ranking
    _drive(h, ctl, [4], 40)
    assert ctl.settled() and ctl.best()[0] == {"B": 16}
    assert ctl.status()[DEFAULT_CONTEXT]["explorations"] >= 2
    rt.shutdown()


def test_controller_warm_restart_starts_in_exploit():
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    ctl = Controller(h, ExhaustiveSweep([{"B": v} for v in (4, 8, 16)]),
                     dwell=3, wait_compiles=True,
                     initial_configs={DEFAULT_CONTEXT: {"B": 16}})
    _drive(h, ctl, [4], 2)
    assert ctl.settled()
    assert h.active_config() == {"B": 16}
    # no exploration happened: the restored config went straight to EXPLOIT
    assert all(ph is Phase.EXPLOIT for ph, _, _ in ctl.history)
    rt.shutdown()


# --- online, multiple contexts --------------------------------------------------

def test_two_contexts_settle_on_different_configs():
    """The mixed-batch serve story: per-context search converges to a
    different winner per batch-shape class (deterministic metric table)."""
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    scores = {(4, 4): 9.0, (4, 8): 1.0, (4, 16): 1.0,
              (8, 4): 1.0, (8, 8): 2.0, (8, 16): 7.0}

    ctl = Controller(
        h, lambda: ExhaustiveSweep([{"B": v} for v in (4, 8, 16)]),
        metric=lambda view: scores[(view.key,
                                    view.active_config().get("B"))],
        dwell=2, wait_compiles=True)
    _drive(h, ctl, [4, 8], 30)
    assert ctl.settled()
    assert h.active_config(context=4) == {"B": 4}
    assert h.active_config(context=8) == {"B": 16}
    assert ctl.best_configs() == {4: {"B": 4}, 8: {"B": 16}}
    rt.shutdown()


def test_contexts_admitted_only_with_traffic():
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    ctl = Controller(h, lambda: ExhaustiveSweep([{"B": 4}]), dwell=2,
                     wait_compiles=True)
    _drive(h, ctl, [4], 10)
    # the default context exists on the handler but received no traffic:
    # the controller must not explore it
    assert DEFAULT_CONTEXT in h.contexts()
    assert ctl.contexts() == [4]
    rt.shutdown()


def test_per_context_policies_are_independent():
    """Observations in one context never leak into another's policy."""
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    pols = []

    def factory():
        p = ExhaustiveSweep([{"B": v} for v in (4, 8)])
        pols.append(p)
        return p

    ctl = Controller(h, factory, metric=lambda view: 1.0, dwell=2,
                     wait_compiles=True)
    _drive(h, ctl, [4, 8], 15)
    assert len(pols) == 2                    # one fresh policy per context
    rt.shutdown()


# --- compile-cost budgeting -----------------------------------------------------

def test_budget_skips_expensive_candidates():
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    costs = {4: 0.0, 8: 1e6, 16: 0.0}        # candidate B=8 is "huge"
    scores = {4: 1.0, 8: 50.0, 16: 2.0}
    ctl = Controller(
        h, ExhaustiveSweep([{"B": v} for v in (4, 8, 16)]),
        metric=lambda view: scores[view.active_config().get("B")],
        dwell=2, wait_compiles=True, budget=1.0,
        cost_fn=lambda cfg: costs[cfg["B"]])
    _drive(h, ctl, [4], 30)
    assert ctl.settled()
    explored = {cfg["B"] for ph, cfg, _ in ctl.history
                if ph is Phase.EXPLORE}
    assert 8 not in explored                 # skipped: cost >> dwell gain
    assert ctl.status()[DEFAULT_CONTEXT]["skipped"] >= 1
    assert ctl.best()[0] == {"B": 16}
    rt.shutdown()


def test_budget_never_skips_already_built_variants():
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    h.specialize({"B": 8}, wait=True)        # variant already exists
    ctl = Controller(
        h, ExhaustiveSweep([{"B": 8}]),
        metric=lambda view: 1.0, dwell=2, wait_compiles=True, budget=0.001,
        cost_fn=lambda cfg: 1e9)
    _drive(h, ctl, [4], 10)
    explored = [cfg["B"] for ph, cfg, _ in ctl.history
                if ph is Phase.EXPLORE]
    assert explored == [8]                   # marginal cost ~0: not skipped
    rt.shutdown()


def test_budget_skipped_candidates_never_elected():
    """Once a dwell-time basis exists, every over-budget candidate is
    skipped, never observed, and can never become the EXPLOIT winner; the
    gate is inactive for the very first candidate (no basis to weigh cost
    against yet), which therefore explores normally."""
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    ctl = Controller(
        h, ExhaustiveSweep([{"B": v} for v in (4, 8, 16)]),
        metric=lambda view: 1.0, dwell=2, wait_compiles=True, budget=0.001,
        cost_fn=lambda cfg: 1e9)
    _drive(h, ctl, [4], 10)
    assert ctl.settled()
    explored = [cfg["B"] for ph, cfg, _ in ctl.history
                if ph is Phase.EXPLORE]
    assert explored == [4]                         # only the ungated first
    assert ctl.status()[DEFAULT_CONTEXT]["skipped"] == 2
    assert h.active_config() == {"B": 4}           # never a skipped config
    rt.shutdown()


def test_budget_skip_does_not_abort_bandit_exploration():
    """A bandit re-proposes an unpulled arm until it is observed; one
    over-budget arm must not abort exploration of the remaining arms
    (regression: the gate used to force EXPLOIT with best=None)."""
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    costs = {4: 1e9, 8: 0.0, 16: 0.0}        # the FIRST arm is over budget
    scores = {4: 50.0, 8: 1.0, 16: 3.0}
    ctl = Controller(
        h, ContextualBandit([{"B": v} for v in (4, 8, 16)], rounds=8),
        metric=lambda view: scores[view.active_config().get("B")],
        dwell=2, wait_compiles=True, budget=1.0,
        cost_fn=lambda cfg: costs[cfg["B"]],
        sec_per_call_prior=0.001)            # gate active from candidate 1
    _drive(h, ctl, [4], 40)
    assert ctl.settled()
    explored = {cfg["B"] for ph, cfg, _ in ctl.history
                if ph is Phase.EXPLORE}
    assert explored == {8, 16}               # cheap arms all measured
    assert ctl.best()[0] == {"B": 16}        # vetoed arm never elected
    assert h.active_config() == {"B": 16}
    rt.shutdown()


def test_unknown_spec_state_version_not_misparsed(tmp_path):
    """A future-versioned spec_state.json must be refused loudly, not
    silently misread as the v1 flat format."""
    import json as _json
    from repro_torch.checkpoint import restore_spec_state
    path = str(tmp_path / "spec_state.json")
    with open(path, "w") as f:
        _json.dump({"version": 99, "handlers": {"m": {"contexts": {}}}}, f)
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    assert restore_spec_state(path, rt, wait=True) is False
    assert h.active_config() == {}
    rt.shutdown()


def test_stale_restored_config_falls_back_to_exploration():
    """A warm-start config that is no longer valid (points renamed /
    choices changed) must not crash step(); the context explores fresh."""
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    ctl = Controller(h, ExhaustiveSweep([{"B": 4}]),
                     metric=lambda view: 1.0, dwell=2, wait_compiles=True,
                     initial_configs={DEFAULT_CONTEXT: {"gone_point": 1}})
    _drive(h, ctl, [4], 10)                        # must not raise
    assert ctl.settled()
    assert h.active_config() == {"B": 4}           # fresh exploration won
    rt.shutdown()


# --- offline mode ---------------------------------------------------------------

def test_offline_run_drives_policy_to_best():
    ctl = Controller(policy=ExhaustiveSweep([{"k": i} for i in range(6)]),
                     measure=lambda cfg: -abs(cfg["k"] - 4))
    best, metric = ctl.run()
    assert best == {"k": 4} and metric == 0
    assert len(ctl.history) == 6             # every candidate measured once


def test_offline_controller_rejects_step_and_vice_versa():
    ctl = Controller(policy=ExhaustiveSweep([{"k": 1}]),
                     measure=lambda cfg: 0.0)
    with pytest.raises(RuntimeError):
        ctl.step()
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    online = Controller(h, ExhaustiveSweep([{"B": 4}]))
    with pytest.raises(RuntimeError):
        online.run()
    rt.shutdown()


# --- ContextualBandit -----------------------------------------------------------

def test_bandit_pulls_every_arm_then_exploits_best():
    bd = ContextualBandit([{"x": i} for i in range(4)], rounds=20)
    seen = []
    while True:
        cfg = bd.propose()
        if cfg is None:
            break
        seen.append(cfg["x"])
        bd.observe(cfg, float(cfg["x"] == 2))
    assert sorted(set(seen[:4])) == [0, 1, 2, 3]   # each arm pulled once
    assert seen.count(2) > len(seen) / 3           # best arm dominates
    best, mean = bd.best()
    assert best == {"x": 2} and mean == 1.0


def test_bandit_auto_rounds_and_reset():
    bd = ContextualBandit([{"x": 0}, {"x": 1}])
    assert bd.rounds == 8                          # 4 pulls per arm
    n = 0
    while bd.propose() is not None:
        n += 1
        bd.observe({"x": 0}, 1.0)
    assert n == 8
    bd.reset()
    assert bd.propose() is not None                # fresh arm statistics


def test_bandit_tie_breaks_to_earliest_candidate():
    bd = ContextualBandit([{"x": "a"}, {"x": "b"}], rounds=4)
    bd.observe({"x": "a"}, 1.0)
    bd.observe({"x": "b"}, 1.0)
    assert bd.best()[0] == {"x": "a"}


def test_bandit_with_controller_per_context_arm_sets():
    """One bandit per context: each workload class converges to its own
    arm under a deterministic per-context reward table."""
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    reward = {(4, 4): 5.0, (4, 8): 1.0, (8, 4): 1.0, (8, 8): 5.0,
              (4, 16): 0.5, (8, 16): 0.5}
    ctl = Controller(
        h, lambda: ContextualBandit([{"B": v} for v in (4, 8, 16)],
                                    rounds=9),
        metric=lambda view: reward[(view.key,
                                    view.active_config().get("B"))],
        dwell=2, wait_compiles=True)
    _drive(h, ctl, [4, 8], 40)
    assert ctl.settled()
    assert h.active_config(context=4) == {"B": 4}
    assert h.active_config(context=8) == {"B": 8}
    rt.shutdown()


def test_controller_accepts_thompson_sampling_per_context():
    """ROADMAP satellite: the Controller runs a ThompsonSampling policy —
    one independent posterior per specialization context."""
    from repro_torch.core import ThompsonSampling
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    h(torch.ones((4, 4)), torch.eye(4))
    h(torch.ones((8, 8)), torch.eye(8))
    scores = {4: {4: 3.0, 8: 1.0}, 8: {4: 1.0, 8: 3.0}}

    def metric(view):
        return scores[view.key][view.active_config().get("B")]

    ctl = Controller(
        h, ThompsonSampling([{"B": 4}, {"B": 8}], seed=5, rounds=8),
        metric=metric, dwell=2, wait_compiles=True,
        change_detector=lambda: ChangeDetector(float("inf")))
    _drive(h, ctl, [4, 8], 40)
    assert ctl.settled()
    assert ctl.best(context=4)[0] == {"B": 4}
    assert ctl.best(context=8)[0] == {"B": 8}
    # the per-context policies are independent instances with own state
    ctls = ctl._ctls
    assert ctls[4].policy is not ctls[8].policy
    assert h.active_config(context=4) == {"B": 4}
    assert h.active_config(context=8) == {"B": 8}
    rt.shutdown()
