"""The reference's scenarios of ``tests/test_safety.py``, held against the
port: each test keeps its name there.

Safe online exploration: canary dispatch slot, shadow evaluation,
SafetyController lifecycle (shadow -> canary -> promote -> rollback ->
quarantine), fleet quarantine propagation + plane gc, and v3 spec-state
crash consistency."""
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (ChangeDetector, ContextualBandit, Controller,  # noqa: E402
                              CostAwareUCB, DEFAULT_CONTEXT, ExhaustiveSweep,
                              IridescentRuntime, Phase, Quarantine,
                              SafetyController, config_key, encode_context_key)
from repro_torch.serve import ShadowEvaluator  # noqa: E402
from repro_torch.serve.fleet import SpecPlane  # noqa: E402


def make_rt(**kw):
    return IridescentRuntime(async_compile=False, **kw)


def _mode_builder(spec):
    mode = spec.enum("mode", "a", ("a", "b", "bad"), guarded=False)

    def f(x):
        return x * (1.0 if mode == "a" else 2.0 if mode == "b" else 3.0)

    return f


def _mm_builder(spec):
    B = spec.enum("B", 8, (4, 8, 16))

    def matmul(L, R):
        return (L @ R) * 1.0

    return matmul


# --- runtime: canary dispatch slot ----------------------------------------------

def test_canary_slot_routes_fraction_and_promotes():
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    h(torch.ones(4))
    view = h.context(DEFAULT_CONTEXT)
    view.set_canary({"mode": "b"}, 0.25, wait=True)
    assert view.canary_config() == {"mode": "b"}
    for _ in range(8):
        h(torch.ones(4))
    # period = round(1/0.25) = 4: tickets 0 and 4 of the 8 routed to it
    assert view.canary_calls() == 2
    assert view.active_config() == {}        # incumbent still owns the slot
    promoted = view.promote_canary(wait=True)
    assert promoted == {"mode": "b"}
    assert view.active_config() == {"mode": "b"}
    assert view.canary_config() is None
    rt.shutdown()


def test_clear_canary_and_revert_to():
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    h(torch.ones(4))
    view = h.context(DEFAULT_CONTEXT)
    view.set_canary({"mode": "b"}, 0.5, wait=True)
    view.clear_canary()
    assert view.canary_config() is None
    n0 = view.canary_calls()
    for _ in range(6):
        h(torch.ones(4))
    assert view.canary_calls() == n0         # withdrawn: no more routing
    view.specialize({"mode": "bad"}, wait=True)
    view.set_canary({"mode": "b"}, 0.5, wait=True)
    view.revert_to({"mode": "a"}, wait=True)  # rollback empties the slot too
    assert view.active_config() == {"mode": "a"}
    assert view.canary_config() is None
    rt.shutdown()


def test_shadow_tap_sees_live_calls():
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    seen = []
    h.set_shadow_tap(lambda key, args, kwargs: seen.append(key))
    h(torch.ones(4))
    h(torch.ones(4))
    assert len(seen) == 2
    h.clear_shadow_tap()
    h(torch.ones(4))
    assert len(seen) == 2
    rt.shutdown()


# --- ShadowEvaluator ------------------------------------------------------------

def _iters_builder(spec):
    # mode "slow" does 200x the work of "fast": a timing gap no shared CI
    # host can invert, so the in_slo verdicts below are deterministic.
    iters = spec.enum("iters", 1, (1, 200), guarded=False)

    def f(x):
        y = x
        for _ in range(iters):
            y = y @ x
        return y

    return f


def test_shadow_evaluator_passes_faster_candidate():
    rt = make_rt()
    h = rt.register("m", _iters_builder)
    ev = ShadowEvaluator(h, sample_frac=1.0, k=3, tolerance=1.5)
    x = torch.eye(32)
    h(x)
    view = h.context(DEFAULT_CONTEXT)
    view.specialize({"iters": 200}, wait=True)   # slow incumbent
    ev.begin(DEFAULT_CONTEXT, {"iters": 1}, view.active_config())
    view.build({"iters": 1}, wait=True)
    for _ in range(3):
        h(x)                                 # captured by the tap
    while ev.verdict(DEFAULT_CONTEXT) is None:
        assert ev.step(budget=4) > 0
    v = ev.verdict(DEFAULT_CONTEXT)
    assert v["measured"] and v["pairs"] >= 3 and v["in_slo"]
    assert v["candidate_s"] < v["incumbent_s"]
    # candidate was exercised off the hot path: live slot never changed
    assert view.active_config() == {"iters": 200}
    ev.close()
    rt.shutdown()


def test_shadow_evaluator_rejects_slow_candidate():
    rt = make_rt()
    h = rt.register("m", _iters_builder)
    ev = ShadowEvaluator(h, sample_frac=1.0, k=3, tolerance=1.5)
    x = torch.eye(32)
    h(x)
    view = h.context(DEFAULT_CONTEXT)
    ev.begin(DEFAULT_CONTEXT, {"iters": 200}, view.active_config())
    view.build({"iters": 200}, wait=True)
    for _ in range(3):
        h(x)
    while ev.verdict(DEFAULT_CONTEXT) is None:
        assert ev.step(budget=4) > 0
    v = ev.verdict(DEFAULT_CONTEXT)
    assert v["measured"] and not v["in_slo"]
    assert v["candidate_s"] > v["incumbent_s"]
    ev.close()
    rt.shutdown()


def test_shadow_evaluator_samples_by_fraction_and_caps():
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    ev = ShadowEvaluator(h, sample_frac=0.5, max_samples=3)
    for _ in range(10):
        h(torch.ones(4))
    st = ev._st(DEFAULT_CONTEXT)
    assert len(st.samples) == 3              # every 2nd call, capped at 3
    assert st.tick == 10
    ev.close()
    rt.shutdown()


def test_shadow_evaluator_fails_safe_without_measurements():
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    ev = ShadowEvaluator(h, sample_frac=1.0, k=2, max_attempts=2)
    h(torch.ones(4))
    ev.begin(DEFAULT_CONTEXT, {"mode": "b"}, {})
    # candidate never built: step() can't run pairs, attempts stay 0 and
    # the verdict stays None (still waiting on the build)...
    assert ev.step(budget=4) == 0
    assert ev.verdict(DEFAULT_CONTEXT) is None
    # ...but once the attempt budget is burned (stale samples), the
    # verdict is a fail-safe rejection, never a silent admission.
    ev._st(DEFAULT_CONTEXT).attempts = 2
    v = ev.verdict(DEFAULT_CONTEXT)
    assert v is not None and not v["in_slo"] and not v["measured"]
    ev.close()
    rt.shutdown()


# --- SafetyController lifecycle -------------------------------------------------

class FakeShadow:
    """Scripted shadow evaluator: verdicts keyed by candidate config."""

    def __init__(self, verdicts):
        self.verdicts = {config_key(c): dict(v) for c, v in verdicts}
        self.begun = []
        self.current = None

    def begin(self, key, candidate, incumbent):
        self.begun.append((key, dict(candidate), dict(incumbent)))
        self.current = dict(candidate)

    def verdict(self, key):
        if self.current is None:
            return None
        return self.verdicts[config_key(self.current)]

    def clear(self, key):
        self.current = None


def _drive_safety(h, ctl, rates, iters, sampled):
    for _ in range(iters):
        h(torch.ones(4))
        h(torch.ones(4))
        ctl.step()
        cfg = h.active_config()
        sampled.add(cfg.get("mode", "a"))


def test_safety_full_lifecycle_promote_rollback_quarantine():
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    h(torch.ones(4))
    rates = {"a": 10.0, "b": 12.0, "bad": 100.0}
    shadow = FakeShadow([
        ({"mode": "b"}, {"metric": 5.0, "in_slo": True}),
        ({"mode": "bad"}, {"metric": 0.5, "in_slo": False}),
    ])
    ctl = SafetyController(
        h, ExhaustiveSweep([{"mode": "b"}, {"mode": "bad"}]),
        shadow=shadow, canary_frac=0.25, promote_after=2,
        metric=lambda view: rates[view.active_config().get("mode", "a")],
        dwell=2, wait_compiles=True, prefetch=0,
        change_detector=ChangeDetector(0.3, warmup=1))
    sampled = set()
    _drive_safety(h, ctl, rates, 30, sampled)
    # both candidates shadowed against the incumbent, off the live path
    assert [c for _, c, _ in shadow.begun] == [{"mode": "b"},
                                               {"mode": "bad"}]
    assert ctl.shadow_rejections == 1
    # the in-SLO winner canaried and promoted; the rejected one never ran
    assert ctl.promotions == 1
    assert h.active_config() == {"mode": "b"}
    assert "bad" not in sampled
    status = ctl.safety_status()
    enc = encode_context_key(DEFAULT_CONTEXT)
    assert status["contexts"][enc]["promoted"]
    assert status["contexts"][enc]["last_known_good"] == {}
    # post-promotion regression: the promoted config degrades
    rates["b"] = 3.0
    _drive_safety(h, ctl, rates, 30, sampled)
    assert ctl.rollbacks == 1
    assert h.active_config() == {}           # reverted to last-known-good
    assert ctl.quarantine.blocked(h.name, DEFAULT_CONTEXT, {"mode": "b"})
    assert "bad" not in sampled
    # quarantined configs stay dead: keep serving, b never comes back
    _drive_safety(h, ctl, rates, 20, sampled)
    assert h.active_config() == {}
    state = ctl.safety_state()
    assert state["quarantined"][enc] == [{"mode": "b"}]
    assert ctl.safety_status()["rollbacks"] == 1
    rt.shutdown()


def test_shadow_rejected_config_never_elected_even_if_board_best():
    """A shadow-failed candidate whose (shadow) metric tops the board must
    not be elected; the incumbent keeps serving."""
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    h(torch.ones(4))
    shadow = FakeShadow([
        ({"mode": "bad"}, {"metric": 99.0, "in_slo": False}),
    ])
    ctl = SafetyController(
        h, ExhaustiveSweep([{"mode": "bad"}]), shadow=shadow,
        metric=lambda view: 10.0, dwell=2, wait_compiles=True, prefetch=0,
        change_detector=ChangeDetector(float("inf")))
    sampled = set()
    _drive_safety(h, ctl, {}, 20, sampled)
    assert ctl.shadow_rejections == 1
    assert ctl.promotions == 0
    assert h.active_config() == {}
    assert sampled == {"a"}
    rt.shutdown()


def test_safety_without_shadow_explores_live_but_canary_gates_swap():
    """shadow=None: candidates explore on live traffic (pre-safety
    behavior) but a winner that is not already serving still goes through
    canary probation before it owns the slot."""
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    h(torch.ones(4))
    rates = {"a": 10.0, "b": 12.0, "bad": 1.0}
    ctl = SafetyController(
        h, ExhaustiveSweep([{"mode": "b"}, {"mode": "bad"}]), shadow=None,
        canary_frac=0.5, promote_after=2,
        metric=lambda view: rates[view.active_config().get("mode", "a")],
        dwell=2, wait_compiles=True, prefetch=0,
        change_detector=ChangeDetector(0.3, warmup=1))
    sampled = set()
    _drive_safety(h, ctl, rates, 30, sampled)
    # live exploration did serve the losing candidate (no shadow to hide it)
    assert "bad" in sampled
    # but the winner was not swapped in directly: it canaried first
    assert ctl.promotions == 1
    assert h.active_config() == {"mode": "b"}
    assert ctl.settled()
    rt.shutdown()


def test_warm_started_safety_controller_never_reexplores_quarantined():
    """Quarantine restored from spec state blocks both the warm-start
    config and any re-proposal of it."""
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    h(torch.ones(4))
    quarantine = Quarantine()
    quarantine.add("m", DEFAULT_CONTEXT, {"mode": "b"})
    ctl = SafetyController(
        h, ExhaustiveSweep([{"mode": "b"}]), shadow=None,
        quarantine=quarantine,
        initial_configs={DEFAULT_CONTEXT: {"mode": "b"}},
        metric=lambda view: 10.0, dwell=2, wait_compiles=True, prefetch=0,
        change_detector=ChangeDetector(float("inf")))
    sampled = set()
    _drive_safety(h, ctl, {}, 20, sampled)
    assert h.active_config() == {}           # never restored, never proposed
    assert "b" not in sampled
    rt.shutdown()


# --- satellite: CostAwareUCB as the budget-gated default policy -----------------

def test_budget_gate_selects_cost_aware_default_policy():
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    ctl = Controller(h, candidates=[{"B": 4}, {"B": 8}], budget=100.0,
                     dwell=2, wait_compiles=True, prefetch=0)
    ctl.step()
    assert isinstance(ctl._ctls[DEFAULT_CONTEXT].policy, CostAwareUCB)
    rt.shutdown()


def test_no_budget_keeps_plain_bandit_default_policy():
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    ctl = Controller(h, candidates=[{"B": 4}, {"B": 8}],
                     dwell=2, wait_compiles=True, prefetch=0)
    ctl.step()
    policy = ctl._ctls[DEFAULT_CONTEXT].policy
    assert isinstance(policy, ContextualBandit)
    assert not isinstance(policy, CostAwareUCB)
    rt.shutdown()


def test_cost_weight_zero_is_veto_only():
    """cost_weight=0 must neutralize the acquisition penalty (proposals in
    plain candidate order) while the hard budget veto still gates the
    over-budget candidate."""
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    costs = {4: 0.001, 8: 0.009, 16: 1.0}    # 16 is over the veto ceiling
    ctl = Controller(
        h, candidates=[{"B": 8}, {"B": 4}, {"B": 16}],
        budget=1.0, cost_weight=0.0, sec_per_call_prior=0.01, dwell=2,
        cost_fn=lambda cfg: costs[cfg["B"]],
        metric=lambda view: float(view.active_config().get("B", 0)),
        wait_compiles=True, prefetch=0,
        change_detector=ChangeDetector(float("inf")))
    for _ in range(40):
        h(torch.ones((4, 4)), torch.eye(4))
        h(torch.ones((4, 4)), torch.eye(4))
        ctl.step()
    explored = [cfg["B"] for ph, cfg, _ in ctl.history
                if ph is Phase.EXPLORE]
    assert 16 not in explored                # vetoed: est 1.0 > 1.0 * 0.02
    # cost_weight=0: no cheapest-first reordering — candidate order kept
    assert explored[:2] == [8, 4]
    assert ctl.settled() and ctl.best()[0] == {"B": 8}
    rt.shutdown()


# --- satellite: decayed prior on re-exploration ---------------------------------

def test_reexploration_keeps_decayed_prior_after_single_dwell_spike():
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    scores = {4: 1.0, 8: 3.0, 16: 2.0}
    spike = {"on": False}

    def metric(view):
        if spike["on"]:
            spike["on"] = False              # a single-dwell transient
            return 30.0
        return scores[view.active_config().get("B")]

    ctl = Controller(
        h, ContextualBandit([{"B": v} for v in (4, 8, 16)], rounds=3),
        metric=metric, dwell=2, wait_compiles=True, prefetch=0,
        change_detector=ChangeDetector(0.5, warmup=1))
    for _ in range(30):
        h(torch.ones((4, 4)), torch.eye(4))
        h(torch.ones((4, 4)), torch.eye(4))
        ctl.step()
    assert ctl.settled() and ctl.best()[0] == {"B": 8}
    before = {config_key(s["config"]): s
              for s in ctl._ctls[DEFAULT_CONTEXT].policy.arm_stats()}
    spike["on"] = True                       # fires the change detector once
    for _ in range(40):
        h(torch.ones((4, 4)), torch.eye(4))
        h(torch.ones((4, 4)), torch.eye(4))
        ctl.step()
    ctx = ctl.status()[DEFAULT_CONTEXT]
    assert ctx["explorations"] >= 1
    after = {config_key(s["config"]): s
             for s in ctl._ctls[DEFAULT_CONTEXT].policy.arm_stats()}
    for key, stats in after.items():
        # decayed prior, not a from-scratch reset: every previously pulled
        # arm keeps >= 1 pull so its learned mean survives the spike
        if before[key]["pulls"] > 0:
            assert stats["pulls"] >= 1
            assert not math.isclose(stats["mean"], 0.0)
    assert ctl.settled() and ctl.best()[0] == {"B": 8}
    rt.shutdown()


# --- fleet: quarantine propagation + plane gc -----------------------------------

def test_plane_propagates_quarantine_between_replicas(tmp_path):
    qa, qb = Quarantine(), Quarantine()
    pa = SpecPlane(str(tmp_path), "A", quarantine=qa)
    qa.add("h", 8, {"mode": "x"})
    pa.publish("h", 8, {"mode": "y"}, goodput=5.0)
    pb = SpecPlane(str(tmp_path), "B", quarantine=qb)
    pb.resolve()
    assert qb.blocked("h", 8, {"mode": "x"})
    assert not qb.blocked("h", 8, {"mode": "y"})


def test_plane_poll_never_seeds_quarantined_winner(tmp_path):
    pa = SpecPlane(str(tmp_path), "A")
    pa.publish("m", DEFAULT_CONTEXT, {"mode": "b"}, goodput=5.0)
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    qb = Quarantine()
    qb.add("m", DEFAULT_CONTEXT, {"mode": "b"})
    pb = SpecPlane(str(tmp_path), "B", quarantine=qb)
    pb.poll(rt)
    assert h.seeded_config(DEFAULT_CONTEXT) is None
    rt.shutdown()


def test_plane_gc_reclaims_superseded_and_retired_records(tmp_path):
    t = {"now": 0.0}
    clock = lambda: t["now"]  # noqa: E731
    pa = SpecPlane(str(tmp_path), "A", clock=clock)
    pb = SpecPlane(str(tmp_path), "B", clock=clock)
    pa.publish("h", 8, {"x": 1}, goodput=1.0)
    pb.resolve()                             # B sees A's epoch
    t["now"] = 1.0
    pb.publish("h", 8, {"x": 2}, goodput=2.0)    # supersedes A's record
    pa.publish("h", 16, {"x": 3}, goodput=1.0)   # A-only context
    assert pb.gc(5.0) == 0                   # nothing old enough yet
    t["now"] = 20.0
    # B reclaims A's superseded h/8 record but never A's h/16 (another
    # replica's active context is not B's to retire)
    assert pb.gc(5.0, active={("h", encode_context_key(8))}) == 1
    winners = pb.resolve()
    assert winners[("h", encode_context_key(8))]["config"] == {"x": 2}
    assert ("h", encode_context_key(16)) in winners
    # A retires its own h/16 record once the context leaves its active set
    assert pa.gc(5.0, active=set()) == 1
    winners = pa.resolve()
    assert ("h", encode_context_key(16)) not in winners
    # the still-active winner survives gc regardless of age
    t["now"] = 100.0
    assert pb.gc(5.0, active={("h", encode_context_key(8))}) == 0
    assert pb.resolve()[("h", encode_context_key(8))]["config"] == {"x": 2}


# --- v3 spec-state crash consistency --------------------------------------------

def _spec_paths(tmp_path):
    return str(tmp_path / "spec_state.json")


def _save_v3(tmp_path, quarantined_active=True):
    """Write a v3 state via the real saver: active config {"mode": "b"}
    with b quarantined and LKG {"mode": "a"} when requested."""
    from repro_torch.checkpoint import save_spec_state
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    h(torch.ones(4))
    h.specialize({"mode": "b"}, wait=True)
    enc = encode_context_key(DEFAULT_CONTEXT)
    safety = None
    if quarantined_active:
        safety = {"m": {"last_known_good": {enc: {"mode": "a"}},
                        "quarantined": {enc: [{"mode": "b"}]}}}
    path = _spec_paths(tmp_path)
    save_spec_state(path, rt, safety=safety)
    rt.shutdown()
    return path


def test_v3_roundtrip_restores_lkg_not_quarantined(tmp_path):
    from repro_torch.checkpoint import load_safety_state, restore_spec_state
    path = _save_v3(tmp_path)
    enc = encode_context_key(DEFAULT_CONTEXT)
    safe = load_safety_state(path)
    assert safe["m"]["last_known_good"][enc] == {"mode": "a"}
    assert safe["m"]["quarantined"][enc] == [{"mode": "b"}]
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    assert restore_spec_state(path, rt, wait=True)
    # the active config was quarantined: the LKG is restored instead
    assert h.active_config() == {"mode": "a"}
    rt.shutdown()


def test_v3_quarantined_without_lkg_stays_generic(tmp_path):
    from repro_torch.checkpoint import restore_spec_state, save_spec_state
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    h(torch.ones(4))
    h.specialize({"mode": "b"}, wait=True)
    enc = encode_context_key(DEFAULT_CONTEXT)
    path = _spec_paths(tmp_path)
    save_spec_state(path, rt,
                    safety={"m": {"quarantined": {enc: [{"mode": "b"}]}}})
    rt.shutdown()
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    assert restore_spec_state(path, rt, wait=True) is False
    assert h.active_config() == {}           # never the quarantined config
    rt.shutdown()


def test_v2_file_loads_under_v3_reader(tmp_path):
    from repro_torch.checkpoint import load_safety_state, restore_spec_state
    enc = encode_context_key(DEFAULT_CONTEXT)
    path = _spec_paths(tmp_path)
    with open(path, "w") as f:
        json.dump({"version": 2, "handlers": {
            "m": {"contexts": {enc: {"mode": "b"}}}}}, f)
    assert load_safety_state(path) == {}
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    assert restore_spec_state(path, rt, wait=True)
    assert h.active_config() == {"mode": "b"}
    rt.shutdown()


def test_truncated_v3_file_restores_to_generic(tmp_path):
    from repro_torch.checkpoint import load_safety_state, restore_spec_state
    path = _save_v3(tmp_path)
    with open(path) as f:
        blob = f.read()
    with open(path, "w") as f:
        f.write(blob[:len(blob) // 2])       # torn write / partial flush
    assert load_safety_state(path) == {}
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    assert restore_spec_state(path, rt, wait=True) is False
    assert h.active_config() == {}
    rt.shutdown()


def test_malformed_v3_safety_fields_are_dropped_not_fatal(tmp_path):
    from repro_torch.checkpoint import load_safety_state, restore_spec_state
    enc = encode_context_key(DEFAULT_CONTEXT)
    path = _spec_paths(tmp_path)
    with open(path, "w") as f:
        json.dump({"version": 3, "handlers": {"m": {
            "contexts": {enc: {"mode": "b"}},
            "last_known_good": "not-a-dict",
            "quarantined": {enc: "not-a-list", "bogus": [17]},
        }}}, f)
    assert load_safety_state(path) == {}     # advisory metadata dropped
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    assert restore_spec_state(path, rt, wait=True)
    assert h.active_config() == {"mode": "b"}
    rt.shutdown()


def test_future_spec_state_version_still_refused(tmp_path):
    from repro_torch.checkpoint import restore_spec_state
    path = _spec_paths(tmp_path)
    with open(path, "w") as f:
        json.dump({"version": 4, "handlers": {
            "m": {"contexts": {encode_context_key(DEFAULT_CONTEXT):
                               {"mode": "b"}}}}}, f)
    rt = make_rt()
    h = rt.register("m", _mode_builder)
    assert restore_spec_state(path, rt, wait=True) is False
    assert h.active_config() == {}
    rt.shutdown()


def test_plane_record_quarantine_roundtrip(tmp_path):
    from repro_torch.checkpoint import load_plane_record, save_plane_record
    path = os.path.join(str(tmp_path), "rec.json")
    save_plane_record(path, handler="h", context="8", config={"x": 1},
                      goodput=2.0, epoch=3, replica="A", t=0.0,
                      quarantined=[{"x": 9}])
    rec = load_plane_record(path)
    assert rec["quarantined"] == [{"x": 9}]
    save_plane_record(path, handler="h", context="8", config={"x": 1},
                      goodput=2.0, epoch=4, replica="A", t=0.0)
    assert load_plane_record(path)["quarantined"] == []
