"""The port's fleet against the JAX reference: routing choices, spec-plane
resolution over records written by both packages, a warm start off the
plane with zero builds, the subprocess worker, and the status screen."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import save_plane_record as ref_save_record  # noqa: E402
from repro.launch.status import render as ref_render  # noqa: E402
from repro.serve import Request as RefRequest  # noqa: E402
from repro.serve.fleet import ReplicaRouter as RefRouter  # noqa: E402
from repro.serve.fleet import SpecPlane as RefPlane  # noqa: E402
from repro_torch.checkpoint import load_plane_record  # noqa: E402
from repro_torch.core import (Controller, ExhaustiveSweep,  # noqa: E402
                              IridescentRuntime, Quarantine, VariantCache,
                              encode_context_key)
from repro_torch.launch.status import main as status_main  # noqa: E402
from repro_torch.launch.status import render  # noqa: E402
from repro_torch.serve import Request, ServeMetrics  # noqa: E402
from repro_torch.serve.fleet import (DeadlineSpill, ReplicaRouter,  # noqa: E402
                                     SpecPlane, make_routing_policy)


class FakeReplica:
    def __init__(self, depths):
        self.depths = depths          # shared list, one entry per replica
        self.index = None
        self.got = 0

    def submit(self, request):
        self.got += 1
        return self.depths[self.index] < 60    # a deep replica refuses

    def depth(self):
        return self.depths[self.index]


def _choices(router_cls, request_cls, policy, seed):
    """Route a seeded sequence of requests (deadlines: none, tight or
    loose) while the replicas' reported depths move; returns the index
    chosen for each request and the router's stats."""
    rs = np.random.RandomState(seed)
    depths = [0, 0, 0]
    reps = [FakeReplica(depths) for _ in depths]
    for i, r in enumerate(reps):
        r.index = i
    kw = ({"est_wait_s": 0.05, "margin": 0.5, "max_depth": 32}
          if policy == "spill" else {})
    router = router_cls(reps, policy=policy, **kw)
    chosen = []
    for _ in range(300):
        depths[:] = rs.randint(0, 80, size=3).tolist()
        deadline = [None, 0.5, 4.0][rs.randint(3)]
        before = [r.got for r in reps]
        router.submit(request_cls(deadline_s=deadline))
        chosen.append([g - b for g, b in zip((r.got for r in reps),
                                             before)].index(1))
    return chosen, router.stats()


@pytest.mark.parametrize("policy", ["round-robin", "jsq", "spill"])
@pytest.mark.parametrize("seed", [0, 1])
def test_router_choices_match_reference(policy, seed):
    chosen, stats = _choices(ReplicaRouter, Request, policy, seed)
    ref_chosen, ref_stats = _choices(RefRouter, RefRequest, policy, seed)
    assert chosen == ref_chosen
    assert stats == ref_stats
    assert sum(stats["refused"]) > 0
    if policy == "spill":
        assert stats["spills"] > 0


def test_router_validation_and_policy_factory():
    with pytest.raises(ValueError):
        ReplicaRouter([])
    with pytest.raises(ValueError):
        make_routing_policy("power-of-two")
    assert isinstance(make_routing_policy("spill"), DeadlineSpill)


# -- the spec plane ------------------------------------------------------------

def _write_mixed_plane(plane_dir):
    """Records for three contexts from replicas of both packages, with
    epoch, goodput and replica-id ties, plus unusable files."""
    ref = {r: RefPlane(plane_dir, replica=r) for r in ("a", "c")}
    port = {r: SpecPlane(plane_dir, replica=r) for r in ("b", "d")}
    ref["a"].publish("h", ("decode", 4), {"tile": 8}, goodput=9.0, epoch=1)
    port["b"].publish("h", ("decode", 4), {"tile": 16}, goodput=0.1, epoch=2)
    port["b"].publish("h", ("prefill", 8), {"tile": 4}, goodput=5.0, epoch=7)
    ref["c"].publish("h", ("prefill", 8), {"tile": 8}, goodput=3.0, epoch=7,
                     quarantined=[{"tile": 16}])
    ref["a"].publish("h", 16, {"tile": 4}, goodput=1.0, epoch=1)
    port["d"].publish("h", 16, {"tile": 4}, goodput=1.0, epoch=1)
    ref_save_record(os.path.join(plane_dir, "old.json"), handler="g",
                    context=encode_context_key("default"),
                    config={"tile": 8}, goodput=1.0, epoch=3, replica="a",
                    t=0.0)
    with open(os.path.join(plane_dir, "torn.json"), "w") as f:
        f.write('{"version": 1, "handler"')
    with open(os.path.join(plane_dir, "future.json"), "w") as f:
        json.dump({"version": 999}, f)


def test_plane_resolves_records_of_both_packages_alike(tmp_path):
    plane_dir = str(tmp_path)
    _write_mixed_plane(plane_dir)
    winners = SpecPlane(plane_dir, replica="me").resolve()
    ref_winners = RefPlane(plane_dir, replica="me").resolve()
    assert winners == ref_winners
    assert {k: v["replica"] for k, v in winners.items()} == {
        ("h", encode_context_key(("decode", 4))): "b",    # freshest epoch
        ("h", encode_context_key(("prefill", 8))): "b",   # goodput tiebreak
        ("h", encode_context_key(16)): "d",               # replica id
        ("g", encode_context_key("default")): "a"}
    assert load_plane_record(os.path.join(plane_dir, "torn.json")) is None


def test_plane_poll_seeds_once_and_absorbs_quarantine(tmp_path):
    plane_dir = str(tmp_path)
    _write_mixed_plane(plane_dir)
    quarantine = Quarantine()
    rt = IridescentRuntime(async_compile=False)
    h = rt.register("h", lambda spec: (spec.enum("tile", 8, (4, 8, 16)),
                                       lambda x: x)[1],
                    context_fn=lambda a, k: a[0])
    plane = SpecPlane(plane_dir, replica="me", quarantine=quarantine)
    plane.poll(rt)
    assert h.seeded_config(("decode", 4)) == {"tile": 16}
    assert h.seeded_config(("prefill", 8)) == {"tile": 4}
    assert quarantine.blocked("h", ("prefill", 8), {"tile": 16})
    h._seeded.clear()
    plane.poll(rt)                               # same winners: no re-seed
    assert h.seeded_config(("decode", 4)) is None
    rt.shutdown()


def _fused_builder(spec):
    fused = spec.enum("fused", False, (False, True), guarded=False)

    def f(x, w):
        if fused:
            return x @ w
        h = w.shape[1] // 2
        return torch.cat([x @ w[:, :h], x @ w[:, h:]], dim=-1)

    return f


def test_plane_round_trip_warm_start_zero_builds(tmp_path):
    """Replica 1 explores and publishes its settled winner; replica 2,
    sharing a portable variant cache, polls, is seeded and activates the
    winner from the cache: zero builds, admitted settled."""
    cache_dir = str(tmp_path / "variants")
    plane_dir = str(tmp_path / "plane")
    ctx_fn = lambda a, k: int(a[0].shape[0])  # noqa: E731
    x, w = torch.ones(4, 8), torch.ones(8, 8)

    rt1 = IridescentRuntime(async_compile=False,
                            variant_cache=VariantCache(cache_dir,
                                                       portable=True))
    h1 = rt1.register("step", _fused_builder, context_fn=ctx_fn)
    ctl1 = Controller(
        h1, lambda: ExhaustiveSweep([{"fused": True}, {"fused": False}]),
        metric=lambda view: 2.0 if view.active_config()["fused"] else 1.0,
        dwell=2, wait_compiles=True)
    for _ in range(30):
        h1(x, w)
        ctl1.step()
        if ctl1.settled():
            break
    assert ctl1.settled()
    assert ctl1.settled_winners()[4][0] == {"fused": True}
    assert SpecPlane(plane_dir, replica="1").publish_controller(
        "step", ctl1) == 1
    assert rt1.compile_stats()["xla_compiles"] > 0    # replica 1 paid
    rt1.shutdown()

    rt2 = IridescentRuntime(async_compile=False,
                            variant_cache=VariantCache(cache_dir,
                                                       portable=True))
    h2 = rt2.register("step", _fused_builder, context_fn=ctx_fn)
    ctl2 = Controller(
        h2, lambda: ExhaustiveSweep([{"fused": True}, {"fused": False}]),
        metric=lambda view: 1.0, dwell=2, wait_compiles=True)
    SpecPlane(plane_dir, replica="2").poll(rt2)
    torch.testing.assert_close(h2(x, w), x @ w)
    ctl2.step()
    stats = rt2.compile_stats()
    assert stats["xla_compiles"] == 0                 # build-free
    assert stats["cache_hits"] >= 1
    assert h2.active_config(context=4) == {"fused": True}
    assert ctl2.settled()                             # admitted in EXPLOIT
    rt2.shutdown()


# -- the subprocess worker -----------------------------------------------------

def test_subprocess_worker_round_trip(tmp_path):
    """One synthetic worker on the CPU behind the stdio protocol: ready,
    serves a routed schedule, exits with mergeable stats."""
    from repro_torch.serve.fleet.worker import (SubprocessReplica,
                                                worker_command)

    rep = SubprocessReplica(
        worker_command("--profile", "synthetic", "--device", "cpu",
                       "--replica-id", "w", "--d", "64", "--dwell", "2",
                       "--max-wall-s", "60"),
        name="w")
    try:
        assert rep.wait_ready(120.0)
        router = ReplicaRouter([rep], policy="round-robin")
        for _ in range(6):
            assert router.submit(Request(prompt_tokens=4, max_new_tokens=2))
    finally:
        rep.close()
        stats = rep.join(120.0)
    assert stats is not None and stats["replica"] == "w"
    assert ServeMetrics.merge(stats["metrics"]).completed == 6
    assert stats["compile"]["xla_compiles"] > 0       # cold: no shared cache
    assert stats["settled"]                           # winners reported
    assert stats["libraries"] == {} and stats["rmsnorm_launches"] == 0


def test_worker_without_its_device_never_starts(tmp_path):
    """A worker asked for ``cuda`` (the default) on a host without it
    exits before reporting ready: it never falls back to the host."""
    from repro_torch.serve.fleet.worker import (SubprocessReplica,
                                                worker_command)

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    rep = SubprocessReplica(
        worker_command("--profile", "synthetic", "--replica-id", "w"),
        name="w")
    try:
        assert not rep.wait_ready(120.0)
    finally:
        rep.close()
        assert rep.join(120.0) is None
    assert rep.proc.returncode != 0


# -- status --------------------------------------------------------------------

SNAPSHOTS = [
    {"mode": "single", "handler": "serve_step", "written_at": 0.0,
     "replica": "0", "slo_ms": 2000.0,
     "contexts": {
         "('decode', 8)": {"phase": "exploit", "active": {"tile": 8},
                           "pending": None, "best_metric": 12.5, "calls": 100,
                           "explorations": 1, "tput_window": {"rate": 42.0}},
         "('prefill', 4)": {"phase": "explore",
                            "active": {"rmsnorm_impl": "cuda",
                                       "cache_dtype": "bfloat16"},
                            "pending": {"rmsnorm_impl": "torch_ref"},
                            "best_metric": None, "calls": 7,
                            "explorations": 2, "tput_window": {}}},
     "safety": {"promotions": 1, "rollbacks": 1, "shadow_rejections": 0,
                "canary_rejections": 0, "quarantined": 1,
                "contexts": {"('decode', 8)": {
                    "stage": "live", "quarantined": [{"tile": 64}]}}},
     "serve": {"completed": 9, "shed": 0, "goodput_tokens": 120,
               "latency_p95_ms": 31.25},
     "queue": {"waiting": 2, "in_flight": 3},
     "compile": {"queue_depth": 0, "in_flight": 1, "cache_hit_rate": 1.0,
                 "build_p50_s": 0.001},
     "bus": {"emitted": 10, "dropped_events": 0, "retained": 10}},
    {"mode": "fleet", "written_at": 0.0,
     "replicas": {"0": {"depth": 3}, "1": {"depth": 1}},
     "router": {"policy": "jsq", "routed": [4, 2]}},
    {"mode": "single"},
]


@pytest.mark.parametrize("doc", SNAPSHOTS, ids=["single", "fleet", "bare"])
def test_status_renders_like_reference(doc):
    assert render(doc, now=2.5) == ref_render(doc, now=2.5)


def test_status_cli_reads_the_snapshot_file(tmp_path, capsys):
    path = tmp_path / "snap.json"
    assert status_main([str(path)]) == 1          # not written yet
    assert "no snapshot" in capsys.readouterr().out
    path.write_text(json.dumps(SNAPSHOTS[1]))
    assert status_main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "[fleet]" in out and "jsq" in out
    assert status_main([str(path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == SNAPSHOTS[1]


def test_plane_records_carry_reference_wire_format(tmp_path):
    path = SpecPlane(str(tmp_path), replica="p").publish(
        "h", ("decode", 2), {"tile": 8, "dtype": "bf16"}, goodput=2.5)
    with open(path) as f:
        record = json.load(f)
    assert record["version"] == 1 and record["replica"] == "p"
    assert record["context"] == encode_context_key(("decode", 2))
    assert record["goodput"] == 2.5
