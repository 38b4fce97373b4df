"""The reference's scenarios of ``tests/test_serve_engine.py``, held against the
port: each test keeps its name there.

ServeEngine integration: continuous batching over the contextual
specialization runtime — retire-on-completion, idle ticks, backpressure,
mid-stream bucket re-tunes, tuner settling, and the drain-and-restart
zero-recompile acceptance path."""
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import restore_spec_state  # noqa: E402
from repro_torch.core import (ChangeDetector, Controller, ExhaustiveSweep,  # noqa: E402
                              IridescentRuntime)
from repro_torch.serve import (AdmissionQueue, BucketTuner, ContinuousBatcher,  # noqa: E402
                               FCFS, Request, ServeEngine, ServeMetrics,
                               bucket_plan_builder)

D = 8


def _toy_builder(spec):
    scale = spec.enum("scale", 1, (1, 2), guarded=False)

    def f(x, w):
        return (x @ w) * float(scale)

    return f


def _batch_ctx(args, kwargs):
    return int(args[0].shape[0])


class ToyExecutor:
    """Counts handler calls; one matmul per step, rows = padded bucket."""

    def __init__(self, handler):
        self.handler = handler
        self.w = torch.eye(D, dtype=torch.float32)
        self.calls = 0
        self.sizes = []
        self.retired = []

    def execute(self, batch):
        self.calls += 1
        self.sizes.append(batch.size)
        x = torch.ones((batch.size, D), dtype=torch.float32)
        self.handler(x, self.w)

    def retire(self, req):
        self.retired.append(req.rid)


def make_engine(max_batch=4, scheme=None, queue=None, controller=None,
                tuner=None, rt=None, metrics=None, slo_s=None,
                scheduler=None):
    rt = rt or IridescentRuntime(async_compile=False)
    handler = rt.register("toy", _toy_builder, context_fn=_batch_ctx)
    executor = ToyExecutor(handler)
    batcher = ContinuousBatcher(max_batch, scheme=scheme)
    engine = ServeEngine(handler, controller, batcher,
                         scheduler or FCFS(), executor=executor,
                         queue=queue if queue is not None
                         else AdmissionQueue(),
                         tuner=tuner, metrics=metrics, slo_s=slo_s)
    return rt, handler, engine, executor


def test_engine_serves_and_stamps_lifecycle():
    rt, handler, engine, ex = make_engine()
    reqs = [Request(max_new_tokens=3) for _ in range(2)]
    for r in reqs:
        assert engine.submit(r)
    engine.run()
    for r in reqs:
        assert r.done and not r.shed
        assert r.arrival_t <= r.service_t <= r.first_token_t <= r.finish_t
        assert r.generated == 3
    s = engine.stats()
    assert s["serve"]["completed"] == 2
    assert s["serve"]["completed_tokens"] == 6
    assert s["in_flight"] == 0
    assert sorted(ex.retired) == sorted(r.rid for r in reqs)
    rt.shutdown()


def test_empty_queue_idle_tick_makes_no_handler_call():
    rt, handler, engine, ex = make_engine()
    assert engine.step() == 0
    assert engine.step() == 0
    assert engine.idle_ticks == 2
    assert engine.steps == 0
    assert ex.calls == 0                      # no handler work on idle
    assert handler.tput.total() == 0
    rt.shutdown()


def test_request_retires_mid_batch_while_others_continue():
    rt, handler, engine, ex = make_engine(scheme="single")
    short = Request(max_new_tokens=2)
    long_ = Request(max_new_tokens=5)
    engine.submit(short), engine.submit(long_)
    engine.step()
    engine.step()                             # short's budget is spent here
    assert short.done and short.finish_t is not None
    assert engine.active == [long_]           # long keeps decoding
    assert ex.retired == [short.rid]
    engine.run()
    assert long_.done and long_.generated == 5
    assert engine.stats()["serve"]["completed"] == 2
    rt.shutdown()


def test_backpressure_rejection_at_capacity_no_shed_errors():
    rt, handler, engine, ex = make_engine(
        max_batch=2, scheme="single", queue=AdmissionQueue(depth=2))
    accepted = [r for r in (Request(max_new_tokens=2) for _ in range(6))
                if engine.submit(r)]
    stats = engine.queue.stats()
    assert len(accepted) == 2 and stats["rejected"] == 4
    engine.run()
    s = engine.stats()
    assert s["serve"]["completed"] == 2       # rejected ones never served
    assert s["queue"]["shed_errors"] == 0
    rt.shutdown()


def test_bucket_retune_mid_stream_keeps_in_flight_requests():
    rt, handler, engine, ex = make_engine(max_batch=4, scheme="pow2")
    reqs = [Request(max_new_tokens=6) for _ in range(3)]
    for r in reqs:
        engine.submit(r)
    engine.step()                             # 3 rows -> bucket 4
    assert ex.sizes[-1] == 4
    engine.batcher.set_scheme("single")       # re-tune between steps
    engine.run()
    assert ex.sizes[-1] == 4                  # cap is 4 either way
    for r in reqs:                            # nobody was dropped
        assert r.done and not r.shed and r.generated == 6
    assert engine.stats()["serve"]["completed"] == 3
    rt.shutdown()


def test_per_bucket_contexts_materialize():
    rt, handler, engine, ex = make_engine(max_batch=4, scheme="pow2")
    engine.submit(Request(max_new_tokens=2))
    engine.run()                              # 1 row -> bucket 1
    for r in (Request(max_new_tokens=2) for _ in range(4)):
        engine.submit(r)
    engine.run()                              # 4 rows -> bucket 4
    assert {1, 4} <= set(handler.contexts())
    rt.shutdown()


def test_drain_timeout_sheds_remainder():
    rt, handler, engine, ex = make_engine(scheme="single")
    stuck = Request(max_new_tokens=10**6)
    engine.submit(stuck)
    engine.step()
    assert not engine.drain(timeout_s=0.0)    # immediate timeout
    assert stuck.shed
    assert engine.active == []
    assert engine.stats()["serve"]["shed"] == 1
    assert not engine.submit(Request())       # admission closed
    rt.shutdown()


def test_tuner_settles_on_a_known_scheme():
    rt = IridescentRuntime(async_compile=False)
    handler = rt.register("toy", _toy_builder, context_fn=_batch_ctx)
    executor = ToyExecutor(handler)
    batcher = ContinuousBatcher(4)
    metrics = ServeMetrics(slo_s=60.0)
    tuner = BucketTuner(
        batcher, rt, metric=metrics.interval_goodput, dwell=3,
        wait_compiles=True,
        change_detector=lambda: ChangeDetector(float("inf")))
    engine = ServeEngine(handler, None, batcher, FCFS(), executor=executor,
                         queue=AdmissionQueue(), tuner=tuner,
                         metrics=metrics, slo_s=60.0)
    for _ in range(40):
        engine.submit(Request(max_new_tokens=2))
        engine.step()
    engine.drain(timeout_s=30.0)
    assert tuner.settled()
    assert tuner.active_scheme() in batcher.schemes
    assert tuner.best_scheme() in batcher.schemes
    status = tuner.status()
    assert status["boundaries"][status["active"]][-1] == 4
    rt.shutdown()


def _restart_stack(tmp_path, restore=False):
    """One serve 'process': runtime + handlers + engine wired to a
    persistent cache under tmp_path."""
    cache_dir = str(tmp_path / "state")
    rt = IridescentRuntime(async_compile=False,
                           variant_cache=os.path.join(cache_dir, "variants"))
    handler = rt.register("toy", _toy_builder, context_fn=_batch_ctx)
    batcher = ContinuousBatcher(4, scheme="pow2")
    plan_handler = rt.register(
        "bucket_plan",
        bucket_plan_builder(list(batcher.schemes), batcher.default_scheme))
    initial_scheme = None
    restored = False
    if restore:
        restored = restore_spec_state(
            os.path.join(cache_dir, "spec_state.json"), rt, wait=True)
        from repro_torch.serve.batcher import BUCKET_POINT
        initial_scheme = plan_handler.active_config().get(BUCKET_POINT)
    controller = Controller(
        handler, lambda: ExhaustiveSweep([{"scale": 2}, {"scale": 1}]),
        dwell=3, wait_compiles=True, prefetch=0,
        change_detector=lambda: ChangeDetector(float("inf")))
    metrics = ServeMetrics(slo_s=60.0)
    tuner = BucketTuner(
        batcher, metric=metrics.interval_goodput, dwell=3,
        plan_handler=plan_handler, initial_scheme=initial_scheme,
        wait_compiles=True,
        change_detector=lambda: ChangeDetector(float("inf")))
    executor = ToyExecutor(handler)
    engine = ServeEngine(handler, controller, batcher, FCFS(),
                         executor=executor, queue=AdmissionQueue(),
                         tuner=tuner, metrics=metrics, slo_s=60.0)
    return cache_dir, rt, handler, plan_handler, controller, tuner, engine


def _serve_batch4_workload(engine, rounds=30):
    """Keep exactly 4 requests in flight so one context (bucket 4) absorbs
    the whole search deterministically."""
    for _ in range(rounds):
        while len(engine.active) + len(engine.queue) < 4:
            engine.submit(Request(max_new_tokens=2))
        engine.step()


def test_drain_and_restart_resumes_tuned_configs_with_zero_recompiles(
        tmp_path):
    """ISSUE acceptance: drain-and-restart resumes every context's tuned
    config (model handler per-bucket configs AND the tuned bucket scheme)
    with zero XLA recompiles."""
    (cache_dir, rt, handler, plan_handler,
     controller, tuner, engine) = _restart_stack(tmp_path)
    _serve_batch4_workload(engine, rounds=40)
    assert controller.settled() and tuner.settled()
    tuned_cfg = handler.active_config(context=4)
    tuned_scheme = tuner.active_scheme()
    assert tuned_cfg                               # the sweep picked one
    cold_compiles = rt.compile_stats()["xla_compiles"]
    assert cold_compiles > 0
    engine.shutdown(state_dir=cache_dir)           # drains + saves + stops
    assert os.path.exists(os.path.join(cache_dir, "spec_state.json"))

    # -- restart -------------------------------------------------------------
    (cache_dir, rt2, handler2, plan2,
     controller2, tuner2, engine2) = _restart_stack(tmp_path, restore=True)
    assert tuner2.active_scheme() == tuned_scheme  # scheme came back
    _serve_batch4_workload(engine2, rounds=10)
    engine2.drain(timeout_s=30.0)
    warm = rt2.compile_stats()
    assert handler2.active_config(context=4) == tuned_cfg
    assert warm["xla_compiles"] == 0, \
        f"warm restart recompiled: {warm}"
    assert warm["cache_hits"] > 0
    # warm start goes straight to EXPLOIT: no re-exploration happened
    assert controller2.settled(context=4)
    rt2.shutdown()


def test_drain_timeout_retires_in_flight_and_counts_shed_once():
    """Timeout shedding frees executor slots (retire hook) and counts each
    stranded request exactly once across queue + serve stats."""
    rt, handler, engine, ex = make_engine(max_batch=2, scheme="single")
    running = [Request(max_new_tokens=10**6) for _ in range(2)]
    waiting = Request(max_new_tokens=10**6)
    for r in running + [waiting]:
        engine.submit(r)
    engine.step()                             # two in flight, one waiting
    assert not engine.drain(timeout_s=0.0)
    assert sorted(ex.retired) == sorted(r.rid for r in running)
    s = engine.stats()
    assert s["serve"]["shed"] == 2            # in-flight sheds only
    assert s["queue"]["shed"] == 1            # the flushed waiter
    assert all(r.shed for r in running + [waiting])
    rt.shutdown()
