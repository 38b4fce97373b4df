"""The port's multi-tenant serving against the JAX reference: the
``--tenant`` grammar, the executor and controller aggregation, tenant
contexts restored from spec_state with zero builds, and greedy tokens per
request of a two-model engine pinned to the plain kernels."""
import argparse

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import Controller as RefController  # noqa: E402
from repro.core import ExhaustiveSweep as RefSweep  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.serve import ControllerGroup as RefGroup  # noqa: E402
from repro.serve import OpenLoopSource as RefSource  # noqa: E402
from repro.serve import Request as RefRequest  # noqa: E402
from repro.serve import TenantSpec as RefTenantSpec  # noqa: E402
from repro.serve import parse_tenant_arg as ref_parse  # noqa: E402
from repro_torch.checkpoint import restore_spec_state  # noqa: E402
from repro_torch.core import (ChangeDetector, Controller,  # noqa: E402
                              ExhaustiveSweep, IridescentRuntime)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serve import (AdmissionQueue, ContinuousBatcher,  # noqa: E402
                               ControllerGroup, DeficitRoundRobin,
                               MultiTenantExecutor, OpenLoopSource,
                               PackedBatch, Request, ServeEngine, TenantSpec,
                               make_tenant_context_fn, parse_tenant_arg)

D = 8

GOOD = ["chat=qwen3-0.6b:50:3", "bg=rwkv6-1.6b", "bg=rwkv6-1.6b::2",
        "x=a:", "x=a::", "x=a:7.5", "a=b:1e3:0.5"]
BAD = ["nameonly", "=arch", "x=", "x=a:1:2:3", "x=:5", "t=a::0",
       "t=a:-1", "t=a:fast", "t=a::heavy"]


@pytest.mark.parametrize("arg", GOOD + BAD)
@pytest.mark.parametrize("default_slo_ms", [None, 200.0])
def test_parse_tenant_arg_matches_reference(arg, default_slo_ms):
    try:
        want = ref_parse(arg, default_slo_ms=default_slo_ms)
    except ValueError:
        assert arg in BAD
        with pytest.raises(ValueError):
            parse_tenant_arg(arg, default_slo_ms=default_slo_ms)
        return
    assert arg in GOOD
    got = parse_tenant_arg(arg, default_slo_ms=default_slo_ms)
    assert (got.name, got.arch, got.slo_s, got.weight) == (
        want.name, want.arch, want.slo_s, want.weight)


def test_tenant_spec_validation_and_context_prefix():
    for kw in ({"weight": 0.0}, {"slo_s": -1.0}):
        with pytest.raises(ValueError):
            TenantSpec("t", "arch", **kw)
        with pytest.raises(ValueError):
            RefTenantSpec("t", "arch", **kw)
    fn = make_tenant_context_fn("t", lambda a, k: ("decode", 4))
    assert fn((), {}) == ("t", "decode", 4)
    assert make_tenant_context_fn("t", lambda a, k: 8)((), {}) == ("t", 8)
    assert make_tenant_context_fn("t", None)((), {}) == ("t",)


# -- toy tenants (the reference's test_serve_tenants.py cases) ----------------

def _toy_builder(spec):
    scale = spec.enum("scale", 1, (1, 2), guarded=False)

    def f(x, w):
        return (x @ w) * float(scale)

    return f


def _batch_ctx(args, kwargs):
    return int(args[0].shape[0])


class ToyExecutor:
    def __init__(self, handler):
        self.handler = handler
        self.w = torch.eye(D)

    def execute(self, batch):
        self.handler(torch.ones(batch.size, D), self.w)

    def retire(self, req):
        pass


def _toy_handlers(rt, tag=""):
    return [rt.register(f"toy[{t}]{tag}", _toy_builder,
                        context_fn=make_tenant_context_fn(t, _batch_ctx))
            for t in ("a", "b")]


def test_tenant_contexts_are_disjoint_per_tenant():
    rt = IridescentRuntime(async_compile=False)
    ha, hb = _toy_handlers(rt)
    engine = ServeEngine(ha, None, ContinuousBatcher(2, scheme="single"),
                         DeficitRoundRobin(),
                         executor=MultiTenantExecutor(
                             {"a": ToyExecutor(ha), "b": ToyExecutor(hb)}),
                         queue=AdmissionQueue())
    for tenant in ("a", "b"):
        engine.submit(Request(tenant=tenant, max_new_tokens=2))
    engine.run()
    assert ("a", 2) in ha.contexts() and ("b", 2) in hb.contexts()
    assert not set(ha.contexts()) & set(hb.contexts()) - {"default"}
    served = engine.metrics.summary()["tenants"]
    assert served["a"]["completed"] == 1 and served["b"]["completed"] == 1
    rt.shutdown()


def test_multitenant_executor_routing_and_validation():
    rt = IridescentRuntime(async_compile=False)
    ha = rt.register("toy[a]", _toy_builder, context_fn=_batch_ctx)
    with pytest.raises(ValueError):
        MultiTenantExecutor({})
    ex = MultiTenantExecutor({"a": ToyExecutor(ha)})
    with pytest.raises(KeyError, match="no executor for tenant"):
        ex.execute(PackedBatch(requests=[Request(tenant="z")], size=1,
                               joined=[], scheme="single", tenant="z"))

    class Phased(ToyExecutor):
        phased = True

    with pytest.raises(ValueError, match="agree on phased"):
        MultiTenantExecutor({"a": ToyExecutor(ha), "b": Phased(ha)})
    rt.shutdown()


def _sweep():
    return ExhaustiveSweep([{"scale": 2}, {"scale": 1}])


def _controller(h, dwell=2):
    return Controller(h, _sweep, dwell=dwell, wait_compiles=True, prefetch=0,
                      change_detector=lambda: ChangeDetector(float("inf")))


def test_controller_group_aggregates_and_validates():
    rt = IridescentRuntime(async_compile=False)
    ha, hb = _toy_handlers(rt)
    ca, cb = _controller(ha), _controller(hb)
    group = ControllerGroup([(ha, ca), (hb, cb)])
    assert group.controllers == {"toy[a]": ca, "toy[b]": cb}
    with pytest.raises(ValueError):
        ControllerGroup([])
    with pytest.raises(ValueError):
        ControllerGroup([(ha, ca), (ha, cb)])
    w, x = torch.eye(D), torch.ones(2, D)
    for _ in range(12):
        ha(x, w), hb(x, w)
        group.step()
    assert group.settled()
    assert set(group.best_configs()) == {"toy[a]", "toy[b]"}
    assert ("a", 2) in group.contexts() and ("b", 2) in group.contexts()
    rt.shutdown()


def _tenant_restart_stack(cache_dir, restore=False):
    rt = IridescentRuntime(async_compile=False,
                           variant_cache=str(cache_dir / "variants"))
    ha, hb = _toy_handlers(rt)
    restored = restore and restore_spec_state(
        str(cache_dir / "spec_state.json"), rt, wait=True)
    group = ControllerGroup([(ha, _controller(ha, 3)),
                             (hb, _controller(hb, 3))])
    engine = ServeEngine(ha, group, ContinuousBatcher(2, scheme="single"),
                         DeficitRoundRobin(),
                         executor=MultiTenantExecutor(
                             {"a": ToyExecutor(ha), "b": ToyExecutor(hb)}),
                         queue=AdmissionQueue())
    return rt, ha, hb, group, engine, restored


def _serve_both_tenants(engine, rounds=60):
    for _ in range(rounds):
        for tenant in ("a", "b"):
            while sum(1 for r in engine.active if r.tenant == tenant) + \
                    len(engine.queue.peek_tenant(tenant)) < 2:
                engine.submit(Request(tenant=tenant, max_new_tokens=2))
        engine.step()


def test_tenant_contexts_restore_from_spec_state_with_zero_builds(tmp_path):
    rt, ha, hb, group, engine, _ = _tenant_restart_stack(tmp_path)
    _serve_both_tenants(engine)
    assert group.settled()
    tuned = {name: {k: dict(cfg) for k, cfg in ctl.best_configs().items()}
             for name, ctl in group.controllers.items()}
    assert tuned["toy[a]"][("a", 2)] and tuned["toy[b]"][("b", 2)]
    assert rt.compile_stats()["xla_compiles"] > 0
    engine.shutdown(state_dir=str(tmp_path))
    assert (tmp_path / "spec_state.json").exists()

    rt2, ha2, hb2, group2, engine2, restored = _tenant_restart_stack(
        tmp_path, restore=True)
    assert restored
    assert ha2._seeded and hb2._seeded     # both tenants' contexts seeded
    _serve_both_tenants(engine2, rounds=20)
    warm = rt2.compile_stats()
    assert warm["xla_compiles"] == 0          # every variant from the cache
    assert warm["cache_hits"] > 0
    for name, ctl in group2.controllers.items():
        key = ("a", 2) if name == "toy[a]" else ("b", 2)
        assert ctl.settled(context=key)
        assert dict(ctl.best_configs()[key]) == tuned[name][key]
    rt2.shutdown()


# -- two models as tenants, token parity --------------------------------------

TENANTS = ["q=qwen3-0.6b:60000:2", "r=rwkv6-1.6b"]
ENGINE_ARGS = ["--batch", "2", "--max-len", "32", "--prefill-chunk", "4",
               "--compile-workers", "1", "--scheduler", "drr"]
#: (tenant, prompt tokens, new tokens) per request, all arriving at once
WORKLOAD = [("q", 5, 4), ("r", 9, 3), ("q", 3, 5), ("r", 7, 2),
            ("q", 6, 3)]
PINNED = {"q": {"cache_dtype": "float32"},
          "r": {"cache_dtype": "float32", "chunk_len": 16}}


def _args(add_engine_args):
    ap = argparse.ArgumentParser()
    add_engine_args(ap)
    return ap.parse_args(ENGINE_ARGS)


def _serve_pinned(built, group_cls, controller_cls, sweep_cls, source_cls,
                  request_cls, plain):
    pairs = []
    for name, st in built.stacks.items():
        cfg = {**PINNED[name], "rmsnorm_impl": plain}
        pairs.append((st.handler, controller_cls(
            st.handler, lambda cfg=cfg: sweep_cls([cfg]), dwell=1000,
            wait_compiles=True, prefetch=0)))
    built.engine.controller = group_cls(pairs)
    reqs = [request_cls(rid=2000 + i, tenant=t, prompt_tokens=p,
                        max_new_tokens=m)
            for i, (t, p, m) in enumerate(WORKLOAD)]
    built.engine.run(source=source_cls(built.engine.queue,
                                       [(0.0, r) for r in reqs]),
                     max_steps=300)
    assert built.engine.drain(timeout_s=60.0)
    served = built.engine.metrics.summary()["tenants"]
    built.engine.shutdown()
    return {r.rid: list(r.payload) for r in reqs}, served


def test_tenant_tokens_match_reference():
    ref_tenants = [ref_parse(t) for t in TENANTS]
    ref_built = ref_serve.build_tenant_engine(
        _args(ref_serve.add_engine_args), ref_tenants)
    params = {name: params_from_numpy(jax.tree_util.tree_map(
        np.asarray, ex.params), "cpu")
        for name, ex in ref_built.engine.executor.executors.items()}
    args = _args(serve.add_engine_args)
    args.device = "cpu"
    built = serve.build_tenant_engine(
        args, [parse_tenant_arg(t) for t in TENANTS], params=params)
    assert {n: st.cfg.mixer for n, st in built.stacks.items()} == {
        "q": "attn", "r": "rwkv6"}
    ref_tokens, ref_served = _serve_pinned(
        ref_built, RefGroup, RefController, RefSweep, RefSource, RefRequest,
        "xla_ref")
    tokens, served = _serve_pinned(
        built, ControllerGroup, Controller, ExhaustiveSweep, OpenLoopSource,
        Request, "torch_ref")
    assert [len(t) for t in tokens.values()] == [m for _, _, m in WORKLOAD]
    assert tokens == ref_tokens
    assert {n: s["completed"] for n, s in served.items()} == {
        n: s["completed"] for n, s in ref_served.items()} == {"q": 3, "r": 2}
    for st in built.stacks.values():
        assert {ctx[0] for ctx in st.handler.contexts()
                if ctx != "default"} == {st.spec.name}
