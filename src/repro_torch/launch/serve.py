"""Serving driver of the port: continuous-batching LM decode with online
specialization, on one CUDA device.

Run:
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --steps 60
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch rwkv6-1.6b

The port of ``repro.launch.serve`` for a single replica.  Requests arrive
open-loop (deterministic pseudo-Poisson at ``--rate``), pass a bounded
admission queue, are ordered by ``--scheduler`` and packed into bucketed
batch shapes by the continuous batcher.  Each engine step runs a
chunked-prefill or a decode batch through one registered serve handler
whose context key is ``(phase, bucket)``, over paged per-request KV pools;
a :class:`~repro_torch.core.safety.SafetyController` with shadow
evaluation explores ``cache_dtype`` x ``rmsnorm_impl`` per context, so the
hand-written CUDA RMSNorm competes with the plain version on measured
throughput.  The bucket scheme and the KV page geometry are tuned online
by their own Controllers.

The CLI serves the reduced ``--arch`` (qwen3-0.6b, or rwkv6-1.6b, whose
contexts also explore ``chunk_len``) in fp32, as the reference does;
:func:`build_engine` takes a config for other sizes (full width on the
H100: ``configs.get_config("qwen3-0.6b").replace(compute_dtype="float32")``).
Not ported yet, and refused with the ROADMAP item that brings them:
``--cache-dir`` (M3), ``--replicas`` > 1, ``--plane-dir`` and ``--tenant``
(M10).
"""
from __future__ import annotations

import argparse
import json
import random
import time
from types import SimpleNamespace
from typing import Any

from repro_torch.core import telemetry
from repro_torch.serve import Request, pseudo_poisson_times

KV_PAGE_SIZES = (8, 16, 64)

#: flags whose machinery is not ported yet -> the ROADMAP item
UNPORTED_FLAGS = {
    "cache_dir": "--cache-dir needs the variant cache and spec_state "
                 "persistence (ROADMAP M3)",
    "plane_dir": "--plane-dir needs the fleet spec plane (ROADMAP M10)",
    "tenant": "--tenant needs multi-tenant serving (ROADMAP M10)",
}


def synthetic_workload(n: int, rate: float, seed: int = 0,
                       budgets=(4, 8, 16, 32),
                       prompts=(16, 64, 128), tenant: str | None = None,
                       deadline_s: float | None = None
                       ) -> list[tuple[float, Request]]:
    """Deterministic open-loop schedule: pseudo-Poisson arrivals at
    ``rate`` req/s with mixed prompt/decode lengths."""
    rng = random.Random(seed)
    times = pseudo_poisson_times([(n / max(rate, 1e-9) * 4, rate)], seed=seed)
    return [(t, Request(prompt_tokens=rng.choice(prompts),
                        max_new_tokens=rng.choice(budgets),
                        tenant=tenant, deadline_s=deadline_s))
            for t in times[:n]]


def add_engine_args(ap: argparse.ArgumentParser) -> None:
    """The single-engine flag set (the reference's, plus ``--device``)."""
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda; pass "
                         "cpu to run on the host)")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=8,
                    help="batch cap = largest batch-shape bucket")
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=240,
                    help="cap on engine iterations")
    ap.add_argument("--dwell", type=int, default=20)
    ap.add_argument("--compile-workers", type=int, default=2,
                    help="CompileService worker threads")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="speculative builds ahead of the policy")
    ap.add_argument("--budget", type=float, default=None,
                    help="skip candidates whose expected build cost "
                         "exceeds BUDGET x the expected dwell time "
                         "(CompileService telemetry; default: no gating)")
    ap.add_argument("--cache-dir", default=None,
                    help="not ported yet (ROADMAP M3)")
    ap.add_argument("--kv-page-size", type=int, default=16,
                    help="initial KV page size (tokens per page); the "
                         "KVTuner searches the geometry menu online")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens consumed per chunked-prefill step "
                         "(long prompts interleave with decode steps)")
    ap.add_argument("--requests", type=int, default=64,
                    help="open-loop workload size")
    ap.add_argument("--rate", type=float, default=40.0,
                    help="mean arrival rate (req/s) of the open-loop load")
    ap.add_argument("--slo-ms", type=float, default=2000.0,
                    help="per-request arrival-to-finish SLO")
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="admission queue bound (backpressure)")
    ap.add_argument("--shed-policy", default="reject",
                    choices=("reject", "shed-oldest"))
    ap.add_argument("--scheduler", default="fcfs",
                    choices=("fcfs", "sjf", "deadline", "drr"))
    ap.add_argument("--bucket-dwell", type=int, default=25,
                    help="engine steps per bucket-scheme candidate")
    ap.add_argument("--kv-dwell", type=int, default=25,
                    help="engine steps per KV-geometry candidate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shadow-frac", type=float, default=0.25,
                    help="fraction of live calls mirrored for shadow "
                         "evaluation (0 disables shadowing; candidates "
                         "then go straight to canary)")
    ap.add_argument("--canary-frac", type=float, default=0.1,
                    help="slice of a context's live traffic a "
                         "shadow-passed candidate serves during canary "
                         "probation")
    ap.add_argument("--promote-after", type=int, default=2,
                    help="consecutive in-SLO canary dwells required "
                         "before a candidate is promoted")
    ap.add_argument("--no-safety", action="store_true",
                    help="disable shadow/canary/rollback and run the "
                         "plain Controller")


def build_engine(args, cfg=None, params: Any = None) -> SimpleNamespace:
    """Build the single-replica serving stack from parsed engine args.

    ``cfg`` defaults to the reduced ``--arch`` in fp32 (the reference's
    CLI model); ``params`` defaults to random weights drawn on the device
    from a generator seeded with 0.  Runs on ``args.device`` (default
    ``cuda``; raises without a CUDA device unless the CPU is asked for).
    Returns the runtime, engine, and every tuned part.
    """
    import torch

    from repro_torch import compat, configs
    from repro_torch.core import (ChangeDetector, Controller, ExhaustiveSweep,
                                  IridescentRuntime, Quarantine,
                                  SafetyController)
    from repro_torch.models import transformer as model
    from repro_torch.models.transformer import RunOptions
    from repro_torch.serve import (AdmissionQueue, BucketTuner,
                                   ContinuousBatcher, KVTuner, PagedKV,
                                   PhasedExecutor, ServeEngine, ServeMetrics,
                                   ShadowEvaluator, bucket_plan_builder,
                                   kv_plan_builder, make_scheduler)
    from repro_torch.training import make_serve_builder, phase_context_fn

    for attr, why in UNPORTED_FLAGS.items():
        if getattr(args, attr, None):
            raise NotImplementedError(why)
    device = compat.resolve_device(getattr(args, "device", None))
    if cfg is None:
        cfg = configs.get_reduced(args.arch).replace(compute_dtype="float32")
    rt = IridescentRuntime(async_compile=True,
                           max_compile_workers=args.compile_workers)
    # The generic variant takes the registry's best entry on this host
    # (the CUDA kernel on Hopper, the plain version on the CPU); the
    # reference pins its plain entry because its alternative on a CPU host
    # is the Pallas interpreter.
    handler = rt.register(
        "serve_step", make_serve_builder(cfg),
        context_fn=phase_context_fn)          # (phase, bucket) contexts
    batcher = ContinuousBatcher(args.batch)
    plan_handler = rt.register(
        "bucket_plan",
        bucket_plan_builder(list(batcher.schemes), batcher.default_scheme))
    page_sizes = tuple(sorted({args.kv_page_size, *KV_PAGE_SIZES}))
    kv_plan_handler = rt.register(
        "kv_plan",
        kv_plan_builder(("paged", "contig"), page_sizes, "paged",
                        args.kv_page_size))

    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = model.init_params(gen, cfg)
    run_opts = RunOptions(decode_cache_dtype="float32")
    # The template stays on the host: PagedKV keeps its pools there and
    # uploads each step's cache to ``device``.
    kv = PagedKV(model.init_cache(cfg, 1, args.max_len, run_opts,
                                  device="cpu"),
                 model.cache_axes(cfg), max_len=args.max_len,
                 capacity_tokens=args.batch * args.max_len,
                 page_size=args.kv_page_size, device=device)
    executor = PhasedExecutor(handler, params, kv,
                              prefill_chunk=args.prefill_chunk,
                              vocab_size=cfg.vocab_size)

    space = handler.spec_space()
    labels = ["cache_dtype", "rmsnorm_impl"] + (
        ["chunk_len"] if cfg.mixer in ("rwkv6", "hymba") else [])
    policy_factory = lambda: ExhaustiveSweep.from_space(space, labels)
    controller_kwargs = dict(
        dwell=args.dwell, change_detector=lambda: ChangeDetector(0.3),
        wait_compiles=False, prefetch=args.prefetch, budget=args.budget)
    shadow = None
    if getattr(args, "no_safety", False):
        # Candidates serve live traffic directly and a detected change
        # restarts exploration without rollback.
        controller = Controller(handler, policy_factory, **controller_kwargs)
    else:
        shadow_frac = getattr(args, "shadow_frac", 0.25)
        if shadow_frac and shadow_frac > 0:
            # The weights (argument 0) are only read: samples share them.
            shadow = ShadowEvaluator(handler, sample_frac=shadow_frac,
                                     shared_args=(0,))
        controller = SafetyController(
            handler, policy_factory, shadow=shadow,
            canary_frac=getattr(args, "canary_frac", 0.1),
            promote_after=getattr(args, "promote_after", 2),
            quarantine=Quarantine(),
            **controller_kwargs)

    slo_s = args.slo_ms / 1e3
    metrics = ServeMetrics(slo_s=slo_s)
    tuner = BucketTuner(batcher, metric=metrics.interval_goodput,
                        dwell=args.bucket_dwell, plan_handler=plan_handler)
    kv_tuner = KVTuner(kv, metric=metrics.interval_goodput,
                       dwell=args.kv_dwell, page_sizes=page_sizes,
                       plan_handler=kv_plan_handler)
    engine = ServeEngine(
        handler, controller, batcher, make_scheduler(args.scheduler),
        executor=executor,
        queue=AdmissionQueue(depth=args.queue_depth, policy=args.shed_policy),
        tuner=tuner, kv_tuner=kv_tuner, metrics=metrics, slo_s=slo_s,
        shadow=shadow)
    return SimpleNamespace(
        rt=rt, engine=engine, handler=handler, controller=controller,
        batcher=batcher, tuner=tuner, kv_tuner=kv_tuner, kv=kv,
        metrics=metrics, shadow=shadow, cfg=cfg, params=params,
        device=device)


def _run_single(args) -> None:
    from repro_torch.kernels import registry
    from repro_torch.kernels.rmsnorm import kernel as rmsnorm_kernel
    from repro_torch.serve import OpenLoopSource

    built = build_engine(args)
    rt, engine = built.rt, built.engine
    schedule = synthetic_workload(args.requests, args.rate, seed=args.seed)
    source = OpenLoopSource(engine.queue, schedule)

    t0 = time.perf_counter()
    engine.run(source=source, max_steps=args.steps)
    engine.drain(timeout_s=60.0)
    wall = time.perf_counter() - t0
    stats = engine.stats()
    served = stats["serve"]
    print(f"device: {built.device}")
    print(f"served {served['completed']} requests / "
          f"{served['completed_tokens']} tokens in {wall:.2f}s "
          f"(goodput basis: slo={args.slo_ms:.0f}ms, "
          f"met={served['slo_met']} missed={served['slo_missed']})")
    print(f"p50/p95/p99 latency ms: {served['latency_p50_ms']} / "
          f"{served['latency_p95_ms']} / {served['latency_p99_ms']}")
    print(f"bucket steps: {stats['bucket_steps']}  "
          f"phase steps: {stats['phase_steps']}  "
          f"scheme: {built.tuner.active_scheme()} "
          f"(boundaries {built.batcher.schemes[built.tuner.active_scheme()]})")
    print(f"kv: plan={built.kv_tuner.active_plan()} pools="
          f"{json.dumps(built.kv.stats()['pools'])}")
    best_cfgs = {str(k): ({kk: repr(vv) for kk, vv in cfg.items()}
                          if cfg is not None else None)
                 for k, cfg in built.controller.best_configs().items()}
    print(f"per-context configs: {json.dumps(best_cfgs)}")
    print(f"kernels: rmsnorm cuda launches={rmsnorm_kernel.launches} "
          f"fallbacks={json.dumps({'/'.join(k): v for k, v in registry.default_registry.fallback_counts.items()})}")
    print(f"compile stats: {json.dumps(rt.compile_stats())}")
    status_fn = getattr(built.controller, "safety_status", None)
    if callable(status_fn):
        st = status_fn()
        print(f"safety: promotions={st['promotions']} "
              f"rollbacks={st['rollbacks']} "
              f"shadow_rejections={st['shadow_rejections']} "
              f"canary_rejections={st['canary_rejections']} "
              f"quarantined={st['quarantined']}")
    if args.trace_out:
        _tb = telemetry.bus()
        if _tb is not None:
            doc = telemetry.export_chrome_trace(_tb.events(), args.trace_out)
            print(f"trace: wrote {len(doc['traceEvents'])} events to "
                  f"{args.trace_out} ({json.dumps(_tb.stats())})")
    engine.shutdown()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    add_engine_args(ap)
    ap.add_argument("--tenant", action="append", default=None,
                    help="not ported yet (ROADMAP M10)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="only 1 is ported (fleet: ROADMAP M10)")
    ap.add_argument("--plane-dir", default=None,
                    help="not ported yet (ROADMAP M10)")
    ap.add_argument("--trace-out", default=None,
                    help="write the flight-recorder stream as Chrome-trace "
                         "JSON here on exit (enables the event bus)")
    args = ap.parse_args(argv)
    for attr, why in UNPORTED_FLAGS.items():
        if getattr(args, attr, None):
            ap.error(why)
    if args.replicas != 1:
        ap.error("--replicas > 1 needs the fleet router (ROADMAP M10)")
    if args.trace_out:
        telemetry.enable()
    _run_single(args)


if __name__ == "__main__":
    main()
