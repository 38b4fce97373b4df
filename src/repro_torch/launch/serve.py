"""Serving driver of the port: continuous-batching LM decode with online
specialization, on CUDA devices.

Run:
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --steps 60
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch rwkv6-1.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch hymba-1.5b --max-len 16

The port of ``repro.launch.serve``.  Requests arrive open-loop
(deterministic pseudo-Poisson at ``--rate``), pass a bounded admission
queue, are ordered by ``--scheduler`` and packed into bucketed batch
shapes by the continuous batcher.  Each engine step runs a chunked-prefill
or a decode batch through one registered serve handler whose context key
is ``(phase, bucket)``, over paged per-request KV pools; a
:class:`~repro_torch.core.safety.SafetyController` with shadow evaluation
explores ``cache_dtype`` x ``rmsnorm_impl`` per context, so the
hand-written CUDA RMSNorm competes with the plain version on measured
throughput.  The bucket scheme and the KV page geometry are tuned online
by their own Controllers.

The CLI serves the reduced ``--arch`` in fp32, as the reference does: any
of ``configs.ARCH_IDS`` (rwkv6-1.6b's and hymba-1.5b's contexts also
explore ``chunk_len``; hymba's attention cache is its window ring, which
pages per request only while ``--max-len`` is at most the window: 16
reduced, 1024 at full width);
:func:`build_engine` and :func:`build_tenant_engine` take configs and
parameters for other sizes (full width on the H100:
``configs.get_config("qwen3-0.6b").replace(compute_dtype="float32")``).

* ``--cache-dir DIR``: the runtime keeps the kernel libraries each variant
  loaded in ``DIR/variants`` and the engine saves the settled per-context
  configurations (and the safety plane's state) to
  ``DIR/spec_state.json`` at shutdown; a restart on the same directory
  seeds every context with its tuned config and makes zero ``nvcc``
  calls.  ``--portable-cache`` drops the device count from the cache key,
  for fleets.
* ``--tenant NAME=ARCH[:SLO_MS[:WEIGHT]]`` (repeatable): several models as
  tenants of one engine, weighted-fair by default.
* ``--replicas N`` (N > 1): this process becomes a router front over N
  subprocess workers (:mod:`repro_torch.serve.fleet.worker` ``--profile
  lm``), each on ``--device``; with ``--plane-dir`` the replicas share a
  specialization plane, so one replica's exploration warm-starts the rest.
* ``--telemetry-snapshot PATH``: a live status file that
  ``python -m repro_torch.launch.status PATH`` renders.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from types import SimpleNamespace
from typing import Any

from repro_torch.core import telemetry
from repro_torch.serve import Request, pseudo_poisson_times

KV_PAGE_SIZES = (8, 16, 64)


def synthetic_workload(n: int, rate: float, seed: int = 0,
                       budgets=(4, 8, 16, 32),
                       prompts=(16, 64, 128), tenant: str | None = None,
                       deadline_s: float | None = None,
                       max_len: int | None = None
                       ) -> list[tuple[float, Request]]:
    """Deterministic open-loop schedule: pseudo-Poisson arrivals at
    ``rate`` req/s with mixed prompt/decode lengths.  ``tenant`` and
    ``deadline_s`` stamp every request (multi-tenant runs give each
    tenant its own schedule off its own seed substream).  With ``max_len``
    a request that would not fit the cache is cut to fit (its budget to at
    most half of ``max_len``, its prompt to the rest), so a short cache
    (hymba's window) still serves the mix; a request that fits is kept as
    drawn."""
    rng = random.Random(seed)
    times = pseudo_poisson_times([(n / max(rate, 1e-9) * 4, rate)], seed=seed)
    out = []
    for t in times[:n]:
        prompt, budget = rng.choice(prompts), rng.choice(budgets)
        if max_len is not None and prompt + budget > max_len:
            budget = max(1, min(budget, max_len // 2))
            prompt = max(1, min(prompt, max_len - budget))
        out.append((t, Request(prompt_tokens=prompt, max_new_tokens=budget,
                               tenant=tenant, deadline_s=deadline_s)))
    return out


#: (flag, args attribute) for every engine flag — the fleet front
#: forwards these verbatim to its ``--profile lm`` workers.
_ENGINE_FLAGS = (
    ("--device", "device"),
    ("--arch", "arch"), ("--batch", "batch"), ("--max-len", "max_len"),
    ("--steps", "steps"), ("--dwell", "dwell"),
    ("--compile-workers", "compile_workers"), ("--prefetch", "prefetch"),
    ("--budget", "budget"), ("--cache-dir", "cache_dir"),
    ("--kv-page-size", "kv_page_size"), ("--prefill-chunk", "prefill_chunk"),
    ("--requests", "requests"), ("--rate", "rate"), ("--slo-ms", "slo_ms"),
    ("--queue-depth", "queue_depth"), ("--shed-policy", "shed_policy"),
    ("--scheduler", "scheduler"), ("--bucket-dwell", "bucket_dwell"),
    ("--kv-dwell", "kv_dwell"), ("--seed", "seed"),
    ("--shadow-frac", "shadow_frac"), ("--canary-frac", "canary_frac"),
    ("--promote-after", "promote_after"),
)


def add_engine_args(ap: argparse.ArgumentParser) -> None:
    """The single-engine flag set (the reference's, plus ``--device``),
    shared between this driver and the fleet worker
    (:mod:`repro_torch.serve.fleet.worker` ``--profile lm``)."""
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
                    help="persist built kernel libraries + tuned configs "
                         "here; a warm restart then makes zero nvcc calls")
    ap.add_argument("--portable-cache", action="store_true",
                    help="drop the device count from the variant-cache "
                         "fingerprint so built libraries are shareable "
                         "across fleet replicas (same device kind, "
                         "toolchain and versions required)")
    ap.add_argument("--kv-page-size", type=int, default=16,
                    help="initial KV page size (tokens per page); the "
                         "KVTuner searches the geometry menu online")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens consumed per chunked-prefill step "
                         "(long prompts interleave with decode steps)")
    ap.add_argument("--requests", type=int, default=64,
                    help="open-loop workload size (per replica in fleet "
                         "mode: each replica's substream offers this many)")
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


def _variant_cache(args):
    """The runtime's persistent variant cache under ``--cache-dir``."""
    from repro_torch.core import VariantCache

    if not args.cache_dir:
        return None
    return VariantCache(os.path.join(args.cache_dir, "variants"),
                        portable=getattr(args, "portable_cache", False))


def _spec_state_path(args) -> str | None:
    return (os.path.join(args.cache_dir, "spec_state.json")
            if args.cache_dir else None)


def build_engine(args, cfg=None, params: Any = None) -> SimpleNamespace:
    """Build the single-replica serving stack from parsed engine args.

    ``cfg`` defaults to the reduced ``--arch`` in fp32 (the reference's
    CLI model); ``params`` defaults to random weights drawn on the device
    from a generator seeded with 0.  Runs on ``args.device`` (default
    ``cuda``; raises without a CUDA device unless the CPU is asked for).
    With ``--cache-dir`` the previous run's spec_state is restored before
    the controllers are built: per-context configs seed the handler, and
    the bucket scheme, the KV plan and the safety plane (quarantine,
    last-known-good) start where that run left them.  Returns the runtime,
    engine, and every tuned part (the fleet worker runs exactly this
    stack per replica).
    """
    import torch

    from repro_torch import compat, configs
    from repro_torch.checkpoint import load_safety_state, restore_spec_state
    from repro_torch.core import (ChangeDetector, Controller, ExhaustiveSweep,
                                  IridescentRuntime, Quarantine,
                                  SafetyController)
    from repro_torch.core.runtime import decode_context_key
    from repro_torch.models import transformer as model
    from repro_torch.models.transformer import RunOptions
    from repro_torch.serve import (AdmissionQueue, BucketTuner,
                                   ContinuousBatcher, KVTuner, PagedKV,
                                   PhasedExecutor, ServeEngine, ServeMetrics,
                                   ShadowEvaluator, bucket_plan_builder,
                                   kv_plan_builder, make_scheduler)
    from repro_torch.serve.batcher import BUCKET_POINT
    from repro_torch.serve.kv import KV_LAYOUT_POINT, KV_PAGE_POINT
    from repro_torch.training import make_serve_builder, phase_context_fn

    device = compat.resolve_device(getattr(args, "device", None))
    if cfg is None:
        cfg = configs.get_reduced(args.arch).replace(compute_dtype="float32")
    rt = IridescentRuntime(async_compile=True,
                           max_compile_workers=args.compile_workers,
                           variant_cache=_variant_cache(args))
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

    # Restore *before* building the controllers: per-(phase,bucket) configs
    # are seeded onto the handler (the Controller warm-starts each context
    # as its traffic materializes), and the tuned bucket scheme / KV plan
    # land on their plan handlers' active configs.
    spec_state_path = _spec_state_path(args)
    initial_scheme = None
    initial_plan = None
    restored = False
    if spec_state_path and restore_spec_state(spec_state_path, rt, wait=True):
        restored = True
        initial_scheme = plan_handler.active_config().get(BUCKET_POINT)
        kv_cfg = kv_plan_handler.active_config()
        if KV_LAYOUT_POINT in kv_cfg:
            initial_plan = (kv_cfg[KV_LAYOUT_POINT],
                            kv_cfg.get(KV_PAGE_POINT, args.kv_page_size))

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
        # Warm-start the safety plane from the previous run's v3 state:
        # last-known-good configs seed rollback targets; quarantined
        # configs are blocked before the first proposal.
        safety_init = (load_safety_state(spec_state_path).get(
            "serve_step", {}) if spec_state_path else {})
        quarantine = Quarantine()
        for enc, cfgs in (safety_init.get("quarantined") or {}).items():
            for q in cfgs:
                quarantine.add("serve_step", decode_context_key(enc), q)
        controller = SafetyController(
            handler, policy_factory, shadow=shadow,
            canary_frac=getattr(args, "canary_frac", 0.1),
            promote_after=getattr(args, "promote_after", 2),
            quarantine=quarantine,
            initial_last_known_good=safety_init.get("last_known_good"),
            **controller_kwargs)

    slo_s = args.slo_ms / 1e3
    metrics = ServeMetrics(slo_s=slo_s)
    tuner = BucketTuner(batcher, metric=metrics.interval_goodput,
                        dwell=args.bucket_dwell, plan_handler=plan_handler,
                        initial_scheme=initial_scheme)
    kv_tuner = KVTuner(kv, metric=metrics.interval_goodput,
                       dwell=args.kv_dwell, page_sizes=page_sizes,
                       plan_handler=kv_plan_handler,
                       initial_plan=initial_plan)
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
        device=device, restored=restored, initial_scheme=initial_scheme,
        initial_plan=initial_plan)


def build_tenant_engine(args, tenants, cfgs: dict | None = None,
                        params: dict | None = None) -> SimpleNamespace:
    """Build one multi-tenant engine: N models, one runtime, one
    CompileService, one variant cache.

    Each :class:`~repro_torch.serve.tenancy.TenantSpec` gets its own
    registered handler ``serve_step[name]`` whose context key is
    ``(tenant, phase, bucket)``, its own params/paged-KV/executor, and its
    own Controller — aggregated behind a
    :class:`~repro_torch.serve.tenancy.ControllerGroup` and a
    :class:`~repro_torch.serve.tenancy.MultiTenantExecutor`.  Scheduling
    between tenants defaults to weighted-fair DRR (``--scheduler drr``)
    using each tenant's declared weight.  The bucket/KV plan tuners and
    the safety plane are single-model machinery and stay off here (tenant
    engines run plain Controllers with a fixed bucket scheme).

    ``cfgs`` and ``params`` map a tenant's name to its model config and
    weights; a tenant missing from them gets the reduced ``arch`` in fp32
    and random weights from a generator seeded with 0, as in
    :func:`build_engine`.
    """
    import torch

    from repro_torch import compat, configs
    from repro_torch.checkpoint import restore_spec_state
    from repro_torch.core import (ChangeDetector, Controller, ExhaustiveSweep,
                                  IridescentRuntime)
    from repro_torch.models import transformer as model
    from repro_torch.models.transformer import RunOptions
    from repro_torch.serve import (AdmissionQueue, ContinuousBatcher,
                                   ControllerGroup, DeficitRoundRobin,
                                   MultiTenantExecutor, PagedKV,
                                   PhasedExecutor, ServeEngine, ServeMetrics,
                                   make_scheduler, make_tenant_context_fn)
    from repro_torch.training import make_serve_builder, phase_context_fn

    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    device = compat.resolve_device(getattr(args, "device", None))
    cfgs, params = dict(cfgs or {}), dict(params or {})
    rt = IridescentRuntime(async_compile=True,
                           max_compile_workers=args.compile_workers,
                           variant_cache=_variant_cache(args))

    stacks = {}
    for spec in tenants:
        cfg = cfgs.get(spec.name)
        if cfg is None:
            cfg = configs.get_reduced(spec.arch).replace(
                compute_dtype="float32")
        handler = rt.register(
            f"serve_step[{spec.name}]", make_serve_builder(cfg),
            context_fn=make_tenant_context_fn(spec.name, phase_context_fn))
        stacks[spec.name] = SimpleNamespace(spec=spec, cfg=cfg,
                                            handler=handler)

    # Restore before building controllers (same ordering contract as the
    # single-model path): every tenant's settled (tenant, phase, bucket)
    # contexts seed onto its handler, keyed losslessly by the tuple codec.
    spec_state_path = _spec_state_path(args)
    restored = bool(spec_state_path
                    and restore_spec_state(spec_state_path, rt, wait=True))

    pairs = []
    executors = {}
    for spec in tenants:
        st = stacks[spec.name]
        cfg = st.cfg
        st.params = params.get(spec.name)
        if st.params is None:
            gen = torch.Generator(device=device).manual_seed(0)
            st.params = model.init_params(gen, cfg)
        run_opts = RunOptions(decode_cache_dtype="float32")
        st.kv = PagedKV(model.init_cache(cfg, 1, args.max_len, run_opts,
                                         device="cpu"),
                        model.cache_axes(cfg), max_len=args.max_len,
                        capacity_tokens=args.batch * args.max_len,
                        page_size=args.kv_page_size, device=device)
        executors[spec.name] = PhasedExecutor(
            st.handler, st.params, st.kv, prefill_chunk=args.prefill_chunk,
            vocab_size=cfg.vocab_size)
        space = st.handler.spec_space()
        labels = ["cache_dtype", "rmsnorm_impl"] + (
            ["chunk_len"] if cfg.mixer in ("rwkv6", "hymba") else [])
        st.controller = Controller(
            st.handler,
            (lambda space=space, labels=labels:
             ExhaustiveSweep.from_space(space, labels)),
            dwell=args.dwell, change_detector=lambda: ChangeDetector(0.3),
            wait_compiles=False, prefetch=args.prefetch, budget=args.budget)
        pairs.append((st.handler, st.controller))

    group = ControllerGroup(pairs)
    tenant_slos = {t.name: t.slo_s for t in tenants if t.slo_s is not None}
    if args.scheduler == "drr":
        scheduler = DeficitRoundRobin({t.name: t.weight for t in tenants})
    else:
        scheduler = make_scheduler(args.scheduler)
    slo_s = args.slo_ms / 1e3
    metrics = ServeMetrics(slo_s=slo_s, tenant_slos=tenant_slos)
    first = stacks[tenants[0].name]
    engine = ServeEngine(
        first.handler, group,
        ContinuousBatcher(args.batch), scheduler,
        executor=MultiTenantExecutor(executors),
        queue=AdmissionQueue(depth=args.queue_depth, policy=args.shed_policy),
        metrics=metrics, slo_s=slo_s, tenant_slos=tenant_slos)
    return SimpleNamespace(rt=rt, engine=engine, group=group,
                           stacks=stacks, tenants=list(tenants),
                           metrics=metrics, restored=restored, device=device)


def tenant_schedule(args, tenants) -> list:
    """Every tenant's open-loop schedule, each off its own seed
    substream, merged."""
    from repro_torch.serve import substream_seed

    schedule: list = []
    for spec in tenants:
        schedule += synthetic_workload(
            args.requests, args.rate,
            seed=substream_seed(args.seed, spec.name),
            tenant=spec.name, deadline_s=spec.slo_s, max_len=args.max_len)
    return schedule


def _run_tenants(args) -> None:
    """Multi-tenant single-process serving (``--tenant`` given)."""
    from repro_torch.serve import OpenLoopSource, parse_tenant_arg

    tenants = [parse_tenant_arg(t, default_slo_ms=args.slo_ms)
               for t in args.tenant]
    built = build_tenant_engine(args, tenants)
    rt, engine = built.rt, built.engine
    if built.restored:
        seeded = {name: list(st.handler._seeded)
                  for name, st in built.stacks.items()}
        print(f"restored spec state: seeded contexts={seeded}")
    source = OpenLoopSource(engine.queue, tenant_schedule(args, tenants))

    t0 = time.perf_counter()
    engine.run(source=source, max_steps=args.steps)
    engine.drain(timeout_s=60.0)
    wall = time.perf_counter() - t0
    stats = engine.stats()
    served = stats["serve"]
    print(f"device: {built.device}")
    print(f"served {served['completed']} requests / "
          f"{served['completed_tokens']} tokens in {wall:.2f}s across "
          f"{len(tenants)} tenants "
          f"(met={served['slo_met']} missed={served['slo_missed']})")
    for name, sub in (served.get("tenants") or {}).items():
        print(f"tenant {name}: completed={sub['completed']} "
              f"goodput_tokens={sub['goodput_tokens']} "
              f"slo_ms={(sub['slo_s'] or 0) * 1e3:.0f} "
              f"met={sub['slo_met']} missed={sub['slo_missed']} "
              f"p95_ms={sub['latency_p95_ms']}")
    print(f"tenant steps: {stats.get('tenant_steps')}  "
          f"scheduler: {json.dumps(stats.get('scheduler', {}))}")
    for name, st in built.stacks.items():
        cfgs = {str(k): ({kk: repr(vv) for kk, vv in cfg.items()}
                         if cfg is not None else None)
                for k, cfg in st.controller.best_configs().items()}
        print(f"tenant {name} per-context configs: {json.dumps(cfgs)}")
    _print_kernels()
    print(f"compile stats: {json.dumps(rt.compile_stats())}")
    _export_trace(args)
    engine.shutdown(state_dir=args.cache_dir)


def _status_provider(built, rt, args):
    """Assemble the live snapshot ``launch/status.py`` renders: per-context
    lifecycle, safety stage, goodput window, compile queue, bus health."""
    def provider() -> dict:
        controller, engine = built.controller, built.engine
        contexts = {}
        for key, st in controller.status().items():
            contexts[repr(key)] = {
                "phase": st["phase"],
                "active": st["active"],
                "pending": st["pending"],
                "best_metric": st["best_metric"],
                "calls": st["calls"],
                "explorations": st["explorations"],
                "tput_window": st["tput_window"],
            }
        doc = {
            "mode": "single",
            "replica": args.replica_id,
            "handler": built.handler.name,
            "slo_ms": args.slo_ms,
            "contexts": contexts,
            "serve": built.metrics.summary(),
            "queue": {"waiting": len(engine.queue),
                      "in_flight": len(engine.active)},
            "compile": rt.compile_stats(),
        }
        status_fn = getattr(controller, "safety_status", None)
        if callable(status_fn):
            doc["safety"] = status_fn()
        _tb = telemetry.bus()
        if _tb is not None:
            doc["bus"] = _tb.stats()
        return doc
    return provider


def _print_kernels() -> None:
    """K1's launches and the registry's fallbacks in this process, and
    how each kernel library was obtained (built by ``nvcc`` or loaded)."""
    from repro_torch.kernels import build, registry
    from repro_torch.kernels.rmsnorm import kernel as rmsnorm_kernel

    fallbacks = {"/".join(k): v for k, v in
                 registry.default_registry.fallback_counts.items()}
    libraries = {name: {"built": info["built"],
                        "seconds": round(info["seconds"], 4)}
                 for name, info in build.build_logs().items()}
    print(f"kernels: rmsnorm cuda launches={rmsnorm_kernel.launches} "
          f"fallbacks={json.dumps(fallbacks)} "
          f"libraries={json.dumps(libraries)}")


def _run_single(args) -> None:
    from repro_torch.serve import OpenLoopSource
    from repro_torch.serve.fleet import SpecPlane

    built = build_engine(args)
    rt, engine = built.rt, built.engine
    snap = (telemetry.SnapshotWriter(args.telemetry_snapshot,
                                     _status_provider(built, rt, args),
                                     interval_s=args.snapshot_interval_s)
            if args.telemetry_snapshot else None)
    if built.restored:
        print(f"restored spec state: bucket scheme={built.initial_scheme}, "
              f"kv plan={built.initial_plan}, "
              f"seeded contexts={list(built.handler._seeded)}")
    plane = (SpecPlane(args.plane_dir, replica=args.replica_id,
                       quarantine=getattr(built.controller, "quarantine",
                                          None))
             if args.plane_dir else None)
    if plane is not None and plane.poll(rt):
        # Warm start off the fleet plane: remotely settled (phase, bucket)
        # contexts begin in EXPLOIT when their traffic materializes.
        print(f"plane: seeded contexts={list(built.handler._seeded)}")

    schedule = synthetic_workload(args.requests, args.rate, seed=args.seed,
                                  max_len=args.max_len)
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
    _print_kernels()
    print(f"compile stats: {json.dumps(rt.compile_stats())}")
    status_fn = getattr(built.controller, "safety_status", None)
    if callable(status_fn):
        st = status_fn()
        print(f"safety: promotions={st['promotions']} "
              f"rollbacks={st['rollbacks']} "
              f"shadow_rejections={st['shadow_rejections']} "
              f"canary_rejections={st['canary_rejections']} "
              f"quarantined={st['quarantined']}")
    if plane is not None:
        n = plane.publish_controller("serve_step", built.controller)
        print(f"plane: published {n} settled winners")
    if snap is not None:
        snap.close()                      # one final snapshot at rest
    _export_trace(args)
    # shutdown drains (already drained), persists spec state once settled,
    # and stops the compile workers.
    engine.shutdown(state_dir=args.cache_dir)


def _export_trace(args) -> None:
    if not args.trace_out:
        return
    _tb = telemetry.bus()
    if _tb is None:
        return
    doc = telemetry.export_chrome_trace(_tb.events(), args.trace_out)
    print(f"trace: wrote {len(doc['traceEvents'])} events to "
          f"{args.trace_out} ({json.dumps(_tb.stats())})")


def _run_fleet(args) -> None:
    """Router front: N subprocess lm workers behind a routing policy."""
    from repro_torch.serve import OpenLoopSource, ServeMetrics, substream_seed
    from repro_torch.serve.fleet import ReplicaRouter
    from repro_torch.serve.fleet.worker import (SubprocessReplica,
                                                worker_command, worker_env)

    passthrough: list[str] = []
    for flag, attr in _ENGINE_FLAGS:
        v = getattr(args, attr)
        if v is not None:
            passthrough += [flag, str(v)]
    if args.portable_cache:
        passthrough.append("--portable-cache")
    if args.no_safety:
        passthrough.append("--no-safety")
    if args.trace_out or args.telemetry_snapshot:
        # Workers run their own flight recorder and forward the stream;
        # SubprocessReplica absorbs it onto this front's bus per replica.
        passthrough.append("--telemetry")
    env = worker_env()
    replicas = []
    for i in range(args.replicas):
        cmd = worker_command("--profile", "lm", "--replica-id", str(i),
                             *passthrough)
        if args.plane_dir:
            cmd += ["--plane-dir", args.plane_dir,
                    "--plane-poll-s", str(args.plane_poll_s)]
        replicas.append(SubprocessReplica(cmd, name=str(i), env=env))
    print(f"fleet: spawned {args.replicas} lm workers "
          f"(router={args.router}, plane={args.plane_dir or 'off'})")
    for r in replicas:
        if not r.wait_ready(300.0):
            for other in replicas:
                other.close()
            for other in replicas:
                other.join(30.0)
            raise RuntimeError(f"replica {r.name} failed to start")
    print(f"fleet: {len(replicas)} workers ready")

    # Per-replica substreams of the root seed: N times the single-replica
    # offered load without N byte-identical arrival processes.
    schedule: list = []
    for i in range(args.replicas):
        schedule += synthetic_workload(args.requests, args.rate,
                                       seed=substream_seed(args.seed, i),
                                       max_len=args.max_len)
    router = ReplicaRouter(replicas, policy=args.router)
    source = OpenLoopSource(router, schedule)

    def fleet_provider() -> dict:
        doc = {"mode": "fleet", "router": router.stats(),
               "replicas": {r.name: {"depth": r.depth()} for r in replicas}}
        _tb = telemetry.bus()
        if _tb is not None:
            doc["bus"] = _tb.stats()
        return doc

    snap = (telemetry.SnapshotWriter(args.telemetry_snapshot, fleet_provider,
                                     interval_s=args.snapshot_interval_s)
            if args.telemetry_snapshot else None)
    while not source.exhausted:
        source.pump(time.perf_counter())
        delay = source.next_due(time.perf_counter())
        if delay:
            time.sleep(min(delay, 0.02))
    for r in replicas:
        r.close()
    stats = [r.join(300.0) for r in replicas]
    alive = [s for s in stats if s is not None]
    print(f"router: {json.dumps(router.stats())}")
    if not alive:
        raise RuntimeError("no replica returned stats")
    merged = ServeMetrics.merge(*(s["metrics"] for s in alive)).summary()
    wall = max(s["wall_s"] for s in alive)
    print(f"fleet served {merged['completed']} requests / "
          f"{merged['completed_tokens']} tokens across {len(alive)} "
          f"replicas in {wall:.2f}s "
          f"({merged['goodput_tokens'] / wall:.1f} goodput tok/s; "
          f"met={merged['slo_met']} missed={merged['slo_missed']})")
    print(f"fleet p50/p95/p99 latency ms: {merged['latency_p50_ms']} / "
          f"{merged['latency_p95_ms']} / {merged['latency_p99_ms']}")
    for s in alive:
        print(f"replica {s['replica']}: steps={s['steps']} "
              f"time_to_settled_s={s['time_to_settled_s']} "
              f"rmsnorm_launches={s['rmsnorm_launches']} "
              f"libraries={json.dumps(s['libraries'])} "
              f"compile={json.dumps(s['compile'])}")
    if snap is not None:
        snap.close()
    _export_trace(args)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    add_engine_args(ap)
    ap.add_argument("--tenant", action="append", default=None,
                    metavar="NAME=ARCH[:SLO_MS[:WEIGHT]]",
                    help="repeatable: serve several models as tenants of "
                         "one engine (own SLO class and DRR fair-share "
                         "weight per tenant); implies single-process mode "
                         "and defaults --scheduler to drr")
    ap.add_argument("--replicas", type=int, default=1,
                    help="N > 1 turns this process into a router front "
                         "over N subprocess engine replicas")
    ap.add_argument("--router", default="jsq",
                    choices=("round-robin", "jsq", "spill"),
                    help="fleet routing policy")
    ap.add_argument("--plane-dir", default=None,
                    help="shared SpecPlane directory: publish settled "
                         "winners, seed remotely-settled ones")
    ap.add_argument("--plane-poll-s", type=float, default=0.5,
                    help="plane subscribe/publish interval")
    ap.add_argument("--replica-id", default="0",
                    help="this replica's plane identity (single mode)")
    ap.add_argument("--trace-out", default=None,
                    help="write the flight-recorder stream as Chrome-trace "
                         "JSON here on exit (enables the event bus)")
    ap.add_argument("--telemetry-snapshot", default=None,
                    help="periodically write an atomic live-status JSON "
                         "snapshot here (read it with "
                         "repro_torch.launch.status)")
    ap.add_argument("--snapshot-interval-s", type=float, default=1.0,
                    help="telemetry snapshot period")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.trace_out or args.telemetry_snapshot:
        telemetry.enable()
    if args.tenant:
        if args.replicas > 1:
            ap.error("--tenant is single-process; drop --replicas")
        if "--scheduler" not in argv and args.scheduler == "fcfs":
            args.scheduler = "drr"    # tenants default to weighted-fair
        _run_tenants(args)
    elif args.replicas > 1:
        _run_fleet(args)
    else:
        _run_single(args)


if __name__ == "__main__":
    main()
