#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU (H100).

Run from the root of a checkout, on a machine with the card:

    python3 chip_smoke.py

It imports the port (``src/repro_torch``) and nothing of JAX or of the
JAX package, and runs five phases; any failure exits non-zero.

1. Device: prints the card's name and power limit (``nvidia-smi``) and
   checks compute capability (9, 0).
2. Build: compiles every kernel of the serve path from the sources in the
   checkout (``nvcc`` into the git-ignored ``build/kernels``).
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card, at every shape the served batch buckets give it, the reference's
   test shapes, widths and a misaligned view that take its scalar path,
   in fp32 (tolerance 1e-5) and bf16 (3e-2); times the kernel, the plain
   version and the one-call PyTorch equivalent with CUDA events.
4. Main path: ``repro_torch.launch.serve.build_engine`` serves qwen3-0.6b
   at full width (28 layers, d=1024, vocab 151936; random weights from
   seed 0) in fp32, through the default safety controller that explores
   ``cache_dtype`` x ``rmsnorm_impl``.  Launch counters are zeroed just
   before and read just after; every kernel of the path must have
   launched and none may have fallen back.
5. Parity at full width: the serve handler pinned to the plain RMSNorm and
   then to the CUDA kernel, on the same inputs (one 16-token prefill chunk
   and 8 teacher-forced decode steps), must agree within a max relative
   logits difference of 1e-3 — the two differ only in the RMSNorm's
   reduction order, compounded over 28 layers.

The line before the last is a JSON object ``{"kernels": [...]}`` with one
entry per kernel; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

#: (rows, d) per rmsnorm launch on one full-width decode step at batch 8,
#: with launches per step: norm1+norm2 per layer + final, q-norm
#: (16 heads x 8 rows), k-norm (8 kv heads x 8 rows)
DECODE_SHAPES = {(8, 1024): 2 * 28 + 1, (128, 128): 28, (64, 128): 28}
#: every (rows, d) the served batch buckets B = 1, 2, 4, 8 give the kernel
#: (prefill runs as a scan of decode steps, so it gives the same shapes)
BUCKET_SHAPES = sorted({s for b in (1, 2, 4, 8)
                        for s in ((b, 1024), (16 * b, 128), (8 * b, 128))})
#: the reference's rmsnorm test shapes (tests/test_kernels.py), then widths
#: that take the kernel's scalar path: d = 1020 is a whole number of fp32
#: 16-byte vectors but not of bf16 ones, d = 65 of neither
TEST_SHAPES = [(32, 128), (100, 64), (256, 256), (2, 17, 64), (5, 1020),
               (3, 65)]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
#: full-width parity: max |a-b| / max |b| over the logits
PARITY_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cuda_time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time per call over ``iters`` back-to-back eager calls, between
    two CUDA events: what a caller pays, host launch overhead included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int = 100) -> float:
    """Mean device time per call with the host out of the way: ``iters``
    calls captured in one CUDA graph, replayed between two events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# -- phases ------------------------------------------------------------------------

def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "unknown (nvidia-smi gave no output)"
    log(f"card: {card}")
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} capability={cap} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    if tuple(cap) != (9, 0):
        fail(f"capability {cap} is not (9, 0) (Hopper)")
    return {"kind": name, "count": torch.cuda.device_count(), "card": card}


def phase_build() -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm import kernel

    t0 = time.perf_counter()
    kernel.load_library()
    info = build.build_log("rmsnorm")
    log(f"build: rmsnorm in {time.perf_counter() - t0:.2f}s "
        f"(compiled here: {info['built']}, nvcc {info['seconds']:.2f}s) "
        f"-> {Path(info['path']).relative_to(ROOT)}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def _rmsnorm_cost(rows: int, d: int, itemsize: int) -> tuple[float, str]:
    """Least time (ms) on the card: read x once, write out once, read w
    once, against ~4 fp32 flops per element."""
    nbytes = 2 * rows * d * itemsize + d * 4
    flops = 4 * rows * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_rmsnorm() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import kernel, ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    checked = 0
    cases = [(s, False) for s in BUCKET_SHAPES + TEST_SHAPES]
    # A contiguous view one element into its storage: its pointer is not
    # 16-byte aligned, so the kernel takes its scalar path.
    cases.append(((8, 1024), True))
    for shape, offset in cases:
        for dtype in ("float32", "bfloat16"):
            n = 1
            for s in shape:
                n *= s
            flat = torch.randn(n + offset, generator=gen, device=dev).to(
                getattr(torch, dtype))
            x = flat[int(offset):].view(shape)
            if offset and x.data_ptr() % 16 == 0:
                fail("the offset view is 16-byte aligned")
            w = torch.randn(shape[-1], generator=gen, device=dev)
            ref = ops.rmsnorm(x, w, impl="torch_ref")
            for block_rows in kernel.BLOCK_ROWS:
                out = ops.rmsnorm(x, w, impl="cuda", block_rows=block_rows)
                torch.cuda.synchronize()
                if out.shape != x.shape or out.dtype != x.dtype:
                    fail(f"rmsnorm {shape} {dtype}: got {out.shape} "
                         f"{out.dtype}")
                tol = TOL[dtype]
                torch.testing.assert_close(out.float(), ref.float(),
                                           rtol=tol, atol=tol)
                err = (out.float() - ref.float()).abs().max().item()
                max_err = max(max_err, err)
                checked += 1
    log(f"rmsnorm: cuda == torch_ref at {checked} shape/dtype/block cases "
        f"(bucket shapes {BUCKET_SHAPES}, test shapes {TEST_SHAPES}, one "
        f"misaligned view), max_abs_err={max_err:.3e}")

    per_shape = []
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bound_kinds = set()
    eps = 1e-6
    for (rows, d), n in DECODE_SHAPES.items():
        x = torch.randn((rows, d), generator=gen, device=dev)
        w = torch.ones(d, device=dev)
        fns = {"ms": lambda: kernel.rmsnorm_cuda(x, w, eps=eps),
               "plain_ms": lambda: ops.ref.rmsnorm(x, w, eps),
               "library_ms": lambda: F.rms_norm(x, (d,), w, eps)}
        eager = {k: cuda_time_ms(f) for k, f in fns.items()}
        device = {k: graph_time_ms(f) for k, f in fns.items()}
        bound, kind = _rmsnorm_cost(rows, d, 4)
        bound_kinds.add(kind)
        t_kernel, t_plain, t_lib = (eager["ms"], eager["plain_ms"],
                                    eager["library_ms"])
        per_shape.append({"shape": [rows, d], "dtype": "float32",
                          "launches_per_decode_step": n, **eager,
                          "bound_ms": bound, "bound_by": kind,
                          "device_only": device})
        log(f"rmsnorm ({rows},{d}) fp32 x{n}/step, eager: kernel "
            f"{t_kernel:.5f} ms plain {t_plain:.5f} ms F.rms_norm "
            f"{t_lib:.5f} ms; in a CUDA graph: kernel {device['ms']:.5f} "
            f"ms plain {device['plain_ms']:.5f} ms F.rms_norm "
            f"{device['library_ms']:.5f} ms; bound {bound:.6f} ms ({kind})")
        totals["ms"] += n * t_kernel
        totals["plain_ms"] += n * t_plain
        totals["library_ms"] += n * t_lib
        totals["bound_ms"] += n * bound
    return {"max_abs_err": max_err, "per_shape": per_shape,
            "bound_by": "bytes" if bound_kinds == {"bytes"}
            else "operations", **totals}


def engine_args(extra: list[str]) -> argparse.Namespace:
    from repro_torch.launch.serve import add_engine_args

    ap = argparse.ArgumentParser()
    add_engine_args(ap)
    return ap.parse_args(extra)


def phase_main_path(cfg) -> dict:
    import torch

    from repro_torch import compat
    from repro_torch.kernels import registry
    from repro_torch.kernels.rmsnorm import kernel
    from repro_torch.launch.serve import build_engine, synthetic_workload
    from repro_torch.serve import OpenLoopSource

    args = engine_args(["--device", "cuda", "--batch", "8", "--max-len",
                        "256", "--prefill-chunk", "16", "--dwell", "2",
                        "--requests", "8", "--rate", "0.1"])
    t0 = time.perf_counter()
    built = build_engine(args, cfg=cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in compat.tree_leaves(built.params))
    log(f"main path: built engine for {cfg.name} ({cfg.n_layers} layers, "
        f"d={cfg.d_model}, vocab {cfg.vocab_size}) in "
        f"{time.perf_counter() - t0:.1f}s; params {n_params / 1e6:.1f}M")
    schedule = synthetic_workload(args.requests, args.rate, seed=args.seed)
    requests = [r for _, r in schedule]
    # Host-clock breakdown of the live steps: KV staging, model, harvest.
    # The wrappers only read the host clock and add no synchronize, so the
    # served run is the main path as shipped; device work a part queues is
    # paid by whichever later part waits for it (harvest's copy to the
    # host).
    spent: dict[str, float] = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
            return out
        return wrapper

    executor = built.engine.executor
    built.kv.materialize = timed("materialize", built.kv.materialize)
    built.kv.harvest = timed("harvest", built.kv.harvest)
    executor.handler = timed("model", executor.handler)
    executor.prefill.execute = timed("prefill steps",
                                     executor.prefill.execute)
    executor.decode.execute = timed("decode steps", executor.decode.execute)
    # Launches made by shadow re-execution (idle ticks), apart from live.
    shadow_launches = [0]
    shadow_step = built.shadow.step

    def counted_shadow_step(*a, **k):
        before = kernel.launches
        out = shadow_step(*a, **k)
        shadow_launches[0] += kernel.launches - before
        return out

    built.shadow.step = counted_shadow_step

    kernel.reset_launches()
    registry.default_registry.fallback_counts.clear()
    t0 = time.perf_counter()
    built.engine.run(source=OpenLoopSource(built.engine.queue, schedule),
                     max_steps=2000, duration_s=600.0)
    drained = built.engine.drain(timeout_s=300.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    fallbacks = {f"{k[0]}/{k[1]}": v for k, v in
                 registry.default_registry.fallback_counts.items()}

    stats = built.engine.stats()
    served = stats["serve"]
    configs = {str(k): ({kk: repr(vv) for kk, vv in c.items()
                         if kk in ("cache_dtype", "rmsnorm_impl")}
                        if c is not None else None)
               for k, c in built.controller.best_configs().items()}
    log(f"main path: served {served['completed']}/{len(requests)} requests, "
        f"{served['completed_tokens']} tokens in {wall:.1f}s "
        f"({served['completed_tokens'] / wall:.2f} tok/s), "
        f"steps {stats['phase_steps']}, idle ticks {stats['idle_ticks']}")
    log(f"main path: latency p50/p95 ms {served['latency_p50_ms']} / "
        f"{served['latency_p95_ms']}")
    steps = stats["phase_steps"]
    n_steps = sum(steps.values())
    per = {"prefill steps": steps.get("prefill", 0),
           "decode steps": steps.get("decode", 0)}
    log("main path: host time over the live steps: " + ", ".join(
        f"{k} {v:.2f}s ({1e3 * v / max(per.get(k, n_steps), 1):.1f} "
        f"ms/{'step' if k in per else 'call'})"
        for k, v in spent.items()) + f"; wall {wall:.2f}s")
    log(f"main path: per-context configs {json.dumps(configs)}")
    generic = f"{registry.resolve('rmsnorm', None).name} (generic)"
    active = {str(k): built.handler.active_config(context=k).get(
        "rmsnorm_impl", generic)
        for k in built.handler.contexts() if k != "default"}
    log(f"main path: active rmsnorm_impl {json.dumps(active)}")
    safety = built.controller.safety_status()
    log(f"main path: safety promotions={safety['promotions']} "
        f"rollbacks={safety['rollbacks']} "
        f"shadow_rejections={safety['shadow_rejections']} "
        f"canary_rejections={safety['canary_rejections']}; "
        f"shadow {json.dumps(stats.get('shadow'))}")
    log(f"main path: rmsnorm cuda launches={launches} (live "
        f"{launches - shadow_launches[0]}, shadow {shadow_launches[0]}) "
        f"fallbacks={json.dumps(fallbacks)}")
    built.engine.shutdown()

    if not drained or served["completed"] != len(requests):
        fail(f"served {served['completed']} of {len(requests)} requests")
    for r in requests:
        if r.payload is None or len(r.payload) != r.max_new_tokens:
            fail(f"request {r.rid} got {r.payload!r}, wanted "
                 f"{r.max_new_tokens} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.payload):
            fail(f"request {r.rid} produced out-of-vocab tokens")
    if launches == 0:
        fail("the serve path launched the rmsnorm kernel no time")
    if any(k.startswith("rmsnorm/") for k in fallbacks):
        fail(f"rmsnorm fell back on the serve path: {fallbacks}")
    return {"launches": launches, "built": built, "spent": spent,
            "wall": wall, "steps": stats["phase_steps"]}


def phase_parity(cfg, params) -> dict:
    import torch

    from repro_torch.core import IridescentRuntime
    from repro_torch.models import transformer as model
    from repro_torch.training import make_serve_builder, phase_context_fn

    dev = torch.device("cuda")
    b, chunk, max_len, steps = 8, 16, 256, 8
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (b, chunk), generator=gen,
                           device=dev, dtype=torch.int32)
    follow = torch.randint(0, cfg.vocab_size, (steps, b), generator=gen,
                           device=dev, dtype=torch.int32)
    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    opts = model.RunOptions(decode_cache_dtype="float32")

    def run(impl: str, profile: bool = False) -> list:
        rt = IridescentRuntime(max_compile_workers=1)
        handler = rt.register("serve_step", make_serve_builder(cfg),
                              context_fn=phase_context_fn)
        pinned = {"cache_dtype": "float32", "rmsnorm_impl": impl}
        for key in (("prefill", b), ("decode", b)):
            handler.specialize(pinned, wait=True, context=key)
            if handler.active_config(context=key)["rmsnorm_impl"] != impl:
                fail(f"could not pin {key} to {impl}")
        cache = model.init_cache(cfg, b, max_len, opts, device=dev)
        outs = []
        lg, cache = handler(params, cache, prompt, zeros,
                            torch.full_like(zeros, chunk))
        outs.append(lg)
        torch.cuda.synchronize()
        prof = None
        if profile:
            from torch.profiler import ProfilerActivity
            prof = torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        for t in range(steps):
            lg, cache = handler(params, cache, follow[t],
                                torch.full_like(zeros, chunk + t),
                                torch.ones_like(zeros))
            outs.append(lg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            _report_profile(prof, wall, steps)
        rt.shutdown()
        return outs

    plain = run("torch_ref")
    cuda = run("cuda", profile=True)
    worst = 0.0
    for i, (a, c) in enumerate(zip(plain, cuda)):
        if a.shape != (b, cfg.vocab_size) or not torch.isfinite(c).all():
            fail(f"parity call {i}: shape {tuple(c.shape)} or non-finite")
        rel = ((c - a).abs().max() / a.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, rel)
    agree = sum(int((p.argmax(-1) == c.argmax(-1)).sum())
                for p, c in zip(plain, cuda))
    log(f"parity: {len(plain)} calls (1 prefill chunk of {chunk} + {steps} "
        f"decode steps, batch {b}), max relative logits diff {worst:.3e} "
        f"(tol {PARITY_TOL:g}); argmax agrees on {agree}/{len(plain) * b}")
    if worst > PARITY_TOL:
        fail(f"full-width parity: relative diff {worst:.3e} > {PARITY_TOL}")
    return {"max_rel": worst}


def _report_profile(prof, wall: float, steps: int) -> None:
    """Device busy share of the decode steps and the top kernels."""
    import torch

    # Device-side events only (kernels, copies): the CPU ops that launch
    # them carry the same device time again.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    log(f"profile: {steps} full-width decode steps (batch 8, handler only, "
        f"profiler on): wall {1e3 * wall / steps:.2f} ms/step, device busy "
        f"{busy_us / 1e3 / steps:.2f} ms/step "
        f"({100 * busy_us / 1e6 / wall:.1f}% of wall), "
        f"{sum(e.count for e in events) / steps:.0f} device ops/step")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
            f"x{e.count // steps:<4d} {e.key[:90]}")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not importable", 2)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA device", 2)
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository", 3)
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch import compat, configs

    t_start = time.perf_counter()
    compat.resolve_device("cuda")
    device = phase_device()
    phase_build()
    rms = phase_rmsnorm()
    cfg = configs.get_config("qwen3-0.6b").replace(compute_dtype="float32")
    main_path = phase_main_path(cfg)
    params = main_path.pop("built").params
    phase_parity(cfg, params)
    log(f"total {time.perf_counter() - t_start:.1f}s")

    kernels = [{
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:29",
        "launches": main_path["launches"],
        "max_abs_err": rms["max_abs_err"],
        "ms": rms["ms"],
        "plain_ms": rms["plain_ms"],
        "bound_ms": rms["bound_ms"],
        "bound_by": rms["bound_by"],
        "library_ms": rms["library_ms"],
        "per": "one full-width decode step at batch 8 (113 launches)",
        "shapes": rms["per_shape"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}), flush=True)


if __name__ == "__main__":
    main()
