#!/usr/bin/env python3
"""What each ``remat`` policy of the port's train step costs on one Hopper
GPU: qwen3-0.6b at full width and depth, fp32 with TF32 off, batches of
``SyntheticLM`` on the card.

Run from the root of a checkout, on a machine with the card:

    python3 tools/remat_profile.py

The policies are measured in turns (none, dots, full, full, dots, none),
so a drift of the host's speed falls on each alike.  For each policy:

* ``step_ms``: the (8, 512) step between CUDA events, the median of
  STEPS steps a turn after one warm-up step, and its peak memory;
* ``host_ms``: the same step at a (1, 8) batch, whose forward and
  backward give the device almost nothing to do: what the host spends
  dispatching the step (the optimizer's update over the 596 M parameters
  is the same under every policy);
* one profiled (8, 512) step: the device's busy ms (its kernels' time),
  the kernels launched and the ATen ops the host dispatched; then, for
  ``dots`` against ``full`` and ``none``, the kernels whose device ms
  differ the most (by kernel name: time and launches);
* under ``dots``, the calls of its selective-checkpoint policy in one
  step and their host time (the policy alone, not the dispatch mode that
  calls it).

Prints one line per measurement, the card's name and power limit, and a
last JSON line of all of them.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import compat, configs  # noqa: E402
from repro_torch.core.specializer import specialize_builder  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels.attention.ops import PROFILE_RANGE  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402
from repro_torch.training import make_train_builder  # noqa: E402

POLICIES = ("none", "dots", "full")
BATCH = (8, 512)
HOST_BATCH = (1, 8)
STEPS = 3
#: kernels listed where dots' device time differs from another policy's
TOP = 12
OPT = OptConfig(lr=1e-3, warmup_steps=5, total_steps=200)


def timed(step, state, batches) -> tuple[dict, list[float], float]:
    """Run ``step`` over ``batches`` (the first a warm-up): the state, the
    event-timed ms of the rest, and the peak GB over them."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        start.record()
        state, metrics = step(state, batch)
        end.record()
        float(metrics["loss"])                  # the loop's own sync
        end.synchronize()
        if i:
            ms.append(start.elapsed_time(end))
    return state, ms, torch.cuda.max_memory_allocated() / 1e9


def profiled(step, state, batch) -> tuple[dict, dict]:
    """One step under the profiler: the device's busy ms, kernels, host
    ATen ops and the event-timed ms."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):                  # the profiler can drop a window
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            state, metrics = step(state, batch)
            end.record()
            float(metrics["loss"])
            torch.cuda.synchronize()
        # the attention's profiler range also shows on the device's
        # timeline (an annotation spanning its kernels): not device work
        device = [e for e in prof.key_averages() if e.device_type == cuda
                  and e.key != PROFILE_RANGE]
        if device:
            busy = sum(e.self_device_time_total for e in device) / 1e3
            ms = start.elapsed_time(end)
            aten = sum(1 for e in prof.events() if e.device_type != cuda
                       and e.name.startswith("aten::"))
            by_kernel = {e.key: (e.self_device_time_total / 1e3, e.count)
                         for e in device}
            return state, {"ms": ms, "busy_ms": busy, "busy_share": busy / ms,
                           "kernels": sum(e.count for e in device),
                           "aten_ops": aten, "by_kernel": by_kernel}
    raise RuntimeError("the profiler saw no device activity in 3 steps")


def policy_calls(step, state, batch) -> tuple[dict, dict]:
    """One ``dots`` step with its checkpoint policy counted and timed."""
    real = model._save_dots
    seen = {"calls": 0, "seconds": 0.0}

    def counted(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        seen["seconds"] += time.perf_counter() - t0
        seen["calls"] += 1
        return out

    model._save_dots = counted
    try:
        state, metrics = step(state, batch)
        float(metrics["loss"])
    finally:
        model._save_dots = real
    return state, {"calls": seen["calls"], "ms": 1e3 * seen["seconds"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = compat.resolve_device("cuda")          # fp32 products: TF32 off
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = smi.strip().splitlines()[0] if smi.strip() else "unknown"
    print(f"card: {card}", flush=True)
    cfg = configs.get_config("qwen3-0.6b").replace(compute_dtype="float32")
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    state = {"params": params, "opt": init_opt_state(params, OPT)}
    del params
    data = {shape: iter(SyntheticLM(cfg.vocab_size, *shape, seed=1,
                                    prefetch=0, device=dev))
            for shape in (BATCH, HOST_BATCH)}
    steps = {p: specialize_builder(make_train_builder(cfg, OPT),
                                   {"remat": p}).fn for p in POLICIES}
    step_ms = {p: [] for p in POLICIES}
    host_ms = {p: [] for p in POLICIES}
    peak = {p: 0.0 for p in POLICIES}
    for p in POLICIES + POLICIES[::-1]:
        state, ms, gb = timed(steps[p], state, [next(data[BATCH])
                                                for _ in range(STEPS + 1)])
        step_ms[p] += ms
        peak[p] = max(peak[p], gb)
        state, ms, _ = timed(steps[p], state, [next(data[HOST_BATCH])
                                               for _ in range(STEPS + 1)])
        host_ms[p] += ms
        print(f"turn {p}: {BATCH} step {[round(x, 1) for x in step_ms[p]]} "
              f"ms, {HOST_BATCH} step {[round(x, 1) for x in host_ms[p]]} ms",
              flush=True)
    out = {"card": card, "batch": BATCH, "host_batch": HOST_BATCH,
           "policies": {}}
    for p in POLICIES:
        state, prof = profiled(steps[p], state, next(data[BATCH]))
        row = {"step_ms": statistics.median(step_ms[p]),
               "step_ms_all": step_ms[p], "peak_gb": peak[p],
               "host_ms": statistics.median(host_ms[p]),
               "host_ms_all": host_ms[p], "profile": prof}
        if p == "dots":
            state, row["policy"] = policy_calls(steps[p], state,
                                                next(data[BATCH]))
        out["policies"][p] = row
        print(f"{p}: step {row['step_ms']:.1f} ms (events, median of "
              f"{len(step_ms[p])}), peak {peak[p]:.2f} GB, {HOST_BATCH} "
              f"step {row['host_ms']:.1f} ms; profiled step {prof['ms']:.1f} "
              f"ms, device busy {prof['busy_ms']:.1f} ms "
              f"({100 * prof['busy_share']:.1f}%), {prof['kernels']} "
              f"kernels, {prof['aten_ops']} ATen ops"
              + (f"; checkpoint policy {row['policy']['calls']} calls, "
                 f"{row['policy']['ms']:.1f} ms" if p == "dots" else ""),
              flush=True)
    prof = {p: out["policies"][p]["profile"].pop("by_kernel")
            for p in POLICIES}
    out["dots_against"] = {}
    for other in ("full", "none"):
        names = set(prof["dots"]) | set(prof[other])
        diff = sorted(
            ((prof["dots"].get(k, (0.0, 0))[0] - prof[other].get(k, (0.0, 0))[0],
              k) for k in names), key=lambda t: -abs(t[0]))[:TOP]
        rows = [{"kernel": k[:120], "delta_ms": d,
                 "dots": prof["dots"].get(k, (0.0, 0)),
                 other: prof[other].get(k, (0.0, 0))} for d, k in diff]
        out["dots_against"][other] = rows
        for r in rows:
            print(f"dots - {other}: {r['delta_ms']:+8.1f} ms  dots "
                  f"{r['dots'][0]:7.1f} ms x{r['dots'][1]:<5} {other} "
                  f"{r[other][0]:7.1f} ms x{r[other][1]:<5} {r['kernel']}",
                  flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
