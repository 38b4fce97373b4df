#!/usr/bin/env python3
"""Timings of variants of the port's flash attention (K2) and chunked
linear attention (K4) on one Hopper GPU: what limits each body, where no
hardware counter profiler runs.

Run from the root of a checkout, on a machine with the card:

    python3 tools/kernel_variants.py

It writes variants of the two CUDA sources into the git-ignored
``build/variants``, compiles each with the port's own ``nvcc`` flags (all
at once) and times them between CUDA events (K2) or by the profiler's
device time per launch (K4), with the card's name and power limit:

* K2: the depth to which each of its two products' loops is unrolled
  (the source's is 4 for q.k and 2 for p.v), at the qwen3-0.6b prefill
  shape (16 q / 8 kv heads, S = 4096, d = 128, causal, fp32), tiles
  (64, 64) and (128, 64).  Equal times say the instruction schedule is not
  what limits it.
* K4: the output launch with one phase cut out at a time (its loop run
  zero times: the cumsum and factors, the scores, the inter product, the
  intra product) and with all four cut (its copies alone), at the rwkv6
  prefill shape (32 heads, T = 4096, 64 x 64, exclusive with the bonus,
  fp32), chunks 64 and 32.  A cut variant computes a wrong result; only
  its time is read.

Prints one line per measurement and a last JSON line of all of them.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"

#: K2's product loops as the source writes them, and the unroll depths tried
K2_QK_LOOP = "#pragma unroll 4\n      for (int e4 = 0; e4 < 16; ++e4) {"
K2_PV_LOOP = "#pragma unroll 2\n  for (int c4 = 0; c4 < BKV / 4; ++c4) {"
K2_UNROLLS = [(4, 2), (2, 2), (4, 4), (8, 2), (8, 4), (16, 4)]
#: K4's output-launch phases as the source writes them, and their cut form
K4_PHASES = {
    "scan": ("float run = sc.prefix(w_s, ks);\n#pragma unroll 4\n"
             "      for (int r = sc.first; r < sc.last; ++r) {\n        const"
             " int o",
             "float run = 0.0f;\n#pragma unroll 4\n"
             "      for (int r = sc.first; r < sc.first; ++r) {\n        const"
             " int o"),
    "scores": ("for (int e = 0; e < cw4; e += 4) {\n      float4 qv[R], kv[R];",
               "for (int e = 0; e < 0; e += 4) {\n      float4 qv[R], kv[R];"),
    "inter": ("for (int e = 0; e < cw4; e += 4) {\n        float4 qv[R];",
              "for (int e = 0; e < 0; e += 4) {\n        float4 qv[R];"),
    "intra": ("for (int c = 0; c < c_end; c += 4) {",
              "for (int c = 0; c < 0; c += 4) {"),
}
K4_VARIANTS = {"whole": (), "no_scan": ("scan",), "no_scores": ("scores",),
               "no_inter": ("inter",), "no_intra": ("intra",),
               "copies_only": tuple(K4_PHASES)}


def _variant(source: Path, name: str, edits) -> str:
    text = source.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{source.name}: {old!r} is not in the source "
                             f"once; update this script to it")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(text)
    return str(cu)


def _build(nvcc: str, flags, cu: str) -> str:
    lib = cu[:-3] + ".so"
    proc = subprocess.run([nvcc, *flags, "-o", lib, cu], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {cu}:\n{proc.stderr}")
    return lib


def _bound(lib: str, entry):
    """``entry``'s function in the variant library ``lib``, with the C
    signature the port's own binding declares for it."""
    fn = getattr(ctypes.CDLL(lib), entry.__name__)
    fn.argtypes, fn.restype = entry.argtypes, entry.restype
    return fn


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import compat
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import kernel as k2
    from repro_torch.kernels.linear_attention import kernel as k4

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    sources = {f"k2_qk{a}_pv{b}": _variant(
        k2.SOURCE, f"k2_qk{a}_pv{b}",
        [(K2_QK_LOOP, K2_QK_LOOP.replace("unroll 4", f"unroll {a}")),
         (K2_PV_LOOP, K2_PV_LOOP.replace("unroll 2", f"unroll {b}"))])
        for a, b in K2_UNROLLS}
    sources.update({f"k4_{name}": _variant(
        k4.SOURCE, f"k4_{name}", [K4_PHASES[p] for p in cut])
        for name, cut in K4_VARIANTS.items()})
    nvcc = compat.nvcc_path()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(
            lambda cu: _build(nvcc, build.NVCC_FLAGS, cu),
            sources.values())))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    results = {"card": card, "k2_ms": {}, "k4_output_us": {}}

    # K2: ms a launch, between CUDA events, two rounds.
    h, hk, s, d = 16, 8, 4096, 128
    q = torch.randn(h, s, d, generator=gen, device=dev)
    k, v = (torch.randn(hk, s, d, generator=gen, device=dev)
            for _ in range(2))
    out = torch.empty_like(q)
    for name in (n for n in libs if n.startswith("k2_")):
        fn = _bound(libs[name], k2.load_library().flash_attention_fwd)
        for bq, bkv in ((64, 64), (128, 64)):
            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), h, s, s, d, d, h // hk, d ** -0.5,
                         1, 0, 0, 0, 0, 0, 0, bq, bkv, stream)
                if err:
                    raise SystemExit(f"{name}: launch error {err}")
            times = []
            for _ in range(2):
                for _ in range(3):
                    call()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    call()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 20)
            results["k2_ms"][f"{name} {bq}x{bkv}"] = times
            print(f"K2 {name} {bq}x{bkv}: " + " / ".join(
                f"{t:.4f}" for t in times) + " ms", flush=True)
    del q, k, v, out

    # K4: device us of the output launch, by the profiler, two rounds.
    from torch.profiler import ProfilerActivity, profile
    bh, t, dk = 32, 4096, 64
    q, k, v = (torch.randn(bh, t, dk, generator=gen, device=dev)
               for _ in range(3))
    lw = -torch.rand(bh, t, dk, generator=gen, device=dev).clamp(1e-4, 1.0)
    u = torch.randn(bh, dk, generator=gen, device=dev)
    out = torch.empty_like(v)
    for chunk in (64, 32):
        work = torch.empty(k4.workspace_floats(bh, t, dk, dk, chunk),
                           device=dev)
        for name in (n for n in libs if n.startswith("k4_")):
            fn = _bound(libs[name], k4.load_library().linear_attention_fwd)

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         lw.data_ptr(), u.data_ptr(), out.data_ptr(),
                         work.data_ptr(), bh, t, dk, dk, chunk, 0, 0, 0,
                         stream)
                if err:
                    raise SystemExit(f"{name}: launch error {err}")
            times = []
            for _ in range(2):
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        call()
                    torch.cuda.synchronize()
                times.append(sum(
                    e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "output_kernel" in e.key) / 20)
            results["k4_output_us"][f"{name} chunk {chunk}"] = times
            print(f"K4 output launch, {name}, chunk {chunk}: " + " / ".join(
                f"{t:.1f}" for t in times) + " us", flush=True)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
