#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU (H100).

Run from the root of a checkout, on a machine with the card:

    python3 chip_smoke.py

It imports the port (``src/repro_torch``) and nothing of JAX or of the
JAX package, and runs its phases in order; any failure exits non-zero.

1. Device: prints the card's name and power limit (``nvidia-smi``) and
   checks compute capability (9, 0).
2. Build: compiles every kernel of the serve and prefill paths from the
   sources in the checkout, one ``nvcc`` per source, all started together
   (into the git-ignored ``build/kernels``).
3. RMSNorm vs plain: the kernel against its plain PyTorch version on the
   card, at every shape the served batch buckets and a (1, 4096) prefill
   give it, the reference's test shapes, widths and a misaligned view that
   take its scalar path, in fp32 (tolerance 1e-5) and bf16 (3e-2); times
   the kernel, the plain version and ``F.rms_norm`` with CUDA events, over
   a ring of inputs larger than the L2 cache where the shape allows.
4. Attention vs plain: the flash attention kernel against its plain
   version at every tile pair, at the reference's test cases and the
   full-width prefill shapes (16 query / 8 kv heads, head dim 128, S =
   512, 1000, 2048, 4096), in fp32 (2e-4) and bf16 (3e-2), each also held
   to a limit scaled to every element's size; at the long call's lengths
   (S = 8192, 16384) the kernel runs whole and slices of its rows are held
   to the plain version; times the kernel, the plain version and
   ``scaled_dot_product_attention``.
5. Serve path: ``repro_torch.launch.serve.build_engine`` serves qwen3-0.6b
   at full width (28 layers, d=1024, vocab 151936; random weights from
   seed 0) in fp32, through the default safety controller that explores
   ``cache_dtype`` x ``rmsnorm_impl``.
6. Serve parity at full width: the serve handler pinned to the plain
   RMSNorm and then to the CUDA kernel, on the same inputs (one 16-token
   prefill chunk and 8 teacher-forced decode steps), must agree within a
   max relative logits difference of 1e-3.
7. Prefill path: the prefill handler (``make_prefill_builder``, the
   full-sequence forward) on the same weights, under a ``Controller``
   whose ``CoordinateDescent`` sweeps ``attention_impl`` x ``block_q`` x
   ``block_kv`` over (1, 4096) prefills until it settles, then one
   (1, 16384) prefill with the chosen config; one (1, 4096) call under
   ``torch.profiler``.
8. Prefill parity at full width: (a) the prefill handler pinned to the
   plain attention and then to the kernel on the same (2, 2048) tokens,
   (b) the forward's last-token logits at (8, 16) against the serve
   path's prefill-chunk logits of phase 6; both within 1e-3.

In phases 5 and 7 (the main paths) the launch counters and the registry's
fallback counts are zeroed just before and read just after; every kernel
of the path must have launched and none may have fallen back.  The line
before the last is a JSON object ``{"kernels": [...]}`` with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
#: outside the tensor cores, dense bf16 FLOP/s on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

#: (rows, d) per rmsnorm launch on one full-width decode step at batch 8,
#: with launches per step: norm1+norm2 per layer + final, q-norm
#: (16 heads x 8 rows), k-norm (8 kv heads x 8 rows)
DECODE_SHAPES = {(8, 1024): 2 * 28 + 1, (128, 128): 28, (64, 128): 28}
#: every (rows, d) the served batch buckets B = 1, 2, 4, 8 give the kernel
#: (prefill runs as a scan of decode steps, so it gives the same shapes)
BUCKET_SHAPES = sorted({s for b in (1, 2, 4, 8)
                        for s in ((b, 1024), (16 * b, 128), (8 * b, 128))})
#: (rows, d) per rmsnorm launch on one full-width (1, 4096) prefill, with
#: launches per call: norm1/norm2/final, q-norm (16 heads), k-norm (8)
PREFILL_SHAPES = {(4096, 1024): 2 * 28 + 1, (65536, 128): 28,
                  (32768, 128): 28}
#: the reference's rmsnorm test shapes (tests/test_kernels.py), then widths
#: that take the kernel's scalar path: d = 1020 is a whole number of fp32
#: 16-byte vectors but not of bf16 ones, d = 65 of neither
TEST_SHAPES = [(32, 128), (100, 64), (256, 256), (2, 17, 64), (5, 1020),
               (3, 65)]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
#: attention tolerances, the reference's (tests/test_kernels.py)
ATTN_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
#: a second limit scaled to each element, |out - ref| <= atol + rtol |ref|
#: as (rtol, atol): the kernel and the plain version both compute in fp32
#: and round once to the output's dtype, so in bf16 they differ by at most
#: one bf16 ulp (2^-7 of the value) and in fp32 by the summation order
ATTN_SCALED_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-5)}
#: attention cases (q, k, v shapes, causal, window): the reference's test
#: cases (tests/test_kernels.py:60-108), then full-width prefill shapes
ATTN_TEST_CASES = [
    *[((2, h, 64, 32), (2, hk, 64, 32), (2, hk, 64, 32), causal, window)
      for h, hk in [(4, 4), (4, 2), (8, 1)]
      for causal, window in [(True, None), (True, 16), (False, None)]],
    ((2, 2, 32, 24), (2, 2, 32, 24), (2, 2, 32, 16), True, None),
    ((1, 2, 16, 16), (1, 2, 64, 16), (1, 2, 64, 16), True, None),
    ((1, 2, 32, 16), (1, 2, 32, 16), (1, 2, 32, 16), True, None),
]
#: full-width qwen3-0.6b prefill attention: (B, H, Hk, head dim) and the
#: lengths compared and timed (1000 is ragged for every tile; 4096 is the
#: prefill path's)
ATTN_WIDTH = (1, 16, 8, 128)
ATTN_LENGTHS = (512, 1000, 2048, 4096)
N_LAYERS = 28
#: the prefill path: (batch, tokens) of the Controller's sweep, the long
#: call, the parity check (a), and calls per candidate
PREFILL_SWEEP = (1, 4096)
PREFILL_LONG = 16384
#: lengths the long call may give the attention kernel (it is cut to half
#: when the sweep predicts it too slow), compared on slices of this many
#: rows at the start, the middle and the end of the sequence
ATTN_LONG_LENGTHS = (PREFILL_LONG // 2, PREFILL_LONG)
ATTN_LONG_ROWS = 512
PREFILL_PARITY = (2, 2048)
PREFILL_DWELL = 3
#: the long call is cut to 8192 tokens when the sweep predicts it past this
LONG_CALL_LIMIT_S = 60.0
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
    """Build every kernel library at once, one ``nvcc`` per source, all
    started together (the build module locks per library); a failed build
    raises here."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel

    libs = {"rmsnorm": rms_kernel.load_library,
            "flash_attention": attn_kernel.load_library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for future in [pool.submit(load) for load in libs.values()]:
            future.result()
    wall = time.perf_counter() - t0
    for name in libs:
        info = build.build_log(name)
        log(f"build: {name} (compiled here: {info['built']}, nvcc "
            f"{info['seconds']:.2f}s) -> "
            f"{Path(info['path']).relative_to(ROOT)}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build: {len(libs)} libraries in {wall:.2f}s wall")


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
    cases = [(s, False) for s in BUCKET_SHAPES + list(PREFILL_SHAPES)
             + TEST_SHAPES]
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
        f"(bucket shapes {BUCKET_SHAPES}, prefill shapes "
        f"{list(PREFILL_SHAPES)}, test shapes {TEST_SHAPES}, one misaligned "
        f"view), max_abs_err={max_err:.3e}")

    per_shape = []
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bound_kinds = set()
    eps = 1e-6
    l2_bytes = torch.cuda.get_device_properties(dev).L2_cache_size
    shapes = ([(s, n, "decode step") for s, n in DECODE_SHAPES.items()]
              + [(s, n, "(1, 4096) prefill")
                 for s, n in PREFILL_SHAPES.items()])
    for (rows, d), n, per in shapes:
        # Successive calls read successive inputs of a ring three times the
        # L2 cache, so an input is evicted before it is read again and a
        # timing reads from HBM; a decode shape's ring (at most 64 inputs)
        # stays in L2, as its activations do on the serve path.
        x_bytes = rows * d * 4
        n_ring = min(64, -(-3 * l2_bytes // x_bytes))
        l2_resident = n_ring * x_bytes < 3 * l2_bytes
        xs = [torch.randn((rows, d), generator=gen, device=dev)
              for _ in range(n_ring)]
        w = torch.ones(d, device=dev)
        ring = itertools.cycle(xs)
        fns = {"ms": lambda: kernel.rmsnorm_cuda(next(ring), w, eps=eps),
               "plain_ms": lambda: ops.ref.rmsnorm(next(ring), w, eps),
               "library_ms": lambda: F.rms_norm(next(ring), (d,), w, eps)}
        eager = {k: cuda_time_ms(f) for k, f in fns.items()}
        device = {k: graph_time_ms(f) for k, f in fns.items()}
        bound, kind = _rmsnorm_cost(rows, d, 4)
        t_kernel, t_plain, t_lib = (eager["ms"], eager["plain_ms"],
                                    eager["library_ms"])
        per_shape.append({"shape": [rows, d], "dtype": "float32",
                          "per": per, "launches_per_call": n, **eager,
                          "bound_ms": bound, "bound_by": kind,
                          "device_only": device, "ring": n_ring,
                          "l2_resident": l2_resident})
        log(f"rmsnorm ({rows},{d}) fp32 x{n}/{per}, ring of {n_ring} "
            f"inputs ({'in L2' if l2_resident else 'from HBM'}), eager: "
            f"kernel {t_kernel:.5f} ms plain {t_plain:.5f} ms F.rms_norm "
            f"{t_lib:.5f} ms; in a CUDA graph: kernel {device['ms']:.5f} "
            f"ms plain {device['plain_ms']:.5f} ms F.rms_norm "
            f"{device['library_ms']:.5f} ms; bound {bound:.6f} ms ({kind}, "
            f"{100 * bound / device['ms']:.1f}% of the kernel in a graph)")
        if per == "decode step":
            bound_kinds.add(kind)
            totals["ms"] += n * t_kernel
            totals["plain_ms"] += n * t_plain
            totals["library_ms"] += n * t_lib
            totals["bound_ms"] += n * bound
    return {"max_abs_err": max_err, "per_shape": per_shape,
            "bound_by": "bytes" if bound_kinds == {"bytes"}
            else "operations", **totals}


def _attention_pairs(sq: int, skv: int, causal: bool, window,
                     q_offset: int) -> int:
    """(row, column) pairs the masks leave: the work this input needs."""
    import numpy as np

    pos = q_offset + np.arange(sq)
    hi = np.minimum(pos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(sq)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _attention_cost(b: int, h: int, hk: int, sq: int, skv: int, d: int,
                    dv: int, itemsize: int, causal: bool = True,
                    window=None) -> tuple[float, str]:
    """Least time (ms) on the card: q, k, v read once and out written
    once, against 2 (d + dv) flops per valid (row, column) pair per head
    (QK^T and PV) at the fp32 FMA peak for fp32 inputs (the reference
    computes in fp32: TF32 stays off), the dense bf16 tensor-core peak
    for bf16 ones."""
    nbytes = itemsize * (b * h * sq * d + b * hk * skv * (d + dv)
                         + b * h * sq * dv)
    flops = 2 * (d + dv) * b * h * _attention_pairs(sq, skv, causal, window,
                                                    skv - sq)
    peak = PEAK_FP32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_attention() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention import kernel, ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tiles = [(bq, bkv) for bq in kernel.BLOCK_Q for bkv in kernel.BLOCK_KV]
    b, h, hk, dh = ATTN_WIDTH
    cases = ATTN_TEST_CASES + [((b, h, s, dh), (b, hk, s, dh),
                                (b, hk, s, dh), True, None)
                               for s in ATTN_LENGTHS]
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    checked = 0

    def check(out, ref, what: str) -> None:
        """Hold ``out`` to ``ref`` at the reference's tolerance and at the
        scaled one; fold its largest difference into ``max_err``."""
        nonlocal checked
        dtype = str(ref.dtype).removeprefix("torch.")
        if out.shape != ref.shape or out.dtype != ref.dtype:
            fail(f"attention {what}: got {tuple(out.shape)} {out.dtype}, "
                 f"wanted {tuple(ref.shape)} {ref.dtype}")
        tol = ATTN_TOL[dtype]
        rtol, atol = ATTN_SCALED_TOL[dtype]
        for rt, at in ((tol, tol), (rtol, atol)):
            torch.testing.assert_close(
                out.float(), ref.float(), rtol=rt, atol=at,
                msg=lambda m: f"attention {what} (rtol {rt}, atol {at}): {m}")
        err = (out.float() - ref.float()).abs().max().item()
        max_err[dtype] = max(max_err[dtype], err)
        checked += 1

    for q_s, k_s, v_s, causal, window in cases:
        for dtype in ("float32", "bfloat16"):
            q, k, v = (torch.randn(s, generator=gen, device=dev).to(
                getattr(torch, dtype)) for s in (q_s, k_s, v_s))
            ref = ops.attention(q, k, v, causal=causal, window=window,
                                impl="torch_ref")
            for bq, bkv in tiles:
                out = ops.attention(q, k, v, causal=causal, window=window,
                                    impl="cuda", block_q=bq, block_kv=bkv)
                torch.cuda.synchronize()
                check(out, ref, f"{q_s} {dtype} causal={causal} "
                      f"window={window} tiles {bq}x{bkv}")
            del ref, out
    n_short = checked
    # The long call's lengths: the kernel runs on the whole sequence, and
    # slices of its rows are held to the plain version of those rows over
    # every column (the whole S^2 plain version would not fit the card).
    r = ATTN_LONG_ROWS
    for s in ATTN_LONG_LENGTHS:
        q = torch.randn((b, h, s, dh), generator=gen, device=dev)
        k, v = (torch.randn((b, hk, s, dh), generator=gen, device=dev)
                for _ in range(2))
        starts = (0, s // 2, s - r)
        refs = [ops.attention(q[:, :, a:a + r], k, v, q_offset=a,
                              impl="torch_ref") for a in starts]
        for bq, bkv in tiles:
            out = ops.attention(q, k, v, impl="cuda", block_q=bq,
                                block_kv=bkv)
            torch.cuda.synchronize()
            if out.shape != (b, h, s, dh) or not torch.isfinite(out).all():
                fail(f"attention at {s}: {tuple(out.shape)} or non-finite")
            for a, ref in zip(starts, refs):
                check(out[:, :, a:a + r], ref, f"(1,16/8,{s},128) float32 "
                      f"rows {a}:{a + r} tiles {bq}x{bkv}")
            del out
        del q, k, v, refs
    torch.cuda.empty_cache()
    log(f"attention: cuda == torch_ref at {n_short} case/dtype/tile cases "
        f"({len(ATTN_TEST_CASES)} reference test cases and full-width "
        f"prefill lengths {ATTN_LENGTHS}, tiles {tiles}) and "
        f"{checked - n_short} row slices ({r} rows at the start, middle and "
        f"end of S = {ATTN_LONG_LENGTHS}, fp32), within the reference's "
        f"tolerances {ATTN_TOL} and the scaled ones (rtol, atol) "
        f"{ATTN_SCALED_TOL}; max_abs_err fp32 {max_err['float32']:.3e}, "
        f"bf16 {max_err['bfloat16']:.3e}")

    per_shape = []
    for s, dtype in [(s, "float32")
                     for s in ATTN_LENGTHS + ATTN_LONG_LENGTHS] + [
            (2048, "bfloat16")]:
        tdt = getattr(torch, dtype)
        q = torch.randn((b * h, s, dh), generator=gen, device=dev).to(tdt)
        k, v = (torch.randn((b * hk, s, dh), generator=gen,
                            device=dev).to(tdt) for _ in range(2))
        q4, k4, v4 = (x.view(b, -1, s, dh) for x in (q, k, v))
        # ~0.3 s of calls per timing at the largest shape
        iters = max(10, min(200, int(200 * (512 / s) ** 2)))
        warm = max(2, iters // 10)
        timed = {f"{bq}x{bkv}": cuda_time_ms(
            lambda bq=bq, bkv=bkv: kernel.flash_attention_cuda(
                q, k, v, block_q=bq, block_kv=bkv), iters, warm)
            for bq, bkv in tiles}
        # The plain version holds a few (B, H, S, S) fp32 score tensors.
        plain_bytes = 4 * b * h * s * s * 4
        if plain_bytes < torch.cuda.mem_get_info()[0] / 2:
            plain = cuda_time_ms(lambda: ops.ref.attention(q4, k4, v4),
                                 iters, warm)
        else:
            log(f"attention: plain not timed at {s}: it would hold ~"
                f"{plain_bytes / 1e9:.0f} GB of scores")
            plain = None
        try:
            library = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, enable_gqa=True), iters, warm)
        except RuntimeError as e:            # timed only, used nowhere
            log(f"attention: sdpa not timed at {s} {dtype}: {e}")
            library = None
            torch.cuda.empty_cache()
        bound, kind = _attention_cost(b, h, hk, s, s, dh, dh,
                                      q.element_size())
        best = min(timed, key=timed.get)
        per_shape.append({"shape": [b, h, hk, s, dh], "dtype": dtype,
                          "kernel_ms_by_tiles": timed, "plain_ms": plain,
                          "library_ms": library, "bound_ms": bound,
                          "bound_by": kind})
        log(f"attention (1,16/8,{s},128) {dtype} causal: kernel "
            + " ".join(f"{t} {ms:.4f}" for t, ms in timed.items())
            + f" ms (best {best}: {100 * bound / timed[best]:.1f}% of the "
            f"bound); plain {plain} ms; sdpa {library} ms; bound "
            f"{bound:.4f} ms ({kind})")
        del q, k, v, q4, k4, v4
    torch.cuda.empty_cache()
    return {"max_abs_err": max(max_err.values()),
            "max_abs_err_by_dtype": max_err, "checked": checked,
            "per_shape": per_shape}


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
    return {"max_rel": worst, "prompt": prompt, "prefill_logits": cuda[0]}


def _report_profile(prof, wall: float, steps: int,
                    what: str = "full-width decode steps (batch 8, handler "
                                "only, profiler on)",
                    unit: str = "step") -> dict:
    """Device busy share of ``steps`` profiled calls and the top kernels."""
    import torch

    # Device-side events only (kernels, copies): the CPU ops that launch
    # them carry the same device time again.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        log("profile: the profiler recorded no device time (not measured)")
        return {}
    log(f"profile: {steps} {what}: wall {1e3 * wall / steps:.2f} ms/{unit}, "
        f"device busy {busy_us / 1e3 / steps:.2f} ms/{unit} "
        f"({100 * busy_us / 1e6 / wall:.1f}% of wall), "
        f"{sum(e.count for e in events) / steps:.0f} device ops/{unit}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/{unit} "
            f"x{e.count // steps:<4d} {e.key[:90]}")
    return {"busy_ms": busy_us / 1e3 / steps, "wall_ms": 1e3 * wall / steps}


def _setting(config: dict, label: str, default=None):
    """A config's value for ``label``; ``default`` where the config leaves
    the point out or disables it (the builder's default then applies)."""
    from repro_torch.core.points import DISABLED

    value = config.get(label, DISABLED)
    return default if value is DISABLED else value


def _config_str(config: dict) -> str:
    from repro_torch.core.points import DISABLED

    return json.dumps({k: v for k, v in config.items() if v is not DISABLED})


def _pin(handler, config: dict) -> None:
    handler.specialize(config, wait=True)
    active = handler.active_config()
    if any(active.get(k) != v for k, v in config.items()):
        fail(f"could not pin {handler.name} to {config}: active {active}")


def phase_prefill(cfg, params) -> dict:
    """The prefill handler under a Controller sweeping the attention
    kernel's implementation and tiles, then one long call."""
    import torch

    from repro_torch.core import (DEFAULT_CONTEXT, Controller,
                                  CoordinateDescent, IridescentRuntime)
    from repro_torch.kernels import registry
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.training import make_prefill_builder

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    b, s = PREFILL_SWEEP
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev, dtype=torch.int32)
    rt = IridescentRuntime(max_compile_workers=1)
    handler = rt.register("prefill_step", make_prefill_builder(cfg))
    space = handler.spec_space()
    labels = ["attention_impl", "block_q", "block_kv"]
    controller = Controller(
        handler, lambda: CoordinateDescent(space, labels=labels,
                                           max_passes=1),
        dwell=PREFILL_DWELL, wait_compiles=True, prefetch=0)

    def impl_of(config: dict) -> str:
        return registry.resolve(
            "attention", _setting(config, "attention_impl")).name

    calls = []          # (attention impl, attention launches, rmsnorm launches, s)
    attn_kernel.reset_launches()
    rms_kernel.reset_launches()
    registry.default_registry.fallback_counts.clear()
    t_phase = time.perf_counter()

    def call(batch_tokens) -> torch.Tensor:
        impl = impl_of(handler.active_config())
        a0, r0 = attn_kernel.launches, rms_kernel.launches
        t = time.perf_counter()
        logits = handler(params, {"tokens": batch_tokens})
        torch.cuda.synchronize()
        calls.append((impl, attn_kernel.launches - a0,
                      rms_kernel.launches - r0, time.perf_counter() - t))
        return logits

    for _ in range(100):
        logits = call(tokens)
        controller.step()
        if controller.settled():
            break
    else:
        fail("the prefill Controller did not settle in 100 calls")
    if logits.shape != (b, s, cfg.padded_vocab_size) \
            or not torch.isfinite(logits).all():
        fail(f"prefill logits {tuple(logits.shape)} or non-finite")
    del logits
    chosen = controller.best_configs()[DEFAULT_CONTEXT]
    for phase, config, rate in controller.histories()[DEFAULT_CONTEXT]:
        log(f"prefill sweep: {phase.value} {_config_str(config)} -> "
            f"{rate * b * s:.1f} tok/s ({1e3 / rate:.1f} ms/call)")
    log(f"prefill sweep: settled after {len(calls)} calls on "
        f"{_config_str(chosen)} (active "
        f"{_config_str(handler.active_config())})")
    t_sweep = 1.0 / controller.best(DEFAULT_CONTEXT)[1]

    # One long call with the chosen config; scaling the 4096-token time by
    # 16 over-predicts it (only attention grows with the square).
    long_s = PREFILL_LONG
    predicted = t_sweep * (long_s / s) ** 2
    # The plain attention holds a few (B, H, S, S) fp32 score tensors.
    plain_bytes = 4 * cfg.n_heads * long_s ** 2 * 4
    if predicted > LONG_CALL_LIMIT_S:
        long_s = PREFILL_LONG // 2
        log(f"prefill: a {PREFILL_LONG}-token call is predicted at "
            f"{predicted:.1f}s (> {LONG_CALL_LIMIT_S:.0f}s): stopping at "
            f"{long_s}")
    elif impl_of(chosen) == "torch_ref" and \
            plain_bytes > torch.cuda.mem_get_info()[0] / 2:
        long_s = PREFILL_LONG // 2
        log(f"prefill: the plain attention chosen would hold ~"
            f"{plain_bytes / 1e9:.0f} GB of scores at {PREFILL_LONG} tokens: "
            f"stopping at {long_s}")
    long_tokens = torch.randint(0, cfg.vocab_size, (1, long_s),
                                generator=gen, device=dev, dtype=torch.int32)
    logits = call(long_tokens)
    if logits.shape != (1, long_s, cfg.padded_vocab_size) \
            or not torch.isfinite(logits[0, -1]).all():
        fail(f"long prefill logits {tuple(logits.shape)} or non-finite")
    del logits
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_phase
    attn_launches, rms_launches = attn_kernel.launches, rms_kernel.launches
    fallbacks = {f"{k[0]}/{k[1]}": v for k, v in
                 registry.default_registry.fallback_counts.items()}
    log(f"prefill: ({b}, {s}) x{len(calls) - 1} then (1, {long_s}) in "
        f"{wall:.1f}s; the long call {1e3 * calls[-1][3]:.1f} ms "
        f"({long_s / calls[-1][3]:.1f} tok/s, predicted by scaling "
        f"{predicted:.1f}s)")
    log(f"prefill: attention cuda launches={attn_launches}, rmsnorm cuda "
        f"launches={rms_launches}, fallbacks={json.dumps(fallbacks)}; "
        f"calls by attention impl "
        f"{json.dumps({i: sum(c[0] == i for c in calls) for i in {c[0] for c in calls}})}")
    n_cuda = sum(c[0] == "cuda" for c in calls)
    if attn_launches == 0 or attn_launches != cfg.n_layers * n_cuda:
        fail(f"attention launched {attn_launches} times over {n_cuda} calls "
             f"pinned to cuda; wanted {cfg.n_layers} per call")
    for impl, a, _, _ in calls:
        if a != (cfg.n_layers if impl == "cuda" else 0):
            fail(f"a prefill call on {impl} launched attention {a} times")
    per_call = sum(PREFILL_SHAPES.values())
    if rms_launches != per_call * len(calls):
        fail(f"rmsnorm launched {rms_launches} times over {len(calls)} "
             f"prefill calls; wanted {per_call} per call")
    if fallbacks:
        fail(f"the prefill path fell back: {fallbacks}")

    # Where a (1, 4096) call's device time goes, with the chosen config.
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        handler(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t
    profile = _report_profile(
        prof, prof_wall, 1, what=f"full-width ({b}, {s}) prefill call "
        f"(chosen config, profiler on)", unit="call")
    rt.shutdown()
    return {"attention_launches": attn_launches,
            "rmsnorm_launches": rms_launches,
            "chosen": {"attention_impl": impl_of(chosen),
                       "block_q": _setting(chosen, "block_q",
                                           attn_kernel.DEFAULT_BLOCK_Q),
                       "block_kv": _setting(chosen, "block_kv",
                                            attn_kernel.DEFAULT_BLOCK_KV)},
            "sweep_ms": 1e3 * t_sweep, "long_tokens": long_s,
            "long_ms": 1e3 * calls[-1][3], "calls": len(calls),
            "profile": profile}


def phase_prefill_parity(cfg, params, serve: dict) -> dict:
    """(a) the prefill handler on the plain attention vs on the kernel;
    (b) the forward's last-token logits vs the serve path's."""
    import torch

    from repro_torch.core import IridescentRuntime
    from repro_torch.models import transformer as model
    from repro_torch.training import make_prefill_builder

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, PREFILL_PARITY, generator=gen,
                           device=dev, dtype=torch.int32)
    rt = IridescentRuntime(max_compile_workers=1)
    handler = rt.register("prefill_step", make_prefill_builder(cfg))
    out = {}
    for impl in ("torch_ref", "cuda"):
        _pin(handler, {"attention_impl": impl})
        out[impl] = handler(params, {"tokens": tokens})
        torch.cuda.synchronize()
    rt.shutdown()
    plain, cuda = out["torch_ref"], out["cuda"]
    if cuda.shape != plain.shape or not torch.isfinite(cuda).all():
        fail(f"prefill parity: shape {tuple(cuda.shape)} or non-finite")
    rel_a = ((cuda - plain).abs().max()
             / plain.abs().max().clamp_min(1e-30)).item()
    agree = int((cuda.argmax(-1) == plain.argmax(-1)).sum())
    del out, plain, cuda
    log(f"prefill parity (a): {PREFILL_PARITY} tokens, plain attention vs "
        f"kernel, max relative logits diff {rel_a:.3e} (tol {PARITY_TOL:g}); "
        f"argmax agrees on {agree}/{PREFILL_PARITY[0] * PREFILL_PARITY[1]}")

    logits, _ = model.apply(params, cfg, model.RunOptions(),
                            tokens=serve["prompt"])
    last = logits[:, -1, : cfg.vocab_size]
    ref = serve["prefill_logits"]
    rel_b = ((last - ref).abs().max()
             / ref.abs().max().clamp_min(1e-30)).item()
    log(f"prefill parity (b): apply at {tuple(serve['prompt'].shape)} "
        f"(kernel attention) vs the serve path's prefill chunk, last-token "
        f"max relative logits diff {rel_b:.3e} (tol {PARITY_TOL:g}); argmax "
        f"agrees on {int((last.argmax(-1) == ref.argmax(-1)).sum())}/"
        f"{ref.shape[0]}")
    if rel_a > PARITY_TOL or rel_b > PARITY_TOL:
        fail(f"prefill parity: relative diffs {rel_a:.3e}, {rel_b:.3e} > "
             f"{PARITY_TOL}")
    return {"max_rel_a": rel_a, "max_rel_b": rel_b}


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
    attn = phase_attention()
    cfg = configs.get_config("qwen3-0.6b").replace(compute_dtype="float32")
    main_path = phase_main_path(cfg)
    params = main_path.pop("built").params
    serve = phase_parity(cfg, params)
    prefill = phase_prefill(cfg, params)
    phase_prefill_parity(cfg, params, serve)
    log(f"total {time.perf_counter() - t_start:.1f}s")

    # K2 per (1, 4096) prefill call: 28 launches at the full-width shape,
    # at the tiles the prefill Controller chose (the default pair if it
    # chose the plain version).
    at = next(r for r in attn["per_shape"]
              if r["shape"][3] == PREFILL_SWEEP[1]
              and r["dtype"] == "float32")
    chosen = prefill["chosen"]
    tiles = f"{chosen['block_q']}x{chosen['block_kv']}"
    n = N_LAYERS
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
        "prefill_launches": prefill["rmsnorm_launches"],
        "shapes": rms["per_shape"],
    }, {
        "name": "attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:106",
        "launches": prefill["attention_launches"],
        "max_abs_err": attn["max_abs_err"],
        "max_abs_err_by_dtype": attn["max_abs_err_by_dtype"],
        "ms": n * at["kernel_ms_by_tiles"][tiles],
        "plain_ms": n * at["plain_ms"],
        "bound_ms": n * at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": (n * at["library_ms"] if at["library_ms"] is not None
                       else None),
        "per": f"one full-width (1, {PREFILL_SWEEP[1]}) prefill call ({n} "
               f"launches at (1, 16 q / 8 kv heads, {PREFILL_SWEEP[1]}, "
               f"128) fp32, causal, tiles {tiles})",
        "shapes": attn["per_shape"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}), flush=True)


if __name__ == "__main__":
    main()
