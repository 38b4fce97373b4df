#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU (H100).

Run from the root of a checkout, on a machine with the card:

    python3 chip_smoke.py

It imports the port (``src/repro_torch``) and nothing of JAX or of the
JAX package, and runs its phases in order; any failure exits non-zero.

1. Device: prints the card's name and power limit (``nvidia-smi``) and
   checks compute capability (9, 0).
2. Build: compiles every kernel of the port (rmsnorm, flash attention,
   linear attention, matmul, fastpath) from the sources in the checkout,
   one ``nvcc`` per source, all started together (into the git-ignored
   ``build/kernels``).
3. RMSNorm vs plain: the kernel against its plain PyTorch version on the
   card, at every shape the served batch buckets and a (1, 4096) prefill
   of qwen3 and of rwkv6 give it, the reference's test shapes, widths and
   a misaligned view that take its general body, in fp32 (tolerance 1e-5),
   bf16 and fp16 (3e-2); the q/k pair launch against two plain calls at
   the decode and the (permuted) prefill layouts.  Then it reads K1's
   launches on one full-width decode step at batch 8 from the model (kind
   and shapes, by wrapping the kernel's entry points) and times each kind
   of launch, the prefill shapes and the prefill pair: the kernel, the
   plain version and ``F.rms_norm`` (two calls for a pair), eager (the
   median of five rounds in alternating order) and in a CUDA graph, with
   CUDA events, over a ring of inputs larger than the L2 cache where the
   shape allows, and the host's microseconds a launch (eager minus graph);
   the (4096, 1024) prefill launch also in bf16 and fp16.
4. Attention vs plain: the flash attention kernel against its plain
   version at every tile pair, at the reference's test cases, the
   full-width prefill shapes (16 query / 8 kv heads, head dim 128, S =
   512, 1000, 2048, 4096) and MLA's head dims (q/k 192, v 128; causal, and
   GQA with a window), in fp32 (2e-4), bf16 and fp16 (3e-2), each also
   held to a limit scaled to every element's size (in fp16 plus the most
   that rounding P to fp16 moves it); at the long call's lengths (S =
   8192, 16384) the kernel runs whole and slices of its rows are held to
   the plain version; the domain past (192, 128), one launch and no
   fallback a call: head dims (256, 256), (128, 256), (256, 128) in each
   dtype, q, k and v of mixed dtypes (held to the loosest tolerance and
   to q's scaled limit plus v's P-rounding term) and windows 0 and -5,
   causal and not, whose rows with no valid column must be 0; times the
   kernel (per tile pair, with the body it
   reports, its shared memory and ring stages, the instantiation and CUDA
   launches a call the profiler saw, which must match that body, its share
   of the bound and, in the log, its previous design's time), the plain
   version and
   ``scaled_dot_product_attention``,
   also at MLA's dims, at the prefill's S = 4096 in bf16 and fp16, and at
   Gemma's head dim 256 on the prefill's heads in each dtype; checks that
   each of the 32 half-precision instantiations holds HGMMA.
4b. Linear attention vs plain: the chunked linear attention kernel against
   its plain version at every chunk (16, 32, 64), at the reference's test
   cases, rwkv6-1.6b's 32 heads of 64 at T = 1000 (ragged), 4096 (the
   prefill path's) and 16384 (the long call's, compared whole) and a
   hymba-like inclusive scalar-decay head, in fp32 (5e-4), bf16 and fp16
   (3e-2), each also held to a limit scaled to every element; GLA-1.3B's
   heads (dk 256, dv 512) in each dtype and a mixed (q, k, v) triple, one
   launch and no fallback a call; times the kernel
   (at the prefill shape also its CUDA launches a call and each launch's
   device time, by the profiler; its share of the bound and, in the log,
   its previous design's time)
   and the plain version (no single PyTorch call computes this function),
   at the prefill shape also in bf16 and fp16, and at GLA's heads (4,
   4096, 256, 512) in each dtype.
4c. Matmul vs plain: the blocked matmul kernel against its plain version
   at every instantiated tile triple (both ``assume_divisible`` settings
   where the shape divides), at the reference's test shapes (ragged ones
   included, one also as a view one element into its storage) in every
   (x, y, out) class of MATMUL_CLASSES: fp32, bf16 and fp16 each to
   itself and to the other two outputs, and fp32 x bf16 and bf16 x fp16
   operands (1e-5 where all three are fp32, else 3e-2), and at Table 1's
   N = 256, 1024, 4096, a ragged (4095, 1000) x (1000, 3001) and
   qwen3-0.6b's (4096, 1024) x (1024, 3072) (fp32, bf16 and fp16 at their
   tiles, an fp32 product into fp16 and the mixed operands at one) within
   a limit scaled to each element's sum |x||y| (plus one ulp of a half
   output); every case launches the kernel once, and the body it ran
   (fp32 cp.async, fp32 with 4-byte copies, bf16/fp16 wgmma, simt) is
   counted; checks in the built library's SASS (``cuobjdump -sass``) that
   every wgmma instantiation, fp16 and bf16, holds HGMMA instructions;
   times the kernel per tile triple, the plain version and
   ``torch.matmul`` (cuBLAS, TF32 off), in fp32 and, at 4096^3 and the
   qwen3 shape, in bf16 and fp16.
4d. Fastpath vs plain: the hot-key matcher against its plain version at
   the reference's cases (every value dtype, int32, int64 and int8 keys,
   block_b 32, 128 and 256), at batches of 8192 and 65536 against tables
   of 1 to 4096 keys with int32 and fp32 values, a table of duplicate
   keys, an all-miss batch, a table whose keys share one probe chain and
   int64 keys apart only in their high 32 bits, then the domain past
   those: fp32, bf16 and fp16 keys against queries that show ``==``'s
   rounding (2^24 + 1, 2049, 257, 70000; a NaN, a -0.0 and a non-integral
   key), every pair of integer query and key dtypes, keys 33, 64 and 100
   wide (staged and not), and block_b 1, 7, 64, 100, 512 and 1024; each
   case on the raw table (the dense body) and on the prepared table (the
   body the kernel picks, then each body), one launch a call, the miss
   count against the plain hit count; exact for integer values, 1e-6 for
   fp32 and bf16 ones, one ulp for fp16 ones; ``make_fastpath`` on the
   card with an (8, 8) key shape and fp16 values (int8 keys: one launch a
   call; float32 keys: float queries, one fallback a call) against the
   generic function; times each body eager and in a CUDA graph of 100 launches
   (host = eager minus graph), the raw wrapper per ``block_b`` and the
   plain version (no single PyTorch call computes this function), logs
   where the hashed body overtakes the dense one, and times a router
   batch with bf16 and fp16 values and with keys 64 wide on each body.
4e. Guards: for each kernel, one call it takes goes through its registry
   entry to ``cuda`` (one launch, no fallback, within the kernel's
   tolerance of its plain version; K3 on random fp32 within phase 4c's
   scaled limit), one call that misses the reference's precondition (host
   tensors; float queries for K5) returns the plain version's answer with
   exactly one fallback counted and no launch (K1, K2 and K4 also take
   an fp16 call so: one launch, within the low-precision tolerance; K2 and
   K4 also a mixed-dtype call and their widest heads, K2 a window of -5;
   K3 fp16, fp32 x bf16 and fp32 into fp16; K5 float keys, fp16 values,
   keys 33 wide, int8 queries and a block_b of 7), and one call of each
   domain gap left, an input the reference's kernel takes and the port's
   does not (fp64 rows for K1; d 264, dv 264 and an uninstantiated tile
   for K2; an uninstantiated tile triple for K3; dk 264, dv 520, chunk 48
   and a bonus on the inclusive recurrence for K4), raises the kernel's
   error with no launch and no fallback; then a stale
   ``spec_state`` restored into a handler on the card leaves it serving
   its generic variant.  Each check fails with its own message.
5. Serve path: ``repro_torch.launch.serve.build_engine`` serves qwen3-0.6b
   at full width (28 layers, d=1024, vocab 151936; random weights from
   seed 0) in fp32, through the default safety controller that explores
   ``cache_dtype`` x ``rmsnorm_impl``; prints the host ms a decode step
   beside PR 15's 115.2 (a record, not a gate).
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
9. rwkv6 prefill path: rwkv6-1.6b at full width (24 layers, d=2048, 32
   heads of 64, d_ff 7168, vocab 65536; random weights from seed 0) in
   fp32, its prefill handler under a ``Controller`` whose
   ``CoordinateDescent`` sweeps ``linear_attention_impl`` x ``chunk_len``
   over (1, 4096) prefills until it settles, then one (1, 16384) call;
   one (1, 4096) call under ``torch.profiler``.
10. rwkv6 serve path: ``build_engine --arch rwkv6-1.6b`` on the same
   weights serves 4 requests through the safety controller (which also
   explores ``chunk_len``).
11. rwkv6 parity at full width: (a) the prefill handler pinned to the
   kernel and then to the plain linear attention on the same (2, 2048)
   tokens, every kernel call held to the plain version on its own inputs
   (the linear attention tolerances), (b) the forward's last-token logits
   at (8, 16) against the serve handler's prefill-chunk logits (its
   per-step decode), on three weight seeds.  Both are held to the plain
   forward in float64: with random weights the per-head norm of
   near-cancelling time-mix rows makes a few positions' logits move by
   more than 1e-3 under fp32 rounding, so the kernel path must lie within
   1e-3 of the witness and of the plain path where the plain fp32 path
   lies within 1e-4 of the witness, and (a) must have at least 90 % such
   positions.
12. The Fig 2 / Table 1 path: (a) ``examples/quickstart_torch.py``'s
   ``main()`` on the card, which must settle and answer its guard miss
   through the generic variant; (b) a Table-1 handler on an
   ``IridescentRuntime`` declaring ``matmul_impl``, the tile triple and
   ``spec.assume("divisible")``, under a ``Controller`` whose
   ``ExhaustiveSweep`` runs N = 4096 fp32 products until it settles (the
   choice is reported beside K3's best candidate and the plain version),
   then a 4095 call that misses the divisibility guard and runs the
   generic variant (the kernel, edge-masked).
13. The Fig 4 / Fig 9 router (the paper's §5): (a) Fig 4, the LPM
   router's fast path against its generic for LPM tables of 16 to 8192
   entries at 100 % hit, batches of 8192 addresses, timed; (b) Fig 9, the
   ``router`` handler's fast-path table instrumented, built from the
   observed addresses and explored online by an ``Explorer`` over
   ``RequestGenerator`` traffic whose addresses shift at the midpoint,
   ranking the sizes by call rate while its change detector reads the
   table's share of the rows; it must re-instrument after the shift, and
   its output must equal the generic's on every 10th step.  At M = 16 and
   8192 the profiler reads the device's busy share over 200 steady
   all-hit calls of the fast path and its launches a call, which must be
   one K5 launch and nothing else.

14. Warm restart: full-width qwen3-0.6b at batch 1 (one prefill and one
   decode context) with ``--cache-dir`` and the plain Controller, run
   twice, each in a fresh process (``chip_smoke.py --restart-run DIR``)
   with K1's built library moved out of ``build/kernels`` (put back
   after). The cold run builds K1 with ``nvcc``, serves until both
   contexts settle and saves spec_state; the warm run must restore, start
   every seeded context in EXPLOIT on its saved config, make no ``nvcc``
   build, count cache hits and launch K1. Prints both times-to-settled,
   the ``nvcc`` seconds saved and the cache hits.
15. Tenants: a full-width qwen3-0.6b tenant and a full-width rwkv6-1.6b
   tenant (DRR weights 2:1, batch 1) served on the card; per-tenant
   completions, latency percentiles, host ms a step and K1 launches (each
   tenant's steps must launch it); the tenants' contexts disjoint; both
   kept busy until every context settles, then a second tenant engine
   restores them from spec_state with zero variant builds.
16. Fleet: ``python -m repro_torch.launch.serve --device cuda --replicas 2
   --plane-dir P --cache-dir C --portable-cache`` at the CLI's reduced
   width, cold then warm on the same P and C, K1's library out of
   ``build/kernels`` each time: both workers ready, every request served,
   merged percentiles printed, every replica launching K1; no warm
   replica builds a library with ``nvcc``; ``python -m
   repro_torch.launch.status`` renders the snapshot.

17. Families' prefill at full width and full depth: (a) K1 at every
   family width, K2 at every family's heads (deepseek-7b's MHA 32/32 and
   yi-6b's 32/4 of 128, minitron-4b's 24/8, internvl2-2b's 16/8,
   musicgen-medium's 24/24 of 64, hymba-1.5b's 25/5 of 64 with its window
   of 1024) at every tile pair and K4 as hymba's SSM heads call it
   (25 heads, 4096, N 16, dv 64: inclusive, q/k broadcast over the heads,
   a scalar decay) at every chunk, each against its plain version (fp32,
   the tolerances of phases 3, 4 and 4b); K2 at hymba's windowed shape and
   K4 at hymba's shape timed beside the plain version, the library call
   and the bound; (b) deepseek-7b, minitron-4b, internvl2-2b and
   musicgen-medium (their stub frontends take embeds drawn from the
   seed), yi-6b and hymba-1.5b, one at a time, random weights from seed 0
   in fp32: one (1, 4096) prefill through ``make_prefill_builder``'s
   generic variant (timed: tok/s), one under ``torch.profiler`` (device
   busy share, device ms and CUDA launches by kernel: K1, K2, K4, GEMMs,
   other), and the same call pinned to the plain versions, their logits
   within a max relative difference of 1e-3; each call must launch K1
   2L + 1 times (hymba 4L + 1), K2 L times and (hymba) K4 L times; then
   hymba's prefill handler under a Controller whose CoordinateDescent
   sweeps ``attention_impl`` x tiles x ``linear_attention_impl`` x
   ``chunk_len`` over (1, 4096) calls until it settles.
18. Families' serving at full width: ``build_engine`` serves hymba-1.5b
   (batch 4, ``--max-len 1024``, its window) and yi-6b (batch 4,
   ``--max-len 256``), 4 requests of 64 prompt and 16 new tokens each,
   every context pinned to the kernels (fp32 cache), then the same engine
   pinned to the plain versions: the greedy tokens must be equal; served
   tok/s, p50/p95 latency and the handler's host ms a step.
18b. Half precision at full width and depth: qwen3-0.6b (K1, K2 causal),
   rwkv6-1.6b (K1, K4 exclusive with the bonus) and hymba-1.5b (K1, K2
   with its window of 1024, K4 inclusive), weights from seed 0, each with
   ``compute_dtype`` float16 and then bfloat16: phase 17b's (1, 4096)
   prefill (launches a call from the wrappers' counts, 0 fallbacks, finite
   logits, host and device ms beside the model's fp32 time), its logits
   held to the plain fp32 path's on the same input: max |kernels - plain
   fp32| <= 1.5 x max |plain half - plain fp32| (the plain half path is
   the same call pinned to ``torch_ref``; where it is not finite the
   criterion is skipped and said); qwen3's prefill then sweeps
   ``rmsnorm_impl`` x ``attention_impl`` x tiles under a Controller, every
   candidate run.  Then qwen3-0.6b served in fp16 through
   ``make_serve_builder`` (one prefill chunk and 8 greedy decode steps at
   batch 8) under each ``cache_dtype`` candidate (bf16, fp32), pinned to
   the kernel then to the plain version: 85 K1 launches a decode step, 0
   fallbacks, finite logits, the greedy tokens compared (the top-2 logit
   gap where they first differ).

19. MoE + MLA prefill: (a) K1 at deepseek-v2-236b's widths 5120, 1536 and
   512 (its pre-norms, MLA's ``q_norm`` and ``kv_norm``) and K2 at MLA's
   (1, 128/128, 4096, 192/128) causal at every tile pair, against their
   plain versions (the tolerances of phases 3 and 4), then K2 at that
   shape timed beside the plain version, ``scaled_dot_product_attention``
   and the bound; (b) deepseek-v2-236b at full width with its depth cut
   to 4 layers (the dense first layer and three MoE layers of 160
   experts: 53.2 GB of fp32 weights, random from seed 0), drawn into
   stacks allocated once: one (1, 4096) prefill through
   ``make_prefill_builder``'s generic variant (``moe_impl`` einsum; K1 4L
   + 1 and K2 L launches a call), the same under ``moe_impl`` gather, both
   timed and profiled (device busy share, device ms by class: GEMM, K2,
   K1, the MoE dispatch's sorts, scans and scatters/gathers), then pinned
   to the plain versions; the logits held to 1e-3, generic against plain
   and gather against einsum, with the routing agreement per MoE layer
   (the share of (token, slot) pairs with equal expert and keep) and each
   variant's aux loss; then a Controller's CoordinateDescent over
   ``attention_impl`` x tiles x ``moe_impl`` x ``moe_ranking``
   (``capacity_factor`` 1.25 and one group kept), counting the ``shard``
   calls that ran as ``gather`` (no mesh).
20. MoE + MLA serving: ``build_engine`` serves the same deepseek-v2 at
   depth 4 as phase 18 serves its families (batch 4, ``--max-len 256``, 4
   requests of 64 + 16 tokens, pinned to the kernels then to the plain
   versions: equal greedy tokens), then one decode step per MoE impl
   profiled; then kimi-k2-1t-a32b at its reduced config (one 384-expert
   layer alone is 67.6 GB in fp32): a (1, 256) prefill as in phase 17b
   and 4 served requests, each held to its plain run.  Each prints its
   peak device memory.

21. Training at full width: (a) qwen3-0.6b (28 layers, d=1024, 596 M
   parameters; random weights from seed 0) in fp32 through
   ``make_train_builder`` on an ``IridescentRuntime``, registered with
   ``donate_argnums=0`` as the training CLI registers it, ``SyntheticLM``
   batches of (8, 512) on the card, a Controller whose CoordinateDescent
   sweeps the CLI's labels (``remat``, ``microbatch``, ``logits_dtype``,
   ``rmsnorm_impl``) at dwell 3 until it settles (30-60 steps): step ms
   by CUDA events, tok/s and TFLOP/s per candidate, peak memory per
   ``remat``, the loss by step (the last 10 steps' mean must fall below
   the first), the Controller's rate for the chosen config within 10 % of
   the event-timed step; (b) one profiled step: device busy share and
   device ms by class (GEMM, the plain attention's ops forward and
   backward, softmax/elementwise, the optimizer); (c) one step of reduced
   qwen3 on the card against the CPU's: loss within 1e-5 relative, every
   gradient leaf within 1e-4 of its max; (d) a full-width restart: save at
   step k, 2 steps, restore, replay, the losses within 1e-5; then
   ``python -m repro_torch.launch.train --size 100m --explore --dwell 3
   --ckpt-every 40 --ckpt DIR`` for 80 steps and again for 100, which must resume at step
   80 with a restored tuned config; (e) the donated step (pinned to
   ``remat`` full) against the undonated one from a clone of the same
   state: every leaf of the donated state keeps its storage, the loss and
   every parameter within 1e-6 relative, and the optimizer's allocator
   peak (above what was allocated before the update) at most 3 x the
   largest leaf donated, printed beside the undonated one's.
22. MoE dispatch exploration: ``examples/moe_exploration_torch.py`` on the
   card (reduced kimi-k2, 16 experts, top 4; an ExhaustiveSweep over
   ``moe_impl`` x ``moe_ranking``), the selected dispatch.

23. The distributed layer on one card: a one-rank NCCL group (``file://``
   rendezvous under ``build/smoke/mesh``) and ``make_local_mesh(1, 1)``
   on ``cuda``; (a) ``compressed_psum`` of a (4096, 4096) fp32 tensor over
   ``data`` within int8 error of it (relative error < 0.02), a profiler
   window whose all-gather ran on int8 data and put work on the device
   (at one rank NCCL copies the payload rather than running a ring);
   (b) deepseek-v2-236b's MoE layer at full width (160 experts, top 6,
   two shared; 15.2 GB fp32) on a (1, 4096) input under ``shard`` (the
   explicit expert-parallel block, all 160 experts local) and
   ``gather``, at the first capacity factor at which no token is dropped:
   outputs within 1e-5 relative, each timed; (c) one full-width qwen3-0.6b
   train step on ``SyntheticLM`` (8, 512) under the ``fsdp`` profile
   with DTensor parameters, from phase 21's initial state, against the
   plain step: loss and every parameter within 1e-5 relative, each step's
   ms (DTensor's own cost on one card); (d) (c)'s parameters saved and
   restored with ``axes=`` onto the mesh: placed by their axes and equal.
   The group is destroyed at the end of the phase.

In phases 5, 7, 9, 10, 12, 13, 15, 17, 18, 18b, 19 and 20 (the main
paths) the launch counters and the registry's fallback counts are zeroed
just before and read just after; every kernel of the path must have
launched and none may have fallen back (phases 14 and 16 count K1's
launches in their own processes).  In phases 21 and 22 (training) and 23
(the mesh) the same counts are zeroed and must stay 0: a train step
declares the gradient-safe entries, no kernel has a backward, and a step
under a mesh pins every implementation to its plain version.  The line
before the last is a JSON object ``{"kernels": [...]}`` with one entry per
kernel, and the line before it gives each phase's wall seconds; the last
line is ``{"ok": true, "device": {...}}``.  Phase 24b's card step is
donated, as the dry run now counts the train step.
"""
from __future__ import annotations

import argparse
import collections
import gc
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: working directories of phases 14-16 (git-ignored ``build/``)
SCRATCH = ROOT / "build" / "smoke"

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
#: outside the tensor cores, dense bf16 FLOP/s on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

#: batch of the decode step whose K1 launches phase 3 reads from the model
#: and times (the serve path's batch cap), and rounds of its eager timings
DECODE_BATCH = 8
K1_ROUNDS = 5
#: every (rows, d) the served batch buckets B = 1, 2, 4, 8 give the kernel
#: (prefill runs as a scan of decode steps, so it gives the same shapes)
BUCKET_SHAPES = sorted({s for b in (1, 2, 4, 8)
                        for s in ((b, 1024), (16 * b, 128), (8 * b, 128))})
#: (rows, d) of the single-tensor K1 launches of one full-width (1, 4096)
#: qwen3 prefill (norm1/norm2/final), with launches per call; then the
#: (rows, d) of the two segments of its q-norm (16 heads) and k-norm (8)
#: pair launch, one a layer; and K1 launches per call in all
PREFILL_SHAPES = {(4096, 1024): 2 * 28 + 1}
PREFILL_PAIR = ((65536, 128), (32768, 128))
PREFILL_LAUNCHES = 2 * 28 + 1 + 28
#: (rows, d) per rmsnorm launch on one full-width rwkv6-1.6b (1, 4096)
#: prefill, with launches per call: norm1/norm2/final, and the per-head
#: output norm (32 heads of 64)
RWKV_PREFILL_SHAPES = {(4096, 2048): 2 * 24 + 1, (131072, 64): 24}
#: the reference's rmsnorm test shapes (tests/test_kernels.py), then widths
#: that take the kernel's scalar path: d = 1020 is a whole number of fp32
#: 16-byte vectors but not of bf16 ones, d = 65 of neither
TEST_SHAPES = [(32, 128), (100, 64), (256, 256), (2, 17, 64), (5, 1020),
               (3, 65)]
TOL = {"float32": 1e-5, "bfloat16": 3e-2, "float16": 3e-2}
#: the dtypes the kernels take (K1, K2 and K4), checked in phases 3-4b
KERNEL_DTYPES = ("float32", "bfloat16", "float16")
#: attention tolerances, the reference's (tests/test_kernels.py; its
#: low-precision one for fp16 too)
ATTN_TOL = {"float32": 2e-4, "bfloat16": 3e-2, "float16": 3e-2}
#: a second limit scaled to each element, |out - ref| <= atol + rtol |ref|
#: as (rtol, atol): the kernel and the plain version both accumulate in
#: fp32 and round once to the output's dtype, so they differ by at most one
#: ulp of it (bf16 2^-7, fp16 2^-10 of the value) and in fp32 by the
#: summation order; in bf16 and fp16 the kernel also rounds each
#: probability to the input dtype before the P.V product (as the
#: reference's Pallas kernel rounds it to v's dtype), which moves an output
#: by at most half an ulp (bf16 2^-8, fp16 2^-11) of sum_c p_c |v_c| / l,
#: the plain attention over |v|: both add rtol times that to the limit
#: (tests/test_torch_half.py holds the reference's own kernel to it)
ATTN_SCALED_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-5),
                   "float16": (2 ** -10, 1e-5)}
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
#: MLA's head dims (deepseek-v2: q/k nope + rope = 192, v 128;
#: src/repro/models/mla.py:90-98) on 16 heads: causal, then GQA with a
#: window, compared in fp32 and bf16; the first also timed at ATTN_MLA_TIMED
ATTN_MLA_CASES = [
    ((1, 16, 1000, 192), (1, 16, 1000, 192), (1, 16, 1000, 128), True, None),
    ((1, 16, 777, 192), (1, 4, 777, 192), (1, 4, 777, 128), True, 256),
]
ATTN_MLA_TIMED = 4096
#: rows of 36 bytes in bf16 and fp16 (head dims 18 / 10): the wgmma body's
#: 4-byte copies (the card tests' d18 case)
ATTN_D18_CASE = ((2, 2, 70, 18), (2, 2, 70, 18), (2, 2, 70, 10), True, None)
#: hymba-1.5b's attention heads (25 query / 5 kv, head dim 64) and sliding
#: window (src/repro_torch/configs/hymba_1_5b.py), timed in bf16 and fp16
#: at ATTN_MLA_TIMED tokens
ATTN_HYMBA = (25, 5, 64, 1024)
#: K2's domain past (192, 128), each call one launch and no
#: fallback: head dims up to 256 (Gemma's) on (B, H, Hk, S) GQA heads at a
#: ragged length, every dtype and tile pair; q, k and v of mixed dtypes
#: (q, k, v) with a window; windows <= 0 (column c of row r kept where c >
#: r - window: no past column), causal and not, at q_offset
#: ATTN_WINDOW_OFFSET, which leaves more rows none
ATTN_WIDE_DIMS = ((256, 256), (128, 256), (256, 128))
ATTN_WIDE_HEADS = (1, 4, 2, 300)
ATTN_MIXED = (("bfloat16", "bfloat16", "float16"),
              ("float32", "bfloat16", "bfloat16"),
              ("float16", "bfloat16", "float32"))
ATTN_WINDOWS = (0, -5)
ATTN_WINDOW_OFFSET = -40
#: Gemma's head dim, timed causal at (1, 16/8, ATTN_MLA_TIMED, 256) in
#: each dtype against SDPA
ATTN_WIDE_TIMED = 256
#: the padded (d, dv) pairs the library instantiates, per tile pair and
#: dtype
ATTN_PADDED_DIMS = ((64, 64), (128, 128), (192, 128), (256, 256))
#: K2's and K4's times in their previous designs (the single-stage flash
#: attention, the half-precision body on fp32 FMAs, and the chunk-serial
#: linear attention; this script's runs on NVIDIA H100 80GB HBM3, 700.00 W,
#: recorded in PERF.md §6), copied here and printed in the log beside this
#: run's, never in the kernels line: a causal (1, 16/8, S, 128) launch by
#: (dtype, S), fp32 at the tiles (128, 64), bf16 and fp16 at their best
#: tiles; and a (32, 4096, 64, 64) fp32 exclusive call by chunk
K2_PREVIOUS_MS = {("float32", 4096): 3.7448, ("float32", 16384): 45.8058,
                  ("bfloat16", 4096): 3.691, ("float16", 4096): 3.739}
K4_PREVIOUS_MS = {16: 1.5623, 32: 1.3388, 64: 1.2708}
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
#: linear attention tolerances: the reference's 5e-4 for fp32
#: (tests/test_linear_attention_kernel.py: the kernel and the plain version
#: sum the chunk products and fold the chunk states in different orders),
#: 3e-2 for bf16 and fp16 as the other kernels
LINATT_TOL = {"float32": 5e-4, "bfloat16": 3e-2, "float16": 3e-2}
#: a second limit scaled to each element, (rtol, atol): la = cumsum(log w)
#: reaches 64 in magnitude at chunk 64, so its rounding (64 x 2^-24, ~4e-6)
#: enters every e^{+-la} factor as a relative error of that size; an output
#: sums ~128 such terms (c intra + dk inter) of magnitude up to ~8 (a score
#: sums 64 products of unit normals), so an output that nearly cancels
#: still carries ~sqrt(128) x 8 x 2e-6 ~ 2e-4 of absolute error; in bf16
#: both round the same fp32 value once (one bf16 ulp, 2^-7 of the value,
#: beyond that; in fp16 one fp16 ulp, 2^-10, beyond the fp32 limit)
LINATT_SCALED_TOL = {"float32": (5e-5, 2e-4), "bfloat16": (2 ** -7, 2e-4),
                     "float16": (2 ** -10 + 5e-5, 2e-4)}
#: linear attention cases (bh, T, dk, dv, inclusive, bonus, scalar decay):
#: the reference's test cases (tests/test_linear_attention_kernel.py:28-55)
LINATT_TEST_CASES = [
    *[(2, t, 8, dv, inc, False, False)
      for t in (32, 64) for dv in (8, 16) for inc in (False, True)],
    (3, 64, 8, 8, False, True, False),
    (2, 32, 8, 12, True, False, True),
]
#: full-width rwkv6-1.6b time mix at batch 1: 32 heads of 64, exclusive with
#: the bonus, at a ragged length, the prefill path's and the long call's;
#: then hymba-1.5b's SSM heads (25 heads, dk 16, dv 64, inclusive, scalar
#: decay) at its prefill length, with independent q/k per head (phase 17
#: holds the broadcast call)
RWKV_HEADS = 32
RWKV_HEAD = 64
RWKV_LAYERS = 24
LINATT_WIDE_CASES = [
    (RWKV_HEADS, 1000, RWKV_HEAD, RWKV_HEAD, False, True, False),
    (RWKV_HEADS, 4096, RWKV_HEAD, RWKV_HEAD, False, True, False),
    (RWKV_HEADS, 16384, RWKV_HEAD, RWKV_HEAD, False, True, False),
    (25, 4096, 16, 64, True, False, True),
]
#: the rwkv6 prefill path: (batch, tokens) of the Controller's sweep, the
#: long call, and the parity check (a)
#: K4's domain past 128, each call one launch and no fallback:
#: GLA-1.3B's heads (d_model 2048, 4 heads, expand_k 0.5, expand_v 1: dk
#: 256, dv 512), exclusive with the bonus and inclusive, and keys past one
#: 128-key chunk with dv in one 64-column pass ((256, 64), (136, 8)), at
#: ragged lengths in every dtype and chunk; q, k and v of mixed dtypes
#: (q, k, v) at rwkv6's heads; GLA's heads timed (inclusive, no bonus) at
#: LINATT_GLA_TIMED (bh, T, dk, dv)
LINATT_GLA_CASES = [(2, 300, 256, 512, False, True, False),
                    (2, 300, 256, 512, True, False, False),
                    (4, 300, 256, 64, False, True, False),
                    (2, 130, 136, 8, True, False, False)]
LINATT_MIXED = ("float16", "float32", "bfloat16")
LINATT_GLA_TIMED = (4, 4096, 256, 512)
RWKV_SWEEP = (1, 4096)
RWKV_LONG = 16384
RWKV_PARITY = (2, 2048)
#: the rwkv6 parity checks hold both fp32 paths to a float64 witness (the
#: plain forward in float64 on the same weights), on these weight seeds (0
#: is the prefill phase's weights): at each of RWKV_QUANTILES of the
#: positions' relative logits differences from the witness, the kernel
#: path (and in (b) the decode) must lie within PARITY_TOL or within
#: RWKV_WITNESS_FACTOR times the plain fp32 path's difference, whichever is
#: larger
RWKV_WITNESS_SEEDS = (0, 1, 2)
RWKV_QUANTILES = (0.5, 0.9, 1.0)
RWKV_WITNESS_FACTOR = 4
#: H100 SXM int32 instruction rate on the SIMT units: 64 INT32 lanes an SM
#: against the 128 FP32 lanes behind PEAK_FP32_FLOPS (NVIDIA's Hopper
#: architecture white paper), so a quarter of the fp32 FLOP/s (two flops
#: an FMA): the rate of the fast-path matcher's key compares
PEAK_INT32_OPS = PEAK_FP32_FLOPS / 4
#: blocked matmul (K3) cases (m, k, n): the reference's test shapes
#: (tests/test_kernels.py:28-55, ragged ones included), held to its
#: tolerances (MATMUL_TOL) at every instantiated tile triple
MATMUL_TEST_SHAPES = [(32, 32, 32), (64, 96, 48), (128, 64, 128),
                      (96, 72, 80), (64, 64, 64), (50, 30, 70)]
MATMUL_TOL = {"float32": 1e-5, "bfloat16": 3e-2, "float16": 3e-2}
#: the (x, y, out) dtype classes checked at the test shapes and every tile
#: triple (out None: x's dtype): one dtype to itself and to each other
#: float output, and operands of two dtypes (widened to fp32 by the
#: wrapper); each held to the loosest tolerance of its three dtypes
MATMUL_CLASSES = [
    ("float32", "float32", None), ("float32", "float32", "bfloat16"),
    ("float32", "float32", "float16"), ("bfloat16", "bfloat16", None),
    ("bfloat16", "bfloat16", "float32"), ("bfloat16", "bfloat16", "float16"),
    ("float16", "float16", None), ("float16", "float16", "float32"),
    ("float16", "float16", "bfloat16"), ("float32", "bfloat16", None),
    ("bfloat16", "float16", None)]
#: one ulp of a half output, relative (the scaled limit's rounding term)
HALF_ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
#: the card's shapes: Table 1's square sizes, a ragged product and
#: qwen3-0.6b's widest layer product (the MLP up projection of a (1, 4096)
#: prefill), held to a limit scaled to each element: the kernel and the
#: plain version (cuBLAS) each sum K fp32 products in their own order, so
#: they differ by about sqrt(K) 2^-24 sum_k |x||y| (allowed
#: MATMUL_SCALED_FACTOR times that), plus one bf16 ulp (2^-7 of the value)
#: for a bf16 output whose two fp32 sums round to neighbouring numbers
MATMUL_TABLE1_SIZES = (256, 1024, 4096)
MATMUL_CARD_SHAPES = [*[(n, n, n) for n in MATMUL_TABLE1_SIZES],
                      (4095, 1000, 3001), (4096, 1024, 3072)]
MATMUL_SCALED_FACTOR = 8
#: the classes also checked at the card's shapes (one tile triple for
#: those the fp32 body runs): fp16 on wgmma into fp16, an fp32 product
#: into fp16, and mixed operands
MATMUL_CARD_CLASSES = [("float16", "float16", None),
                       ("float32", "float32", "float16"),
                       ("float32", "bfloat16", None),
                       ("bfloat16", "float16", None)]
#: the Table-1 handler (phase 12): square size of the Controller's sweep,
#: the size of the call that must miss its divisibility guard, and calls
#: per candidate
TABLE1_N = 4096
TABLE1_MISS_N = 4095
TABLE1_DWELL = 3
#: fast-path matcher (K5) cases (B, N, K, V): the reference's
#: (tests/test_kernels.py:136-145, block_b 32 there), then the router's
#: K = 1 at batches of 8192 and 65536 against fig 9's table sizes and the
#: generator's hot pool (data/pipeline.py: 4096), with int32 values (V = 1,
#: the router's next hop) and fp32 values (V = 16); exact for integer
#: values, FASTPATH_TOL for float ones
FASTPATH_TEST_CASES = [(64, 8, 3, 16), (100, 4, 1, 8), (256, 32, 2, 4)]
#: the reference's cases' block_b (its tests' 32, 128, its default 256)
FASTPATH_BLOCK_B = (32, 128, 256)
#: any positive block_b: warps of 32 rows, and past 256 blocks of 256
FASTPATH_ODD_BLOCK_B = (1, 7, 64, 100, 512, 1024)
#: keys wider than the 32 integers a query keeps in registers
FASTPATH_WIDE = (33, 64, 100)
#: float keys and integer queries that show ``==``'s rounding of the query
#: to the keys' dtype: 16777217 onto 2^24 (fp32, bf16) or inf (fp16), 2049
#: onto 2048 (half), 257 onto 256 (bf16), 70000 onto inf (fp16), a NaN key
#: (matches nothing), -0.0 (matches 0), 2.5 (not integral)
FASTPATH_FLOAT_KEYS = [16777216.0, float("nan"), -0.0, 2.5, 2048.0, 256.0,
                       float("inf"), -7.0, 300.0, 2.0 ** 31]
FASTPATH_EDGE_QUERIES = [16777217, 16777216, 16777215, 0, 2, 3, 2049, 2050,
                         257, 258, 70000, 65519, 65520, -7, 5, -70000, 300,
                         301, 2 ** 31 - 1, -2 ** 31]
FASTPATH_BATCHES = (8192, 65536)
FASTPATH_TABLES = (1, 4, 16, 256, 4096)
FASTPATH_TOL = 1e-6
#: table sizes between which the body threshold is read (device time of
#: each body in a CUDA graph of FASTPATH_GRAPH_LAUNCHES launches)
FASTPATH_THRESHOLD = (2, 8, 32, 64, 128)
FASTPATH_GRAPH_LAUNCHES = 100
#: the router (phase 13): addresses a batch, fig 4's LPM table sizes and
#: hot addresses, fig 9's table size, iterations, dwell and candidate
#: fast-path sizes (benchmarks/fig4_fastpath.py, fig9_fastpath_size.py)
ROUTER_BATCH = 8192
FIG4_TABLES = (16, 128, 1024, 8192)
FIG4_HOT = 16
#: LPM sizes whose fast path is profiled (device busy share, launches a
#: call) over this many steady calls
FIG4_PROFILE = (16, 8192)
FIG4_PROFILE_CALLS = 200
FIG9_TABLE = 512
FIG9_ITERS = 700
FIG9_DWELL = 30
FIG9_SIZES = (1, 4, 16)
#: the restart (phase 14): full-width qwen3 at batch 1 (two contexts,
#: prefill and decode), the plain Controller so a short run settles; a
#: request is offered whenever the engine is idle, until every context has
#: settled or the cap
RESTART_ARGS = ["--device", "cuda", "--batch", "1", "--max-len", "256",
                "--prefill-chunk", "16", "--dwell", "2", "--no-safety",
                "--bucket-dwell", "100000", "--kv-dwell", "100000"]
RESTART_STEP_CAP = 800
RESTART_TIMEOUT_S = 300
#: the tenants (phase 15): full-width qwen3 (weight 2) and rwkv6 (weight
#: 1) at batch 1 (a prefill and a decode context each), requests per
#: tenant, then one request a tenant in flight until every context settles
TENANTS = ("q=qwen3-0.6b::2", "r=rwkv6-1.6b::1")
TENANT_ARGS = ["--device", "cuda", "--batch", "1", "--max-len", "256",
               "--prefill-chunk", "16", "--dwell", "2", "--requests", "3",
               "--rate", "2", "--scheduler", "drr"]
TENANT_SETTLE_CAP = 600
#: the fleet (phase 16): the CLI at its reduced width, two replicas, run
#: cold then warm on one plane and one portable cache; round-robin, so
#: both replicas serve (join-shortest-queue sent every request to one in a
#: probe: a worker busy building its first variants reports no depth)
FLEET_ARGS = ["--device", "cuda", "--replicas", "2", "--router",
              "round-robin", "--requests", "4", "--rate", "4", "--steps",
              "400", "--dwell", "2",
              "--no-safety", "--portable-cache", "--plane-poll-s", "0.25"]
FLEET_TIMEOUT_S = 300
#: the families (phases 17-18) at full width and full depth, in the order
#: phase 17 loads them (one at a time, the largest first); the last two
#: stay loaded for phase 18.  The stub frontends take embeds.
FAMILY_ARCHS = ("deepseek-7b", "minitron-4b", "internvl2-2b",
                "musicgen-medium", "yi-6b", "hymba-1.5b")
FAMILY_PREFILL = (1, 4096)
#: hymba's prefill Controller: its builder's kernel points
HYMBA_SWEEP_LABELS = ["attention_impl", "block_q", "block_kv",
                      "linear_attention_impl", "chunk_len"]
#: phase 18: (arch, --max-len) served at batch 4 (hymba at its window:
#: its attention cache pages per request only up to it), requests of
#: FAMILY_SERVE_PROMPT prompt tokens and FAMILY_SERVE_NEW new ones
FAMILY_SERVE = (("hymba-1.5b", 1024), ("yi-6b", 256))
FAMILY_SERVE_ARGS = ["--device", "cuda", "--batch", "4", "--prefill-chunk",
                     "16", "--compile-workers", "1", "--no-safety",
                     "--bucket-dwell", "100000", "--kv-dwell", "100000"]
FAMILY_SERVE_REQUESTS = 4
FAMILY_SERVE_PROMPT = 64
FAMILY_SERVE_NEW = 16
#: phase 18b: the models run in half precision at full width and depth,
#: each in every half dtype, a (1, 4096) prefill (FAMILY_PREFILL) each
HALF_ARCHS = ("qwen3-0.6b", "rwkv6-1.6b", "hymba-1.5b")
HALF_DTYPES = ("float16", "bfloat16")
#: the kernels' half-precision logits may lie this many times the plain
#: half-precision path's distance from the plain fp32 path's logits
#: (tests/test_torch_half.py holds the same rule against the reference)
HALF_SPREAD = 1.5
#: qwen3-0.6b's half-precision prefill sweeps these points
HALF_SWEEP_LABELS = ["rmsnorm_impl", "attention_impl", "block_q",
                     "block_kv"]
#: qwen3-0.6b served in fp16: batch, prompt tokens (one prefill chunk) and
#: greedy decode steps, in a cache of HALF_SERVE_MAX_LEN
HALF_SERVE = (8, 16, 8)
HALF_SERVE_MAX_LEN = 64
#: phases 19-20: deepseek-v2-236b at full width, its depth cut to
#: MOE_DEPTH layers (the dense first layer and three MoE layers: 53.2 GB
#: of fp32 weights; its 60 layers are 943 GB, 5 would be 69.1 GB beside
#: the activations of a (1, 4096) call on one 80 GB card)
MOE_ARCH = "deepseek-v2-236b"
MOE_DEPTH = 4
MOE_PREFILL = (1, 4096)
#: its prefill Controller: the attention points and the MoE dispatch.
#: ``capacity_factor`` and ``moe_group`` stay at their defaults (1.25, one
#: group): another capacity drops other tokens, a different result
MOE_SWEEP_LABELS = ["attention_impl", "block_q", "block_kv", "moe_impl",
                    "moe_ranking"]
MOE_SERVE_MAX_LEN = 256
#: kimi-k2-1t-a32b on one card only at its reduced config (one MoE layer
#: of 384 experts is 67.6 GB in fp32): a prefill of this shape, then served
KIMI_ARCH = "kimi-k2-1t-a32b"
KIMI_PREFILL = (1, 256)

#: phases 21-22 (training): qwen3-0.6b at full width on SyntheticLM
#: batches of (B, S); the optimizer of the run; the Controller's dwell and
#: the steps it may take (at least TRAIN_MIN_STEPS, so the loss has
#: steps to fall over)
TRAIN_BATCH = (8, 512)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=5, total_steps=200)
TRAIN_DWELL = 3
TRAIN_STEP_CAP = 60
TRAIN_MIN_STEPS = 30
#: the Controller's rate for the chosen config against the event-timed
#: step (its window also holds the host's work between steps)
TRAIN_RATE_TOL = 0.10
#: the card's step against the host's: fp32 products summed in other
#: orders, the embedding gather's backward accumulating with atomics
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
#: the reduced configs held card against host: a GQA stack, and MLA
#: (whose attention falls through to the step-wide implementation)
TRAIN_PARITY_ARCHS = ("qwen3-0.6b", "deepseek-v2-236b")
#: the CLI twice on one --ckpt.  It saves the tuned config only at a
#: checkpoint step on which its Controller is settled.  At dwell 3 the
#: sweep settles at step 28, and the change detector first reads the
#: settled rate at step 40: an asynchronous save still writing then (one
#: at step 20) can make it re-explore at step 40, and the save at 40
#: makes it re-explore at step 43, to settle again at 70.  So the first
#: run saves at 40 and 80, with no save before 40
TRAIN_CLI_ARGS = ["--size", "100m", "--explore", "--dwell", "3",
                  "--ckpt-every", "40"]
TRAIN_CLI_STEPS = (80, 100)
TRAIN_CLI_TIMEOUT_S = 300
#: phase 21e: the donated step against the undonated one from a clone of
#: the same state, both under DONATE_CONFIG: loss and parameters within
#: DONATE_RTOL relative; the donated optimizer's allocator peak at most
#: DONATE_PEAK_LEAVES x the largest leaf's bytes (qwen3-0.6b's tied
#: embedding, 622.3 MB in fp32)
DONATE_CONFIG = {"remat": "full"}
DONATE_RTOL = 1e-6
DONATE_PEAK_LEAVES = 3

# phase 23: the distributed layer on a one-rank NCCL group, a (1, 1) mesh
MESH_PSUM = (4096, 4096)
MESH_PSUM_RTOL = 0.02
MESH_PSUM_PROFILE_CALLS = 10
MESH_PSUM_PAD_S = 0.1
MESH_MOE_INPUT = (1, 4096)
MESH_MOE_RTOL = 1e-5
#: capacity factors tried in turn for the MoE layer: the first at which no
#: token is dropped is used (shard and gather then compute one function)
MESH_MOE_FACTORS = (1.25, 2.0, 4.0, 8.0)
MESH_TRAIN_RTOL = 1e-5
MESH_TIMED_STEPS = 3
#: phase 23c's logits layouts (the loss on the rank's vocab shard, or the
#: vocab gathered first) and 23e's MoE train step: reduced kimi-k2, fp32,
#: (batch, seq), each dispatch with the microbatch split
MESH_LOGITS_LAYOUTS = ("sharded", "gathered")
MESH_MOE_TRAIN_BATCH = (8, 64)
MESH_MOE_TRAIN_SPECS = ({"moe_impl": "gather", "microbatch": 2},
                        {"moe_impl": "einsum", "microbatch": 2})

#: phase 24: the cached steps on the one-rank mesh (each rank writing and
#: attending on its own cache shard) against the plain step: qwen3-0.6b
#: served (batch, tokens) under each cache layout, deepseek-v2-236b at
#: depth CACHED_MLA_DEPTH under serve_ep with each MoE dispatch of
#: CACHED_MOE_IMPLS (the einsum one runs on each rank's own tokens); fp32
#: caches of CACHED_MAX_LEN
CACHED_SERVE = (8, 32)
CACHED_MLA = (4, 8)
CACHED_MOE_IMPLS = ("gather", "einsum")
CACHED_MLA_DEPTH = 2
CACHED_MAX_LEN = 64
CACHED_RTOL = 1e-5
#: the dry run held to the card: FLOPs equal, argument + temp within
#: DRYRUN_PEAK_RTOL of the measured peak (phase 23's qwen3 train step)
DRYRUN_FLOPS_RTOL = 1e-6
DRYRUN_PEAK_RTOL = 0.15
#: the dry-run CLI at the production mesh: its per-rank argument + temp at
#: most the placed cache plus the parameters' local shards plus this
DRYRUN_CLI_SLACK = 1e9
DRYRUN_CLI = ["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh",
              "single", "--spec", '{"sharding_profile": "serve_ep"}']
#: the hillclimb's c2_logitsbf16 cell of hymba-1.5b prefill_32k at the
#: production mesh: its 25 heads split unevenly over model = 16, at most
#: DRYRUN_HYMBA_TEMP bytes of temp a rank
DRYRUN_HYMBA = ["--arch", "hymba-1.5b", "--shape", "prefill_32k", "--mesh",
                "single", "--no-surrogate", "--tag", "c2_logitsbf16",
                "--spec", '{"swa_impl": "banded", "logits_dtype": "bfloat16"}']
DRYRUN_HYMBA_TEMP = 16e9
#: phase 4e: each kernel's tolerance against its plain version (atol =
#: rtol; the reference's tests/test_kernels.py and
#: tests/test_linear_attention_kernel.py): fp32, and the low-precision one
#: (K3's calls are held to phase 4c's scaled limit instead)
GUARD_TOL = {"rmsnorm": (1e-5, 3e-2), "attention": (2e-4, 3e-2),
             "matmul": (1e-5, 3e-2), "linear_attention": (5e-4, 3e-2),
             "fastpath": (1e-6, 1e-6)}
#: phase 4e: calls of each K1 guard timed on the host
GUARD_TIMING_CALLS = 20000
#: phase 5's host ms a decode step in PR 15 (PERF.md section 5), printed
#: beside this run's as a record, not a gate
PR15_DECODE_HOST_MS = 115.2
#: the subprocess of phase 24b: the dry run's count of the phase-23 train
#: step on a fake world of one rank
DRYRUN_PROBE = r"""
import json, sys
import torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.optim import OptConfig

b, s = json.loads(sys.argv[1])
cfg = configs.get_config("qwen3-0.6b").replace(compute_dtype="float32")
shape = configs.Shape("phase23", "train", s, b)
dryrun.open_fake_world(1)
mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                  mesh_dim_names=("data", "model"))
a = dryrun.analyze(cfg, shape, mesh, {"sharding_profile": "fsdp"},
                   OptConfig(**json.loads(sys.argv[2])))
a["roofline"] = dryrun.roofline(cfg, shape, dryrun._roofline_input(a), 1)
print(json.dumps(a))
"""


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


#: idle host seconds on each side of a profiler window, doubled on each
#: retry: the profiler keeps only device activities whose timestamps lie
#: inside the host's window, and the device's clock can sit outside a window
#: that holds only the calls (as phase 23a found late in a long process)
PROFILE_PAD_S = 0.05


def profiled(fn, calls: int, attempts: int = 3):
    """``calls`` calls of ``fn`` under the profiler (device activities
    only), the wall seconds they took and the windows run.  Each window
    holds the calls between two idle pads (PROFILE_PAD_S, outside the wall
    time).  The profiler can drop a whole window's activities, so a window
    in which it saw nothing on the device is logged and run again with
    twice the pads, up to ``attempts`` times; then this fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for window in range(1, attempts + 1):
        pad = PROFILE_PAD_S * 2 ** (window - 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(pad)
        if any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.key_averages()):
            return prof, wall, window
        log(f"profiler: window {window} of {calls} call(s) saw no device "
            f"activity (pads {pad} s)")
    fail(f"the profiler saw no device activity in {attempts} windows")


def device_launches(fn, calls: int = 3) -> tuple[dict, float]:
    """What ``calls`` calls of ``fn`` launch on the card, by the profiler:
    device us a call by kernel (its name and template arguments) and
    launches a call, every device activity counted."""
    import torch

    prof, _, _ = profiled(fn, calls)
    us, launched = {}, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"\w+_kernel(<[^<>]*>)?", e.key)
        name = m.group(0) if m else e.key[:80]
        us[name] = us.get(name, 0.0) + e.self_device_time_total / calls
        launched += e.count
    return us, launched / calls


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
    from repro_torch.kernels.fastpath import kernel as fp_kernel
    from repro_torch.kernels.linear_attention import kernel as la_kernel
    from repro_torch.kernels.matmul import kernel as mm_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel

    libs = {"rmsnorm": rms_kernel.load_library,
            "flash_attention": attn_kernel.load_library,
            "linear_attention": la_kernel.load_library,
            "matmul": mm_kernel.load_library,
            "fastpath": fp_kernel.load_library}
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


def _rmsnorm_cost_of(shapes, itemsize: int) -> tuple[float, str]:
    """Least time (ms) on the card of one launch over tensors of
    ``shapes``: read each x once, write each out once, read each w once,
    against ~4 fp32 flops per element."""
    elems = sum(math.prod(sh) for sh in shapes)
    nbytes = 2 * elems * itemsize + sum(sh[-1] for sh in shapes) * 4
    flops = 4 * elems
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_rmsnorm(cfg) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import kernel, ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    checked = 0
    cases = [(s, False) for s in BUCKET_SHAPES + list(PREFILL_SHAPES)
             + list(PREFILL_PAIR) + list(RWKV_PREFILL_SHAPES) + TEST_SHAPES]
    # A contiguous view one element into its storage: its pointer is not
    # 16-byte aligned, so the kernel takes its scalar path.
    cases.append(((8, 1024), True))
    for shape, offset in cases:
        for dtype in KERNEL_DTYPES:
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
        f"({', '.join(KERNEL_DTYPES)}; bucket shapes {BUCKET_SHAPES}, "
        f"prefill shapes "
        f"{list(PREFILL_SHAPES) + list(PREFILL_PAIR)} and rwkv6 "
        f"{list(RWKV_PREFILL_SHAPES)}, test "
        f"shapes {TEST_SHAPES}, one misaligned view), "
        f"max_abs_err={max_err:.3e}")

    # The q/k pair in one launch, against two plain calls: the decode
    # step's (B, H, 1, dh) and the prefill's permuted einsum outputs,
    # which the kernel takes in storage order (no copy; same strides out).
    for (hq, hk, s_len, b), dtype in itertools.product(
            ((16, 8, 1, DECODE_BATCH), (16, 8, 4096, 1)), KERNEL_DTYPES):
        tdt = getattr(torch, dtype)
        q = torch.randn((b, s_len, hq, 128), generator=gen,
                        device=dev).to(tdt).transpose(1, 2)
        k = torch.randn((b, s_len, hk, 128), generator=gen,
                        device=dev).to(tdt).transpose(1, 2)
        wq = torch.randn(128, generator=gen, device=dev)
        wk = torch.randn(128, generator=gen, device=dev)
        before = kernel.launches
        outs = ops.rmsnorm_pair(q, wq, k, wk, impl="cuda")
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            fail(f"rmsnorm pair {tuple(q.shape)}: {kernel.launches - before}"
                 f" launches, wanted 1")
        for out, x, w in zip(outs, (q, k), (wq, wk)):
            if out.stride() != x.stride():
                fail(f"rmsnorm pair: output strides {out.stride()}, input "
                     f"{x.stride()}")
            ref = ops.rmsnorm(x, w, impl="torch_ref")
            torch.testing.assert_close(out.float(), ref.float(),
                                       rtol=TOL[dtype], atol=TOL[dtype])
            max_err = max(max_err,
                          (out.float() - ref.float()).abs().max().item())
            checked += 1
    log(f"rmsnorm: the q/k pair launch == two torch_ref calls at the decode "
        f"and prefill layouts, fp32, bf16 and fp16; max_abs_err="
        f"{max_err:.3e}")

    decode = _k1_decode_launches(cfg)
    log("rmsnorm: one full-width decode step at batch " f"{DECODE_BATCH} "
        f"makes {sum(decode.values())} K1 launches: " + ", ".join(
            f"{n} x {kind} {shapes}" for (kind, *shapes), n in
            decode.items()))

    per_shape = []
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bound_kinds = set()
    eps = 1e-6
    l2_bytes = torch.cuda.get_device_properties(dev).L2_cache_size
    launches = ([(kind_shapes, n, "decode step", "float32")
                 for kind_shapes, n in decode.items()]
                + [(("single", s), n, "(1, 4096) prefill", dtype)
                   for s, n in PREFILL_SHAPES.items()
                   for dtype in KERNEL_DTYPES]
                + [(("pair",) + PREFILL_PAIR, N_LAYERS, "(1, 4096) prefill",
                    "float32")]
                + [(("single", s), 0, "(1, 4096) prefill, a segment of its "
                    "pair alone", "float32") for s in PREFILL_PAIR]
                + [(("single", s), n, "(1, 4096) rwkv6 prefill", "float32")
                   for s, n in RWKV_PREFILL_SHAPES.items()])
    for (kind, *shapes), n, per, dtype in launches:
        # Successive calls read successive inputs of a ring three times the
        # L2 cache, so an input is evicted before it is read again and a
        # timing reads from HBM; a decode shape's ring (at most 64 inputs)
        # stays in L2, as its activations do on the serve path.
        tdt = getattr(torch, dtype)
        itemsize = torch.empty(0, dtype=tdt).element_size()
        x_bytes = sum(math.prod(sh) for sh in shapes) * itemsize
        n_ring = min(64, -(-3 * l2_bytes // x_bytes))
        l2_resident = n_ring * x_bytes < 3 * l2_bytes
        ring = itertools.cycle([
            [(torch.randn(sh, generator=gen, device=dev).to(tdt),
              torch.ones(sh[-1], device=dev)) for sh in shapes]
            for _ in range(n_ring)])
        if kind == "single":
            # F.rms_norm takes its weight in the rows' dtype (every weight
            # of the ring is ones, so one such weight stands for them)
            lib_w = torch.ones(shapes[0][-1], device=dev, dtype=tdt)
            fns = {"ms": lambda: kernel.rmsnorm_cuda(*next(ring)[0],
                                                     eps=eps),
                   "plain_ms": lambda: ops.ref.rmsnorm(*next(ring)[0], eps),
                   "library_ms": lambda: _f_rms_norm(
                       F, (next(ring)[0][0], lib_w), eps)}
        else:
            def pair_kernel():
                (x0, w0), (x1, w1) = next(ring)
                return kernel.rmsnorm_pair_cuda(x0, w0, x1, w1, eps=eps)

            fns = {"ms": pair_kernel,
                   "plain_ms": lambda: [ops.ref.rmsnorm(x, w, eps)
                                        for x, w in next(ring)],
                   "library_ms": lambda: [_f_rms_norm(F, xw, eps)
                                          for xw in next(ring)]}
        # Eager times are host-bound at the decode shapes, and the host's
        # clock moves between bursts: take the median of K1_ROUNDS rounds
        # that alternate the order of the three (forward, then reversed).
        rounds: dict[str, list[float]] = {k: [] for k in fns}
        for r in range(K1_ROUNDS):
            for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                rounds[k].append(cuda_time_ms(fns[k]))
        eager = {k: statistics.median(v) for k, v in rounds.items()}
        device = {k: graph_time_ms(f) for k, f in fns.items()}
        host_us = {k: 1e3 * (eager[k] - device[k]) for k in ("ms",
                                                              "library_ms")}
        bound, bkind = _rmsnorm_cost_of(shapes, itemsize)
        per_shape.append({"kind": kind, "shapes": [list(sh) for sh in shapes],
                          "dtype": dtype, "per": per,
                          "launches_per_call": n, **eager,
                          "eager_rounds": rounds,
                          "bound_ms": bound, "bound_by": bkind,
                          "device_only": device, "host_us": host_us,
                          "ring": n_ring, "l2_resident": l2_resident})
        log(f"rmsnorm {kind} {' + '.join(str(tuple(sh)) for sh in shapes)} "
            f"{dtype} x{n}/{per}, ring of {n_ring} inputs "
            f"({'in L2' if l2_resident else 'from HBM'}), eager: kernel "
            f"{eager['ms']:.5f} ms plain {eager['plain_ms']:.5f} ms "
            f"F.rms_norm {eager['library_ms']:.5f} ms; in a CUDA graph: "
            f"kernel {device['ms']:.5f} ms plain {device['plain_ms']:.5f} ms "
            f"F.rms_norm {device['library_ms']:.5f} ms; host us per launch "
            f"(eager - graph): kernel {host_us['ms']:.2f} F.rms_norm "
            f"{host_us['library_ms']:.2f}; bound {bound:.6f} ms ({bkind}, "
            f"{100 * bound / device['ms']:.1f}% of the kernel in a graph)")
        if per == "decode step":
            bound_kinds.add(bkind)
            totals["ms"] += n * eager["ms"]
            totals["plain_ms"] += n * eager["plain_ms"]
            totals["library_ms"] += n * eager["library_ms"]
            totals["bound_ms"] += n * bound
    n_decode = sum(decode.values())
    n_library = sum(n * (1 if kind == "single" else 2)
                    for (kind, *_), n in decode.items())
    log(f"rmsnorm: per decode step, eager (medians of {K1_ROUNDS} "
        f"alternating rounds): kernel {totals['ms']:.4f} ms "
        f"({n_decode} launches), F.rms_norm {totals['library_ms']:.4f} ms "
        f"({n_library} calls), plain {totals['plain_ms']:.4f} ms, bound "
        f"{totals['bound_ms']:.6f} ms")
    return {"max_abs_err": max_err, "per_shape": per_shape,
            "decode_launches": n_decode, "decode_library_calls": n_library,
            "decode_by_kind": {k: sum(n for (kind, *_), n in decode.items()
                                      if kind == k)
                               for k in ("single", "pair")},
            "bound_by": "bytes" if bound_kinds == {"bytes"}
            else "operations", **totals}


def _f_rms_norm(F, xw, eps):
    x, w = xw
    return F.rms_norm(x, (x.shape[-1],), w, eps)


def _k1_decode_launches(cfg) -> collections.Counter:
    """K1's launches on one decode step of the full-width model at batch
    DECODE_BATCH (random weights, the kernel for every norm), by kind and
    shapes, read from the wrappers as the model calls them."""
    import torch

    from repro_torch.kernels.rmsnorm import kernel
    from repro_torch.models import transformer as model
    from repro_torch.models.common import KernelOptions

    dev = torch.device("cuda")
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    opts = model.RunOptions(kernels=KernelOptions(rmsnorm_impl="cuda"))
    cache = model.init_cache(cfg, DECODE_BATCH, 16, opts, device=dev)
    tokens = torch.zeros(DECODE_BATCH, dtype=torch.int32, device=dev)
    pos = torch.zeros(DECODE_BATCH, dtype=torch.int32, device=dev)
    seen: collections.Counter = collections.Counter()
    single, pair = kernel.rmsnorm_cuda, kernel.rmsnorm_pair_cuda

    def record_single(x, w, **kw):
        seen[("single", tuple(x.shape))] += 1
        return single(x, w, **kw)

    def record_pair(x0, w0, x1, w1, **kw):
        seen[("pair", tuple(x0.shape), tuple(x1.shape))] += 1
        return pair(x0, w0, x1, w1, **kw)

    kernel.rmsnorm_cuda, kernel.rmsnorm_pair_cuda = record_single, record_pair
    try:
        model.decode_step(params, cache, tokens, pos, cfg, opts)
        torch.cuda.synchronize()
    finally:
        kernel.rmsnorm_cuda, kernel.rmsnorm_pair_cuda = single, pair
    del params, cache
    torch.cuda.empty_cache()
    return seen


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
    computes in fp32: TF32 stays off), the dense bf16/fp16 tensor-core
    peak for bf16 and fp16 ones."""
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

    from repro_torch.kernels import registry
    from repro_torch.kernels.attention import kernel, ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tiles = [(bq, bkv) for bq in kernel.BLOCK_Q for bkv in kernel.BLOCK_KV]
    b, h, hk, dh = ATTN_WIDTH
    hy_h, hy_hk, hy_d, hy_w = ATTN_HYMBA
    cases = ATTN_TEST_CASES + [((b, h, s, dh), (b, hk, s, dh),
                                (b, hk, s, dh), True, None)
                               for s in ATTN_LENGTHS] + ATTN_MLA_CASES + [
        ATTN_D18_CASE, ((b, hy_h, 2048, hy_d), (b, hy_hk, 2048, hy_d),
                        (b, hy_hk, 2048, hy_d), True, hy_w)]
    max_err = {dtype: 0.0 for dtype in KERNEL_DTYPES + ("mixed",)}
    checked = 0

    def check(out, ref, what: str, spread=None, dtypes=None) -> None:
        """Hold ``out`` to ``ref`` at the reference's tolerance and at the
        scaled one (plus rtol times ``spread``, the plain attention over
        |v|, in bf16 and fp16); fold its largest difference into
        ``max_err``.  For mixed ``dtypes`` (q, k, v) the tolerance is the
        loosest of theirs, the scaled one q's (the output's) with v's rtol
        on the spread (P is rounded to v's dtype)."""
        nonlocal checked
        dtype = str(ref.dtype).removeprefix("torch.")
        if out.shape != ref.shape or out.dtype != ref.dtype:
            fail(f"attention {what}: got {tuple(out.shape)} {out.dtype}, "
                 f"wanted {tuple(ref.shape)} {ref.dtype}")
        mixed = dtypes is not None and len(set(dtypes)) > 1
        tol = max(ATTN_TOL[d] for d in dtypes) if mixed else ATTN_TOL[dtype]
        torch.testing.assert_close(
            out.float(), ref.float(), rtol=tol, atol=tol,
            msg=lambda m: f"attention {what} (rtol {tol}, atol {tol}): {m}")
        rtol, atol = ATTN_SCALED_TOL[dtype]
        diff = (out.float() - ref.float()).abs()
        limit = atol + rtol * ref.float().abs()
        if spread is not None:
            p_rtol = ATTN_SCALED_TOL[dtypes[2]][0] if mixed else rtol
            limit += p_rtol * spread
        if not bool((diff <= limit).all()):
            fail(f"attention {what}: |out - ref| over the scaled limit "
                 f"(rtol {rtol}, atol {atol}) by "
                 f"{(diff - limit).max().item():.3e}")
        key = "mixed" if mixed else dtype
        max_err[key] = max(max_err[key], diff.max().item())
        checked += 1

    for q_s, k_s, v_s, causal, window in cases:
        for dtype in KERNEL_DTYPES:
            q, k, v = (torch.randn(s, generator=gen, device=dev).to(
                getattr(torch, dtype)) for s in (q_s, k_s, v_s))
            ref = ops.attention(q, k, v, causal=causal, window=window,
                                impl="torch_ref")
            spread = (ops.attention(q.float(), k.float(), v.float().abs(),
                                    causal=causal, window=window,
                                    impl="torch_ref")
                      if dtype != "float32" else None)
            for bq, bkv in tiles:
                out = ops.attention(q, k, v, causal=causal, window=window,
                                    impl="cuda", block_q=bq, block_kv=bkv)
                torch.cuda.synchronize()
                check(out, ref, f"{q_s} {dtype} causal={causal} "
                      f"window={window} tiles {bq}x{bkv}", spread)
            del ref, out, spread
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
    n_long = checked - n_short

    # The wider domain: every call one launch, no fallback; rows
    # the masks leave no column are 0 (the Pallas kernel's answer; the plain
    # version writes the mean of v there), every other row is held to the
    # plain version.
    counts = registry.default_registry.fallback_counts
    wb, wh, whk, ws = ATTN_WIDE_HEADS
    wide = [((dtype,) * 3, (wb, wh, ws, d), (wb, whk, ws, d),
             (wb, whk, ws, dv), True, None, None)
            for d, dv in ATTN_WIDE_DIMS for dtype in KERNEL_DTYPES]
    wide += [(dts, (wb, wh, ws, dh), (wb, whk, ws, dh), (wb, whk, ws, dh),
              True, 64, None) for dts in ATTN_MIXED]
    wide += [((dtype,) * 3, (wb, wh, 150, 64), (wb, whk, 100, 64),
              (wb, whk, 100, 64), causal, window, ATTN_WINDOW_OFFSET)
             for window in ATTN_WINDOWS for causal in (True, False)
             for dtype in KERNEL_DTYPES]
    zero_rows = 0
    for dts, q_s, k_s, v_s, causal, window, q_offset in wide:
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(
            getattr(torch, dt)) for s, dt in zip((q_s, k_s, v_s), dts))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        ref = ops.attention(q, k, v, impl="torch_ref", **kw)
        spread = (ops.attention(q.float(), k.float(), v.float().abs(),
                                impl="torch_ref", **kw)
                  if dts[2] != "float32" else None)
        sq, skv = q_s[2], k_s[2]
        pos = torch.arange(sq, device=dev) + (
            skv - sq if q_offset is None else q_offset)
        hi = pos.clamp(max=skv - 1) if causal else torch.full_like(pos,
                                                                   skv - 1)
        lo = ((pos - window + 1).clamp(min=0) if window is not None
              else torch.zeros_like(pos))
        rows = hi >= lo
        for bq, bkv in tiles:
            what = (f"{q_s}/{k_s}/{v_s} {'/'.join(dts)} causal={causal} "
                    f"window={window} q_offset={q_offset} tiles {bq}x{bkv}")
            l0, fb0 = kernel.launches, dict(counts)
            out = ops.attention(q, k, v, impl="cuda", block_q=bq,
                                block_kv=bkv, **kw)
            torch.cuda.synchronize()
            if kernel.launches != l0 + 1 or dict(counts) != fb0:
                fail(f"attention {what}: {kernel.launches - l0} launches, "
                     f"fallbacks {fb0} -> {dict(counts)}; wanted one launch "
                     f"and none")
            if bool(out[:, :, ~rows].any()):
                fail(f"attention {what}: a row with no valid column is not 0")
            zero_rows += int((~rows).sum())
            if bool(rows.any()):
                check(out[:, :, rows], ref[:, :, rows], what,
                      None if spread is None else spread[:, :, rows], dts)
            else:
                checked += 1
            del out
        del q, k, v, ref, spread
    torch.cuda.empty_cache()
    n_wide = checked - n_short - n_long
    log(f"attention: cuda == torch_ref at {n_short} case/dtype/tile cases "
        f"({len(ATTN_TEST_CASES)} reference test cases, full-width "
        f"prefill lengths {ATTN_LENGTHS}, MLA's head dims (192, 128) at "
        f"{[c[0] for c in ATTN_MLA_CASES]}, 36-byte rows at "
        f"{ATTN_D18_CASE[0]}, hymba's heads and window {ATTN_HYMBA} at "
        f"2048, tiles {tiles}), "
        f"{n_long} row slices ({r} rows at the start, middle and "
        f"end of S = {ATTN_LONG_LENGTHS}, fp32) and {n_wide} calls of the "
        f"wider domain, one launch each, no fallback (head dims "
        f"{ATTN_WIDE_DIMS} at {ATTN_WIDE_HEADS} in each dtype, mixed "
        f"{ATTN_MIXED} with window 64, windows {ATTN_WINDOWS} causal and "
        f"not at q_offset {ATTN_WINDOW_OFFSET}: {zero_rows} rows with no "
        f"valid column, each 0), within the reference's "
        f"tolerances {ATTN_TOL} and the scaled ones (rtol, atol) "
        f"{ATTN_SCALED_TOL}; max_abs_err fp32 {max_err['float32']:.3e}, "
        f"bf16 {max_err['bfloat16']:.3e}, fp16 {max_err['float16']:.3e}, "
        f"mixed {max_err['mixed']:.3e}")

    # The library's SASS: every half-precision instantiation is the wgmma
    # body and holds HGMMA instructions; no other half body is left.
    sass = _hgmma_by_function("flash_attention")
    wgmma_fns = {f: c for f, c in sass.items() if "fa_wgmma_kernel" in f}
    others = sorted(f for f in sass if f not in wgmma_fns
                    and "ring_kernel" not in f)
    log(f"attention: SASS of the built library: {len(wgmma_fns)} "
        f"fa_wgmma_kernel instantiations, HGMMA instructions in each: "
        f"{sorted(set(wgmma_fns.values()))}; "
        f"{len(sass) - len(wgmma_fns) - len(others)} ring_kernel "
        f"instantiations; other kernels {others}")
    n_wgmma = 2 * len(tiles) * len(ATTN_PADDED_DIMS)
    if (len(wgmma_fns) != n_wgmma or not all(wgmma_fns.values())
            or others):
        fail(f"attention: the library's half-precision bodies are not the "
             f"{n_wgmma} wgmma instantiations with HGMMA: {sass}")

    per_shape = []
    mla = ATTN_MLA_CASES[0]
    half = ("bfloat16", "float16")
    # (S, dtype, H, Hk, d, dv, window): the qwen3 prefill's heads by
    # length, then MLA's head dims, hymba's heads and window, and Gemma's
    # head dim on the qwen3 prefill's heads at 4096
    timed = [(s, "float32", h, hk, dh, dh, None) for s in ATTN_LENGTHS
             + ATTN_LONG_LENGTHS] + [(2048, "bfloat16", h, hk, dh, dh, None)] + [
        (PREFILL_SWEEP[1], dtype, h, hk, dh, dh, None) for dtype in half] + [
        (ATTN_MLA_TIMED, dtype, mla[0][1], mla[1][1], mla[0][3], mla[2][3],
         None) for dtype in ("float32",) + half] + [
        (ATTN_MLA_TIMED, dtype, hy_h, hy_hk, hy_d, hy_d, hy_w)
        for dtype in half] + [
        (ATTN_MLA_TIMED, dtype, h, hk, ATTN_WIDE_TIMED, ATTN_WIDE_TIMED, None)
        for dtype in ("float32",) + half]
    for s, dtype, hq, hkv, d, dv, window in timed:
        tdt = getattr(torch, dtype)
        q = torch.randn((b * hq, s, d), generator=gen, device=dev).to(tdt)
        k = torch.randn((b * hkv, s, d), generator=gen, device=dev).to(tdt)
        v = torch.randn((b * hkv, s, dv), generator=gen, device=dev).to(tdt)
        q4, k4, v4 = (x.view(b, -1, s, x.shape[-1]) for x in (q, k, v))
        # ~0.3 s of calls per timing at the largest shape
        iters = max(10, min(200, int(200 * (512 / s) ** 2)))
        warm = max(2, iters // 10)
        kernel_ms = {f"{bq}x{bkv}": cuda_time_ms(
            lambda bq=bq, bkv=bkv: kernel.flash_attention_cuda(
                q, k, v, window=window, block_q=bq, block_kv=bkv), iters,
            warm)
            for bq, bkv in tiles}
        bodies = {f"{bq}x{bkv}": kernel.body(tdt, d, dv, block_q=bq,
                                             block_kv=bkv)
                  for bq, bkv in tiles}
        for bq, bkv in tiles:
            x = bodies[f"{bq}x{bkv}"]
            x["kernels_us"], x["cuda_launches_per_call"] = device_launches(
                lambda bq=bq, bkv=bkv: kernel.flash_attention_cuda(
                    q, k, v, window=window, block_q=bq, block_kv=bkv))
            ctype = "__half" if dtype == "float16" else "__nv_bfloat16"
            want = (f"ring_kernel<{bq},{bkv}," if x["body"] == "ring"
                    else f"fa_wgmma_kernel<{ctype},{bq},{bkv},")
            if not any(want in n.replace(" ", "") for n in x["kernels_us"]):
                fail(f"attention {s} {dtype} tiles {bq}x{bkv}: reported "
                     f"the {x['body']} body, launched {x['kernels_us']}")
        # The plain version holds a few (B, H, S, S) fp32 score tensors.
        plain_bytes = 4 * b * hq * s * s * 4
        if plain_bytes < torch.cuda.mem_get_info()[0] / 2:
            plain = cuda_time_ms(lambda: ops.ref.attention(
                q4, k4, v4, window=window), iters, warm)
        else:
            log(f"attention: plain not timed at {s}: it would hold ~"
                f"{plain_bytes / 1e9:.0f} GB of scores")
            plain = None
        if window is None:
            mask = None
        else:
            pos = torch.arange(s, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & (
                pos[None, :] > pos[:, None] - window)
        try:
            library = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True), iters, warm)
        except RuntimeError as e:            # timed only, used nowhere
            log(f"attention: sdpa not timed at {s} {dtype}: {e}")
            library = None
            torch.cuda.empty_cache()
        bound, kind = _attention_cost(b, hq, hkv, s, s, d, dv,
                                      q.element_size(), True, window)
        best = min(kernel_ms, key=kernel_ms.get)
        previous = (K2_PREVIOUS_MS.get((dtype, s))
                    if (hq, hkv, d, dv) == (h, hk, dh, dh) else None)
        per_shape.append({"shape": [b, hq, hkv, s, d, dv], "dtype": dtype,
                          "window": window,
                          "kernel_ms_by_tiles": kernel_ms,
                          "body_by_tiles": bodies, "plain_ms": plain,
                          "library_ms": library, "bound_ms": bound,
                          "bound_by": kind, "previous_ms": previous})
        log(f"attention (1,{hq}/{hkv},{s},{d}/{dv}) {dtype} causal, window "
            f"{window}, {bodies[best]['body']} body, "
            f"{bodies[best]['cuda_launches_per_call']:g} CUDA launches a "
            f"call ({', '.join(bodies[best]['kernels_us'])}): kernel "
            + " ".join(f"{t} {ms:.4f} ({100 * bound / ms:.1f}%)"
                       for t, ms in kernel_ms.items())
            + f" ms (% of the bound; best {best}); previous design "
            f"{'at 128x64 ' if dtype == 'float32' else ''}{previous} "
            f"ms; plain {plain} ms; sdpa {library} ms"
            + (f" ({kernel_ms[best] / library:.2f}x the best tiles)"
               if library else "")
            + f"; bound {bound:.4f} ms "
            f"({kind}); shared memory a block "
            + " ".join(f"{t} {x['smem_bytes']} B/{x['stages']} stages"
                       for t, x in bodies.items()))
        del q, k, v, q4, k4, v4, mask
    torch.cuda.empty_cache()
    return {"max_abs_err": max(max_err.values()),
            "max_abs_err_by_dtype": max_err, "checked": checked,
            "wide_checked": n_wide, "per_shape": per_shape}


def _linatt_cost(bh: int, t: int, dk: int, dv: int, chunk: int,
                 itemsize: int, inclusive: bool,
                 bonus: bool) -> tuple[float, str]:
    """Least time (ms) on the card: q, k and v read once (``itemsize``),
    the fp32 log_w and bonus read once, out written once; against the
    products the chunked form needs on this length: per chunk of n tokens,
    a dk-long score and a dv-long intra product for each (query, key) pair
    under the mask (n(n-1)/2 strict, plus the diagonal when inclusive or
    with the bonus; the masked-out half of the c x c tiles is not counted),
    and per token the inter (q S) and state (k^T v) products of dk x dv;
    2 flops a multiply-add, at the fp32 FMA peak for fp32 inputs (the
    reference computes in fp32: TF32 stays off) and at the dense bf16/fp16
    tensor-core peak for half-precision ones, the least time the card
    could take for them."""
    nbytes = (itemsize * bh * t * (2 * dk + 2 * dv) + 4 * bh * t * dk
              + (4 * bh * dk if bonus else 0))
    diag = inclusive or bonus

    def pairs(n: int) -> int:
        return n * (n + 1) // 2 if diag else n * (n - 1) // 2

    n_pairs = (t // chunk) * pairs(chunk) + pairs(t % chunk)
    flops = 2 * bh * (n_pairs * (dk + dv) + 2 * t * dk * dv)
    peak = PEAK_FP32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_linear_attention() -> dict:
    """K4 against its plain version at every chunk, then timed."""
    import torch

    from repro_torch.kernels import registry
    from repro_torch.kernels.linear_attention import kernel, ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    max_err = {dtype: 0.0 for dtype in KERNEL_DTYPES + ("mixed",)}
    checked = 0

    def inputs(bh, t, dk, dv, bonus, scalar, dtype):
        """q, k, v of ``dtype`` (or of the dtypes "q-k-v"), log_w of q's
        dtype, the fp32 bonus or None."""
        dts = dtype.split("-") if "-" in dtype else [dtype] * 3
        tdt = getattr(torch, dts[0])
        q, k = (torch.randn((bh, t, dk), generator=gen, device=dev).to(
            getattr(torch, dt)) for dt in dts[:2])
        v = torch.randn((bh, t, dv), generator=gen, device=dev).to(
            getattr(torch, dts[2]))
        lw = -torch.rand((bh, t, 1 if scalar else dk), generator=gen,
                         device=dev).clamp(1e-4, 1.0).to(tdt)
        u = (torch.randn((bh, dk), generator=gen, device=dev) if bonus
             else None)
        return q, k, v, lw, u

    def check(out, ref, what: str, dtypes=None) -> None:
        """``out`` against ``ref`` within the reference's tolerance and the
        scaled one; for mixed ``dtypes`` (q, k, v) the loosest tolerance
        of theirs and the scaled one of v's (the output's) plus fp32's:
        both sides compute in fp32 on the same values."""
        nonlocal checked
        dtype = str(ref.dtype).removeprefix("torch.")
        if out.shape != ref.shape or out.dtype != ref.dtype:
            fail(f"linear attention {what}: got {tuple(out.shape)} "
                 f"{out.dtype}, wanted {tuple(ref.shape)} {ref.dtype}")
        tol = LINATT_TOL[dtype]
        rtol, atol = LINATT_SCALED_TOL[dtype]
        if dtypes is not None:
            tol = max(LINATT_TOL[d] for d in dtypes)
            rtol += LINATT_SCALED_TOL["float32"][0] * (dtype != "float32")
        for rt, at in ((tol, tol), (rtol, atol)):
            torch.testing.assert_close(
                out.float(), ref.float(), rtol=rt, atol=at,
                msg=lambda m: f"linear attention {what} (rtol {rt}, atol "
                              f"{at}): {m}")
        err = (out.float() - ref.float()).abs().max().item()
        key = "mixed" if dtypes is not None else dtype
        max_err[key] = max(max_err[key], err)
        checked += 1

    for bh, t, dk, dv, inclusive, bonus, scalar in (LINATT_TEST_CASES
                                                    + LINATT_WIDE_CASES):
        for dtype in KERNEL_DTYPES:
            q, k, v, lw, u = inputs(bh, t, dk, dv, bonus, scalar, dtype)
            for chunk in kernel.CHUNKS:
                kw = dict(bonus=u, inclusive=inclusive, chunk=chunk)
                ref = ops.linear_attention(q, k, v, lw, impl="torch_ref",
                                           **kw)
                out = ops.linear_attention(q, k, v, lw, impl="cuda", **kw)
                torch.cuda.synchronize()
                check(out, ref, f"({bh},{t},{dk},{dv}) {dtype} "
                      f"inclusive={inclusive} bonus={bonus} "
                      f"scalar_decay={scalar} chunk {chunk}")
                del ref, out
            del q, k, v, lw, u
    torch.cuda.empty_cache()
    n_short = checked

    # The wider domain: GLA's heads and wide keys with narrow values in
    # every dtype, and a mixed triple, each call one launch and no
    # fallback.
    counts = registry.default_registry.fallback_counts
    mixed = "-".join(LINATT_MIXED)
    wide = [(case, dtype) for case in LINATT_GLA_CASES
            for dtype in KERNEL_DTYPES] + [(LINATT_WIDE_CASES[0], mixed)]
    for (bh, t, dk, dv, inclusive, bonus, scalar), dtype in wide:
        q, k, v, lw, u = inputs(bh, t, dk, dv, bonus, scalar, dtype)
        if dtype == mixed:
            lw = lw.float()
        for chunk in kernel.CHUNKS:
            kw = dict(bonus=u, inclusive=inclusive, chunk=chunk)
            what = (f"({bh},{t},{dk},{dv}) {dtype} inclusive={inclusive} "
                    f"bonus={bonus} chunk {chunk}")
            ref = ops.linear_attention(q, k, v, lw, impl="torch_ref", **kw)
            l0, fb0 = kernel.launches, dict(counts)
            out = ops.linear_attention(q, k, v, lw, impl="cuda", **kw)
            torch.cuda.synchronize()
            if kernel.launches != l0 + 1 or dict(counts) != fb0:
                fail(f"linear attention {what}: {kernel.launches - l0} "
                     f"launches, fallbacks {fb0} -> {dict(counts)}; wanted "
                     f"one launch and none")
            check(out, ref, what,
                  LINATT_MIXED if dtype == mixed else None)
            del ref, out
        del q, k, v, lw, u
    torch.cuda.empty_cache()
    n_wide = checked - n_short
    log(f"linear attention: cuda == torch_ref at {n_short} case/dtype/chunk "
        f"cases ({len(LINATT_TEST_CASES)} reference test cases and "
        f"(bh, T, dk, dv) {[c[:4] for c in LINATT_WIDE_CASES]}, whole; "
        f"chunks {kernel.CHUNKS}) and {n_wide} calls of the wider domain, "
        f"one launch each, no fallback (wide heads "
        f"{[c[:5] for c in LINATT_GLA_CASES]} in each dtype, mixed "
        f"{LINATT_MIXED} at {LINATT_WIDE_CASES[0][:4]}), within the "
        f"reference's tolerances {LINATT_TOL} "
        f"and the scaled ones (rtol, atol) {LINATT_SCALED_TOL}; max_abs_err "
        f"fp32 {max_err['float32']:.3e}, bf16 {max_err['bfloat16']:.3e}, "
        f"fp16 {max_err['float16']:.3e}, mixed {max_err['mixed']:.3e}")

    per_shape = []
    timed_cases = [(c, "float32") for c in LINATT_WIDE_CASES] + [
        (LINATT_WIDE_CASES[1], dtype) for dtype in ("bfloat16", "float16")] + [
        (LINATT_GLA_TIMED + (True, False, False), dtype)
        for dtype in KERNEL_DTYPES]
    prefill_case = (RWKV_HEADS, RWKV_SWEEP[1], RWKV_HEAD, RWKV_HEAD)
    for (bh, t, dk, dv, inclusive, bonus, scalar), dtype in timed_cases:
        q, k, v, lw, u = inputs(bh, t, dk, dv, bonus, scalar, dtype)
        lw = lw.to(torch.float32).expand(q.shape).contiguous()
        iters = max(10, min(100, 100 * 4096 // t))
        plain_iters = max(3, iters // 10)
        kernel_ms, plain_ms, bound_ms, bound_by = {}, {}, {}, {}
        for c in kernel.CHUNKS:
            kernel_ms[str(c)] = cuda_time_ms(
                lambda c=c: kernel.linear_attention_cuda(
                    q, k, v, lw, u, inclusive=inclusive, chunk=c),
                iters, max(2, iters // 10))
            # the plain entry clamps a chunk that does not divide T
            plain_ms[str(c)] = cuda_time_ms(
                lambda c=c: ops.linear_attention(
                    q, k, v, lw, bonus=u, inclusive=inclusive, chunk=c,
                    impl="torch_ref"), plain_iters, 1)
            bound_ms[str(c)], bound_by[str(c)] = _linatt_cost(
                bh, t, dk, dv, c, q.element_size(), inclusive, bonus)
        previous = ({str(c): K4_PREVIOUS_MS[c] for c in kernel.CHUNKS}
                    if ((bh, t, dk, dv), dtype) == (prefill_case, "float32")
                    else None)
        # Where a call's device time goes among its CUDA launches (at the
        # prefill path's shape): summary, fold, outputs.
        launch_us, cuda_launches = None, None
        if ((bh, t, dk, dv), dtype) == (prefill_case, "float32"):
            launch_us, cuda_launches = {}, {}
            for c in kernel.CHUNKS:
                launch_us[str(c)], cuda_launches[str(c)] = device_launches(
                    lambda c=c: kernel.linear_attention_cuda(
                        q, k, v, lw, u, inclusive=inclusive, chunk=c), 10)
        per_shape.append({"shape": [bh, t, dk, dv], "dtype": dtype,
                          "inclusive": inclusive, "bonus": bonus,
                          "kernel_ms_by_chunk": kernel_ms,
                          "plain_ms_by_chunk": plain_ms,
                          "bound_ms_by_chunk": bound_ms,
                          "bound_by_chunk": bound_by,
                          "library_ms": None,
                          "cuda_launches_per_call_by_chunk": cuda_launches,
                          "launch_us_by_chunk": launch_us})
        log(f"linear attention ({bh},{t},{dk},{dv}) {dtype} "
            f"{'inclusive' if inclusive else 'exclusive'}"
            f"{' +bonus' if bonus else ''}, chunk-parallel body: kernel "
            + " ".join(f"c{c} {ms:.4f} ({100 * bound_ms[c] / ms:.1f}%)"
                       for c, ms in kernel_ms.items())
            + " ms (% of the bound); previous design "
            + (" ".join(f"c{c} {ms}" for c, ms in previous.items())
               if previous else "not timed at this shape")
            + " ms; plain " + " ".join(f"c{c} {ms:.3f}"
                                       for c, ms in plain_ms.items())
            + " ms; bound " + " ".join(f"c{c} {ms:.4f} ({bound_by[c]})"
                                       for c, ms in bound_ms.items())
            + " ms")
        if launch_us:
            for c, per in launch_us.items():
                log(f"  chunk {c}: {cuda_launches[c]:g} CUDA launches a "
                    f"call; device us a call by launch "
                    + ", ".join(f"{n} {us:.1f}" for n, us in per.items()))
        del q, k, v, lw, u
    torch.cuda.empty_cache()
    return {"max_abs_err": max(max_err.values()),
            "max_abs_err_by_dtype": max_err, "checked": checked,
            "wide_checked": n_wide, "per_shape": per_shape}


def _matmul_cost(m: int, k: int, n: int, itemsize: int,
                 out_itemsize: int) -> tuple[float, str]:
    """Least time (ms) on the card: x and y read once, out written once,
    against 2mnk flops at the fp32 FMA peak for fp32 inputs and at the
    tensor-core peak (bf16 and fp16 alike) for half ones."""
    nbytes = (m * k + k * n) * itemsize + m * n * out_itemsize
    peak = PEAK_FP32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, 2 * m * n * k / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _matmul_limit(x, y, ref):
    """The per-element limit of the card's shapes (MATMUL_SCALED_FACTOR)."""
    import torch

    k = x.shape[1]
    mag = x.float().abs() @ y.float().abs()
    limit = MATMUL_SCALED_FACTOR * k ** 0.5 * 2.0 ** -24 * mag + 1e-6
    ulp = HALF_ULP.get(str(ref.dtype).removeprefix("torch."))
    if ulp:
        limit += ulp * ref.float().abs()
    return limit


def phase_matmul() -> dict:
    """K3 against its plain version at every tile triple and dtype class,
    then timed with the plain version and cuBLAS (``torch.matmul``, TF32
    off)."""
    import torch

    from repro_torch.kernels.matmul import kernel, ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    max_err = {"float32": 0.0, "bfloat16": 0.0, "float16": 0.0}
    checked = 0

    def rand(r, c, dtype):
        return torch.randn((r, c), generator=gen, device=dev).to(
            getattr(torch, dtype))

    def inputs(m, k, n, dtype, y_dtype=None):
        return rand(m, k, dtype), rand(k, n, y_dtype or dtype)

    def check(out, ref, limit, what: str, tol: float | None) -> None:
        nonlocal checked
        dtype = str(ref.dtype).removeprefix("torch.")
        if out.shape != ref.shape or out.dtype != ref.dtype:
            fail(f"matmul {what}: got {tuple(out.shape)} {out.dtype}, "
                 f"wanted {tuple(ref.shape)} {ref.dtype}")
        if tol is not None:
            torch.testing.assert_close(
                out.float(), ref.float(), rtol=tol, atol=tol,
                msg=lambda m: f"matmul {what} (tolerance {tol}): {m}")
        diff = (out.float() - ref.float()).abs()
        if not bool((diff <= limit).all()):
            fail(f"matmul {what}: beyond the scaled limit by "
                 f"{(diff - limit).max().item():.3e}")
        max_err[dtype] = max(max_err[dtype], diff.max().item())
        checked += 1

    bodies: collections.Counter = collections.Counter()
    by_class: collections.Counter = collections.Counter()
    card_bf16 = [("bfloat16", "bfloat16", None),
                 ("bfloat16", "bfloat16", "float32")]
    for shapes, classes, scaled_only, offset in (
            (MATMUL_TEST_SHAPES, MATMUL_CLASSES, False, 0),
            (MATMUL_TEST_SHAPES[3:4], MATMUL_CLASSES[:5], False, 1),
            (MATMUL_CARD_SHAPES, [MATMUL_CLASSES[0], *card_bf16,
                                  *MATMUL_CARD_CLASSES], True, 0)):
        for (m, k, n), (dtype, y_dtype, out_dtype) in itertools.product(
                shapes, classes):
            x, y = inputs(m, k, n, dtype, y_dtype)
            if offset:
                # a contiguous view one element into its storage: no
                # 16-byte-aligned rows, so the 4-byte-copy or simt body
                x = torch.cat([x.flatten()[:offset], x.flatten()])[
                    offset:].view(m, k)
                if x.data_ptr() % 16 == 0:
                    fail("the offset view is 16-byte aligned")
            odt = getattr(torch, out_dtype or dtype)
            ref = ops.matmul(x, y, impl="torch_ref", out_dtype=odt)
            limit = _matmul_limit(x, y, ref)
            tol = None if scaled_only else max(
                MATMUL_TOL[d] for d in (dtype, y_dtype, out_dtype or dtype))
            cls = f"{dtype}x{y_dtype}->{out_dtype or dtype}"
            if not scaled_only:
                tiles_list = kernel.TILES
            elif (dtype, y_dtype) == ("float32", "float32") \
                    and out_dtype is None:
                tiles_list = kernel.TILES   # the test tiles too, in fp32
            elif dtype == y_dtype and dtype != "float32":
                tiles_list = kernel.CARD_TILES
            else:                           # the fp32 body: one triple
                tiles_list = (kernel.DEFAULT_TILES,)
            for bm, bn, bk in tiles_list:
                div = m % bm == 0 and n % bn == 0 and k % bk == 0
                body = kernel.body(x, y, bm=bm, bn=bn, bk=bk, out_dtype=odt)
                for assume in (False, True) if div else (False,):
                    before = kernel.launches
                    out = ops.matmul(x, y, bm=bm, bn=bn, bk=bk, impl="cuda",
                                     out_dtype=odt, assume_divisible=assume)
                    torch.cuda.synchronize()
                    what = (f"({m},{k})x({k},{n}) {cls} tiles "
                            f"({bm},{bn},{bk}) assume_divisible={assume} "
                            f"offset {offset} ({body} body)")
                    if kernel.launches != before + 1:
                        fail(f"matmul {what}: {kernel.launches - before} "
                             f"launches, wanted 1")
                    check(out, ref, limit, what, tol)
                    bodies[body] += 1
                    by_class[cls] += 1
                    del out
            del x, y, ref, limit
    torch.cuda.empty_cache()
    log(f"matmul: cuda == torch_ref at {checked} shape/dtype/tile cases, "
        f"one launch each (the reference's test shapes at every tile "
        f"triple {kernel.TILES} in every (x, y, out) class "
        f"{[c[:2] + (c[2] or c[0],) for c in MATMUL_CLASSES]} within "
        f"{MATMUL_TOL} (the loosest of the three dtypes), one of them also "
        f"as a view one element into its storage; (m, k, n) "
        f"{MATMUL_CARD_SHAPES} within {MATMUL_SCALED_FACTOR} sqrt(K) 2^-24 "
        f"sum|x||y| (+ one ulp of a half output); both assume_divisible "
        f"settings where the shape divides); cases by body "
        f"{json.dumps(bodies)}; by class {json.dumps(by_class)}; "
        f"max_abs_err fp32 {max_err['float32']:.3e}, bf16 "
        f"{max_err['bfloat16']:.3e}, fp16 {max_err['float16']:.3e}")
    sass = _hgmma_by_function()
    wgmma_fns = {f: c for f, c in sass.items() if "wgmma_kernel" in f}
    # wgmma_kernel<TIn, ...>: __half mangles as 6__half
    f16_fns = {f: c for f, c in wgmma_fns.items() if "6__half" in f}
    log(f"matmul: SASS of the built library: {len(wgmma_fns)} wgmma_kernel "
        f"instantiations ({len(f16_fns)} fp16, "
        f"{len(wgmma_fns) - len(f16_fns)} bf16), HGMMA instructions in "
        f"each: {sorted(set(wgmma_fns.values()))} (fp16: "
        f"{sorted(set(f16_fns.values()))}); {sum(sass.values())} HGMMA in "
        f"all, {sum(c for f, c in sass.items() if f not in wgmma_fns)} "
        f"outside the wgmma body")
    if not wgmma_fns or not all(wgmma_fns.values()):
        fail("a wgmma body has no HGMMA instruction in its SASS")
    if len(f16_fns) != len(wgmma_fns) // 2 or not f16_fns:
        fail(f"matmul: {len(f16_fns)} fp16 wgmma instantiations of "
             f"{len(wgmma_fns)}; wanted half of them")

    per_shape = []
    half_timed = ((TABLE1_N,) * 3, MATMUL_CARD_SHAPES[-1])
    timed = [(s, "float32") for s in MATMUL_CARD_SHAPES] + [
        (s, dt) for dt in ("bfloat16", "float16") for s in half_timed]
    log(f"matmul: torch.backends.cuda.matmul."
        f"allow_fp16_reduced_precision_reduction = "
        f"{torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction}"
        f", allow_bf16_reduced_precision_reduction = "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}"
        f" (cuBLAS's half products)")
    for (m, k, n), dtype in timed:
        x, y = inputs(m, k, n, dtype)
        iters = max(3, min(200, int(4e10 / (2 * m * n * k))))
        tiles_list = (kernel.TILES if dtype == "float32" else
                      kernel.CARD_TILES)
        kernel_ms = {}
        for bm, bn, bk in tiles_list:
            div = m % bm == 0 and n % bn == 0 and k % bk == 0
            kernel_ms[f"{bm}x{bn}x{bk}"] = cuda_time_ms(
                lambda t=(bm, bn, bk), d=div: kernel.matmul_cuda(
                    x, y, bm=t[0], bn=t[1], bk=t[2], assume_divisible=d),
                iters, max(1, iters // 10))
        plain_ms = cuda_time_ms(
            lambda: ops.matmul(x, y, impl="torch_ref"), iters,
            max(1, iters // 10))
        library_ms = cuda_time_ms(lambda: torch.matmul(x, y), iters,
                                  max(1, iters // 10))
        bound_ms, bound_by = _matmul_cost(m, k, n, x.element_size(),
                                          x.element_size())
        best = min(kernel_ms, key=kernel_ms.get)
        per_shape.append({"shape": [m, k, n], "dtype": dtype,
                          "kernel_ms_by_tiles": kernel_ms,
                          "body_by_tiles": {
                              f"{bm}x{bn}x{bk}": kernel.body(
                                  x, y, bm=bm, bn=bn, bk=bk)
                              for bm, bn, bk in tiles_list},
                          "plain_ms": plain_ms, "library_ms": library_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by})
        log(f"matmul ({m},{k})x({k},{n}) {dtype}: kernel "
            + " ".join(f"{t} {ms:.4f}" for t, ms in kernel_ms.items())
            + f" ms (best {best}: {2e-9 * m * n * k / kernel_ms[best]:.1f} "
            f"TFLOP/s, {100 * bound_ms / kernel_ms[best]:.1f}% of the "
            f"bound); plain {plain_ms:.4f} ms; cuBLAS {library_ms:.4f} ms "
            f"({2e-9 * m * n * k / library_ms:.1f} TFLOP/s); bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        del x, y
    torch.cuda.empty_cache()
    return {"max_abs_err": max(max_err.values()),
            "max_abs_err_by_dtype": max_err, "checked": checked,
            "bodies": dict(bodies), "by_class": dict(by_class),
            "hgmma_by_function": wgmma_fns, "per_shape": per_shape}


def _hgmma_by_function(library: str = "matmul") -> dict:
    """HGMMA (wgmma) instructions in the SASS of each kernel of a built
    kernel library, by mangled name (``cuobjdump -sass``)."""
    from repro_torch import compat
    from repro_torch.kernels import build

    cuobjdump = Path(compat.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", build.build_log(library)["path"]],
        capture_output=True, text=True, timeout=300, check=True).stdout
    counts: dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    return counts


def _fastpath_cost(b: int, n: int, kw: int, v: int, key_itemsize: int,
                   value_itemsize: int) -> tuple[float, str]:
    """Least time (ms) on the card for the function's bytes: queries, keys
    and values read once, out, hit and the miss count written once.  The
    B * N * K compares are one body's work, not the function's (the hashed
    body does not make them), so they bound nothing."""
    nbytes = ((b + n) * kw * key_itemsize + (n + b) * v * value_itemsize
              + b + 4)
    return nbytes / PEAK_BYTES_S * 1e3, "bytes"


def _colliding_keys(n: int, rs) -> "np.ndarray":
    """``n`` int32 keys (K = 1) whose hashes all fall in one slot of the
    table ``prepare_table`` builds for ``n`` keys (one probe chain)."""
    import numpy as np

    from repro_torch.kernels.fastpath import kernel

    size = 2
    while size < 2 * n:
        size *= 2
    cand = rs.permutation(8 * n * size).astype(np.int64)[:, None]
    slot = kernel.hash_keys(cand) & np.uint64(size - 1)
    same = cand[slot == np.bincount(slot.astype(np.int64)).argmax()]
    if len(same) < 2 * n:
        fail(f"fastpath: found {len(same)} keys of one slot, need {2 * n}")
    return same.astype(np.int32)


def phase_fastpath() -> dict:
    """K5 against its plain version on both bodies (the raw table through
    the op, the prepared table on each body and on the one the kernel
    picks), exact for integer values, the miss count against the plain
    hit count; then timed, eager and in a CUDA graph."""
    import numpy as np
    import torch

    from repro_torch.kernels.fastpath import kernel, ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    rs = np.random.RandomState(6)
    checked = 0
    max_err = 0.0

    def inputs(b, n, kw, v, vdtype, kdtype=torch.int32, hot=0.5,
               key_range=None):
        """Keys from a range of about N / 2 values (so some repeat); about
        ``hot`` of the queries drawn from the keys, the rest from the
        range (mostly misses)."""
        hi = key_range or max(2, n // 2)
        keys = torch.randint(0, hi, (n, kw), generator=gen, device=dev)
        x = torch.randint(0, max(2, 2 * hi), (b, kw), generator=gen,
                          device=dev)
        if n:
            pick = torch.rand((b,), generator=gen, device=dev) < hot
            rows = torch.randint(0, n, (b,), generator=gen, device=dev)
            x = torch.where(pick[:, None], keys[rows], x)
        return x.to(kdtype), keys.to(kdtype), values(n, v, vdtype)

    def values(n, v, vdtype):
        if vdtype.is_floating_point:
            return torch.randn((n, v), generator=gen, device=dev).to(vdtype)
        return torch.randint(-2 ** 30, 2 ** 30, (n, v), generator=gen,
                             device=dev).to(vdtype)

    readback = kernel.MissReadback()

    def compare(out, hit, miss, ref, ref_hit, what):
        nonlocal max_err
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != ref.dtype \
                or hit.dtype != torch.bool:
            fail(f"fastpath {what}: got {tuple(out.shape)} {out.dtype}, "
                 f"hit {hit.dtype}")
        if not torch.equal(hit, ref_hit):
            fail(f"fastpath {what}: hit differs at "
                 f"{int((hit != ref_hit).sum())} rows")
        if miss is not None and miss != int((~ref_hit).sum()):
            fail(f"fastpath {what}: miss count {miss}, the plain version "
                 f"misses {int((~ref_hit).sum())} rows")
        if ref.dtype.is_floating_point:
            # fp16 values: one ulp of the output (both round one fp32 sum,
            # added in their own orders)
            rtol = HALF_ULP["float16"] if ref.dtype == torch.float16 \
                else FASTPATH_TOL
            torch.testing.assert_close(
                out.float(), ref.float(), rtol=rtol,
                atol=FASTPATH_TOL, msg=lambda m: f"fastpath {what}: {m}")
            if out.numel():
                max_err = max(max_err,
                              (out.float() - ref.float()).abs().max().item())
        elif not torch.equal(out, ref):
            fail(f"fastpath {what}: integer sums differ at "
                 f"{int((out != ref).any(-1).sum())} rows")

    def check(x, keys, vals, block_b, what):
        """The raw table through the op (the dense body), the prepared
        table through the op (the body the kernel picks) and on each body
        with its miss count."""
        nonlocal checked
        ref, ref_hit = ops.lookup(x, keys, vals, impl="torch_ref")
        compare(*ops.lookup(x, keys, vals, block_b=block_b, impl="cuda"),
                None, ref, ref_hit, f"{what} raw")
        table = kernel.prepare_table(keys, vals)
        compare(*ops.lookup(x, keys, vals, block_b=block_b, impl="cuda",
                            prepared=table), None, ref, ref_hit,
                f"{what} prepared")
        for body in kernel.BODIES:
            out, hit = kernel.fastpath_cuda_prepared(
                x, table, block_b=block_b, body=body, readback=readback)
            compare(out, hit, readback.misses, ref, ref_hit,
                    f"{what} prepared, {body} body")
        checked += 1
        return ref_hit

    value_dtypes = (torch.float32, torch.bfloat16, torch.float16,
                    torch.int32, torch.int64)
    for (b, n, kw, v), vdt, kdt, block_b in itertools.product(
            FASTPATH_TEST_CASES, value_dtypes,
            (torch.int32, torch.int64, torch.int8), FASTPATH_BLOCK_B):
        x, keys, vals = inputs(b, n, kw, v, vdt, kdt, key_range=10)
        check(x, keys, vals, block_b, f"({b},{n},{kw},{v}) {vdt} keys {kdt} "
              f"block_b {block_b}")
    router_tables = sorted(set(FASTPATH_TABLES) | set(FASTPATH_THRESHOLD))
    for b, n, (vdt, v) in itertools.product(
            FASTPATH_BATCHES, router_tables,
            ((torch.int32, 1), (torch.float32, 16))):
        x, keys, vals = inputs(b, n, 1, v, vdt)
        for block_b in FASTPATH_BLOCK_B:
            check(x, keys, vals, block_b,
                  f"({b},{n},1,{v}) {vdt} block_b {block_b}")
    # a table whose keys all repeat (pairs with different values) and a
    # batch that misses every key
    x, keys, vals = inputs(8192, 256, 1, 16, torch.float32)
    keys = torch.cat([keys[:128], keys[:128]])
    check(x, keys, vals, 256, "duplicate keys")
    x, keys, vals = inputs(8192, 4096, 1, 1, torch.int32, hot=0.0)
    if check(x, keys - 2 ** 20, vals, 256, "all miss").any():
        fail("fastpath: the all-miss batch hit")
    # a table whose keys all hash to one slot (one probe chain of 128),
    # queried with its keys and with keys of the same slot it lacks
    same = torch.as_tensor(_colliding_keys(128, rs), device=dev)
    keys, absent = same[:128].contiguous(), same[128:]
    pick = torch.randint(0, 128, (8192,), generator=gen, device=dev)
    x = torch.where((torch.arange(8192, device=dev) % 2 == 0)[:, None],
                    keys[pick], absent[pick]).contiguous()
    check(x, keys, values(128, 16, torch.float32), 256, "one probe chain")
    # int64 keys that differ only in their high 32 bits
    high = (torch.arange(1, 257, device=dev, dtype=torch.int64) << 32) | 12345
    keys = high[:, None].contiguous()
    x = torch.cat([keys, keys + (1000 << 32), keys & 0xFFFFFFFF])
    x = x[torch.randperm(x.shape[0], generator=gen, device=dev)].contiguous()
    if int(check(x, keys, values(256, 2, torch.int64), 256,
                 "int64 keys apart in the high bits").sum()) != 256:
        fail("fastpath: the high-bit int64 keys did not hit exactly once")
    base_checked = checked
    # The domain past int32/int64 keys of one dtype, 32 wide, block_b in
    # FASTPATH_BLOCK_B: float keys with the edge cases, queries and keys of
    # every integer dtype, wide keys (staged and too large to stage), any
    # positive block_b; each on every path, one launch a call.
    l0 = kernel.launches
    fkeys = torch.tensor(FASTPATH_FLOAT_KEYS, device=dev)[:, None]
    fq = torch.tensor(FASTPATH_EDGE_QUERIES, device=dev)[:, None]
    for kdt, vdt in itertools.product(
            (torch.float32, torch.bfloat16, torch.float16),
            (torch.float16, torch.int32)):
        vals = values(len(FASTPATH_FLOAT_KEYS), 3, vdt)
        for qdt in (torch.int32, torch.int64):
            hit = check(fq.to(qdt), fkeys.to(kdt), vals, 256,
                        f"{kdt} keys, {qdt} edge queries, {vdt} values")
            want = {q for q, h in zip(FASTPATH_EDGE_QUERIES, hit.tolist())
                    if h}
            if not {16777217, 0, -7} <= want or {3, 5} & want:
                fail(f"fastpath: {kdt} keys hit the queries {sorted(want)}")
        for qdt in (torch.int8, torch.int16, torch.uint8):
            check(fq.clamp(0, 120).to(qdt).contiguous(), fkeys.to(kdt), vals,
                  256, f"{kdt} keys, {qdt} queries")
    ints = (torch.int8, torch.int16, torch.uint8, torch.int32, torch.int64)
    raw = torch.randint(-5, 260, (40, 2), generator=gen, device=dev)
    q = torch.randint(-5, 260, (4096, 2), generator=gen, device=dev)
    q[::2] = raw[torch.randint(0, 40, (2048,), generator=gen, device=dev)]
    for qdt, kdt in itertools.product(ints, ints):
        check(q.to(qdt), raw.to(kdt), values(40, 2, torch.int32), 256,
              f"{qdt} queries, {kdt} keys")
    for kw, n in itertools.product(FASTPATH_WIDE, (64, 2000)):
        x, keys, vals = inputs(8192, n, kw, 4, torch.float32, key_range=3,
                               hot=0.5)
        x[1::4, -1] = 7
        hit = check(x, keys, vals, 256, f"keys {kw} wide, N {n}")
        if bool(hit[1::4].any()):
            fail(f"fastpath: keys {kw} wide hit queries apart in the last "
                 f"integer")
        check(x, keys.float(), vals, 256, f"fp32 keys {kw} wide, N {n}")
    x, keys, vals = inputs(8192, 16, 1, 2, torch.float16)
    for block_b in FASTPATH_ODD_BLOCK_B:
        check(x, keys, vals, block_b, f"block_b {block_b}")
        check(x[:37].contiguous(), keys, vals, block_b,
              f"block_b {block_b}, B 37")
    wider = checked - base_checked
    if kernel.launches - l0 != 4 * wider:
        fail(f"fastpath: {kernel.launches - l0} launches for {wider} wider "
             f"cases; wanted 4 each (raw, prepared, dense, hashed)")
    log(f"fastpath: cuda == torch_ref at {checked} cases, each on the raw "
        f"table (dense body) and on the prepared table (the picked body, "
        f"dense, hashed; miss counts against the plain hit count), one "
        f"launch a call (the reference's {FASTPATH_TEST_CASES} x values "
        f"fp32/bf16/fp16/int32/int64 x keys int32/int64/int8 x block_b "
        f"{FASTPATH_BLOCK_B}; K = 1 at B {FASTPATH_BATCHES} x N "
        f"{tuple(router_tables)} with int32 (V = 1) and fp32 (V = 16) "
        f"values; duplicate keys; an all-miss batch; one probe chain; int64 "
        f"keys apart in the high bits; then {wider} of the wider domain: "
        f"fp32/bf16/fp16 keys against the edge queries "
        f"{FASTPATH_EDGE_QUERIES} and narrow queries, every pair of "
        f"integer dtypes, keys {FASTPATH_WIDE} wide at N 64 and 2000 "
        f"(int32 and fp32 keys), block_b {FASTPATH_ODD_BLOCK_B}), exact "
        f"for integer values, within {FASTPATH_TOL} for fp32 and bf16 ones "
        f"and one ulp for fp16 ones (max_abs_err {max_err:.3e})")
    fastpath_card = _make_fastpath_on_card()

    per_shape = []
    for b, n, (vdt, v) in itertools.product(
            FASTPATH_BATCHES, router_tables,
            ((torch.int32, 1), (torch.float32, 16))):
        x, keys, vals = inputs(b, n, 1, v, vdt)
        table = kernel.prepare_table(keys, vals)
        timed = n in FASTPATH_TABLES
        kernel_ms = {str(bb): cuda_time_ms(
            lambda bb=bb: kernel.fastpath_cuda(x, keys, vals, block_b=bb),
            100, 10) for bb in FASTPATH_BLOCK_B} if timed else {}
        by_body = {}
        for name in kernel.BODIES:
            run = (lambda name=name:
                   kernel.fastpath_cuda_prepared(x, table, body=name))
            by_body[name] = {
                "ms": cuda_time_ms(run, 100, 10) if timed else None,
                "graph_ms": graph_time_ms(run, FASTPATH_GRAPH_LAUNCHES)}
        chosen = kernel.body(table)
        plain_ms = cuda_time_ms(
            lambda: ops.lookup(x, keys, vals, impl="torch_ref"), 10, 2) \
            if timed else None
        bound_ms, bound_by = _fastpath_cost(b, n, 1, v, 4,
                                            vals.element_size())
        row = {"shape": [b, n, 1, v],
               "value_dtype": str(vdt).removeprefix("torch."),
               "body": chosen, "ms": by_body[chosen]["ms"],
               "graph_ms": by_body[chosen]["graph_ms"],
               "by_body": by_body, "kernel_ms_by_block_b": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "compares": b * n,
               "library_ms": None}
        per_shape.append(row)
        eager = (" ".join(f"{k} eager {r['ms']:.4f}"
                          for k, r in by_body.items()) + "; raw dense "
                 + " ".join(f"b{bb} {ms:.4f}" for bb, ms in kernel_ms.items())
                 + f"; plain {plain_ms:.4f}; ") if timed else ""
        log(f"fastpath B={b} N={n} K=1 V={v} {vdt}: prepared picks {chosen}; "
            + " ".join(f"{k} graph {r['graph_ms']:.5f}"
                       for k, r in by_body.items())
            + f" ms; {eager}bound {bound_ms:.6f} ms ({bound_by}; "
            f"{100 * bound_ms / by_body[chosen]['graph_ms']:.1f} % of it in "
            f"the graph); {b * n} compares for the dense body, unbounded")
        del x, keys, vals, table
    # the body threshold: where the hashed body's device time falls below
    # the dense one's
    for b, v in ((FASTPATH_BATCHES[0], 1), (FASTPATH_BATCHES[1], 16)):
        rows = [r for r in per_shape if r["shape"][0] == b
                and r["shape"][3] == v]
        log(f"fastpath threshold B={b} V={v}: N -> dense / hashed graph ms: "
            + ", ".join("{}: {:.5f} / {:.5f}".format(
                r["shape"][1], r["by_body"]["dense"]["graph_ms"],
                r["by_body"]["hashed"]["graph_ms"]) for r in rows)
            + f"; prepared tables of >= {kernel.hash_min_keys()} keys take "
            f"the hashed body")
    # the router's batch with bf16 and fp16 values, and with keys 64 wide
    wider_timed = {}
    for label, (kw, vdt) in (("bf16 values", (1, torch.bfloat16)),
                             ("fp16 values", (1, torch.float16)),
                             ("keys 64 wide", (64, torch.int32))):
        x, keys, vals = inputs(ROUTER_BATCH, FIG4_HOT, kw, 1, vdt, hot=1.0,
                               key_range=2 ** 20)
        table = kernel.prepare_table(keys, vals)
        row = {"shape": [ROUTER_BATCH, FIG4_HOT, kw, 1],
               "value_dtype": str(vdt).removeprefix("torch."),
               "body": kernel.body(table)}
        for name in kernel.BODIES:
            run = (lambda name=name:
                   kernel.fastpath_cuda_prepared(x, table, body=name))
            row[name] = {"ms": cuda_time_ms(run, 100, 10),
                         "graph_ms": graph_time_ms(
                             run, FASTPATH_GRAPH_LAUNCHES)}
        row["bound_ms"], row["bound_by"] = _fastpath_cost(
            ROUTER_BATCH, FIG4_HOT, kw, 1, 4, vals.element_size())
        wider_timed[label] = row
        log(f"fastpath router batch, {label} (B={ROUTER_BATCH} N={FIG4_HOT} "
            f"K={kw} V=1 {vdt}): prepared picks {row['body']}; "
            + "; ".join(f"{b} eager {row[b]['ms']:.5f} graph "
                        f"{row[b]['graph_ms']:.5f}" for b in kernel.BODIES)
            + f" ms; bound {row['bound_ms']:.6f} ms ({row['bound_by']})")
        del x, keys, vals, table
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "checked": checked,
            "wider_checked": wider, "per_shape": per_shape,
            "wider_timed": wider_timed, "make_fastpath": fastpath_card}


def _make_fastpath_on_card() -> dict:
    """``make_fastpath`` on the card with an (8, 8) key shape and fp16
    values, with ``key_dtype`` int8 (the kernel: one launch a call, wide
    int8 keys on the hashed body) and float32 (the queries cast to float
    miss the guard: ``torch_ref``, one fallback a call, as in the
    reference), against the generic function on hits and misses."""
    import numpy as np
    import torch

    from repro_torch.core import fastpath as fp
    from repro_torch.kernels import registry
    from repro_torch.kernels.fastpath import kernel

    def generic(xb):
        return (xb.reshape(xb.shape[0], -1).float().sum(
            -1, keepdim=True) * 0.25).half()

    rs = np.random.RandomState(8)
    keys = rs.randint(0, 4, (16, 8, 8)).astype(np.int32)
    table = fp.FastPathTable.from_arrays(
        keys, generic(torch.from_numpy(keys)).float().numpy())
    q = rs.randint(0, 4, (4096, 8, 8)).astype(np.int32)
    q[::2] = keys[rs.randint(0, 16, 2048)]
    counts = registry.default_registry.fallback_counts
    key = ("fastpath", "cuda")
    result = {}
    for key_dtype in (torch.int8, torch.float32):
        f = fp.make_fastpath(generic, table, key_dtype=key_dtype,
                             value_dtype=torch.float16)
        on_kernel = key_dtype == torch.int8
        for what, batch in (("mixed", q), ("all hit", q[::2])):
            xb = torch.from_numpy(np.ascontiguousarray(batch)).to("cuda")
            l0, fb0 = kernel.launches, counts.get(key, 0)
            out = f(xb)
            torch.cuda.synchronize()
            launched, fb = kernel.launches - l0, counts.get(key, 0) - fb0
            name = f"make_fastpath (8, 8) keys {key_dtype}, fp16 values, {what}"
            if (launched, fb) != ((1, 0) if on_kernel else (0, 1)):
                fail(f"{name}: {launched} launches, {fb} fallbacks")
            if out.dtype != torch.float16 or not torch.equal(out,
                                                             generic(xb)):
                fail(f"{name}: differs from the generic function")
            result[f"{key_dtype} {what}"] = {"launches": launched,
                                             "fallbacks": fb}
            log(f"fastpath: {name}: {launched} K5 launch(es), {fb} "
                f"fallback(s), equal to the generic function")
    return result


def engine_args(extra: list[str]) -> argparse.Namespace:
    from repro_torch.launch.serve import add_engine_args

    ap = argparse.ArgumentParser()
    add_engine_args(ap)
    return ap.parse_args(extra)


def phase_guards(decode_by_kind: dict) -> dict:
    """Phase 4e: each kernel's guard (``ops._guard``: the card and the
    reference's precondition).  For each of K1 to K5, one call the kernel
    takes goes to ``cuda`` (K1, K2 and K4 also an fp16 one; K3 fp16, mixed
    operands and a half output; K5 float keys, fp16 values, keys 33 wide,
    int8 queries and a block_b of 7): one launch, no fallback, its answer
    within GUARD_TOL of ``torch_ref`` on the same inputs (K3 within phase
    4c's scaled limit at its k, K5's fp16 values within one fp16 ulp).  One call that
    misses the reference's precondition (host tensors; float queries to
    K5) returns ``torch_ref``'s answer with exactly one fallback counted
    and no launch.
    One call of each domain gap (an input the reference's kernel takes and
    the port's does not: ROADMAP "Kernel work") raises the wrapper's or the
    entry's error, with no launch and no fallback: it never runs the plain
    version on the card.  Then a stale ``spec_state`` (a point the handler
    does not declare) restored into a handler on the card leaves it
    serving its generic variant.  Last, the host's cost of K1's guards on
    a decode step: each guard's microseconds a call (GUARD_TIMING_CALLS
    calls at the decode shapes) times its launches a step
    (``decode_by_kind``, from phase 3)."""
    import torch

    from repro_torch.checkpoint import restore_spec_state
    from repro_torch.core import DEFAULT_CONTEXT, IridescentRuntime
    from repro_torch.core.runtime import encode_context_key
    from repro_torch.kernels import registry
    from repro_torch.kernels.attention import attention
    from repro_torch.kernels.attention import kernel as attn_k
    from repro_torch.kernels.fastpath import kernel as fp_k
    from repro_torch.kernels.fastpath import lookup
    from repro_torch.kernels.linear_attention import kernel as la_k
    from repro_torch.kernels.linear_attention import linear_attention
    from repro_torch.kernels.matmul import kernel as mm_k
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.rmsnorm import kernel as rms_k
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import rmsnorm

    gen = torch.Generator().manual_seed(0)
    f16, f32, f64 = torch.float16, torch.float32, torch.float64

    def rand(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)

    def host(args):
        return tuple(a.cpu() for a in args)

    counts = registry.default_registry.fallback_counts
    checks = []

    def counted(family, kmod, fn):
        """``fn()``'s result (or error), and the launches and fallbacks of
        ``family`` it made."""
        key = (family, "cuda")
        fb0, l0 = counts.get(key, 0), kmod.launches
        try:
            out, err = fn(), None
        except Exception as e:             # noqa: BLE001 (checked below)
            out, err = None, e
        torch.cuda.synchronize()
        return out, err, kmod.launches - l0, counts.get(key, 0) - fb0

    def check(family, kmod, label, fn, want_kernel, limit=None):
        """``fn(impl)`` through the registry with ``impl="cuda"``: one
        launch and no fallback (``want_kernel``) or the reverse, and its
        answer against ``fn("torch_ref")`` within GUARD_TOL (or within the
        per-element ``limit(ref)``)."""
        name = f"guards: {family} {label}"
        out, err, launched, fb = counted(family, kmod, lambda: fn("cuda"))
        if err is not None:
            fail(f"{name}: raised {type(err).__name__}: {err}")
        ref = fn("torch_ref")
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        err, excess = 0.0, 0.0
        for o, r in zip(outs, refs):
            if o.shape != r.shape or o.dtype != r.dtype:
                fail(f"{name}: output {tuple(o.shape)} {o.dtype}, torch_ref "
                     f"{tuple(r.shape)} {r.dtype}")
            tol = GUARD_TOL[family][o.dtype in (f16, torch.bfloat16)]
            bound = (limit(r).double() if limit is not None
                     else tol + tol * r.double().abs())
            o, r = o.double(), r.double()
            if not torch.isfinite(o).all():
                fail(f"{name}: output not finite")
            diff = (o - r).abs()
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
            excess = max(excess, float((diff - bound).max())
                         if diff.numel() else 0.0)
        log(f"{name}: {launched} launch(es), {fb} fallback(s), max |out - "
            f"torch_ref| {err:.3e}")
        if want_kernel and (launched != 1 or fb != 0):
            fail(f"{name}: {launched} launches and {fb} fallbacks; wanted "
                 f"one launch and no fallback")
        if not want_kernel and (launched != 0 or fb != 1):
            fail(f"{name}: {launched} launches and {fb} fallbacks; wanted "
                 f"no launch and one fallback")
        if excess > 0:
            fail(f"{name}: max |out - torch_ref| {err:.3e} over the "
                 f"tolerance by {excess:.3e}")
        checks.append({"kernel": family, "case": label, "launches": launched,
                       "fallbacks": fb, "max_abs_err": err, "raised": None})

    def gap(family, kmod, label, fn, error):
        """A domain gap: ``fn()`` on the card raises ``error`` (the
        wrapper's or the entry's) with no launch and no fallback."""
        name = f"guards: {family} gap {label}"
        _, err, launched, fb = counted(family, kmod, fn)
        log(f"{name}: {launched} launch(es), {fb} fallback(s), raised "
            f"{type(err).__name__}: {err}")
        if not isinstance(err, error):
            fail(f"{name}: raised {type(err).__name__} ({err}); wanted the "
                 f"kernel's {error.__name__}")
        if launched or fb:
            fail(f"{name}: {launched} launches and {fb} fallbacks; wanted "
                 f"none: a domain gap raises")
        checks.append({"kernel": family, "case": f"gap {label}",
                       "launches": launched, "fallbacks": fb,
                       "max_abs_err": None, "raised": type(err).__name__})

    # K1: rows of qwen3-0.6b's width, fp32 and fp16; host rows; fp64 rows
    # raise
    x, w = rand(8, 1024), rand(1024)
    check("rmsnorm", rms_k, "fp32 rows", lambda i: rmsnorm(x, w, impl=i),
          True)
    check("rmsnorm", rms_k, "fp16 rows",
          lambda i: rmsnorm(x.half(), w, impl=i), True)
    check("rmsnorm", rms_k, "host rows",
          lambda i: rmsnorm(*host((x, w)), impl=i), False)
    gap("rmsnorm", rms_k, f"{f64} rows",
        lambda: rmsnorm(x.to(f64), w, impl="cuda"), TypeError)
    # K2: (1, 4/2 heads, 128, 64) causal GQA, fp32 and fp16, fp16 q over
    # fp32 k and v, head dims (256, 256) and a window of -5 (at q_offset
    # -20, which leaves every row a column); host tensors; d 264, dv 264
    # and block_q 256 raise
    q, k, v = rand(1, 4, 128, 64), rand(1, 2, 128, 64), rand(1, 2, 128, 64)
    check("attention", attn_k, "fp32 GQA",
          lambda i: attention(q, k, v, impl=i), True)
    check("attention", attn_k, "fp16 GQA",
          lambda i: attention(q.half(), k.half(), v.half(), impl=i), True)
    check("attention", attn_k, "fp16 q, fp32 k and v",
          lambda i: attention(q.half(), k, v, impl=i), True)
    gq, gk, gv = (rand(1, n, 128, 256) for n in (4, 2, 2))
    check("attention", attn_k, "head dims (256, 256)",
          lambda i: attention(gq, gk, gv, impl=i), True)
    check("attention", attn_k, "window -5, not causal",
          lambda i: attention(q, k, v, causal=False, window=-5, q_offset=-20,
                              impl=i), True)
    check("attention", attn_k, "host tensors",
          lambda i: attention(*host((q, k, v)), impl=i), False)
    cases = {"d 264": ((rand(1, 4, 128, 264), rand(1, 2, 128, 264),
                        rand(1, 2, 128, 64)), {}, ValueError),
             "dv 264": ((q, k, rand(1, 2, 128, 264)), {}, ValueError),
             "block_q 256": ((q, k, v), {"block_q": 256}, ValueError)}
    for label, (args, kw, error) in cases.items():
        gap("attention", attn_k, label,
            lambda a=args, kw=kw: attention(*a, impl="cuda", **kw), error)
    # K3: (256, 256) x (256, 256) of random fp32, fp16, fp32 x bf16 and
    # fp32 into fp16, within phase 4c's scaled limit at k 256; host
    # operands; a tile triple not instantiated raises
    a, b = rand(256, 256), rand(256, 256)
    check("matmul", mm_k, "fp32", lambda i: matmul(a, b, impl=i), True,
          limit=lambda ref: _matmul_limit(a, b, ref))
    for label, (ma, mb, kw) in {
            "fp16": (a.half(), b.half(), {}),
            "fp32 x bf16": (a, b.bfloat16(), {}),
            "fp32 into fp16": (a, b, {"out_dtype": f16})}.items():
        check("matmul", mm_k, label,
              lambda i, ma=ma, mb=mb, kw=kw: matmul(ma, mb, impl=i, **kw),
              True, limit=lambda ref, ma=ma, mb=mb: _matmul_limit(ma, mb,
                                                                  ref))
    check("matmul", mm_k, "host operands",
          lambda i: matmul(*host((a, b)), impl=i), False,
          limit=lambda ref: _matmul_limit(a.cpu(), b.cpu(), ref))
    gap("matmul", mm_k, "tiles (256, 256, 128)",
        lambda: matmul(a, b, bm=256, bn=256, bk=128, impl="cuda"),
        ValueError)
    # K4: rwkv6's heads of 64 at T 256, exclusive with the bonus, fp32 and
    # fp16 (log_w and the bonus fp32, as the models give them), fp16 q and
    # v with an fp32 k, GLA's heads (256, 512); host tensors; dk 264, dv
    # 520, chunk 48 and a bonus on the inclusive recurrence raise
    lq, lk, lv = rand(8, 256, 64), rand(8, 256, 64), rand(8, 256, 64)
    lw = -torch.rand(8, 256, 64, generator=gen).to("cuda") - 0.01
    u = rand(8, 64)
    check("linear_attention", la_k, "fp32 exclusive + bonus",
          lambda i: linear_attention(lq, lk, lv, lw, bonus=u, impl=i), True)
    check("linear_attention", la_k, "fp16 exclusive + bonus",
          lambda i: linear_attention(lq.half(), lk.half(), lv.half(), lw,
                                     bonus=u, impl=i), True)
    check("linear_attention", la_k, "fp16 q and v, fp32 k",
          lambda i: linear_attention(lq.half(), lk, lv.half(), lw, bonus=u,
                                     impl=i), True)
    gla_qk = 0.3 * rand(2, 128, 256)
    gla_v, gla_w = rand(2, 128, 512), -torch.rand(
        2, 128, 256, generator=gen).to("cuda") - 0.01
    check("linear_attention", la_k, "head dims (256, 512), inclusive",
          lambda i: linear_attention(gla_qk, gla_qk, gla_v, gla_w,
                                     inclusive=True, impl=i), True)
    check("linear_attention", la_k, "host tensors",
          lambda i: linear_attention(*host((lq, lk, lv, lw)),
                                     bonus=u.cpu(), impl=i), False)
    wide = rand(8, 64, 264)
    wide_w = -torch.rand(8, 64, 264, generator=gen).to("cuda") - 0.01
    cases = {"dk 264": ((wide, wide, rand(8, 64, 64), wide_w), {},
                        ValueError),
             "dv 520": ((lq, lk, rand(8, 256, 520), lw), {}, ValueError),
             "chunk 48": ((lq, lk, lv, lw), {"chunk": 48}, ValueError),
             "inclusive + bonus": ((lq, lk, lv, lw),
                                   {"bonus": u, "inclusive": True},
                                   ValueError)}
    for label, (args, kw, error) in cases.items():
        gap("linear_attention", la_k, label,
            lambda a=args, kw=kw: linear_attention(*a, impl="cuda", **kw),
            error)
    # K5: 4096 int32 queries against 64 keys, fp32 values, then float
    # keys, fp16 values (within one fp16 ulp), keys 33 wide, int8 queries
    # and a block_b of 7; host tensors and float queries (the reference's
    # guard refuses them too)
    keys = torch.randint(0, 100, (64, 1), generator=gen).to("cuda",
                                                            torch.int32)
    hot = torch.randint(0, 64, (4096,), generator=gen).to("cuda")
    xq = torch.where((hot % 2 == 0)[:, None], keys[hot], -keys[hot] - 1)
    vals = rand(64, 4)
    wk = torch.randint(0, 3, (64, 33), generator=gen).to("cuda", torch.int32)
    wx = wk[torch.randint(0, 64, (512,), generator=gen).to("cuda")]
    for label, (args, kw) in {
            "int32 keys": ((xq, keys, vals), {}),
            "float keys": ((xq, keys.float(), vals), {}),
            "fp16 values": ((xq, keys, vals.half()), {}),
            "key width 33": ((wx, wk, vals), {}),
            "int8 queries": ((xq.to(torch.int8), keys, vals), {}),
            "block_b 7": ((xq, keys, vals), {"block_b": 7})}.items():
        check("fastpath", fp_k, label,
              lambda i, a=args, kw=kw: lookup(*a, impl=i, **kw), True,
              limit=(lambda ref: 2.0 ** -10 * ref.double().abs() + 1e-6)
              if label == "fp16 values" else None)
    check("fastpath", fp_k, "host tensors",
          lambda i: lookup(*host((xq, keys, vals)), impl=i), False)
    check("fastpath", fp_k, "float queries",
          lambda i: lookup(xq.float(), keys.float(), vals, impl=i), False)

    # A stale spec_state restored into a handler on the card: the handler
    # keeps serving its generic variant (K1 through the default impl).
    def builder(spec):
        impl = registry.impl_point(spec, "rmsnorm")

        def step(x, w):
            return rmsnorm(x, w, impl=impl)
        return step

    path = SCRATCH / "guards_spec_state.json"
    SCRATCH.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"version": 2, "handlers": {"norm": {
        "contexts": {encode_context_key(DEFAULT_CONTEXT):
                     {"no_such_point": 1}}}}}))
    rt = IridescentRuntime(max_compile_workers=1)
    try:
        h = rt.register("norm", builder)
        applied = restore_spec_state(str(path), rt, wait=True)
        l0 = rms_k.launches
        out = h(x, w)
        torch.cuda.synchronize()
        stale = h.stats()["stale_configs"]
        active = h.active_config()
        launched = rms_k.launches - l0
    finally:
        rt.shutdown()
    err = float((out - rmsnorm(x, w, impl="torch_ref")).abs().max())
    log(f"guards: stale spec_state restored (applied {applied}): active "
        f"config {active}, stale configs counted {stale}, the generic "
        f"variant's call made {launched} K1 launch(es), max |out - "
        f"torch_ref| {err:.3e}")
    if applied or active != {} or stale != 1:
        fail(f"guards: stale spec_state: applied {applied}, active config "
             f"{active}, {stale} stale configs counted; wanted False, {{}}, "
             f"1")
    if launched != 1 or not err <= GUARD_TOL["rmsnorm"][0] * (
            1 + float(out.abs().max())):
        fail(f"guards: stale spec_state: the generic variant made "
             f"{launched} K1 launches, max |out - torch_ref| {err:.3e}")

    # K1's guards at qwen3's decode shapes (batch 8: the residual rows,
    # and the q/k pair of 16 and 8 heads of 128), timed on the host.
    qn, kn, hw = rand(8, 16, 1, 128), rand(8, 8, 1, 128), rand(128)
    us = {}
    for kind, fn in (("single", lambda: rms_ops._guard(x, w)),
                     ("pair", lambda: rms_ops._pair_guard(qn, hw, kn, hw))):
        if not fn():
            fail(f"guards: K1's {kind} guard misses a decode-shape call")
        t0 = time.perf_counter()
        for _ in range(GUARD_TIMING_CALLS):
            fn()
        us[kind] = 1e6 * (time.perf_counter() - t0) / GUARD_TIMING_CALLS
    step_ms = sum(us[k] * decode_by_kind[k] for k in us) / 1e3
    log(f"guards: K1's guard {us['single']:.2f} us a call, the pair's "
        f"{us['pair']:.2f} us; on a decode step ({decode_by_kind['single']} "
        f"single, {decode_by_kind['pair']} pair launches) "
        f"{step_ms:.3f} host ms")
    return {"checks": checks, "stale": {"active": active,
                                         "stale_configs": stale},
            "k1_guard_us": us, "k1_guard_ms_a_decode_step": step_ms}


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
    decode_host_ms = 1e3 * spent.get("decode steps", 0.0) / max(
        per["decode steps"], 1)
    log(f"main path: host ms a decode step {decode_host_ms:.1f} (PR 15: "
        f"{PR15_DECODE_HOST_MS}; a record, not a gate)")
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
            "wall": wall, "steps": stats["phase_steps"],
            "decode_host_ms": decode_host_ms}


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
    per_call = PREFILL_LAUNCHES
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


def phase_rwkv_prefill(cfg) -> dict:
    """The rwkv6 prefill handler under a Controller sweeping the linear
    attention's implementation and chunk, then one long call."""
    import torch

    from repro_torch import compat
    from repro_torch.core import (DEFAULT_CONTEXT, Controller,
                                  CoordinateDescent, IridescentRuntime)
    from repro_torch.kernels import registry
    from repro_torch.kernels.linear_attention import kernel as la_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.models import transformer as model
    from repro_torch.training import make_prefill_builder

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in compat.tree_leaves(params))
    log(f"rwkv6 prefill: {cfg.name} ({cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.rwkv_heads} heads of {cfg.rwkv_head_size}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}) params {n_params / 1e6:.1f}M "
        f"({4 * n_params / 1e9:.2f} GB fp32), drawn in "
        f"{time.perf_counter() - t0:.1f}s")
    gen = torch.Generator(device=dev).manual_seed(5)
    b, s = RWKV_SWEEP
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev, dtype=torch.int32)
    rt = IridescentRuntime(max_compile_workers=1)
    handler = rt.register("prefill_step", make_prefill_builder(cfg))
    space = handler.spec_space()
    labels = ["linear_attention_impl", "chunk_len"]
    controller = Controller(
        handler, lambda: CoordinateDescent(space, labels=labels,
                                           max_passes=1),
        dwell=PREFILL_DWELL, wait_compiles=True, prefetch=0)

    def impl_of(config: dict) -> str:
        return registry.resolve(
            "linear_attention",
            _setting(config, "linear_attention_impl")).name

    calls = []          # (impl, K4 launches, K1 launches, seconds)
    la_kernel.reset_launches()
    rms_kernel.reset_launches()
    registry.default_registry.fallback_counts.clear()
    t_phase = time.perf_counter()

    def call(batch_tokens) -> torch.Tensor:
        impl = impl_of(handler.active_config())
        a0, r0 = la_kernel.launches, rms_kernel.launches
        t = time.perf_counter()
        logits = handler(params, {"tokens": batch_tokens})
        torch.cuda.synchronize()
        calls.append((impl, la_kernel.launches - a0,
                      rms_kernel.launches - r0, time.perf_counter() - t))
        return logits

    for _ in range(100):
        logits = call(tokens)
        controller.step()
        if controller.settled():
            break
    else:
        fail("the rwkv6 prefill Controller did not settle in 100 calls")
    if logits.shape != (b, s, cfg.padded_vocab_size) \
            or not torch.isfinite(logits).all():
        fail(f"rwkv6 prefill logits {tuple(logits.shape)} or non-finite")
    del logits
    chosen = controller.best_configs()[DEFAULT_CONTEXT]
    for phase, config, rate in controller.histories()[DEFAULT_CONTEXT]:
        log(f"rwkv6 prefill sweep: {phase.value} {_config_str(config)} -> "
            f"{rate * b * s:.1f} tok/s ({1e3 / rate:.1f} ms/call)")
    log(f"rwkv6 prefill sweep: settled after {len(calls)} calls on "
        f"{_config_str(chosen)} (active "
        f"{_config_str(handler.active_config())})")
    t_sweep = 1.0 / controller.best(DEFAULT_CONTEXT)[1]

    long_tokens = torch.randint(0, cfg.vocab_size, (1, RWKV_LONG),
                                generator=gen, device=dev, dtype=torch.int32)
    logits = call(long_tokens)
    if logits.shape != (1, RWKV_LONG, cfg.padded_vocab_size) \
            or not torch.isfinite(logits[0, -1]).all():
        fail(f"rwkv6 long prefill logits {tuple(logits.shape)} or "
             f"non-finite")
    del logits
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_phase
    la_launches, rms_launches = la_kernel.launches, rms_kernel.launches
    fallbacks = {f"{k[0]}/{k[1]}": v for k, v in
                 registry.default_registry.fallback_counts.items()}
    log(f"rwkv6 prefill: ({b}, {s}) x{len(calls) - 1} then (1, {RWKV_LONG}) "
        f"in {wall:.1f}s; the long call {1e3 * calls[-1][3]:.1f} ms "
        f"({RWKV_LONG / calls[-1][3]:.1f} tok/s; the sweep's best scaled by "
        f"{RWKV_LONG // s}: {t_sweep * RWKV_LONG / s:.2f}s)")
    log(f"rwkv6 prefill: linear_attention cuda launches={la_launches}, "
        f"rmsnorm cuda launches={rms_launches}, "
        f"fallbacks={json.dumps(fallbacks)}; calls by linear_attention impl "
        f"{json.dumps({i: sum(c[0] == i for c in calls) for i in {c[0] for c in calls}})}")
    n_cuda = sum(c[0] == "cuda" for c in calls)
    if la_launches == 0 or la_launches != cfg.n_layers * n_cuda:
        fail(f"linear attention launched {la_launches} times over {n_cuda} "
             f"calls on cuda; wanted {cfg.n_layers} per call")
    for impl, a, _, _ in calls:
        if a != (cfg.n_layers if impl == "cuda" else 0):
            fail(f"an rwkv6 prefill call on {impl} launched the linear "
                 f"attention {a} times")
    per_call = sum(RWKV_PREFILL_SHAPES.values())
    if rms_launches != per_call * len(calls):
        fail(f"rmsnorm launched {rms_launches} times over {len(calls)} "
             f"rwkv6 prefill calls; wanted {per_call} per call")
    if fallbacks:
        fail(f"the rwkv6 prefill path fell back: {fallbacks}")

    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        handler(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t
    profile = _report_profile(
        prof, prof_wall, 1, what=f"full-width rwkv6 ({b}, {s}) prefill call "
        f"(chosen config, profiler on)", unit="call")
    rt.shutdown()
    return {"params": params, "la_launches": la_launches,
            "rms_launches": rms_launches,
            "chosen": {"linear_attention_impl": impl_of(chosen),
                       "chunk_len": _setting(chosen, "chunk_len", 64)},
            "sweep_ms": 1e3 * t_sweep, "long_ms": 1e3 * calls[-1][3],
            "calls": len(calls), "profile": profile}


def phase_rwkv_serve(cfg, params) -> dict:
    """``build_engine --arch rwkv6-1.6b`` serves a few requests at full
    width through the safety controller (its decode advances the state
    with the plain step: K1 launches, K4 does not)."""
    import torch

    from repro_torch.kernels import registry
    from repro_torch.kernels.linear_attention import kernel as la_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.launch.serve import build_engine, synthetic_workload
    from repro_torch.serve import OpenLoopSource

    args = engine_args(["--device", "cuda", "--arch", "rwkv6-1.6b",
                        "--batch", "8", "--max-len", "256",
                        "--prefill-chunk", "16", "--dwell", "2",
                        "--requests", "4", "--rate", "0.5"])
    built = build_engine(args, cfg=cfg, params=params)
    schedule = synthetic_workload(args.requests, args.rate, seed=args.seed)
    requests = [r for _, r in schedule]
    rms_kernel.reset_launches()
    la_kernel.reset_launches()
    registry.default_registry.fallback_counts.clear()
    t0 = time.perf_counter()
    built.engine.run(source=OpenLoopSource(built.engine.queue, schedule),
                     max_steps=2000, duration_s=120.0)
    drained = built.engine.drain(timeout_s=120.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, la_launches = rms_kernel.launches, la_kernel.launches
    fallbacks = {f"{k[0]}/{k[1]}": v for k, v in
                 registry.default_registry.fallback_counts.items()}
    stats = built.engine.stats()
    served = stats["serve"]
    configs = {str(k): ({kk: repr(vv) for kk, vv in c.items()
                         if kk in ("cache_dtype", "rmsnorm_impl",
                                   "chunk_len")}
                        if c is not None else None)
               for k, c in built.controller.best_configs().items()}
    safety = built.controller.safety_status()
    log(f"rwkv6 serve: served {served['completed']}/{len(requests)} "
        f"requests (prompts {[r.prompt_tokens for r in requests]}), "
        f"{served['completed_tokens']} tokens in {wall:.1f}s "
        f"({served['completed_tokens'] / wall:.2f} tok/s), steps "
        f"{stats['phase_steps']}, idle ticks {stats['idle_ticks']}; latency "
        f"p50/p95 ms {served['latency_p50_ms']} / {served['latency_p95_ms']}")
    log(f"rwkv6 serve: per-context configs {json.dumps(configs)}; safety "
        f"promotions={safety['promotions']} rollbacks={safety['rollbacks']}")
    log(f"rwkv6 serve: rmsnorm cuda launches={launches}, linear_attention "
        f"launches={la_launches} (decode steps the state without it), "
        f"fallbacks={json.dumps(fallbacks)}")
    built.engine.shutdown()
    if not drained or served["completed"] != len(requests):
        fail(f"rwkv6 served {served['completed']} of {len(requests)} "
             f"requests")
    for r in requests:
        if r.payload is None or len(r.payload) != r.max_new_tokens:
            fail(f"rwkv6 request {r.rid} got {r.payload!r}, wanted "
                 f"{r.max_new_tokens} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.payload):
            fail(f"rwkv6 request {r.rid} produced out-of-vocab tokens")
    if launches == 0:
        fail("the rwkv6 serve path launched the rmsnorm kernel no time")
    if fallbacks:
        fail(f"the rwkv6 serve path fell back: {fallbacks}")
    return {"launches": launches, "wall": wall,
            "tokens": served["completed_tokens"]}


def _rel_rows(a, w):
    """max |a - w| over the last axis / max |w|: one relative difference
    per (batch, token) position, on the witness's scale."""
    return (a.double() - w).abs().amax(-1) / w.abs().max()


def phase_rwkv_parity(cfg, params) -> dict:
    """Both full-width rwkv6 parity checks, held to a float64 witness on
    each of ``RWKV_WITNESS_SEEDS``' weights: (a) the prefill handler on the
    kernel against the plain linear attention, on (2, 2048) tokens; (b) the
    forward's last-token logits against the serve path's prefill chunk
    (its per-step decode), on an (8, 16) prompt.

    With random weights the rwkv6 forward is ill-conditioned at full width:
    the per-head output norm divides time-mix rows that nearly cancel by
    their small norm, so fp32 rounding alone moves the logits of most
    positions by more than ``PARITY_TOL``.  The witness (the plain forward
    in float64) sides with neither fp32 path: each is held to it at
    ``RWKV_QUANTILES`` of the positions, within ``PARITY_TOL`` or
    ``RWKV_WITNESS_FACTOR`` times the plain fp32 path's own difference.
    Every kernel call of (a) is also held to the plain linear attention on
    its own inputs, at the linear-attention tolerances."""
    import torch

    from repro_torch import compat
    from repro_torch.core import IridescentRuntime
    from repro_torch.kernels.linear_attention import ops as la_ops
    from repro_torch.models import rwkv6 as rwkv_mod
    from repro_torch.models import transformer as model
    from repro_torch.models.common import KernelOptions
    from repro_torch.training import (make_prefill_builder,
                                      make_serve_builder, phase_context_fn)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, RWKV_PARITY, generator=gen,
                           device=dev, dtype=torch.int32)
    b, chunk = 8, 16
    prompt = torch.randint(0, cfg.vocab_size, (b, chunk), generator=gen,
                           device=dev, dtype=torch.int32)
    cfg64 = cfg.replace(compute_dtype="float64")
    opts64 = model.RunOptions(kernels=KernelOptions(impl="torch_ref",
                                                    chunk_len=64),
                              logits_dtype="float64")
    rt = IridescentRuntime(max_compile_workers=1)
    prefill = rt.register("prefill_step", make_prefill_builder(cfg))
    serve = rt.register("serve_step", make_serve_builder(cfg),
                        context_fn=phase_context_fn)
    serve.specialize({"cache_dtype": "float32"}, wait=True,
                     context=("prefill", b))
    op = rwkv_mod.linear_attention
    calls = []          # max |kernel - plain| of each kernel call

    def held_op(q, k, v, log_w, **kw):
        out = op(q, k, v, log_w, **kw)
        ref = la_ops.linear_attention(q, k, v, log_w,
                                      **dict(kw, impl="torch_ref"))
        for rt_, at in ((LINATT_TOL["float32"],) * 2,
                        LINATT_SCALED_TOL["float32"]):
            torch.testing.assert_close(
                out, ref, rtol=rt_, atol=at,
                msg=lambda m: f"rwkv6 parity (a), linear attention call "
                              f"{len(calls)} at {tuple(q.shape)}: {m}")
        calls.append((out - ref).abs().max().item())
        return out

    def quantiles(plain, gated: dict) -> dict:
        """RWKV_QUANTILES of the plain fp32 path's and each gated path's
        per-position differences from the witness."""
        qs = torch.tensor(RWKV_QUANTILES, dtype=torch.float64,
                          device=plain.device)
        return {name: torch.quantile(err.flatten(), qs).tolist()
                for name, err in {"plain": plain, **gated}.items()}

    def hold(what, seed, got: dict) -> None:
        for name, values in got.items():
            for q, e, p in zip(RWKV_QUANTILES, values, got["plain"]):
                if not e <= max(PARITY_TOL, RWKV_WITNESS_FACTOR * p):
                    fail(f"rwkv6 parity {what}, weights {seed}: {name} lies "
                         f"{e:.3e} from the float64 witness at quantile {q} "
                         f"of the positions; the plain fp32 path {p:.3e}")

    results = []
    for seed in RWKV_WITNESS_SEEDS:
        p32 = params if seed == 0 else model.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg)
        p64 = compat.tree_map(lambda a: a.double(), p32)
        # (a) the prefill handler on the kernel and on the plain version
        n_calls = len(calls)
        out = {}
        for key, impl, hook in (("cuda", "cuda", held_op),
                                ("plain", "torch_ref", op)):
            _pin(prefill, {"linear_attention_impl": impl, "chunk_len": 64})
            rwkv_mod.linear_attention = hook
            try:
                out[key] = prefill(p32, {"tokens": tokens})
            finally:
                rwkv_mod.linear_attention = op
        if len(calls) - n_calls != cfg.n_layers:
            fail(f"rwkv6 parity (a): {len(calls) - n_calls} linear attention "
                 f"calls, wanted {cfg.n_layers}")
        w64 = model.apply(p64, cfg64, opts64, tokens=tokens)[0]
        cuda, plain = out.pop("cuda"), out.pop("plain")
        if cuda.shape != w64.shape or not torch.isfinite(cuda).all():
            fail(f"rwkv6 parity (a): shape {tuple(cuda.shape)} or non-finite")
        err_k, err_p = _rel_rows(cuda, w64), _rel_rows(plain, w64)
        err_kp = _rel_rows(cuda, plain.double()).max().item()
        within = int((err_p <= PARITY_TOL).sum())
        agree = int((cuda.argmax(-1) == plain.argmax(-1)).sum())
        del cuda, plain, w64
        # (b) the serve path's per-step prefill chunk against the forward
        cache = model.init_cache(cfg, b, 256, model.RunOptions(
            decode_cache_dtype="float32"), device=dev)
        zeros = torch.zeros(b, dtype=torch.int32, device=dev)
        decode, _ = serve(p32, cache, prompt, zeros,
                          torch.full_like(zeros, chunk))
        last = {impl: model.apply(p32, cfg, model.RunOptions(
            kernels=KernelOptions(linear_attention_impl=impl, chunk_len=64)),
            tokens=prompt)[0][:, -1, : cfg.vocab_size]
            for impl in ("cuda", "torch_ref")}
        w_last = model.apply(p64, cfg64, opts64, tokens=prompt)[0][
            :, -1, : cfg.vocab_size]
        del p64, cache
        if decode.shape != w_last.shape or not torch.isfinite(decode).all():
            fail(f"rwkv6 parity (b): shape {tuple(decode.shape)} or "
                 f"non-finite")
        errb_d, errb_k = _rel_rows(decode, w_last), _rel_rows(last["cuda"],
                                                                w_last)
        errb_p = _rel_rows(last["torch_ref"], w_last)
        errb_kd = _rel_rows(last["cuda"], decode.double()).max().item()
        fmt = lambda qs: "/".join(f"{e:.3e}" for e in qs)
        qa = quantiles(err_p, {"the kernel path": err_k})
        qb = quantiles(errb_p, {"the decode": errb_d,
                                "the kernel forward": errb_k})
        log(f"rwkv6 parity, weights {seed}: relative logits differences "
            f"from the float64 witness at quantiles {RWKV_QUANTILES} of the "
            f"positions. (a) {RWKV_PARITY} tokens: kernel path "
            f"{fmt(qa['the kernel path'])}, plain path {fmt(qa['plain'])} "
            f"(kernel vs plain max {err_kp:.3e}; the plain path within "
            f"{PARITY_TOL:g} of the witness at {within}/{err_p.numel()} "
            f"positions; argmax kernel vs plain agrees on "
            f"{agree}/{err_p.numel()}). (b) {tuple(prompt.shape)} last "
            f"token: decode {fmt(qb['the decode'])}, kernel forward "
            f"{fmt(qb['the kernel forward'])}, plain forward "
            f"{fmt(qb['plain'])} (kernel forward vs decode max "
            f"{errb_kd:.3e})")
        results.append({"seed": seed, "a": qa, "b": qb,
                        "a_plain_within_tol": within})
        hold("(a)", seed, qa)
        hold("(b)", seed, qb)
        del p32
        torch.cuda.empty_cache()
    rt.shutdown()
    log(f"rwkv6 parity: the {len(calls)} kernel calls each within "
        f"{LINATT_TOL['float32']:g} and the scaled "
        f"{LINATT_SCALED_TOL['float32']} of the plain version on the same "
        f"inputs (largest difference {max(calls):.3e})")
    return {"seeds": results, "kernel_call_max_diff": max(calls)}


def _load_example(name: str):
    """A module of the checkout's ``examples/`` (not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_table1() -> dict:
    """(a) The Fig 2 quickstart on the card; (b) a Table-1 handler whose
    ``matmul_impl`` x tile x divisibility points a Controller sweeps over
    N = TABLE1_N products, then a TABLE1_MISS_N call that misses its
    divisibility guard."""
    import torch

    from repro_torch.core import (DEFAULT_CONTEXT, Controller,
                                  ExhaustiveSweep, IridescentRuntime,
                                  guards)
    from repro_torch.kernels import registry
    from repro_torch.kernels.matmul import kernel, matmul

    t0 = time.perf_counter()
    quick = _load_example("quickstart_torch").main(["--device", "cuda"])
    if not quick["settled"] or quick["guard_misses"] != 1:
        fail(f"quickstart: settled={quick['settled']}, guard misses "
             f"{quick['guard_misses']} (wanted 1)")
    log(f"table1: quickstart settled on {_config_str(quick['selected'])}, "
        f"its guard miss answered through the generic variant, in "
        f"{time.perf_counter() - t0:.1f}s")

    def build(spec):
        impl = registry.impl_point(spec, "matmul")
        bm, bn, bk = spec.enum("tiles", kernel.DEFAULT_TILES,
                               kernel.CARD_TILES)

        def divisible(args, kwargs, _value):
            # spec_assume("N % B == 0") for each dimension and its tile
            return all(guards.shape_multiple_of(i, d)(args, kwargs, t)
                       for i, d, t in ((0, 0, bm), (0, 1, bk), (1, 1, bn)))

        assume = spec.assume("divisible", guard=divisible)

        def handler(x, y):
            return matmul(x, y, bm=bm, bn=bn, bk=bk, impl=impl,
                          assume_divisible=assume)

        return handler

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    n = TABLE1_N
    x = torch.randn((n, n), generator=gen, device=dev)
    y = torch.randn((n, n), generator=gen, device=dev)
    rt = IridescentRuntime(max_compile_workers=1)
    handler = rt.register("table1_matmul", build)
    candidates = [{"matmul_impl": "cuda", "tiles": t, "divisible": True}
                  for t in kernel.CARD_TILES]
    candidates.append({"matmul_impl": "torch_ref", "divisible": True})
    controller = Controller(handler, lambda: ExhaustiveSweep(candidates),
                            dwell=TABLE1_DWELL, wait_compiles=True,
                            prefetch=0)
    kernel.reset_launches()
    registry.default_registry.fallback_counts.clear()
    calls = 0
    for _ in range(100):
        out = handler(x, y)
        torch.cuda.synchronize()
        calls += 1
        controller.step()
        if controller.settled():
            break
    else:
        fail("the Table-1 Controller did not settle in 100 calls")
    ref = matmul(x, y, impl="torch_ref")
    diff = (out - ref).abs()
    if out.shape != (n, n) or not bool(
            (diff <= _matmul_limit(x, y, ref)).all()):
        fail(f"table1: the settled handler's product is off by "
             f"{diff.max().item():.3e}")
    flop = 2 * n ** 3
    by_config: dict[str, list[float]] = {}
    for phase, config, rate in controller.histories()[DEFAULT_CONTEXT]:
        log(f"table1 sweep: {phase.value} {_config_str(config)} -> "
            f"{rate * flop / 1e12:.2f} TFLOP/s ({1e3 / rate:.2f} ms/call)")
        by_config.setdefault(_config_str(config), []).append(rate)
    chosen = controller.best_configs()[DEFAULT_CONTEXT]
    log(f"table1 sweep: settled after {calls} calls on {_config_str(chosen)}")
    # The Table-1 choice: the settled config beside the best K3 candidate
    # and the plain version (cuBLAS), each at its best call in the sweep.
    best = {key: max(rates) * flop / 1e12 for key, rates in by_config.items()}
    k3 = {key: v for key, v in best.items() if '"cuda"' in key}
    plain = [v for key, v in best.items() if '"torch_ref"' in key]
    best_k3 = max(k3, key=k3.get) if k3 else None
    log(f"table1: the Controller chose "
        f"{_setting(chosen, 'matmul_impl')} {_config_str(chosen)}; best K3 "
        f"candidate {best_k3} at {k3.get(best_k3, float('nan')):.2f} TFLOP/s, "
        f"the plain version (cuBLAS, TF32 off) at "
        f"{max(plain, default=float('nan')):.2f} TFLOP/s")

    # A size the divisibility assumption does not hold for: the handler's
    # guard misses and the generic variant (the kernel, edge-masked) runs.
    misses, launches = handler.guard_misses, kernel.launches
    m = TABLE1_MISS_N
    x2, y2 = x[:m, :m].contiguous(), y[:m, :m].contiguous()
    out2 = handler(x2, y2)
    torch.cuda.synchronize()
    ref2 = matmul(x2, y2, impl="torch_ref")
    if handler.guard_misses != misses + 1:
        fail(f"table1: the ({m}, {m}) call missed the guard "
             f"{handler.guard_misses - misses} times, wanted 1")
    if kernel.launches != launches + 1:
        fail(f"table1: the ({m}, {m}) call launched the kernel "
             f"{kernel.launches - launches} times, wanted 1")
    diff2 = (out2 - ref2).abs()
    if not bool((diff2 <= _matmul_limit(x2, y2, ref2)).all()):
        fail(f"table1: the generic variant's ({m}, {m}) product is off by "
             f"{diff2.max().item():.3e}")
    launched = kernel.launches
    fallbacks = {f"{k[0]}/{k[1]}": v for k, v in
                 registry.default_registry.fallback_counts.items()}
    log(f"table1: ({m}, {m}) call missed the divisibility guard (guard "
        f"misses {handler.guard_misses}), ran the generic variant on the "
        f"kernel, max |diff| {diff2.max().item():.3e}; matmul cuda "
        f"launches={launched}, fallbacks={json.dumps(fallbacks)}")
    if launched == 0:
        fail("the Table-1 path never launched the matmul kernel")
    if fallbacks:
        fail(f"the Table-1 path fell back: {fallbacks}")
    rt.shutdown()
    tiles = _setting(chosen, "tiles")              # None for torch_ref
    return {"launches": launched, "calls": calls + 1,
            "chosen": {"matmul_impl": registry.resolve(
                "matmul", _setting(chosen, "matmul_impl")).name,
                "tiles": list(tiles) if tiles else None},
            "best_tflops": best,
            "quickstart": _config_str(quick["selected"])}


def _make_lpm(m: int, rs, dev):
    """benchmarks/fig4_fastpath.py::make_lpm in torch: a random LPM table
    (net, masklen, next hop) and its vectorized longest-prefix match.  The
    numbers are drawn as the reference draws them; the tables are int32,
    as JAX holds them with 64-bit types off."""
    import numpy as np
    import torch

    masklen = rs.randint(8, 25, size=m).astype(np.int32)
    nets = (rs.randint(0, 2**31 - 1, size=m).astype(np.int64)
            & (~((1 << (32 - masklen)) - 1))).astype(np.int64)
    hops = rs.randint(1, 255, size=m).astype(np.int64)
    nets_c = torch.as_tensor(nets.astype(np.int32), device=dev)
    mask_c = torch.as_tensor(masklen, device=dev)
    hops_c = torch.as_tensor(hops.astype(np.int32), device=dev)
    shift = 32 - mask_c
    nets_s = nets_c >> shift

    def lookup(addrs):            # (B, 1) int32 -> (B, 1) int32
        a = addrs.reshape(-1)
        match = (a[:, None] >> shift[None, :]) == nets_s[None, :]  # (B, M)
        pref = torch.where(match, mask_c[None, :], -1)
        best = torch.argmax(pref, dim=-1)
        hit = pref.max(dim=-1).values >= 0
        hop = torch.where(hit, hops_c[best], 0)
        return hop[:, None]

    return lookup, nets, masklen


def phase_router() -> dict:
    """(a) Fig 4: the LPM router's fast path against its generic at 100 %
    hit; (b) Fig 9: change-triggered instrumentation and exploration of
    the fast-path size through the runtime, the traffic shifting at the
    midpoint."""
    import numpy as np
    import torch

    from repro_torch.core import (ChangeDetector, ExhaustiveSweep, Explorer,
                                  IridescentRuntime, Phase)
    from repro_torch.core.fastpath import (FastPathTable, build_table,
                                           make_fastpath)
    from repro_torch.data import RequestGenerator
    from repro_torch.kernels import registry
    from repro_torch.kernels.fastpath import kernel

    dev = torch.device("cuda", torch.cuda.current_device())
    rs = np.random.RandomState(0)
    kernel.reset_launches()
    registry.default_registry.fallback_counts.clear()

    def as_batch(keys) -> torch.Tensor:
        # jnp.asarray of int64 addresses is int32 with 64-bit types off
        return torch.as_tensor(np.asarray(keys).reshape(-1, 1)
                               .astype(np.int32), device=dev)

    fig4 = []
    for m in FIG4_TABLES:
        lookup, nets, _ = _make_lpm(m, rs, dev)
        hot = nets[:FIG4_HOT] | 1
        hot_keys = hot.reshape(-1, 1)
        hot_vals = lookup(as_batch(hot_keys)).cpu().numpy()
        fp = make_fastpath(lookup, FastPathTable.from_arrays(
            hot_keys, hot_vals), key_dtype=torch.int64,
            value_dtype=torch.int64)
        batch = as_batch(rs.choice(hot, ROUTER_BATCH))
        launches = kernel.launches
        out, expect = fp(batch), lookup(batch)
        if kernel.launches != launches + 1 or not torch.equal(out, expect):
            fail(f"fig4 M={m}: the fast path's output differs from the "
                 f"generic's (or the matcher did not launch)")
        ms_g = cuda_time_ms(lambda: lookup(batch), 100, 10)
        ms_f = cuda_time_ms(lambda: fp(batch), 100, 10)
        fig4.append({"M": m, "generic_ms": ms_g, "fastpath_ms": ms_f})
        log(f"fig4 M={m}: generic {ms_g:.4f} ms, fast path {ms_f:.4f} ms "
            f"a batch of {ROUTER_BATCH} (all hit; speedup {ms_g / ms_f:.2f}"
            f"x)")
        if m in FIG4_PROFILE:
            fig4[-1].update(_router_profile(fp, batch, m, ms_f))

    fig4_launches = kernel.launches
    kernel.reset_launches()

    # Fig 9.  The Explorer ranks the table sizes by the handler's call
    # rate, the reference's metric.  On the card that rate barely moves
    # with the table or with the traffic: the generic runs on the whole
    # batch unless every row hits, which a batch of thousands of Zipf
    # addresses never does against 16 entries.  So the change detector
    # watches what the shift does move, the share of the last dwell's rows
    # that the installed table holds (counted here by torch.isin, beside
    # the router), and ignores the call rate the Explorer hands it.
    lookup, nets, _ = _make_lpm(FIG9_TABLE, rs, dev)
    gen = RequestGenerator(seed=2)
    # hot addresses drawn from the LPM nets so lookups are meaningful
    gen._hot_keys = nets[:4096] | 1
    rt = IridescentRuntime(async_compile=False)
    rt.add_custom_spec("fastpath", lambda tbl: make_fastpath(
        lookup, tbl, key_dtype=torch.int64, value_dtype=torch.int64))

    def builder(spec):
        fp = spec.custom("table", "fastpath")
        return fp if fp is not None else lookup

    h = rt.register("router", builder)
    h(as_batch(gen.keys(ROUTER_BATCH)))
    held = collections.deque(maxlen=FIG9_DWELL)   # rows a call, in the table
    table_keys = {}                               # table -> its keys on dev

    class TableShareChange(ChangeDetector):
        def update(self, _rate: float) -> bool:
            return super().update(sum(held) / (max(1, len(held))
                                               * ROUTER_BATCH))

    def on_instrumented(ex):
        obs = h.spec_space().observed
        cands = []
        for size in FIG9_SIZES:
            tbl = build_table(obs, "addr", size,
                              lambda k: lookup(k.reshape(1, 1)).ravel())
            if tbl is not None:
                table_keys[tbl] = tbl.key_array(torch.int64, dev).ravel()
                cands.append({"table": tbl})
        ex.policy.candidates = cands
        ex.policy.reset()

    ex = Explorer(
        h, ExhaustiveSweep([]), dwell=FIG9_DWELL,
        change_detector=TableShareChange(0.4, warmup=0),
        instrument_iters=100, instrument_rate=0.25,
        collectors={"addr": lambda a, k: int(a[0][0, 0].item())},
        on_instrumented=on_instrumented)

    half = FIG9_ITERS // 2
    sizes, explorations, rows_held, wall = {}, {}, {0: 0, 1: 0}, {}
    t_phase = time.perf_counter()
    compared = 0
    for i in range(FIG9_ITERS):
        part = 0 if i < half else 1
        if i == half:
            gen.shift()                   # disjoint address set
            explorations[0] = ex.explorations
            wall[0] = time.perf_counter() - t_phase
            t_phase = time.perf_counter()
        batch = as_batch(gen.keys(ROUTER_BATCH))
        out = h(batch)
        tbl = h.active_config().get("table")
        held.append(int(torch.isin(batch.ravel(), table_keys[tbl]).sum())
                    if isinstance(tbl, FastPathTable) else 0)
        rows_held[part] += held[-1]
        if i % 10 == 0:
            compared += 1
            if not torch.equal(out, lookup(batch)):
                fail(f"fig9 step {i}: the router's output differs from the "
                     f"generic's (config {_config_str(h.active_config())})")
        ex.step()
        if ex.phase is Phase.EXPLOIT:             # the size it installed
            cfg = h.active_config().get("table")
            sizes[part] = cfg.n if isinstance(cfg, FastPathTable) else 0
    torch.cuda.synchronize()
    wall[1] = time.perf_counter() - t_phase
    explorations[1] = ex.explorations
    for part in (0, 1):
        log(f"fig9 phase {part}: installed fast-path size "
            f"N={sizes.get(part)} by call rate, "
            f"{FIG9_ITERS // 2} batches of {ROUTER_BATCH} in "
            f"{wall[part]:.2f}s ({FIG9_ITERS / 2 / wall[part]:.1f} calls/s, "
            f"{rows_held[part] / (FIG9_ITERS / 2 * ROUTER_BATCH):.3f} of the "
            f"rows held by the table), explorations so far "
            f"{explorations[part]}")
    for phase, config, rate in ex.history:
        n_tbl = config.get("table") if config else None
        if phase.value == "explore":
            log(f"fig9: explore N={n_tbl.n} -> {rate:.1f} calls/s")
    launched = kernel.launches
    fallbacks = {f"{k[0]}/{k[1]}": v for k, v in
                 registry.default_registry.fallback_counts.items()}
    log(f"fig9: explorations {ex.explorations} (re-instrumented after the "
        f"shift: {explorations[1] > explorations[0]}), output == generic "
        f"on {compared} sampled steps; fastpath cuda launches={launched} "
        f"(fig 4: {fig4_launches}), fallbacks={json.dumps(fallbacks)}")
    if explorations[1] <= explorations[0]:
        fail("fig9: the Explorer did not re-instrument after the shift")
    if not sizes.get(1):
        fail("fig9: the Explorer installed no fast path after the shift")
    if launched == 0:
        fail("the router path never launched the fast-path matcher")
    if fallbacks:
        fail(f"the router path fell back: {fallbacks}")
    rt.shutdown()
    return {"launches": launched, "fig4_launches": fig4_launches,
            "fig4": fig4, "sizes": sizes, "explorations": ex.explorations,
            "launches_per_call": max(r["launches_per_call"] for r in fig4
                                     if "launches_per_call" in r)}


def _router_profile(fp, batch, m: int, eager_ms: float) -> dict:
    """The device's busy share over a steady window of all-hit calls of
    the specialized function, by the profiler, and its launches a call;
    fails unless each call launched K5 once and nothing else."""
    import torch

    from repro_torch.kernels.fastpath import kernel

    for _ in range(10):
        fp(batch)
    before = kernel.launches
    prof, wall, windows = profiled(lambda: fp(batch), FIG4_PROFILE_CALLS)
    rep = _report_profile(prof, wall, FIG4_PROFILE_CALLS,
                          what=f"fig4 M={m} all-hit fast-path calls (profiler "
                               f"on)", unit="call")
    if not rep:
        fail(f"fig4 M={m}: the profiler saw no device activity")
    launched = collections.Counter()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            launched[e.key] += e.count
    others = {k[:80]: c for k, c in launched.items()
              if not re.search(r"(dense|hashed)_kernel", k)}
    per_call = sum(launched.values()) / FIG4_PROFILE_CALLS
    k5_per_call = (kernel.launches - before) / (windows * FIG4_PROFILE_CALLS)
    # The profiler may drop a short window's first activities: it decides
    # what ran, kernel.launches how often.
    if others or k5_per_call != 1 or per_call > 1:
        fail(f"fig4 M={m}: an all-hit call of the specialized function "
             f"made {k5_per_call:g} K5 launches and {per_call:g} device "
             f"ops, not one K5 launch (others: {others})")
    log(f"fig4 M={m}: device busy {100 * rep['busy_ms'] / rep['wall_ms']:.2f}"
        f" % of the profiled window, {100 * rep['busy_ms'] / eager_ms:.2f} % "
        f"of an unprofiled call ({eager_ms:.4f} ms); {k5_per_call:g} K5 "
        f"launch a call, {per_call:g} device ops a call seen by the profiler "
        f"({', '.join(k[:60] for k in launched)})")
    return {"busy_share": rep["busy_ms"] / rep["wall_ms"],
            "busy_share_unprofiled": rep["busy_ms"] / eager_ms,
            "device_ms": rep["busy_ms"], "profiled_ms": rep["wall_ms"],
            "launches_per_call": k5_per_call,
            "device_ops_per_call": per_call}



# -- phases 14-16: warm restart, tenants, fleet -----------------------------------

def _library_logs() -> dict:
    from repro_torch.kernels import build

    return {name: {"built": info["built"],
                   "seconds": round(info["seconds"], 4)}
            for name, info in build.build_logs().items()}


def restart_run(cache_dir: str) -> None:
    """One run of the restart phase, in a process of its own (``python3
    chip_smoke.py --restart-run DIR``): full-width qwen3 with
    ``--cache-dir DIR`` serves until its contexts settle, shuts down
    (saving spec_state), and prints one JSON line."""
    import torch

    from repro_torch import compat, configs
    from repro_torch.kernels.rmsnorm import kernel
    from repro_torch.launch.serve import build_engine, synthetic_workload

    compat.resolve_device("cuda")
    cfg = configs.get_config("qwen3-0.6b").replace(compute_dtype="float32")
    args = engine_args(RESTART_ARGS + ["--cache-dir", cache_dir])
    t0 = time.perf_counter()
    built = build_engine(args, cfg=cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    engine, ctl, handler = built.engine, built.controller, built.handler
    seeded = {k: dict(v) for k, v in handler._seeded.items()}
    offered = iter([r for _, r in synthetic_workload(
        RESTART_STEP_CAP, 1000.0, seed=0)])
    served = []
    labels = ("cache_dtype", "rmsnorm_impl")
    admitted = {}                        # context -> (phase, config) at entry
    kernel.reset_launches()
    t0 = time.perf_counter()
    settled_s = None
    steps = 0
    while steps < RESTART_STEP_CAP \
            and time.perf_counter() - t0 < RESTART_TIMEOUT_S:
        if not engine.active and not len(engine.queue):
            if settled_s is not None:
                break
            served.append(next(offered))
            engine.submit(served[-1])
        engine.step()
        steps += 1
        for k, st in ctl.status().items():
            admitted.setdefault(k, (st["phase"], {
                label: st["active"].get(label) for label in labels}))
        if settled_s is None and {k[0] for k in ctl.contexts()} == {
                "prefill", "decode"} and ctl.settled():
            settled_s = time.perf_counter() - t0
            # Settled: stop exploring (host-clock noise can re-trigger the
            # change detector), finish the request in flight, then save.
            engine.controller = None
    engine.drain(timeout_s=120.0)
    engine.controller = ctl
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    status = ctl.status()
    contexts = {repr(k): {"phase": st["phase"],
                          "explorations": st["explorations"],
                          "at_admission": admitted[k][0],
                          "active": {label: repr(st["active"].get(label))
                                     for label in labels}}
                for k, st in status.items()}
    checked = [(admitted[k], seeded[_encode(k)]) for k in admitted
               if _encode(k) in seeded]
    seeded_ok = bool(checked) and all(
        phase == "exploit" and all(cfg[label] == want.get(label)
                                   for label in labels)
        for (phase, cfg), want in checked)
    tokens_ok = all(r.payload is not None
                    and len(r.payload) == r.max_new_tokens
                    and all(0 <= t < cfg.vocab_size for t in r.payload)
                    for r in served)
    out = {"restored": built.restored,
           "seeded": sorted(seeded),
           "seeded_ok": seeded_ok,
           "build_s": build_s, "settled_s": settled_s, "wall_s": wall,
           "steps": steps, "requests": len(served), "tokens_ok": tokens_ok,
           "contexts": contexts,
           "launches": kernel.launches,
           "compile": built.rt.compile_stats(),
           "libraries": _library_logs()}
    engine.shutdown(state_dir=cache_dir)
    print(json.dumps(out), flush=True)


def _encode(key) -> str:
    from repro_torch.core import encode_context_key

    return encode_context_key(key)


def _run(cmd: list, timeout_s: float, what: str) -> tuple[str, float]:
    """Run ``cmd`` from the checkout with the port on the path; its
    stdout and wall seconds.  Fails on a non-zero exit or a timeout (the
    child is killed)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s, cwd=ROOT, env=env)
    except subprocess.TimeoutExpired:
        fail(f"{what} did not finish in {timeout_s:.0f}s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{what} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-6000:]}")
    return proc.stdout, wall


class _LibraryMovedOut:
    """K1's built library moved out of the build directory for the block
    (a run inside finds none and must build it or take it from the variant
    cache), and put back after."""

    def __init__(self):
        from repro_torch.kernels import build
        from repro_torch.kernels.rmsnorm import kernel

        self.path = build.library_path("rmsnorm", kernel.SOURCE)
        self.kept = self.path.with_name(self.path.name + ".kept")

    def clear(self) -> None:
        self.path.unlink(missing_ok=True)

    def __enter__(self):
        if not self.path.is_file():
            fail(f"K1's library {self.path} is not built")
        os.replace(self.path, self.kept)
        return self

    def __exit__(self, *exc):
        os.replace(self.kept, self.path)
        return False


def phase_restart() -> dict:
    """Phase 14: full-width qwen3 with ``--cache-dir``, cold then warm,
    each in a fresh process with K1's library out of the build directory:
    the cold run builds it with nvcc, explores and saves; the warm run
    restores, seeds its contexts (EXPLOIT, saved configs) and loads K1 from
    the variant cache with no nvcc build."""
    cache_dir = tempfile.mkdtemp(prefix="restart_", dir=SCRATCH)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--restart-run",
           cache_dir]
    runs = {}
    with _LibraryMovedOut() as lib:
        for name in ("cold", "warm"):
            lib.clear()
            out, wall = _run(cmd, RESTART_TIMEOUT_S + 300,
                             f"the {name} restart run")
            runs[name] = (json.loads(out.strip().splitlines()[-1]), wall)
    (cold, cold_wall), (warm, warm_wall) = runs["cold"], runs["warm"]
    for name, run, wall in (("cold", cold, cold_wall),
                            ("warm", warm, warm_wall)):
        log(f"restart {name}: process {wall:.1f}s, engine built in "
            f"{run['build_s']:.2f}s, time-to-settled "
            f"{run['settled_s']}s, {run['steps']} steps, "
            f"{run['requests']} requests, K1 launches {run['launches']}, "
            f"restored={run['restored']} seeded={run['seeded']}, "
            f"builds={json.dumps(run['compile']['xla_compiles'])} "
            f"cache_hits={run['compile']['cache_hits']} "
            f"libraries={json.dumps(run['libraries'])}")
        log(f"restart {name}: contexts {json.dumps(run['contexts'])}")
    nvcc_s = cold["libraries"].get("rmsnorm", {}).get("seconds", 0.0)
    log(f"restart: time-to-settled cold {cold['settled_s']}s -> warm "
        f"{warm['settled_s']}s; nvcc seconds saved {nvcc_s}; warm cache "
        f"hits {warm['compile']['cache_hits']}")
    shutil.rmtree(cache_dir, ignore_errors=True)
    if cold["settled_s"] is None:
        fail("the cold restart run did not settle its contexts")
    if not cold["libraries"].get("rmsnorm", {}).get("built"):
        fail("the cold restart run did not build K1 with nvcc")
    if not warm["restored"] or not warm["seeded"] or not warm["seeded_ok"]:
        fail(f"the warm run did not start its contexts from the saved "
             f"configs: {warm['seeded']} {warm['contexts']}")
    built = [n for n, i in warm["libraries"].items() if i["built"]]
    if built or "rmsnorm" not in warm["libraries"]:
        fail(f"the warm run built {built} with nvcc or never loaded K1: "
             f"{warm['libraries']}")
    if warm["compile"]["cache_hits"] <= 0:
        fail("the warm run counted no cache hit")
    if warm["settled_s"] is None:
        fail("the warm run did not settle")
    for name, run in (("cold", cold), ("warm", warm)):
        if run["launches"] <= 0:
            fail(f"the {name} restart run launched K1 no time")
        if not run["tokens_ok"]:
            fail(f"the {name} restart run served a request wrongly")
    return {"cold": cold, "warm": warm, "nvcc_s": nvcc_s,
            "cold_wall": cold_wall, "warm_wall": warm_wall,
            "launches": warm["launches"]}


def _frozen_group(stacks):
    """A ControllerGroup over the tenants' handlers sweeping what
    ``build_tenant_engine``'s Controllers sweep, with no change detector
    (a settled context stays settled)."""
    from repro_torch.core import ChangeDetector, Controller, ExhaustiveSweep
    from repro_torch.serve import ControllerGroup

    pairs = []
    for st in stacks.values():
        space = st.handler.spec_space()
        labels = ["cache_dtype", "rmsnorm_impl"] + (
            ["chunk_len"] if st.cfg.mixer == "rwkv6" else [])
        pairs.append((st.handler, Controller(
            st.handler, (lambda space=space, labels=labels:
                         ExhaustiveSweep.from_space(space, labels)),
            dwell=2, change_detector=lambda: ChangeDetector(float("inf")),
            wait_compiles=False, prefetch=2)))
    return ControllerGroup(pairs)


def phase_tenants() -> dict:
    """Phase 15: a full-width qwen3 tenant and a full-width rwkv6 tenant
    (DRR weights 2:1) served on the card; their contexts disjoint, both
    tenants' steps launching K1; then the tenant contexts restored from
    spec_state with zero builds."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import registry
    from repro_torch.kernels.rmsnorm import kernel
    from repro_torch.launch.serve import build_tenant_engine, tenant_schedule
    from repro_torch.serve import OpenLoopSource, Request, parse_tenant_arg

    tenants = [parse_tenant_arg(t, default_slo_ms=2000.0) for t in TENANTS]
    cfgs = {"q": configs.get_config("qwen3-0.6b"),
            "r": configs.get_config("rwkv6-1.6b")}
    cfgs = {k: c.replace(compute_dtype="float32") for k, c in cfgs.items()}
    state = tempfile.mkdtemp(prefix="tenants_", dir=SCRATCH)
    args = engine_args(TENANT_ARGS + ["--cache-dir", state])
    t0 = time.perf_counter()
    built = build_tenant_engine(args, tenants, cfgs=cfgs)
    torch.cuda.synchronize()
    log(f"tenants: built {len(tenants)} full-width tenants in "
        f"{time.perf_counter() - t0:.1f}s")
    params = {n: st.params for n, st in built.stacks.items()}
    engine, group = built.engine, built.group
    per = {n: {"steps": 0, "s": 0.0, "launches": 0} for n in built.stacks}
    for name, ex in engine.executor.executors.items():
        def wrapped(batch, _ex=ex.execute, _p=per[name]):
            before, t = kernel.launches, time.perf_counter()
            out = _ex(batch)
            _p["s"] += time.perf_counter() - t
            _p["steps"] += 1
            _p["launches"] += kernel.launches - before
            return out
        ex.execute = wrapped
    schedule = tenant_schedule(args, tenants)
    requests = [r for _, r in schedule]
    kernel.reset_launches()
    registry.default_registry.fallback_counts.clear()
    t0 = time.perf_counter()
    engine.run(source=OpenLoopSource(engine.queue, schedule),
               max_steps=2000, duration_s=300.0)
    # finish what is in flight, admission left open (drain would close it)
    while (engine.active or len(engine.queue)) \
            and time.perf_counter() - t0 < 300.0:
        engine.step()
    drained = all(r.done for r in requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    fallbacks = dict(registry.default_registry.fallback_counts)
    per_main = {n: dict(p) for n, p in per.items()}
    served = engine.stats()["serve"]
    log(f"tenants: served {served['completed']}/{len(requests)} requests, "
        f"{served['completed_tokens']} tokens in {wall:.1f}s; K1 launches "
        f"{launches}, fallbacks {fallbacks}")
    for name, sub in served["tenants"].items():
        p = per_main[name]
        log(f"tenant {name}: completed={sub['completed']} latency p50/p95/"
            f"p99 ms {sub['latency_p50_ms']} / {sub['latency_p95_ms']} / "
            f"{sub['latency_p99_ms']}; {p['steps']} steps, "
            f"{1e3 * p['s'] / max(p['steps'], 1):.2f} ms a step (host "
            f"clock), K1 launches {p['launches']}")
    # For the restore: the tenants' Controllers with the change detector
    # off (as tests/test_serve_tenants.py's restore case runs them), each
    # tenant offered one request at a time until its contexts settle.
    engine.controller = group = _frozen_group(built.stacks)
    ctls = {n: group.controllers[st.handler.name]
            for n, st in built.stacks.items()}
    extra = 0
    for _ in range(TENANT_SETTLE_CAP):
        if group.settled() and len(group.contexts()) >= 4:
            break
        for t in tenants:
            done = ctls[t.name].settled() and len(
                ctls[t.name].contexts()) >= 2
            if not done and \
                    not any(r.tenant == t.name for r in engine.active) and \
                    not engine.queue.peek_tenant(t.name):
                engine.submit(Request(prompt_tokens=64, max_new_tokens=4,
                                      tenant=t.name))
                extra += 1
        engine.step()
    engine.drain(timeout_s=300.0)
    settled = group.settled()
    tuned = {n: {_encode(k): dict(c) for k, c in ctl.best_configs().items()
                 if c is not None}
             for n, ctl in group.controllers.items()}
    contexts = {n: [k for k in st.handler.contexts() if k != "default"]
                for n, st in built.stacks.items()}
    engine.shutdown(state_dir=state)
    log(f"tenants: settled={settled} after {extra} more requests; contexts "
        f"{json.dumps({n: [repr(k) for k in c] for n, c in contexts.items()})}")

    if not drained or served["completed"] != len(requests):
        fail(f"tenants served {served['completed']} of {len(requests)}")
    for r in requests:
        vocab = cfgs[r.tenant].vocab_size
        if r.payload is None or len(r.payload) != r.max_new_tokens or \
                not all(0 <= t < vocab for t in r.payload):
            fail(f"tenant request {r.rid} got {r.payload!r}")
    for n, keys in contexts.items():
        if not keys or any(k[0] != n for k in keys):
            fail(f"tenant {n}'s contexts are not its own: {keys}")
        if per_main[n]["launches"] <= 0:
            fail(f"tenant {n}'s steps launched K1 no time")
    if any(k[0].startswith("rmsnorm") for k in fallbacks):
        fail(f"rmsnorm fell back on the tenant path: {fallbacks}")
    if not settled:
        fail("the tenant contexts did not settle")

    # -- restore the tenant contexts from spec_state: zero builds ----------
    del built, engine, group
    torch.cuda.empty_cache()
    again = build_tenant_engine(args, tenants, cfgs=cfgs, params=params)
    again.engine.controller = again.group = _frozen_group(again.stacks)
    seeded = {n: sorted(st.handler._seeded)
              for n, st in again.stacks.items()}
    for _ in range(40):
        for t in tenants:
            if not any(r.tenant == t.name for r in again.engine.active) and \
                    not again.engine.queue.peek_tenant(t.name):
                again.engine.submit(Request(prompt_tokens=64,
                                            max_new_tokens=4,
                                            tenant=t.name))
        again.engine.step()
    again.engine.drain(timeout_s=300.0)
    warm = again.rt.compile_stats()
    restored_ok = all(
        ctl.settled(context=k) and
        _encode(k) in tuned[n] and
        dict(ctl.best_configs()[k]) == tuned[n][_encode(k)]
        for n, ctl in again.group.controllers.items()
        for k in ctl.contexts() if _encode(k) in tuned[n])
    again.engine.shutdown()
    shutil.rmtree(state, ignore_errors=True)
    log(f"tenants restore: restored={again.restored} seeded {seeded}; "
        f"builds={warm['xla_compiles']} cache_hits={warm['cache_hits']} "
        f"same configs={restored_ok}")
    if not again.restored or not all(seeded.values()):
        fail(f"the tenant contexts were not seeded: {seeded}")
    if warm["xla_compiles"] != 0 or warm["cache_hits"] <= 0:
        fail(f"the tenant restore built variants: {warm}")
    if not restored_ok:
        fail("a restored tenant context did not keep its saved config")
    return {"launches": launches, "per_tenant": per_main,
            "served": served, "wall": wall,
            "restore": {"builds": warm["xla_compiles"],
                        "cache_hits": warm["cache_hits"]}}


def _fleet_replicas(out: str) -> dict:
    """``replica N: ... rmsnorm_launches=.. libraries={..} compile={..}``
    lines of the fleet driver, parsed."""
    reps = {}
    for line in out.splitlines():
        m = re.match(r"replica (\S+): steps=(\d+) time_to_settled_s=(\S+) "
                     r"rmsnorm_launches=(\d+) libraries=(\{.*\}) "
                     r"compile=(\{.*\})$", line)
        if m:
            reps[m.group(1)] = {
                "steps": int(m.group(2)),
                "time_to_settled_s": (None if m.group(3) == "None"
                                      else float(m.group(3))),
                "launches": int(m.group(4)),
                "libraries": json.loads(m.group(5)),
                "compile": json.loads(m.group(6))}
    return reps


def phase_fleet() -> dict:
    """Phase 16: ``python -m repro_torch.launch.serve --replicas 2`` with a
    plane and a portable cache on the card, at the CLI's reduced width,
    cold (K1's library out of the build directory: the replicas build it)
    then warm (out again: the replicas load it from the shared cache and
    start from the plane); the snapshot rendered by launch.status."""
    plane = tempfile.mkdtemp(prefix="plane_", dir=SCRATCH)
    cache = tempfile.mkdtemp(prefix="fleet_", dir=SCRATCH)
    snap = os.path.join(cache, "snapshot.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *FLEET_ARGS,
           "--plane-dir", plane, "--cache-dir", cache,
           "--telemetry-snapshot", snap]
    runs = {}
    with _LibraryMovedOut() as lib:
        for name in ("cold", "warm"):
            lib.clear()
            out, wall = _run(cmd, FLEET_TIMEOUT_S, f"the {name} fleet")
            reps = _fleet_replicas(out)
            served = re.search(r"fleet served (\d+) requests", out)
            pct = re.search(r"fleet p50/p95/p99 latency ms: (.*)$", out,
                            re.M)
            log(f"fleet {name}: process {wall:.1f}s; "
                + "; ".join(ln for ln in out.splitlines()
                            if ln.startswith(("fleet", "router"))))
            for r, st in sorted(reps.items()):
                log(f"fleet {name} replica {r}: steps={st['steps']} "
                    f"time_to_settled_s={st['time_to_settled_s']} "
                    f"K1 launches={st['launches']} builds="
                    f"{st['compile']['xla_compiles']} cache_hits="
                    f"{st['compile']['cache_hits']} libraries="
                    f"{json.dumps(st['libraries'])}")
            want = 2 * int(FLEET_ARGS[FLEET_ARGS.index("--requests") + 1])
            if "fleet: 2 workers ready" not in out or len(reps) != 2:
                fail(f"the {name} fleet did not run two workers:\n{out}")
            if served is None or int(served.group(1)) != want:
                fail(f"the {name} fleet served {served and served.group(1)}"
                     f" of {want} requests")
            if pct is None:
                fail(f"the {name} fleet printed no merged percentiles")
            if any(st["launches"] <= 0 for st in reps.values()):
                fail(f"a {name} replica launched K1 no time")
            runs[name] = {"wall": wall, "replicas": reps,
                          "percentiles": pct.group(1)}
    status = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.status", snap],
        capture_output=True, text=True, timeout=60, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    log("fleet status:\n" + status.stdout.rstrip())
    shutil.rmtree(plane, ignore_errors=True)
    shutil.rmtree(cache, ignore_errors=True)
    if status.returncode != 0 or "[fleet]" not in status.stdout:
        fail(f"launch.status did not render the fleet snapshot: "
             f"{status.stdout}{status.stderr}")
    warm = runs["warm"]["replicas"]
    built = {r: [n for n, i in st["libraries"].items() if i["built"]]
             for r, st in warm.items()}
    if any(built.values()) or any("rmsnorm" not in st["libraries"]
                                  for st in warm.values()):
        fail(f"a warm replica built a library with nvcc: {built}")
    if any(st["compile"]["cache_hits"] <= 0 for st in warm.values()):
        fail("a warm replica counted no cache hit")
    if not any(i["built"] for st in runs["cold"]["replicas"].values()
               for i in st["libraries"].values()):
        fail("no cold replica built K1 with nvcc")
    return {"runs": runs,
            "launches": sum(st["launches"] for st in warm.values())}

def _hold_kernel(what: str, out, ref, limits) -> float:
    """Hold a kernel's ``out`` to its plain version's ``ref`` within each
    (rtol, atol) of ``limits``; its largest difference."""
    import torch

    if out.shape != ref.shape or out.dtype != ref.dtype:
        fail(f"{what}: got {tuple(out.shape)} {out.dtype}, wanted "
             f"{tuple(ref.shape)} {ref.dtype}")
    for rt, at in limits:
        torch.testing.assert_close(
            out, ref, rtol=rt, atol=at,
            msg=lambda m: f"{what} (rtol {rt}, atol {at}): {m}")
    return (out - ref).abs().max().item()


def phase_family_kernels() -> dict:
    """Phase 17a: K1, K2 and K4 against their plain versions at the shapes
    the families' (1, 4096) prefills give them, fp32: K1 at every width,
    K2 at every family's heads (hymba's with its window) at every tile
    pair, K4 as hymba's SSM heads call it (q = C and k = B one row a step
    broadcast over the heads, one log decay a (head, step) broadcast over
    the state) at every chunk.  Then K2 at hymba's windowed shape and K4 at
    hymba's shape timed beside the plain version, the library call (K2:
    ``scaled_dot_product_attention`` with the window as a mask) and the
    bound (K2 counting only the pairs under the window)."""
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.linear_attention import kernel as la_kernel
    from repro_torch.kernels.linear_attention import ops as la_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    s = FAMILY_PREFILL[1]
    cfgs = [configs.get_config(a) for a in FAMILY_ARCHS]
    tiles = [(bq, bkv) for bq in attn_kernel.BLOCK_Q
             for bkv in attn_kernel.BLOCK_KV]
    err = {"rmsnorm": 0.0, "attention": 0.0, "linear_attention": 0.0}
    checked = collections.Counter()

    def hold(family, what, out, ref, limits):
        torch.cuda.synchronize()
        err[family] = max(err[family], _hold_kernel(f"{family} {what}", out,
                                                    ref, limits))
        checked[family] += 1

    rms_limits = [(TOL["float32"], TOL["float32"])]
    attn_limits = [(ATTN_TOL["float32"],) * 2, ATTN_SCALED_TOL["float32"]]
    la_limits = [(LINATT_TOL["float32"],) * 2, LINATT_SCALED_TOL["float32"]]
    widths = sorted({c.d_model for c in cfgs})
    for d in widths:
        x = torch.randn((s, d), generator=gen, device=dev)
        w = 1 + 0.1 * torch.randn((d,), generator=gen, device=dev)
        hold("rmsnorm", f"({s}, {d})", rms_ops.rmsnorm(x, w, impl="cuda"),
             rms_ops.rmsnorm(x, w, impl="torch_ref"), rms_limits)
    heads = sorted({(c.n_heads, c.n_kv_heads, c.d_head, c.window or 0)
                    for c in cfgs})
    for h, hk, dh, window in heads:
        window = window or None
        q = torch.randn((1, h, s, dh), generator=gen, device=dev)
        k, v = (torch.randn((1, hk, s, dh), generator=gen, device=dev)
                for _ in range(2))
        ref = attn_ops.attention(q, k, v, window=window, impl="torch_ref")
        for bq, bkv in tiles:
            hold("attention", f"(1,{h}/{hk},{s},{dh}) window={window} "
                 f"tiles {bq}x{bkv}",
                 attn_ops.attention(q, k, v, window=window, impl="cuda",
                                    block_q=bq, block_kv=bkv), ref,
                 attn_limits)
        del q, k, v, ref
    hy = configs.get_config("hymba-1.5b")
    h, hk, n, dh, window = (hy.ssm_heads, hy.n_kv_heads, hy.ssm_state,
                            hy.d_head, hy.window)
    cq, ck = (torch.randn((1, s, n), generator=gen, device=dev)
              for _ in range(2))
    q, k = cq.expand(h, s, n), ck.expand(h, s, n)
    v = torch.randn((h, s, dh), generator=gen, device=dev)
    lw = -torch.rand((h, s, 1), generator=gen, device=dev).clamp(1e-4, 1.0)
    for c in la_kernel.CHUNKS:
        kw = dict(inclusive=True, chunk=c)
        hold("linear_attention", f"hymba ({h},{s},{n},{dh}) chunk {c}",
             la_ops.linear_attention(q, k, v, lw, impl="cuda", **kw),
             la_ops.linear_attention(q, k, v, lw, impl="torch_ref", **kw),
             la_limits)
    torch.cuda.empty_cache()
    log(f"family kernels: cuda == torch_ref for K1 at ({s}, d) d in "
        f"{widths} (tol {TOL['float32']:g}; max_abs_err "
        f"{err['rmsnorm']:.3e}), K2 at (1, H/Hk, {s}, dh, window) in "
        f"{heads} at tiles {tiles} (tols {attn_limits}; max_abs_err "
        f"{err['attention']:.3e}), K4 at hymba's ({h}, {s}, {n}, {dh}) "
        f"inclusive broadcast call at chunks {la_kernel.CHUNKS} (tols "
        f"{la_limits}; max_abs_err {err['linear_attention']:.3e}); "
        f"{dict(checked)} checks")

    # K4 timed as the SSM calls it: the op makes q, k and the decay
    # contiguous (the decay expanded to (h, s, n)) before the kernel; the
    # kernel alone on those inputs, the op, and the plain version.
    qc, kc = q.contiguous(), k.contiguous()
    lwc = lw.expand(h, s, n).contiguous()
    la = {"shape": [h, s, n, dh], "kernel_ms_by_chunk": {},
          "op_ms_by_chunk": {}, "plain_ms_by_chunk": {},
          "bound_ms_by_chunk": {}, "bound_by_chunk": {}}
    for c in la_kernel.CHUNKS:
        la["kernel_ms_by_chunk"][str(c)] = cuda_time_ms(
            lambda c=c: la_kernel.linear_attention_cuda(
                qc, kc, v, lwc, inclusive=True, chunk=c), 100, 10)
        la["op_ms_by_chunk"][str(c)] = cuda_time_ms(
            lambda c=c: la_ops.linear_attention(
                q, k, v, lw, inclusive=True, chunk=c, impl="cuda"), 100, 10)
        la["plain_ms_by_chunk"][str(c)] = cuda_time_ms(
            lambda c=c: la_ops.linear_attention(
                q, k, v, lw, inclusive=True, chunk=c, impl="torch_ref"), 5, 1)
        (la["bound_ms_by_chunk"][str(c)],
         la["bound_by_chunk"][str(c)]) = _linatt_cost(h, s, n, dh, c, 4, True,
                                                      False)
    log(f"linear attention at hymba's SSM call ({h},{s},{n},{dh}) fp32 "
        f"inclusive, scalar decay: kernel "
        + " ".join(f"c{c} {ms:.4f} ({100 * la['bound_ms_by_chunk'][c] / ms:.1f}%)"
                   for c, ms in la["kernel_ms_by_chunk"].items())
        + " ms (% of the bound); the op with its copies "
        + " ".join(f"c{c} {ms:.4f}" for c, ms in la["op_ms_by_chunk"].items())
        + " ms; plain " + " ".join(f"c{c} {ms:.3f}" for c, ms in
                                   la["plain_ms_by_chunk"].items())
        + " ms; bound " + " ".join(
            f"c{c} {ms:.4f} ({la['bound_by_chunk'][c]})"
            for c, ms in la["bound_ms_by_chunk"].items()) + " ms")
    del q, k, v, lw, qc, kc, lwc, cq, ck

    # K2 timed at hymba's windowed prefill shape.
    q3 = torch.randn((h, s, dh), generator=gen, device=dev)
    k3, v3 = (torch.randn((hk, s, dh), generator=gen, device=dev)
              for _ in range(2))
    q4, k4, v4 = (x[None] for x in (q3, k3, v3))
    at = {"shape": [1, h, hk, s, dh, dh], "window": window,
          "kernel_ms_by_tiles": {
              f"{bq}x{bkv}": cuda_time_ms(
                  lambda bq=bq, bkv=bkv: attn_kernel.flash_attention_cuda(
                      q3, k3, v3, window=window, block_q=bq, block_kv=bkv),
                  50, 5)
              for bq, bkv in tiles},
          "plain_ms": cuda_time_ms(
              lambda: attn_ops.ref.attention(q4, k4, v4, window=window), 10,
              2)}
    pos = torch.arange(s, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                             > pos[:, None] - window)
    at["library_ms"] = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                               enable_gqa=True), 20, 3)
    torch.testing.assert_close(
        F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                       enable_gqa=True),
        attn_ops.ref.attention(q4, k4, v4, window=window),
        rtol=ATTN_TOL["float32"], atol=ATTN_TOL["float32"],
        msg=lambda m: f"sdpa with the window mask is not the same "
                      f"function: {m}")
    at["bound_ms"], at["bound_by"] = _attention_cost(1, h, hk, s, s, dh, dh,
                                                    4, True, window)
    at["pairs"] = _attention_pairs(s, s, True, window, 0)
    best = min(at["kernel_ms_by_tiles"], key=at["kernel_ms_by_tiles"].get)
    at["body"] = attn_kernel.body(torch.float32, dh, dh,
                                  block_q=int(best.split("x")[0]),
                                  block_kv=int(best.split("x")[1]))
    log(f"attention at hymba's prefill (1,{h}/{hk},{s},{dh}) fp32 causal, "
        f"window {window} ({at['pairs']} pairs of {s * (s + 1) // 2} "
        f"causal): kernel "
        + " ".join(f"{t} {ms:.4f} ({100 * at['bound_ms'] / ms:.1f}%)"
                   for t, ms in at["kernel_ms_by_tiles"].items())
        + f" ms (% of the bound; best {best}, {at['body']['body']} body); "
        f"plain {at['plain_ms']:.3f} ms; sdpa with the window mask "
        f"{at['library_ms']:.3f} ms; bound {at['bound_ms']:.4f} ms "
        f"({at['bound_by']})")
    del q3, k3, v3, q4, k4, v4, mask
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "checked": dict(checked),
            "hymba_attention": at, "hymba_linear_attention": la}


#: PyTorch's device kernels of the MoE dispatch, by name (phases 19-20):
#: the routing's top-k and the ``sort`` ranking (sorts, searchsorted),
#: the ``cumsum`` ranking (scans), and the scatters and gathers that build
#: the dispatch and capacity buffers and read them back (one-hot, index
#: put/copy/select; the embedding lookup's gather falls here too)
MOE_KERNEL_CLASSES = (
    (r"sort", "MoE top-k/sort"),
    (r"scan", "MoE cumsum"),
    (r"scatter|gather|index", "MoE scatter/gather"))


def _kernel_class(name: str, moe: bool = False) -> str:
    """The port's kernels by their CUDA symbols, the matrix products by
    cuBLAS's, (``moe``) the MoE dispatch's by PyTorch's, the rest as
    other."""
    classes = ((r"rmsnorm_(regs|general)", "K1 rmsnorm"),
               (r"\b(ring|fa_wgmma)_kernel", "K2 attention"),
               (r"\b(summary|fold|output)_kernel", "K4 linear attention"),
               (r"gemm|xmma|cutlass|cublas|nvjet", "GEMM"))
    for pattern, label in classes + (MOE_KERNEL_CLASSES if moe else ()):
        if re.search(pattern, name, re.IGNORECASE):
            return label
    return "other"


def _profile_by_kernel(prof, wall: float, what: str,
                       moe: bool = False) -> dict:
    """Device ms and CUDA launches of one profiled call by kernel class,
    and the device's busy share of the call's wall."""
    import torch

    ms, count = collections.Counter(), collections.Counter()
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        label = _kernel_class(e.key, moe)
        ms[label] += e.self_device_time_total / 1e3
        count[label] += e.count
    busy = sum(ms.values())
    log(f"profile: {what}: wall {1e3 * wall:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / (1e3 * wall):.1f}% of wall); by "
        f"kernel: " + ", ".join(
            f"{k} {v:.1f} ms ({100 * v / busy:.1f}%) x{count[k]}"
            for k, v in ms.most_common()))
    return {"wall_ms": 1e3 * wall, "busy_ms": busy,
            "busy_share": busy / (1e3 * wall), "ms_by_kernel": dict(ms),
            "cuda_launches_by_kernel": dict(count)}


def _prefill_sweep(what: str, cfg, params, batch, labels: list) -> dict:
    """A prefill handler under a Controller whose CoordinateDescent sweeps
    ``labels`` over calls on ``batch`` until it settles, as phase 9 runs
    rwkv6's (hymba: its kernel points; deepseek-v2: the attention points
    and the MoE dispatch)."""
    import torch

    from repro_torch.core import (DEFAULT_CONTEXT, Controller,
                                  CoordinateDescent, IridescentRuntime)
    from repro_torch.training import make_prefill_builder

    rt = IridescentRuntime(max_compile_workers=1)
    handler = rt.register("prefill_step", make_prefill_builder(cfg))
    space = handler.spec_space()
    controller = Controller(
        handler, lambda: CoordinateDescent(space, labels=labels,
                                           max_passes=1),
        dwell=PREFILL_DWELL, wait_compiles=True, prefetch=0)
    tokens = next(iter(batch.values())).shape[:2].numel()
    for calls in range(1, 101):
        logits = handler(params, batch)
        torch.cuda.synchronize()
        controller.step()
        if controller.settled():
            break
    else:
        fail(f"the {what} prefill Controller did not settle in 100 calls")
    if not torch.isfinite(logits[0, -1]).all():
        fail(f"{what} sweep: non-finite logits")
    del logits
    chosen = controller.best_configs()[DEFAULT_CONTEXT]
    rates = []
    for phase, config, rate in controller.histories()[DEFAULT_CONTEXT]:
        rates.append({"config": json.loads(_config_str(config)),
                      "tok_s": rate * tokens})
        log(f"{what} prefill sweep: {phase.value} {_config_str(config)} -> "
            f"{rate * tokens:.1f} tok/s ({1e3 / rate:.1f} ms/call)")
    log(f"{what} prefill sweep: settled after {calls} calls on "
        f"{_config_str(chosen)}")
    rt.shutdown()
    return {"calls": calls, "chosen": json.loads(_config_str(chosen)),
            "candidates": rates,
            "axes": {label: list(space[label].candidates())
                     for label in labels},
            "settled_tok_s": controller.best(DEFAULT_CONTEXT)[1] * tokens}


def _family_batch(cfg, shape: tuple) -> dict:
    """Phase 17b's input of ``shape``, from seed 17: tokens, or embeds for
    the stub frontends."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(17)
    if cfg.frontend:
        return {"embeds": torch.randn((*shape, cfg.d_model), generator=gen,
                                      device="cuda")}
    return {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                    device="cuda", dtype=torch.int32)}


def _plain_logits(cfg, params, batch):
    """The prefill handler's logits on ``batch`` pinned to every plain
    version, and the call's wall seconds."""
    import torch

    from repro_torch.core import IridescentRuntime
    from repro_torch.training import make_prefill_builder

    rt = IridescentRuntime(max_compile_workers=1)
    handler = rt.register("prefill_step", make_prefill_builder(cfg))
    labels = handler.spec_space().labels()
    _pin(handler, {label: "torch_ref" for label in (
        "rmsnorm_impl", "attention_impl", "linear_attention_impl")
        if label in labels})
    t = time.perf_counter()
    logits = handler(params, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    rt.shutdown()
    return logits, seconds


def _k_per_call(cfg) -> dict:
    """K1, K2 and K4 launches of one full-sequence forward of ``cfg``: a
    pre-norm pair and the final norm, the q/k pair (``qk_norm``), hymba's
    two mixer norms, rwkv6's per-head output norm; an attention a layer but
    in rwkv6; a linear attention a layer in rwkv6 and hymba."""
    layers, hymba = cfg.n_layers, cfg.mixer == "hymba"
    rwkv = cfg.mixer == "rwkv6"
    return {"rmsnorm": 2 * layers + 1 + (2 * layers if hymba else 0)
            + (layers if rwkv or cfg.qk_norm else 0),
            "attention": 0 if rwkv else layers,
            "linear_attention": layers if hymba or rwkv else 0}


def phase_family_prefill(arch: str, keep: bool, cfg=None,
                         shape: tuple = FAMILY_PREFILL, *, params=None,
                         plain32=None, sweep_labels=None) -> dict:
    """Phase 17b for one family at full width and full depth (or at
    ``cfg``: phase 20's reduced kimi-k2, phase 18b's half precision): one
    ``shape`` prefill through ``make_prefill_builder``'s generic variant,
    timed, then profiled, then the same call pinned to the plain versions;
    each call's K1, K2 and K4 launches from the wrappers' counts
    (:func:`_k_per_call`).  In fp32 the two logits agree within
    PARITY_TOL; given ``plain32``, the plain fp32 path's logits on the same
    weights and input (phase 18b), the kernels' half-precision logits lie
    within HALF_SPREAD times the plain half-precision path's own distance
    from them (skipped, and said, where the plain path is not finite).
    Then, given ``sweep_labels``, the handler runs a Controller sweep over
    them.  The weights (drawn from seed 0 unless ``params`` are given) are
    returned if ``keep``."""
    import torch

    from repro_torch import compat, configs
    from repro_torch.core import IridescentRuntime
    from repro_torch.kernels import registry
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.linear_attention import kernel as la_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.models import transformer as model
    from repro_torch.training import make_prefill_builder

    dev = torch.device("cuda")
    cfg = cfg or configs.get_config(arch).replace(compute_dtype="float32")
    hymba = cfg.mixer == "hymba"
    what = (arch if cfg.compute_dtype == "float32"
            else f"{arch} {cfg.compute_dtype}")
    torch.cuda.reset_peak_memory_stats()
    if params is None:
        t0 = time.perf_counter()
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in compat.tree_leaves(params))
        log(f"family prefill: {arch} ({cfg.n_layers} layers, d="
            f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
            f"{cfg.d_head}"
            f"{f', window {cfg.window}, {cfg.ssm_heads} SSM heads of state {cfg.ssm_state}' if hymba else ''}"
            f", d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
            f"{f', {cfg.frontend} frontend (embeds)' if cfg.frontend else ''}) "
            f"params {n_params / 1e6:.1f}M ({4 * n_params / 1e9:.2f} GB "
            f"fp32), drawn in {time.perf_counter() - t0:.1f}s")
    n_params = sum(p.numel() for p in compat.tree_leaves(params))
    b, s = shape
    batch = _family_batch(cfg, shape)
    rt = IridescentRuntime(max_compile_workers=1)
    handler = rt.register("prefill_step", make_prefill_builder(cfg))
    counters = {"rmsnorm": rms_kernel, "attention": attn_kernel,
                "linear_attention": la_kernel}
    per_call = _k_per_call(cfg)

    # the main path: the generic variant, twice (the second timed)
    for k in counters.values():
        k.reset_launches()
    registry.default_registry.fallback_counts.clear()
    seconds = []
    for _ in range(2):
        t = time.perf_counter()
        logits = handler(params, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
    launches = {n: k.launches for n, k in counters.items()}
    fallbacks = {f"{k[0]}/{k[1]}": v for k, v in
                 registry.default_registry.fallback_counts.items()}
    if fallbacks:
        fail(f"{what} prefill fell back: {fallbacks}")
    for n, want in per_call.items():
        if launches[n] != 2 * want:
            fail(f"{what} prefill: {n} launched {launches[n]} times over 2 "
                 f"calls; wanted {want} a call")
    finite = bool(torch.isfinite(logits).all())
    if logits.shape != (b, s, cfg.padded_vocab_size) or not (
            finite or plain32 is not None):
        fail(f"{what} prefill logits {tuple(logits.shape)} or non-finite")
    tok_s = b * s / seconds[1]
    prof, wall, _ = profiled(lambda: handler(params, batch), 1)
    profile = _profile_by_kernel(prof, wall, f"{what} full-width ({b}, {s}) "
                                 f"prefill call (generic variant, profiler "
                                 f"on)")
    del prof

    rt.shutdown()
    plain, plain_s = _plain_logits(cfg, params, batch)
    v = cfg.vocab_size
    rel = ((logits[..., :v] - plain[..., :v]).abs().max()
           / plain[..., :v].abs().max().clamp_min(1e-30)).item()
    agree = int((logits[..., :v].argmax(-1) == plain[..., :v].argmax(-1))
                .sum())
    half = None
    if plain32 is not None:
        half = {"kernel_err": (logits[..., :v] - plain32[..., :v]).abs()
                .max().item(),
                "plain_err": (plain[..., :v] - plain32[..., :v]).abs()
                .max().item(),
                "plain_finite": bool(torch.isfinite(plain).all()),
                "kernel_finite": finite,
                "max_abs_logit": plain32[..., :v].abs().max().item()}
    del logits, plain
    log(f"family prefill: {what} ({b}, {s}) {'embeds' if cfg.frontend else 'tokens'}: "
        f"generic variant {1e3 * seconds[1]:.1f} ms ({tok_s:.1f} tok/s; "
        f"first call {1e3 * seconds[0]:.1f} ms), plain {1e3 * plain_s:.1f} "
        f"ms; launches a call {per_call}; max relative logits diff "
        f"generic vs plain {rel:.3e}"
        f"{f' (tol {PARITY_TOL:g})' if half is None else ''}; argmax agrees "
        f"on {agree}/{b * s}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if half is None and rel > PARITY_TOL:
        fail(f"{what} prefill parity: relative diff {rel:.3e} > "
             f"{PARITY_TOL}")
    if half is not None:
        limit = HALF_SPREAD * half["plain_err"]
        log(f"family prefill: {what}: max |kernels - plain fp32| "
            f"{half['kernel_err']:.4e}, max |plain {cfg.compute_dtype} - "
            f"plain fp32| {half['plain_err']:.4e} (limit {HALF_SPREAD:g} x "
            f"that, {limit:.4e}); max |plain fp32 logit| "
            f"{half['max_abs_logit']:.3f}")
        if not half["plain_finite"]:
            log(f"family prefill: {what}: the plain {cfg.compute_dtype} "
                f"path is not finite at full width with these random "
                f"weights (the kernels' logits: "
                f"{'finite' if finite else 'not finite'}): the "
                f"configuration's range, not the kernels'; criterion "
                f"skipped")
        elif not finite:
            fail(f"{what} prefill: the kernels' logits are not finite where "
                 f"the plain {cfg.compute_dtype} path's are")
        elif not half["kernel_err"] <= limit:
            fail(f"{what} prefill: max |kernels - plain fp32| "
                 f"{half['kernel_err']:.4e} over {HALF_SPREAD:g} x the plain "
                 f"{cfg.compute_dtype} path's {half['plain_err']:.4e}")
    sweep = (_prefill_sweep(what, cfg, params, batch, sweep_labels)
             if sweep_labels else None)
    out = {"arch": arch, "n_params": n_params, "call_ms": 1e3 * seconds[1],
           "first_ms": 1e3 * seconds[0], "tok_s": tok_s,
           "plain_ms": 1e3 * plain_s, "max_rel": rel,
           "argmax_agree": agree, "launches": launches,
           "per_call": per_call, "profile": profile, "sweep": sweep,
           "half": half, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if keep:
        out["params"] = params
    del params, batch
    torch.cuda.empty_cache()
    return out


def phase_family_serve(arch: str, max_len: int, params, cfg=None) -> dict:
    """Phase 18 for one family: ``build_engine`` at full width (or at
    ``cfg``: phase 20's deepseek-v2 at depth 4 and reduced kimi-k2), batch
    4, serves FAMILY_SERVE_REQUESTS requests with every context pinned to
    the kernels (fp32 cache), then the same engine pinned to the plain
    versions; the greedy tokens must be equal."""
    import torch

    from repro_torch import configs
    from repro_torch.core import Controller, ExhaustiveSweep
    from repro_torch.kernels import registry
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve import OpenLoopSource, Request

    cfg = cfg or configs.get_config(arch).replace(compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    args = engine_args(FAMILY_SERVE_ARGS + ["--arch", arch, "--max-len",
                                            str(max_len)])
    extra = {"chunk_len": 64} if cfg.mixer == "hymba" else {}
    out = {}
    for impl in ("cuda", "torch_ref"):
        built = build_engine(args, cfg=cfg, params=params)
        pinned = {"cache_dtype": "float32", "rmsnorm_impl": impl, **extra}
        # every (phase, bucket) context on the pinned config before its
        # first step, and a Controller that proposes nothing else
        for key in itertools.product(("prefill", "decode"),
                                     range(1, args.batch + 1)):
            built.handler.specialize(pinned, wait=True, context=key)
        built.engine.controller = Controller(
            built.handler, lambda p=pinned: ExhaustiveSweep([dict(p)]),
            dwell=1000, wait_compiles=True, prefetch=0)
        spent = {"s": 0.0, "steps": 0}
        execute = built.engine.executor.handler

        def timed(*a, _fn=execute, **k):
            t = time.perf_counter()
            r = _fn(*a, **k)
            spent["s"] += time.perf_counter() - t
            spent["steps"] += 1
            return r

        built.engine.executor.handler = timed
        reqs = [Request(rid=5000 + i, prompt_tokens=FAMILY_SERVE_PROMPT,
                        max_new_tokens=FAMILY_SERVE_NEW)
                for i in range(FAMILY_SERVE_REQUESTS)]
        rms_kernel.reset_launches()
        registry.default_registry.fallback_counts.clear()
        t0 = time.perf_counter()
        built.engine.run(source=OpenLoopSource(built.engine.queue,
                                               [(0.0, r) for r in reqs]),
                         max_steps=2000, duration_s=300.0)
        drained = built.engine.drain(timeout_s=300.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rms_kernel.launches
        fallbacks = {f"{k[0]}/{k[1]}": v for k, v in
                     registry.default_registry.fallback_counts.items()}
        stats = built.engine.stats()
        served = stats["serve"]
        built.engine.shutdown()
        if not drained or served["completed"] != len(reqs) or any(
                r.payload is None or len(r.payload) != FAMILY_SERVE_NEW
                or not all(0 <= t < cfg.vocab_size for t in r.payload)
                for r in reqs):
            fail(f"{arch} serve ({impl}): served {served['completed']} of "
                 f"{len(reqs)} requests, payloads "
                 f"{[r.payload for r in reqs]}")
        if fallbacks:
            fail(f"{arch} serve ({impl}) fell back: {fallbacks}")
        if (launches == 0) == (impl == "cuda"):
            fail(f"{arch} serve ({impl}): {launches} K1 launches")
        out[impl] = {"tokens": {r.rid: list(r.payload) for r in reqs},
                     "wall_s": wall, "tok_s": served["completed_tokens"]
                     / wall, "p50_ms": served["latency_p50_ms"],
                     "p95_ms": served["latency_p95_ms"],
                     "host_ms_a_step": 1e3 * spent["s"]
                     / max(spent["steps"], 1),
                     "steps": stats["phase_steps"], "launches": launches,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"family serve: {arch} at batch {args.batch}, --max-len "
            f"{max_len}, pinned to {impl}: served {served['completed']} "
            f"requests ({FAMILY_SERVE_PROMPT} prompt + {FAMILY_SERVE_NEW} "
            f"new tokens), {served['completed_tokens']} tokens in "
            f"{wall:.2f}s ({out[impl]['tok_s']:.2f} tok/s); latency p50/p95 "
            f"ms {served['latency_p50_ms']} / {served['latency_p95_ms']}; "
            f"handler {out[impl]['host_ms_a_step']:.1f} ms a step (host "
            f"clock, {spent['steps']} steps {stats['phase_steps']}); K1 "
            f"launches {launches}; peak device memory "
            f"{out[impl]['peak_gb']:.2f} GB")
        del built
        torch.cuda.empty_cache()
    same = out["cuda"]["tokens"] == out["torch_ref"]["tokens"]
    log(f"family serve: {arch} greedy tokens, kernels vs plain: "
        f"{'equal' if same else 'DIFFER'} ({out['cuda']['tokens']})")
    if not same:
        fail(f"{arch} serve: greedy tokens differ between the kernels "
             f"{out['cuda']['tokens']} and the plain versions "
             f"{out['torch_ref']['tokens']}")
    return out

def phase_half(fp32_ms: dict) -> dict:
    """Phase 18b: half precision on the card.  Each of HALF_ARCHS at full
    width and depth (weights from seed 0, fp32 as every configuration
    keeps them; the model casts them to ``compute_dtype``) runs phase 17b's
    (1, 4096) prefill (:func:`phase_family_prefill`) in fp16 and in bf16,
    held to the plain fp32 path's logits on the same input (HALF_SPREAD);
    qwen3-0.6b's then sweeps HALF_SWEEP_LABELS under a Controller, every
    candidate of each run in both dtypes.  ``fp32_ms`` is each model's
    fp32 time a call from phases 7, 9 and 17, printed beside.  Then
    qwen3-0.6b is served in fp16 (:func:`_half_serve`)."""
    import torch

    from repro_torch import compat, configs
    from repro_torch.models import transformer as model

    dev = torch.device("cuda")
    out = {"prefill": {}, "launches": collections.Counter()}
    for arch in HALF_ARCHS:
        cfg = configs.get_config(arch).replace(compute_dtype="float32")
        t0 = time.perf_counter()
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg)
        torch.cuda.synchronize()
        drawn_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in compat.tree_leaves(params))
        batch = _family_batch(cfg, FAMILY_PREFILL)
        plain32, plain_s = _plain_logits(cfg, params, batch)
        if not torch.isfinite(plain32).all():
            fail(f"half: the plain fp32 {arch} prefill is not finite")
        log(f"half: {arch} ({cfg.n_layers} layers, d={cfg.d_model}, "
            f"{n_params / 1e6:.1f}M fp32 parameters drawn in "
            f"{drawn_s:.1f}s); the plain fp32 {FAMILY_PREFILL} prefill "
            f"{1e3 * plain_s:.1f} ms")
        del batch
        for dtype in HALF_DTYPES:
            hcfg = cfg.replace(compute_dtype=dtype)
            run = phase_family_prefill(
                arch, False, hcfg, params=params, plain32=plain32,
                sweep_labels=(HALF_SWEEP_LABELS if arch == "qwen3-0.6b"
                              else None))
            if run["sweep"] is not None:
                seen = {label: {_setting(c["config"], label)
                                for c in run["sweep"]["candidates"]}
                        for label in HALF_SWEEP_LABELS}
                missed = {label: [c for c in axis if c not in seen[label]]
                          for label, axis in run["sweep"]["axes"].items()}
                if any(missed.values()):
                    fail(f"half: {arch} {dtype} sweep never ran "
                         f"{missed}")
            out["launches"].update(run["launches"])
            out["prefill"][f"{arch} {dtype}"] = run
            log(f"half: {arch} {dtype} {FAMILY_PREFILL} prefill, generic "
                f"variant: "
                f"host {run['call_ms']:.1f} ms a call, device "
                f"{run['profile']['busy_ms']:.1f} ms "
                f"({100 * run['profile']['busy_share']:.1f}% busy); fp32 "
                f"{fp32_ms[arch]['ms']:.1f} ms ({fp32_ms[arch]['what']})")
        del params, plain32
        torch.cuda.empty_cache()
    out["serve"] = _half_serve()
    out["launches"]["rmsnorm"] += out["serve"]["launches"]
    return out


def _half_serve() -> dict:
    """qwen3-0.6b at full width served in fp16 through
    ``make_serve_builder``: one prefill chunk then HALF_SERVE's greedy
    decode steps at batch 8, under each of the builder's ``cache_dtype``
    candidates, pinned to the kernels and then to the plain versions.
    Every kernel step launches K1 85 times (57 single, 28 pairs) and
    nothing falls back; the logits are finite; the greedy tokens are
    compared with the plain path's, and where they first differ the top-2
    logit gap of both is printed."""
    import torch

    from repro_torch import configs
    from repro_torch.core import IridescentRuntime
    from repro_torch.kernels import registry
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.models import transformer as model
    from repro_torch.training import make_serve_builder, phase_context_fn

    dev = torch.device("cuda")
    cfg = configs.get_config("qwen3-0.6b").replace(compute_dtype="float16")
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    b, chunk, steps = HALF_SERVE
    per_step = _k_per_call(cfg)["rmsnorm"]          # as a forward's
    prompt = torch.randint(0, cfg.vocab_size, (b, chunk),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev, dtype=torch.int32)
    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    out = {"launches": 0, "by_cache": {}}
    for cache_dtype in ("bfloat16", "float32"):
        runs = {}
        for impl in ("cuda", "torch_ref"):
            rt = IridescentRuntime(max_compile_workers=1)
            handler = rt.register("serve_step", make_serve_builder(cfg),
                                  context_fn=phase_context_fn)
            pinned = {"cache_dtype": cache_dtype, "rmsnorm_impl": impl}
            for key in (("prefill", b), ("decode", b)):
                handler.specialize(pinned, wait=True, context=key)
            cache = model.init_cache(
                cfg, b, HALF_SERVE_MAX_LEN,
                model.RunOptions(decode_cache_dtype=cache_dtype), device=dev)
            rms_kernel.reset_launches()
            registry.default_registry.fallback_counts.clear()
            logits, cache = handler(params, cache, prompt, zeros,
                                    torch.full_like(zeros, chunk))
            seen = [logits]
            tokens = [logits.argmax(-1)]
            launched, host_s = [], 0.0
            for t in range(steps):
                l0 = rms_kernel.launches
                t0 = time.perf_counter()
                logits, cache = handler(params, cache, tokens[-1].int(),
                                        torch.full_like(zeros, chunk + t),
                                        torch.ones_like(zeros))
                torch.cuda.synchronize()
                host_s += time.perf_counter() - t0
                launched.append(rms_kernel.launches - l0)
                seen.append(logits)
                tokens.append(logits.argmax(-1))
            fallbacks = {f"{k[0]}/{k[1]}": v for k, v in
                         registry.default_registry.fallback_counts.items()}
            rt.shutdown()
            want = per_step if impl == "cuda" else 0
            if fallbacks:
                fail(f"half serve ({cache_dtype} cache, {impl}) fell back: "
                     f"{fallbacks}")
            if any(n != want for n in launched):
                fail(f"half serve ({cache_dtype} cache, {impl}): K1 "
                     f"launches a decode step {launched}; wanted {want}")
            if any(lg.shape != (b, cfg.vocab_size)
                   or not torch.isfinite(lg).all() for lg in seen):
                fail(f"half serve ({cache_dtype} cache, {impl}): logits "
                     f"not finite or not ({b}, {cfg.vocab_size})")
            out["launches"] += rms_kernel.launches if impl == "cuda" else 0
            runs[impl] = {"tokens": torch.stack(tokens, 1).tolist(),
                          "logits": seen,
                          "host_ms_a_step": 1e3 * host_s / steps,
                          "launches_a_step": launched[0]}
        kern, plain = runs["cuda"], runs["torch_ref"]
        first = next(((t, r) for t in range(steps + 1) for r in range(b)
                      if kern["tokens"][r][t] != plain["tokens"][r][t]),
                     None)
        if first is None:
            agree = "equal"
        else:
            t, r = first
            gaps = {impl: float((lambda top: top[0] - top[1])(
                runs[impl]["logits"][t][r].float().topk(2).values))
                for impl in runs}
            agree = (f"first differ at step {t}, row {r}: top-2 logit gap "
                     f"kernels {gaps['cuda']:.4e}, plain "
                     f"{gaps['torch_ref']:.4e}")
        log(f"half serve: qwen3-0.6b fp16, {cache_dtype} cache, batch {b}: "
            f"1 prefill chunk of {chunk} + {steps} greedy decode steps; K1 "
            f"{kern['launches_a_step']} launches a decode step, 0 "
            f"fallbacks; host ms a decode step kernels "
            f"{kern['host_ms_a_step']:.1f}, plain "
            f"{plain['host_ms_a_step']:.1f}; greedy tokens kernels vs "
            f"plain: {agree}")
        out["by_cache"][cache_dtype] = {
            "tokens_agree": first is None, "first_difference": agree,
            **{f"{impl}_host_ms_a_step": runs[impl]["host_ms_a_step"]
               for impl in runs}}
        del runs, kern, plain
    del params
    torch.cuda.empty_cache()
    return out


# -- phases 19-20: MoE and MLA ----------------------------------------------------

def _moe_cfg():
    from repro_torch import configs

    return configs.get_config(MOE_ARCH).replace(n_layers=MOE_DEPTH,
                                                compute_dtype="float32")


def phase_moe_kernels() -> dict:
    """Phase 19a: K1 and K2 against their plain versions at the shapes
    deepseek-v2's (1, 4096) prefill gives them, fp32: K1 at the widths of
    its pre-norms, ``q_norm`` and ``kv_norm`` (5120, 1536, 512: the
    general body), K2 at MLA's 128 heads (q/k 192, v 128; causal, scale
    192^-0.5) at every tile pair.  Then K2 at that shape timed per tile
    pair beside the plain version, ``scaled_dot_product_attention`` and the
    bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    cfg = _moe_cfg()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    s = MOE_PREFILL[1]
    tiles = [(bq, bkv) for bq in attn_kernel.BLOCK_Q
             for bkv in attn_kernel.BLOCK_KV]
    err = {"rmsnorm": 0.0, "attention": 0.0}
    widths = (cfg.d_model, cfg.q_lora_rank, cfg.kv_lora_rank)
    for d in widths:
        x = torch.randn((s, d), generator=gen, device=dev)
        w = 1 + 0.1 * torch.randn((d,), generator=gen, device=dev)
        out = rms_ops.rmsnorm(x, w, impl="cuda")
        torch.cuda.synchronize()
        err["rmsnorm"] = max(err["rmsnorm"], _hold_kernel(
            f"rmsnorm ({s}, {d})", out, rms_ops.rmsnorm(x, w,
                                                        impl="torch_ref"),
            [(TOL["float32"], TOL["float32"])]))
    h, d, dv = (cfg.n_heads, cfg.nope_head_dim + cfg.rope_head_dim,
                cfg.d_head)
    scale = d ** -0.5
    q, k = (torch.randn((1, h, s, d), generator=gen, device=dev)
            for _ in range(2))
    v = torch.randn((1, h, s, dv), generator=gen, device=dev)
    ref = attn_ops.attention(q, k, v, scale=scale, impl="torch_ref")
    limits = [(ATTN_TOL["float32"],) * 2, ATTN_SCALED_TOL["float32"]]
    for bq, bkv in tiles:
        out = attn_ops.attention(q, k, v, scale=scale, impl="cuda",
                                 block_q=bq, block_kv=bkv)
        torch.cuda.synchronize()
        err["attention"] = max(err["attention"], _hold_kernel(
            f"attention (1,{h}/{h},{s},{d}/{dv}) tiles {bq}x{bkv}", out,
            ref, limits))
        del out
    del ref
    log(f"moe kernels: cuda == torch_ref for K1 at ({s}, d) d in {widths} "
        f"(tol {TOL['float32']:g}; max_abs_err {err['rmsnorm']:.3e}) and "
        f"K2 at MLA's (1, {h}/{h}, {s}, {d}/{dv}) causal, scale {d}^-0.5, "
        f"at tiles {tiles} (tols {limits}; max_abs_err "
        f"{err['attention']:.3e})")

    q3, k3, v3 = (x[0] for x in (q, k, v))
    at = {"shape": [1, h, h, s, d, dv], "kernel_ms_by_tiles": {
        f"{bq}x{bkv}": cuda_time_ms(
            lambda bq=bq, bkv=bkv: attn_kernel.flash_attention_cuda(
                q3, k3, v3, scale=scale, block_q=bq, block_kv=bkv), 10, 2)
        for bq, bkv in tiles}}
    at["plain_ms"] = cuda_time_ms(
        lambda: attn_ops.ref.attention(q, k, v, scale=scale), 3, 1)
    at["library_ms"] = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               scale=scale), 10, 2)
    at["bound_ms"], at["bound_by"] = _attention_cost(1, h, h, s, s, d, dv,
                                                    4)
    best = min(at["kernel_ms_by_tiles"], key=at["kernel_ms_by_tiles"].get)
    at["best"] = best
    at["body"] = attn_kernel.body(torch.float32, d, dv,
                                  block_q=int(best.split("x")[0]),
                                  block_kv=int(best.split("x")[1]))
    log(f"attention at MLA's prefill (1,{h}/{h},{s},{d}/{dv}) fp32 causal: "
        f"kernel " + " ".join(
            f"{t} {ms:.4f} ({100 * at['bound_ms'] / ms:.1f}%)"
            for t, ms in at["kernel_ms_by_tiles"].items())
        + f" ms (% of the bound; best {best}, {at['body']['body']} body); "
        f"plain {at['plain_ms']:.3f} ms; sdpa {at['library_ms']:.3f} ms; "
        f"bound {at['bound_ms']:.4f} ms ({at['bound_by']})")
    del q, k, v, q3, k3, v3
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "widths": list(widths), "mla_attention": at}


class _RoutingLog:
    """Records every ``assign_experts`` call's router logits, expert ids,
    keep mask and aux loss term while it is entered (the routing of a
    call's MoE layers, in order)."""

    def __init__(self):
        self.calls: list[dict] = []

    def __enter__(self):
        from repro_torch.models import moe as moe_mod

        self._inner = inner = moe_mod.assign_experts

        def logged(logits, *a, **k):
            out = inner(logits, *a, **k)
            self.calls.append({"logits": logits.detach().clone(),
                               "idx": out["idx"].clone(),
                               "keep": out["keep"].clone(),
                               "aux": out["aux"].item()})
            return out

        moe_mod.assign_experts = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_mod

        moe_mod.assign_experts = self._inner


def _aux_loss(routing: list) -> float:
    """A call's MoE aux loss (``apply``'s second output) from its routing
    log: the layers' terms summed, times the default ``aux_coef``."""
    from repro_torch.models.moe import MoEOptions

    return sum(c["aux"] for c in routing) * MoEOptions().aux_coef


def _routing_agreement(a: list, b: list) -> list:
    """Per MoE layer, the share of (token, slot) pairs routed to the same
    expert with the same keep in two calls' routing logs."""
    return [((x["idx"] == y["idx"]) & (x["keep"] == y["keep"]))
            .float().mean().item() for x, y in zip(a, b)]


def _near_tie_flips(a: list, b: list, k: int) -> list:
    """Per MoE layer, the tokens whose expert set differs between two
    calls, with the gap between the k-th and (k+1)-th router probability
    in the first call (a flip at a near-tie has a gap near zero)."""
    import torch

    out = []
    for x, y in zip(a, b):
        differ = (x["idx"].sort(-1).values != y["idx"].sort(-1).values) \
            .any(-1).nonzero().flatten()
        probs = torch.softmax(x["logits"][differ], -1).sort(
            -1, descending=True).values
        out.append({"tokens": differ.tolist(),
                    "gap": (probs[:, k - 1] - probs[:, k]).tolist()})
    return out


def phase_moe_prefill() -> dict:
    """Phase 19b: deepseek-v2-236b at full width and depth MOE_DEPTH,
    random weights from seed 0 in fp32: one (1, 4096) prefill through
    ``make_prefill_builder``'s generic variant (``moe_impl`` einsum),
    timed, each call's K1 (4L + 1: the pre-norms, MLA's two latent norms,
    the final norm) and K2 (L) launches counted; profiled; the same call
    pinned to ``moe_impl`` gather, timed and profiled; then pinned to the
    plain versions.  Logits held to PARITY_TOL, generic against plain and
    gather against einsum, with the routing agreement per MoE layer.  Then
    the Controller sweep over MOE_SWEEP_LABELS.  Returns the weights for
    phase 20."""
    import torch

    from repro_torch import compat
    from repro_torch.core import IridescentRuntime
    from repro_torch.kernels import registry
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as model
    from repro_torch.training import make_prefill_builder

    dev = torch.device("cuda")
    cfg = _moe_cfg()
    log(f"moe prefill: device memory held before the weights "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in compat.tree_leaves(params))
    init_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"moe prefill: {MOE_ARCH} at full width, depth {cfg.n_layers} of "
        f"60 ({cfg.n_layers - cfg.n_moe_layers} dense, {cfg.n_moe_layers} "
        f"MoE layers; d={cfg.d_model}, MLA {cfg.n_heads} heads q_lora "
        f"{cfg.q_lora_rank} kv_lora {cfg.kv_lora_rank} nope/rope "
        f"{cfg.nope_head_dim}/{cfg.rope_head_dim} v {cfg.d_head}; "
        f"{cfg.n_experts} experts top-{cfg.top_k} of {cfg.moe_d_ff} + "
        f"{cfg.n_shared_experts} shared; dense d_ff {cfg.d_ff}; vocab "
        f"{cfg.vocab_size}) params {n_params / 1e6:.1f}M "
        f"({4 * n_params / 1e9:.2f} GB fp32), drawn in "
        f"{time.perf_counter() - t0:.1f}s, peak device memory "
        f"{init_gb:.2f} GB")
    b, s = MOE_PREFILL
    gen = torch.Generator(device=dev).manual_seed(17)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    rt = IridescentRuntime(max_compile_workers=1)
    handler = rt.register("prefill_step", make_prefill_builder(cfg))
    counters = {"rmsnorm": rms_kernel, "attention": attn_kernel}
    per_call = {"rmsnorm": 4 * cfg.n_layers + 1, "attention": cfg.n_layers}

    def calls(n: int):
        """``n`` calls of the active variant: the last logits, each call's
        seconds, the last call's routing."""
        seconds = []
        for _ in range(n):
            with _RoutingLog() as routing:
                t = time.perf_counter()
                logits = handler(params, batch)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t)
        if logits.shape != (b, s, cfg.padded_vocab_size) \
                or not torch.isfinite(logits).all():
            fail(f"{MOE_ARCH} prefill logits {tuple(logits.shape)} or "
                 f"non-finite")
        return logits, seconds, routing.calls

    def rel(a, ref):
        v = cfg.vocab_size
        return ((a[..., :v] - ref[..., :v]).abs().max()
                / ref[..., :v].abs().max().clamp_min(1e-30)).item()

    # the main path: the generic variant, twice (the second timed)
    for k in counters.values():
        k.reset_launches()
    registry.default_registry.fallback_counts.clear()
    einsum_logits, seconds, einsum_routing = calls(2)
    launches = {n: k.launches for n, k in counters.items()}
    fallbacks = {f"{k[0]}/{k[1]}": v for k, v in
                 registry.default_registry.fallback_counts.items()}
    if fallbacks:
        fail(f"{MOE_ARCH} prefill fell back: {fallbacks}")
    for n, want in per_call.items():
        if launches[n] != 2 * want:
            fail(f"{MOE_ARCH} prefill: {n} launched {launches[n]} times "
                 f"over 2 calls; wanted {want} a call")
    aux = {"einsum": _aux_loss(einsum_routing)}
    prof, wall, _ = profiled(lambda: handler(params, batch), 1)
    profiles = {"einsum": _profile_by_kernel(
        prof, wall, f"{MOE_ARCH} depth {cfg.n_layers} ({b}, {s}) prefill, "
        f"generic variant (moe_impl einsum), profiler on", moe=True)}
    del prof
    ms = {"einsum": 1e3 * seconds[1]}
    first_ms = 1e3 * seconds[0]

    _pin(handler, {"moe_impl": "gather"})
    gather_logits, seconds, gather_routing = calls(2)
    ms["gather"] = 1e3 * seconds[1]
    aux["gather"] = _aux_loss(gather_routing)
    prof, wall, _ = profiled(lambda: handler(params, batch), 1)
    profiles["gather"] = _profile_by_kernel(
        prof, wall, f"{MOE_ARCH} depth {cfg.n_layers} ({b}, {s}) prefill, "
        f"moe_impl gather, profiler on", moe=True)
    del prof
    gather_rel = rel(gather_logits, einsum_logits)
    gather_agree = _routing_agreement(gather_routing, einsum_routing)
    del gather_logits

    _pin(handler, {"rmsnorm_impl": "torch_ref",
                   "attention_impl": "torch_ref"})
    plain_logits, seconds, plain_routing = calls(1)
    ms["plain"] = 1e3 * seconds[0]
    aux["plain"] = _aux_loss(plain_routing)
    plain_rel = rel(einsum_logits, plain_logits)
    plain_agree = _routing_agreement(einsum_routing, plain_routing)
    flips = _near_tie_flips(plain_routing, einsum_routing, cfg.top_k)
    del einsum_logits, plain_logits
    rt.shutdown()
    torch.cuda.empty_cache()
    tok_s = {impl: b * s / (v / 1e3) for impl, v in ms.items()}
    log(f"moe prefill: ({b}, {s}) tokens: generic (einsum) {ms['einsum']:.1f}"
        f" ms ({tok_s['einsum']:.1f} tok/s; first call {first_ms:.1f} ms), "
        f"gather {ms['gather']:.1f} ms ({tok_s['gather']:.1f} tok/s), plain "
        f"{ms['plain']:.1f} ms; launches a call {per_call}; aux loss "
        f"{aux}; max relative logits diff generic vs plain {plain_rel:.3e}, "
        f"gather vs einsum {gather_rel:.3e} (tol {PARITY_TOL:g}); routing "
        f"agreement per MoE layer generic vs plain {plain_agree}, gather vs "
        f"einsum {gather_agree}; tokens routed apart generic vs plain, with "
        f"the top-{cfg.top_k} gap: {flips}")
    if gather_rel > PARITY_TOL or min(gather_agree) < 1.0:
        fail(f"{MOE_ARCH} prefill: gather vs einsum relative diff "
             f"{gather_rel:.3e} (tol {PARITY_TOL}), routing {gather_agree}")
    if plain_rel > PARITY_TOL:
        fail(f"{MOE_ARCH} prefill parity: relative diff {plain_rel:.3e} > "
             f"{PARITY_TOL} (routing {plain_agree}, flips {flips})")

    moe_mod.reset_degrades()
    sweep = _prefill_sweep(MOE_ARCH, cfg, params, batch, MOE_SWEEP_LABELS)
    sweep["shard_degrades"] = moe_mod.degrades
    log(f"moe prefill sweep: moe_impl shard ran as gather (no mesh) in "
        f"{moe_mod.degrades} MoE layer calls; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return {"params": params, "cfg": cfg, "n_params": n_params,
            "init_peak_gb": init_gb, "ms": ms, "first_ms": first_ms,
            "tok_s": tok_s, "aux": aux, "launches": launches,
            "per_call": per_call, "rel": {"plain": plain_rel,
                                          "gather": gather_rel},
            "routing_agreement": {"plain": plain_agree,
                                  "gather": gather_agree},
            "flips": flips, "profiles": profiles, "sweep": sweep,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}



def phase_moe_serve(cfg, params) -> dict:
    """Phase 20a: ``build_engine`` serves deepseek-v2 at full width and
    depth MOE_DEPTH as phase 18 serves its families (pinned to the
    kernels, then to the plain versions: equal greedy tokens; ``moe_impl``
    stays at its default, einsum).  Then one decode step at the engine's
    batch, per MoE impl, profiled: the device ms by kernel class."""
    import torch

    from repro_torch.models import KernelOptions
    from repro_torch.models import transformer as model
    from repro_torch.models.moe import MoEOptions

    served = phase_family_serve(MOE_ARCH, MOE_SERVE_MAX_LEN, params, cfg=cfg)
    dev = torch.device("cuda")
    batch = int(FAMILY_SERVE_ARGS[FAMILY_SERVE_ARGS.index("--batch") + 1])
    gen = torch.Generator(device=dev).manual_seed(20)
    tokens = torch.randint(0, cfg.vocab_size, (batch,), generator=gen,
                           device=dev, dtype=torch.int32)
    pos = torch.full((batch,), FAMILY_SERVE_PROMPT, dtype=torch.int32,
                     device=dev)
    decode = {}
    for impl in ("einsum", "gather"):
        opts = model.RunOptions(kernels=KernelOptions(rmsnorm_impl="cuda"),
                                moe=MoEOptions(impl=impl),
                                decode_cache_dtype="float32")
        cache = model.init_cache(cfg, batch, MOE_SERVE_MAX_LEN, opts,
                                 device=dev)

        def step():
            return model.decode_step(params, cache, tokens, pos, cfg, opts)

        step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t) / 3
        prof, wall, _ = profiled(step, 1)
        decode[impl] = _profile_by_kernel(
            prof, wall, f"{MOE_ARCH} depth {cfg.n_layers} decode step at "
            f"batch {batch} (moe_impl {impl}, profiler on)", moe=True)
        decode[impl]["step_ms"] = host_ms
        del prof, cache
    log(f"moe serve: one decode step at batch {batch}, "
        + ", ".join(f"{impl} {d['step_ms']:.1f} ms (device busy "
                    f"{d['busy_ms']:.1f} ms)" for impl, d in decode.items())
        + " (host clock, 3 steps; device time by the profiler)")
    return {"serve": served, "decode": decode}


# -- training (phases 21-22) -------------------------------------------------------

TRAIN_KERNELS = ("rmsnorm", "attention", "linear_attention", "matmul",
                 "fastpath")


def _kernel_modules() -> dict:
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.fastpath import kernel as fp_kernel
    from repro_torch.kernels.linear_attention import kernel as la_kernel
    from repro_torch.kernels.matmul import kernel as mm_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel

    return dict(zip(TRAIN_KERNELS, (rms_kernel, attn_kernel, la_kernel,
                                    mm_kernel, fp_kernel)))


class _NoKernelUnderTraining:
    """Zeroes every kernel's launch count on entry and snapshots the
    registry's fallback counts; ``check()`` fails if a kernel launched or
    a fallback was counted since (a train step declares the gradient-safe
    entries, so neither may happen) and returns the launch counts."""

    def __enter__(self):
        from repro_torch.kernels import registry

        self.mods = _kernel_modules()
        for mod in self.mods.values():
            mod.reset_launches()
        self.fallbacks = dict(registry.default_registry.fallback_counts)
        return self

    def __exit__(self, *exc):
        return False

    def check(self, what: str) -> dict:
        from repro_torch.kernels import registry

        launches = {name: mod.launches for name, mod in self.mods.items()}
        if any(launches.values()):
            fail(f"{what}: a kernel launched under training: {launches}")
        after = dict(registry.default_registry.fallback_counts)
        if after != self.fallbacks:
            fail(f"{what}: the registry counted fallbacks: "
                 f"{self.fallbacks} -> {after}")
        return launches


def _train_cost(cfg, b: int, s: int) -> float:
    """TFLOP of one train step (forward and backward, 3x the forward's
    products): the parameters' products at 2 flops a weight a token (the
    tied LM head included), and the plain attention's full causal score
    and value products."""
    n_layer = (cfg.d_model * cfg.n_heads * cfg.d_head * 2
               + cfg.d_model * cfg.n_kv_heads * cfg.d_head * 2
               + 3 * cfg.d_model * cfg.d_ff)
    params = cfg.n_layers * n_layer + cfg.d_model * cfg.padded_vocab_size
    attn = cfg.n_layers * 2 * 2 * b * cfg.n_heads * s * s * cfg.d_head
    return 3 * (2 * params * b * s + attn) / 1e12


def _train_profile(prof, wall: float) -> dict:
    """Device ms of one profiled train step by class: GEMM (cuBLAS's
    symbols, outside the attention), the plain attention's ops (the
    kernels under the ranges ``attention`` opens for every mixer's call,
    ``PROFILE_RANGE``, and the backward nodes those ranges created,
    linked by autograd sequence number), the
    optimizer (under ``smoke::optimizer``) and the rest
    (softmax/elementwise); and the busy share of the step's wall.  Fails
    if no attention was seen: the step runs attention in every layer."""
    import torch

    from repro_torch.kernels.attention.ops import PROFILE_RANGE

    cuda = torch.autograd.DeviceType.CUDA
    # the named ranges also appear on the device's timeline (user
    # annotations spanning their kernels): not device work of their own
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == cuda and not e.key.startswith("smoke::")
                  and e.key != PROFILE_RANGE)
    events = [e for e in prof.events() if e.device_type != cuda]

    def walk(e):
        yield e
        for c in e.cpu_children:
            yield from walk(c)

    att_seq = {d.sequence_nr for e in events if e.name == PROFILE_RANGE
               for d in walk(e) if d.sequence_nr >= 0}

    def label(e, kernel: str) -> str:
        node = e
        while node is not None:
            if node.name == "smoke::optimizer":
                return "optimizer"
            if node.name == PROFILE_RANGE or (
                    node.name.startswith("autograd::engine::evaluate_function")
                    and node.sequence_nr in att_seq):
                return "attention (plain ops)"
            node = node.cpu_parent
        if re.search(r"gemm|xmma|cutlass|cublas", kernel, re.IGNORECASE):
            return "GEMM"
        return "softmax/elementwise"

    ms, count = collections.Counter(), collections.Counter()
    rest = collections.Counter()        # the softmax/elementwise class
    for e in events:
        for k in e.kernels:
            cls = label(e, k.name)
            ms[cls] += k.duration / 1e3
            count[cls] += 1
            if cls == "softmax/elementwise":
                rest[f"{e.name} / {k.name[:60]}"] += k.duration / 1e3
    linked = sum(ms.values())
    if not ms["attention (plain ops)"] or not att_seq:
        fail(f"train profile: no attention kernels or backward nodes under "
             f"{PROFILE_RANGE}: {dict(ms)}")
    log(f"train profile: one step, wall {1e3 * wall:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}% of "
        f"wall), {linked:.1f} ms linked to the ops that launched them; by "
        f"class: " + ", ".join(
            f"{k} {v:.1f} ms ({100 * v / max(linked, 1e-9):.1f}%) "
            f"x{count[k]}" for k, v in ms.most_common()))
    for name, v in rest.most_common(6):
        log(f"  softmax/elementwise: {v:7.1f} ms  {name}")
    return {"wall_ms": 1e3 * wall, "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e6 / wall, "linked_ms": linked,
            "ms_by_class": dict(ms), "launches_by_class": dict(count),
            "attention_backward_nodes": len(att_seq)}


#: the train step's optimizer calls: the functional update of an
#: undonated step and the in-place one of a donated step
OPTIMIZER_ENTRIES = ("apply_updates", "update_in_place")


class _WrappedOptimizer:
    """The train step's optimizer calls (OPTIMIZER_ENTRIES) replaced by
    ``wrap(name, fn)`` for the length of the block."""

    def __init__(self, wrap):
        self.wrap = wrap

    def __enter__(self):
        from repro_torch.training import steps as steps_mod

        self.mod = steps_mod
        self.entries = {n: getattr(steps_mod, n) for n in OPTIMIZER_ENTRIES}
        for n, fn in self.entries.items():
            setattr(steps_mod, n, self.wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.entries.items():
            setattr(self.mod, n, fn)
        return False


def _profiled_train_step(handler, state, batch):
    """One train step under the profiler (CPU ops and CUDA kernels), the
    optimizer inside a named range (the attention opens its own); returns
    the new state and the classified profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(_, fn):
        def call(*args, **kwargs):
            with record_function("smoke::optimizer"):
                return fn(*args, **kwargs)
        return call

    with _WrappedOptimizer(ranged):
        for window in range(1, 4):
            pad = PROFILE_PAD_S * 2 ** (window - 1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(pad)
                t0 = time.perf_counter()
                state, metrics = handler(state, batch)
                float(metrics["loss"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                time.sleep(pad)
            if any(e.device_type == torch.autograd.DeviceType.CUDA
                   for e in prof.key_averages()):
                return state, _train_profile(prof, wall)
            log(f"profiler: train step window {window} saw no device "
                f"activity (pads {pad} s)")
    fail("the profiler saw no device activity in 3 train steps")


def _train_key(config: dict, space) -> str:
    """The explored labels' values of ``config``, each point's default
    where the config leaves it out (the generic variant's): one key per
    train candidate."""
    from repro_torch.launch.train import EXPLORE_LABELS

    return json.dumps({label: _setting(config, label,
                                       space.points[label].default)
                       for label in EXPLORE_LABELS})


def phase_train(cfg) -> dict:
    """Phase 21a-b: full-width qwen3-0.6b training through the entry
    points: ``make_train_builder`` on an ``IridescentRuntime``,
    ``SyntheticLM`` batches of TRAIN_BATCH on the card, a Controller whose
    CoordinateDescent sweeps the CLI's labels (``remat``, ``microbatch``,
    ``logits_dtype``, ``rmsnorm_impl``) at dwell TRAIN_DWELL until it
    settles (at most TRAIN_STEP_CAP steps), each step timed by CUDA events
    and its peak memory read; then one profiled step.  No kernel may
    launch and no fallback may be counted.  Returns the state for the
    restart (21d)."""
    import torch

    from repro_torch.core import (DEFAULT_CONTEXT, Controller,
                                  CoordinateDescent, IridescentRuntime)
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import EXPLORE_LABELS
    from repro_torch.models import transformer as model
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.training import make_train_builder

    dev = torch.device("cuda")
    b, s = TRAIN_BATCH
    opt_cfg = OptConfig(**TRAIN_OPT)
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    del params
    held = torch.cuda.memory_allocated() / 1e9
    log(f"train: qwen3-0.6b at full width, {cfg.param_count() / 1e6:.1f} M "
        f"params; params, m and v hold {held:.2f} GB; batch ({b}, {s})")
    rt = IridescentRuntime(max_compile_workers=1)
    handler = rt.register("train_step", make_train_builder(cfg, opt_cfg),
                          donate_argnums=0)
    space = handler.spec_space()
    controller = Controller(
        handler, lambda: CoordinateDescent(space, labels=EXPLORE_LABELS,
                                           max_passes=1),
        dwell=TRAIN_DWELL, wait_compiles=True, prefetch=0)
    it = iter(SyntheticLM(cfg.vocab_size, b, s, seed=1, prefetch=0,
                          device=dev))
    step_ms, peaks, losses, by_step = (collections.defaultdict(list), {},
                                       [], [])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    with _NoKernelUnderTraining() as guard:
        for step in range(1, TRAIN_STEP_CAP + 1):
            batch = next(it)
            key = _train_key(handler.active_config(), space)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start.record()
            state, metrics = handler(state, batch)
            end.record()
            losses.append(float(metrics["loss"]))   # waits for the card
            end.synchronize()
            ms = start.elapsed_time(end)
            remat = json.loads(key).get("remat", "none")
            peaks[remat] = max(peaks.get(remat, 0.0),
                               torch.cuda.max_memory_allocated() / 1e9)
            step_ms[key].append(ms)
            by_step.append((key, ms))
            controller.step()
            if controller.settled() and step >= TRAIN_MIN_STEPS:
                break
        else:
            fail(f"the train Controller did not settle in {TRAIN_STEP_CAP} "
                 f"steps")
        wall = time.perf_counter() - t0
        state, profile = _profiled_train_step(handler, state, next(it))
        launches = guard.check("train sweep")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: non-finite loss: {losses}")
    last = statistics.fmean(losses[-10:])
    log(f"train: {step} steps in {wall:.1f} s; loss by step: "
        + " ".join(f"{x:.4f}" for x in losses))
    if not last < losses[0]:
        fail(f"train: the last 10 steps' mean loss {last:.4f} is not below "
             f"the first {losses[0]:.4f}")
    best = controller.best_configs()[DEFAULT_CONTEXT]
    chosen = json.loads(_config_str(best))
    chosen_key = _train_key(best, space)
    tflop = _train_cost(cfg, b, s)
    candidates = {}
    for key, times in step_ms.items():
        med = statistics.median(times)
        candidates[key] = {"steps": len(times), "step_ms": med,
                           "tok_s": b * s / med * 1e3,
                           "tflop_s": tflop / med * 1e3}
        log(f"train candidate {key}: {len(times)} steps, median "
            f"{med:.1f} ms/step (CUDA events), {b * s / med * 1e3:.1f} "
            f"tok/s, {tflop / med * 1e3:.1f} TFLOP/s")
    for phase_, config, rate in controller.histories()[DEFAULT_CONTEXT]:
        log(f"train sweep: {phase_.value} {_config_str(config)} -> "
            f"{rate:.3f} steps/s ({1e3 / rate:.1f} ms/step)")
    rate = controller.best(DEFAULT_CONTEXT)[1]
    event_ms = candidates[chosen_key]["step_ms"]
    gap = abs(1e3 / rate - event_ms) / event_ms
    log(f"train: settled on {chosen_key}: the Controller's rate "
        f"{rate:.3f} steps/s = {1e3 / rate:.1f} ms/step against "
        f"{event_ms:.1f} ms by CUDA events ({100 * gap:.1f}% apart)")
    if gap > TRAIN_RATE_TOL:
        fail(f"train: the Controller's rate is {100 * gap:.1f}% from the "
             f"event-timed step (limit {100 * TRAIN_RATE_TOL:.0f}%)")
    log("train: peak memory by remat: " + ", ".join(
        f"{k} {v:.2f} GB" for k, v in peaks.items()))
    log(f"train: {tflop:.2f} TFLOP a step; kernel launches under training "
        f"{launches}, no fallback")
    rt.shutdown()
    return {"state": state, "handler_config": chosen, "steps": step,
            "losses": losses, "first_loss": losses[0],
            "last10_mean_loss": last, "candidates": candidates,
            "chosen": chosen_key, "controller_ms": 1e3 / rate,
            "event_ms": event_ms, "rate_gap": gap, "peak_gb": peaks,
            "weights_gb": held, "tflop": tflop, "profile": profile,
            "launches": launches}


def _reduced_step_parity() -> dict:
    """Phase 21c: one train step of reduced qwen3 and of reduced
    deepseek-v2 (MLA: its attention has no point of its own and takes the
    step-wide implementation) on the card against the same step of the
    port on the CPU, both under the options the train builder declares:
    the loss within TRAIN_LOSS_RTOL relative, every gradient leaf within
    TRAIN_GRAD_TOL of its max, and no kernel launched on the card."""
    import numpy as np
    import torch

    from repro_torch import compat, configs
    from repro_torch.core.specializer import SpecCtx
    from repro_torch.models import transformer as model
    from repro_torch.training import cross_entropy
    from repro_torch.training.steps import (_value_and_grad,
                                            run_options_from_spec)

    out = {}
    for arch in TRAIN_PARITY_ARCHS:
        cfg = configs.get_reduced(arch).replace(compute_dtype="float32")
        params = model.init_params(torch.Generator().manual_seed(0), cfg)
        rs = np.random.RandomState(7)
        toks = torch.from_numpy(
            rs.randint(0, cfg.vocab_size, (4, 65)).astype(np.int32))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        opts = run_options_from_spec(SpecCtx(config={}), cfg,
                                     differentiable=True)

        def loss(p, bt, cfg=cfg, opts=opts):
            lg, aux = model.apply(p, cfg, opts, tokens=bt["tokens"])
            return cross_entropy(lg, bt["labels"]) + aux

        to_card = lambda tree: compat.tree_map(lambda t: t.cuda(), tree)
        host_loss, host = _value_and_grad(loss, params, batch)
        with _NoKernelUnderTraining() as guard:
            card_loss, card = _value_and_grad(loss, to_card(params),
                                              to_card(batch))
            torch.cuda.synchronize()
            guard.check(f"train parity ({arch})")
        loss_rel = abs(float(card_loss) - float(host_loss)) / abs(
            float(host_loss))
        grad_rel = max(float((g.cpu() - w).abs().max())
                       / max(float(w.abs().max()), 1e-30)
                       for w, g in zip(host, card))
        log(f"train parity: reduced {arch} step, card vs host: loss "
            f"{float(card_loss):.7f} vs {float(host_loss):.7f} "
            f"({loss_rel:.3e} relative), gradients within {grad_rel:.3e} of "
            f"each leaf's max, no kernel launched")
        if loss_rel > TRAIN_LOSS_RTOL or grad_rel > TRAIN_GRAD_TOL:
            fail(f"train parity ({arch}): loss {loss_rel:.3e} (limit "
                 f"{TRAIN_LOSS_RTOL}), gradients {grad_rel:.3e} (limit "
                 f"{TRAIN_GRAD_TOL})")
        out[arch] = {"loss_rel": loss_rel, "grad_rel": grad_rel}
    return out


def phase_train_restart(cfg, train: dict) -> dict:
    """Phase 21d: tests/test_system.py's restart sequence at full width on
    the settled config: save the state at step k, run 2 more steps,
    restore, replay them: the final losses within TRAIN_LOSS_RTOL.  Then
    the CLI twice on one ``--ckpt`` directory: the second run must resume
    at the first run's last step with a restored tuned configuration."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import IridescentRuntime
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import OptConfig
    from repro_torch.training import make_train_builder

    b, s = TRAIN_BATCH
    rt = IridescentRuntime(max_compile_workers=1)
    handler = rt.register("train_step", make_train_builder(
        cfg, OptConfig(**TRAIN_OPT)), donate_argnums=0)
    _pin(handler, train["handler_config"])
    ds = SyntheticLM(cfg.vocab_size, b, s, seed=1, prefetch=0,
                     device="cuda")
    k = train["steps"] + 1
    ckpt = SCRATCH / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt), keep=1)
    state = train.pop("state")
    with _NoKernelUnderTraining() as guard:
        t0 = time.perf_counter()
        mgr.save(k, state, extra_meta={"data_step": k}, block=True)
        save_s = time.perf_counter() - t0
        for i in range(k, k + 2):
            state, m = handler(state, ds.place(ds.batch_at(i)))
        direct = float(m["loss"])
        t0 = time.perf_counter()
        state, meta = mgr.restore(state)
        restore_s = time.perf_counter() - t0
        for i in range(meta["data_step"], k + 2):
            state, m = handler(state, ds.place(ds.batch_at(i)))
        replay = float(m["loss"])
        guard.check("train restart")
    gap = abs(replay - direct) / abs(direct)
    size = sum(f.stat().st_size for f in ckpt.rglob("*.npz")) / 1e9
    log(f"train restart: {size:.2f} GB saved in {save_s:.1f} s, restored "
        f"in {restore_s:.1f} s; loss after 2 steps {direct:.7f} direct, "
        f"{replay:.7f} replayed ({gap:.3e} relative)")
    if gap > TRAIN_LOSS_RTOL:
        fail(f"train restart: replayed loss {gap:.3e} from the direct one")
    del state
    rt.shutdown()
    shutil.rmtree(ckpt, ignore_errors=True)

    cli = SCRATCH / "train_cli"
    shutil.rmtree(cli, ignore_errors=True)
    runs = []
    for steps in TRAIN_CLI_STEPS:
        out, wall = _run([sys.executable, "-m", "repro_torch.launch.train",
                          *TRAIN_CLI_ARGS, "--steps", str(steps), "--ckpt",
                          str(cli)], TRAIN_CLI_TIMEOUT_S,
                         f"the training CLI (--steps {steps})")
        runs.append(out)
        for line in out.splitlines():
            if not line.startswith("compile stats"):
                log(f"train cli ({steps}): {line[:240]}")
        log(f"train cli ({steps}): {wall:.1f} s")
    first = TRAIN_CLI_STEPS[0]
    if "resumed" in runs[0] or f"resumed from step {first}" not in runs[1] \
            or "restored tuned config: {" not in runs[1]:
        said = [ln[:120] for ln in runs[1].splitlines()
                if ln.startswith(("resumed", "restored"))]
        fail(f"train cli: the second run did not resume at step {first} "
             f"with a restored tuned config (it said {said})")
    shutil.rmtree(cli, ignore_errors=True)
    return {"save_s": save_s, "restore_s": restore_s, "ckpt_gb": size,
            "direct_loss": direct, "replay_loss": replay, "rel_gap": gap}


def phase_moe_train() -> dict:
    """Phase 22: ``examples/moe_exploration_torch.py`` on the card (reduced
    kimi-k2, 16 experts, top 4; its ExhaustiveSweep over ``moe_impl`` x
    ``moe_ranking``): the selected dispatch, each candidate's rate, no
    kernel launched."""
    with _NoKernelUnderTraining() as guard:
        out = _load_example("moe_exploration_torch").main(
            ["--device", "cuda"])
        guard.check("moe exploration")
    if not out["settled"] or not all(math.isfinite(x)
                                     for x in out["losses"]):
        fail(f"moe exploration: settled {out['settled']}, losses "
             f"{out['losses']}")
    log(f"moe exploration: selected {out['selected']}; loss "
        f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}")
    return out


def _peak_recorder(peaks: list):
    """A wrap for :class:`_WrappedOptimizer` that appends ``(name, the
    call's allocator peak above what was allocated before it)`` to
    ``peaks``: the device is synchronized and the peak reset before the
    call, and read after it (the gradients and the state were allocated
    before)."""
    import torch

    def wrap(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            peaks.append((name, torch.cuda.max_memory_allocated() - base))
            return out
        return call
    return wrap


def phase_train_donation(cfg) -> dict:
    """Phase 21e: the donated train step at full width.  qwen3-0.6b's
    initial state (seed 0) and one SyntheticLM TRAIN_BATCH batch; a
    handler registered with ``donate_argnums=0`` and an undonated one,
    both pinned to DONATE_CONFIG.  The undonated step runs on a clone of
    the state, the donated one on the state: the donated step returns the
    dict it was given with every leaf on its own storage, the clone is
    left unchanged (its step count still 0), the loss and every parameter
    agree within DONATE_RTOL relative, and the donated optimizer's
    allocator peak is at most DONATE_PEAK_LEAVES x the largest leaf (the
    undonated one's, a second copy of params, m and v, printed beside
    it).  No kernel may launch."""
    import torch

    from repro_torch import compat
    from repro_torch.core import IridescentRuntime
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer as model
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.training import make_train_builder

    dev = torch.device("cuda")
    b, s = TRAIN_BATCH
    opt_cfg = OptConfig(**TRAIN_OPT)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    del params
    batch = next(iter(SyntheticLM(cfg.vocab_size, b, s, seed=1, prefetch=0,
                                  device=dev)))
    rt = IridescentRuntime(max_compile_workers=1)
    plain = rt.register("train_undonated", make_train_builder(cfg, opt_cfg))
    donated = rt.register("train_donated", make_train_builder(cfg, opt_cfg),
                          donate_argnums=0)
    for h in (plain, donated):
        _pin(h, DONATE_CONFIG)
    leaves = compat.tree_leaves(state)
    largest = max(t.numel() * t.element_size() for t in leaves)
    ptrs = [t.untyped_storage().data_ptr() for t in leaves]
    held = sum(t.numel() * t.element_size() for t in leaves)
    clone = compat.tree_map(torch.clone, state)
    peaks = []
    with _NoKernelUnderTraining() as guard, \
            _WrappedOptimizer(_peak_recorder(peaks)):
        ref, ref_m = plain(clone, batch)
        ref_loss = float(ref_m["loss"])
        new, m = donated(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        guard.check("donated train step")
    if [n for n, _ in peaks] != ["apply_updates", "update_in_place"]:
        fail(f"donated train step: the optimizer calls were {peaks}, not "
             f"one functional and one in-place update")
    (_, plain_peak), (_, peak) = peaks
    kept = new is state and [t.untyped_storage().data_ptr()
                             for t in compat.tree_leaves(new)] == ptrs
    untouched = int(clone["opt"]["count"]) == 0 and int(
        new["opt"]["count"]) == 1
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    param_rel = max(float((a - w).abs().max()
                          / w.abs().max().clamp_min(1e-30))
                    for a, w in zip(compat.tree_leaves(new["params"]),
                                    compat.tree_leaves(ref["params"])))
    limit = DONATE_PEAK_LEAVES * largest
    log(f"donated train step: qwen3-0.6b at full width, {DONATE_CONFIG}, "
        f"state {held / 1e9:.3f} GB, largest leaf {largest / 1e9:.4f} GB; "
        f"every leaf kept its storage: {kept}; the undonated step's input "
        f"unchanged: {untouched}; loss {loss:.7f} vs {ref_loss:.7f} "
        f"undonated ({loss_rel:.3e} relative), parameters within "
        f"{param_rel:.3e} of each leaf's max; the optimizer's allocator "
        f"peak above what was allocated before it: donated "
        f"{peak / 1e9:.4f} GB (limit {limit / 1e9:.4f}), undonated "
        f"{plain_peak / 1e9:.4f} GB")
    if not kept:
        fail("donated train step: a leaf of the donated state moved to "
             "other storage")
    if not untouched:
        fail("donated train step: the undonated step's input state changed "
             "or the donated count is not 1")
    if loss_rel > DONATE_RTOL or param_rel > DONATE_RTOL:
        fail(f"donated train step: loss {loss_rel:.3e}, parameters "
             f"{param_rel:.3e} from the undonated step (limit "
             f"{DONATE_RTOL})")
    if peak > limit:
        fail(f"donated train step: the optimizer's peak {peak} bytes is "
             f"over {DONATE_PEAK_LEAVES} x the largest leaf ({limit})")
    del state, new, clone, ref
    rt.shutdown()
    return {"state_bytes": held, "largest_leaf_bytes": largest,
            "donated_peak_bytes": peak, "undonated_peak_bytes": plain_peak,
            "loss_rel": loss_rel, "param_rel": param_rel}


def _mesh_psum(mesh) -> dict:
    """Phase 23a: ``compressed_psum`` of a MESH_PSUM fp32 tensor over the
    ``data`` dim: within int8 error of ``x``, and a profiler window in
    which the NCCL all-gather ran on the int8 payload (its c10d op's input
    dtype) and put work on the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed import compression

    x = torch.randn(MESH_PSUM, generator=torch.Generator(
        device="cuda").manual_seed(23), device="cuda")
    y = compression.compressed_psum(x, "data", mesh)
    torch.cuda.synchronize()
    rel = float((y - x).abs().max() / x.abs().max())
    # the profiler can drop a window's device activities (see profiled):
    # a window without the collective's device work is run again.  The
    # window holds MESH_PSUM_PROFILE_CALLS calls with the host idle for
    # MESH_PSUM_PAD_S on each side: late in a long process the device's
    # timestamps can fall just outside a window of one 0.5 ms call
    # (windows of one call came back empty in two of three whole runs)
    for window in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            time.sleep(MESH_PSUM_PAD_S)
            for _ in range(MESH_PSUM_PROFILE_CALLS):
                compression.compressed_psum(x, "data", mesh)
            torch.cuda.synchronize()
            time.sleep(MESH_PSUM_PAD_S)
        # the ops' input types, from the trace (FunctionEvent has no dtypes
        # in every release): the c10d all-gather's payload and NCCL's own
        # record
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        gathers = [(ev["name"], ev.get("args", {}).get("Input type"),
                    ev.get("args", {}).get("dtype")) for ev in events
                   if "allgather" in ev.get("name", "").lower().replace(
                       "_", "") or ev.get("args", {}).get("Collective name")]
        device = sorted({e.name for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA})
        nccl = [n for n in device
                if "nccl" in n.lower() or "memcpy" in n.lower()]
        if nccl:
            break
    ms = cuda_time_ms(lambda: compression.compressed_psum(x, "data", mesh),
                      iters=20, warmup=3)
    log(f"mesh psum: compressed_psum of {MESH_PSUM} fp32 over data (1 "
        f"rank): {rel:.3e} relative to x (limit {MESH_PSUM_RTOL}); "
        f"{ms:.3f} ms a call (CUDA events); collective ops {gathers}; "
        f"the collectives' device activity {nccl} (profiler window "
        f"{window})")
    if not rel < MESH_PSUM_RTOL:
        fail(f"mesh psum: {rel:.3e} relative error (limit {MESH_PSUM_RTOL})")
    if not any("signed char" in (types or ()) or dtype == "Char"
               for _, types, dtype in gathers):
        fail(f"mesh psum: no all-gather on int8 data in the window: "
             f"{gathers}")
    if not nccl:
        fail(f"mesh psum: the collective put nothing on the device: "
             f"{device}")
    return {"rel_err": rel, "ms": ms, "collectives": gathers,
            "device_activity": nccl, "windows": window}


def _mesh_moe(mesh) -> dict:
    """Phase 23b: deepseek-v2-236b's MoE layer at full width (160 experts,
    top 6, two shared) on a MESH_MOE_INPUT input, under ``shard`` (the
    explicit expert-parallel block, all 160 experts local) and under
    ``gather``, at the first capacity factor at which neither drops a
    token: the outputs within MESH_MOE_RTOL relative, each timed."""
    import torch

    from repro_torch import configs
    from repro_torch.distributed.sharding import (DEFAULT_RULES,
                                                  mesh_context, replicate)
    from repro_torch.models import moe as moe_mod

    cfg = configs.get_config(MOE_ARCH).replace(compute_dtype="float32")
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    p = moe_mod.init_moe(torch.Generator(device=dev).manual_seed(0), cfg)
    gb = sum(t.numel() * 4 for t in itertools.chain(
        *(v.values() if isinstance(v, dict) else [v] for v in p.values())))
    b, s = MESH_MOE_INPUT
    x = torch.randn((b, s, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    e, k, t = cfg.n_experts, cfg.top_k, b * s
    with torch.no_grad():
        _, _, idx = moe_mod._route(x.reshape(t, -1) @ p["router"], k)
        load = torch.bincount(idx.reshape(-1), minlength=e)
    for factor in MESH_MOE_FACTORS:
        cap = moe_mod._capacity(t, k, e, factor)
        if int(load.max()) <= cap:
            break
    else:
        fail(f"mesh moe: the busiest expert takes {int(load.max())} slots, "
             f"more than any capacity of {MESH_MOE_FACTORS}")
    drops = int((load - cap).clamp_min(0).sum())
    out, ms = {}, {}
    moe_mod.reset_degrades()
    with torch.no_grad(), mesh_context(mesh, DEFAULT_RULES):
        for impl in ("shard", "gather"):
            opts = moe_mod.MoEOptions(impl=impl, capacity_factor=factor)
            fn = lambda: moe_mod.apply_moe(p, x, cfg, opts)
            out[impl] = replicate(fn()[0])
            ms[impl] = cuda_time_ms(fn, iters=5, warmup=1)
    degrades = moe_mod.degrades
    rel = float((out["shard"] - out["gather"]).abs().max()
                / out["gather"].abs().max())
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"mesh moe: {MOE_ARCH} MoE layer at full width ({e} experts, top "
        f"{k}, {cfg.n_shared_experts} shared; {gb / 1e9:.1f} GB fp32), "
        f"({b}, {s}) input, capacity factor {factor} (capacity {cap}, "
        f"busiest expert {int(load.max())}, {drops} tokens dropped): shard "
        f"{ms['shard']:.2f} ms, gather {ms['gather']:.2f} ms (CUDA "
        f"events); outputs {rel:.3e} apart relative; shard degrades "
        f"{degrades}; peak {peak:.1f} GB")
    if drops or degrades or not rel <= MESH_MOE_RTOL:
        fail(f"mesh moe: {drops} drops, {degrades} degrades, outputs "
             f"{rel:.3e} apart (limit {MESH_MOE_RTOL})")
    del p, x, out
    return {"capacity_factor": factor, "capacity": cap, "drops": drops,
            "max_load": int(load.max()), "shard_ms": ms["shard"],
            "gather_ms": ms["gather"], "rel_err": rel, "weights_gb": gb / 1e9,
            "peak_gb": peak}


def _mesh_train(cfg, mesh) -> dict:
    """Phase 23c-d: one full-width qwen3-0.6b train step on a
    ``SyntheticLM`` TRAIN_BATCH batch under the ``fsdp`` profile on the
    mesh (DTensor parameters) under each of MESH_LOGITS_LAYOUTS, from
    phase 21's initial state (weights from seed 0, the first batch of
    seed 1), against the plain step: the loss and every parameter within
    MESH_TRAIN_RTOL relative; each step timed.
    Then the mesh step's parameters saved and restored with ``axes=`` onto
    the mesh: every leaf placed by its axes and equal to the saved one."""
    import torch

    from repro_torch import compat
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.specializer import specialize_builder
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.sharding import (DEFAULT_RULES, is_dtensor,
                                                  mesh_context, replicate,
                                                  spec_for_axes)
    from repro_torch.models import transformer as model
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.training import make_train_builder

    dev = torch.device("cuda")
    b, s = TRAIN_BATCH
    opt_cfg = OptConfig(**TRAIN_OPT)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    batch = next(iter(SyntheticLM(cfg.vocab_size, b, s, seed=1, prefetch=0,
                                  device=dev)))
    config = {"sharding_profile": "fsdp"}
    steps = {"plain": specialize_builder(
        make_train_builder(cfg, opt_cfg), config).fn}
    for layout in MESH_LOGITS_LAYOUTS:
        steps["mesh" if layout == "sharded" else f"mesh_{layout}"] = \
            specialize_builder(make_train_builder(cfg, opt_cfg, mesh),
                               dict(config, logits_layout=layout)).fn
    new, loss, ms = {}, {}, {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for name, step in steps.items():
        t0 = time.perf_counter()
        new[name], m = step(state, batch)
        loss[name] = float(m["loss"])
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(MESH_TIMED_STEPS):
            torch.cuda.synchronize()
            start.record()
            _, m = step(state, batch)
            end.record()
            float(m["loss"])
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms[name] = statistics.median(times)
        log(f"mesh train: {name} step {ms[name]:.1f} ms (median of "
            f"{MESH_TIMED_STEPS}, CUDA events; first call {first_s:.1f} s "
            f"wall), loss {loss[name]:.7f}")
    layouts = {}
    for name in steps:
        if name == "plain":
            continue
        leaves = compat.tree_leaves(new[name]["params"])
        if not all(is_dtensor(t) for t in leaves):
            fail(f"mesh train: a parameter of the {name} step came back as "
                 f"a plain tensor")
        loss_rel = abs(loss[name] - loss["plain"]) / abs(loss["plain"])
        param_rel = max(float((replicate(a) - w).abs().max()
                              / w.abs().max().clamp_min(1e-30))
                        for a, w in zip(leaves, compat.tree_leaves(
                            new["plain"]["params"])))
        log(f"mesh train: {name} loss {loss_rel:.3e} apart relative, "
            f"parameters within {param_rel:.3e} of each leaf's max; "
            f"DTensor's overhead on one card {ms[name] - ms['plain']:.1f} "
            f"ms a step")
        if loss_rel > MESH_TRAIN_RTOL or param_rel > MESH_TRAIN_RTOL:
            fail(f"mesh train: {name} loss {loss_rel:.3e}, parameters "
                 f"{param_rel:.3e} (limit {MESH_TRAIN_RTOL})")
        layouts[name] = {"loss_rel": loss_rel, "param_rel": param_rel,
                         "ms": ms[name]}
    loss_rel, param_rel = (layouts["mesh"]["loss_rel"],
                           layouts["mesh"]["param_rel"])
    del new["plain"]

    ckpt = SCRATCH / "mesh_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt), keep=1)
    t0 = time.perf_counter()
    mgr.save(1, new["mesh"]["params"], block=True)
    save_s = time.perf_counter() - t0
    axes = model.param_axes(cfg)
    with mesh_context(mesh, DEFAULT_RULES):
        t0 = time.perf_counter()
        restored, _ = mgr.restore(params, axes=axes)
        restore_s = time.perf_counter() - t0
        want = compat.tree_leaves(spec_for_axes(axes, params),
                                  is_leaf=lambda v: isinstance(v, tuple))
    got = compat.tree_leaves(restored)
    placed = all(is_dtensor(g) and tuple(g.placements) == w[1]
                 for g, w in zip(got, want))
    equal = all(torch.equal(replicate(g), replicate(a))
                for g, a in zip(got, leaves))
    log(f"mesh restore: saved in {save_s:.1f} s, restored with axes= onto "
        f"the mesh in {restore_s:.1f} s; placed by the axes: {placed}; "
        f"leaves equal: {equal}")
    if not (placed and equal):
        fail(f"mesh restore: placed {placed}, equal {equal}")
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"plain_ms": ms["plain"], "mesh_ms": ms["mesh"],
            "loss_rel": loss_rel, "param_rel": param_rel,
            "loss": loss["mesh"], "save_s": save_s, "restore_s": restore_s,
            "layouts": layouts}


def _mesh_moe_train(mesh) -> dict:
    """Phase 23e: a reduced kimi-k2 train step (fp32, MESH_MOE_TRAIN_BATCH,
    ``fsdp``) on the mesh with each spec of MESH_MOE_TRAIN_SPECS (the
    gather and the einsum MoE on each rank's own tokens, the microbatch
    split) against the plain step from the same state and batch: the
    loss and every parameter within MESH_TRAIN_RTOL relative."""
    import torch

    from repro_torch import compat, configs
    from repro_torch.core.specializer import specialize_builder
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.sharding import replicate
    from repro_torch.models import transformer as model
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.training import make_train_builder

    dev = torch.device("cuda")
    cfg = configs.get_reduced(KIMI_ARCH).replace(compute_dtype="float32")
    opt_cfg = OptConfig(**TRAIN_OPT)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    b, s = MESH_MOE_TRAIN_BATCH
    batch = next(iter(SyntheticLM(cfg.vocab_size, b, s, seed=1, prefetch=0,
                                  device=dev)))
    out = {}
    for spec in MESH_MOE_TRAIN_SPECS:
        config = dict(spec, sharding_profile="fsdp")
        loss, leaves = {}, {}
        for name, m in (("plain", None), ("mesh", mesh)):
            step = specialize_builder(make_train_builder(cfg, opt_cfg, m),
                                      config).fn
            new, met = step(state, batch)
            loss[name] = float(met["loss"])
            leaves[name] = [replicate(t)
                            for t in compat.tree_leaves(new["params"])]
        loss_rel = abs(loss["mesh"] - loss["plain"]) / abs(loss["plain"])
        param_rel = max(float((a - w).abs().max()
                              / w.abs().max().clamp_min(1e-30))
                        for a, w in zip(leaves["mesh"], leaves["plain"]))
        log(f"mesh moe train: reduced {KIMI_ARCH}, ({b}, {s}) fp32, {spec}: "
            f"loss {loss['mesh']:.7f}, {loss_rel:.3e} apart relative; "
            f"parameters within {param_rel:.3e} of each leaf's max")
        if loss_rel > MESH_TRAIN_RTOL or param_rel > MESH_TRAIN_RTOL:
            fail(f"mesh moe train {spec}: loss {loss_rel:.3e}, parameters "
                 f"{param_rel:.3e} (limit {MESH_TRAIN_RTOL})")
        out[spec["moe_impl"]] = {"loss_rel": loss_rel,
                                 "param_rel": param_rel}
    return out


def phase_mesh(cfg) -> dict:
    """Phase 23: the distributed layer on the card.  A one-rank NCCL group
    (``file://`` rendezvous under the script's work directory) and
    ``make_local_mesh(1, 1)`` on ``cuda``; (a) ``compressed_psum``, (b)
    the ``shard`` MoE at deepseek-v2's width, (c) a DTensor train step of
    qwen3-0.6b at full width under each logits layout, (d) its checkpoint
    restored onto the mesh, (e) a reduced kimi-k2 train step with the
    gather and the einsum MoE and the microbatch split.
    Every step under the mesh pins its implementations to ``torch_ref``:
    no kernel may launch and no fallback may be counted.  The group is
    destroyed at the end, so later work sees a clean process."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    work = SCRATCH / "mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{work}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, 1)
        log(f"mesh: {mesh}")
        out = {"psum": _mesh_psum(mesh)}
        with _NoKernelUnderTraining() as guard:
            out["moe"] = _mesh_moe(mesh)
            gc.collect()
            torch.cuda.empty_cache()
            out["train"] = _mesh_train(cfg, mesh)
            gc.collect()
            torch.cuda.empty_cache()
            out["moe_train"] = _mesh_moe_train(mesh)
            out["launches"] = guard.check("mesh")
    finally:
        dist.destroy_process_group()
    shutil.rmtree(work, ignore_errors=True)
    return out


def _cached_steps(name: str, cfg, params, mesh, config: dict, batch: int,
                  tokens: int) -> dict:
    """Phase 24a: ``tokens`` decode steps at ``batch`` of the decode
    builder on ``mesh`` against the plain one (both ``torch_ref``), each
    from an empty fp32 cache, on the same random tokens: the logits of
    every step within CACHED_RTOL of the plain step's largest; each step
    timed with CUDA events."""
    import torch

    from repro_torch.core.specializer import specialize_builder
    from repro_torch.models import transformer as model
    from repro_torch.models.transformer import RunOptions
    from repro_torch.training import make_decode_builder

    dev = torch.device("cuda")
    config = dict(config, cache_dtype="float32")
    step = {"plain": specialize_builder(make_decode_builder(
        cfg, kernel_impl="torch_ref"), config).fn,
        "mesh": specialize_builder(make_decode_builder(
            cfg, mesh, kernel_impl="torch_ref"), config).fn}
    opts = RunOptions(decode_cache_dtype="float32")
    cache = {k: model.init_cache(cfg, batch, CACHED_MAX_LEN, opts,
                                 device=dev) for k in step}
    gen = torch.Generator(device=dev).manual_seed(24)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    err, ms = 0.0, {k: [] for k in step}
    with torch.no_grad():
        for t in range(tokens):
            tok = torch.randint(0, cfg.vocab_size, (batch,), generator=gen,
                                device=dev, dtype=torch.int32)
            pos = torch.tensor(t, dtype=torch.int32, device=dev)
            logits = {}
            for k, fn in step.items():
                torch.cuda.synchronize()
                start.record()
                logits[k], cache[k] = fn(params, cache[k], tok, pos)
                end.record()
                end.synchronize()
                ms[k].append(start.elapsed_time(end))
            if type(logits["mesh"]) is not torch.Tensor:
                fail(f"cached {name}: the mesh step's logits came back as "
                     f"{type(logits['mesh']).__name__}")
            err = max(err, float((logits["mesh"] - logits["plain"]).abs()
                                 .max() / logits["plain"].abs().max()))
    med = {k: statistics.median(v[1:]) for k, v in ms.items()}
    log(f"mesh cached {name}: {tokens} decode steps at batch {batch} "
        f"({config}): mesh {med['mesh']:.1f} ms a step, plain "
        f"{med['plain']:.1f} ms (median after the first, CUDA events); "
        f"logits within {err:.3e} of the plain step's largest (limit "
        f"{CACHED_RTOL})")
    if not err <= CACHED_RTOL:
        fail(f"mesh cached {name}: logits {err:.3e} apart (limit "
             f"{CACHED_RTOL})")
    del cache
    return {"rel_err": err, "mesh_ms": med["mesh"], "plain_ms": med["plain"]}


def _dryrun_held_to_card(cfg, mesh) -> dict:
    """Phase 24b: the dry run's count of phase 23's train step (fsdp,
    TRAIN_BATCH, fp32, the state donated) on a fake world of one rank (a
    subprocess), then the same donated step on the card under the mesh:
    its FLOPs by ``FlopCounterMode`` (exact at one rank) equal to the
    count, its peak (``max_memory_allocated`` above what was allocated
    before the state was made) within DRYRUN_PEAK_RTOL of the predicted
    argument + temp; its ms by CUDA events beside the roofline's terms.
    The dry run's arguments are placed on the mesh already; on the card
    the first donated step places the state's plain tensors (the step
    puts each placed DTensor in the state), so the count is held to the
    second step, which updates that state in place."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.specializer import specialize_builder
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer as model
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.training import make_train_builder

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", DRYRUN_PROBE, json.dumps(TRAIN_BATCH),
         json.dumps(TRAIN_OPT)], capture_output=True, text=True,
        timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    probe_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"dry run probe: exit {proc.returncode}: {proc.stderr[-3000:]}")
    pred = json.loads(proc.stdout.strip().splitlines()[-1])
    mem = pred["memory"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    opt_cfg = OptConfig(**TRAIN_OPT)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    del params
    b, s = TRAIN_BATCH
    batch = next(iter(SyntheticLM(cfg.vocab_size, b, s, seed=1, prefetch=0,
                                  device=dev)))
    step = specialize_builder(make_train_builder(cfg, opt_cfg, mesh),
                              {"sharding_profile": "fsdp"},
                              donate_argnums=(0,)).fn
    state, m = step(state, batch)
    float(m["loss"])
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        out = step(state, batch)
        float(out[1]["loss"])
    if out[0] is not state:
        fail("dry run held to the card: the donated step did not return "
             "the state it was given")
    del out
    peak = torch.cuda.max_memory_allocated() - base
    flops = float(fc.get_total_flops())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(MESH_TIMED_STEPS):
        torch.cuda.synchronize()
        start.record()
        out = step(state, batch)
        end.record()
        float(out[1]["loss"])
        end.synchronize()
        del out
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    flops_rel = abs(pred["flops"] - flops) / flops
    peak_rel = abs(predicted - peak) / peak
    rf = pred["roofline"]
    log(f"dry run held to the card: phase 23's train step (fsdp, "
        f"{TRAIN_BATCH}, fp32, donated) counted on a fake world of one rank in "
        f"{probe_s:.1f} s: {pred['flops']:.6e} FLOPs against "
        f"FlopCounterMode's {flops:.6e} on the card ({flops_rel:.2e} "
        f"apart, limit {DRYRUN_FLOPS_RTOL}); argument "
        f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB + temp "
        f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB = {predicted / 1e9:.3f} "
        f"GB against a measured peak of {peak / 1e9:.3f} GB "
        f"({peak_rel:.3f} apart, limit {DRYRUN_PEAK_RTOL}); largest at "
        f"the peak {mem['peak_tensors'][:3]}; the step {ms:.1f} ms (median "
        f"of {MESH_TIMED_STEPS}, CUDA events) against the roofline's "
        f"compute {rf['compute_s'] * 1e3:.1f} ms (fp32 peak) and memory "
        f"{rf['memory_s'] * 1e3:.1f} ms")
    if not flops_rel <= DRYRUN_FLOPS_RTOL:
        fail(f"dry run: FLOPs {pred['flops']} against {flops}")
    if not peak_rel <= DRYRUN_PEAK_RTOL:
        fail(f"dry run: predicted {predicted} bytes against a peak of "
             f"{peak}")
    del state, batch
    return {"flops": pred["flops"], "card_flops": flops,
            "predicted_bytes": predicted, "peak_bytes": peak,
            "peak_rel": peak_rel, "ms": ms,
            "compute_ms": rf["compute_s"] * 1e3,
            "memory_ms": rf["memory_s"] * 1e3, "probe_s": probe_s}


def _dryrun_errors(out: Path, what: str) -> None:
    """Fail, naming each cell, if the dry run left a ``<cell>.error.txt``
    under ``out`` (it exits 0 when a cell fails, as the reference's)."""
    errors = sorted(out.rglob("*.error.txt"))
    if errors:
        fail(f"{what}: failed cells " + "; ".join(
            f"{e.relative_to(out).with_suffix('').with_suffix('')}: "
            f"{e.read_text().strip().splitlines()[-1]}" for e in errors))


def _start_dryrun(args: list, out: Path) -> dict:
    """Start the dry-run CLI with ``args`` writing into ``out`` (emptied
    first), its output to ``out``.log: it runs on the host, beside the
    card's work (phase 24 starts both cells first and reads them last)."""
    shutil.rmtree(out, ignore_errors=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    log_path = out.with_suffix(".log")
    with open(log_path, "w") as sink:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", str(out)], stdout=sink, stderr=subprocess.STDOUT,
            text=True, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return {"proc": proc, "t0": time.perf_counter(), "out": out,
            "log": log_path}


def _finish_dryrun(run: dict, what: str, artifact: str) -> tuple:
    """Wait for a run of :func:`_start_dryrun` (at most 900 s from its
    start; killed past that) and fail unless it exited 0 and wrote
    ``artifact`` under its ``out``; its seconds and the artifact's
    contents."""
    proc = run["proc"]
    try:
        proc.wait(timeout=max(1.0, 900 - (time.perf_counter() - run["t0"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    secs = time.perf_counter() - run["t0"]
    _dryrun_errors(run["out"], what)
    art = run["out"] / "single" / artifact
    if proc.returncode != 0 or not art.exists():
        fail(f"{what}: exit {proc.returncode}, artifact {art.exists()}: "
             f"{run['log'].read_text()[-5000:]}")
    return secs, json.loads(art.read_text())


def _dryrun_cli(run: dict) -> dict:
    """Phase 24c: the dry-run CLI on the single-pod production mesh (256
    ranks of the fake backend) for qwen3-0.6b's decode_32k under
    serve_ep (started by :func:`_start_dryrun`): it exits 0 and writes its
    artifact, whose per-rank argument + temp is at most the placed cache
    plus the parameters' local shards plus DRYRUN_CLI_SLACK (a working
    copy of the whole cache would be 481 GB)."""
    secs, res = _finish_dryrun(run, "dry run CLI",
                               "qwen3-0.6b__decode_32k.json")
    mem = res["full"]["memory"]
    held = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    bound = (mem["cache_placed_bytes"] + mem["params_size_in_bytes"]
             + DRYRUN_CLI_SLACK)
    rf = res["roofline"]
    log(f"dry run CLI: {' '.join(DRYRUN_CLI)} in {secs:.1f} s: a rank "
        f"holds {held / 1e9:.3f} GB (arguments "
        f"{mem['argument_size_in_bytes'] / 1e9:.3f} + temp "
        f"{mem['temp_size_in_bytes'] / 1e9:.3f}; the cache placed "
        f"{mem['cache_placed_bytes'] / 1e9:.3f} of "
        f"{mem['cache_whole_bytes'] / 1e9:.1f} GB whole; bound "
        f"{bound / 1e9:.3f}); roofline compute {rf['compute_s']:.3e} s, "
        f"memory {rf['memory_s']:.3e} s, collective "
        f"{rf['collective_s']:.3e} s, {rf['dominant']}")
    if held > bound:
        fail(f"dry run CLI: {held} bytes a rank, over {bound}")
    return {"seconds": secs, "held_bytes": held, "bound_bytes": bound,
            "cache_placed_bytes": mem["cache_placed_bytes"]}


def _dryrun_hymba(run: dict) -> dict:
    """Phase 24c, second cell: the dry-run CLI on the single-pod production
    mesh for hymba-1.5b's prefill_32k under the hillclimb's c2_logitsbf16
    spec (25 heads split unevenly over model = 16; started by
    :func:`_start_dryrun`): it exits 0, no score tensor among the five
    largest at the peak holds more than 2 heads, and a rank's temp is at
    most DRYRUN_HYMBA_TEMP."""
    secs, res = _finish_dryrun(run, "dry run CLI (hymba)",
                               "hymba-1.5b__prefill_32k__c2_logitsbf16.json")
    mem = res["full"]["memory"]
    temp = mem["temp_size_in_bytes"]
    # a score tensor: (batch, heads, chunks, rows, keys), banded
    heads = max((t["shape"][1] for t in mem["peak_tensors"]
                 if len(t["shape"]) == 5), default=0)
    log(f"dry run CLI: {' '.join(DRYRUN_HYMBA)} in {secs:.1f} s: a rank "
        f"holds {mem['argument_size_in_bytes'] / 1e9:.3f} GB of arguments "
        f"and {temp / 1e9:.3f} GB of temp (bound "
        f"{DRYRUN_HYMBA_TEMP / 1e9:.0f}); largest at the peak "
        f"{[(t['shape'], t['dtype']) for t in mem['peak_tensors']]}")
    if temp > DRYRUN_HYMBA_TEMP or heads > 2:
        fail(f"dry run CLI (hymba): {temp} bytes of temp a rank, a score "
             f"tensor of {heads} heads")
    return {"seconds": secs, "temp_bytes": temp,
            "argument_bytes": mem["argument_size_in_bytes"]}


def phase_cached_mesh(cfg) -> dict:
    """Phase 24: the repaired cached steps, the dry run and its CLI.  A
    one-rank NCCL group and ``make_local_mesh(1, 1)`` as in phase 23; (a)
    the cached decode steps of qwen3-0.6b (both cache layouts) and of
    deepseek-v2-236b at full width and depth CACHED_MLA_DEPTH (serve_ep)
    against the plain step (deepseek-v2 with each MoE dispatch), no
    kernel launched and no fallback counted; (b) the dry run held to the
    card; (c) the dry-run CLI at the production mesh: qwen3-0.6b
    decode_32k and hymba-1.5b prefill_32k's uneven heads, two processes
    on the host started first and read last.  The group is destroyed at
    the end."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as model

    work = SCRATCH / "cached_mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    # (c)'s cells need only the host: they run while (a) and (b) use the
    # card
    cells = [_start_dryrun(DRYRUN_CLI, SCRATCH / "dryrun"),
             _start_dryrun(DRYRUN_HYMBA, SCRATCH / "dryrun_hymba")]
    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{work}/rendezvous",
                            rank=0, world_size=1)
    out = {}
    try:
        mesh = make_local_mesh(1, 1)
        with _NoKernelUnderTraining() as guard:
            params = model.init_params(
                torch.Generator(device=dev).manual_seed(0), cfg)
            b, n = CACHED_SERVE
            for layout in ("seq", "batch"):
                out[f"qwen3_{layout}"] = _cached_steps(
                    f"{cfg.name} cache_layout={layout}", cfg, params, mesh,
                    {"cache_layout": layout}, b, n)
            del params
            gc.collect()
            torch.cuda.empty_cache()
            mcfg = configs.get_config(MOE_ARCH).replace(
                compute_dtype="float32", n_layers=CACHED_MLA_DEPTH)
            params = model.init_params(
                torch.Generator(device=dev).manual_seed(0), mcfg)
            b, n = CACHED_MLA
            for impl in CACHED_MOE_IMPLS:
                out["mla" if impl == "gather" else f"mla_{impl}"] = \
                    _cached_steps(
                        f"{MOE_ARCH} depth {CACHED_MLA_DEPTH} serve_ep "
                        f"{impl}", mcfg, params, mesh,
                        {"sharding_profile": "serve_ep", "moe_impl": impl},
                        b, n)
            del params
            gc.collect()
            torch.cuda.empty_cache()
            out["launches"] = guard.check("mesh cached")
        out["dryrun"] = _dryrun_held_to_card(cfg, mesh)
        out["cli"] = _dryrun_cli(cells[0])
        out["hymba"] = _dryrun_hymba(cells[1])
    finally:
        dist.destroy_process_group()
        for cell in cells:                     # stopped on any failure
            if cell["proc"].poll() is None:
                cell["proc"].kill()
                cell["proc"].wait()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    log(f"phase 24 took {time.perf_counter() - t0:.1f} s")
    return out


def main(argv: list[str]) -> None:
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
    if argv[:1] == ["--restart-run"]:
        restart_run(argv[1])             # one run of phase 14, in its process
        return

    from repro_torch import compat, configs

    t_start = time.perf_counter()
    seconds: dict[str, float] = {}

    def timed(fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, its wall seconds added to its phase's
        (the function's name) in ``seconds``."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[fn.__name__] = round(
            seconds.get(fn.__name__, 0.0) + time.perf_counter() - t0, 1)
        return out

    compat.resolve_device("cuda")
    device = timed(phase_device)
    timed(phase_build)
    cfg = configs.get_config("qwen3-0.6b").replace(compute_dtype="float32")
    rms = timed(phase_rmsnorm, cfg)
    attn = timed(phase_attention)
    linatt = timed(phase_linear_attention)
    mm = timed(phase_matmul)
    fpk = timed(phase_fastpath)
    guards = timed(phase_guards, rms["decode_by_kind"])
    main_path = timed(phase_main_path, cfg)
    params = main_path.pop("built").params
    serve = timed(phase_parity, cfg, params)
    prefill = timed(phase_prefill, cfg, params)
    timed(phase_prefill_parity, cfg, params, serve)
    del params, serve
    torch.cuda.empty_cache()
    rcfg = configs.get_config("rwkv6-1.6b").replace(compute_dtype="float32")
    rprefill = timed(phase_rwkv_prefill, rcfg)
    rparams = rprefill.pop("params")
    rserve = timed(phase_rwkv_serve, rcfg, rparams)
    timed(phase_rwkv_parity, rcfg, rparams)
    del rparams
    torch.cuda.empty_cache()
    table1 = timed(phase_table1)
    router = timed(phase_router)
    SCRATCH.mkdir(parents=True, exist_ok=True)
    restart = timed(phase_restart)
    tenant = timed(phase_tenants)
    fleet = timed(phase_fleet)
    family_k = timed(phase_family_kernels)
    serve_archs = dict(FAMILY_SERVE)
    family = {a: timed(phase_family_prefill, a, keep=a in serve_archs,
                       sweep_labels=(HYMBA_SWEEP_LABELS
                                     if a == "hymba-1.5b" else None))
              for a in FAMILY_ARCHS}
    family_serve = {a: timed(phase_family_serve, a, max_len,
                             family[a].pop("params"))
                    for a, max_len in FAMILY_SERVE}
    # phase 18's engines hold its weights in reference cycles
    gc.collect()
    torch.cuda.empty_cache()
    half = timed(phase_half, {
        "qwen3-0.6b": {"ms": prefill["sweep_ms"],
                       "what": "fp32, phase 7's settled config"},
        "rwkv6-1.6b": {"ms": rprefill["sweep_ms"],
                       "what": "fp32, phase 9's settled config"},
        "hymba-1.5b": {"ms": family["hymba-1.5b"]["call_ms"],
                       "what": "fp32, phase 17's generic variant"}})
    # phase 18's engines hold its weights in reference cycles: collect them
    # before 53 GB of deepseek-v2 weights need the card
    gc.collect()
    torch.cuda.empty_cache()
    moe_k = timed(phase_moe_kernels)
    moe = timed(phase_moe_prefill)
    moe_serve = timed(phase_moe_serve, moe.pop("cfg"), moe.pop("params"))
    gc.collect()
    torch.cuda.empty_cache()
    kcfg = configs.get_reduced(KIMI_ARCH).replace(compute_dtype="float32")
    kimi = timed(phase_family_prefill, KIMI_ARCH, keep=True, cfg=kcfg,
                 shape=KIMI_PREFILL)
    kimi_serve = timed(phase_family_serve, KIMI_ARCH, MOE_SERVE_MAX_LEN,
                       kimi.pop("params"), cfg=kcfg)
    gc.collect()
    torch.cuda.empty_cache()
    train = timed(phase_train, cfg)
    train["parity"] = timed(_reduced_step_parity)
    train["restart"] = timed(phase_train_restart, cfg, train)
    gc.collect()
    torch.cuda.empty_cache()
    train["donation"] = timed(phase_train_donation, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    timed(phase_moe_train)
    gc.collect()
    torch.cuda.empty_cache()
    mesh = timed(phase_mesh, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    cached = timed(phase_cached_mesh, cfg)
    log(f"total {time.perf_counter() - t_start:.1f}s")

    # K2 per (1, 4096) prefill call: 28 launches at the full-width shape,
    # at the tiles the prefill Controller chose (the default pair if it
    # chose the plain version).
    b, h, hk, dh = ATTN_WIDTH
    at = next(r for r in attn["per_shape"]
              if r["shape"] == [b, h, hk, PREFILL_SWEEP[1], dh, dh]
              and r["dtype"] == "float32")
    mla_at = next(r for r in attn["per_shape"]
                  if r["shape"][4:] == [ATTN_MLA_CASES[0][0][3],
                                        ATTN_MLA_CASES[0][2][3]]
                  and r["dtype"] == "float32")
    mla_tiles = min(mla_at["kernel_ms_by_tiles"],
                    key=mla_at["kernel_ms_by_tiles"].get)
    chosen = prefill["chosen"]
    tiles = f"{chosen['block_q']}x{chosen['block_kv']}"
    n = N_LAYERS
    # K4 per rwkv6 (1, 4096) prefill call: 24 launches at the full-width
    # shape, at the chunk the rwkv6 Controller chose.
    la_at = next(r for r in linatt["per_shape"]
                 if r["shape"] == [RWKV_HEADS, RWKV_SWEEP[1], RWKV_HEAD,
                                   RWKV_HEAD] and r["dtype"] == "float32")
    c = str(rprefill["chosen"]["chunk_len"])
    rn = RWKV_LAYERS
    # K3 at (TABLE1_N,)^3 fp32, the Table-1 handler's product, at its
    # best-measured tiles; the Table-1 Controller may settle on the plain
    # version, which the entry names.
    mm_at = next(r for r in mm["per_shape"]
                 if r["shape"] == [TABLE1_N] * 3 and r["dtype"] == "float32")
    mm_tiles = min(mm_at["kernel_ms_by_tiles"],
                   key=mm_at["kernel_ms_by_tiles"].get)
    # and the same product in bf16 and fp16 on the wgmma body, at its best
    # tiles
    mm_half = {}
    for dt in ("bfloat16", "float16"):
        r = next(r for r in mm["per_shape"]
                 if r["shape"] == [TABLE1_N] * 3 and r["dtype"] == dt)
        t = min(r["kernel_ms_by_tiles"], key=r["kernel_ms_by_tiles"].get)
        mm_half[dt] = {"tiles": t, "body": r["body_by_tiles"][t],
                       "ms": r["kernel_ms_by_tiles"][t],
                       "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"],
                       "library_ms": r["library_ms"]}
    # K5 per router batch: one launch at fig 4's shape (ROUTER_BATCH
    # addresses against FIG4_HOT keys, int32 next hops), block_b 256.
    fp_at = next(r for r in fpk["per_shape"]
                 if r["shape"] == [ROUTER_BATCH, FIG4_HOT, 1, 1])
    kernels = [{
        "name": "rmsnorm",
        "route": "cuda",
        "mesh_launches": mesh["launches"]["rmsnorm"],
        "cached_mesh_launches": cached["launches"]["rmsnorm"],
        "train_launches": train["launches"]["rmsnorm"],
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:29",
        "launches": main_path["launches"] + sum(
            f["launches"]["rmsnorm"] for f in family.values()) + sum(
            f["cuda"]["launches"] for f in family_serve.values())
        + moe["launches"]["rmsnorm"] + moe_serve["serve"]["cuda"]["launches"]
        + kimi["launches"]["rmsnorm"] + kimi_serve["cuda"]["launches"]
        + half["launches"]["rmsnorm"],
        "serve_launches": main_path["launches"],
        "max_abs_err": rms["max_abs_err"],
        "ms": rms["ms"],
        "plain_ms": rms["plain_ms"],
        "bound_ms": rms["bound_ms"],
        "bound_by": rms["bound_by"],
        "library_ms": rms["library_ms"],
        "per": f"one full-width decode step at batch {DECODE_BATCH} "
               f"({rms['decode_launches']} launches; F.rms_norm makes "
               f"{rms['decode_library_calls']} calls)",
        "prefill_launches": prefill["rmsnorm_launches"],
        "rwkv6_prefill_launches": rprefill["rms_launches"],
        "rwkv6_serve_launches": rserve["launches"],
        "restart_launches": restart["launches"],
        "tenant_launches": {n: p["launches"]
                            for n, p in tenant["per_tenant"].items()},
        "fleet_launches": fleet["launches"],
        "family_prefill_launches": {a: f["launches"]["rmsnorm"]
                                    for a, f in family.items()},
        "family_serve_launches": {a: f["cuda"]["launches"]
                                  for a, f in family_serve.items()},
        "family_max_abs_err": family_k["max_abs_err"]["rmsnorm"],
        "moe_prefill_launches": moe["launches"]["rmsnorm"],
        "moe_serve_launches": moe_serve["serve"]["cuda"]["launches"],
        "kimi_prefill_launches": kimi["launches"]["rmsnorm"],
        "kimi_serve_launches": kimi_serve["cuda"]["launches"],
        "half_launches": half["launches"]["rmsnorm"],
        "half_serve_launches": half["serve"]["launches"],
        "half": {r["dtype"]: {
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "graph_ms": r["device_only"]["ms"],
            "per": f"one launch at {tuple(r['shapes'][0])} "
                   f"(x{r['launches_per_call']} a qwen3 (1, 4096) prefill)"}
            for r in rms["per_shape"] if r["kind"] == "single"
            and r["shapes"] == [list(next(iter(PREFILL_SHAPES)))]
            and r["dtype"] != "float32"},
        "moe_max_abs_err": moe_k["max_abs_err"]["rmsnorm"],
        "moe_widths": moe_k["widths"],
        "shapes": rms["per_shape"],
    }, {
        "name": "attention",
        "route": "cuda",
        "mesh_launches": mesh["launches"]["attention"],
        "cached_mesh_launches": cached["launches"]["attention"],
        "train_launches": train["launches"]["attention"],
        "source": "src/repro_torch/kernels/attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:106",
        "launches": prefill["attention_launches"] + sum(
            f["launches"]["attention"] for f in family.values())
        + moe["launches"]["attention"] + kimi["launches"]["attention"]
        + half["launches"]["attention"],
        "half_launches": half["launches"]["attention"],
        "half": {r["dtype"]: {
            "tiles": min(r["kernel_ms_by_tiles"],
                         key=r["kernel_ms_by_tiles"].get),
            "ms": n * min(r["kernel_ms_by_tiles"].values()),
            "plain_ms": n * r["plain_ms"] if r["plain_ms"] else None,
            "bound_ms": n * r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": (n * r["library_ms"] if r["library_ms"] is not None
                           else None),
            "per": f"one (1, {PREFILL_SWEEP[1]}) qwen3 prefill call ({n} "
                   f"launches, the best tiles)"}
            for r in attn["per_shape"]
            if r["shape"] == [b, h, hk, PREFILL_SWEEP[1], dh, dh]
            and r["dtype"] != "float32"},
        "prefill_launches": prefill["attention_launches"],
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
        "body": at["body_by_tiles"][tiles]["body"],
        "cuda_launches_per_call":
            at["body_by_tiles"][tiles]["cuda_launches_per_call"],
        "mla": {"shape": mla_at["shape"], "tiles": mla_tiles,
                "ms": mla_at["kernel_ms_by_tiles"][mla_tiles],
                "bound_ms": mla_at["bound_ms"],
                "library_ms": mla_at["library_ms"]},
        "family_prefill_launches": {a: f["launches"]["attention"]
                                    for a, f in family.items()},
        "family_max_abs_err": family_k["max_abs_err"]["attention"],
        "moe_prefill_launches": moe["launches"]["attention"],
        "kimi_prefill_launches": kimi["launches"]["attention"],
        "moe_max_abs_err": moe_k["max_abs_err"]["attention"],
        "mla128": dict(moe_k["mla_attention"],
                       per=f"one launch at {MOE_ARCH}'s (1, 4096) prefill "
                           f"shape (a layer's MLA attention)"),
        "hymba": dict(family_k["hymba_attention"],
                      per="one launch at hymba-1.5b's (1, 4096) prefill "
                          "shape (a layer's attention branch)"),
        "wide_checked": attn["wide_checked"],
        "wide256": {r["dtype"]: {
            "tiles": min(r["kernel_ms_by_tiles"],
                         key=r["kernel_ms_by_tiles"].get),
            "ms": min(r["kernel_ms_by_tiles"].values()),
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "per": f"one causal launch at (1, {h} q / {hk} kv heads, "
                   f"{ATTN_MLA_TIMED}, {ATTN_WIDE_TIMED}), the best tiles"}
            for r in attn["per_shape"]
            if r["shape"] == [b, h, hk, ATTN_MLA_TIMED, ATTN_WIDE_TIMED,
                              ATTN_WIDE_TIMED]},
        "shapes": attn["per_shape"],
    }, {
        "name": "linear_attention",
        "route": "cuda",
        "mesh_launches": mesh["launches"]["linear_attention"],
        "cached_mesh_launches": cached["launches"]["linear_attention"],
        "train_launches": train["launches"]["linear_attention"],
        "source": "src/repro_torch/kernels/linear_attention/csrc/"
                  "linear_attention.cu",
        "replaces": "src/repro/kernels/linear_attention/kernel.py:76",
        "launches": rprefill["la_launches"] + sum(
            f["launches"]["linear_attention"] for f in family.values())
        + half["launches"]["linear_attention"],
        "half_launches": half["launches"]["linear_attention"],
        "half": {r["dtype"]: {
            "ms": rn * r["kernel_ms_by_chunk"][c],
            "plain_ms": rn * r["plain_ms_by_chunk"][c],
            "bound_ms": rn * r["bound_ms_by_chunk"][c],
            "bound_by": r["bound_by_chunk"][c], "library_ms": None,
            "per": f"one rwkv6 (1, {RWKV_SWEEP[1]}) prefill call ({rn} "
                   f"calls, chunk {c})"}
            for r in linatt["per_shape"]
            if r["shape"] == [RWKV_HEADS, RWKV_SWEEP[1], RWKV_HEAD, RWKV_HEAD]
            and r["dtype"] != "float32"},
        "rwkv6_prefill_launches": rprefill["la_launches"],
        "max_abs_err": linatt["max_abs_err"],
        "max_abs_err_by_dtype": linatt["max_abs_err_by_dtype"],
        "ms": rn * la_at["kernel_ms_by_chunk"][c],
        "plain_ms": rn * la_at["plain_ms_by_chunk"][c],
        "bound_ms": rn * la_at["bound_ms_by_chunk"][c],
        "bound_by": la_at["bound_by_chunk"][c],
        "library_ms": None,
        "library_note": "no single PyTorch call computes chunked gated "
                        "linear attention",
        "per": f"one full-width rwkv6-1.6b (1, {RWKV_SWEEP[1]}) prefill "
               f"call ({rn} calls at ({RWKV_HEADS}, {RWKV_SWEEP[1]}, "
               f"{RWKV_HEAD}, {RWKV_HEAD}) fp32, exclusive with the bonus, "
               f"chunk {c}; each call is "
               f"{la_at['cuda_launches_per_call_by_chunk'][c]:g} CUDA "
               f"launches)",
        "body": "chunk-parallel (summaries, state fold, outputs)",
        "cuda_launches_per_call":
            la_at["cuda_launches_per_call_by_chunk"][c],
        "launch_us": la_at["launch_us_by_chunk"][c],
        "wide_checked": linatt["wide_checked"],
        "gla": {r["dtype"]: (lambda g: {
            "chunk": g, "ms": r["kernel_ms_by_chunk"][g],
            "plain_ms": r["plain_ms_by_chunk"][g],
            "bound_ms": r["bound_ms_by_chunk"][g],
            "bound_by": r["bound_by_chunk"][g], "library_ms": None,
            "per": f"one inclusive call at {LINATT_GLA_TIMED} (bh, T, dk, "
                   f"dv), the best chunk"})(
                min(r["kernel_ms_by_chunk"], key=r["kernel_ms_by_chunk"].get))
            for r in linatt["per_shape"]
            if r["shape"] == list(LINATT_GLA_TIMED)},
        "family_prefill_launches": {a: f["launches"]["linear_attention"]
                                    for a, f in family.items()},
        "family_max_abs_err": family_k["max_abs_err"]["linear_attention"],
        "hymba": dict(family_k["hymba_linear_attention"],
                      per="one call as hymba-1.5b's SSM heads make it in a "
                          "(1, 4096) prefill layer: inclusive, no bonus, "
                          "q/k broadcast over 25 heads, the decay "
                          "expanded to (25, 4096, 16)"),
        "shapes": linatt["per_shape"],
    }, {
        "name": "matmul",
        "route": "cuda",
        "mesh_launches": mesh["launches"]["matmul"],
        "cached_mesh_launches": cached["launches"]["matmul"],
        "train_launches": train["launches"]["matmul"],
        "source": "src/repro_torch/kernels/matmul/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul/kernel.py:43",
        "launches": table1["launches"],
        "max_abs_err": mm["max_abs_err"],
        "max_abs_err_by_dtype": mm["max_abs_err_by_dtype"],
        "ms": mm_at["kernel_ms_by_tiles"][mm_tiles],
        "plain_ms": mm_at["plain_ms"],
        "bound_ms": mm_at["bound_ms"],
        "bound_by": mm_at["bound_by"],
        "library_ms": mm_at["library_ms"],
        "library_note": "torch.matmul (cuBLAS fp32 SGEMM, TF32 off)",
        "per": f"one K3 launch at ({TABLE1_N},{TABLE1_N}) x ({TABLE1_N},"
               f"{TABLE1_N}) fp32 at its best-measured tiles {mm_tiles}, "
               f"not a settled Table-1 call",
        "bf16": mm_half["bfloat16"],
        "fp16": mm_half["float16"],
        "checked_by_class": mm["by_class"],
        "hgmma_by_function": mm["hgmma_by_function"],
        "settled_impl": table1["chosen"]["matmul_impl"],
        "settled_tiles": table1["chosen"]["tiles"],
        "shapes": mm["per_shape"],
    }, {
        "name": "fastpath",
        "route": "cuda",
        "mesh_launches": mesh["launches"]["fastpath"],
        "cached_mesh_launches": cached["launches"]["fastpath"],
        "train_launches": train["launches"]["fastpath"],
        "source": "src/repro_torch/kernels/fastpath/csrc/fastpath.cu",
        "replaces": "src/repro/kernels/fastpath/kernel.py:44",
        "launches": router["launches"],
        "fig4_launches": router["fig4_launches"],
        "max_abs_err": fpk["max_abs_err"],
        "ms": fp_at["ms"],
        "graph_ms": fp_at["graph_ms"],
        "body": fp_at["body"],
        "launches_per_call": router["launches_per_call"],
        "plain_ms": fp_at["plain_ms"],
        "bound_ms": fp_at["bound_ms"],
        "bound_by": fp_at["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call matches keys and gathers "
                        "the summed values",
        "per": f"one router batch: {ROUTER_BATCH} int32 addresses against "
               f"a prepared table of {FIG4_HOT} hot keys, int32 next hops, "
               f"block_b 256; launches_per_call: device launches a Fig 4 "
               f"all-hit call of the specialized function",
        "wider_checked": fpk["wider_checked"],
        "wider_timed": fpk["wider_timed"],
        "make_fastpath_wide_keys": fpk["make_fastpath"],
        "shapes": fpk["per_shape"],
    }]
    for entry in kernels:
        entry["guards"] = [{"case": c["case"], "launches": c["launches"],
                            "fallbacks": c["fallbacks"],
                            "raised": c["raised"]}
                           for c in guards["checks"]
                           if c["kernel"] == entry["name"]]
    kernels[0]["serve_decode_host_ms"] = main_path["decode_host_ms"]
    kernels[0]["guard_ms_a_decode_step"] = guards["k1_guard_ms_a_decode_step"]
    log("phase wall seconds: " + json.dumps(seconds))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
