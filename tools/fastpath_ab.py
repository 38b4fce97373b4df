#!/usr/bin/env python3
"""Time the fast-path matcher (K5) and the Fig 4 router fast path of a
checkout of this repository, on one CUDA card; or of two checkouts in
turns, so that a change and its parent are compared on one card.

    python3 tools/fastpath_ab.py                     # this checkout
    python3 tools/fastpath_ab.py --turns OTHER_DIR   # OTHER, this, this, OTHER

A checkout is measured in a process of its own, with its own package
(``src/repro_torch``), its own ``chip_smoke.py`` (for ``cuda_time_ms``,
``graph_time_ms`` and the Fig 4 LPM table) and its own kernel build:

- K5 at the router batch, (8192, 16, 1, 1) int32 (one Fig 4 batch against
  its 16 hot keys), and at (65536, 4096, 1, 16) fp32 (the generator's hot
  pool): eager (``cuda_time_ms``: back-to-back calls between CUDA events,
  the host's part included) and device time in a CUDA graph of 100
  launches, through the wrapper the fast path calls: the prepared table
  where the checkout has one (``kernel.prepare_table``), else the raw one;
  the raw wrapper too;
- the Fig 4 fast path and its generic, a batch of 8192 addresses at 100 %
  hit, at each LPM table size (``chip_smoke.FIG4_TABLES``);
- the host's microseconds to allocate a router batch's outputs as one
  allocation cut by views or as two allocations (``alloc_us``).

Each run prints one JSON line; ``--turns`` prints each turn's line, then
the per-tree medians, and writes all of it to ``--out`` when given.
Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(tree: Path) -> dict:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch import compat
    from repro_torch.core.fastpath import FastPathTable, make_fastpath
    from repro_torch.kernels.fastpath import kernel

    if not torch.cuda.is_available():
        sys.exit("fastpath_ab: no CUDA device")
    compat.resolve_device("cuda")
    kernel.load_library()
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    prepared = hasattr(kernel, "prepare_table")
    gen = torch.Generator(device=dev).manual_seed(6)
    result = {"tree": str(tree), "card": card, "prepared": prepared}

    for name, (b, n, v, vdt) in (("k5_router", (8192, 16, 1, torch.int32)),
                                 ("k5_4096", (65536, 4096, 16,
                                              torch.float32))):
        keys = torch.randperm(4 * n, generator=gen, device=dev)[:n]
        keys = keys.to(torch.int32)[:, None].contiguous()
        x = keys[torch.randint(0, n, (b,), generator=gen, device=dev)]
        if vdt.is_floating_point:
            vals = torch.randn((n, v), generator=gen, device=dev)
        else:
            vals = torch.randint(1, 255, (n, v), generator=gen, device=dev,
                                 dtype=vdt)
        runs = {"raw": lambda: kernel.fastpath_cuda(x, keys, vals)}
        if prepared:
            table = kernel.prepare_table(keys, vals)
            runs["prepared"] = lambda: kernel.fastpath_cuda_prepared(x, table)
        row = {"shape": [b, n, 1, v]}
        for what, run in runs.items():
            row[what] = {"ms": cs.cuda_time_ms(run, 500, 50),
                         "graph_ms": cs.graph_time_ms(run, 100)}
        row["path"] = "prepared" if prepared else "raw"
        row["ms"] = row[row["path"]]["ms"]
        row["graph_ms"] = row[row["path"]]["graph_ms"]
        if prepared:
            row["body"] = kernel.body(table)
        result[name] = row

    result["alloc_us"] = alloc_us(dev)

    rs = np.random.RandomState(0)
    fig4 = []
    for m in cs.FIG4_TABLES:
        lookup, nets, _ = cs._make_lpm(m, rs, dev)
        hot = nets[:cs.FIG4_HOT] | 1
        hot_keys = hot.reshape(-1, 1)

        def as_batch(a):
            return torch.as_tensor(np.asarray(a).reshape(-1, 1)
                                   .astype(np.int32), device=dev)

        fp = make_fastpath(lookup, FastPathTable.from_arrays(
            hot_keys, lookup(as_batch(hot_keys)).cpu().numpy()),
            key_dtype=torch.int64, value_dtype=torch.int64)
        batch = as_batch(rs.choice(hot, cs.ROUTER_BATCH))
        if not torch.equal(fp(batch), lookup(batch)):
            sys.exit(f"fastpath_ab: fig4 M={m}: fast path != generic")
        fig4.append({"M": m,
                     "fastpath_ms": cs.cuda_time_ms(lambda: fp(batch), 200,
                                                    20),
                     "generic_ms": cs.cuda_time_ms(lambda: lookup(batch),
                                                   200, 20)})
    result["fig4"] = fig4
    return result


def alloc_us(dev) -> dict:
    """Host microseconds to allocate a router batch's outputs, out (8192,
    1) int32 and hit (8192,) bool: one allocation cut by views, or two
    allocations; median of three rounds of 20000 each, in turns."""
    import timeit

    import torch

    b = 8192
    x = torch.zeros((b, 1), dtype=torch.int32, device=dev)

    def one():
        buf = x.new_empty((b + b // 4,), dtype=torch.int32)
        return (buf.as_strided((b, 1), (1, 1)),
                buf.view(torch.uint8).as_strided((b,), (1,), 4 * b)
                .view(torch.bool))

    def two():
        return (x.new_empty((b, 1), dtype=torch.int32),
                x.new_empty((b,), dtype=torch.bool))

    times = {"one_allocation_and_views": [], "two_allocations": []}
    for _ in range(3):
        for name, fn in (("one_allocation_and_views", one),
                         ("two_allocations", two)):
            times[name].append(timeit.timeit(fn, number=20000) / 20000 * 1e6)
    return {k: statistics.median(v) for k, v in times.items()}


def turns(other: Path, out: Path | None) -> None:
    order = [other, ROOT, ROOT, other]
    results = []
    for tree in order:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--tree",
             str(tree)], capture_output=True, text=True)
        if proc.returncode:
            sys.exit(f"fastpath_ab: the run of {tree} failed "
                     f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))

    def median(tree, get):
        return statistics.median(get(r) for r in results
                                 if r["tree"] == str(tree))

    summary = {}
    for label, tree in (("other", other), ("this", ROOT)):
        summary[label] = {
            "tree": str(tree),
            "k5_router_ms": median(tree, lambda r: r["k5_router"]["ms"]),
            "k5_router_graph_ms": median(
                tree, lambda r: r["k5_router"]["graph_ms"]),
            "k5_4096_ms": median(tree, lambda r: r["k5_4096"]["ms"]),
            "k5_4096_graph_ms": median(
                tree, lambda r: r["k5_4096"]["graph_ms"]),
            "alloc_us": results[order.index(tree)]["alloc_us"],
            "fig4_fastpath_ms": {
                str(m): median(tree, lambda r, m=m: next(
                    f["fastpath_ms"] for f in r["fig4"] if f["M"] == m))
                for m in (f["M"] for f in results[0]["fig4"])},
        }
    print(json.dumps({"summary": summary, "card": results[0]["card"]}),
          flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"turns": results, "summary": summary},
                                  indent=1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout to measure (default: this one)")
    ap.add_argument("--turns", type=Path, default=None,
                    help="another checkout: run it and this one in turns")
    ap.add_argument("--out", type=Path, default=None,
                    help="with --turns: write every turn's result here")
    args = ap.parse_args()
    if args.turns is not None:
        turns(args.turns.resolve(), args.out)
    else:
        print(json.dumps(measure(args.tree.resolve())), flush=True)


if __name__ == "__main__":
    main()
