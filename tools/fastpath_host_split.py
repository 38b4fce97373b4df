#!/usr/bin/env python3
"""Split the host time of one prepared fast-path matcher call (K5) into
its Python part and its C part (packing aside: the library's entry and
the kernel launch), on one CUDA card.

    python3 tools/fastpath_host_split.py TREE     # a checkout's root

TREE's own package (``TREE/src/repro_torch``) is imported, so two
checkouts are compared by running this in turns, one process each (for
example parent, change, change, parent).  The call is the router's: 8192
int32 queries against a prepared table of 16 int32 keys with int32
values, on the hashed body.  Each number is the median of five rounds of
20000 back-to-back calls, host clock, the stream synchronised at each
round's ends: the whole call; the call with the library's entry replaced
by a stub (Python only); and the library's entry alone on a packed
argument the wrapper built (C and launch).  Prints one JSON line.  Needs
a CUDA card.
"""
import json
import sys
import time


def per_call_us(fn, sync, n: int = 20000, rounds: int = 5) -> float:
    out = []
    for _ in range(rounds):
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        out.append(1e6 * (time.perf_counter() - t0) / n)
    return sorted(out)[len(out) // 2]


def main(tree: str) -> None:
    sys.path[:0] = [tree + "/src"]
    import torch

    from repro_torch import compat
    from repro_torch.kernels.fastpath import kernel

    if not torch.cuda.is_available():
        sys.exit("fastpath_host_split: no CUDA device")
    compat.resolve_device("cuda")
    kernel.load_library()
    dev = torch.device("cuda", 0)
    keys = (torch.arange(16, dtype=torch.int32, device=dev)[:, None]
            * 7).contiguous()
    x = keys[torch.randint(0, 16, (8192,), device=dev)].contiguous()
    vals = torch.ones((16, 1), dtype=torch.int32, device=dev)
    table = kernel.prepare_table(keys, vals)

    def run():
        return kernel.fastpath_cuda_prepared(x, table)

    sync = torch.cuda.synchronize
    for _ in range(2000):
        run()
    full = per_call_us(run, sync)
    real = kernel._fwd
    packed = []
    kernel._fwd = lambda b: (packed.append(b), real(b))[1]
    run()
    kernel._fwd = lambda b: 0
    python = per_call_us(run, sync)
    kernel._fwd = real
    c_launch = per_call_us(lambda: real(packed[0]), sync)
    print(json.dumps({"tree": tree, "full_us": full, "python_us": python,
                      "c_launch_us": c_launch,
                      "packed_bytes": len(packed[0])}))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
