"""Quickstart on the PyTorch port: the paper's Fig 2 MMulBlockBench in ~40
lines of user code.

Handler code declares the spec points; fixed code (``main``) runs the
processing loop and the exploration policy.  Runs on the card unless
``--device cpu`` is given:

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core import Controller, ExhaustiveSweep, IridescentRuntime, guards


# ---- handler code (paper Fig 2a) ---------------------------------------------
def build_matmul(spec):
    # spec_enum("B", ...): internal tuning parameter, any value is correct.
    b = spec.enum("B", 8, (4, 8, 16, 32, 64))
    # spec_generic("N", ...): workload assumption -> guarded.
    n = spec.generic("N", None, guard=guards.shape_equals(0, 0))

    def matmul(x, y):
        size = n if n is not None else x.shape[0]
        nb = size // b
        xb = x.reshape(nb, b, nb, b).permute(0, 2, 1, 3)
        yb = y.reshape(nb, b, nb, b).permute(0, 2, 1, 3)
        out = torch.einsum("ikab,kjbc->ijac", xb, yb)
        return out.permute(0, 2, 1, 3).reshape(size, size)

    return matmul


# ---- fixed code (paper Fig 2b) -------------------------------------------------
def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = compat.resolve_device(args.device)

    rt = IridescentRuntime()
    matmul = rt.register("matmul", build_matmul)

    rs = np.random.RandomState(0)
    n = 256
    x = torch.from_numpy(rs.randn(n, n).astype(np.float32)).to(dev)
    y = torch.from_numpy(rs.randn(n, n).astype(np.float32)).to(dev)
    matmul(x, y)   # generic version serves immediately

    controller = Controller(
        matmul,
        ExhaustiveSweep.from_space(matmul.spec_space(), labels=["B"]),
        dwell=30)

    print("exploring block sizes online...")
    for i in range(200):
        matmul(x, y)          # the server keeps serving during exploration
        controller.step()
    for phase, cfg, metric in controller.history:
        print(f"  {phase.value:8s} config={cfg}  tput={metric:9.1f}/s")
    selected = matmul.active_config()
    print(f"selected: {selected}")
    settled = controller.settled()

    # guard in action: a different N falls back to the generic variant
    x2 = torch.ones((128, 128), device=dev)
    eye = torch.eye(128, device=dev)
    matmul.specialize({"B": 16, "N": 256}, wait=True)
    out = matmul(x2, eye)
    print(f"guard misses (fell back to generic, still correct): "
          f"{matmul.guard_misses}")
    torch.testing.assert_close(out, x2 @ eye, rtol=1e-5, atol=1e-5)
    rt.shutdown()
    return {"selected": selected, "settled": settled,
            "guard_misses": matmul.guard_misses, "history": controller.history}


if __name__ == "__main__":
    main()
