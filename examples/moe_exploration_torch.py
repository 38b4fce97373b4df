"""MoE dispatch exploration on the PyTorch port: the online policy discovers
which dispatch implementation (einsum vs gather, cumsum vs sort ranking)
trains fastest on this device, measured for real.  Runs on the card
unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/moe_exploration_torch.py [--device cpu]

Reduced kimi-k2 with 16 experts, top 4, in fp32; an ``ExhaustiveSweep``
over ``moe_impl`` {einsum, gather} x ``moe_ranking`` {cumsum, sort}, each
held for ``--dwell`` train steps of one fixed (8, 64) batch.  The loop
reads the loss once a step (a wait for the device), so each candidate's
rate is its own steps'.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import compat, configs  # noqa: E402
from repro_torch.core import (Controller, ExhaustiveSweep,  # noqa: E402
                              IridescentRuntime, cartesian)
from repro_torch.models import transformer as model  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402
from repro_torch.training import make_train_builder  # noqa: E402

LABELS = ("moe_impl", "moe_ranking")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=110)
    ap.add_argument("--dwell", type=int, default=15)
    args = ap.parse_args(argv)
    dev = compat.resolve_device(args.device)

    cfg = configs.get_reduced("kimi-k2-1t-a32b").replace(
        compute_dtype="float32", n_experts=16, top_k=4)
    opt_cfg = OptConfig(lr=1e-3, total_steps=1000)
    rt = IridescentRuntime()
    handler = rt.register("train_step", make_train_builder(cfg, opt_cfg),
                          donate_argnums=0)

    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    rs = np.random.RandomState(0)
    toks = torch.from_numpy(
        rs.randint(0, cfg.vocab_size, (8, 65)).astype(np.int32)).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    state, _ = handler(state, batch)

    candidates = cartesian(
        [{"moe_impl": i} for i in ("einsum", "gather")],
        [{"moe_ranking": r} for r in ("cumsum", "sort")],
    )
    controller = Controller(handler, ExhaustiveSweep(candidates),
                            dwell=args.dwell)
    print("exploring MoE dispatch implementations...")
    losses = []
    for _ in range(args.steps):
        state, metrics = handler(state, batch)
        losses.append(float(metrics["loss"]))    # waits for the device
        controller.step()
    rates = []
    for phase, cfg_, metric in controller.history:
        sel = {k: v for k, v in (cfg_ or {}).items() if k in LABELS}
        rates.append((phase.value, sel, metric))
        print(f"  {phase.value:8s} {sel}  tput={metric:8.1f} steps/s")
    selected = {k: v for k, v in handler.active_config().items()
                if k in LABELS}
    print(f"selected: {selected}")
    settled = controller.settled()
    rt.shutdown()
    return {"selected": selected, "settled": settled, "rates": rates,
            "losses": losses}


if __name__ == "__main__":
    main()
