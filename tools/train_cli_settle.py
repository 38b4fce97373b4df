#!/usr/bin/env python3
"""At which steps the training CLI's Controller settles and re-explores,
and whether a second run on the same ``--ckpt`` restores a tuned config.

Run from the root of a checkout (on the card, or with ``--device cpu``):

    python3 tools/train_cli_settle.py --runs 3 --steps 80 100 -- \\
        --size 100m --explore --dwell 3 --ckpt-every 40

Each run starts from an empty checkpoint directory under
``build/train_cli_settle`` and calls ``python -m repro_torch.launch.train``
once per ``--steps`` value, in its own process, with the arguments after
``--``.  The CLI's Controller is wrapped to report the CLI step at which
it settles (``settle``) and at which its change detector starts a new
exploration (``change``, with the rate read and the baseline).  The CLI
saves the tuned config only at a checkpoint step on which the Controller
is settled, which is what these steps decide.  Prints one JSON line per
CLI call.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: the CLI under a Controller whose transitions print the step reached
WRAPPED_CLI = r'''
import sys
from repro_torch.core import controller as C
steps = [0]
_step = C.Controller.step
def step(self):
    steps[0] += 1
    return _step(self)
_begin_exploit = C.Controller._begin_exploit
def begin_exploit(self, ctl, best, metric):
    print(f"SETTLE {steps[0]}", flush=True)
    return _begin_exploit(self, ctl, best, metric)
_on_change = C.Controller._on_change
def on_change(self, ctl, rate, prev):
    print(f"CHANGE {steps[0]} {rate} {prev}", flush=True)
    return _on_change(self, ctl, rate, prev)
C.Controller.step = step
C.Controller._begin_exploit = begin_exploit
C.Controller._on_change = on_change
from repro_torch.launch import train
train.main(sys.argv[1:])
'''


def cli_call(steps: int, ckpt: Path, cli_args: list[str]) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", WRAPPED_CLI, *cli_args, "--steps", str(steps),
         "--ckpt", str(ckpt)], capture_output=True, text=True, env=env,
        cwd=ROOT)
    rec = {"steps": steps, "rc": out.returncode,
           "s": time.perf_counter() - t0, "settle": [], "change": [],
           "resumed": None, "restored_config": False}
    for line in out.stdout.splitlines():
        word, *rest = line.split() or [""]
        if word == "SETTLE":
            rec["settle"].append(int(rest[0]))
        elif word == "CHANGE":
            rec["change"].append([int(rest[0]), float(rest[1]),
                                  None if rest[2] == "None"
                                  else float(rest[2])])
        elif line.startswith("resumed from step "):
            rec["resumed"] = int(line.split()[-1])
        elif line.startswith("restored tuned config: {"):
            rec["restored_config"] = True
    if out.returncode:
        rec["stderr"] = out.stderr[-2000:]
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--steps", type=int, nargs="+", default=[80, 100])
    ap.add_argument("cli_args", nargs=argparse.REMAINDER,
                    help="after --: the CLI's arguments")
    args = ap.parse_args(argv)
    cli_args = [a for a in args.cli_args if a != "--"]
    ckpt = ROOT / "build" / "train_cli_settle"
    rc = 0
    for run in range(args.runs):
        shutil.rmtree(ckpt, ignore_errors=True)
        for steps in args.steps:
            rec = cli_call(steps, ckpt, cli_args)
            print(json.dumps({"run": run, **rec}), flush=True)
            rc = rc or rec["rc"]
    shutil.rmtree(ckpt, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
