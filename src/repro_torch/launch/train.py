"""End-to-end training driver of the port, with online specialization.

Run:
    PYTHONPATH=src python -m repro_torch.launch.train --steps 120 --explore
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 24 --explore --dwell 2

The port of ``repro.launch.train``, flag for flag, plus ``--device``
(default ``cuda``; without a CUDA device it raises unless ``--device cpu``
is given).  The *fixed code* of the paper's architecture (Fig 1): it owns
the processing loop, the data pipeline, checkpointing and the
specialization policy; the train step is the Iridescent handler it
obtains from the runtime.

Exercised: online exploration of ``remat`` x ``microbatch`` x
``logits_dtype`` x ``rmsnorm_impl`` guided by measured steps/s (a train
step offers only gradient-safe implementations, so ``rmsnorm_impl`` has
the one candidate ``torch_ref``); builds off the critical path;
checkpoint/restart (resume with the same command: the data stream and
the optimizer state restore exactly, and the tuned configuration with
them); degradation detection through the ``ChangeDetector``.

The loop reads the loss once a step, which waits for the device.  The
Controller's rate is calls per second of the handler: without that wait
it would measure how fast the host enqueues work, and a candidate's
queued work would run inside the next candidate's dwell.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import compat, configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import (DEFAULT_CONTEXT, ChangeDetector, Controller,
                              CoordinateDescent, IridescentRuntime)
from repro_torch.data import SyntheticLM
from repro_torch.models import ModelConfig
from repro_torch.models import transformer as model
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.training import make_train_builder

#: the points the CLI's Controller explores (the reference's)
EXPLORE_LABELS = ["remat", "microbatch", "logits_dtype", "rmsnorm_impl"]


def small_lm(scale: str) -> ModelConfig:
    """The CLI's small dense LMs.  ``100m`` overrides the base vocab (the
    reference passes ``vocab_size`` twice there and raises ``TypeError``;
    the port merges the size into the base)."""
    base = dict(family="dense", n_kv_heads=2, vocab_size=8192,
                compute_dtype="float32")
    sizes = {
        "2m": dict(n_layers=4, d_model=128, n_heads=4, d_ff=512),
        "25m": dict(n_layers=8, d_model=384, n_heads=6, d_ff=1536),
        "100m": dict(n_layers=12, d_model=640, n_heads=10, d_ff=2560,
                     vocab_size=16384),
    }
    return ModelConfig(name=f"lm-{scale}", **{**base, **sizes[scale]})


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: cuda; pass "
                         "cpu to run on the host)")
    ap.add_argument("--arch", default=None,
                    help="assigned arch id (reduced config); default: small LM")
    ap.add_argument("--size", default="2m", choices=("2m", "25m", "100m"))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--explore", action="store_true",
                    help="enable online specialization search")
    ap.add_argument("--dwell", type=int, default=5)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compress", default="none", choices=("none", "int8_ef"))
    ap.add_argument("--compile-workers", type=int, default=2,
                    help="CompileService worker threads")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="speculative builds ahead of the policy")
    ap.add_argument("--budget", type=float, default=None,
                    help="skip candidates whose expected build cost "
                         "exceeds BUDGET x the expected dwell time")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    device = compat.resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch).replace(compute_dtype="float32")
           if args.arch else small_lm(args.size))
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps,
                        compress=args.compress)
    print(f"model={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"tokens/step={args.batch * args.seq} device={device}")

    mgr = CheckpointManager(args.ckpt, keep=3) if args.ckpt else None
    # The checkpoint directory doubles as the persistent variant cache: a
    # resumed run reloads its kernel libraries instead of rebuilding them.
    rt = IridescentRuntime(async_compile=True,
                           max_compile_workers=args.compile_workers,
                           variant_cache=mgr.variant_cache() if mgr else None)
    # the state is donated, as the reference's CLI donates it: the step
    # updates params and optimizer state in place
    handler = rt.register("train_step", make_train_builder(cfg, opt_cfg),
                          donate_argnums=0)

    params = model.init_params(
        torch.Generator(device=device).manual_seed(0), cfg)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    start_step = 0
    initial_configs = None
    if mgr and mgr.latest_step() is not None:
        state, meta = mgr.restore(state)
        start_step = meta["step"]
        print(f"resumed from step {start_step}")
        if mgr.restore_spec_state(rt, wait=True):
            tuned = handler.active_config()
            if tuned:
                initial_configs = {DEFAULT_CONTEXT: tuned}
                print(f"restored tuned config: {tuned}")

    ds = SyntheticLM(cfg.vocab_size, args.batch, args.seq, seed=1,
                     start_step=start_step, device=device)
    it = iter(ds)

    controller = None
    if args.explore:
        space = handler.spec_space()
        controller = Controller(
            handler,
            lambda: CoordinateDescent(space, labels=EXPLORE_LABELS,
                                      max_passes=1),
            dwell=args.dwell, change_detector=lambda: ChangeDetector(0.3),
            wait_compiles=False, prefetch=args.prefetch, budget=args.budget,
            initial_configs=initial_configs)

    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = next(it)
        state, metrics = handler(state, batch)
        loss = float(metrics["loss"])      # waits for the device: see above
        if controller is not None:
            controller.step()
        if (step + 1) % 10 == 0 or step == start_step:
            dt = time.perf_counter() - t0
            print(f"step {step + 1:4d} loss={loss:.4f} "
                  f"tok/s={(step + 1 - start_step) * args.batch * args.seq / dt:,.0f} "
                  f"config={handler.active_config()}")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state)   # async, off the critical path
            # Persist the tuned configs only once the controller has
            # settled: saving a mid-sweep candidate would make the next
            # warm restart exploit an arbitrary (possibly worst) config.
            if controller is None or controller.settled():
                mgr.save_spec_state(rt)
    if mgr:
        mgr.wait()
        if controller is None or controller.settled():
            mgr.save_spec_state(rt)
    print(f"done. variants compiled: {len(handler.variants())}; "
          f"guard misses: {handler.guard_misses}")
    print(f"compile stats: {rt.compile_stats()}")
    if controller is not None:
        best, metric = controller.best()
        print(f"best config: {best} ({metric:.2f} steps/s)")
    rt.shutdown()


if __name__ == "__main__":
    main()
