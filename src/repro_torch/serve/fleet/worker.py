"""Fleet replica worker: one ServeEngine behind a line-JSON stdio protocol.

Run as a subprocess by the router front (``launch/serve.py --replicas N``)::

    python -m repro_torch.serve.fleet.worker --profile synthetic --replica-id 1
    python -m repro_torch.serve.fleet.worker --profile synthetic --device cpu

Protocol (newline-delimited JSON):

* stdin  (front -> worker): ``{"type": "req", "prompt_tokens": ...,
  "max_new_tokens": ..., "deadline_s": ...}`` submits one request;
  ``{"type": "close"}`` stops admission — the worker drains in-flight
  work, publishes its settled winners to the spec plane, and exits.
* stdout (worker -> front): ``{"type": "ready"}`` once the engine is
  built; ``{"type": "depth", "waiting": ..., "in_flight": ...}``
  periodically (the join-shortest-queue router's signal); with
  ``--telemetry``, ``{"type": "events", "replica": ..., "events":
  [...]}`` batches of flight-recorder events (the front absorbs them
  onto its own bus tagged with the replica id, so consumers see one
  merged stream); one final ``{"type": "stats", ...}`` with the metrics
  snapshot (:meth:`~repro_torch.serve.metrics.ServeMetrics.state` —
  mergeable by the front), compile stats, time-to-settled, and — in the
  port — the kernel libraries the worker loaded (whether each was built
  by ``nvcc`` in it) and its RMSNorm kernel launches.

Two profiles: ``synthetic`` (the benchmark's fused-vs-split matmul
handler, a plain ``torch.matmul`` as in the reference, where it is
computed outside Pallas — cheap, deterministic winner) and ``lm`` (the
full LM serving stack of :mod:`repro_torch.launch.serve`:
phase-disaggregated execution over paged KV, bucket and KV-geometry
tuners).  Both run on ``--device`` (default ``cuda``); a worker without
the device it was given raises, it never falls back to the host.

With ``--plane-dir`` the worker participates in the shared
specialization plane: it polls before serving (warm start — remotely
settled contexts begin in EXPLOIT) and on an interval while serving, and
publishes its own settled winners on the same interval and at shutdown.
With a shared ``--cache-dir`` the variant cache is opened *portable*
(device-count-free fingerprints), so a seeded config activates from
the kernel libraries another replica built instead of calling ``nvcc``.

:class:`SubprocessReplica` is the front half: it spawns the worker,
feeds its stdin, and tracks the depth reports — satisfying the
``submit``/``depth`` replica contract of
:class:`~repro_torch.serve.fleet.router.ReplicaRouter`.
"""
from __future__ import annotations

import argparse
import collections
import json
import logging
import os
import subprocess
import sys
import threading
import time

logger = logging.getLogger("repro_torch.serve.fleet.worker")

__all__ = ["SubprocessReplica", "worker_command", "main"]

_DEPTH_INTERVAL_S = 0.025


# -- front side ------------------------------------------------------------------

def worker_command(*args: str) -> list[str]:
    """Subprocess invocation for this module with extra CLI args."""
    return [sys.executable, "-m", "repro_torch.serve.fleet.worker", *args]


def worker_env() -> dict:
    """Environment for a worker subprocess: the parent's, with this
    package's source root on PYTHONPATH (the front may run from a repo
    checkout that is not installed)."""
    import repro_torch
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env = dict(os.environ)
    existing = env.get("PYTHONPATH")
    env["PYTHONPATH"] = (src if not existing
                         else src + os.pathsep + existing)
    return env


class SubprocessReplica:
    """Router-facing handle on one worker subprocess.

    ``submit`` returns True when the request was written to the worker
    (remote queue backpressure is the worker's business — its shed
    counters come back in the final stats); ``depth`` is the last
    reported waiting + in-flight.
    """

    def __init__(self, cmd: list[str], name: str, env: dict | None = None):
        self.name = str(name)
        self.stats: dict | None = None
        self._depth = 0
        self._ready = threading.Event()
        self._said_ready = False
        self._wlock = threading.Lock()
        self.proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env=env if env is not None else worker_env(),
            text=True, bufsize=1)
        self._reader = threading.Thread(target=self._read_stdout,
                                        name=f"replica-{name}-reader",
                                        daemon=True)
        self._reader.start()

    def _read_stdout(self) -> None:
        for line in self.proc.stdout:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except ValueError:
                continue                  # stray print from a library
            kind = msg.get("type")
            if kind == "ready":
                self._said_ready = True
                self._ready.set()
            elif kind == "depth":
                self._depth = int(msg.get("waiting", 0)) + \
                    int(msg.get("in_flight", 0))
            elif kind == "events":
                # Forwarded flight-recorder batch: merge onto the front's
                # bus (if enabled) tagged with the replica id.
                from repro_torch.core import telemetry
                _tb = telemetry.bus()
                if _tb is not None:
                    _tb.absorb(msg.get("events", ()),
                               replica=str(msg.get("replica", self.name)))
            elif kind == "stats":
                self.stats = msg
        self._ready.set()                 # EOF: never leave waiters hanging

    def wait_ready(self, timeout_s: float = 120.0) -> bool:
        # the reader also wakes waiters at EOF, when the worker exited
        # before it said ready (it may not be reaped yet: poll() alone
        # could still see it running)
        ok = self._ready.wait(timeout_s)
        return ok and self._said_ready and self.proc.poll() is None

    def _write(self, msg: dict) -> bool:
        with self._wlock:
            if self.proc.stdin is None or self.proc.poll() is not None:
                return False
            try:
                self.proc.stdin.write(json.dumps(msg) + "\n")
                self.proc.stdin.flush()
                return True
            except (OSError, ValueError):
                return False

    def submit(self, request) -> bool:
        return self._write({
            "type": "req",
            "prompt_tokens": request.prompt_tokens,
            "max_new_tokens": request.max_new_tokens,
            "deadline_s": request.deadline_s,
        })

    def depth(self) -> int:
        return self._depth

    def close(self) -> None:
        self._write({"type": "close"})
        with self._wlock:
            if self.proc.stdin is not None:
                try:
                    self.proc.stdin.close()
                except OSError:
                    pass

    def join(self, timeout_s: float = 120.0) -> dict | None:
        """Wait for exit; returns the final stats message (None if the
        worker died without one)."""
        try:
            self.proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10.0)
        self._reader.join(5.0)
        return self.stats


# -- worker side -----------------------------------------------------------------

def _synthetic_stack(args):
    """The benchmark's cheap serve stack: one contextual handler (fused
    vs split matmul), single-bucket batcher (exactly one specialization
    context — deterministic warm-start accounting), exhaustive 2-arm
    sweep.  The product is a plain ``torch.matmul`` on the worker's
    device, as the reference computes it outside Pallas."""
    import torch

    from repro_torch import compat
    from repro_torch.core import (ChangeDetector, Controller, ExhaustiveSweep,
                                  IridescentRuntime, VariantCache)
    from repro_torch.serve import (AdmissionQueue, ContinuousBatcher,
                                   ServeEngine, ServeMetrics,
                                   ShortestJobFirst)

    device = compat.resolve_device(args.device)

    def builder(spec):
        fused = spec.enum("fused", False, (False, True), guarded=False)

        def f(x, w):
            if fused:
                return x @ w
            h = w.shape[1] // 2
            return torch.cat([x @ w[:, :h], x @ w[:, h:]], dim=-1)

        return f

    cache = (VariantCache(os.path.join(args.cache_dir, "variants"),
                          portable=True) if args.cache_dir else None)
    rt = IridescentRuntime(async_compile=True, max_compile_workers=2,
                           variant_cache=cache)
    handler = rt.register("fleet_step", builder,
                          context_fn=lambda a, k: int(a[0].shape[0]))
    d = args.d
    w = torch.zeros((d, d), dtype=torch.float32, device=device)

    class Exec:
        def execute(self, batch):
            x = torch.zeros((batch.size, d), dtype=torch.float32,
                            device=device)
            handler(x, w)
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    controller = Controller(
        handler,
        lambda: ExhaustiveSweep([{"fused": True}, {"fused": False}]),
        dwell=args.dwell, change_detector=lambda: ChangeDetector(float("inf")),
        wait_compiles=False, prefetch=0)
    slo_s = args.slo_ms / 1e3
    metrics = ServeMetrics(slo_s=slo_s)
    engine = ServeEngine(
        handler, controller,
        ContinuousBatcher(args.max_batch, scheme="single"),
        ShortestJobFirst(), executor=Exec(), queue=AdmissionQueue(),
        metrics=metrics, slo_s=slo_s)
    return rt, engine, [("fleet_step", controller)]


def _lm_stack(args):
    """The full LM serving stack, shared with ``launch/serve.py``."""
    from repro_torch.launch.serve import build_engine
    built = build_engine(args)
    return built.rt, built.engine, [("serve_step", built.controller)]


def _emit(msg: dict) -> None:
    sys.stdout.write(json.dumps(msg) + "\n")
    sys.stdout.flush()


def main(argv=None) -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--profile", default="synthetic",
                     choices=("synthetic", "lm"))
    ns, _ = pre.parse_known_args(argv)
    ap = argparse.ArgumentParser(description=__doc__, parents=[pre])
    ap.add_argument("--replica-id", default="0")
    ap.add_argument("--plane-dir", default=None,
                    help="shared SpecPlane directory (publish + subscribe)")
    ap.add_argument("--plane-poll-s", type=float, default=0.25)
    ap.add_argument("--plane-gc-s", type=float, default=0.0,
                    help="reclaim plane records older than this (superseded"
                         " epochs, retired contexts); 0 disables")
    ap.add_argument("--max-wall-s", type=float, default=300.0,
                    help="hard serve-loop wall cap (CI hang guard)")
    ap.add_argument("--telemetry", action="store_true",
                    help="enable the flight-recorder bus and forward its "
                         "events to the front over stdout")
    if ns.profile == "lm":
        # the launch driver's flag set (--arch, --batch, --dwell,
        # --cache-dir, --slo-ms, ... — shared via add_engine_args)
        from repro_torch.launch.serve import add_engine_args
        add_engine_args(ap)
    else:
        ap.add_argument("--device", default=None,
                        help="torch device (default: cuda; pass cpu to "
                             "run on the host)")
        ap.add_argument("--d", type=int, default=256)
        ap.add_argument("--max-batch", type=int, default=8)
        ap.add_argument("--cache-dir", default=None)
        ap.add_argument("--dwell", type=int, default=6)
        ap.add_argument("--slo-ms", type=float, default=5000.0)
    args = ap.parse_args(argv)

    from repro_torch.serve import Request
    from repro_torch.serve.fleet.plane import SpecPlane

    # Flight recorder: a bounded sink buffer the serve loop flushes to the
    # front as line-JSON ``events`` batches.  Drop-not-block end to end —
    # the deque overwrites its oldest entries if the loop falls behind.
    fwd: collections.deque | None = None
    if args.telemetry:
        from repro_torch.core import telemetry
        telemetry.enable().add_sink(
            (fwd := collections.deque(maxlen=4096)).append)

    def flush_events() -> None:
        if not fwd:
            return
        batch = []
        while fwd:
            try:
                batch.append(fwd.popleft())
            except IndexError:            # racy emit during flush
                break
        if batch:
            _emit({"type": "events", "replica": args.replica_id,
                   "events": batch})

    rt, engine, publishable = (_synthetic_stack(args)
                               if args.profile == "synthetic"
                               else _lm_stack(args))
    # Share the controller's quarantine registry with the plane so local
    # rollbacks propagate fleet-wide and remote ones are absorbed here.
    quarantine = next((ctl.quarantine for _, ctl in publishable
                       if getattr(ctl, "quarantine", None) is not None),
                      None)
    plane = (SpecPlane(args.plane_dir, replica=args.replica_id,
                       quarantine=quarantine)
             if args.plane_dir else None)
    if plane is not None:
        # Warm start: remotely settled winners seed the handlers *before*
        # traffic, so the Controller admits those contexts in EXPLOIT.
        plane.poll(rt)

    closed = threading.Event()
    first_req_t: list[float] = []         # set once by the stdin thread

    def read_stdin():
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            if msg.get("type") == "req":
                if not first_req_t:
                    first_req_t.append(time.perf_counter())
                engine.submit(Request(
                    prompt_tokens=int(msg.get("prompt_tokens", 0)),
                    max_new_tokens=int(msg.get("max_new_tokens", 1)),
                    deadline_s=msg.get("deadline_s")))
            elif msg.get("type") == "close":
                break
        closed.set()

    threading.Thread(target=read_stdin, name="stdin-reader",
                     daemon=True).start()
    _emit({"type": "ready", "replica": args.replica_id})

    t0 = time.perf_counter()
    steps = 0
    settled_t: float | None = None
    last_depth = last_plane = t0
    controllers = [ctl for _, ctl in publishable]
    while True:
        now = time.perf_counter()
        if now - t0 > args.max_wall_s:
            logger.warning("worker %s: wall cap %.0fs hit; draining",
                           args.replica_id, args.max_wall_s)
            break
        produced = engine.step()
        steps += 1
        if settled_t is None and first_req_t \
                and all(c.contexts() for c in controllers) \
                and all(c.settled() for c in controllers):
            # Time from first traffic to every controller settled: the
            # warm-start headline number (a seeded replica settles on its
            # first dwell; a cold one pays the full sweep).
            settled_t = time.perf_counter() - first_req_t[0]
        if now - last_depth >= _DEPTH_INTERVAL_S:
            _emit({"type": "depth", "waiting": len(engine.queue),
                   "in_flight": len(engine.active)})
            flush_events()
            last_depth = now
        if plane is not None and now - last_plane >= args.plane_poll_s:
            plane.poll(rt)
            for name, ctl in publishable:
                plane.publish_controller(name, ctl)
            if args.plane_gc_s > 0:
                from repro_torch.core.runtime import encode_context_key
                active = {(name, encode_context_key(k))
                          for name, ctl in publishable
                          for k in ctl.contexts()}
                plane.gc(args.plane_gc_s, active=active)
            last_plane = now
        if closed.is_set() and not engine.active and not len(engine.queue):
            break
        if produced == 0 and not engine.active:
            time.sleep(0.001)
    engine.drain(timeout_s=30.0)
    wall = time.perf_counter() - t0
    if plane is not None:
        for name, ctl in publishable:
            plane.publish_controller(name, ctl)

    flush_events()                        # final batch before stats
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm import kernel as rmsnorm_kernel
    stats = engine.stats()
    settled = {name: {str(k): {kk: repr(vv) for kk, vv in cfg.items()}
                      for k, (cfg, _) in ctl.settled_winners().items()}
               for name, ctl in publishable}
    _emit({
        "type": "stats",
        "replica": args.replica_id,
        "wall_s": round(wall, 4),
        "steps": steps,
        "time_to_settled_s": (round(settled_t, 4)
                              if settled_t is not None else None),
        "metrics": engine.metrics.state(),
        "queue": stats["queue"],
        "compile": rt.compile_stats(),
        "settled": settled,
        "libraries": {name: {"built": info["built"],
                             "seconds": round(info["seconds"], 4)}
                      for name, info in build.build_logs().items()},
        "rmsnorm_launches": rmsnorm_kernel.launches,
    })
    engine.shutdown(state_dir=None)


if __name__ == "__main__":
    main()
