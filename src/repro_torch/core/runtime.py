"""The Iridescent specialization runtime (paper §4.4).

Components, mapped from the paper:

* **JIT** — a variant is the builder's closure with its configuration's
  constants baked in (:func:`~repro_torch.core.specializer.specialize_builder`);
  PyTorch runs it eagerly, so nothing is traced.  "Compiling" a variant
  means building and loading every kernel library its configuration names
  (each spec point with a ``prepare`` hook, e.g. the kernel registry's
  implementation points), **off the critical path** (paper §6.4) on the
  :class:`~repro_torch.core.compile_service.CompileService`: a
  priority-queued, deduplicating, cancellable multi-worker build pipeline.
  Policies may *speculatively* enqueue upcoming candidates so dwell windows
  overlap compilation instead of serializing with it.
* **Trampoline** — :class:`Handler` is a stable callable the fixed code
  obtains once (``runtime.handler(name)``).  Dispatch state — the active
  variant, the generic fallback, and the pre-bound guard check — lives in
  one immutable :class:`_Snapshot` swapped atomically by reference, so the
  per-call fast path takes **no locks**: one attribute read, one optional
  lock-free counter bump, then the compiled executable.  Guard checks are
  skipped entirely for guardless variants.
* **Specialization contexts** — the paper specializes to "the hardware and
  workload conditions at a given time"; a serve loop that mixes workload
  classes (decode batch 1 vs 64) must not thrash one global specialization
  between them.  ``register(name, builder, context_fn=...)`` takes a
  workload classifier ``context_fn(args, kwargs) -> hashable``; the handler
  keeps an immutable map ``context_key -> _Snapshot`` (swapped atomically by
  reference, like the snapshot itself), so each workload class dispatches to
  *its own* active variant with its own stats, guard-miss counters, and
  argument specs.  Without ``context_fn`` everything targets the single
  default context and dispatch is exactly the PR 2 lock-free fast path.
* **Guards** — before dispatching to a specialized variant the trampoline
  evaluates the variant's pre-bound guard closure against the actual
  arguments; on failure it transparently re-routes to the generic variant
  (the paper's exception-unwind path, minus the exception: a guard runs
  before the variant, so there are no side effects to roll back).
* **Variant cache** — built variants are cached by configuration in
  memory.  The persistent on-disk cache is not ported yet (ROADMAP M3).
* **Errors** — an exception inside a variant propagates to the caller, and
  a failed build (a kernel library that does not compile) is raised by the
  next call routed to that context.
"""
from __future__ import annotations

import concurrent.futures
import logging
import threading
import time
from typing import Any, Callable, Iterable, Mapping, Sequence

from repro_torch import compat
from repro_torch.core import instrumentation as instr_mod
from repro_torch.core import telemetry
from repro_torch.core.compile_service import (CompileService,
                                              PRIORITY_ACTIVATE,
                                              PRIORITY_SPECULATIVE)
from repro_torch.core.metrics import (AtomicCounter, ThroughputCounter,
                                      ThroughputWindow)
from repro_torch.core.points import DISABLED, Config, SpecSpace, config_key
from repro_torch.core.specializer import Specialized, specialize_builder

logger = logging.getLogger("repro_torch.core.runtime")

__all__ = ["IridescentRuntime", "Handler", "Variant", "ContextView",
           "DEFAULT_CONTEXT", "encode_context_key", "decode_context_key"]

#: Context key used when no ``context_fn`` is given (and the target of the
#: legacy, context-less policy API: ``rt.specialize(cfg)`` etc.).
DEFAULT_CONTEXT = "default"


def _canonical_key(key: Any) -> Any:
    """Normalize a context key into the JSON-encodable canonical form.

    Tuples become tagged lists (so they survive JSON and decode back to
    tuples — the serve engine's ``(phase, bucket)`` keys must round-trip
    losslessly); numpy scalars collapse to their Python value so
    ``("prefill", np.int32(4))`` and ``("prefill", 4)`` encode identically.
    Anything non-encodable falls back to a tagged ``repr`` (deterministic,
    matched by string equality, not invertible — same contract the old
    repr-based encoder had for exotic keys).
    """
    if isinstance(key, tuple):
        return {"t": [_canonical_key(k) for k in key]}
    if isinstance(key, _OpaqueKey):
        return {"r": str(key)}
    if isinstance(key, bool) or key is None or isinstance(key, str):
        return key
    if isinstance(key, (int, float)):
        return key
    item = getattr(key, "item", None)
    if item is not None and getattr(key, "shape", None) == ():
        try:
            return _canonical_key(item())
        except Exception:
            pass
    return {"r": repr(key)}


class _OpaqueKey(str):
    """Decoded stand-in for a key that only persisted as a repr string.

    Re-encoding it reproduces the tagged-repr form, so
    ``encode(decode(enc)) == enc`` holds for opaque entries too (the
    normalization `restore_spec_state` relies on)."""

    __slots__ = ()


def _uncanonical_key(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "t" in obj and len(obj) == 1:
            return tuple(_uncanonical_key(x) for x in obj["t"])
        if "r" in obj and len(obj) == 1:
            return _OpaqueKey(obj["r"])
    if isinstance(obj, list):           # defensive (hand-edited files)
        return tuple(_uncanonical_key(x) for x in obj)
    return obj


def encode_context_key(key: Any) -> str:
    """Stable, **invertible** string encoding of a context key for
    persistence (``spec_state.json``).  Flat hashables and tuples of them
    (e.g. the serve engine's ``(phase, bucket)`` keys) round-trip through
    :func:`decode_context_key` losslessly; exotic keys degrade to a
    deterministic repr tag matched by string equality only."""
    import json as _json
    return _json.dumps(_canonical_key(key), sort_keys=True,
                       separators=(",", ":"))


def decode_context_key(encoded: str) -> Any:
    """Inverse of :func:`encode_context_key`.

    Also tolerates the legacy repr-based encoding (pre-tuple-key format):
    ``"'default'"`` / ``"4"`` / ``"('prefill', 4)"`` decode via a literal
    parse, so old ``spec_state.json`` files keep restoring.  A string that
    parses under neither scheme is returned as-is (opaque key)."""
    import ast as _ast
    import json as _json
    try:
        return _uncanonical_key(_json.loads(encoded))
    except (ValueError, TypeError):
        pass
    try:
        return _ast.literal_eval(encoded)
    except (ValueError, SyntaxError):
        # Legacy repr of an exotic key: keep it opaque so re-encoding
        # lands on the tagged-repr form a live key of that repr produces.
        return _OpaqueKey(encoded)


def _arg_spec(x: Any) -> Any:
    """Tensors -> ``(shape, dtype, device)`` records; others as-is."""
    if hasattr(x, "shape") and hasattr(x, "dtype") and hasattr(x, "device"):
        return (tuple(x.shape), x.dtype, x.device)
    return x


class Variant:
    """One specialized version of a handler: the builder's closure for one
    configuration, plus whether the kernels it names are built."""

    __slots__ = ("specialized", "compiled", "compile_time_s",
                 "build_time_s", "_calls", "_guard_misses")

    def __init__(self, specialized: Specialized):
        self.specialized = specialized
        self.compiled = False          # every named kernel built and loaded
        self.compile_time_s: float | None = None
        self.build_time_s: float | None = None
        self._calls = AtomicCounter()
        self._guard_misses = AtomicCounter()

    @property
    def config(self) -> dict:
        return self.specialized.config

    @property
    def calls(self) -> int:
        return self._calls.value()

    @property
    def guard_misses(self) -> int:
        return self._guard_misses.value()

    def call(self, *args, **kwargs):
        self._calls.bump()
        return self.specialized.fn(*args, **kwargs)


class _Snapshot:
    """Immutable dispatch state, swapped atomically by reference.

    Everything ``Handler.__call__`` needs is resolved once, here, at swap
    time: the active variant, the generic fallback, the pre-bound composite
    guard (``None`` for guardless variants), whether host-side sampling is
    on, and — when none of the slow-path features apply — the bound
    ``variant.call`` to jump straight to.  ``ready=False`` (argument specs
    not captured yet) forces the slow path by leaving ``fast`` unset.

    ``canary`` is the second dispatch slot: a candidate variant admitted to
    a slice of live traffic (every ``canary_period``-th call) before full
    activation.  ``tap`` marks that a shadow-evaluation tap wants to see
    live call arguments.  ``error`` is a failed build to raise at the next
    call.  Each forces the slow path.
    """

    __slots__ = ("variant", "generic", "guard_fn", "sample", "fast",
                 "canary", "canary_guard", "canary_period", "tap", "error")

    def __init__(self, variant: Variant, generic: Variant,
                 instr_rate: float, ready: bool = True,
                 canary: Variant | None = None, canary_period: int = 0,
                 tap: bool = False, error: BaseException | None = None):
        self.variant = variant
        self.generic = generic
        self.guard_fn = (variant.specialized.guard_fn
                         if variant is not generic else None)
        self.sample = instr_rate > 0.0
        self.canary = canary
        self.canary_guard = (canary.specialized.guard_fn
                             if canary is not None and canary is not generic
                             else None)
        self.canary_period = max(1, int(canary_period)) if canary else 0
        self.tap = tap
        self.error = error
        self.fast = (variant.call
                     if ready and self.guard_fn is None and not self.sample
                     and canary is None and not tap and error is None
                     and not variant.specialized.instrumented else None)


class _Context:
    """Per-context dispatch state: one workload class's variants, active
    selection, argument specs, and stats.  Mutated only under the handler
    lock; the published ``snapshot`` is immutable and swapped by reference
    so dispatch stays lock-free."""

    __slots__ = ("key", "variants", "active_key", "generic_key", "arg_specs",
                 "need_arg_specs", "epoch", "snapshot", "tput",
                 "guard_misses", "window", "instr_rate", "canary_key",
                 "canary_period", "canary_epoch", "canary_ticker",
                 "canary_calls", "build_error")

    def __init__(self, key: Any, tput: ThroughputCounter):
        self.key = key
        self.variants: dict[tuple, Variant] = {}
        self.active_key: tuple | None = None
        self.generic_key: tuple = (key, config_key({}), False)
        self.arg_specs: tuple | None = None    # (arg specs, kwarg specs)
        self.need_arg_specs = True
        self.epoch = 0                         # supersedes stale activations
        self.snapshot: _Snapshot | None = None
        self.tput = tput
        self.guard_misses = AtomicCounter()
        #: per-context throughput observations (filled by the Controller)
        self.window = ThroughputWindow()
        #: host-side sampling rate while this context is instrumented
        self.instr_rate = 0.0
        #: canary slot: candidate variant serving 1/canary_period of calls
        self.canary_key: tuple | None = None
        self.canary_period = 0
        self.canary_epoch = 0                  # supersedes stale canary builds
        self.canary_ticker = AtomicCounter()
        self.canary_calls = AtomicCounter()
        #: a failed build, raised by the next call routed here
        self.build_error: BaseException | None = None


class ContextView:
    """Handler-like facade bound to one specialization context.

    The :class:`~repro.core.controller.Controller` drives one explore loop
    per context through this surface; it mirrors the subset of the
    :class:`Handler` API that is context-scoped.
    """

    __slots__ = ("handler", "key", "_ctx")

    def __init__(self, handler: "Handler", key: Any, ctx: _Context):
        self.handler = handler
        self.key = key
        self._ctx = ctx

    @property
    def tput(self) -> ThroughputCounter:
        return self._ctx.tput

    @property
    def window(self) -> ThroughputWindow:
        return self._ctx.window

    @property
    def guard_misses(self) -> int:
        return self._ctx.guard_misses.value()

    def specialize(self, config: Config, wait: bool = False,
                   instrument: bool = False) -> None:
        self.handler.specialize(config, wait=wait, instrument=instrument,
                                context=self.key)

    def prefetch(self, configs: Iterable[Config]) -> int:
        return self.handler.prefetch(configs, context=self.key)

    def despecialize(self, wait: bool = True) -> None:
        self.handler.despecialize(wait=wait, context=self.key)

    def active_config(self) -> dict:
        return self.handler.active_config(context=self.key)

    # -- safe exploration (see the Handler methods for semantics) ---------------
    def build(self, config: Config, wait: bool = False):
        return self.handler.build(config, context=self.key, wait=wait)

    def shadow_call(self, config: Config, args: tuple = (),
                    kwargs: dict | None = None):
        return self.handler.shadow_call(config, args, kwargs,
                                        context=self.key)

    def set_canary(self, config: Config, fraction: float,
                   wait: bool = False) -> None:
        self.handler.set_canary(config, fraction, context=self.key, wait=wait)

    def clear_canary(self) -> None:
        self.handler.clear_canary(context=self.key)

    def canary_config(self) -> dict | None:
        return self.handler.canary_config(context=self.key)

    def canary_calls(self) -> int:
        return self.handler.canary_calls(context=self.key)

    def promote_canary(self, wait: bool = False) -> dict | None:
        return self.handler.promote_canary(context=self.key, wait=wait)

    def revert_to(self, config: Config, wait: bool = True) -> None:
        self.handler.revert_to(config, context=self.key, wait=wait)

    def enable_instrumentation(self, rate: float = 1.0,
                               collectors: Mapping[str, Callable] | None = None,
                               wait: bool = True) -> None:
        """Instrument *this* context only (closes the ROADMAP item: other
        contexts keep their uninstrumented fast path)."""
        self.handler.enable_instrumentation(rate=rate, collectors=collectors,
                                            wait=wait, context=self.key)

    def disable_instrumentation(self) -> None:
        self.handler.disable_instrumentation(context=self.key)

    def has_variant(self, config: Config) -> bool:
        """Whether a variant for ``config`` is already built in this
        context (specializing to it costs no fresh compile)."""
        key = (self._ctx.key, config_key(config), False)
        with self.handler._lock:
            return key in self._ctx.variants

    def spec_space(self) -> SpecSpace:
        return self.handler.spec_space()

    def calls(self) -> int:
        """Lifetime dispatch count for this context."""
        return self._ctx.tput.total()

    def __repr__(self) -> str:
        return f"ContextView({self.handler.name!r}, {self.key!r})"


def _done_future(value: Any) -> concurrent.futures.Future:
    fut: concurrent.futures.Future = concurrent.futures.Future()
    fut.set_result(value)
    return fut


class Handler:
    """The trampoline (paper §4.4.2): a fixed, stable callable.

    "The JIT creates a trampoline function which calls the most recent
    specialized version of the function. The trampoline function is stored at
    a fixed address and does not change across runtime updates."

    With a ``context_fn`` the trampoline routes each call to the snapshot of
    its workload class (``context_fn(args, kwargs) -> hashable``); each
    context holds its own variants, active config, argument specs, and
    stats.  Without one, all calls hit the single default context and the
    dispatch fast path is unchanged from the context-less design.
    """

    def __init__(
        self,
        name: str,
        builder: Callable,
        runtime: "IridescentRuntime",
        context_fn: Callable[[tuple, dict], Any] | None = None,
    ):
        self.name = name
        self.builder = builder
        self.runtime = runtime
        self._context_fn = context_fn
        self._lock = threading.Lock()
        self._create_lock = threading.Lock()   # context materialization only
        self._contexts: dict[Any, _Context] = {}
        self._ctx_map: dict[Any, _Context] = {}  # immutable copy, swapped
        self._seeded: dict[str, dict] = {}       # encoded key -> config
        self.space: SpecSpace = SpecSpace()
        self.tput = ThroughputCounter()
        self.count_calls = True                # bump tput on every dispatch
        self.recorders = instr_mod.RecorderSet()
        self._instr_rate = 0.0
        self._guard_miss_counter = AtomicCounter()
        #: shadow-evaluation tap: fn(ctx_key, args, kwargs), called on the
        #: slow path so an evaluator can mirror live arguments off-path
        self._shadow_tap: Callable[[Any, tuple, dict], None] | None = None
        # Mirrors of the default context's dispatch state (the contextless
        # fast path reads these; tests assert on them).
        self._snapshot: _Snapshot | None = None
        self._need_arg_specs = True
        # Build the default context (and its generic variant) eagerly so
        # dispatch always has a fallback.
        self._default = self._materialize_context(DEFAULT_CONTEXT)

    @property
    def guard_misses(self) -> int:
        """Host-side guard misses across all contexts (lock-free counter)."""
        return self._guard_miss_counter.value()

    # -- contexts ---------------------------------------------------------------
    def contexts(self) -> list:
        """Keys of every materialized context."""
        return list(self._ctx_map)

    def context(self, key: Any = None) -> ContextView:
        """A :class:`ContextView` bound to ``key`` (default context when
        ``None``), materializing its state if needed."""
        key = DEFAULT_CONTEXT if key is None else key
        return ContextView(self, key, self._ctx(key))

    def seed_spec_state(self, encoded_key: str, config: Config) -> None:
        """Stage a restored configuration for a context that may not exist
        yet; it is applied (best-effort) when the context first
        materializes.  Already-materialized contexts are specialized now."""
        self._seeded[encoded_key] = dict(config)
        for key, _ in list(self._ctx_map.items()):
            if encode_context_key(key) == encoded_key:
                self._apply_seed(key)

    def seeded_config(self, key: Any) -> dict | None:
        """The restored configuration staged for ``key``, if any."""
        cfg = self._seeded.get(encode_context_key(key))
        return dict(cfg) if cfg is not None else None

    def _apply_seed(self, key: Any) -> None:
        cfg = self._seeded.get(encode_context_key(key))
        if cfg is None:
            return
        try:
            self.specialize(cfg, wait=False, context=key)
        except Exception as e:
            # Same best-effort contract as restore_spec_state: a stale
            # config must degrade to generic, never break dispatch.
            logger.warning("seeded spec state for %r context %r no longer "
                           "valid (%s: %s); keeping generic", self.name, key,
                           type(e).__name__, e)

    def _reject_unhashable(self, key: Any) -> None:
        raise TypeError(
            f"context keys must be hashable; context_fn for handler "
            f"{self.name!r} returned {key!r}") from None

    def _materialize_context(self, key: Any) -> _Context:
        with self._create_lock:
            try:
                ctx = self._ctx_map.get(key)
            except TypeError:
                self._reject_unhashable(key)
            if ctx is not None:
                return ctx
            # The contextless handler's default context shares the handler
            # counter (single-bump fast path).  A contextual handler's
            # default context keeps its own: handler.tput aggregates all
            # contexts there, so sharing would credit every call to
            # "default" (and e.g. make controllers explore an idle context).
            tput = (self.tput
                    if key == DEFAULT_CONTEXT and self._context_fn is None
                    else ThroughputCounter())
            ctx = _Context(key, tput)
            # Build the generic variant synchronously: the very first call
            # routed to a new context must have something to dispatch to.
            self._install(ctx, {}, wait=True, activate=True)
            with self._lock:
                self._contexts[key] = ctx
                self._ctx_map = dict(self._contexts)
        self._apply_seed(key)
        return ctx

    def _ctx(self, context: Any) -> _Context:
        key = DEFAULT_CONTEXT if context is None else context
        try:
            ctx = self._ctx_map.get(key)
        except TypeError:
            self._reject_unhashable(key)
        return ctx if ctx is not None else self._materialize_context(key)

    # -- construction of variants ---------------------------------------------
    def _build_variant(self, config: Config, instrument: bool) -> Variant:
        t0 = time.perf_counter()
        spec = specialize_builder(
            self.builder,
            config,
            custom_generators=self.runtime.custom_generators,
            instrument=instrument,
            guards_enabled=self.runtime.guards_enabled,
        )
        self.space = spec.space if len(spec.space) >= len(self.space) else self.space
        variant = Variant(specialized=spec)
        variant.build_time_s = time.perf_counter() - t0
        return variant

    def _compile_variant(self, variant: Variant) -> None:
        """Build and load every kernel library the variant's configuration
        names: each spec point with a ``prepare`` hook gets the variant's
        value for it (its default where the config leaves it out, as the
        builder resolved it).  Shapes do not matter, so this runs at build
        time.  A build failure raises."""
        if variant.compiled:
            return
        t0 = time.perf_counter()
        spec = variant.specialized
        for label, point in spec.space.points.items():
            prepare = getattr(point, "prepare", None)
            if prepare is not None:
                value = spec.config.get(label, DISABLED)
                prepare(point.default if value is DISABLED else value)
        variant.compiled = True
        variant.compile_time_s = time.perf_counter() - t0
        self.runtime.compile_service.note_compile(
            variant.compile_time_s, cache_hit=False,
            build_s=variant.build_time_s)

    # -- snapshot publication ---------------------------------------------------
    def _rebuild_snapshot_locked(self, ctx: _Context) -> None:
        variant = ctx.variants[ctx.active_key]
        generic = ctx.variants[ctx.generic_key]
        canary = (ctx.variants.get(ctx.canary_key)
                  if ctx.canary_key is not None else None)
        if canary is variant:
            canary = None                      # promoting made it the active
        ctx.snapshot = _Snapshot(variant, generic, ctx.instr_rate,
                                 ready=not ctx.need_arg_specs,
                                 canary=canary,
                                 canary_period=ctx.canary_period,
                                 tap=self._shadow_tap is not None,
                                 error=ctx.build_error)
        if ctx.key == DEFAULT_CONTEXT:
            # Mirror for the contextless fast path (and legacy callers).
            self._snapshot = ctx.snapshot
            self._need_arg_specs = ctx.need_arg_specs

    def _publish(self, ctx: _Context, key: tuple, epoch: int | None) -> None:
        """Atomically swap the context's dispatch snapshot — unless a newer
        activation (or despecialize) has superseded this one."""
        with self._lock:
            if epoch is not None and epoch != ctx.epoch:
                return
            if key not in ctx.variants:
                return
            ctx.active_key = key
            self._rebuild_snapshot_locked(ctx)
            cfg = dict(ctx.variants[key].config)
        _tb = telemetry.bus()
        if _tb is not None:
            _tb.emit("dispatch.activate", track=ctx.key, handler=self.name,
                     config=repr(cfg), generic=key == ctx.generic_key)

    def _next_epoch(self, ctx: _Context) -> int:
        with self._lock:
            ctx.epoch += 1
            return ctx.epoch

    # -- install / compile pipeline ---------------------------------------------
    def _install(self, ctx: _Context, config: Config, wait: bool,
                 activate: bool, instrument: bool = False,
                 speculative: bool = False) -> concurrent.futures.Future:
        key = (ctx.key, config_key(config), bool(instrument))
        epoch = self._next_epoch(ctx) if activate else None
        with self._lock:
            existing = ctx.variants.get(key)
        svc = self.runtime.compile_service
        if activate:
            # The policy has moved past any still-queued activation for a
            # different config *in this context*: cancel before a worker
            # wastes a compile.
            svc.cancel_pending(self.name, keep_keys={key},
                               max_priority=PRIORITY_ACTIVATE,
                               key_filter=lambda k: k[0] == ctx.key)
        if existing is not None:
            if activate:
                self._publish(ctx, key, epoch)
            return _done_future(existing)

        def build() -> Variant:
            variant = self._build_variant(config, instrument)
            self._compile_variant(variant)
            with self._lock:
                variant = ctx.variants.setdefault(key, variant)
            return variant

        req = svc.submit(
            self.name, key, dict(config), build,
            priority=(PRIORITY_ACTIVATE if activate
                      else PRIORITY_SPECULATIVE),
            speculative=speculative)
        fut = req.future

        def _on_done(f: concurrent.futures.Future) -> None:
            if f.cancelled():
                return
            err = f.exception()
            if err is not None:
                # Nobody may be waiting on this future: park the failure
                # on the context so its next call raises it.
                logger.error("build of %s %s failed: %s: %s", self.name,
                             dict(config), type(err).__name__, err)
                with self._lock:
                    ctx.build_error = err
                    if ctx.snapshot is not None:
                        self._rebuild_snapshot_locked(ctx)
                return
            if activate:
                self._publish(ctx, key, epoch)
        fut.add_done_callback(_on_done)
        if wait and not fut.cancelled():
            try:
                fut.result()
            except concurrent.futures.CancelledError:
                pass
            else:
                if activate:
                    # Worker-side done-callbacks may still be in flight;
                    # publishing here (idempotent) guarantees the swap is
                    # visible when a wait=True caller returns.
                    self._publish(ctx, key, epoch)
        return fut

    # -- paper policy API ------------------------------------------------------
    def specialize(self, config: Config, wait: bool = False,
                   instrument: bool = False, context: Any = None) -> None:
        """Select a specialization configuration (paper ``rt.specialize(c)``).

        Compilation happens off the critical path; the trampoline keeps
        dispatching to the previous variant until the new one is ready.
        ``context`` selects the workload class to specialize (``None`` =
        the default context, preserving the context-less API).
        """
        self.space.validate({k: v for k, v in config.items() if k in self.space})
        ctx = self._ctx(context)
        self._install(ctx, config, wait=wait, activate=True,
                      instrument=instrument)

    def prefetch(self, configs: Iterable[Config],
                 context: Any = None) -> int:
        """Speculatively enqueue builds for upcoming candidates (paper §6.4:
        overlap dwell windows with compilation).  Pending speculative builds
        in this context for configs *not* in the new set are cancelled — the
        policy has moved past them.  Returns the number of builds enqueued."""
        ctx = self._ctx(context)
        keep_keys: set = set()
        enqueued = 0
        for cfg in configs:
            try:
                self.space.validate(
                    {k: v for k, v in cfg.items() if k in self.space})
            except (KeyError, ValueError):
                continue
            key = (ctx.key, config_key(cfg), False)
            keep_keys.add(key)
            with self._lock:
                if key in ctx.variants:
                    continue
            fut = self._install(ctx, cfg, wait=False, activate=False,
                                speculative=True)
            if not fut.cancelled():      # sync runtimes skip speculation
                enqueued += 1
        self.runtime.compile_service.cancel_pending(
            self.name, keep_keys=keep_keys, speculative_only=True,
            key_filter=lambda k: k[0] == ctx.key)
        return enqueued

    def despecialize(self, wait: bool = True, context: Any = ...) -> None:
        """Return to the generic variant.

        ``context`` selects one workload class; the default (no argument)
        despecializes **every** context.  Pending (not yet started) builds
        for the targeted context(s) are cancelled and any in-flight
        activation is superseded, so a compile finishing later can no longer
        overwrite the generic swap.  With ``wait=True`` this additionally
        blocks until in-flight builds for this handler have drained — on
        return, no background compile work remains for it.
        """
        if context is ...:
            targets = list(self._ctx_map.values())
        else:
            targets = [self._ctx(context)]
        keys = {ctx.key for ctx in targets}
        self.runtime.compile_service.cancel_pending(
            self.name, key_filter=lambda k: k[0] in keys)
        for ctx in targets:
            epoch = self._next_epoch(ctx)
            self._publish(ctx, ctx.generic_key, epoch)
        if wait:
            self.runtime.compile_service.drain(self.name)

    # -- safe exploration surface (shadow + canary + rollback) -------------------
    def build(self, config: Config, context: Any = None,
              wait: bool = False) -> concurrent.futures.Future:
        """Build a variant for ``config`` *without* activating it.

        Unlike :meth:`prefetch` the request is non-speculative, so a
        synchronous runtime (``workers=0``) builds it inline instead of
        skipping it — shadow evaluation needs the variant to exist even
        when there is no compile pipeline to overlap with.
        """
        self.space.validate({k: v for k, v in config.items() if k in self.space})
        ctx = self._ctx(context)
        fut = self._install(ctx, config, wait=False, activate=False)
        if wait and not fut.cancelled():
            try:
                fut.result()
            except concurrent.futures.CancelledError:
                pass
        return fut

    def shadow_call(self, config: Config, args: tuple = (),
                    kwargs: dict | None = None, context: Any = None):
        """Invoke the built variant for ``config`` directly, bypassing the
        dispatch snapshot: no activation, no tput accounting, no guards.
        This is how a shadow evaluator re-executes mirrored live calls
        against a candidate off the hot path.  Raises ``LookupError`` if the
        variant has not been built yet (see :meth:`build`)."""
        ctx = self._ctx(context)
        key = (ctx.key, config_key(config), False)
        with self._lock:
            variant = ctx.variants.get(key)
        if variant is None:
            raise LookupError(
                f"no built variant for {dict(config)!r} in context "
                f"{ctx.key!r} of handler {self.name!r}")
        return variant.call(*args, **(kwargs or {}))

    def set_shadow_tap(self,
                       fn: Callable[[Any, tuple, dict], None] | None) -> None:
        """Install (or, with ``None``, remove) the shadow tap: every live
        call takes the slow path and ``fn(ctx_key, args, kwargs)`` sees its
        arguments before dispatch, so an evaluator can mirror real traffic.
        Costs the fast path while installed; remove it when not shadowing."""
        with self._lock:
            self._shadow_tap = fn
            for ctx in self._contexts.values():
                if ctx.snapshot is not None:
                    self._rebuild_snapshot_locked(ctx)

    def clear_shadow_tap(self) -> None:
        self.set_shadow_tap(None)

    def set_canary(self, config: Config, fraction: float,
                   context: Any = None, wait: bool = False) -> None:
        """Admit ``config`` to a slice of live traffic (the second dispatch
        slot): every ``round(1/fraction)``-th call in this context routes to
        the candidate variant while the incumbent keeps serving the rest.
        The build happens off-path; the canary starts serving only once the
        variant exists.  A newer ``set_canary``/``clear_canary`` supersedes
        an in-flight one."""
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"canary fraction must be in (0, 1]: {fraction}")
        self.space.validate({k: v for k, v in config.items() if k in self.space})
        ctx = self._ctx(context)
        key = (ctx.key, config_key(config), False)
        period = max(1, round(1.0 / fraction))
        with self._lock:
            ctx.canary_epoch += 1
            token = ctx.canary_epoch
            ctx.canary_period = period
        fut = self._install(ctx, config, wait=False, activate=False)

        def _arm(f: concurrent.futures.Future) -> None:
            if f.cancelled() or f.exception() is not None:
                return
            with self._lock:
                if ctx.canary_epoch != token:
                    return                     # superseded while building
                ctx.canary_key = key
                self._rebuild_snapshot_locked(ctx)

        fut.add_done_callback(_arm)
        if wait and not fut.cancelled():
            try:
                fut.result()
            except concurrent.futures.CancelledError:
                pass

    def clear_canary(self, context: Any = None) -> None:
        """Withdraw the canary slot; the incumbent serves all traffic again."""
        ctx = self._ctx(context)
        with self._lock:
            ctx.canary_epoch += 1
            if ctx.canary_key is None:
                return
            ctx.canary_key = None
            ctx.canary_period = 0
            self._rebuild_snapshot_locked(ctx)

    def canary_config(self, context: Any = None) -> dict | None:
        """The config currently holding the canary slot, or ``None``."""
        ctx = self._ctx(context)
        with self._lock:
            if ctx.canary_key is None:
                return None
            variant = ctx.variants.get(ctx.canary_key)
            return dict(variant.config) if variant is not None else None

    def canary_calls(self, context: Any = None) -> int:
        """Live calls served by canary variants in this context (lifetime)."""
        return self._ctx(context).canary_calls.value()

    def promote_canary(self, context: Any = None,
                       wait: bool = False) -> dict | None:
        """Promote the canary to full activation: one atomic swap makes the
        candidate the active variant and empties the canary slot.  Returns
        the promoted config, or ``None`` if no canary was armed."""
        ctx = self._ctx(context)
        with self._lock:
            variant = (ctx.variants.get(ctx.canary_key)
                       if ctx.canary_key is not None else None)
            ctx.canary_epoch += 1
            ctx.canary_key = None
            ctx.canary_period = 0
            if variant is None:
                if ctx.snapshot is not None and ctx.snapshot.canary is not None:
                    self._rebuild_snapshot_locked(ctx)
                return None
            cfg = dict(variant.config)
        # The variant exists, so this publishes (and clears the slot in the
        # same snapshot swap) without any compile.
        self._install(ctx, cfg, wait=wait, activate=True)
        return cfg

    def revert_to(self, config: Config, context: Any = None,
                  wait: bool = True) -> None:
        """Atomically revert the context to ``config`` (the auto-rollback
        path): the canary slot is emptied, still-queued builds for this
        context are cancelled, any in-flight activation is superseded by a
        fresh epoch, and — since a last-known-good config's variant is
        already built — the swap itself is a synchronous publish."""
        self.space.validate({k: v for k, v in config.items() if k in self.space})
        ctx = self._ctx(context)
        with self._lock:
            ctx.canary_epoch += 1
            ctx.canary_key = None
            ctx.canary_period = 0
        self.runtime.compile_service.cancel_pending(
            self.name, key_filter=lambda k: k[0] == ctx.key)
        _tb = telemetry.bus()
        if _tb is not None:
            _tb.emit("dispatch.revert", track=ctx.key, handler=self.name,
                     config=repr(dict(config)))
        self._install(ctx, config, wait=wait, activate=True)

    def enable_instrumentation(self, rate: float = 1.0,
                               collectors: Mapping[str, Callable] | None = None,
                               wait: bool = True, context: Any = None) -> None:
        """Switch to the instrumented variant of the current config.

        ``rate`` is the sampling rate for *host-side* collectors
        (paper §6.4 / Fig 11).  ``collectors`` maps label ->
        ``fn(args, kwargs) -> value`` recorded into ``spec_space().observed``
        (collectors are handler-wide; sampling is gated per context).
        ``context`` selects the workload class to instrument — only that
        context pays the instrumentation cost; every other context keeps
        its lock-free fast path.  ``None`` targets the default context,
        preserving the context-less API.
        """
        for label, fn in (collectors or {}).items():
            self.recorders.add_host(label, fn, rate)
        ctx = self._ctx(context)
        if ctx.key == DEFAULT_CONTEXT:
            self._instr_rate = float(rate)       # legacy mirror
        with self._lock:
            ctx.instr_rate = float(rate)
            cfg = dict(ctx.snapshot.variant.config)
            self._rebuild_snapshot_locked(ctx)   # sampling starts immediately
        self._install(ctx, cfg, wait=wait, activate=True, instrument=True)

    def disable_instrumentation(self, context: Any = None) -> None:
        ctx = self._ctx(context)
        if ctx.key == DEFAULT_CONTEXT:
            self._instr_rate = 0.0
        with self._lock:
            ctx.instr_rate = 0.0
            active = ctx.snapshot.variant
            self._rebuild_snapshot_locked(ctx)
        if active.specialized.instrumented:
            self._install(ctx, active.config, wait=True, activate=True,
                          instrument=False)

    def spec_space(self) -> SpecSpace:
        """The handler's specialization space, including instrumentation data
        (paper: "The policy retrieves this information included in the result
        of the spec_space call")."""
        self.space.observed = self.recorders.summary()
        return self.space

    # -- stats -----------------------------------------------------------------
    def active_config(self, context: Any = None) -> dict:
        key = DEFAULT_CONTEXT if context is None else context
        ctx = self._ctx_map.get(key)
        if ctx is None or ctx.snapshot is None:
            return {}
        return dict(ctx.snapshot.variant.config)

    def spec_state(self) -> dict:
        """Active configuration per context, keyed by encoded context key
        (what ``spec_state.json`` persists).

        Restored-but-not-yet-materialized contexts (seeds whose traffic has
        not arrived this run) are carried through, so a save never drops a
        tuned config that a previous run already paid to find.
        """
        out = {enc: dict(cfg) for enc, cfg in self._seeded.items()}
        for key in self._ctx_map:
            enc = encode_context_key(key)
            cfg = self.active_config(context=key)
            # An empty active config on a seeded context usually means the
            # seeded specialize has not landed yet (async compile): the
            # seed is the better record to persist.
            if cfg or enc not in out:
                out[enc] = cfg
        return out

    def variants(self) -> list[Variant]:
        with self._lock:
            return [v for ctx in self._contexts.values()
                    for v in ctx.variants.values()]

    def stats(self) -> dict:
        with self._lock:
            ctxs = list(self._contexts.values())
            vs = [(k, v) for ctx in ctxs for k, v in ctx.variants.items()]
            per_context = {}
            for ctx in ctxs:
                active = (ctx.variants.get(ctx.active_key)
                          if ctx.active_key is not None else None)
                canary = (ctx.variants.get(ctx.canary_key)
                          if ctx.canary_key is not None else None)
                per_context[encode_context_key(ctx.key)] = {
                    "variants": len(ctx.variants),
                    "calls": ctx.tput.total(),
                    "guard_misses": ctx.guard_misses.value(),
                    "active": (dict(active.config)
                               if active is not None else None),
                    "canary": (dict(canary.config)
                               if canary is not None else None),
                    "canary_calls": ctx.canary_calls.value(),
                    "tput_window": ctx.window.summary(),
                }
            default = self._contexts.get(DEFAULT_CONTEXT)
            active = (default.variants.get(default.active_key)
                      if default is not None and default.active_key is not None
                      else None)
        return {
            "variants": len(vs),
            "contexts": per_context,
            "guard_misses": self.guard_misses,
            "active": dict(active.config) if active is not None else None,
            "compiled": sum(1 for _, v in vs if v.compiled),
            "compile_times_s": {
                str(dict(k[1])): v.compile_time_s for k, v in vs
                if v.compile_time_s is not None
            },
        }

    # -- argument-spec capture (once per context, then the flag stays down) ------
    def _capture_arg_specs(self, ctx: _Context, args: tuple,
                           kwargs: dict) -> None:
        with self._lock:
            if not ctx.need_arg_specs:
                return
            ctx.arg_specs = (compat.tree_map(_arg_spec, args),
                             compat.tree_map(_arg_spec, kwargs))
            ctx.need_arg_specs = False
            self._rebuild_snapshot_locked(ctx)

    # -- the trampoline itself ---------------------------------------------------
    def __call__(self, *args, **kwargs):
        # Lock-free fast path: one snapshot reference read (plus, for
        # contextual handlers, the workload classification and one dict
        # probe on the immutable context map); guardless, uninstrumented
        # variants dispatch straight to the compiled executable.  All
        # remaining bookkeeping is either lock-free (AtomicCounter bumps)
        # or disabled.
        ctx_fn = self._context_fn
        if ctx_fn is None:
            snap = self._snapshot
            if snap.fast is not None:
                if self.count_calls:
                    self.tput.add()
                return snap.fast(*args, **kwargs)
            return self._call_slow(self._default, snap, args, kwargs)
        key = ctx_fn(args, kwargs)
        try:
            ctx = self._ctx_map.get(key)
        except TypeError:
            self._reject_unhashable(key)
        if ctx is None:
            ctx = self._materialize_context(key)
        snap = ctx.snapshot
        if snap.fast is not None:
            if self.count_calls:
                self.tput.add()
            if ctx.tput is not self.tput:
                ctx.tput.add()
            return snap.fast(*args, **kwargs)
        return self._call_slow(ctx, snap, args, kwargs)

    def _call_slow(self, ctx: _Context, snap: _Snapshot, args: tuple,
                   kwargs: dict):
        if snap.error is not None:
            raise RuntimeError(
                f"a variant build for handler {self.name!r} context "
                f"{ctx.key!r} failed") from snap.error
        if ctx.need_arg_specs:
            # Record the (shape, dtype, device) of the first call's
            # arguments, once per context.
            self._capture_arg_specs(ctx, args, kwargs)
            snap = ctx.snapshot
        if snap.tap:
            tap = self._shadow_tap
            if tap is not None:
                try:
                    tap(ctx.key, args, kwargs)
                except Exception:       # never let evaluation break dispatch
                    logger.exception("shadow tap failed for %r", self.name)
        variant = snap.variant
        guard_fn = snap.guard_fn
        # Canary slot: route every canary_period-th call to the candidate
        # variant (lock-free ticket; deterministic 1/period traffic slice).
        if snap.canary is not None and \
                ctx.canary_ticker.bump() % snap.canary_period == 0:
            variant = snap.canary
            guard_fn = snap.canary_guard
            ctx.canary_calls.bump()
            _tb = telemetry.bus()
            if _tb is not None:
                _tb.emit("dispatch.canary_call", track=ctx.key,
                         handler=self.name, config=repr(dict(variant.config)))
        # Host-side specialization guards (paper §4.4.3): on miss, fall back
        # to the generic variant for this invocation.
        if guard_fn is not None and not guard_fn(args, kwargs):
            variant._guard_misses.bump()
            ctx.guard_misses.bump()
            self._guard_miss_counter.bump()
            _tb = telemetry.bus()
            if _tb is not None:
                _tb.emit("dispatch.guard_miss", track=ctx.key,
                         handler=self.name, config=repr(dict(variant.config)))
            variant = snap.generic
        # Host-side instrumentation sampling.
        if snap.sample:
            self.recorders.maybe_record(args, kwargs)
        out = variant.call(*args, **kwargs)
        # In-graph instrumentation taps come back as (out, taps).
        if variant.specialized.instrumented and variant.specialized.space and \
                isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict):
            out, taps = out
            self.recorders.absorb_taps(taps)
        if self.count_calls:
            self.tput.add()
        if ctx.tput is not self.tput:
            ctx.tput.add()
        return out


class IridescentRuntime:
    """Paper Table 2 policy API: the object the *fixed code* talks to."""

    def __init__(self, max_compile_workers: int = 2, async_compile: bool = True,
                 guards_enabled: bool = True, variant_cache: Any = None):
        if variant_cache is not None:
            raise NotImplementedError(
                "the persistent variant cache is not ported yet "
                "(ROADMAP M3: variant_cache)")
        self.handlers: dict[str, Handler] = {}
        self.custom_generators: dict[str, Callable] = {}
        self.guards_enabled = guards_enabled
        self.variant_cache = None
        self.compile_service = CompileService(
            workers=max_compile_workers if async_compile else 0)

    # -- registration ----------------------------------------------------------
    def register(self, name: str, builder: Callable,
                 context_fn: Callable[[tuple, dict], Any] | None = None
                 ) -> Handler:
        """Register handler code; analogous to loading ``handler_code.ll``.

        ``context_fn(args, kwargs) -> hashable`` classifies each call into a
        workload context; each context keeps its own active specialization
        (one dispatch snapshot per batch-shape class).  ``None`` = one
        global context (the default).
        """
        if name in self.handlers:
            raise ValueError(f"handler {name!r} already registered")
        h = Handler(name, builder, self, context_fn=context_fn)
        self.handlers[name] = h
        return h

    def handler(self, name: str) -> Handler:
        """``rt.handler(h)`` — obtain the stable trampoline."""
        return self.handlers[name]

    def add_custom_spec(self, name: str, generator: Callable) -> None:
        """``rt.add_custom_spec(n, gen)`` — register a custom code generator."""
        self.custom_generators[name] = generator

    # -- space & selection -------------------------------------------------------
    def spec_space(self, name: str | None = None) -> SpecSpace:
        if name is not None:
            return self.handlers[name].spec_space()
        merged = SpecSpace()
        observed: dict[str, Any] = {}
        for h in self.handlers.values():
            for p in h.spec_space().points.values():
                merged.register(p)
            observed.update(h.space.observed)
        merged.observed = observed
        return merged

    def specialize(self, config: Config, handler: str | None = None,
                   wait: bool = False, context: Any = None) -> None:
        """``rt.specialize(c)`` — apply a configuration.

        With ``handler=None`` the config is routed to every handler, each
        receiving the subset of points it declared.  ``context`` selects the
        workload context (default: the default context, so the legacy
        context-less call keeps working unchanged).
        """
        targets = ([self.handlers[handler]] if handler is not None
                   else list(self.handlers.values()))
        for h in targets:
            sub = {k: v for k, v in config.items() if k in h.spec_space()}
            h.specialize(sub, wait=wait, context=context)

    # -- persistence & telemetry -------------------------------------------------
    def spec_state(self) -> dict:
        """Active configuration per handler per context (encoded context key
        -> config; repr-serializable only when configs are; the launch
        drivers persist this next to checkpoints)."""
        return {name: h.spec_state() for name, h in self.handlers.items()}

    def compile_stats(self) -> dict:
        """Aggregate compile telemetry (the service's counters)."""
        return self.compile_service.stats()

    def shutdown(self) -> None:
        self.compile_service.shutdown(wait=True)
