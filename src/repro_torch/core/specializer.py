"""The specializer (paper §4.4.1): binds a configuration to a handler builder.

In the paper the specializer is an LLVM pass that rewrites handler IR,
replacing specialization-point annotations with constants / assumptions /
generated code.  In JAX the handler is a *builder*::

    def build(spec: SpecCtx) -> step_fn:
        bm = spec.enum("bm", default=128, choices=(64, 128, 256))
        packed = spec.assume("len_divisible", guard=lambda a, k, v: ...)
        ...
        def step_fn(...): ...
        return step_fn

Re-executing the builder with a bound :class:`SpecCtx` *is* the IR rewrite:
the chosen constants become Python-level constants closed over by ``step_fn``,
so when ``jax.jit`` traces it, XLA sees them as static — and the cascading
compiler optimizations the paper relies on (const-prop → unroll → fuse →
vectorize → DCE) fire in the XLA pipeline exactly as they do in LLVM O3.

The specializer also collects the *guards* for the enabled points, which the
trampoline checks at dispatch (paper §4.4.3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core.points import (
    DISABLED,
    AssumePoint,
    Config,
    CustomPoint,
    EnumPoint,
    GenericPoint,
    RangePoint,
    SpecPoint,
    SpecSpace,
)

__all__ = ["SpecCtx", "Specialized", "specialize_builder", "discover_space"]


@dataclasses.dataclass
class _BoundGuard:
    label: str
    value: Any
    predicate: Callable[[tuple, dict, Any], bool]

    def check(self, args: tuple, kwargs: dict) -> bool:
        return bool(self.predicate(args, kwargs, self.value))


def _compose_guards(guards: Sequence[_BoundGuard]) -> Callable | None:
    """Pre-bind guards into one ``(args, kwargs) -> bool`` closure.

    Binding the predicate/value pairs once at specialize time keeps the
    trampoline's dispatch path free of per-call attribute walks over the
    guard list; ``None`` means the variant is guardless and the trampoline
    may skip the check entirely.
    """
    if not guards:
        return None
    if len(guards) == 1:
        pred, value = guards[0].predicate, guards[0].value
        return lambda args, kwargs: bool(pred(args, kwargs, value))
    bound = tuple((g.predicate, g.value) for g in guards)
    return lambda args, kwargs: all(p(args, kwargs, v) for p, v in bound)


@dataclasses.dataclass
class Specialized:
    """Result of specializing a builder for one configuration."""

    fn: Callable
    config: dict[str, Any]
    space: SpecSpace
    guards: list[_BoundGuard]
    instrumented: bool
    #: labels of points that were enabled in this variant
    enabled: list[str]
    #: pre-bound composite guard; None iff the variant is guardless
    guard_fn: Callable[[tuple, dict], bool] | None = None

    def check_guards(self, args: tuple, kwargs: dict) -> bool:
        """True iff every guard passes (specialized variant is applicable)."""
        if self.guard_fn is not None:
            return self.guard_fn(args, kwargs)
        return all(g.check(args, kwargs) for g in self.guards)


class SpecCtx:
    """Context handed to handler builders.

    One instance per (builder, config) pair.  Each ``spec_*`` call both
    *registers* the point into the space and *resolves* it against the active
    configuration, returning the concrete value the builder should close over.

    ``donate_argnums`` are the positions of the step's arguments that the
    handler was registered to donate (``register(..., donate_argnums=...)``,
    ``jax.jit``'s keyword in the reference): the builder may update them in
    place (:meth:`donated`).
    """

    def __init__(
        self,
        config: Config | None = None,
        space: SpecSpace | None = None,
        custom_generators: Mapping[str, Callable] | None = None,
        instrument: bool = False,
        guards_enabled: bool = True,
        donate_argnums: Sequence[int] = (),
    ):
        self.space = space if space is not None else SpecSpace()
        self.donate_argnums = tuple(donate_argnums)
        self.config: dict[str, Any] = dict(config or {})
        self.guards: list[_BoundGuard] = []
        self.enabled: list[str] = []
        self.instrument = instrument
        self.guards_enabled = guards_enabled
        self._custom_generators = dict(custom_generators or {})
        #: in-graph instrumentation taps declared by the builder (label ->
        #: collector spec); see instrumentation.py.
        self.taps: dict[str, Any] = {}

    def donated(self, argnum: int) -> bool:
        """Whether the step's positional argument ``argnum`` is donated:
        its caller gives it up, so the step may write into it."""
        return argnum in self.donate_argnums

    # -- internal ------------------------------------------------------------
    def _resolve(self, point: SpecPoint) -> Any:
        self.space.register(point)
        value = self.config.get(point.label, DISABLED)
        if value is DISABLED:
            return point.default
        if not point.validate(value):
            raise ValueError(f"invalid value {value!r} for point {point}")
        if point.label not in self.enabled:
            self.enabled.append(point.label)
            if point.guard is not None and point.guarded and self.guards_enabled:
                self.guards.append(_BoundGuard(point.label, value, point.guard))
        return value

    # -- paper Table 2: specialization API ------------------------------------
    def point(self, point: SpecPoint) -> Any:
        """Register a pre-built (possibly custom-subclassed) point and
        resolve it against the active configuration.  Lets libraries ship
        point types with their own candidate/validation semantics (e.g. the
        kernel registry's ImplPoint, whose candidates are host-filtered but
        whose validation accepts any registered implementation name)."""
        return self._resolve(point)

    def enum(self, label: str, default: Any, choices: Sequence[Any],
             guard: Callable | None = None, guarded: bool = True) -> Any:
        """``spec_enum(lbl, x, ...)`` — value is one of ``choices``."""
        return self._resolve(EnumPoint(label, default, guard, guarded,
                                       choices=tuple(choices)))

    def range(self, label: str, default: Any, lo: Any, hi: Any, step: Any = 1,
              guard: Callable | None = None, guarded: bool = True) -> Any:
        """``spec_range(lbl, x, l, h)`` — value lies in ``[lo, hi]``."""
        return self._resolve(RangePoint(label, default, guard, guarded,
                                        lo=lo, hi=hi, step=step))

    def generic(self, label: str, default: Any = None,
                guard: Callable | None = None, guarded: bool = True) -> Any:
        """``spec_generic(lbl, x)`` — policy-controlled value point."""
        return self._resolve(GenericPoint(label, default, guard, guarded))

    def assume(self, label: str, guard: Callable | None = None,
               guarded: bool = True) -> bool:
        """``spec_assume(lbl, cond)`` — returns True iff the assumption is
        enabled for this variant; the builder emits simplified code then.

        Unlike ``llvm.assume``, violating the assumption is safe: the guard
        catches it at dispatch and falls back to the generic variant.
        """
        value = self._resolve(AssumePoint(label, False, guard, guarded))
        return bool(value)

    def custom(self, label: str, generator: str, *gen_args: Any,
               guard: Callable | None = None, guarded: bool = True,
               **gen_kwargs: Any) -> Any:
        """``spec_custom_*`` — invoke a registered code generator.

        Returns whatever the generator produced for the configured payload,
        or ``None`` when the point is disabled (builder keeps generic code).
        The generator signature is ``gen(payload, *gen_args, **gen_kwargs)``.
        """
        point = CustomPoint(label, None, guard, guarded, generator=generator)
        payload = self._resolve(point)
        if payload is None or payload is DISABLED:
            return None
        try:
            gen = self._custom_generators[generator]
        except KeyError:
            raise KeyError(
                f"custom specialization generator {generator!r} not "
                f"registered; call runtime.add_custom_spec({generator!r}, gen)"
            ) from None
        return gen(payload, *gen_args, **gen_kwargs)

    # -- instrumentation taps (paper §4.4.1) ----------------------------------
    def tap(self, label: str, spec: Any = None) -> bool:
        """Declare an in-graph instrumentation tap.

        Returns True iff instrumentation is enabled for this variant; the
        builder should then emit the collection code (extra outputs).  The
        runtime strips & accumulates tap outputs (see instrumentation.py).
        """
        self.taps[label] = spec
        return self.instrument


def specialize_builder(
    builder: Callable[[SpecCtx], Callable],
    config: Config,
    custom_generators: Mapping[str, Callable] | None = None,
    instrument: bool = False,
    guards_enabled: bool = True,
    donate_argnums: Sequence[int] = (),
) -> Specialized:
    """Run the builder under ``config`` and package the specialized handler
    (``donate_argnums``: see :class:`SpecCtx`)."""
    ctx = SpecCtx(config=config, custom_generators=custom_generators,
                  instrument=instrument, guards_enabled=guards_enabled,
                  donate_argnums=donate_argnums)
    fn = builder(ctx)
    ctx.space.validate(config)
    return Specialized(
        fn=fn,
        config=dict(config),
        space=ctx.space,
        guards=list(ctx.guards),
        instrumented=instrument,
        enabled=list(ctx.enabled),
        guard_fn=_compose_guards(ctx.guards),
    )


def discover_space(
    builder: Callable[[SpecCtx], Callable],
    custom_generators: Mapping[str, Callable] | None = None,
) -> SpecSpace:
    """Trace the builder with everything disabled to discover its points."""
    return specialize_builder(builder, {}, custom_generators).space
