"""Specialization points and the specialization space (paper §4.2, Table 2).

A *specialization point* declares one dimension of the space of possible
specializations.  Points are declared by handler builders through a
:class:`SpecCtx` (see ``specializer.py``); the set of points discovered while
tracing the builder forms the :class:`SpecSpace` the policy explores.

Point kinds (mirroring the paper's API):

* ``enum``    — value point; the wrapped value is one of an explicit set.
* ``range``   — value point; the wrapped value lies in ``[lo, hi]`` (with step).
* ``generic`` — value point; the policy supplies candidate values (possibly
  discovered through instrumentation).
* ``assume``  — assumption point; a boolean predicate the specializer may bake
  into the code (the JAX analogue of ``llvm.assume``), guarded at dispatch.
* ``custom``  — user-defined code-generation point; the policy supplies an
  opaque payload that a registered generator turns into specialized code.

A *configuration* maps point labels to chosen values.  ``None`` / ``DISABLED``
means "point disabled": the specializer keeps the generic code for that point.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Iterable, Iterator, Mapping, Sequence

__all__ = [
    "DISABLED",
    "SpecPoint",
    "EnumPoint",
    "RangePoint",
    "GenericPoint",
    "AssumePoint",
    "CustomPoint",
    "SpecSpace",
    "StaleConfigError",
    "Config",
    "config_key",
    "cartesian",
]


class _Disabled:
    """Sentinel: the point is disabled (generic code path)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "DISABLED"

    def __bool__(self):
        return False


DISABLED = _Disabled()

#: A specialization configuration: label -> chosen value (or DISABLED).
Config = Mapping[str, Any]


def _freeze(value: Any) -> Any:
    """Make a config value hashable for the variant cache."""
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, set):
        return tuple(sorted(_freeze(v) for v in value))
    if hasattr(value, "tobytes"):          # np/jax arrays as payloads
        import numpy as np
        arr = np.asarray(value)
        return (str(arr.dtype), arr.shape, arr.tobytes())
    return value


def config_key(config: Config) -> tuple:
    """Canonical hashable key for a configuration (variant-cache key)."""
    return tuple(sorted((k, _freeze(v)) for k, v in config.items()))


@dataclasses.dataclass(frozen=True)
class SpecPoint:
    """Base class for specialization points.

    Attributes:
      label: unique name of the point within a handler.
      default: value used when the point is disabled (the generic behaviour).
      guard: optional host-side predicate ``guard(args, kwargs, value) -> bool``
        checked at dispatch when the point is enabled.  ``None`` means the
        point needs no guard (any choice is correct for every workload — e.g.
        an internal tuning parameter like a block size).
      guarded: whether the specializer should install the guard (the paper's
        "specializer will also insert a specialization guard, which the
        developers may explicitly disable").
    """

    label: str
    default: Any = None
    guard: Callable[[tuple, dict, Any], bool] | None = None
    guarded: bool = True

    @property
    def kind(self) -> str:
        return type(self).__name__.replace("Point", "").lower()

    def candidates(self) -> Sequence[Any]:
        """Candidate values for exhaustive policies (may be empty)."""
        return ()

    def validate(self, value: Any) -> bool:
        """Whether ``value`` is a legal choice for this point."""
        return True


@dataclasses.dataclass(frozen=True)
class EnumPoint(SpecPoint):
    choices: tuple = ()

    def candidates(self) -> Sequence[Any]:
        return self.choices

    def validate(self, value: Any) -> bool:
        return value is DISABLED or value in self.choices


@dataclasses.dataclass(frozen=True)
class RangePoint(SpecPoint):
    lo: Any = 0
    hi: Any = 0
    step: Any = 1

    def __post_init__(self):
        # A non-positive step would make candidates() loop forever.
        try:
            ok = self.step > 0
        except TypeError:
            ok = False
        if not ok:
            raise ValueError(
                f"RangePoint {self.label!r} requires step > 0 "
                f"(got step={self.step!r}); a non-positive step would never "
                f"advance past hi={self.hi!r}")

    def candidates(self) -> Sequence[Any]:
        out, v = [], self.lo
        while v <= self.hi:
            out.append(v)
            v = v + self.step
        return out

    def validate(self, value: Any) -> bool:
        return value is DISABLED or (self.lo <= value <= self.hi)


@dataclasses.dataclass(frozen=True)
class GenericPoint(SpecPoint):
    """Policy-controlled point: candidates come from the policy (often from
    instrumentation data), not from the declaration."""

    def candidates(self) -> Sequence[Any]:
        return ()


@dataclasses.dataclass(frozen=True)
class AssumePoint(SpecPoint):
    """Assumption point. Value is a bool: True = bake the assumption in.

    ``guard`` receives ``(args, kwargs, True)`` and must return whether the
    assumption actually holds for this invocation.
    """

    default: Any = False

    def candidates(self) -> Sequence[Any]:
        return (False, True)

    def validate(self, value: Any) -> bool:
        return value is DISABLED or isinstance(value, bool)


@dataclasses.dataclass(frozen=True)
class CustomPoint(SpecPoint):
    """User-defined code-generation point (paper §4.2 "custom").

    ``generator`` names a generator registered with
    ``IridescentRuntime.add_custom_spec(name, gen)``.  The config value for a
    custom point is an opaque payload passed to the generator.
    """

    generator: str = ""


class StaleConfigError(KeyError, ValueError):
    """A configuration the space rejects: an unknown point, a value outside
    a point's choices, or no mapping at all (say, one restored from a run
    whose builder declared other points).  It is a ``KeyError`` and a
    ``ValueError``, the two errors the reference's ``validate`` raises.
    The runtime never builds such a configuration: the context keeps its
    current variant, unlike a valid configuration whose build fails."""

    def __str__(self) -> str:
        return str(self.args[0]) if self.args else ""


class SpecSpace:
    """The specialization space: the set of points a handler declared.

    Returned by ``IridescentRuntime.spec_space()`` (paper Table 2).  Also
    carries instrumentation results (``observed``) so policies can derive
    candidate values from runtime data (paper §4.4.1 "The policy retrieves
    this information included in the result of the spec_space call").
    """

    def __init__(self, points: Mapping[str, SpecPoint] | None = None):
        self._points: dict[str, SpecPoint] = dict(points or {})
        #: label -> instrumentation summary (filled in by the runtime).
        self.observed: dict[str, Any] = {}

    # -- registration -------------------------------------------------------
    @staticmethod
    def _shape(point: SpecPoint) -> tuple:
        """Point identity modulo guard-function object identity (builders
        commonly declare the same point in a loop with a fresh lambda)."""
        d = dataclasses.asdict(point)
        d.pop("guard", None)
        return (type(point).__name__, _freeze(d))

    def register(self, point: SpecPoint) -> None:
        existing = self._points.get(point.label)
        if existing is not None and self._shape(existing) != self._shape(point):
            raise ValueError(
                f"specialization point {point.label!r} re-declared with a "
                f"different definition: {existing} vs {point}"
            )
        self._points[point.label] = point

    # -- queries -------------------------------------------------------------
    @property
    def points(self) -> dict[str, SpecPoint]:
        return dict(self._points)

    def __contains__(self, label: str) -> bool:
        return label in self._points

    def __getitem__(self, label: str) -> SpecPoint:
        return self._points[label]

    def __iter__(self) -> Iterator[str]:
        return iter(self._points)

    def __len__(self) -> int:
        return len(self._points)

    def labels(self) -> list[str]:
        return list(self._points)

    def default_config(self) -> dict[str, Any]:
        """All points disabled — the generic implementation."""
        return {label: DISABLED for label in self._points}

    def validate(self, config: Config) -> None:
        """Raise :class:`StaleConfigError` unless ``config`` is a mapping of
        this space's labels to values their points accept."""
        if not isinstance(config, Mapping):
            raise StaleConfigError(f"a configuration is a mapping of point "
                                   f"labels, got {type(config).__name__}")
        for label, value in config.items():
            if label not in self._points:
                raise StaleConfigError(
                    f"unknown specialization point {label!r}; "
                    f"space has {sorted(self._points)}")
            if not self._points[label].validate(value):
                raise StaleConfigError(
                    f"value {value!r} invalid for point {self._points[label]}")

    def configs(
        self,
        labels: Sequence[str] | None = None,
        overrides: Mapping[str, Sequence[Any]] | None = None,
        include_disabled: bool = False,
    ) -> list[dict[str, Any]]:
        """Enumerate the cartesian product of candidate values.

        Args:
          labels: restrict enumeration to these points (others disabled).
          overrides: label -> candidate values (e.g. for generic points whose
            candidates came from instrumentation).
          include_disabled: include DISABLED alongside each point's candidates.
        """
        overrides = dict(overrides or {})
        labels = list(labels) if labels is not None else list(self._points)
        axes: list[list[tuple[str, Any]]] = []
        for label in labels:
            cands = list(overrides.get(label, self._points[label].candidates()))
            if include_disabled or not cands:
                cands = [DISABLED] + cands
            axes.append([(label, v) for v in cands])
        base = self.default_config()
        out = []
        for combo in itertools.product(*axes):
            cfg = dict(base)
            cfg.update(dict(combo))
            out.append(cfg)
        return out


def cartesian(*config_sets: Iterable[Config]) -> list[dict[str, Any]]:
    """Cartesian product of configuration sets (paper Fig 2b ``cartesian``)."""
    out: list[dict[str, Any]] = []
    for combo in itertools.product(*config_sets):
        merged: dict[str, Any] = {}
        for c in combo:
            merged.update(c)
        out.append(merged)
    return out
