"""Kernel registry of the PyTorch/CUDA port.

Every kernel family the port has (rmsnorm, attention, matmul,
linear_attention and fastpath: one for each of the reference's Pallas
kernels) registers its implementations here as *named entries*
with an availability predicate (host capability: is there a Hopper-class
CUDA device), an optional per-call correctness guard (shape/dtype/device
preconditions of the specialized code path) and an optional ``prepare``
hook that builds and loads the entry's kernel library.  Dispatch then
mirrors the paper's specialization story end to end:

* the set of **available** entries on the current host is the candidate set
  of the family's ``{family}_impl`` spec point (declared via
  :func:`impl_point`), so ``Explorer`` searches the implementation choice
  online exactly like a block size;
* a **guard miss** at call time transparently falls back to the generic
  ``torch_ref`` entry (paper §4.4.3) — a CPU tensor handed to ``cuda``
  runs the plain version, counted in ``fallback_counts``;
* requesting an implementation that is *unavailable* on this host degrades
  to ``torch_ref`` as well — a config tuned on the H100 replays safely on
  a CPU CI host.

Canonical entry names:

* ``torch_ref`` — plain PyTorch composition; always available; the
                  numerical oracle and the fallback target.
* ``cuda``      — a hand-written CUDA C++ kernel for ``sm_90a``, built
                  with ``nvcc`` on first use and bound with ``ctypes``;
                  needs a CUDA device of capability >= (9, 0).

The reference package's names are accepted as aliases (``xla``/``xla_ref``
-> ``torch_ref``, ``pallas``/``pallas_tpu``/``pallas_gpu`` -> ``cuda``), so
a ``spec_state`` tuned on the reference replays here.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable, Mapping

from repro_torch.core.points import DISABLED, EnumPoint

logger = logging.getLogger("repro_torch.kernels.registry")

__all__ = [
    "FALLBACK_IMPL", "LEGACY_ALIASES", "KernelImpl", "KernelRegistry",
    "default_registry", "register", "get", "families", "implementations",
    "available", "choices", "resolve", "dispatch", "impl_point",
]

#: the generic entry every family must register; target of all fallbacks.
FALLBACK_IMPL = "torch_ref"

#: the reference package's impl spellings, accepted everywhere an impl
#: name is.  The interpreter entries map to the plain version: they are
#: the reference's way of running a kernel body on the host.
LEGACY_ALIASES: Mapping[str, str] = {
    "xla": "torch_ref",
    "xla_ref": "torch_ref",
    "ref": "torch_ref",
    "interpret": "torch_ref",
    "pallas_interpret": "torch_ref",
    "pallas": "cuda",
    "pallas_tpu": "cuda",
    "pallas_gpu": "cuda",
}


def canonical_name(impl: str) -> str:
    return LEGACY_ALIASES.get(impl, impl)


def env_impl() -> str | None:
    """The impl name forced via ``REPRO_KERNEL_IMPL`` (canonicalized), or
    None.  The single place the environment override is read."""
    env = os.environ.get("REPRO_KERNEL_IMPL")
    return canonical_name(env) if env else None


def _always(*_args: Any, **_kw: Any) -> bool:
    return True


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One named implementation of a kernel family."""

    family: str
    name: str
    fn: Callable
    #: host/build capability probe — no arguments, cheap, safe to call often.
    available: Callable[[], bool]
    #: per-call correctness precondition ``guard(*args, **kwargs) -> bool``;
    #: None means the implementation handles every input the family accepts.
    guard: Callable[..., bool] | None
    #: selection order among available entries (higher = preferred by auto).
    priority: int
    #: whether autograd can differentiate through this entry (kernels
    #: without a backward cannot be used inside a training step).
    supports_grad: bool = True
    description: str = ""
    #: builds and loads the entry's kernel library; None for plain entries.
    #: Called off the dispatch path when a variant naming the entry is
    #: compiled; a build failure raises.
    prepare: Callable[[], Any] | None = None

    def is_available(self) -> bool:
        try:
            return bool(self.available())
        except Exception:                     # defensive: probe must not kill
            logger.exception("availability probe failed for %s/%s",
                             self.family, self.name)
            return False


class KernelRegistry:
    """family -> {name -> KernelImpl}, with guarded fallback dispatch."""

    def __init__(self):
        self._families: dict[str, dict[str, KernelImpl]] = {}
        #: (family, requested-or-guarded name) -> fallback count, observable
        #: by tests and the instrumentation layer.
        self.fallback_counts: dict[tuple[str, str], int] = {}

    # -- registration --------------------------------------------------------
    def register(self, family: str, name: str, *,
                 available: Callable[[], bool] | None = None,
                 guard: Callable[..., bool] | None = None,
                 priority: int = 0,
                 supports_grad: bool = True,
                 description: str = "",
                 prepare: Callable[[], Any] | None = None
                 ) -> Callable[[Callable], Callable]:
        """Decorator: register ``fn`` as ``family``/``name``.

        The decorated function keeps working as a plain callable; the
        registry stores it alongside its availability predicate and guard.
        """
        name = canonical_name(name)

        def deco(fn: Callable) -> Callable:
            fam = self._families.setdefault(family, {})
            if name in fam:
                raise ValueError(
                    f"kernel impl {family}/{name} registered twice")
            fam[name] = KernelImpl(
                family=family, name=name, fn=fn,
                available=available or _always, guard=guard,
                priority=priority, supports_grad=supports_grad,
                description=description, prepare=prepare)
            return fn

        return deco

    # -- queries -------------------------------------------------------------
    def families(self) -> list[str]:
        return sorted(self._families)

    def implementations(self, family: str) -> dict[str, KernelImpl]:
        return dict(self._family(family))

    def get(self, family: str, name: str) -> KernelImpl:
        fam = self._family(family)
        name = canonical_name(name)
        if name not in fam:
            raise KeyError(
                f"kernel family {family!r} has no impl {name!r}; "
                f"registered: {sorted(fam)}")
        return fam[name]

    def available(self, family: str,
                  require_grad: bool = False) -> list[KernelImpl]:
        """Available entries, best (highest priority) first."""
        entries = [e for e in self._family(family).values()
                   if e.is_available()
                   and (e.supports_grad or not require_grad)]
        return sorted(entries, key=lambda e: (-e.priority, e.name))

    def choices(self, family: str,
                require_grad: bool = False) -> tuple[str, ...]:
        """Canonical names of the entries available on this host — the
        candidate set for the family's ``{family}_impl`` spec point.

        ``require_grad=True`` restricts to entries autograd can
        differentiate through (for training-step builders)."""
        return tuple(e.name
                     for e in self.available(family, require_grad))

    def _family(self, family: str) -> dict[str, KernelImpl]:
        if family not in self._families:
            raise KeyError(f"unknown kernel family {family!r}; "
                           f"registered: {self.families()}")
        return self._families[family]

    # -- selection & dispatch -------------------------------------------------
    def pick(self, family: str,
             impl: str | None = None) -> tuple[KernelImpl, str | None]:
        """:meth:`resolve` without counting: the entry to run, and the name
        of the unavailable entry it stands in for (None if none)."""
        fam = self._family(family)
        if impl is None:
            impl = env_impl()
        if impl is None or impl == "auto":
            avail = self.available(family)
            if not avail:
                raise RuntimeError(
                    f"kernel family {family!r} has no available impl on "
                    f"this host (registered: {sorted(fam)})")
            return avail[0], None
        entry = self.get(family, impl)
        if entry.is_available():
            return entry, None
        return self.get(family, FALLBACK_IMPL), entry.name

    def resolve(self, family: str, impl: str | None = None) -> KernelImpl:
        """Pick the entry to run: ``impl`` if named and available, the best
        available entry if ``impl`` is None/'auto', else the fallback."""
        entry, missing = self.pick(family, impl)
        if missing is not None:
            self._count_fallback(family, missing)
            logger.debug("impl %s/%s unavailable on this host; falling back "
                         "to %s", family, missing, FALLBACK_IMPL)
        return entry

    def dispatch(self, family: str, impl: str | None,
                 *args: Any, **kwargs: Any) -> Any:
        """Resolve, check the guard against the actual call, run.

        A guard miss re-routes this invocation to ``torch_ref`` (the entry
        stays selected — the next call re-checks, mirroring the trampoline's
        per-invocation guard semantics).
        """
        entry = self._guarded(family, self.resolve(family, impl), args,
                              kwargs)
        return entry.fn(*args, **kwargs)

    def bind(self, family: str,
             impl: str | None = None) -> Callable[..., KernelImpl]:
        """For a caller that runs one family many times (a specialized
        handler): resolves ``impl`` once, as the reference's ``jax.jit``
        traces its dispatch once, and returns ``select(*args, **kwargs)``,
        the entry :meth:`dispatch` would run for that call, counting its
        fallbacks as :meth:`dispatch` does (an unavailable entry on every
        call, a guard miss)."""
        entry, missing = self.pick(family, impl)

        def select(*args: Any, **kwargs: Any) -> KernelImpl:
            if missing is not None:
                self._count_fallback(family, missing)
                return entry
            return self._guarded(family, entry, args, kwargs)

        return select

    def _guarded(self, family: str, entry: KernelImpl, args: tuple,
                 kwargs: dict) -> KernelImpl:
        """``entry``, or ``torch_ref`` (counted) if its guard misses."""
        if entry.guard is not None and entry.name != FALLBACK_IMPL:
            try:
                ok = bool(entry.guard(*args, **kwargs))
            except Exception:
                logger.exception("guard for %s/%s raised; treating as miss",
                                 family, entry.name)
                ok = False
            if not ok:
                self._count_fallback(family, entry.name)
                return self.get(family, FALLBACK_IMPL)
        return entry

    def prepare(self, family: str, impl: str | None) -> None:
        """Build and load the kernel library of the entry ``impl`` would
        resolve to (nothing for plain or unavailable entries).  Counts no
        fallback: nothing is dispatched."""
        if impl is None or impl == "auto":
            impl = env_impl()
        if impl is None or impl == "auto":
            avail = self.available(family)
            entry = avail[0] if avail else None
        else:
            entry = self.get(family, impl)
        if entry is not None and entry.prepare is not None \
                and entry.is_available():
            entry.prepare()

    def _count_fallback(self, family: str, name: str) -> None:
        key = (family, name)
        self.fallback_counts[key] = self.fallback_counts.get(key, 0) + 1


@dataclasses.dataclass(frozen=True)
class ImplPoint(EnumPoint):
    """Spec point for a kernel family's implementation choice.

    ``choices`` (the exploration candidates) are the entries available on
    the *current* host, but :meth:`validate` accepts any name registered
    for the family — canonical or legacy — so a configuration tuned on one
    host (e.g. ``cuda`` on the H100, or the reference's ``pallas_tpu``)
    replays on another: dispatch degrades unavailable choices to
    ``torch_ref`` instead of the spec layer rejecting the config.

    :meth:`prepare` is the runtime's compile step for this point: it builds
    the kernel library the chosen entry needs.
    """

    family: str = ""

    def prepare(self, value: Any) -> None:
        default_registry.prepare(self.family, value)

    def validate(self, value: Any) -> bool:
        if value is DISABLED:
            return True
        try:
            default_registry.get(self.family, value)
        except (KeyError, TypeError):
            return False
        return True


#: the process-wide registry the kernel packages populate at import time.
default_registry = KernelRegistry()

# module-level conveniences bound to the default registry
register = default_registry.register
get = default_registry.get
families = default_registry.families
implementations = default_registry.implementations
available = default_registry.available
choices = default_registry.choices
resolve = default_registry.resolve
dispatch = default_registry.dispatch


def impl_point(spec: Any, family: str, default: str | None = None,
               require_grad: bool = False,
               registry: KernelRegistry | None = None) -> str | None:
    """Declare the family's implementation choice as an Iridescent spec point.

    ``spec`` is the :class:`repro_torch.core.specializer.SpecCtx` handed to a
    handler builder.  The candidate set is the entries *available on this
    host*, so exploring the point on a CPU-only machine can only land on
    entries that actually run there (``torch_ref`` alone).

    No dispatch guard is installed for the point itself: unavailable or
    guard-missing choices already degrade to ``torch_ref`` inside
    :meth:`KernelRegistry.dispatch`, which is the correctness story.

    With ``require_grad=True`` the returned value is always a *concrete*
    grad-safe entry name, never None: auto-resolution at dispatch time
    ignores differentiability (it cannot know the call is under
    autograd), so a builder for a differentiated step must close over
    an explicit choice.  A default that is not grad-safe on this host is
    replaced by the best grad-safe entry.
    """
    reg = registry or default_registry
    choices = reg.choices(family, require_grad)
    default = canonical_name(default) if default else None
    if require_grad and default not in choices:
        default = choices[0] if choices else FALLBACK_IMPL
    value = spec.point(ImplPoint(f"{family}_impl", default, None, False,
                                 choices=choices, family=family))
    if require_grad and value is not None and value is not DISABLED:
        # a replayed config may name a non-grad-safe entry; pin the
        # grad-safe fallback instead of crashing inside autograd
        if not reg.get(family, value).supports_grad:
            value = default
    return value
