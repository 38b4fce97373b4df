"""Multi-tenant serving: N models sharing one engine and one runtime.

One :class:`~repro_torch.serve.engine.ServeEngine` can serve several *tenants*
— each a model architecture with its own SLO class and fair-share weight —
through one :class:`~repro_torch.core.runtime.IridescentRuntime`, one
``CompileService`` and one variant cache.  The pieces:

* :class:`TenantSpec` — the declaration (``name=arch:slo_ms:weight``, the
  ``--tenant`` CLI grammar),
* :func:`make_tenant_context_fn` — prefixes a handler's context key with
  the tenant name, so contexts become ``(tenant, phase, bucket)`` and each
  tenant's traffic runs its *own* Controller search per phase/bucket (the
  tuple-key codec already round-trips this through ``spec_state.json``),
* :class:`MultiTenantExecutor` — routes each step's batch to the served
  tenant's executor (different models cannot share a handler call; the
  batcher guarantees one tenant per step),
* :class:`ControllerGroup` — aggregates the per-tenant Controllers behind
  the single ``controller`` slot the engine steps and persists.

Scheduling *between* tenants is the scheduler's job —
:class:`~repro_torch.serve.scheduler.DeficitRoundRobin` provides the
weighted-fair isolation; a plain FCFS engine still works but lets a
flooding tenant starve the rest.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

from repro_torch.serve.batcher import PackedBatch
from repro_torch.serve.request import Request

__all__ = ["TenantSpec", "parse_tenant_arg", "make_tenant_context_fn",
           "MultiTenantExecutor", "ControllerGroup"]


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: a model plus its SLO class and fair-share weight."""

    name: str
    arch: str
    slo_s: float | None = None       # per-tenant default SLO (None = engine's)
    weight: float = 1.0              # DRR fair-share weight

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r} has non-positive weight {self.weight}")
        if self.slo_s is not None and self.slo_s <= 0:
            raise ValueError(
                f"tenant {self.name!r} has non-positive SLO {self.slo_s}")


def parse_tenant_arg(arg: str,
                     default_slo_ms: float | None = None) -> TenantSpec:
    """Parse one ``--tenant`` value: ``name=arch[:slo_ms[:weight]]``.

    ``slo_ms`` may be empty (inherit ``default_slo_ms``); ``weight``
    defaults to 1.0.  Examples::

        --tenant chat=qwen3-0.6b:50:3     # 50 ms SLO, weight 3
        --tenant batch=rwkv6-1.6b::1      # no own SLO, weight 1
        --tenant bg=rwkv6-1.6b            # inherit SLO, weight 1
    """
    name, sep, rest = arg.partition("=")
    if not sep or not name or not rest:
        raise ValueError(
            f"bad --tenant {arg!r}; expected name=arch[:slo_ms[:weight]]")
    parts = rest.split(":")
    if len(parts) > 3:
        raise ValueError(
            f"bad --tenant {arg!r}; expected name=arch[:slo_ms[:weight]]")
    arch = parts[0]
    if not arch:
        raise ValueError(f"bad --tenant {arg!r}; missing architecture")
    slo_ms = default_slo_ms
    if len(parts) > 1 and parts[1]:
        slo_ms = float(parts[1])
    weight = 1.0
    if len(parts) > 2 and parts[2]:
        weight = float(parts[2])
    return TenantSpec(name=name, arch=arch,
                      slo_s=(slo_ms / 1e3 if slo_ms is not None else None),
                      weight=weight)


def make_tenant_context_fn(tenant: str, base: Callable | None) -> Callable:
    """Wrap a handler ``context_fn`` so its key is prefixed with the
    tenant name: ``base -> (phase, bucket)`` becomes ``(tenant, phase,
    bucket)``.  A scalar base key becomes ``(tenant, key)``; with no base
    the key is just ``(tenant,)`` — the tenant always owns its contexts.
    """
    def context_fn(args, kwargs):
        if base is None:
            return (tenant,)
        key = base(args, kwargs)
        if isinstance(key, tuple):
            return (tenant, *key)
        return (tenant, key)

    return context_fn


class MultiTenantExecutor:
    """Routes each packed batch to the served tenant's executor.

    ``executors`` maps tenant name -> a per-tenant
    :class:`~repro_torch.serve.engine.BatchExecutor` (each owns its model's
    params, handler and KV state).  The batcher packs one tenant per step
    and stamps ``batch.tenant``; retire routes by ``request.tenant``.
    All per-tenant executors must agree on ``phased`` — the engine packs
    either phased or legacy batches, not a mix.
    """

    def __init__(self, executors: Mapping[str, object]):
        if not executors:
            raise ValueError("MultiTenantExecutor needs at least one tenant")
        self.executors = dict(executors)
        flags = {bool(getattr(ex, "phased", False))
                 for ex in self.executors.values()}
        if len(flags) != 1:
            raise ValueError(
                "all tenant executors must agree on phased execution; got "
                f"{ {t: bool(getattr(ex, 'phased', False)) for t, ex in sorted(self.executors.items())} }")
        self.phased = flags.pop()

    def _executor_for(self, tenant):
        try:
            return self.executors[tenant]
        except KeyError:
            raise KeyError(
                f"no executor for tenant {tenant!r}; "
                f"have {sorted(self.executors)}") from None

    def execute(self, batch: PackedBatch):
        tenant = batch.tenant
        if tenant is None and batch.requests:
            tenant = batch.requests[0].tenant
        return self._executor_for(tenant).execute(batch)

    def retire(self, req: Request) -> None:
        ex = self.executors.get(req.tenant)
        retire = getattr(ex, "retire", None)
        if retire is not None:
            retire(req)

    def stats(self) -> dict:
        out = {}
        for tenant, ex in sorted(self.executors.items()):
            fn = getattr(ex, "stats", None)
            if callable(fn):
                out[tenant] = fn()
        return out


class ControllerGroup:
    """Aggregates per-tenant Controllers behind the engine's single
    ``controller`` slot.

    ``pairs`` is ``[(handler, controller), ...]`` — one per tenant.  The
    engine calls :meth:`step` once per served iteration (every tenant's
    search advances on the shared dwell clock; a tenant with no traffic
    simply observes no throughput and keeps waiting), and persistence
    walks :attr:`pairs` so every tenant's settled contexts land in one
    ``spec_state.json``.
    """

    def __init__(self, pairs: Sequence[tuple]):
        pairs = list(pairs)
        if not pairs:
            raise ValueError("ControllerGroup needs at least one controller")
        self.pairs = [(h, c) for h, c in pairs]
        names = [h.name for h, _ in self.pairs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate handler names in group: {names}")

    @property
    def controllers(self) -> dict:
        return {h.name: c for h, c in self.pairs}

    def step(self) -> None:
        for _, ctl in self.pairs:
            ctl.step()

    def contexts(self) -> list:
        return [k for _, ctl in self.pairs for k in ctl.contexts()]

    def settled(self) -> bool:
        return all(ctl.settled() for _, ctl in self.pairs)

    def best_configs(self) -> dict:
        """Per-handler map of each context's best known config."""
        return {h.name: ctl.best_configs() for h, ctl in self.pairs}

    def status(self) -> dict:
        return {h.name: ctl.status() for h, ctl in self.pairs}
