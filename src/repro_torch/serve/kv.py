"""Block-paged per-request KV/state management for the serve engine.

The continuous-batching engine joins and retires requests mid-stream, but
model decode caches are dense ``(batch, ..., seq, ...)`` arrays compiled
for a bucket shape.  :class:`PagedKV` bridges the two, vLLM-style: every
request owns an isolated logical KV sequence stored as fixed-size **pages**
in host-side pools, mapped through a per-request :class:`PageTable`.  Each
engine step the executor *materializes* the batch's rows into a dense
device cache (padded to the bucket), runs the compiled step, then
*harvests* the newly written slots back into pages.  Retiring a request
returns its pages to a free list, so memory is reused across the stream
and no page is ever shared between two live requests.

**Page geometry is a specialization point.**  The layout — ``paged`` with
a tunable page size, or ``contig`` (one max-length page per request, the
contiguous-per-bucket baseline) — is declared as enum spec points on a
tiny registered ``kv_plan`` handler (:func:`kv_plan_builder`), and
:class:`KVTuner` drives it with the ordinary
:class:`~repro_torch.core.controller.Controller` against observed goodput —
exactly the machinery that tunes kernel implementations and bucket
schemes, persisting through ``spec_state.json`` like any other tuned
config.  The tradeoff being searched: small pages waste no capacity on
short requests (more concurrent requests fit) but fragment the host
copies; big pages copy in long runs but strand capacity.  A geometry
re-tune only affects *future* joins — in-flight requests keep the
geometry they were admitted under, so no live state is ever migrated.

The pools stay host numpy arrays, as in the reference; ``materialize``
builds one staging array per cache leaf and copies it to the device, and
``harvest`` slices each row's written span on the device before copying
it back, so a step moves the rows' new tokens, not the whole cache.

Cache pytree leaves are classified by the model's logical axes
(``model.cache_axes(cfg)``), so the manager is generic across mixers:

* ``seq_kv`` in axes      -> **paged** (attention/MLA KV rings),
* ``batch`` without seq   -> **row state** (SSM/RWKV recurrent state,
  copied whole per request per step — it is O(1) in sequence length),
* neither                 -> **shared** (e.g. ``slot_pos``), passed
  through from the template.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import compat

logger = logging.getLogger("repro_torch.serve.kv")

__all__ = ["PageError", "PagePool", "PageTable", "PagedKV",
           "kv_plan_builder", "KVTuner", "KV_LAYOUT_POINT", "KV_PAGE_POINT"]

#: Spec-point labels for the KV plan handler.
KV_LAYOUT_POINT = "kv_layout"
KV_PAGE_POINT = "kv_page_size"


class PageError(RuntimeError):
    """Page-allocator invariant violation (double free, foreign page,
    out of pages)."""


class PagePool:
    """Fixed-capacity page allocator with a LIFO free list.

    LIFO reuse keeps recently retired pages hot in cache and makes
    free-list reuse observable in tests: the next alloc after a retire
    returns the just-freed page.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0:
            raise ValueError(f"num_pages must be positive, got {num_pages}")
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free: list[int] = list(range(self.num_pages - 1, -1, -1))
        self._live: set[int] = set()
        self.allocs = 0
        self.frees = 0
        self.high_water = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return len(self._live)

    def alloc(self) -> int:
        if not self._free:
            raise PageError(f"out of pages ({self.num_pages} total, "
                            f"{len(self._live)} live)")
        pid = self._free.pop()
        self._live.add(pid)
        self.allocs += 1
        self.high_water = max(self.high_water, len(self._live))
        return pid

    def free(self, pid: int) -> None:
        if pid < 0 or pid >= self.num_pages:
            raise PageError(f"page {pid} does not belong to this pool "
                            f"(capacity {self.num_pages})")
        if pid not in self._live:
            raise PageError(f"double free of page {pid}")
        self._live.remove(pid)
        self._free.append(pid)
        self.frees += 1


@dataclasses.dataclass
class PageTable:
    """One request's logical KV sequence: its pages and token length."""

    rid: str
    geometry: tuple[str, int]            # (layout, page_size)
    pages: list[int] = dataclasses.field(default_factory=list)
    length: int = 0                      # tokens written so far
    row_state: list = dataclasses.field(default_factory=list)

    @property
    def page_size(self) -> int:
        return self.geometry[1]


# -- leaf classification --------------------------------------------------------

_PAGED, _ROW, _SHARED = "paged", "row", "shared"


@dataclasses.dataclass
class _LeafSpec:
    kind: str
    bat_i: int | None       # batch axis index in the original layout
    seq_i: int | None       # seq_kv axis index in the original layout
    shape: tuple            # original template shape (batch dim == 1)
    dtype: Any
    token_shape: tuple      # moved-layout trailing dims (paged leaves)
    template_row: "np.ndarray | None"   # one row's initial state
    template_value: Any = None          # shared leaves: passed through


def _moved(arr, bat_i: int, seq_i: int | None):
    """View with batch first (and seq second, for paged leaves)."""
    if seq_i is None:
        return np.moveaxis(arr, bat_i, 0)
    return np.moveaxis(arr, (bat_i, seq_i), (0, 1))


class PagedKV:
    """Block-paged state manager over an arbitrary cache pytree.

    ``template`` is a cache built for ``batch=1`` at full ``max_len``
    (``model.init_cache(cfg, 1, max_len, opts)``); ``axes`` is the
    matching logical-axes pytree (``model.cache_axes(cfg)``).  The
    manager owns host (numpy) page pools per *geometry*; device arrays
    exist only for the duration of a step (materialize -> run -> harvest).

    ``capacity_tokens`` bounds each geometry's pool.  ``geometry`` fixes
    the layout; attach a :class:`KVTuner` to tune it online instead.
    ``device`` is where :meth:`materialize` puts the step's cache.
    """

    def __init__(self, template: Any, axes: Any, *, max_len: int,
                 capacity_tokens: int, page_size: int = 16,
                 layout: str = "paged",
                 device: torch.device | str = "cpu"):
        if max_len <= 0:
            raise ValueError(f"max_len must be positive, got {max_len}")
        if capacity_tokens < max_len:
            raise ValueError(f"capacity_tokens ({capacity_tokens}) below "
                             f"max_len ({max_len}): one request cannot fit")
        self.max_len = int(max_len)
        self.capacity_tokens = int(capacity_tokens)
        self.device = torch.device(device)
        t_leaves, self._treedef = compat.tree_flatten(template)
        a_leaves, _ = compat.tree_flatten(
            axes, is_leaf=lambda x: isinstance(x, tuple))
        if len(t_leaves) != len(a_leaves):
            raise ValueError(
                f"template has {len(t_leaves)} leaves but axes has "
                f"{len(a_leaves)}; the pytrees must match")
        self._leaves: list[_LeafSpec] = []
        for leaf, ax in zip(t_leaves, a_leaves):
            ax = tuple(ax)
            if len(ax) != np.ndim(leaf):
                raise ValueError(f"axes {ax} do not match leaf shape "
                                 f"{np.shape(leaf)}")
            bat_i = ax.index("batch") if "batch" in ax else None
            seq_i = ax.index("seq_kv") if "seq_kv" in ax else None
            if seq_i is not None and bat_i is None:
                raise ValueError(f"leaf with axes {ax} has seq_kv but no "
                                 f"batch axis; cannot page it per request")
            host = _to_host(leaf)
            if seq_i is not None:
                moved = _moved(host, bat_i, seq_i)
                if moved.shape[1] != self.max_len:
                    raise ValueError(
                        f"paged leaf seq capacity {moved.shape[1]} != "
                        f"max_len {self.max_len}; windowed (SWA) caches "
                        f"are not pageable per request")
                self._leaves.append(_LeafSpec(
                    _PAGED, bat_i, seq_i, host.shape, host.dtype,
                    moved.shape[2:], None))
            elif bat_i is not None:
                moved = _moved(host, bat_i, None)
                self._leaves.append(_LeafSpec(
                    _ROW, bat_i, None, host.shape, host.dtype,
                    moved.shape[1:], moved[0].copy()))
            else:
                # Shared leaves are kept on host and re-uploaded each
                # materialize: the step writes its cache in place, so a
                # device buffer handed out once cannot be reused.
                self._leaves.append(_LeafSpec(
                    _SHARED, None, None, host.shape, host.dtype,
                    (), None, template_value=host.copy()))
        self._paged_idx = [i for i, l in enumerate(self._leaves)
                           if l.kind == _PAGED]
        self._row_idx = [i for i, l in enumerate(self._leaves)
                         if l.kind == _ROW]
        # geometry -> (PagePool, {leaf index -> pool array})
        self._pools: dict[tuple[str, int],
                          tuple[PagePool, dict[int, np.ndarray]]] = {}
        self._tables: dict[str, PageTable] = {}
        self._tuner: "KVTuner | None" = None
        self._fixed = self._normalize(layout, page_size)

    # -- geometry ---------------------------------------------------------------
    def _normalize(self, layout: str, page_size: int | None) -> tuple[str, int]:
        if layout == "contig":
            return ("contig", self.max_len)
        if layout == "paged":
            if page_size is None or page_size <= 0:
                raise ValueError(f"paged layout needs a positive page size, "
                                 f"got {page_size}")
            return ("paged", int(page_size))
        raise ValueError(f"unknown layout {layout!r}; "
                         f"have ['paged', 'contig']")

    def set_geometry(self, layout: str, page_size: int | None = None) -> None:
        """Pin the geometry for *future* joins (in-flight requests keep
        the geometry they were admitted under)."""
        self._fixed = self._normalize(layout, page_size)

    def bind_tuner(self, tuner: "KVTuner") -> None:
        self._tuner = tuner

    def active_geometry(self) -> tuple[str, int]:
        if self._tuner is not None:
            layout, page = self._tuner.active_plan()
            try:
                return self._normalize(layout, page)
            except ValueError:
                logger.warning("tuned kv plan (%r, %r) invalid; "
                               "using fixed geometry", layout, page)
        return self._fixed

    def _geo_pools(self, geo: tuple[str, int]) \
            -> tuple[PagePool, dict[int, np.ndarray]]:
        entry = self._pools.get(geo)
        if entry is None:
            _, page_size = geo
            num_pages = max(1, math.ceil(self.capacity_tokens / page_size))
            pools = {
                i: np.zeros((num_pages, page_size)
                            + self._leaves[i].token_shape,
                            self._leaves[i].dtype)
                for i in self._paged_idx}
            entry = (PagePool(num_pages, page_size), pools)
            self._pools[geo] = entry
        return entry

    # -- request lifecycle ------------------------------------------------------
    def join(self, rid: str) -> PageTable:
        """Admit a request under the active geometry; pages are allocated
        lazily as tokens are written."""
        if rid in self._tables:
            raise PageError(f"request {rid!r} already live")
        geo = self.active_geometry()
        self._geo_pools(geo)           # materialize the pool up front
        table = PageTable(rid=rid, geometry=geo,
                          row_state=[self._leaves[i].template_row.copy()
                                     for i in self._row_idx])
        self._tables[rid] = table
        return table

    def retire(self, rid: str) -> int:
        """Free a request's pages back to its geometry's pool.  Returns
        the number of pages released."""
        table = self._tables.pop(rid, None)
        if table is None:
            raise PageError(f"request {rid!r} is not live")
        pool, _ = self._geo_pools(table.geometry)
        for pid in table.pages:
            pool.free(pid)
        return len(table.pages)

    def length(self, rid: str) -> int:
        return self._tables[rid].length

    def table(self, rid: str) -> PageTable:
        """The live request's page table (KeyError when not live)."""
        return self._tables[rid]

    def live_requests(self) -> list[str]:
        return list(self._tables)

    def can_fit(self, n_tokens: int, rid: str | None = None) -> bool:
        """Whether ``n_tokens`` more tokens fit — for a live request
        (``rid``), in its own geometry's pool; otherwise for a fresh
        request under the active geometry."""
        if rid is not None and rid in self._tables:
            table = self._tables[rid]
            geo = table.geometry
            have = len(table.pages) * geo[1] - table.length
        else:
            geo = self.active_geometry()
            have = 0
        if n_tokens <= have:
            return True
        pool, _ = self._geo_pools(geo)
        need = math.ceil((n_tokens - have) / geo[1])
        return need <= pool.free_pages

    # -- step I/O ---------------------------------------------------------------
    def materialize(self, rids: Sequence[str], batch: int) \
            -> tuple[Any, np.ndarray]:
        """Assemble a dense device cache for one step.

        Rows ``0..len(rids)`` hold those requests' paged tokens and row
        state; rows beyond are padding (template-initial).  Returns
        ``(cache pytree, lengths)`` where ``lengths[i]`` is request i's
        token count — the executor passes it as the per-row write
        position vector.
        """
        if len(rids) > batch:
            raise ValueError(f"{len(rids)} requests do not fit in "
                             f"batch {batch}")
        tables = [self._tables[r] for r in rids]
        out_leaves = []
        for i, spec in enumerate(self._leaves):
            if spec.kind == _SHARED:
                out_leaves.append(self._upload(spec.template_value.copy()))
                continue
            shape = list(spec.shape)
            shape[spec.bat_i] = batch
            staging = np.zeros(tuple(shape), spec.dtype)
            view = _moved(staging, spec.bat_i, spec.seq_i)
            if spec.kind == _ROW:
                view[:] = spec.template_row
                for r, table in enumerate(tables):
                    view[r] = table.row_state[self._row_idx.index(i)]
            else:
                for r, table in enumerate(tables):
                    pool_arr = self._geo_pools(table.geometry)[1][i]
                    ps = table.page_size
                    for j, pid in enumerate(table.pages):
                        a = j * ps
                        n = min(ps, table.length - a)
                        if n <= 0:
                            break
                        view[r, a:a + n] = pool_arr[pid, :n]
            out_leaves.append(self._upload(staging))
        cache = compat.tree_unflatten(self._treedef, out_leaves)
        lengths = np.array([t.length for t in tables]
                           + [0] * (batch - len(tables)), np.int32)
        return cache, lengths

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(host).to(self.device)

    def harvest(self, rids: Sequence[str], new_cache: Any,
                n_new: Sequence[int]) -> None:
        """Copy each request's newly written slots back into its pages.

        Request i wrote ``n_new[i]`` tokens at slots
        ``[length, length + n_new[i])`` of row i.  Pages are allocated on
        demand; the whole-batch page demand is checked *before* any
        mutation, so a capacity failure raises :class:`PageError` without
        corrupting any request's state.
        """
        new_leaves, _ = compat.tree_flatten(new_cache)
        if len(new_leaves) != len(self._leaves):
            raise ValueError("new_cache structure does not match template")
        tables = [self._tables[r] for r in rids]
        # pre-check page demand per geometry pool
        demand: dict[tuple[str, int], int] = {}
        for table, n in zip(tables, n_new):
            n = int(n)
            if n == 0:
                continue
            end = table.length + n
            if end > self.max_len:
                raise PageError(f"request {table.rid!r} would exceed "
                                f"max_len {self.max_len} ({end} tokens)")
            need = math.ceil(end / table.page_size) - len(table.pages)
            if need > 0:
                demand[table.geometry] = demand.get(table.geometry, 0) + need
        for geo, need in demand.items():
            pool, _ = self._geo_pools(geo)
            if need > pool.free_pages:
                raise PageError(
                    f"geometry {geo} needs {need} pages but only "
                    f"{pool.free_pages} free")
        # host copies of the written spans (sliced on the device, per row)
        for r, (table, n) in enumerate(zip(tables, n_new)):
            n = int(n)
            # row state is O(1)-sized: refresh it every step regardless
            for k, i in enumerate(self._row_idx):
                spec = self._leaves[i]
                moved = _moved_view(new_leaves[i], spec.bat_i, None)
                table.row_state[k] = _to_host(moved[r]).copy()
            if n == 0:
                continue
            pool, pools = self._geo_pools(table.geometry)
            ps = table.page_size
            start = table.length
            while len(table.pages) * ps < start + n:
                table.pages.append(pool.alloc())
            for i in self._paged_idx:
                spec = self._leaves[i]
                moved = _moved_view(new_leaves[i], spec.bat_i, spec.seq_i)
                span = _to_host(moved[r, start:start + n])
                for off in range(0, n, ps):
                    slot = start + off
                    j, a = divmod(slot, ps)
                    m = min(ps - a, n - off)
                    pools[i][table.pages[j], a:a + m] = span[off:off + m]
            table.length = start + n

    # -- reporting --------------------------------------------------------------
    def stats(self) -> dict:
        geos = {}
        for geo, (pool, _) in self._pools.items():
            geos[f"{geo[0]}@{geo[1]}"] = {
                "num_pages": pool.num_pages,
                "live_pages": pool.live_pages,
                "free_pages": pool.free_pages,
                "allocs": pool.allocs,
                "frees": pool.frees,
                "high_water": pool.high_water,
            }
        return {
            "live_requests": len(self._tables),
            "active_geometry": list(self.active_geometry()),
            "pools": geos,
        }


def _to_host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _moved_view(leaf: torch.Tensor, bat_i: int, seq_i: int | None):
    """Moved-layout view of a tensor where it lies (it stays on its
    device, so slicing it before the host copy moves only the slice)."""
    if seq_i is None:
        return torch.movedim(leaf, bat_i, 0)
    return torch.movedim(leaf, (bat_i, seq_i), (0, 1))


# -- geometry as a specialization point -----------------------------------------

def kv_plan_builder(layouts: Sequence[str], page_sizes: Sequence[int],
                    default_layout: str, default_page: int) -> Callable:
    """Handler builder declaring the KV geometry as enum spec points.

    Like :func:`repro_torch.serve.batcher.bucket_plan_builder`, the traced body
    is the identity — registering the *choice* as a handler buys the
    Controller's search, spec_state persistence, and warm restore for
    free.
    """
    layout_choices = tuple(layouts)
    page_choices = tuple(int(p) for p in page_sizes)

    def builder(spec):
        spec.enum(KV_LAYOUT_POINT, default_layout, layout_choices,
                  guarded=False)
        spec.enum(KV_PAGE_POINT, default_page, page_choices, guarded=False)

        def plan(tick):
            return tick

        return plan

    return builder


class KVTuner:
    """Tunes the KV geometry online with a Controller.

    Registers a ``kv_plan`` handler on ``runtime`` whose spec points are
    the layout and page-size enums, and drives it with a
    :class:`~repro_torch.core.controller.Controller` whose metric is served
    goodput (the same read-and-reset window the bucket tuner observes).
    The candidate list enumerates ``contig`` once plus ``paged`` at each
    page size — the engine calls :meth:`step` once per non-idle
    iteration, and the manager reads :meth:`active_plan` at each join.
    """

    def __init__(self, kv: PagedKV, runtime=None,
                 metric: Callable[[], float] = lambda: 0.0,
                 dwell: int = 25,
                 name: str = "kv_plan",
                 page_sizes: Sequence[int] = (8, 16, 64),
                 include_contig: bool = True,
                 policy: "Callable | None" = None,
                 change_detector=None,
                 initial_plan: "tuple[str, int] | None" = None,
                 wait_compiles: bool = False,
                 plan_handler=None):
        from repro_torch.core.controller import Controller
        from repro_torch.core.metrics import ChangeDetector
        from repro_torch.core.policy import ExhaustiveSweep
        from repro_torch.core.runtime import DEFAULT_CONTEXT

        self.kv = kv
        self.metric = metric
        page_sizes = tuple(sorted({int(p) for p in page_sizes}))
        if not page_sizes:
            raise ValueError("page_sizes must be non-empty")
        layouts = ("paged", "contig") if include_contig else ("paged",)
        self._default_page = page_sizes[0]
        if plan_handler is None:
            if runtime is None:
                raise ValueError("KVTuner needs a runtime (to register the "
                                 "plan handler) or a plan_handler")
            plan_handler = runtime.register(
                name, kv_plan_builder(layouts, page_sizes, layouts[0],
                                      self._default_page))
        self.handler = plan_handler
        candidates = [{KV_LAYOUT_POINT: "paged", KV_PAGE_POINT: p}
                      for p in page_sizes]
        if include_contig:
            candidates.append({KV_LAYOUT_POINT: "contig"})
        initial_configs = None
        if initial_plan is not None:
            layout, page = initial_plan
            if layout not in layouts or (layout == "paged"
                                         and page not in page_sizes):
                logger.warning("restored kv plan %r unknown; "
                               "exploring fresh", initial_plan)
            else:
                cfg = {KV_LAYOUT_POINT: layout}
                if layout == "paged":
                    cfg[KV_PAGE_POINT] = int(page)
                initial_configs = {DEFAULT_CONTEXT: cfg}
        self.controller = Controller(
            self.handler,
            policy if policy is not None
            else (lambda: ExhaustiveSweep(candidates)),
            metric=lambda view: self.metric(),
            dwell=dwell,
            change_detector=(change_detector if change_detector is not None
                             else (lambda: ChangeDetector(0.5))),
            wait_compiles=wait_compiles,
            prefetch=0,
            initial_configs=initial_configs)
        self._tick = 0              # the plan handler's (ignored) argument
        kv.bind_tuner(self)

    def active_plan(self) -> tuple[str, int]:
        cfg = self.handler.active_config()
        layout = cfg.get(KV_LAYOUT_POINT, "paged")
        page = cfg.get(KV_PAGE_POINT, self._default_page)
        return layout, page

    def step(self) -> None:
        self.handler(self._tick)
        self.controller.step()

    def settled(self) -> bool:
        return self.controller.settled()

    def best_plan(self) -> "tuple[str, int] | None":
        cfg, _ = self.controller.best()
        if cfg is None:
            return None
        return (cfg.get(KV_LAYOUT_POINT, "paged"),
                cfg.get(KV_PAGE_POINT, self._default_page))

    def status(self) -> dict:
        return {"active": list(self.active_plan()),
                "best": list(self.best_plan() or ()),
                "settled": self.settled(),
                "stats": self.kv.stats()}
