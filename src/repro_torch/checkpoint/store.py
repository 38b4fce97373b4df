"""Checkpointing: async, atomic, keep-k, and the specialization state.

The port of ``repro.checkpoint.store``.  Layout:
``<dir>/step_<n>/shard_<process>.npz`` + ``meta.json``.  Saves run on a
background thread (off the critical path, like the runtime's builds);
directories become visible via atomic rename, so a crash mid-save never
corrupts the latest checkpoint.  Leaves are stored as host numpy arrays
under the reference's ``"/"``-joined tree paths (dict keys sorted, list
and tuple positions by index), so a checkpoint written by the JAX package
restores into the port's parameter tree, and the reverse.  numpy has no
bfloat16: a bf16 tensor is written widened to fp32, and ``restore`` casts
every leaf to its template leaf's dtype and device.  A DTensor leaf is
written whole (gathered from its shards), and ``restore(axes=...)`` under
an active mesh places each leaf on the *current* mesh by its logical
axes: elastic re-sharding from any saved layout.

Specialization state also persists here: the checkpoint directory carries
a ``variants/`` subdirectory (the runtime's persistent
:class:`~repro_torch.core.variant_cache.VariantCache` of built kernel
libraries) and a ``spec_state.json`` (active configuration per handler
and context, plus the safety plane's last-known-good and quarantined
configs), so a restarted job reaches its tuned configs with zero
``nvcc`` calls.  The file format is the reference's, so either package
reads the other's files; the fleet's spec-plane records live here too.
"""
from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch import compat
from repro_torch.distributed.sharding import (current_mesh, replicate,
                                              spec_for_axes)

logger = logging.getLogger("repro_torch.checkpoint.store")

__all__ = ["CheckpointManager", "save_spec_state", "restore_spec_state",
           "load_safety_state", "SPEC_STATE_VERSION", "PLANE_RECORD_VERSION",
           "save_plane_record", "load_plane_record"]


# -- specialization-state persistence ------------------------------------------

def _encode_config(cfg: dict) -> dict:
    from repro_torch.core.points import DISABLED
    out: dict[str, Any] = {}
    for k, v in cfg.items():
        if v is DISABLED:
            out[k] = {"__disabled__": True}
        elif isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            # Non-JSON payloads (arrays, callables) are recorded for
            # debugging but not restored.
            out[k] = {"__repr__": repr(v)}
    return out


def _decode_config(cfg: dict) -> dict:
    from repro_torch.core.points import DISABLED
    out: dict[str, Any] = {}
    for k, v in cfg.items():
        if isinstance(v, dict):
            if v.get("__disabled__"):
                out[k] = DISABLED
            continue                    # unrestorable payload: skip
        out[k] = v
    return out


def _parse_safety_entry(entry: dict) -> dict:
    """Decode one handler's v3 safety fields, normalizing context keys
    through decode -> re-encode like the contexts themselves.  Malformed
    pieces are dropped, never raised — safety metadata is advisory on read
    and must not take a restore down."""
    from repro_torch.core.runtime import decode_context_key, encode_context_key

    lkg: dict[str, dict] = {}
    quar: dict[str, list] = {}
    raw_lkg = entry.get("last_known_good")
    if isinstance(raw_lkg, dict):
        for enc, cfg in raw_lkg.items():
            if not isinstance(cfg, dict):
                continue
            try:
                enc = encode_context_key(decode_context_key(enc))
                lkg[enc] = _decode_config(cfg)
            except Exception:
                continue
    raw_quar = entry.get("quarantined")
    if isinstance(raw_quar, dict):
        for enc, cfgs in raw_quar.items():
            if not isinstance(cfgs, list):
                continue
            try:
                enc = encode_context_key(decode_context_key(enc))
            except Exception:
                continue
            decoded = [_decode_config(c) for c in cfgs if isinstance(c, dict)]
            if decoded:
                quar[enc] = decoded
    return {"last_known_good": lkg, "quarantined": quar}


#: spec_state.json format version.  v3 adds optional per-handler safety
#: state on top of the v2 per-context layout:
#: ``{"version": 3, "handlers": {name: {"contexts": {encoded_key: cfg},
#:    "last_known_good": {encoded_key: cfg},
#:    "quarantined": {encoded_key: [cfg, ...]}}}}``.
#: v2 (no safety fields) and the v1 flat format ``{name: cfg}`` (one global
#: config per handler, mapped onto the default context) are still read.
SPEC_STATE_VERSION = 3


def save_spec_state(path: str, runtime: Any,
                    keep: "Any | None" = None,
                    safety: "dict | None" = None) -> None:
    """Persist each handler's active configuration per context
    (atomic write, versioned format).

    ``keep(handler_name, encoded_context_key) -> bool`` filters what is
    persisted — the serve engine passes the per-context *settled* predicate
    so a context still mid-sweep never writes its candidate config as the
    next restart's "winner", while every settled context's tuned config is
    saved regardless.

    ``safety`` is the optional per-handler safety state —
    ``{handler: {"last_known_good": {enc_key: cfg},
    "quarantined": {enc_key: [cfg, ...]}}}`` as produced by
    :meth:`~repro_torch.core.safety.SafetyController.safety_state` — persisted so
    a restart neither re-trusts a config that was rolled back nor
    re-explores one that was quarantined.
    """
    safety = safety or {}
    handlers = {}
    for name, ctx_cfgs in runtime.spec_state().items():
        entry: dict[str, Any] = {"contexts": {
            enc: _encode_config(cfg) for enc, cfg in ctx_cfgs.items()
            if keep is None or keep(name, enc)}}
        safe = safety.get(name)
        if isinstance(safe, dict):
            lkg = safe.get("last_known_good") or {}
            quar = safe.get("quarantined") or {}
            if lkg:
                entry["last_known_good"] = {
                    enc: _encode_config(cfg) for enc, cfg in lkg.items()}
            if quar:
                entry["quarantined"] = {
                    enc: [_encode_config(c) for c in cfgs]
                    for enc, cfgs in quar.items()}
        handlers[name] = entry
    state = {"version": SPEC_STATE_VERSION, "handlers": handlers}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".tmp_spec_")
    with os.fdopen(fd, "w") as f:
        json.dump(state, f, indent=1)
    os.replace(tmp, path)


def restore_spec_state(path: str, runtime: Any, wait: bool = False) -> bool:
    """Re-apply persisted per-handler, per-context configurations;
    best-effort.

    The default context's config is applied immediately; configs for other
    workload contexts are *seeded* onto the handler and applied the moment
    traffic first materializes each context (contexts are created by
    dispatch, so they do not exist yet at restore time).  The legacy flat
    format (one config per handler, no version field) still loads — it
    targets the default context.  Combined with a warm variant cache this
    brings every handler back to its tuned configs with zero recompiles.
    Returns True if any state was applied or seeded.
    """
    from repro_torch.core.points import config_key
    from repro_torch.core.runtime import (DEFAULT_CONTEXT,
                                          decode_context_key,
                                          encode_context_key)

    if not os.path.exists(path):
        return False
    try:
        with open(path) as f:
            state = json.load(f)
    except (OSError, ValueError) as e:
        logger.warning("spec state %s unreadable (%s); starting generic",
                       path, e)
        return False
    version = state.get("version") if isinstance(state, dict) else None
    per_safety: dict[str, dict] = {}
    if version in (2, 3):
        handlers = state.get("handlers")
        handlers = handlers if isinstance(handlers, dict) else {}
        per_handler = {}
        for name, entry in handlers.items():
            ctxs = entry.get("contexts") if isinstance(entry, dict) else None
            per_handler[name] = ctxs if isinstance(ctxs, dict) else {}
            if version == 3 and isinstance(entry, dict):
                per_safety[name] = _parse_safety_entry(entry)
    elif version is None and isinstance(state, dict):
        # v1 flat format (no version field): {handler: config} -> the
        # default context.
        per_handler = {
            name: {encode_context_key(DEFAULT_CONTEXT): cfg}
            for name, cfg in state.items() if isinstance(cfg, dict)}
    else:
        # A version we don't know (newer writer, or a corrupted field):
        # misparsing it as v1 would silently drop every tuned config.
        logger.warning("spec state %s has unsupported version %r; "
                       "starting generic", path, version)
        return False
    default_enc = encode_context_key(DEFAULT_CONTEXT)
    applied = False
    for name, ctx_cfgs in per_handler.items():
        handler = runtime.handlers.get(name)
        if handler is None:
            continue
        if not isinstance(ctx_cfgs, dict):
            logger.warning("spec state for handler %r malformed; "
                           "keeping generic", name)
            continue
        safe = per_safety.get(name) or {}
        lkg_map = safe.get("last_known_good") or {}
        quar_map = safe.get("quarantined") or {}
        for enc_key, cfg in ctx_cfgs.items():
            # Normalize the stored encoding through decode -> re-encode:
            # files written by the legacy repr encoder ("('prefill', 4)")
            # land on the same canonical string the live context's key
            # produces, so their seeds still apply.
            enc_key = encode_context_key(decode_context_key(enc_key))
            # Best-effort by contract: a stale or malformed config (points
            # renamed, builder changed, cross-host payloads, truncated
            # file) must degrade to the generic variant, never crash
            # startup.
            try:
                if not isinstance(cfg, dict):
                    raise TypeError(f"config is {type(cfg).__name__}, "
                                    f"not a dict")
                decoded = _decode_config(cfg)
                blocked = {config_key(c) for c in quar_map.get(enc_key, ())}
                if blocked and config_key(decoded) in blocked:
                    # A quarantined config is NEVER restored — a process
                    # that crashed right after a rollback must not resume
                    # on the config that caused it.  Fall back to the
                    # recorded last-known-good, else stay generic.
                    fallback = lkg_map.get(enc_key)
                    if fallback is not None and \
                            config_key(fallback) not in blocked:
                        decoded = dict(fallback)
                    else:
                        logger.warning(
                            "spec state for handler %r context %s is "
                            "quarantined with no last-known-good; "
                            "keeping generic", name, enc_key)
                        continue
                if handler.stale(decoded, decode_context_key(enc_key)):
                    continue                   # logged and counted there
                if enc_key == default_enc:
                    handler.specialize(decoded, wait=wait)
                else:
                    handler.seed_spec_state(enc_key, decoded)
                applied = True
            except Exception as e:
                logger.warning("spec state for handler %r context %s no "
                               "longer valid (%s: %s); keeping generic",
                               name, enc_key, type(e).__name__, e)
    return applied


def load_safety_state(path: str) -> dict:
    """Read the per-handler safety state (last-known-good + quarantined)
    from a ``spec_state.json``.

    Returns ``{handler: {"last_known_good": {enc_key: cfg},
    "quarantined": {enc_key: [cfg, ...]}}}`` with decoded configs —
    the shape :class:`~repro_torch.core.safety.SafetyController` accepts for warm
    initialization.  v1/v2 files (no safety fields), missing files, and
    unreadable files all yield ``{}``: safety state is an additive v3
    feature and its absence is never an error.
    """
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            state = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(state, dict) or state.get("version") != 3:
        return {}
    handlers = state.get("handlers")
    if not isinstance(handlers, dict):
        return {}
    out = {}
    for name, entry in handlers.items():
        if not isinstance(entry, dict):
            continue
        safe = _parse_safety_entry(entry)
        if safe["last_known_good"] or safe["quarantined"]:
            out[name] = safe
    return out


# -- fleet spec-plane records ---------------------------------------------------

#: Spec-plane record format version (versioned like ``spec_state`` v2: an
#: unknown version is refused, never misparsed).  One record = one
#: replica's settled winner for one (handler, context):
#: ``{"version": 1, "handler": name, "context": encoded_key,
#:    "config": encoded_cfg, "goodput": float, "epoch": int,
#:    "replica": str, "t": wall_clock_s}``.
PLANE_RECORD_VERSION = 1


def save_plane_record(path: str, *, handler: str, context: str, config: dict,
                      goodput: float, epoch: int, replica: str,
                      t: float, quarantined: "list | None" = None) -> None:
    """Atomically publish one spec-plane record (same mkstemp +
    ``os.replace`` discipline as :func:`save_spec_state`: a subscriber
    polling the shared directory never observes a torn write).

    ``quarantined`` optionally lists configs this replica has quarantined
    for the record's context — an additive field (version stays 1; old
    readers ignore it) that lets other replicas skip configs already proven
    to regress live traffic somewhere in the fleet.
    """
    record = {
        "version": PLANE_RECORD_VERSION,
        "handler": str(handler),
        "context": str(context),
        "config": _encode_config(config),
        "goodput": float(goodput),
        "epoch": int(epoch),
        "replica": str(replica),
        "t": float(t),
    }
    if quarantined:
        record["quarantined"] = [_encode_config(c) for c in quarantined]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".tmp_plane_")
    with os.fdopen(fd, "w") as f:
        json.dump(record, f, indent=1)
    os.replace(tmp, path)


def load_plane_record(path: str) -> "dict | None":
    """Read one spec-plane record; ``None`` for anything unusable
    (truncated/corrupt JSON, unknown version, missing fields) — a bad
    record on the shared plane must never take a subscriber down."""
    try:
        with open(path) as f:
            record = json.load(f)
    except (OSError, ValueError) as e:
        logger.warning("plane record %s unreadable (%s); ignoring", path, e)
        return None
    if not isinstance(record, dict) or \
            record.get("version") != PLANE_RECORD_VERSION:
        logger.warning("plane record %s has unsupported version %r; ignoring",
                       path, record.get("version")
                       if isinstance(record, dict) else None)
        return None
    try:
        cfg = record["config"]
        if not isinstance(cfg, dict):
            raise TypeError(f"config is {type(cfg).__name__}, not a dict")
        raw_quar = record.get("quarantined")
        quarantined = ([_decode_config(c) for c in raw_quar
                        if isinstance(c, dict)]
                       if isinstance(raw_quar, list) else [])
        return {
            "handler": str(record["handler"]),
            "context": str(record["context"]),
            "config": _decode_config(cfg),
            "goodput": float(record["goodput"]),
            "epoch": int(record["epoch"]),
            "replica": str(record["replica"]),
            "t": float(record["t"]),
            "quarantined": quarantined,
        }
    except (KeyError, TypeError, ValueError) as e:
        logger.warning("plane record %s malformed (%s: %s); ignoring",
                       path, type(e).__name__, e)
        return None


def _path_key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _leaves_with_paths(tree: Any, path: tuple = ()):
    """``(path, leaf)`` in the reference's order: dict keys sorted, list
    and tuple entries by index; ``None`` is a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def _to_numpy(leaf: Any) -> np.ndarray:
    """The leaf's value as an array of its own: a host tensor is copied, so
    an asynchronous save writes the bytes of the step it was given even
    if a donated step then updates the tensor in place."""
    if isinstance(leaf, torch.Tensor):
        t = replicate(leaf.detach())      # a DTensor's whole value
        if t.dtype is torch.bfloat16:
            t = t.float()                 # numpy has no bfloat16
        a = t.cpu().numpy()
        return a.copy() if t.device.type == "cpu" else a
    return np.array(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {_path_key(path): _to_numpy(leaf)
            for path, leaf in _leaves_with_paths(tree) if leaf is not None}


def _place(arr: torch.Tensor, sharding: Any) -> torch.Tensor:
    """``arr`` (the whole value, on every rank) as a DTensor placed by
    ``sharding`` (``(mesh, placements)``)."""
    from torch.distributed.tensor import distribute_tensor
    mesh, place = sharding
    return distribute_tensor(arr, mesh, list(place))


def _process_index() -> int:
    dist = torch.distributed
    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = (concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt") if async_save else None)
        self._pending: concurrent.futures.Future | None = None

    # -- specialization state ---------------------------------------------------
    @property
    def variant_cache_dir(self) -> str:
        """Canonical location for the persistent variant cache."""
        return os.path.join(self.directory, "variants")

    def variant_cache(self):
        """A :class:`~repro_torch.core.variant_cache.VariantCache` rooted
        next to the checkpoints — pass it to ``IridescentRuntime`` so built
        kernel libraries survive restarts alongside the model state."""
        from repro_torch.core.variant_cache import VariantCache
        return VariantCache(self.variant_cache_dir)

    @property
    def spec_state_path(self) -> str:
        return os.path.join(self.directory, "spec_state.json")

    def save_spec_state(self, runtime: Any) -> None:
        save_spec_state(self.spec_state_path, runtime)

    def restore_spec_state(self, runtime: Any, wait: bool = False) -> bool:
        return restore_spec_state(self.spec_state_path, runtime, wait=wait)

    # -- save ------------------------------------------------------------------
    def _write(self, step: int, flat: dict[str, np.ndarray],
               meta: dict) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, f"shard_{_process_index()}.npz"),
                     **flat)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                      # atomic publish
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, step: int, tree: Any, extra_meta: dict | None = None,
             block: bool = False) -> None:
        """Snapshot ``tree`` at ``step`` (copies to the host, then an async
        write)."""
        self.wait()                       # one in flight at a time
        flat = _flatten(tree)             # copy while the caller waits
        meta = {"step": step, **(extra_meta or {})}
        if self._pool is None or block:
            self._write(step, flat, meta)
        else:
            self._pending = self._pool.submit(self._write, step, flat, meta)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    # -- restore ----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None,
                axes: Any = None) -> tuple[Any, dict]:
        """Restore into the structure of ``template``: each tensor leaf
        lands on its template leaf's device and dtype.

        If ``axes`` (the logical-axes tree of ``template``) is given and a
        mesh is active (:func:`~repro_torch.distributed.sharding.mesh_context`),
        each leaf is placed on the current mesh by
        ``spec_for_axes(axes, template)`` (``distribute_tensor``): elastic
        re-sharding across meshes.  With no mesh ``axes`` changes nothing.
        """
        shardings = None
        if axes is not None and current_mesh() is not None:
            shardings = compat.tree_leaves(
                spec_for_axes(axes, template),
                is_leaf=lambda x: isinstance(x, tuple) or x is None)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, f"shard_{_process_index()}.npz")) as data:
            leaves, placed = [], 0      # placed: the non-None leaves so far
            for path, leaf in _leaves_with_paths(template):
                if leaf is None:
                    leaves.append(None)
                    continue
                arr = data[_path_key(path)]
                if isinstance(leaf, torch.Tensor):
                    arr = torch.from_numpy(np.array(arr)).to(
                        device=leaf.device, dtype=leaf.dtype)
                    if shardings is not None:
                        arr = _place(arr, shardings[placed])
                placed += 1
                leaves.append(arr)
        _, treedef = compat.tree_flatten(template,
                                         is_leaf=lambda x: x is None)
        return compat.tree_unflatten(treedef, leaves), meta
