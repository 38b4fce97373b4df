"""SpecPlane: shared specialization state across serving replicas.

A fleet of replicas each running its own :class:`~repro_torch.core.controller.
Controller` would re-pay the full exploration cost N times — the plane
amortizes it.  Replicas **publish** per-context settled winners (context
key, config, goodput evidence, epoch) as one-record files in a shared
directory; every record is written atomically
(:func:`~repro_torch.checkpoint.store.save_plane_record`: mkstemp +
``os.replace``), so a subscriber polling mid-publish never reads a torn
record.  Replicas **subscribe** by polling the directory: conflicting
records for the same (handler, context) resolve freshest-wins (highest
epoch — a Lamport-style counter each publisher advances past the highest
epoch it has seen for that context), tie-broken by goodput evidence and
finally by replica id, so every subscriber converges on the same winner.

A resolved winner is applied through the existing warm-start path:
``handler.seed_spec_state(encoded_key, config)``.  The Controller's
``_admit`` then sees a seeded config and starts the context directly in
EXPLOIT — and when the fleet also shares a portable variant cache
(``VariantCache(portable=True)``), activating the seeded config is a
cache hit, not a compile: replicas 2..N warm-start compile-free off
replica 1's exploration.
"""
from __future__ import annotations

import hashlib
import logging
import os
import time
from typing import Any, Callable, Mapping

from repro_torch.checkpoint.store import load_plane_record, save_plane_record
from repro_torch.core import telemetry
from repro_torch.core.runtime import decode_context_key, encode_context_key

logger = logging.getLogger("repro_torch.serve.fleet.plane")

__all__ = ["SpecPlane"]


def _slug(handler: str, enc_context: str) -> str:
    """Filesystem-safe digest of (handler, encoded context)."""
    h = hashlib.sha256(f"{handler}\x00{enc_context}".encode()).hexdigest()
    return h[:16]


class SpecPlane:
    """One replica's handle on the shared plane directory.

    ``publish`` writes this replica's settled winner for one (handler,
    context); ``poll`` scans every record on the plane, resolves
    conflicts, and (given a runtime) seeds the winners onto the local
    handlers.  Both sides are crash-tolerant by construction: corrupt,
    truncated, or unknown-version records are ignored
    (:func:`~repro_torch.checkpoint.store.load_plane_record` returns ``None``),
    never fatal.
    """

    def __init__(self, directory: str, replica: str,
                 clock: Callable[[], float] = time.time,
                 quarantine=None):
        self.directory = directory
        self.replica = str(replica)
        self.clock = clock
        #: optional :class:`~repro_torch.core.safety.Quarantine` registry.  When
        #: set, records published here carry this replica's quarantine
        #: lists and ``poll`` absorbs remote ones — a config that regressed
        #: live traffic on one replica is never re-explored anywhere.
        self.quarantine = quarantine
        os.makedirs(directory, exist_ok=True)
        #: highest epoch seen per (handler, encoded context) — publishers
        #: advance past it so a re-publish supersedes every record seen
        self._epochs: dict[tuple[str, str], int] = {}
        #: resolution key of the record last seeded per (handler, context)
        #: (idempotence: the same winner is never re-seeded)
        self._applied: dict[tuple[str, str], tuple] = {}
        #: config last published per (handler, context) — an unchanged
        #: winner is not re-published (no epoch churn on every interval)
        self._published: dict[tuple[str, str], tuple] = {}
        #: quarantine fingerprint last published per (handler, context) —
        #: a grown quarantine forces a re-publish even if the winner is
        #: unchanged, so the fleet learns about new quarantines promptly
        self._published_quar: dict[tuple[str, str], frozenset] = {}

    # -- publishing ------------------------------------------------------------
    def _path(self, handler: str, enc: str) -> str:
        # One file per (handler, context, replica): a replica's re-publish
        # atomically replaces its own record instead of accumulating.
        return os.path.join(self.directory,
                            f"{_slug(handler, enc)}__{self.replica}.json")

    def publish(self, handler: str, context: Any, config: Mapping,
                goodput: float, *, epoch: int | None = None,
                t: float | None = None,
                quarantined: "list | None" = None) -> str:
        """Publish this replica's settled winner for one context.

        ``context`` is the raw context key (it is canonicalized via
        :func:`~repro_torch.core.runtime.encode_context_key`).  ``epoch``
        defaults to one past the highest epoch this replica has seen for
        the pair — publish-after-poll therefore always supersedes.
        ``quarantined`` defaults to this replica's quarantine list for the
        context (when a registry is attached).  Returns the record path.
        """
        enc = encode_context_key(context)
        pair = (handler, enc)
        if epoch is None:
            epoch = self._epochs.get(pair, 0) + 1
        self._epochs[pair] = max(self._epochs.get(pair, 0), epoch)
        if quarantined is None and self.quarantine is not None:
            quarantined = self.quarantine.configs(handler, context)
        path = self._path(handler, enc)
        save_plane_record(path, handler=handler, context=enc,
                          config=dict(config), goodput=goodput, epoch=epoch,
                          replica=self.replica,
                          t=self.clock() if t is None else t,
                          quarantined=quarantined)
        _tb = telemetry.bus()
        if _tb is not None:
            _tb.emit("plane.publish", track=enc, handler=handler,
                     config=repr(dict(config)), goodput=goodput,
                     epoch=epoch, replica_id=self.replica,
                     quarantined=len(quarantined or []))
        return path

    def publish_controller(self, handler_name: str, controller,
                           goodput_fn: Callable[[], float] | None = None
                           ) -> int:
        """Publish every settled winner of a Controller
        (:meth:`~repro_torch.core.controller.Controller.settled_winners`); the
        evidence is the controller's per-context metric unless
        ``goodput_fn`` supplies an engine-level goodput reading.
        Controllers exposing ``quarantined_configs()`` (the
        :class:`~repro_torch.core.safety.SafetyController`) get their quarantine
        lists attached to each record — and a *grown* quarantine triggers
        a re-publish even when the winner itself is unchanged.  Returns
        the number of records written."""
        from repro_torch.core.points import config_key
        quar_fn = getattr(controller, "quarantined_configs", None)
        by_ctx = quar_fn() if callable(quar_fn) else {}
        n = 0
        for key, (cfg, metric) in controller.settled_winners().items():
            pair = (handler_name, encode_context_key(key))
            quar = by_ctx.get(key, [])
            quar_fp = frozenset(config_key(c) for c in quar)
            if self._published.get(pair) == config_key(cfg) and \
                    self._published_quar.get(pair, frozenset()) == quar_fp:
                continue                  # unchanged winner: no epoch churn
            evidence = goodput_fn() if goodput_fn is not None else metric
            self.publish(handler_name, key, cfg, evidence, quarantined=quar)
            self._published[pair] = config_key(cfg)
            self._published_quar[pair] = quar_fp
            n += 1
        return n

    # -- subscribing -----------------------------------------------------------
    @staticmethod
    def _rank(record: Mapping) -> tuple:
        # Freshest-wins: epoch is the logical clock; goodput evidence
        # breaks epoch ties (the better-performing winner spreads);
        # replica id makes full ties deterministic fleet-wide.
        return (record["epoch"], record["goodput"], record["replica"])

    def resolve(self) -> dict[tuple[str, str], dict]:
        """Scan the plane and return the winning record per
        (handler, encoded context key)."""
        winners: dict[tuple[str, str], dict] = {}
        try:
            names = sorted(os.listdir(self.directory))
        except OSError as e:
            logger.warning("spec plane %s unreadable (%s)",
                           self.directory, e)
            return winners
        for name in names:
            if not name.endswith(".json"):
                continue                  # in-flight temp files etc.
            record = load_plane_record(os.path.join(self.directory, name))
            if record is None:
                continue                  # corrupt/unknown: ignored
            pair = (record["handler"], record["context"])
            self._epochs[pair] = max(self._epochs.get(pair, 0),
                                     record["epoch"])
            self._absorb_quarantine(record)
            cur = winners.get(pair)
            if cur is None or self._rank(record) > self._rank(cur):
                winners[pair] = record
        return winners

    def _absorb_quarantine(self, record: Mapping) -> None:
        # Quarantine is a monotone union across the fleet: every record's
        # list is absorbed (not just the winner's), so a config rolled
        # back anywhere is blocked everywhere.
        if self.quarantine is None or not record.get("quarantined"):
            return
        try:
            key = decode_context_key(record["context"])
        except Exception:
            return
        for cfg in record["quarantined"]:
            if self.quarantine.add(record["handler"], key, cfg):
                logger.info("plane: absorbed quarantine of %r for %s/%s "
                            "from replica %s", cfg, record["handler"],
                            record["context"], record["replica"])

    def poll(self, runtime=None) -> dict[tuple[str, str], dict]:
        """Resolve the plane; with a runtime, seed every remote winner
        onto its local handler via ``handler.seed_spec_state`` (the
        Controller warm-starts the context in EXPLOIT when its traffic
        materializes).  Already-applied winners and this replica's own
        records are skipped.  Returns the resolved winners."""
        winners = self.resolve()
        if runtime is None:
            return winners
        for (handler_name, enc), record in winners.items():
            if record["replica"] == self.replica:
                continue                  # our own state: already live
            if self._applied.get((handler_name, enc)) == self._rank(record):
                continue
            handler = runtime.handlers.get(handler_name)
            if handler is None:
                continue
            if self.quarantine is not None and self.quarantine.blocked(
                    handler_name, decode_context_key(enc),
                    record["config"]):
                # A winner another replica published *before* the config
                # was quarantined must not warm-start here.
                continue
            # Best-effort like every restore path: a stale config from a
            # replica running older code must not take this one down.
            try:
                handler.seed_spec_state(enc, dict(record["config"]))
            except Exception as e:
                logger.warning(
                    "plane seed for %s/%s from %s invalid (%s: %s); ignored",
                    handler_name, enc, record["replica"],
                    type(e).__name__, e)
                continue
            self._applied[(handler_name, enc)] = self._rank(record)
            _tb = telemetry.bus()
            if _tb is not None:
                _tb.emit("plane.resolve", track=enc, handler=handler_name,
                         config=repr(dict(record["config"])),
                         source=record["replica"], epoch=record["epoch"],
                         goodput=record["goodput"])
            logger.info("plane: seeded %s/%s from replica %s (epoch %d, "
                        "goodput %.3f)", handler_name, enc,
                        record["replica"], record["epoch"],
                        record["goodput"])
        return winners

    # -- garbage collection ------------------------------------------------------
    def gc(self, max_age_s: float,
           active: "set[tuple[str, str]] | None" = None) -> int:
        """Remove stale records so a long-lived plane directory does not
        grow without bound.

        Two kinds of records are reclaimed, both only once older than
        ``max_age_s``: records *superseded* by a higher-ranked record for
        the same (handler, context) pair, and this replica's *own* records
        for contexts no longer in ``active`` (a set of
        ``(handler, encoded_context)`` pairs) — retired workloads.  Only
        our own records are retired by context: another replica may still
        be serving a context we are not, and its records are its own to
        reclaim.  The current winner of a still-active pair is never
        removed.  Returns the number of records deleted.
        """
        now = self.clock()
        try:
            names = sorted(os.listdir(self.directory))
        except OSError as e:
            logger.warning("spec plane %s unreadable (%s)",
                           self.directory, e)
            return 0
        records: list[tuple[str, dict]] = []
        for name in names:
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.directory, name)
            record = load_plane_record(path)
            if record is not None:
                records.append((path, record))
        winners: dict[tuple[str, str], str] = {}
        best: dict[tuple[str, str], tuple] = {}
        for path, record in records:
            pair = (record["handler"], record["context"])
            rank = self._rank(record)
            if pair not in best or rank > best[pair]:
                best[pair] = rank
                winners[pair] = path
        removed = 0
        for path, record in records:
            if now - record["t"] < max_age_s:
                continue
            pair = (record["handler"], record["context"])
            superseded = winners.get(pair) != path
            retired = (active is not None and pair not in active
                       and record["replica"] == self.replica)
            if not (superseded or retired):
                continue
            try:
                os.remove(path)
            except OSError:
                continue
            removed += 1
            if retired and not superseded:
                self._published.pop(pair, None)
                self._published_quar.pop(pair, None)
        if removed:
            logger.info("plane gc: removed %d stale record(s)", removed)
            _tb = telemetry.bus()
            if _tb is not None:
                _tb.emit("plane.gc", removed=removed,
                         remaining=len(records) - removed)
        return removed
