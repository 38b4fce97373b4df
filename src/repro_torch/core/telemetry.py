"""Specialization flight recorder: a process-wide structured event bus.

Every component of the specialization lifecycle — dispatch, CompileService
builds, Controller decisions, SafetyController transitions, the serve
engine's request lifecycle, and the fleet SpecPlane — emits typed events
onto one process-wide bus.  The bus is a bounded ring ("flight recorder"):
writes never block and never allocate beyond the preallocated slot table;
under backpressure the oldest events are overwritten and counted in
``dropped_events``.  Consumers read the retained tail (:meth:`EventBus
.events`), export it as Perfetto/Chrome-trace JSON
(:func:`export_chrome_trace`), or attach a sink for streaming (the fleet
worker forwards its stream to the front over the stdio protocol).

Hot-path contract
-----------------
The bus is **disabled by default** and the dispatch fast path is never
instrumented: ``telemetry.bus()`` returns ``None`` and every emit site is
guarded by a single ``if bus is not None`` branch on *slow* paths only
(guard miss, canary tick, lifecycle transitions).  The fig11
``dispatch_telemetry_off`` row certifies the fast row is unchanged.

Enabled, the bus is lock-free on emit: a slot index is claimed with an
:class:`~repro_torch.core.metrics.AtomicCounter` ticket (a C-level increment,
atomic under the GIL) and the event dict is stored by reference.  Readers
take a racy-but-consistent snapshot — fine for a flight recorder.

Event shape
-----------
Each event is a plain dict::

    {"name": "safety.rollback",      # dotted taxonomy, see README
     "kind": "instant",              # instant | span | counter
     "ts": 12345.6,                  # µs since the process epoch
     "dur": 88.2,                    # span events only, µs
     "track": "('decode', 8)",       # optional: per-context trace track
     "replica": "2",                 # optional: fleet replica id
     ...payload}                     # event-specific fields
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterable

from .metrics import AtomicCounter

__all__ = [
    "EventBus", "bus", "install", "enable", "disable",
    "export_chrome_trace", "SnapshotWriter", "write_atomic_json",
    "ctx_str", "perf_to_us", "now_us",
]

_EPOCH = time.perf_counter()


def _now_us() -> float:
    return (time.perf_counter() - _EPOCH) * 1e6


def perf_to_us(perf_t: float) -> float:
    """Convert a ``time.perf_counter()`` reading to bus-timebase µs."""
    return (perf_t - _EPOCH) * 1e6


#: public alias: current bus-timebase timestamp in µs
now_us = _now_us


def ctx_str(key: Any) -> str:
    """Stable display form of a context key (tuples survive repr)."""
    return repr(key)


class EventBus:
    """Bounded lock-free ring of structured events plus pluggable sinks.

    ``capacity`` fixes the retained tail; overflow overwrites the oldest
    slot (drop-not-block) and is observable as :meth:`dropped`.  Sinks are
    callables invoked inline on every emit — they must not block (a
    forwarding sink buffers into its own bounded queue).
    """

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._slots: list[dict | None] = [None] * capacity
        self._ticket = AtomicCounter()
        self._sinks: tuple[Callable[[dict], None], ...] = ()

    # -- emit -------------------------------------------------------------
    def emit(self, name: str, kind: str = "instant", *,
             track: Any = None, dur: float | None = None,
             ts: float | None = None, **payload) -> dict:
        ev: dict = {"name": name, "kind": kind,
                    "ts": _now_us() if ts is None else ts}
        if dur is not None:
            ev["dur"] = dur
        if track is not None:
            ev["track"] = track if isinstance(track, str) else ctx_str(track)
        if payload:
            ev.update(payload)
        self._store(ev)
        return ev

    def _store(self, ev: dict) -> None:
        idx = self._ticket.bump()            # lock-free ticket
        self._slots[idx % self.capacity] = ev
        for sink in self._sinks:             # tuple: safe racy iteration
            try:
                sink(ev)
            except Exception:
                pass                         # a broken sink never blocks emit

    def absorb(self, events: Iterable[dict], replica: str | None = None,
               ) -> int:
        """Ingest pre-formed event dicts (the fleet front merging a
        worker's forwarded stream), optionally tagging the replica id."""
        n = 0
        for ev in events:
            if not isinstance(ev, dict) or "name" not in ev:
                continue
            if replica is not None:
                ev = {**ev, "replica": replica}
            self._store(ev)
            n += 1
        return n

    @contextmanager
    def span(self, name: str, *, track: Any = None, **payload):
        """Measure a span; emits one ``kind="span"`` event on exit.

        Yields the payload dict — mutate it inside the block to attach
        results (e.g. ``p["status"] = "done"``)."""
        t0 = time.perf_counter()
        ts = _now_us()
        try:
            yield payload
        finally:
            dur = (time.perf_counter() - t0) * 1e6
            self.emit(name, "span", track=track, dur=dur, ts=ts, **payload)

    # -- read -------------------------------------------------------------
    def emitted(self) -> int:
        return self._ticket.value()

    def dropped(self) -> int:
        """Events overwritten before any reader could retain them."""
        return max(0, self._ticket.value() - self.capacity)

    def events(self) -> list[dict]:
        """Snapshot of the retained tail, oldest first.

        Racy by design: events emitted concurrently with the read may or
        may not appear; the returned list is always well-formed."""
        n = self._ticket.value()
        if n <= self.capacity:
            out = [e for e in self._slots[:n] if e is not None]
        else:
            first = n % self.capacity
            out = [e for e in (self._slots[first:] + self._slots[:first])
                   if e is not None]
        out.sort(key=lambda e: e.get("ts", 0.0))
        return out

    def clear(self) -> None:
        self._slots = [None] * self.capacity
        self._ticket = AtomicCounter()

    # -- sinks ------------------------------------------------------------
    def add_sink(self, sink: Callable[[dict], None]) -> None:
        self._sinks = self._sinks + (sink,)

    def remove_sink(self, sink: Callable[[dict], None]) -> None:
        # equality, not identity: a bound method (``buf.append``) is a
        # fresh object on every attribute access but compares equal
        self._sinks = tuple(s for s in self._sinks if s != sink)

    def stats(self) -> dict:
        return {"capacity": self.capacity, "emitted": self.emitted(),
                "dropped_events": self.dropped(),
                "retained": min(self.emitted(), self.capacity),
                "sinks": len(self._sinks)}


# -- the process-wide bus -------------------------------------------------
_bus: EventBus | None = None


def bus() -> EventBus | None:
    """The process bus, or ``None`` when telemetry is disabled.

    Every emit site spells the disabled case as one branch::

        _tb = telemetry.bus()
        if _tb is not None:
            _tb.emit(...)
    """
    return _bus


def install(new_bus: EventBus | None) -> EventBus | None:
    """Swap the process bus in (or out, with ``None``); returns the old."""
    global _bus
    old, _bus = _bus, new_bus
    return old


def enable(capacity: int = 65536) -> EventBus:
    """Idempotently enable the process bus."""
    global _bus
    if _bus is None:
        _bus = EventBus(capacity)
    return _bus


def disable() -> None:
    install(None)


# -- Chrome-trace exporter ------------------------------------------------
def export_chrome_trace(events: Iterable[dict], path: str | None = None,
                        process_name: str = "iridescent") -> dict:
    """Render bus events as Chrome-trace/Perfetto JSON.

    Spans become complete (``ph="X"``) events, instants ``ph="i"``,
    counters ``ph="C"``.  Tracks (context keys) map to tids so each
    specialization context gets its own row; replicas map to pids so a
    fleet's merged stream splits per process.  Every emitted trace event
    carries ``ph/ts/pid/tid/name``.  Returns the trace dict; writes it to
    ``path`` atomically when given.
    """
    pids: dict[str, int] = {}
    tids: dict[tuple[int, str], int] = {}
    trace: list[dict] = []

    def _pid(ev: dict) -> int:
        rep = str(ev.get("replica", "front"))
        if rep not in pids:
            pids[rep] = len(pids) + 1
            trace.append({"ph": "M", "ts": 0, "pid": pids[rep], "tid": 0,
                          "name": "process_name",
                          "args": {"name": f"{process_name}:{rep}"}})
        return pids[rep]

    def _tid(pid: int, ev: dict) -> int:
        label = str(ev.get("track", ev["name"].split(".", 1)[0]))
        k = (pid, label)
        if k not in tids:
            tids[k] = sum(1 for (p, _l) in tids if p == pid) + 1  # 1-based
            trace.append({"ph": "M", "ts": 0, "pid": pid, "tid": tids[k],
                          "name": "thread_name",
                          "args": {"name": label}})
        return tids[k]

    _PH = {"span": "X", "instant": "i", "counter": "C"}
    for ev in events:
        pid = _pid(ev)
        tid = _tid(pid, ev)
        out = {"ph": _PH.get(ev.get("kind", "instant"), "i"),
               "ts": float(ev.get("ts", 0.0)), "pid": pid, "tid": tid,
               "name": ev["name"]}
        if out["ph"] == "X":
            out["dur"] = float(ev.get("dur", 0.0))
        elif out["ph"] == "i":
            out["s"] = "t"
        args = {k: v for k, v in ev.items()
                if k not in ("name", "kind", "ts", "dur", "track")}
        if out["ph"] == "C":
            args = {k: v for k, v in args.items()
                    if isinstance(v, (int, float))}
        if args:
            out["args"] = args
        trace.append(out)
    doc = {"traceEvents": trace, "displayTimeUnit": "ms"}
    if path:
        write_atomic_json(path, doc)
    return doc


# -- snapshot file (the `iridectl` data plane) ----------------------------
def write_atomic_json(path: str, doc: dict) -> None:
    """Write JSON via tmp+rename so readers never see a torn file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True, default=repr)
        f.write("\n")
    os.replace(tmp, path)


class SnapshotWriter:
    """Periodic atomic JSON snapshot of live state for ``launch/status.py``.

    ``provider`` assembles the snapshot dict (per-context phase, active /
    canary config, goodput window, quarantine, compile queue depth — see
    ``launch/serve.py``); a daemon thread serializes it to ``path`` every
    ``interval_s`` via tmp+rename, so ``iridectl``-style readers can poll
    the file without locks.  ``close()`` writes one final snapshot.
    """

    def __init__(self, path: str, provider: Callable[[], dict],
                 interval_s: float = 1.0):
        self.path = path
        self.provider = provider
        self.interval_s = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="telemetry-snapshot")
        self._thread.start()

    def _write(self) -> None:
        try:
            doc = self.provider()
            doc["written_at"] = time.time()
            write_atomic_json(self.path, doc)
        except Exception:
            pass                       # never take the serve loop down

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._write()
