"""Instrumentation (paper §4.4.1): collecting runtime values so the policy
can *discover* specialization candidates.

Two collection modes, mirroring the paper's measured trade-off (§6.4):

* **Host-side sampling** (the paper's "general specialization point",
  ~450-500 cycles/op at rate=1.0): a Python collector samples the handler's
  arguments at a configurable sampling rate.  Expensive per sample, so the
  sampling rate knob matters (Fig 11).
* **In-graph taps** (the paper's "range-based" point, ~1 cycle/op): the
  instrumented variant of the handler computes aggregates (histograms,
  min/max) on the device beside the step — one vectorized pass — and
  returns them as extra outputs the runtime accumulates.
"""
from __future__ import annotations

import collections
import logging
import random
import threading
from typing import Any, Callable, Mapping

import numpy as np
import torch

logger = logging.getLogger("repro_torch.core.instrumentation")

__all__ = ["HostRecorder", "TapAccumulator", "RecorderSet",
           "hist_tap", "topk_from_counter"]


class HostRecorder:
    """Samples ``fn(args, kwargs)`` at ``rate`` and keeps a value Counter."""

    def __init__(self, label: str, fn: Callable[[tuple, dict], Any],
                 rate: float = 1.0, maxlen: int = 65536,
                 rng: random.Random | None = None):
        self.label = label
        self.fn = fn
        self.rate = float(rate)
        self.counter: collections.Counter = collections.Counter()
        self.samples = 0
        self.maxlen = maxlen
        #: samples whose (new) key was discarded because the counter is
        #: full — the top-N ranking may be missing tail values
        self.evicted = 0
        self._rng = rng or random.Random(0xC0FFEE)

    def maybe_record(self, args: tuple, kwargs: dict) -> None:
        if self._rng.random() >= self.rate:
            return
        value = self.fn(args, kwargs)
        self.samples += 1
        if len(self.counter) < self.maxlen or value in self.counter:
            self.counter[value] += 1
            return
        # Counter full and the value is a never-seen key: it is dropped
        # (bounding memory), which silently biases the ranking toward
        # early keys — say so, once, and count every drop.
        if self.evicted == 0:
            logger.warning(
                "host recorder %r saturated at %d distinct values; new "
                "values are no longer counted", self.label, self.maxlen)
            from repro_torch.core import telemetry
            _tb = telemetry.bus()
            if _tb is not None:
                _tb.emit("instrument.saturated", label=self.label,
                         maxlen=self.maxlen, samples=self.samples)
        self.evicted += 1

    def summary(self) -> dict:
        return {
            "kind": "host",
            "samples": self.samples,
            "saturated": self.evicted > 0,
            "evicted": self.evicted,
            "top": self.counter.most_common(32),
        }


class TapAccumulator:
    """Accumulates in-graph tap outputs (e.g. histograms) across calls."""

    def __init__(self, label: str):
        self.label = label
        self.total: np.ndarray | None = None
        self.calls = 0

    def absorb(self, value: Any) -> None:
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        arr = np.asarray(value)
        self.total = arr.astype(np.float64) if self.total is None else self.total + arr
        self.calls += 1

    def summary(self) -> dict:
        return {"kind": "tap", "calls": self.calls, "total": self.total}


class RecorderSet:
    """Per-handler bundle of host recorders + tap accumulators."""

    def __init__(self):
        self._lock = threading.Lock()
        self.host: dict[str, HostRecorder] = {}
        self.taps: dict[str, TapAccumulator] = {}

    def add_host(self, label: str, fn: Callable, rate: float) -> None:
        with self._lock:
            self.host[label] = HostRecorder(label, fn, rate)

    def maybe_record(self, args: tuple, kwargs: dict) -> None:
        for rec in list(self.host.values()):
            rec.maybe_record(args, kwargs)

    def absorb_taps(self, taps: Mapping[str, Any]) -> None:
        with self._lock:
            for label, value in taps.items():
                acc = self.taps.setdefault(label, TapAccumulator(label))
                acc.absorb(value)

    def summary(self) -> dict:
        out: dict[str, Any] = {}
        for label, rec in self.host.items():
            out[label] = rec.summary()
        for label, acc in self.taps.items():
            out[label] = acc.summary()
        return out

    def clear(self) -> None:
        with self._lock:
            for rec in self.host.values():
                rec.counter.clear()
                rec.samples = 0
                rec.evicted = 0
            self.taps.clear()


# --- in-graph tap helpers (used by handler builders) --------------------------

def hist_tap(values: torch.Tensor, num_bins: int,
             lo: float = 0.0, hi: float | None = None) -> torch.Tensor:
    """Histogram of ``values`` as a dense ``num_bins`` int32 vector.

    One vectorized binning pass plus a ``bincount`` on the values' device:
    the port of the reference's one-hot-and-sum tap.
    """
    v = values.reshape(-1).to(torch.float32)
    if hi is None:
        hi = float(num_bins)
    idx = torch.clamp(((v - lo) / (hi - lo) * num_bins).to(torch.int32),
                      0, num_bins - 1)
    return torch.bincount(idx.to(torch.long),
                          minlength=num_bins).to(torch.int32)


def topk_from_counter(summary: Mapping[str, Any], label: str,
                      n: int) -> list:
    """Extract top-N observed values for a label from spec_space().observed."""
    info = summary.get(label)
    if info is None:
        return []
    if info.get("kind") == "host":
        return [v for v, _ in info["top"][:n]]
    total = info.get("total")
    if total is None:
        return []
    order = np.argsort(total)[::-1]
    return [int(i) for i in order[:n] if total[i] > 0]
