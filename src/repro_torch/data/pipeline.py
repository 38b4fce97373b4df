"""Data pipeline of the PyTorch port: deterministic synthetic token streams
(training) and a workload generator with shiftable distributions (serving
benchmarks); the port of ``repro.data.pipeline``.

Training pipeline properties that matter:
* **deterministic & restartable** — batch ``i`` is a pure function of
  (seed, i), drawn with numpy exactly as the reference draws it, so
  checkpoint/restart resumes the stream exactly (the loader state is one
  integer) and either package's stream is the other's;
* **explicit placement** — batches are placed on one device, the card
  unless the caller asks for the CPU;
* **prefetch** — a background thread keeps ``prefetch`` batches in flight so
  host data work overlaps device compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch import compat

__all__ = ["SyntheticLM", "RequestGenerator"]


class SyntheticLM:
    """Deterministic synthetic LM batches: {tokens, labels} (B, S) int32.

    Tokens follow a Zipfian unigram distribution (embedding gathers hit
    hot rows, losses vary).  ``embeds_dim`` adds ``embeds (B, S, d)`` fp32
    for the stub frontends.  Batches land on ``device`` (default
    ``cuda``, see :func:`repro_torch.compat.resolve_device`).
    """

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, start_step: int = 0, zipf_a: float = 1.2,
                 embeds_dim: int | None = None, prefetch: int = 2,
                 device: torch.device | str | None = None):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.step = start_step
        self.embeds_dim = embeds_dim
        self.device = compat.resolve_device(device)
        # Zipf weights over the vocab (truncated harmonic).
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        w = ranks ** -zipf_a
        self._cdf = np.cumsum(w / w.sum())
        self._prefetch_n = prefetch
        self._q: queue.Queue | None = None
        self._thread: threading.Thread | None = None

    # -- pure batch function ----------------------------------------------------
    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Batch ``step`` as host numpy arrays, bit for bit the
        reference's."""
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % 2**31)
        u = rng.rand(self.batch, self.seq_len + 1)
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        toks = np.minimum(toks, self.vocab_size - 1)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.embeds_dim is not None:
            out["embeds"] = rng.randn(
                self.batch, self.seq_len, self.embeds_dim).astype(np.float32)
        return out

    def place(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """A host batch as contiguous tensors on this stream's device."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    # -- iterator with prefetch ----------------------------------------------------
    def _worker(self):
        while True:
            b = self.batch_at(self.step)
            self.step += 1
            self._q.put(self.place(b))

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        if self._prefetch_n > 0:
            self._q = queue.Queue(maxsize=self._prefetch_n)
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
            while True:
                yield self._q.get()
        else:
            while True:
                b = self.batch_at(self.step)
                self.step += 1
                yield self.place(b)

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}


class RequestGenerator:
    """Serving workload generator with shiftable key/length distributions.

    Reproduces the paper's experiment shapes: a hot-key Zipf over request
    keys (fast-path experiments, Fig 4/5/9) and a sequence-length mixture
    (shape-bucketing), both of which can be switched mid-run (``shift()``)
    to exercise workload-change adaptation (Fig 7/8/9).
    """

    def __init__(self, key_space: int = 1 << 20, zipf_a: float = 1.3,
                 lengths: tuple[int, ...] = (128, 256, 512),
                 length_probs: tuple[float, ...] = (0.7, 0.2, 0.1),
                 seed: int = 0):
        self.key_space = key_space
        self.zipf_a = zipf_a
        self.lengths = lengths
        self.length_probs = np.asarray(length_probs, np.float64)
        self.length_probs /= self.length_probs.sum()
        self._rng = np.random.RandomState(seed)
        self._phase = 0
        self._build()

    def _build(self):
        n_hot = 4096
        ranks = np.arange(1, n_hot + 1, dtype=np.float64)
        w = ranks ** -self.zipf_a
        self._hot_cdf = np.cumsum(w / w.sum())
        # phase-dependent hot key identities (disjoint across phases)
        rs = np.random.RandomState(1234 + self._phase)
        self._hot_keys = rs.choice(self.key_space, size=n_hot, replace=False)

    def shift(self, lengths=None, length_probs=None, zipf_a=None):
        """Switch the workload distribution (a 'phase change')."""
        self._phase += 1
        if lengths is not None:
            self.lengths = lengths
        if length_probs is not None:
            self.length_probs = np.asarray(length_probs, np.float64)
            self.length_probs /= self.length_probs.sum()
        if zipf_a is not None:
            self.zipf_a = zipf_a
        self._build()

    def keys(self, n: int) -> np.ndarray:
        u = self._rng.rand(n)
        idx = np.searchsorted(self._hot_cdf, u)
        return self._hot_keys[np.minimum(idx, len(self._hot_keys) - 1)] \
            .astype(np.int64)

    def batch_lengths(self, n: int) -> np.ndarray:
        return self._rng.choice(self.lengths, size=n, p=self.length_probs)
