"""Data pipeline of the PyTorch port: the serving workload generator with
shiftable distributions (numpy only, copied from the reference).

The reference's training stream (``SyntheticLM``) waits for the port's
training slice (ROADMAP M8).
"""
from __future__ import annotations

import numpy as np

__all__ = ["RequestGenerator"]


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
