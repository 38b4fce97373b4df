"""Phase-specialized batch executors: the serve engine's model adapter.

Extracted from ``launch/serve.py``'s monolithic ``DecodeExecutor`` and
rebuilt on the paged KV runtime (:mod:`repro_torch.serve.kv`):

* :class:`PrefillExecutor` — consumes prompts chunk by chunk through the
  serve handler's ``tokens (B, C)`` trace.  A request whose prompt
  completes this chunk samples its first output token from the logits at
  its last prompt position (that is the TTFT moment).
* :class:`DecodeExecutor` — one ``tokens (B,)`` step per call: feeds each
  row's last sampled token back in, samples the next.
* :class:`PhasedExecutor` — the facade the engine drives.  Routes each
  :class:`~repro_torch.serve.batcher.PackedBatch` to its phase's executor,
  owns per-request lifecycle (KV join on first prefill, free-list
  release on retire) and the sampled-token bookkeeping both phases
  share.

Every step runs materialize -> handler -> harvest against the
:class:`~repro_torch.serve.kv.PagedKV` manager, so requests keep isolated
per-request state across continuous-batching join/retire, and the
handler's ``(phase, bucket)`` context key
(:func:`repro_torch.training.steps.phase_context_fn`) sends prefill and decode
traffic through separate specialization contexts.
"""
from __future__ import annotations

import logging
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.serve.batcher import PackedBatch
from repro_torch.serve.kv import PagedKV
from repro_torch.serve.request import Request

logger = logging.getLogger("repro_torch.serve.executor")

__all__ = ["PhasedExecutor", "PrefillExecutor", "DecodeExecutor"]


class _RowState:
    """Executor-side per-request state: the prompt ids and the sampled
    output tokens (the decode feedback loop)."""

    __slots__ = ("prompt", "out")

    def __init__(self, prompt: np.ndarray):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.out: list[int] = []


def _default_prompt_fn(vocab_size: int) -> Callable[[Request], np.ndarray]:
    """Deterministic synthetic prompts: same rid -> same token ids, so
    replayed workloads decode identical sequences."""

    def prompt_fn(req: Request) -> np.ndarray:
        rng = np.random.RandomState((req.rid * 2654435761 + 1) % (2 ** 31))
        return rng.randint(0, vocab_size,
                           size=max(1, req.prompt_tokens)).astype(np.int32)

    return prompt_fn


def _argmax_sample(logits_row: np.ndarray) -> int:
    return int(np.argmax(logits_row))


class PrefillExecutor:
    """Chunked-prefill steps: ``tokens (B, C)`` through the serve handler.

    The chunk length ``C`` is fixed per executor so each (prefill,
    bucket) context compiles one program; rows whose remaining prompt is
    shorter than ``C`` run masked (``n_new < C``) and rows that finish
    sample their first token.
    """

    def __init__(self, owner: "PhasedExecutor", chunk: int):
        if chunk <= 0:
            raise ValueError(f"prefill chunk must be positive, got {chunk}")
        self.owner = owner
        self.chunk = int(chunk)

    def execute(self, batch: PackedBatch) -> list[int]:
        o = self.owner
        reqs = batch.requests
        b, c = batch.size, self.chunk
        for req in reqs:
            o.ensure_joined(req)
        tokens = np.zeros((b, c), np.int32)
        n_new = np.zeros((b,), np.int32)
        for i, req in enumerate(reqs):
            row = o.state[req.rid]
            n = min(c, req.prompt_tokens - req.prompt_consumed)
            tokens[i, :n] = row.prompt[req.prompt_consumed:
                                       req.prompt_consumed + n]
            n_new[i] = n
        rids = [req.rid for req in reqs]
        cache, lengths = o.kv.materialize(rids, b)
        logits, new_cache = o.handler(
            o.params, cache, o.upload(tokens), o.upload(lengths),
            o.upload(n_new))
        o.kv.harvest(rids, new_cache, n_new[: len(reqs)])
        logits = logits.cpu().numpy()
        produced = []
        for i, req in enumerate(reqs):
            req.prompt_consumed += int(n_new[i])
            if req.prefilling:
                produced.append(0)
            else:
                o.state[req.rid].out.append(o.sample(logits[i]))
                produced.append(1)
        return produced


class DecodeExecutor:
    """Decode steps: ``tokens (B,)`` through the serve handler — each
    row's last sampled token in, next token sampled out, KV appended at
    the row's own position."""

    def __init__(self, owner: "PhasedExecutor"):
        self.owner = owner

    def execute(self, batch: PackedBatch) -> list[int]:
        o = self.owner
        reqs = batch.requests
        b = batch.size
        tokens = np.zeros((b,), np.int32)
        for i, req in enumerate(reqs):
            row = o.state[req.rid]
            tokens[i] = row.out[-1] if row.out else row.prompt[-1]
        rids = [req.rid for req in reqs]
        cache, lengths = o.kv.materialize(rids, b)
        ones = np.ones((b,), np.int32)
        logits, new_cache = o.handler(
            o.params, cache, o.upload(tokens), o.upload(lengths),
            o.upload(ones))
        o.kv.harvest(rids, new_cache, [1] * len(reqs))
        logits = logits.cpu().numpy()
        for i, req in enumerate(reqs):
            o.state[req.rid].out.append(o.sample(logits[i]))
        return [1] * len(reqs)


class PhasedExecutor:
    """Prefill/decode-disaggregated executor over a paged KV runtime.

    ``handler`` is the registered serve trampoline
    (:func:`repro_torch.training.steps.make_serve_builder`, registered with
    ``context_fn=phase_context_fn``); ``kv`` the
    :class:`~repro_torch.serve.kv.PagedKV` manager; ``prompt_fn`` maps a
    request to its prompt token ids (default: deterministic synthetic
    prompts over ``vocab_size``).  ``sample`` turns a logits row into the
    next token id (greedy argmax by default).

    On retire the request's pages return to the free list and its
    generated token ids are published as ``request.payload`` (a list).
    """

    #: tells the engine to pack prefill and decode steps separately
    phased = True

    def __init__(self, handler, params: Any, kv: PagedKV, *,
                 prefill_chunk: int = 16,
                 prompt_fn: Callable[[Request], np.ndarray] | None = None,
                 vocab_size: int | None = None,
                 sample: Callable[[np.ndarray], int] = _argmax_sample):
        if prompt_fn is None:
            if vocab_size is None:
                raise ValueError("PhasedExecutor needs prompt_fn or "
                                 "vocab_size (for synthetic prompts)")
            prompt_fn = _default_prompt_fn(int(vocab_size))
        self.handler = handler
        self.params = params
        self.kv = kv
        self.prompt_fn = prompt_fn
        self.sample = sample
        self.state: dict[Any, _RowState] = {}
        self.prefill = PrefillExecutor(self, prefill_chunk)
        self.decode = DecodeExecutor(self)

    # -- lifecycle --------------------------------------------------------------
    def ensure_joined(self, req: Request) -> None:
        if req.rid in self.state:
            return
        total = req.prompt_tokens + req.max_new_tokens
        if total > self.kv.max_len:
            raise ValueError(
                f"request {req.rid} needs {total} cache slots "
                f"(prompt {req.prompt_tokens} + budget {req.max_new_tokens})"
                f" but max_len is {self.kv.max_len}")
        self.state[req.rid] = _RowState(self.prompt_fn(req))
        self.kv.join(req.rid)

    def retire(self, req: Request) -> None:
        row = self.state.pop(req.rid, None)
        if row is not None:
            req.payload = row.out
        if req.rid in self.kv.live_requests():
            self.kv.retire(req.rid)

    # -- execution --------------------------------------------------------------
    def upload(self, host: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the KV manager's device."""
        return torch.from_numpy(host).to(self.kv.device)

    def execute(self, batch: PackedBatch) -> list[int]:
        if batch.phase == "prefill":
            return self.prefill.execute(batch)
        return self.decode.execute(batch)

    def stats(self) -> dict:
        return self.kv.stats()
