"""Requests and completions: the unit of work the serve engine moves.

A :class:`Request` is one client job — a prompt of ``prompt_tokens`` tokens
plus a per-request decode budget of ``max_new_tokens`` — stamped with the
timestamps the latency/goodput accounting needs:

* ``arrival_t``     — stamped by the admission queue at submit,
* ``service_t``     — first joined a running batch (queueing delay ends),
* ``first_token_t`` — first decode step that produced a token for it,
* ``finish_t``      — retired from the batch (budget exhausted).

All timestamps come from the engine's injected clock (``time.perf_counter``
by default), so tests can drive a fake clock deterministically.

``deadline_s`` is the request's *relative* SLO (seconds from arrival to
finish); ``None`` falls back to the engine-wide SLO.  A finished request
folds into a :class:`Completion`, the record the serve metrics consume.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any

__all__ = ["Request", "Completion", "next_request_id"]

_ids = itertools.count()


def next_request_id() -> int:
    """Process-wide monotonically increasing request id."""
    return next(_ids)


@dataclasses.dataclass
class Request:
    """One serve job and its lifecycle timestamps."""

    rid: int = dataclasses.field(default_factory=next_request_id)
    prompt_tokens: int = 1
    max_new_tokens: int = 16
    deadline_s: float | None = None
    tenant: str | None = None        # SLO class / model this request targets
    payload: Any = None              # opaque per-request state (e.g. tokens)

    arrival_t: float | None = None   # stamped by AdmissionQueue.submit
    service_t: float | None = None   # stamped when first packed into a batch
    first_token_t: float | None = None
    finish_t: float | None = None
    generated: int = 0               # decode tokens produced so far
    prompt_consumed: int = 0         # prompt tokens prefilled so far (phased)
    shed: bool = False               # dropped by backpressure / drain timeout

    @property
    def remaining(self) -> int:
        """Decode tokens still owed."""
        return max(0, self.max_new_tokens - self.generated)

    @property
    def remaining_prefill(self) -> int:
        """Prompt tokens not yet prefilled.  Under phased execution the
        executor advances ``prompt_consumed`` chunk by chunk; legacy
        (non-phased) executors never touch it, in which case the whole
        prompt counts as outstanding work until the first token."""
        if self.generated > 0 and self.prompt_consumed == 0:
            return 0                 # legacy executor: prompt already paid
        return max(0, self.prompt_tokens - self.prompt_consumed)

    @property
    def prefilling(self) -> bool:
        """Whether this request still has prompt tokens to consume."""
        return self.prompt_consumed < self.prompt_tokens

    @property
    def remaining_work(self) -> int:
        """Total step-cost estimate: remaining prefill + remaining decode
        (the SJF scheduling key — chunked prefill makes prompt length part
        of the true job cost)."""
        return self.remaining_prefill + self.remaining

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens

    def deadline_t(self, default_slo_s: float | None) -> float:
        """Absolute deadline (EDF key).  Requests with no SLO sort last."""
        slo = self.deadline_s if self.deadline_s is not None else default_slo_s
        base = self.arrival_t if self.arrival_t is not None else 0.0
        return base + slo if slo is not None else float("inf")

    def __repr__(self) -> str:
        who = f", tenant={self.tenant!r}" if self.tenant is not None else ""
        return (f"Request(rid={self.rid}{who}, prompt={self.prompt_tokens}, "
                f"budget={self.max_new_tokens}, generated={self.generated})")


@dataclasses.dataclass(frozen=True)
class Completion:
    """The immutable record of a finished request."""

    rid: int
    prompt_tokens: int
    tokens: int                      # decode tokens actually produced
    arrival_t: float
    service_t: float | None
    first_token_t: float | None
    finish_t: float
    within_slo: bool
    tenant: str | None = None

    @classmethod
    def from_request(cls, req: Request,
                     default_slo_s: float | None = None) -> "Completion":
        if req.arrival_t is None:
            raise ValueError(
                f"request rid={req.rid} has no arrival_t — it bypassed the "
                "admission queue (AdmissionQueue.submit stamps arrival); "
                "submit it through the queue or stamp arrival_t before "
                "retiring it")
        if req.finish_t is None:
            raise ValueError(
                f"request rid={req.rid} has no finish_t — it was never "
                "retired; Completion.from_request is only meaningful for "
                "finished (or shed-with-finish-stamp) requests")
        latency = req.finish_t - req.arrival_t
        slo = (req.deadline_s if req.deadline_s is not None
               else default_slo_s)
        return cls(rid=req.rid, prompt_tokens=req.prompt_tokens,
                   tokens=req.generated, arrival_t=req.arrival_t,
                   service_t=req.service_t,
                   first_token_t=req.first_token_t, finish_t=req.finish_t,
                   within_slo=(slo is None or latency <= slo),
                   tenant=req.tenant)

    @property
    def latency_s(self) -> float:
        """Arrival-to-finish latency (what the SLO is measured against)."""
        return self.finish_t - self.arrival_t

    @property
    def queue_delay_s(self) -> float | None:
        if self.service_t is None:
            return None
        return self.service_t - self.arrival_t
