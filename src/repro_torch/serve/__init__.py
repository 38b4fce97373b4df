"""Continuous-batching serve engine feeding the contextual specialization
runtime (the port of ``repro.serve`` for one replica).

An open-loop admission queue with backpressure, pluggable scheduling, a
continuous batcher that packs each step's batch into tuned bucket shapes,
and a :class:`~repro_torch.serve.engine.ServeEngine` loop that routes
every packed batch through the handler's per-context dispatch and feeds
the per-context Controller.  :mod:`repro_torch.serve.kv` keeps every
request's decode state in block-paged host pools and
:mod:`repro_torch.serve.executor` runs chunked prefill and decode as
separate ``(phase, bucket)`` contexts of one serve handler.  Tenancy and
the fleet wait for ROADMAP M10.
"""
from repro_torch.serve.request import Completion, Request, next_request_id
from repro_torch.serve.queue import (AdmissionQueue, OpenLoopSource,
                                     pseudo_poisson_times, substream_seed)
from repro_torch.serve.scheduler import (SCHEDULERS, DeadlineAware,
                                         DeficitRoundRobin, FCFS, Scheduler,
                                         ShortestJobFirst, make_scheduler)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.batcher import (BucketTuner, ContinuousBatcher,
                                       PackedBatch, bucket_plan_builder,
                                       default_schemes)
from repro_torch.serve.kv import (KVTuner, PagedKV, PageError, PagePool,
                                  PageTable, kv_plan_builder)
from repro_torch.serve.executor import (DecodeExecutor, PhasedExecutor,
                                        PrefillExecutor)
from repro_torch.serve.engine import BatchExecutor, ServeEngine
from repro_torch.serve.shadow import ShadowEvaluator

__all__ = [
    "Completion", "Request", "next_request_id",
    "AdmissionQueue", "OpenLoopSource", "pseudo_poisson_times",
    "substream_seed",
    "SCHEDULERS", "DeadlineAware", "DeficitRoundRobin", "FCFS", "Scheduler",
    "ShortestJobFirst", "make_scheduler", "ServeMetrics",
    "BucketTuner", "ContinuousBatcher", "PackedBatch",
    "bucket_plan_builder", "default_schemes",
    "KVTuner", "PagedKV", "PageError", "PagePool", "PageTable",
    "kv_plan_builder",
    "DecodeExecutor", "PhasedExecutor", "PrefillExecutor",
    "BatchExecutor", "ServeEngine", "ShadowEvaluator",
]
