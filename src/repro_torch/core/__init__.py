"""Iridescent core: online system implementation specialization, for the
PyTorch port.

The paper's framework: developers declare a *space* of possible
specializations in performance-critical handler code; the runtime builds
specialized variants off the critical path and explores the space online,
guided by observed end-to-end performance.  The modules here are the
reference's, with the runtime's compile step ported to PyTorch (a variant
is a closure; compiling it builds the kernel libraries it names).

Public API (mirrors paper Table 2):

Specialization API (used inside handler builders, via :class:`SpecCtx`):
    ``spec.enum(lbl, x, choices)`` / ``spec.range`` / ``spec.generic`` /
    ``spec.assume`` / ``spec.custom``

Policy API (used by the system's fixed code):
    ``IridescentRuntime`` — ``.register``, ``.handler``, ``.spec_space``,
    ``.specialize``, ``.add_custom_spec``

Building blocks: policies, metrics, guards, instrumentation, and the
Morpheus-style fast-path specialization (``fastpath``), and the
persistent variant cache of built kernel libraries (``VariantCache``).
"""
from repro_torch.core.points import (DISABLED, AssumePoint, Config,
                                     CustomPoint, EnumPoint, GenericPoint,
                                     RangePoint, SpecPoint, SpecSpace,
                                     StaleConfigError, cartesian, config_key)
from repro_torch.core.specializer import (SpecCtx, Specialized,
                                          discover_space, specialize_builder)
from repro_torch.core.variant_cache import VariantCache
from repro_torch.core.compile_service import (CompileService,
                                              PRIORITY_ACTIVATE,
                                              PRIORITY_SPECULATIVE)
from repro_torch.core.runtime import (ContextView, DEFAULT_CONTEXT, Handler,
                                      IridescentRuntime, Variant,
                                      encode_context_key)
from repro_torch.core.policy import (ContextualBandit, CoordinateDescent,
                                     CostAwareUCB, EpsilonGreedy,
                                     ExhaustiveSweep, Explorer, Phase, Policy,
                                     ScoreBoard, SuccessiveHalving,
                                     ThompsonSampling)
from repro_torch.core.controller import Controller
from repro_torch.core.safety import CanaryGate, Quarantine, SafetyController
from repro_torch.core.metrics import (AtomicCounter, ChangeDetector, EWMA,
                                      StepTimer, ThroughputCounter,
                                      ThroughputWindow)
from repro_torch.core import fastpath, guards, instrumentation, telemetry
from repro_torch.core.telemetry import EventBus, export_chrome_trace

__all__ = [
    "DISABLED", "AssumePoint", "Config", "CustomPoint", "EnumPoint",
    "GenericPoint", "RangePoint", "SpecPoint", "SpecSpace",
    "StaleConfigError", "cartesian",
    "config_key", "SpecCtx", "Specialized", "discover_space",
    "specialize_builder", "CompileService", "PRIORITY_ACTIVATE",
    "PRIORITY_SPECULATIVE", "VariantCache", "ContextView", "DEFAULT_CONTEXT",
    "Handler", "IridescentRuntime", "Variant", "encode_context_key",
    "ContextualBandit", "Controller", "CoordinateDescent", "CostAwareUCB",
    "EpsilonGreedy", "ExhaustiveSweep", "Explorer", "Phase", "Policy",
    "ScoreBoard", "SuccessiveHalving", "ThompsonSampling",
    "CanaryGate", "Quarantine", "SafetyController",
    "AtomicCounter", "ChangeDetector", "EWMA",
    "StepTimer", "ThroughputCounter", "ThroughputWindow", "fastpath",
    "guards", "instrumentation", "telemetry", "EventBus",
    "export_chrome_trace",
]
