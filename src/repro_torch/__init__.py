"""PyTorch/CUDA port of the Iridescent reproduction, for NVIDIA Hopper.

A second package beside the JAX reference (``repro``), mirroring its
layout: ``core`` (the specialization runtime), ``kernels`` (hand-written
CUDA kernels for ``sm_90a`` beside their plain PyTorch versions),
``models``, ``configs``, ``training`` (step builders), ``serve`` (the
continuous-batching engine, tenants and the fleet), ``checkpoint``
(parameters and specialization state on disk) and ``launch`` (entry
points).  It imports
``torch`` and numpy, never JAX.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
