"""Serving example on the PyTorch port: continuous-batching LM decode with
online specialization.  Runs on the card unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/serve_adaptive_torch.py
    PYTHONPATH=src python examples/serve_adaptive_torch.py --device cpu
    PYTHONPATH=src python examples/serve_adaptive_torch.py --arch rwkv6-1.6b
    PYTHONPATH=src python examples/serve_adaptive_torch.py \\
        --prefill-chunk 32 --kv-page-size 8 --scheduler sjf

Open-loop requests (pseudo-Poisson arrivals, mixed prompt/decode lengths)
flow through the :mod:`repro_torch.serve` engine: admission queue ->
scheduler -> continuous batcher -> phase-disaggregated execution over the
paged per-request KV runtime.  Chunked prefill interleaves with decode
steps, and each phase dispatches through its own ``(phase, bucket)``
specialization contexts: the Controller tunes the decode spec points
separately for prefill and decode, while the bucket boundaries and the KV
page geometry are tuned online against measured goodput by their own plan
handlers.  Without ``--steps`` it serves for 240 steps, as the reference's
``examples/serve_adaptive.py``.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import serve  # noqa: E402


def main(argv: list[str]) -> None:
    if not any(a == "--steps" or a.startswith("--steps=") for a in argv):
        argv = argv + ["--steps", "240"]
    serve.main(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
