"""End-to-end training example on the PyTorch port: a small LM trained with
online specialization and checkpoint/restart.  Runs on the card unless
``--device cpu`` is given:

    PYTHONPATH=src python examples/train_lm_torch.py                # quick (2M)
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu   # on the host
    PYTHONPATH=src python examples/train_lm_torch.py --size 100m \
        --steps 300 --seq 256                                       # the full run

With no arguments but ``--device`` it trains the 2M model for 60 steps
with ``--explore`` and checkpoints to ``build/train_lm_ckpt`` in the
checkout: interrupt and re-run to see the restart resume the data stream,
the optimizer state and the tuned configuration.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import main  # noqa: E402

CKPT = Path(__file__).resolve().parents[1] / "build" / "train_lm_ckpt"

if __name__ == "__main__":
    argv = sys.argv[1:]
    only_device = all(a.startswith("--device") or a in ("cpu", "cuda")
                      for a in argv)
    if only_device:
        argv += ["--size", "2m", "--steps", "60", "--explore",
                 "--ckpt", str(CKPT)]
    main(argv)
