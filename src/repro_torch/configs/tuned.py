"""Best-known specialization configs per (arch, shape): the persistent
output of the hillclimbs, with the reference's API.

The online explorer *discovers* these; the table warm-starts the next
deployment so exploration begins from the incumbent instead of the
generic config.

Every entry is the winner of the port's own hillclimb chain for its cell
(``python -m repro_torch.launch.hillclimb``: the dry run on the
single-pod (16, 16) mesh, ranked by the reciprocal of its H100 roofline
time); none is the reference's, whose winners were ranked on a TPU.  A
cell no chain covers gets the generic (empty) config.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b \\
        --shape decode_32k --mesh single --spec "$(python -c 'from \\
        repro_torch.configs.tuned import spec_json; \\
        print(spec_json("kimi-k2-1t-a32b", "decode_32k"))')"
"""
from __future__ import annotations

import json

__all__ = ["TUNED", "best_spec", "spec_json"]

#: (arch, shape name) -> spec-point overrides, from the port's chains
TUNED: dict[tuple[str, str], dict] = {
    # a9_noremat, 1/roofline_s 0.0157 (every step of the chain runs since
    # the dispatch and the loss work on local shards; the state donated);
    # torch 2.13.0+cpu; H100 SXM5 roofline, 700 W
    ("kimi-k2-1t-a32b", "train_4k"): {
        "moe_impl": "shard", "logits_dtype": "bfloat16",
        "sharding_profile": "fsdp_noexp"},
    # b2_moegather, 1/roofline_s 6.581; torch 2.13.0+cpu; H100 SXM5
    # roofline, 700 W
    ("kimi-k2-1t-a32b", "decode_32k"): {
        "sharding_profile": "serve_ep", "moe_impl": "gather",
        "moe_ranking": "sort"},
    # c2_logitsbf16, 1/roofline_s 0.2759; torch 2.13.0+cpu; H100 SXM5
    # roofline, 700 W
    ("hymba-1.5b", "prefill_32k"): {
        "swa_impl": "banded", "logits_dtype": "bfloat16"},
}


def best_spec(arch: str, shape: str) -> dict:
    """Best-known config, falling back to the generic (empty) config."""
    return dict(TUNED.get((arch, shape), {}))


def spec_json(arch: str, shape: str) -> str:
    return json.dumps(best_spec(arch, shape))
