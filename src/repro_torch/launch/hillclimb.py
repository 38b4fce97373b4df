"""Perf hillclimbing: runs the hypothesis->change->measure iteration
chains for the three selected (arch x shape) cells, writing tagged dry-run
artifacts next to the baselines.  Each entry is one iteration: the spec
config *delta* is cumulative within a chain.

Each chain is driven by the library :class:`~repro_torch.core.Controller`
in offline mode (``measure=``): the chain's cumulative configs become an
``ExhaustiveSweep`` candidate list and the controller owns the
propose -> measure -> observe loop; ``measure`` runs the cell's step on
the single-pod production mesh (:func:`repro_torch.launch.dryrun.run_cell`,
the ``fake`` backend in this one process) and writes the tagged artifact;
an artifact that exists is read back.  The metric is the reciprocal of the
cell's H100 roofline time (:func:`_metric`).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --cell kimi-k2-1t-a32b:decode_32k
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from repro_torch.core import Controller, ExhaustiveSweep
from repro_torch.launch import dryrun
from repro_torch.optim import OptConfig

# (tag, cumulative spec config) per cell: the reference's chains.
CHAINS = {
    ("kimi-k2-1t-a32b", "train_4k"): [
        ("a1_gather", {"moe_impl": "gather"}),
        ("a2_sort", {"moe_impl": "gather", "moe_ranking": "sort"}),
        ("a3_mem", {"moe_impl": "gather", "moe_ranking": "sort",
                    "remat": "dots", "logits_dtype": "bfloat16"}),
        ("a4_noexpfsdp", {"moe_impl": "gather", "moe_ranking": "sort",
                          "remat": "dots", "logits_dtype": "bfloat16",
                          "sharding_profile": "fsdp_noexp"}),
        ("a5_micro", {"moe_impl": "gather", "moe_ranking": "sort",
                      "remat": "dots", "logits_dtype": "bfloat16",
                      "sharding_profile": "fsdp_noexp", "microbatch": 4}),
        # diagnostics on the collective term (dispatch resharding volume)
        ("a6_group", {"moe_impl": "gather", "moe_ranking": "sort",
                      "remat": "dots", "logits_dtype": "bfloat16",
                      "moe_group": 4096}),
        ("a7_cf10", {"moe_impl": "gather", "moe_ranking": "sort",
                     "remat": "dots", "logits_dtype": "bfloat16",
                     "capacity_factor": 1.0}),
        # explicit-EP dispatch: zero dispatch collectives, one TP psum
        # per layer
        ("a8_shard", {"moe_impl": "shard", "remat": "dots",
                      "logits_dtype": "bfloat16",
                      "sharding_profile": "fsdp_noexp"}),
        ("a9_noremat", {"moe_impl": "shard",
                        "logits_dtype": "bfloat16",
                        "sharding_profile": "fsdp_noexp"}),
    ],
    ("kimi-k2-1t-a32b", "decode_32k"): [
        ("b1_serveep", {"sharding_profile": "serve_ep"}),
        ("b2_moegather", {"sharding_profile": "serve_ep",
                          "moe_impl": "gather", "moe_ranking": "sort"}),
        ("b3_cachebatch", {"sharding_profile": "serve_ep",
                           "moe_impl": "gather", "moe_ranking": "sort",
                           "cache_layout": "batch"}),
        ("b4_shard", {"sharding_profile": "fsdp_noexp",
                      "moe_impl": "shard"}),
    ],
    ("hymba-1.5b", "prefill_32k"): [
        ("c1_banded", {"swa_impl": "banded"}),
        ("c2_logitsbf16", {"swa_impl": "banded",
                           "logits_dtype": "bfloat16"}),
        ("c3_chunk32", {"swa_impl": "banded", "logits_dtype": "bfloat16",
                        "chunk_len": 32}),
        # explicit generic-kernel baseline via the registry impl points
        # (xla_ref everywhere) — the reference row the impl sweep beats
        ("c4_xlaref", {"swa_impl": "banded", "logits_dtype": "bfloat16",
                       "chunk_len": 32, "attention_impl": "xla_ref",
                       "linear_attention_impl": "xla_ref",
                       "rmsnorm_impl": "xla_ref"}),
    ],
}


def _key(spec: dict) -> str:
    return json.dumps(spec, sort_keys=True, default=repr)


def climb(arch: str, shape: str, chain: list, mesh,
          outdir: str) -> tuple[str | None, float]:
    """One chain through the Controller; returns the best tag and its
    metric (``None`` and -inf when every step failed)."""
    tag_of = {_key(spec): tag for tag, spec in chain}

    def measure(spec):
        tag = tag_of[_key(spec)]
        fn = os.path.join(outdir, f"{arch}__{shape}__{tag}.json")
        if os.path.exists(fn):
            print(f"skip {tag} (exists)")
            with open(fn) as f:
                return _metric(json.load(f))
        print(f"=== {arch} {shape} [{tag}] spec={spec}", flush=True)
        t0 = time.perf_counter()
        try:
            res = dryrun.run_cell(arch, shape, "single", mesh, spec,
                                  OptConfig(), surrogate=True)
            res["wall_s"] = time.perf_counter() - t0
            res["tag"] = tag
            with open(fn, "w") as f:
                json.dump(res, f, indent=1)
            rf = res["roofline"]
            print(f"  compute={rf['compute_s']:.4f}s "
                  f"memory={rf['memory_s']:.4f}s "
                  f"collective={rf['collective_s']:.4f}s "
                  f"dominant={rf['dominant']} "
                  f"useful={rf['useful_flops_ratio']:.3f} "
                  f"temp={res['full']['memory']['temp_size_in_bytes']/2**30:.1f}GiB",
                  flush=True)
            return _metric(res)
        except Exception as e:
            traceback.print_exc()
            print(f"  FAILED {tag}: {e}", flush=True)
            return float("-inf")

    ctl = Controller(policy=ExhaustiveSweep([spec for _, spec in chain]),
                     measure=measure)
    best, metric = ctl.run()
    if best is None or metric == float("-inf"):
        return None, float("-inf")
    best_tag = tag_of[_key(best)]
    print(f"--- {arch} {shape}: best step [{best_tag}] "
          f"(1/roofline_s={metric:.3f})", flush=True)
    return best_tag, metric


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="all",
                    help="'arch:shape' or 'all'")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    outdir = os.path.join(args.out, "single")
    os.makedirs(outdir, exist_ok=True)
    dryrun.open_fake_world(256)
    try:
        mesh = make_production_mesh(multi_pod=False)
        for (arch, shape), chain in CHAINS.items():
            if args.cell != "all" and args.cell != f"{arch}:{shape}":
                continue
            climb(arch, shape, chain, mesh, outdir)
    finally:
        dist.destroy_process_group()
    return 0


def _metric(res: dict) -> float:
    """Higher-is-better scalar from a dry-run artifact: reciprocal of the
    total roofline time (compute + memory + collective)."""
    rf = res.get("roofline") or {}
    total = (rf.get("compute_s", 0.0) + rf.get("memory_s", 0.0)
             + rf.get("collective_s", 0.0))
    return 1.0 / total if total > 0 else float("-inf")


if __name__ == "__main__":
    sys.exit(main())
