"""Per-rank bytes of a decode cache on the production (data=16, model=16)
mesh: as the cache's logical axes place it, and as a cached step holds it
while it runs (a replicated working copy: ``training.steps._cached_step``).

    PYTHONPATH=src python tools/mesh_cache_bytes.py \\
        --arch deepseek-v2-236b --seq 32768 --batch 128

Runs on the host in one process: the mesh is a ``DeviceMesh`` over a
world of 256 on the ``fake`` backend, and the cache's tensors are on the
``meta`` device (shapes, no memory).  Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json

import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch import compat, configs
from repro_torch.distributed.sharding import (DEFAULT_RULES, logical_to_spec,
                                              mesh_shape)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as model
from repro_torch.models.transformer import RunOptions
from repro_torch.training.steps import SHARDING_PROFILES


def cache_bytes(arch: str, seq: int, batch: int, profile: str,
                cache_dtype: str) -> dict:
    """Whole and per-rank bytes of the cache under ``profile`` with
    ``cache_layout=seq`` (the decode builders' default)."""
    cfg = configs.get_config(arch)
    cache = model.init_cache(cfg, batch, seq,
                             RunOptions(decode_cache_dtype=cache_dtype),
                             device="meta")
    axes = compat.tree_leaves(model.cache_axes(cfg),
                              is_leaf=lambda x: isinstance(x, tuple))
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = make_production_mesh()
        sizes = mesh_shape(mesh)
        rules = SHARDING_PROFILES[profile](DEFAULT_RULES).replace(
            seq_kv="model")
        whole = placed = 0
        for leaf, ax in zip(compat.tree_leaves(cache), axes):
            n = leaf.numel() * leaf.element_size()
            shards = 1
            for entry in logical_to_spec(ax, leaf.shape, mesh, rules):
                for name in ((entry,) if isinstance(entry, str)
                             else entry or ()):
                    shards *= sizes[name]
            whole += n
            placed += n // shards
    finally:
        dist.destroy_process_group()
    return {"arch": arch, "seq": seq, "batch": batch, "profile": profile,
            "cache_dtype": cache_dtype, "mesh": sizes,
            "placed_bytes_per_rank": placed,
            "working_copy_bytes_per_rank": whole}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek-v2-236b")
    ap.add_argument("--seq", type=int, default=32_768)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--profile", default="serve_ep",
                    choices=tuple(SHARDING_PROFILES))
    ap.add_argument("--cache-dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    a = ap.parse_args(argv)
    print(json.dumps(cache_bytes(a.arch, a.seq, a.batch, a.profile,
                                 a.cache_dtype)))


if __name__ == "__main__":
    main()
