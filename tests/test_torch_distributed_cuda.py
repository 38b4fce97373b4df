"""The distributed layer on a Hopper GPU, at reduced size: a one-rank NCCL
group and a (data=1, model=1) mesh on the card; ``compressed_psum`` within
int8 error of the plain sum with the int8 payload handed to NCCL, the
``shard`` MoE (its explicit expert-parallel block, all experts local)
against ``gather`` at a capacity that drops no token, to 1e-5 relative,
and the cached steps on the mesh (each rank writing and attending on its
own cache shard: reduced qwen3 under both cache layouts, reduced
deepseek-v2's MLA under ``serve_ep`` with the gather and the einsum
MoE) against the plain step on one
device, logits within 1e-5 with an fp32 cache.

Needs no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m requires_h100 tests/test_torch_distributed_cuda.py

Elsewhere every case skips.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import compat, configs  # noqa: E402
from repro_torch.core.specializer import specialize_builder  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.distributed.sharding import (DEFAULT_RULES,  # noqa: E402
                                              mesh_context, replicate)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.transformer import RunOptions  # noqa: E402
from repro_torch.training import steps  # noqa: E402

#: a reduced deepseek-v2 MoE layer: 16 experts, top 6, two shared
MOE_CFG = ModelConfig(name="m", family="moe", n_layers=1, d_model=256,
                      n_heads=4, n_kv_heads=4, d_ff=512, vocab_size=128,
                      n_experts=16, top_k=6, moe_d_ff=128,
                      n_shared_experts=2, compute_dtype="float32")


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    if not compat.has_hopper():
        pytest.skip("needs a CUDA device of capability (9, 0)")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    compat.resolve_device("cuda")            # fp32 products: TF32 off
    torch.cuda.set_device(0)
    path = tmp_path_factory.mktemp("nccl") / "rendezvous"
    dist.init_process_group("nccl", init_method=f"file://{path}", rank=0,
                            world_size=1)
    yield make_local_mesh(1, 1)
    dist.destroy_process_group()


@pytest.mark.requires_h100
def test_compressed_psum_on_the_card(mesh, monkeypatch):
    import torch.distributed as dist

    wire = []
    orig = dist.all_gather_into_tensor

    def spy(out, inp, *a, **k):
        wire.append((out.dtype, inp.dtype, out.device.type))
        return orig(out, inp, *a, **k)

    monkeypatch.setattr(dist, "all_gather_into_tensor", spy)
    x = torch.randn(512, 384, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    y = compression.compressed_psum(x, "data", mesh)
    assert y.dtype == x.dtype and y.device == x.device
    assert float((y - x).abs().max() / x.abs().max()) < 0.02
    assert wire[0] == (torch.int8, torch.int8, "cuda")
    assert wire[1][0] == torch.float32


@pytest.mark.requires_h100
def test_shard_moe_matches_gather_on_the_card(mesh):
    dev = torch.device("cuda")
    p = moe.init_moe(torch.Generator(device=dev).manual_seed(0), MOE_CFG)
    x = torch.randn((2, 256, MOE_CFG.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    out = {}
    moe.reset_degrades()
    with torch.no_grad(), mesh_context(mesh, DEFAULT_RULES):
        for impl in ("shard", "gather"):
            o, _ = moe.apply_moe(p, x, MOE_CFG,
                                 moe.MoEOptions(impl=impl,
                                                capacity_factor=8.0))
            out[impl] = replicate(o)
    assert moe.degrades == 0
    rel = (out["shard"] - out["gather"]).abs().max() \
        / out["gather"].abs().max()
    assert float(rel) <= 1e-5


@pytest.mark.requires_h100
@pytest.mark.parametrize("arch,config", [
    ("qwen3-0.6b", {"cache_layout": "seq"}),
    ("qwen3-0.6b", {"cache_layout": "batch"}),
    ("deepseek-v2-236b", {"sharding_profile": "serve_ep",
                          "moe_impl": "gather"}),
    # the einsum MoE on each rank's own tokens: its replicated dispatch
    # failed DTensor's view rule under serve_ep on torch 2.11
    ("deepseek-v2-236b", {"sharding_profile": "serve_ep",
                          "moe_impl": "einsum"}),
])
def test_cached_step_on_the_mesh_matches_plain(mesh, arch, config):
    """Decode steps of the repaired cached step on the card's (1, 1) mesh
    against the plain step (both on ``torch_ref``), from one fp32 cache
    each: the logits of every step within 1e-5 of the plain step's
    largest."""
    dev = torch.device("cuda")
    cfg = configs.get_reduced(arch).replace(compute_dtype="float32")
    config = dict(config, cache_dtype="float32")
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    plain = specialize_builder(steps.make_decode_builder(
        cfg, kernel_impl="torch_ref"), config).fn
    sharded = specialize_builder(steps.make_decode_builder(
        cfg, mesh, kernel_impl="torch_ref"), config).fn
    opts = RunOptions(decode_cache_dtype="float32")
    c_plain = model.init_cache(cfg, 4, 16, opts, device=dev)
    c_mesh = model.init_cache(cfg, 4, 16, opts, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for t in range(6):
        tok = torch.randint(0, cfg.vocab_size, (4,), generator=gen,
                            device=dev, dtype=torch.int32)
        pos = torch.tensor(t, dtype=torch.int32, device=dev)
        lg_p, c_plain = plain(params, c_plain, tok, pos)
        lg_m, c_mesh = sharded(params, c_mesh, tok, pos)
        assert type(lg_m) is torch.Tensor
        err = float((lg_m - lg_p).abs().max() / lg_p.abs().max())
        assert err <= 1e-5, (t, err)
