"""The kernels on the MoE + MLA path, each against its plain version, on a
Hopper GPU: the flash attention at deepseek-v2-236b's MLA prefill shape
(128 heads, q/k head dim 192, v 128, causal, S = 4096) at every tile pair;
the RMSNorm at its widths 5120 (the pre-norms), 1536 (MLA's ``q_norm``)
and 512 (its ``kv_norm``); one full-width deepseek-v2 MoE + MLA layer; and
the whole forward of reduced deepseek-v2 and kimi-k2, the kernels against
the plain versions.

Needs no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m requires_h100 tests/test_torch_moe_mla_cuda.py

Elsewhere every case skips.  Tolerances are ``chip_smoke.py``'s: the
flash attention's fp32 2e-4 (``ATTN_TOL``), with a second limit scaled to
every element (see tests/test_torch_attention_cuda.py), and the RMSNorm's
fp32 1e-5 (``TOL``); the layer and the forwards, which run both kernels,
within the attention's 2e-4.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import compat, configs  # noqa: E402
from repro_torch.kernels.attention import attention  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.models import KernelOptions  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402

ARCH = "deepseek-v2-236b"
ATTN_TOL = 2e-4
ATTN_SCALED_TOL = (1e-5, 1e-5)
NORM_TOL = 1e-5
TILES = [(bq, bkv) for bq in attn_kernel.BLOCK_Q
         for bkv in attn_kernel.BLOCK_KV]
S = 4096


@pytest.fixture
def hopper():
    if not compat.has_hopper():
        pytest.skip("needs a CUDA device of capability (9, 0)")
    return torch.device("cuda")


def _randn(rs, shape, device):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device)


@pytest.mark.requires_h100
@pytest.mark.parametrize("tiles", TILES)
def test_attention_at_the_mla_prefill_shape(hopper, tiles):
    cfg = configs.get_config(ARCH)
    h, d, dv = (cfg.n_heads, cfg.nope_head_dim + cfg.rope_head_dim,
                cfg.d_head)
    assert (h, d, dv) == (128, 192, 128)
    rs = np.random.RandomState(0)
    q, k = (_randn(rs, (1, h, S, d), hopper) for _ in range(2))
    v = _randn(rs, (1, h, S, dv), hopper)
    before = attn_kernel.launches
    out = attention(q, k, v, causal=True, scale=d ** -0.5, impl="cuda",
                    block_q=tiles[0], block_kv=tiles[1])
    torch.cuda.synchronize()
    assert attn_kernel.launches == before + 1
    ref = attention(q, k, v, causal=True, scale=d ** -0.5, impl="torch_ref")
    torch.testing.assert_close(out, ref, rtol=ATTN_TOL, atol=ATTN_TOL)
    torch.testing.assert_close(out, ref, rtol=ATTN_SCALED_TOL[0],
                               atol=ATTN_SCALED_TOL[1])


@pytest.mark.requires_h100
@pytest.mark.parametrize("width", ["d_model", "q_lora_rank",
                                   "kv_lora_rank"])
def test_rmsnorm_at_the_mla_widths(hopper, width):
    d = getattr(configs.get_config(ARCH), width)
    rs = np.random.RandomState(1)
    x = _randn(rs, (S, d), hopper)
    w = 1 + 0.1 * _randn(rs, (d,), hopper)
    before = rms_kernel.launches
    out = rmsnorm(x, w, impl="cuda")
    torch.cuda.synchronize()
    assert rms_kernel.launches == before + 1
    torch.testing.assert_close(out, rmsnorm(x, w, impl="torch_ref"),
                               rtol=NORM_TOL, atol=NORM_TOL)


@pytest.mark.requires_h100
def test_moe_mla_layer_at_full_width(hopper):
    """One full-width deepseek-v2 MoE layer (MLA, 160 experts top-6 and 2
    shared) on (1, 4096) inputs: the kernels (RMSNorm, the flash attention)
    against the plain versions, on the same weights; the same routing, so
    the same aux loss."""
    cfg = configs.get_config(ARCH).replace(n_layers=2,
                                           compute_dtype="float32")
    gen = torch.Generator(device=hopper).manual_seed(0)
    params = model.init_params(gen, cfg)
    layer = model._layer(params["moe_layers"], 0)
    del params["dense_layers"], params["embed"], params["lm_head"]
    x = torch.randn((1, S, cfg.d_model), generator=gen, device=hopper)
    launches = (rms_kernel.launches, attn_kernel.launches)
    outs, aux = {}, {}
    for impl in ("cuda", "torch_ref"):
        opts = model.RunOptions(kernels=KernelOptions(impl=impl))
        outs[impl], aux[impl] = model._layer_fwd(layer, x, cfg, opts, True)
    torch.cuda.synchronize()
    # the two pre-norms and MLA's two latent norms; one attention
    assert (rms_kernel.launches, attn_kernel.launches) == (
        launches[0] + 4, launches[1] + 1)
    assert torch.isfinite(outs["cuda"]).all()
    torch.testing.assert_close(outs["cuda"], outs["torch_ref"],
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    torch.testing.assert_close(aux["cuda"], aux["torch_ref"], rtol=1e-5,
                               atol=0)


@pytest.mark.requires_h100
@pytest.mark.parametrize("arch", [ARCH, "kimi-k2-1t-a32b"])
def test_reduced_prefill_kernels_match_plain(hopper, arch):
    """The full-sequence forward of the reduced config, every kernel
    against every plain version: logits and the MoE aux loss."""
    cfg = configs.get_reduced(arch).replace(compute_dtype="float32")
    gen = torch.Generator(device=hopper).manual_seed(0)
    params = model.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                           device=hopper, dtype=torch.int32)
    before = attn_kernel.launches
    out = {impl: model.apply(params, cfg, model.RunOptions(
        kernels=KernelOptions(impl=impl)), tokens=tokens)
        for impl in ("cuda", "torch_ref")}
    torch.cuda.synchronize()
    assert attn_kernel.launches == before + cfg.n_layers
    torch.testing.assert_close(out["cuda"][0], out["torch_ref"][0],
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    torch.testing.assert_close(out["cuda"][1], out["torch_ref"][1],
                               rtol=1e-5, atol=0)
    assert float(out["cuda"][1]) > 0
