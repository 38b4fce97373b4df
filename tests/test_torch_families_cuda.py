"""The kernels at the new families' full-width prefill shapes, each against
its plain version, on a Hopper GPU: the flash attention at hymba-1.5b's
windowed GQA (25 query / 5 kv heads of 64, window 1024), yi-6b's group of
8 and deepseek-7b's MHA at S = 4096; the chunked linear attention as
hymba's SSM heads call it (inclusive, a scalar decay broadcast over the
state dim) at every chunk; and one full-width hymba layer, the kernels
against the plain versions.

Needs no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m requires_h100 tests/test_torch_families_cuda.py

Elsewhere every case skips.  Tolerances are ``chip_smoke.py``'s: the flash
attention's fp32 2e-4 (``ATTN_TOL``) and the linear attention's fp32 5e-4
(``LINATT_TOL``), each with a second limit scaled to every element (see
tests/test_torch_attention_cuda.py and
tests/test_torch_linear_attention_cuda.py for their reasons); the layer,
which runs both kernels, within the looser 5e-4.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import compat, configs  # noqa: E402
from repro_torch.kernels.attention import attention  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.linear_attention import (  # noqa: E402
    kernel as la_kernel, linear_attention)
from repro_torch.models import KernelOptions  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402

ATTN_TOL = 2e-4
ATTN_SCALED_TOL = (1e-5, 1e-5)
LINATT_TOL = 5e-4
LINATT_SCALED_TOL = (5e-5, 2e-4)
TILES = [(bq, bkv) for bq in attn_kernel.BLOCK_Q
         for bkv in attn_kernel.BLOCK_KV]
S = 4096

#: (query heads, kv heads, head dim, window) of each family's prefill
ATTN_CASES = {
    "hymba-1.5b": (25, 5, 64, 1024),
    "yi-6b": (32, 4, 128, None),
    "deepseek-7b": (32, 32, 128, None),
}


@pytest.fixture
def hopper():
    if not compat.has_hopper():
        pytest.skip("needs a CUDA device of capability (9, 0)")
    return torch.device("cuda")


def _randn(rs, shape, device, scale=1.0):
    return torch.from_numpy((rs.randn(*shape) * scale).astype(
        np.float32)).to(device)


def _hold(out, ref, tol, scaled):
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    torch.testing.assert_close(out, ref, rtol=scaled[0], atol=scaled[1])


@pytest.mark.requires_h100
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("arch", sorted(ATTN_CASES))
def test_attention_at_the_family_prefill_shape(hopper, arch, tiles):
    h, hk, d, window = ATTN_CASES[arch]
    cfg = configs.get_config(arch)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.window) == (
        h, hk, d, window)
    rs = np.random.RandomState(0)
    q = _randn(rs, (1, h, S, d), hopper)
    k, v = (_randn(rs, (1, hk, S, d), hopper) for _ in range(2))
    before = attn_kernel.launches
    out = attention(q, k, v, causal=True, window=window, impl="cuda",
                    block_q=tiles[0], block_kv=tiles[1])
    torch.cuda.synchronize()
    assert attn_kernel.launches == before + 1
    ref = attention(q, k, v, causal=True, window=window, impl="torch_ref")
    _hold(out, ref, ATTN_TOL, ATTN_SCALED_TOL)


@pytest.mark.requires_h100
@pytest.mark.parametrize("chunk", la_kernel.CHUNKS)
def test_linear_attention_at_hymba_prefill_shape(hopper, chunk):
    """hymba's SSM call at (25 heads, 4096, N = 16, dv = 64): q = C and
    k = B one row per step broadcast over the heads, one log decay per
    (head, step) broadcast over N, inclusive, no bonus."""
    cfg = configs.get_config("hymba-1.5b")
    h, n, dv = cfg.ssm_heads, cfg.ssm_state, cfg.d_head
    assert (h, n, dv) == (25, 16, 64)
    rs = np.random.RandomState(1)
    q, k = (_randn(rs, (1, S, n), hopper, 0.25).expand(h, S, n)
            for _ in range(2))
    v = _randn(rs, (h, S, dv), hopper)
    log_w = -torch.from_numpy(rs.uniform(1e-4, 1.0, (h, S, 1)).astype(
        np.float32)).to(hopper)
    before = la_kernel.launches
    out = linear_attention(q, k, v, log_w, inclusive=True, chunk=chunk,
                           impl="cuda")
    torch.cuda.synchronize()
    assert la_kernel.launches == before + 1
    ref = linear_attention(q, k, v, log_w, inclusive=True, chunk=chunk,
                           impl="torch_ref")
    _hold(out, ref, LINATT_TOL, LINATT_SCALED_TOL)


@pytest.mark.requires_h100
def test_hymba_layer_at_full_width(hopper):
    """One full-width hymba layer on (1, 4096) inputs: every kernel
    (RMSNorm, the windowed flash attention, the linear attention) against
    every plain version, on the same weights."""
    cfg = configs.get_config("hymba-1.5b").replace(n_layers=1,
                                                   compute_dtype="float32")
    gen = torch.Generator(device=hopper).manual_seed(0)
    params = model.init_params(gen, cfg)
    layer = model._layer(params["dense_layers"], 0)
    x = torch.randn((1, S, cfg.d_model), generator=gen, device=hopper)
    launches = (attn_kernel.launches, la_kernel.launches)
    outs = {}
    for impl in ("cuda", "torch_ref"):
        opts = model.RunOptions(kernels=KernelOptions(impl=impl,
                                                      chunk_len=64))
        outs[impl], _ = model._layer_fwd(layer, x, cfg, opts, False)
    torch.cuda.synchronize()
    assert (attn_kernel.launches, la_kernel.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert torch.isfinite(outs["cuda"]).all()
    torch.testing.assert_close(outs["cuda"], outs["torch_ref"],
                               rtol=LINATT_TOL, atol=LINATT_TOL)
