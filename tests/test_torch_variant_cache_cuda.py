"""The persistent variant cache with K1's library, on a Hopper GPU.

Needs no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m requires_h100 tests/test_torch_variant_cache_cuda.py

Elsewhere every case skips.  A variant naming K1's ``cuda`` entry stores
the built library; a fresh process whose build directory lacks it loads
it from the cache with no ``nvcc`` call and computes what ``torch_ref``
computes; an entry built from other sources is a miss.
"""
import json
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import compat  # noqa: E402
from repro_torch.core import IridescentRuntime, VariantCache  # noqa: E402
from repro_torch.core import variant_cache as vc  # noqa: E402
from repro_torch.kernels import build, registry  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"

#: run in a fresh process: build directory of its own (without K1's
#: library), every subprocess it starts recorded; one specialized variant
#: naming K1, then one K1 call against torch_ref
FRESH = r"""
import json, subprocess, sys
from pathlib import Path
import torch
from repro_torch import compat
compat.BUILD_DIR = Path(sys.argv[2])
commands = []
_run = subprocess.run
def run(cmd, *a, **k):
    commands.append([str(c) for c in cmd])
    return _run(cmd, *a, **k)
subprocess.run = run
from repro_torch.core import IridescentRuntime
from repro_torch.kernels import build, registry
from repro_torch.kernels.rmsnorm import kernel, ref
def builder(spec):
    impl = registry.impl_point(spec, "rmsnorm")
    return lambda x, w: registry.dispatch("rmsnorm", impl, x, w)
rt = IridescentRuntime(async_compile=False, variant_cache=sys.argv[1])
h = rt.register("norm", builder)
h.specialize({"rmsnorm_impl": "cuda"}, wait=True)
g = torch.Generator(device="cuda").manual_seed(0)
x = torch.randn(64, 1024, device="cuda", generator=g)
w = torch.randn(1024, device="cuda", generator=g)
out = h(x, w)
torch.cuda.synchronize()
print(json.dumps({
    "stats": rt.compile_stats(),
    "log": {k: v for k, v in build.build_log("rmsnorm").items() if k != "log"},
    "launches": kernel.launches,
    "max_abs_err": (out - ref.rmsnorm(x, w, 1e-6)).abs().max().item(),
    "builds": [c for c in commands if "-shared" in c]}))
rt.shutdown()
"""


@pytest.fixture
def hopper():
    if not compat.has_hopper():
        pytest.skip("needs a CUDA device of capability (9, 0)")
    return torch.device("cuda")


def _builder(spec):
    impl = registry.impl_point(spec, "rmsnorm")
    return lambda x, w: registry.dispatch("rmsnorm", impl, x, w)


def _populate(cache_dir):
    """Build, in this process, a variant naming K1's ``cuda`` entry with
    the cache at ``cache_dir``; returns that cache."""
    rt = IridescentRuntime(async_compile=False, variant_cache=cache_dir)
    h = rt.register("norm", _builder)
    h.specialize({"rmsnorm_impl": "cuda"}, wait=True)
    stats = rt.compile_stats()
    rt.shutdown()
    assert stats["cache"]["stores"] >= 1
    return VariantCache(cache_dir)


def _entries(cache):
    out = []
    for key in cache.entries():
        with open(cache._path(key), "rb") as f:
            out.append((key, pickle.load(f)))
    return out


@pytest.mark.requires_h100
def test_variant_naming_k1_stores_its_library(hopper, tmp_path):
    cache = _populate(str(tmp_path / "variants"))
    libs = [lib for _, e in _entries(cache) for lib in e["libraries"]]
    assert libs and {lib["name"] for lib in libs} == {"rmsnorm"}
    built = build.library_path("rmsnorm", kernel.SOURCE).read_bytes()
    for lib in libs:
        assert lib["blob"] == built
        assert lib["digest"] == build.source_digest(kernel.SOURCE)
        assert lib["source"] == "kernels/rmsnorm/csrc/rmsnorm.cu"


@pytest.mark.requires_h100
def test_fresh_process_loads_k1_from_cache_without_nvcc(hopper, tmp_path):
    cache_dir = str(tmp_path / "variants")
    _populate(cache_dir)
    empty = tmp_path / "build"                  # K1's library not in it
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", FRESH, cache_dir,
                           str(empty)], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["builds"] == []                  # no nvcc build ran
    assert got["log"]["built"] is False
    assert Path(got["log"]["path"]).parent == empty
    assert got["stats"]["xla_compiles"] == 0
    assert got["stats"]["cache_hits"] >= 2      # generic + cuda variant
    assert got["launches"] == 1
    assert got["max_abs_err"] <= 1e-5


@pytest.mark.requires_h100
def test_entry_of_other_sources_is_a_miss(hopper, tmp_path):
    """An entry whose library was built from another version of the
    source (its digest differs) is never served."""
    cache = _populate(str(tmp_path / "variants"))
    tampered = 0
    for key, entry in _entries(cache):
        if not entry["libraries"]:
            continue
        for lib in entry["libraries"]:
            lib["digest"] = "0" * 12
        with open(cache._path(key), "wb") as f:
            pickle.dump(entry, f)
        fresh = VariantCache(cache.directory)
        assert fresh.load(key) is None
        assert fresh.stats.misses.value() == 1
        assert fresh.stats.errors.value() == 0
        tampered += 1
    assert tampered
    assert not (compat.BUILD_DIR / f"librmsnorm-{'0' * 12}.so").exists()


@pytest.mark.requires_h100
def test_fingerprint_carries_capability_and_nvcc_release(hopper):
    fp = vc.backend_fingerprint()
    assert "|sm90|" in fp
    out = subprocess.run([compat.nvcc_path(), "--version"],
                         capture_output=True, text=True).stdout
    release = re.search(r"release ([\d.]+)", out).group(1)
    assert f"|nvcc-{release}|" in fp
    assert torch.cuda.get_device_name(0) in fp
    assert fp.endswith(f"|{torch.cuda.device_count()}")
