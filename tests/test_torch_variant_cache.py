"""The port's persistent variant cache: the counterparts of
tests/test_variant_cache.py's cases, and a stale build that is never
served.

In the port a variant's "compile" builds and loads the kernel libraries
its configuration names, and an entry holds those libraries.  On the CPU
a variant names none, so its entry is a record only; a hit counts as the
reference's does, and the runtime's ``xla_compiles`` counter (the name
both packages' CompileService keeps) counts the variants that missed.
The reference's two AOT-failure cases (a transient failure of the AOT
executable falls back to jit; consecutive ones demote the variant) have
no counterpart: the port has no AOT step, every variant runs its closure
eagerly.
"""
import dataclasses
import os
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import compat  # noqa: E402
from repro_torch.core import (EnumPoint, IridescentRuntime,  # noqa: E402
                              VariantCache)
from repro_torch.core import variant_cache as vc  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


def _mm_builder(spec):
    spec.enum("B", 8, (4, 8, 16))

    def matmul(L, R):
        return (L @ R) * 1.0

    return matmul


def _run_once(cache_dir, specialize_cfg, **cache_kw):
    rt = IridescentRuntime(async_compile=False,
                           variant_cache=VariantCache(cache_dir, **cache_kw))
    h = rt.register("m", _mm_builder)
    out_generic = h(torch.ones(8, 8), torch.eye(8))
    h.specialize(specialize_cfg, wait=True)
    out_spec = h(torch.ones(8, 8), torch.eye(8))
    stats = rt.compile_stats()
    from_cache = [v.from_cache for v in h.variants()]
    rt.shutdown()
    return out_generic, out_spec, stats, from_cache


def test_warm_restart_zero_builds(tmp_path):
    cache_dir = str(tmp_path / "variants")
    g1, s1, cold, _ = _run_once(cache_dir, {"B": 4})
    assert cold["xla_compiles"] >= 2            # generic + specialized
    assert cold["cache"]["stores"] >= 2
    g2, s2, warm, from_cache = _run_once(cache_dir, {"B": 4})
    assert warm["xla_compiles"] == 0            # zero builds on warm start
    assert warm["cache_hits"] >= 2
    assert all(from_cache)
    torch.testing.assert_close(g1, g2)
    torch.testing.assert_close(s1, s2)


def test_unseen_config_still_builds_on_warm_start(tmp_path):
    cache_dir = str(tmp_path / "variants")
    _run_once(cache_dir, {"B": 4})
    _, _, stats, _ = _run_once(cache_dir, {"B": 16})   # new config
    assert stats["cache_hits"] >= 1             # generic came from cache
    assert stats["xla_compiles"] == 1           # only the unseen config


def test_corrupted_entry_falls_back_to_build(tmp_path):
    cache_dir = str(tmp_path / "variants")
    _run_once(cache_dir, {"B": 4})
    cache = VariantCache(cache_dir)
    entries = cache.entries()
    assert entries
    for key in entries:                          # corrupt every entry
        with open(cache._path(key), "wb") as f:
            f.write(b"not a pickle at all")
    _, s, stats, _ = _run_once(cache_dir, {"B": 4})
    assert stats["xla_compiles"] >= 2            # built from scratch
    assert stats["cache"]["errors"] >= 1
    torch.testing.assert_close(s, torch.ones(8, 8))
    # bad entries were replaced by fresh ones: a third run hits again
    _, _, stats3, _ = _run_once(cache_dir, {"B": 4})
    assert stats3["xla_compiles"] == 0


def test_cache_key_distinguishes_arg_shapes(tmp_path):
    """The runtime keys an entry by its context (libraries are built
    before a context's first call is seen): with the shape as the
    context, another shape is another entry, never a bogus hit."""
    cache_dir = str(tmp_path / "variants")
    shape_ctx = lambda a, k: tuple(a[0].shape)  # noqa: E731
    rt = IridescentRuntime(async_compile=False, variant_cache=cache_dir)
    rt.register("m", _mm_builder, context_fn=shape_ctx)(torch.ones(4, 4),
                                                        torch.eye(4))
    rt.shutdown()
    rt2 = IridescentRuntime(async_compile=False, variant_cache=cache_dir)
    h2 = rt2.register("m", _mm_builder, context_fn=shape_ctx)
    base = rt2.compile_stats()["cache_hits"]     # the default context's
    out = h2(torch.ones(8, 8), torch.eye(8))
    assert out.shape == (8, 8)
    assert rt2.compile_stats()["cache_hits"] == base
    rt2.shutdown()
    cache = VariantCache(cache_dir)
    fp = [vc.spec_fingerprint((torch.ones(n, n),), {}) for n in (4, 8)]
    assert fp[0] != fp[1] and "torch.float32(4, 4)@cpu" in fp[0]
    assert (cache.entry_key("m", (), False, fp[0])
            != cache.entry_key("m", (), False, fp[1]))


# --- LRU eviction ----------------------------------------------------------------

def _fill_entry(cache, key, nbytes):
    """Write a raw entry of a known size (content irrelevant for eviction)."""
    with open(cache._path(key), "wb") as f:
        f.write(b"x" * nbytes)


def test_lru_eviction_by_last_used(tmp_path):
    cache = VariantCache(str(tmp_path), max_bytes=250)
    for i, key in enumerate(("aa", "bb", "cc")):
        _fill_entry(cache, key, 100)
        os.utime(cache._path(key), (i, i))       # distinct, ordered mtimes
    assert sorted(cache.entries()) == ["aa", "bb", "cc"]
    os.utime(cache._path("aa"), None)            # 'aa' used most recently
    _fill_entry(cache, "dd", 100)
    with cache._lock:
        cache._evict_lru_locked(keep=cache._path("dd"))
    assert sorted(cache.entries()) == ["aa", "dd"]
    assert cache.stats.evictions.value() == 2


def test_lru_keeps_oversized_just_written_entry(tmp_path):
    cache = VariantCache(str(tmp_path), max_bytes=50)
    _fill_entry(cache, "big", 100)
    with cache._lock:
        cache._evict_lru_locked(keep=cache._path("big"))
    assert cache.entries() == ["big"]


def test_lru_eviction_end_to_end(tmp_path):
    """Real store() path: a byte cap of one keeps one entry."""
    cache_dir = str(tmp_path / "variants")
    rt = IridescentRuntime(async_compile=False,
                           variant_cache=VariantCache(cache_dir, max_bytes=1))
    h = rt.register("m", _mm_builder)
    h(torch.ones(4, 4), torch.eye(4))
    h.specialize({"B": 4}, wait=True)
    h.specialize({"B": 16}, wait=True)
    cache = rt.variant_cache
    assert cache.stats.stores.value() >= 3
    assert len(cache.entries()) <= 1             # cap enforced on insert
    assert cache.stats.evictions.value() >= 2
    rt.shutdown()


def test_unbounded_cache_never_evicts(tmp_path):
    cache_dir = str(tmp_path / "variants")
    _run_once(cache_dir, {"B": 4})
    cache = VariantCache(cache_dir)               # max_bytes=None
    assert cache.stats.evictions.value() == 0
    assert len(cache.entries()) >= 2


# -- portable (replica-fleet) cache keys ---------------------------------------

def test_default_cache_key_stays_pinned_to_device_count(tmp_path,
                                                        monkeypatch):
    cache = VariantCache(str(tmp_path))
    assert cache.portable is False
    monkeypatch.setattr(vc, "_device_info", lambda: ("H100", "sm90", 1))
    k1 = cache.entry_key("h", ("cfg",), False, "args")
    monkeypatch.setattr(vc, "_device_info", lambda: ("H100", "sm90", 4))
    k4 = cache.entry_key("h", ("cfg",), False, "args")
    assert k1 != k4


def test_portable_cache_key_ignores_device_count_only(tmp_path, monkeypatch):
    cache = VariantCache(str(tmp_path), portable=True)
    monkeypatch.setattr(vc, "_device_info", lambda: ("H100", "sm90", 1))
    k1 = cache.entry_key("h", ("cfg",), False, "args")
    monkeypatch.setattr(vc, "_device_info", lambda: ("H100", "sm90", 4))
    k4 = cache.entry_key("h", ("cfg",), False, "args")
    assert k1 == k4                      # count no longer in the key
    monkeypatch.setattr(vc, "_device_info", lambda: ("A100", "sm80", 4))
    assert cache.entry_key("h", ("cfg",), False, "args") != k4
    monkeypatch.setattr(vc, "_device_info", lambda: ("H100", "sm90", 4))
    monkeypatch.setattr(vc, "_nvcc_release", lambda: "99.9")
    assert cache.entry_key("h", ("cfg",), False, "args") != k4


def test_portable_and_pinned_caches_use_distinct_keys(tmp_path):
    pinned = VariantCache(str(tmp_path))
    portable = VariantCache(str(tmp_path), portable=True)
    args = ("h", ("cfg",), False, "args")
    assert pinned.entry_key(*args) != portable.entry_key(*args)


def test_portable_cache_round_trip(tmp_path):
    cache_dir = str(tmp_path / "portable")
    _, o1, cold, _ = _run_once(cache_dir, {"B": 4}, portable=True)
    _, o2, warm, _ = _run_once(cache_dir, {"B": 4}, portable=True)
    assert cold["xla_compiles"] >= 2
    assert warm["xla_compiles"] == 0
    assert warm["cache_hits"] >= 2
    torch.testing.assert_close(o1, o2)


def test_backend_fingerprint_names_toolchain_and_device(monkeypatch):
    if compat.nvcc_path() is None:
        assert "|nvcc-none|" in vc.backend_fingerprint()
    monkeypatch.setattr(vc, "_device_info", lambda: ("H100", "sm90", 2))
    monkeypatch.setattr(vc, "_nvcc_release", lambda: "12.8")
    fp = vc.backend_fingerprint()
    for part in (f"torch-{torch.__version__}", f"cuda-{torch.version.cuda}",
                 "H100", "sm90", "nvcc-12.8", " ".join(build.NVCC_FLAGS)):
        assert part in fp
    assert fp.endswith("|2")
    assert vc.backend_fingerprint(portable=True).endswith("|*")


# -- libraries in entries: a hit loads with no nvcc call; a stale one misses --

@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """A kernel source under a stand-in package root, a build directory of
    the test's own, and an ``nvcc`` stand-in: a build writes the library
    file (its bytes name the source digest) and counts one call; loading
    returns a stand-in for the ``ctypes`` handle."""
    root = tmp_path / "pkg"
    source = root / "kernels" / "fake" / "csrc" / "fake.cu"
    source.parent.mkdir(parents=True)
    source.write_text("// version 1\n")
    monkeypatch.setattr(vc, "_PACKAGE_ROOT", root)
    monkeypatch.setattr(compat, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_logs", {})
    calls = []

    def fake_nvcc_build(name, src):
        out = build.library_path(name, src)
        if out.is_file():
            return out, {"path": str(out), "seconds": 0.0, "built": False,
                         "log": ""}
        calls.append(name)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(b"LIB-" + build.source_digest(src).encode())
        return out, {"path": str(out), "seconds": 1.0, "built": True,
                     "log": ""}

    monkeypatch.setattr(build, "_build", fake_nvcc_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: Path(path))

    @dataclasses.dataclass(frozen=True)
    class LibPoint(EnumPoint):
        def prepare(self, value):
            if value == "fake":
                build.load_cuda_library("fake", source)

    def builder(spec):
        spec.point(LibPoint("impl", "fake", None, False,
                            choices=("fake", "plain")))
        return lambda x: x + 1

    def run():
        monkeypatch.setattr(build, "_libs", {})
        monkeypatch.setattr(build, "_logs", {})
        rt = IridescentRuntime(async_compile=False,
                               variant_cache=str(tmp_path / "variants"))
        h = rt.register("k", builder)
        out = h(torch.zeros(2))
        stats = rt.compile_stats()
        rt.shutdown()
        return out, stats, build.build_log("fake")

    return dict(source=source, calls=calls, run=run)


def test_library_hit_installs_and_loads_without_nvcc(fake_toolchain):
    f = fake_toolchain
    _, cold, log = f["run"]()
    assert f["calls"] == ["fake"] and log["built"]
    assert cold["cache"]["stores"] == 1
    lib = build.library_path("fake", f["source"])
    blob = lib.read_bytes()
    lib.unlink()                                  # moved out of BUILD_DIR
    out, warm, log = f["run"]()
    assert f["calls"] == ["fake"]                 # no second nvcc call
    assert warm["cache_hits"] == 1 and warm["xla_compiles"] == 0
    assert log["built"] is False and lib.read_bytes() == blob
    torch.testing.assert_close(out, torch.ones(2))


def test_stale_library_is_a_miss(fake_toolchain):
    f = fake_toolchain
    f["run"]()
    stale = build.library_path("fake", f["source"])
    stale.unlink()
    f["source"].write_text("// version 2\n")      # the source was edited
    _, stats, log = f["run"]()
    assert stats["cache_hits"] == 0 and stats["xla_compiles"] == 1
    assert stats["cache"]["misses"] == 1 and stats["cache"]["errors"] == 0
    assert f["calls"] == ["fake", "fake"] and log["built"]
    assert not stale.exists()                     # never reinstalled
    _, again, log = f["run"]()                    # the rebuilt entry hits
    assert again["cache_hits"] == 1 and not log["built"]
