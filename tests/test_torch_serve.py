"""The port's serving stack end to end against the JAX reference, its
device policy, and its import boundary.

Both packages' engines serve the same schedule from the same parameters
at reduced qwen3-0.6b, with every context pinned to ``cache_dtype=float32``
and the reference rmsnorm entry (so exploration timing cannot change the
numerics); greedy decoding must then give the same tokens per request.
"""
import argparse
import ast
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import Controller as RefController  # noqa: E402
from repro.core import ExhaustiveSweep as RefSweep  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.serve import OpenLoopSource as RefSource  # noqa: E402
from repro.serve import Request as RefRequest  # noqa: E402
from repro_torch import compat  # noqa: E402
from repro_torch.core import Controller, ExhaustiveSweep  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serve import OpenLoopSource, Request  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINE_ARGS = ["--batch", "2", "--max-len", "32", "--prefill-chunk", "4",
               "--bucket-dwell", "100000", "--kv-dwell", "100000",
               "--compile-workers", "1", "--no-safety"]
#: (prompt tokens, new tokens) per request, all arriving at once
WORKLOAD = [(5, 4), (9, 3), (3, 5), (7, 2)]


def _args(add_engine_args, extra=()):
    ap = argparse.ArgumentParser()
    add_engine_args(ap)
    return ap.parse_args(ENGINE_ARGS + list(extra))


def _serve(built, controller_cls, sweep_cls, source_cls, request_cls,
           pinned):
    """Pin every context to ``pinned`` and serve WORKLOAD; returns the
    generated token ids per request id."""
    built.engine.controller = controller_cls(
        built.handler, lambda: sweep_cls([dict(pinned)]), dwell=1000,
        wait_compiles=True, prefetch=0)
    reqs = [request_cls(rid=1000 + i, prompt_tokens=p, max_new_tokens=m)
            for i, (p, m) in enumerate(WORKLOAD)]
    built.engine.run(source=source_cls(built.engine.queue,
                                       [(0.0, r) for r in reqs]),
                     max_steps=200)
    assert built.engine.drain(timeout_s=60.0)
    built.engine.shutdown()
    return {r.rid: list(r.payload) for r in reqs}


def test_served_tokens_match_reference():
    ref_built = ref_serve.build_engine(_args(ref_serve.add_engine_args))
    np_params = jax.tree_util.tree_map(np.asarray,
                                       ref_built.engine.executor.params)
    built = serve.build_engine(_args(serve.add_engine_args,
                                     ["--device", "cpu"]),
                               params=params_from_numpy(np_params, "cpu"))
    ref_tokens = _serve(ref_built, RefController, RefSweep, RefSource,
                        RefRequest, {"cache_dtype": "float32",
                                     "rmsnorm_impl": "xla_ref"})
    tokens = _serve(built, Controller, ExhaustiveSweep, OpenLoopSource,
                    Request, {"cache_dtype": "float32",
                              "rmsnorm_impl": "torch_ref"})
    assert [len(t) for t in tokens.values()] == [m for _, m in WORKLOAD]
    assert tokens == ref_tokens
    active = {built.handler.active_config(context=k)["rmsnorm_impl"]
              for k in built.handler.contexts() if k != "default"}
    assert active == {"torch_ref"}


def test_entry_points_need_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_engine(_args(serve.add_engine_args))
    assert compat.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("entry", ["init_cache", "init_gqa_cache",
                                   "init_rwkv6_cache", "PagedKV",
                                   "params_from_numpy"])
def test_device_defaults_to_cuda(monkeypatch, entry):
    """Public functions that place tensors default to ``cuda``, never to
    the host: without a CUDA device they raise unless given a device."""
    from repro_torch import configs
    from repro_torch.models import attention, rwkv6, transformer
    from repro_torch.serve import PagedKV

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_reduced("qwen3-0.6b")
    rwkv = configs.get_reduced("rwkv6-1.6b")
    calls = {
        "init_cache": lambda **kw: transformer.init_cache(cfg, 1, 8, **kw),
        "init_gqa_cache": lambda **kw: attention.init_gqa_cache(cfg, 1, 8,
                                                                **kw),
        "init_rwkv6_cache": lambda **kw: rwkv6.init_rwkv6_cache(rwkv, 1,
                                                                **kw),
        "PagedKV": lambda **kw: PagedKV(
            transformer.init_cache(cfg, 1, 8, transformer.RunOptions(
                decode_cache_dtype="float32"), device="cpu"),
            transformer.cache_axes(cfg), max_len=8, capacity_tokens=8, **kw),
        "params_from_numpy": lambda **kw: params_from_numpy(
            {"w": np.zeros(3, np.float32)}, **kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    out = calls[entry](device="cpu")
    leaves = compat.tree_leaves(out) if entry != "PagedKV" else []
    assert all(t.device.type == "cpu" for t in leaves)


#: a short CPU run of the driver (reduced qwen3-0.6b)
CLI = ["--device", "cpu", "--steps", "200", "--requests", "4", "--rate",
       "40", "--dwell", "2", "--compile-workers", "1"]


def _main(capsys, *extra):
    serve.main(CLI + list(extra))
    return capsys.readouterr().out


def _line(out, prefix):
    return next(ln for ln in out.splitlines() if ln.startswith(prefix))


def test_cache_dir_warm_restart(tmp_path, capsys):
    """``--cache-dir`` twice: the second run restores the saved spec state
    and finds its variants in the cache."""
    cache = str(tmp_path / "cache")
    cold = _main(capsys, "--cache-dir", cache)
    assert "restored spec state" not in cold
    assert (tmp_path / "cache" / "spec_state.json").is_file()
    warm = _main(capsys, "--cache-dir", cache)
    assert _line(warm, "restored spec state:")
    stats = json.loads(_line(warm, "compile stats: ")[len("compile stats: "):])
    assert stats["cache_hits"] > 0
    assert "served 4 requests" in warm


def test_tenant_flag_serves_each_tenant(capsys):
    out = _main(capsys, "--tenant", "a=qwen3-0.6b:60000:2", "--tenant",
                "b=qwen3-0.6b")
    assert "served 8 requests" in out and "across 2 tenants" in out
    assert "tenant a: completed=4" in out and "tenant b: completed=4" in out
    assert '"weights": {"a": 2.0, "b": 1.0}' in out   # drr by default


def test_plane_dir_publishes_and_seeds(tmp_path, capsys):
    plane = str(tmp_path / "plane")
    # the plain Controller settles within a short run
    out = _main(capsys, "--plane-dir", plane, "--replica-id", "r0",
                "--requests", "12", "--steps", "400", "--no-safety")
    published = int(_line(out, "plane: published").split()[2])
    assert published > 0
    out = _main(capsys, "--plane-dir", plane, "--replica-id", "r1",
                "--no-safety")
    assert _line(out, "plane: seeded contexts=")


def test_replicas_run_a_fleet_of_workers(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")    # two workers share a host
    snap = tmp_path / "snap.json"
    out = _main(capsys, "--replicas", "2", "--requests", "2",
                "--plane-dir", str(tmp_path / "plane"),
                "--cache-dir", str(tmp_path / "cache"), "--portable-cache",
                "--telemetry-snapshot", str(snap))
    assert "fleet: 2 workers ready" in out
    assert "fleet served 4 requests" in out
    assert _line(out, "fleet p50/p95/p99 latency ms:")
    assert _line(out, "replica 0:") and _line(out, "replica 1:")
    assert json.loads(snap.read_text())["mode"] == "fleet"


def test_tenant_with_replicas_errors_as_reference(capsys):
    with pytest.raises(SystemExit):
        serve.main(CLI + ["--tenant", "a=qwen3-0.6b", "--replicas", "2"])
    assert "--tenant is single-process" in capsys.readouterr().err


def _imported_modules(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(files) > 20
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_serve_adaptive_example_on_the_host(capsys):
    """``examples/serve_adaptive_torch.py`` (the reference's
    ``examples/serve_adaptive.py`` on the port) at a few steps; without
    ``--steps`` it adds the reference's 240."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_serve_adaptive_torch", ROOT / "examples" / "serve_adaptive_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", "--steps", "30", "--requests", "3",
              "--dwell", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out
