"""The port's serving stack end to end against the JAX reference, its
device policy, and its import boundary.

Both packages' engines serve the same schedule from the same parameters
at reduced qwen3-0.6b, with every context pinned to ``cache_dtype=float32``
and the reference rmsnorm entry (so exploration timing cannot change the
numerics); greedy decoding must then give the same tokens per request.
"""
import argparse
import ast
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


@pytest.mark.parametrize("flag", [["--cache-dir", "x"], ["--replicas", "2"],
                                  ["--tenant", "a=qwen3-0.6b"],
                                  ["--plane-dir", "x"]])
def test_unported_flags_exit_naming_roadmap(flag, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu"] + flag)
    assert "ROADMAP" in capsys.readouterr().err


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
    assert len(files) > 20
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
