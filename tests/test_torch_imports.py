"""The port's import firewall, the counterpart of the reference's drift
firewall (``tests/test_kernel_registry.py::
test_no_direct_experimental_imports_outside_compat``): nothing the port
ships imports JAX or the JAX package.  Every file under
``src/repro_torch/``, ``chip_smoke.py``, ``examples/*_torch.py`` and
``tools/*.py`` is read with ``ast`` (imports inside functions included),
and every module of the port is imported in a fresh interpreter, which
must end with no ``jax`` module loaded."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _shipped() -> list[pathlib.Path]:
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("*_torch.py"))
            + sorted((ROOT / "tools").glob("*.py")))


def _forbidden(name: str) -> bool:
    """``jax`` and its submodules, ``repro`` and its submodules (not
    ``repro_torch``)."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path) -> list[tuple[int, str]]:
    """(line, module) of every import statement in ``path``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module or ""))
    return out


def test_files_the_port_ships_exist():
    files = _shipped()
    assert PORT / "__init__.py" in files
    assert len(files) > 50 and all(f.exists() for f in files)


@pytest.mark.parametrize("area", ["src/repro_torch", "chip_smoke.py",
                                  "examples", "tools"])
def test_no_jax_or_reference_import(area):
    files = [f for f in _shipped()
             if str(f.relative_to(ROOT)).startswith(area)]
    assert files
    offenders = [f"{f.relative_to(ROOT)}:{line}: {name}"
                 for f in files for line, name in _imports(f)
                 if _forbidden(name)]
    assert not offenders, offenders


def test_forbidden_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("repro") and _forbidden("repro.core.runtime")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.core")
    assert not _forbidden("torch") and not _forbidden("jaxtyping_x")


_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "jax": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))}))
"""


def test_every_port_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["jax"] == []
    wanted = {"repro_torch.core.runtime", "repro_torch.kernels.registry",
              "repro_torch.launch.dryrun", "repro_torch.serve.engine"}
    assert wanted <= set(res["modules"])
    assert len(res["modules"]) == len(
        [p for p in PORT.rglob("*.py")
         if p.name != "__main__.py"]), res["modules"]
