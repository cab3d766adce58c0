"""The port stands alone: rio_tpu_torch and chip_smoke.py import neither jax nor rio_tpu."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "rio_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "rio_tpu"}

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import rio_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rio_tpu_torch.__path__, "rio_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "rio_tpu"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_importing_every_module_of_the_port_loads_no_jax():
    # A fresh interpreter: the root conftest.py has already imported jax here.
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "rio_tpu_torch.ops.scaling" in result["imported"]
    assert "rio_tpu_torch.kernels.build" in result["imported"]
    assert "rio_tpu_torch.object_placement.torch_placement" in result["imported"]
    assert "rio_tpu_torch.object_placement.persistent" in result["imported"]
    assert "rio_tpu_torch.parallel.hierarchical" in result["imported"]
    assert "rio_tpu_torch.parallel.mesh" in result["imported"]
    assert "rio_tpu_torch.parallel.multihost" in result["imported"]
    assert "rio_tpu_torch.ops.prng" in result["imported"]
    assert "rio_tpu_torch.bench" in result["imported"]
    assert "rio_tpu_torch.profiling" in result["imported"]
    assert result["bad"] == [], f"the port loaded {result['bad']}"


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None)) in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax(path):
    assert path.exists()
    assert not FORBIDDEN & set(_imported_roots(path))


def test_the_port_bench_imports_nothing_of_the_reference_bench():
    # bench.py at the root is the reference; the port keeps its own copies.
    roots = set(_imported_roots(ROOT / "rio_tpu_torch" / "bench.py"))
    assert "bench" not in roots and not FORBIDDEN & roots
