"""Nothing the benchmark runs imports JAX or the JAX package; the reference imports no program.

The root ``conftest.py`` loads JAX into this process, so each check runs
its imports in a fresh interpreter and compares whole top-level names.
"""

import json
import subprocess
import sys

from rio_bench import harness

from .tiny import REPO

# Every driver, every metric reader and every driver's test file, found by glob.
LOAD_ALL = """
import json, sys
from rio_bench import control, harness
r = harness.Registry()
for path in sorted((r.root / "drivers").glob("*.py")):
    r.driver(path.stem)
for path in sorted((r.root / "metrics").glob("*.py")):
    r.metric(path.stem)
for path in sorted((r.root / "tests" / "drivers").glob("*.py")):
    r.driver_tests(path.stem)
import rio_tpu_torch.entry, rio_tpu_torch.parallel.hierarchical
import rio_tpu_torch.object_placement.torch_placement, rio_tpu_torch.registry
print(json.dumps(sorted({name.split(".")[0] for name in sys.modules})))
"""
# Every module of the plain reference, found by glob.
LOAD_REFERENCE = """
import importlib, json, sys
from pathlib import Path
for path in sorted(Path("rio_bench/reference").glob("*.py")):
    importlib.import_module("rio_bench.reference" + ("" if path.stem == "__init__" else "." + path.stem))
print(json.dumps(sorted({name.split(".")[0] for name in sys.modules})))
"""


def _top_level_modules(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_benchmark_and_the_program_load_no_jax():
    names = _top_level_modules(LOAD_ALL)
    assert "rio_tpu_torch" in names  # the port, whose name begins with the JAX package's
    assert not names & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    names = _top_level_modules(LOAD_REFERENCE)
    assert not names & {*harness.FORBIDDEN, "rio_tpu_torch"}


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setattr(sys, "modules", {"rio_tpu_torch.entry": None, "rio_tpu_torch_probe": None})
    assert harness.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {"rio_tpu.ops": None, "jaxlib.xla": None, "flaxen": None})
    assert harness.forbidden_modules() == ["jaxlib", "rio_tpu"]
