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
    for name in ("server", "client", "codec", "utils.routing_live", "utils.churn_live", "sharded",
                 "autoscale.provision", "utils.autoscale_live", "utils.tracing_live",
                 "examples.tpu_placement", "placement_daemon", "native", "native.transport",
                 "streams.cursor", "streams.saga", "autoscale", "cluster.storage.http",
                 *BACKENDS, "utils.affinity_live", "examples.affinity", "examples.migration",
                 "examples.multihost_solve", "tools.endurance", "utils.server_utils",
                 *RUNTIME_EXAMPLES):
        assert f"rio_tpu_torch.{name}" in result["imported"], name
    assert result["bad"] == [], f"the port loaded {result['bad']}"


BACKENDS = [
    f"{family}.{kind}"
    for kind in ("sqlite", "postgres", "redis")
    for family in ("cluster.storage", "object_placement", "state", "reminders", "streams")
] + ["utils.sqlite", "utils.pg", "utils.resp"]

# The runtime-only examples, copies of the reference's.
RUNTIME_EXAMPLES = [
    f"examples.{name}" for name in (
        "ping_pong", "black_jack", "custom_storage", "hot_actor", "metric_aggregator",
        "observability", "presence", "qos", "reminders", "replication", "streams",
    )
]

_IMPORT_DURABLE = """
import importlib, json, sys
names = sys.argv[1:]
for name in names:
    importlib.import_module("rio_tpu_torch." + name)
import rio_tpu_torch.utils.affinity_live as live
import rio_tpu_torch.examples.affinity as demo
from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement
print(json.dumps({
    "bad": sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "rio_tpu")),
    "providers": [live.TorchObjectPlacement is TorchObjectPlacement,
                  demo.TorchObjectPlacement is TorchObjectPlacement],
}))
"""


def test_the_durable_backends_and_the_affinity_loop_load_no_jax_and_no_rio_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_DURABLE, *BACKENDS, "utils.affinity_live", "examples.affinity"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"bad": [], "providers": [True, True]}


_IMPORT_RUNTIME = """
import json, sys
from rio_tpu_torch import Server, Client, LocalStorage, Registry, ServiceObject, handler, message
import rio_tpu_torch.codec, rio_tpu_torch.utils.routing_live, rio_tpu_torch.examples.tpu_placement
print(json.dumps(sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "rio_tpu"))))
"""


def test_the_ports_runtime_loads_no_jax_and_no_rio_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_RUNTIME],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


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


# The runtime's modules: every process of a cluster (a server, a sharded worker, a
# load generator, an autoscaled node) imports only these, and none loads torch, as
# none of the reference's loads jax. Modules that compute on tensors import torch.
RUNTIME_MODULES = [
    "rio_tpu_torch", "server", "client", "placement_daemon", "migration", "replication",
    "affinity", "autoscale", "qos", "streams", "admin", *BACKENDS, "sharded",
    "autoscale.provision", "autoscale.__main__", "utils.routing_live", "utils.routing_sim",
    "utils.loop", "utils.autoscale_live", "utils.faults_live", "utils.hotkey_live",
    "utils.journal_live", "utils.migration_live", "utils.qos_live", "utils.series_live",
    "utils.spans_live", "utils.streams_live", "utils.tracing_live", "utils.churn_live",
    "utils.durable_live", "utils.server_utils", "examples.multihost_solve", *RUNTIME_EXAMPLES,
]

_IMPORT_ONE = """
import importlib, json, sys
importlib.import_module(sys.argv[1])
print(json.dumps(sorted(n for n in sys.modules if n.split(".")[0] in ("torch", "jax", "rio_tpu"))))
"""


@pytest.mark.parametrize("name", RUNTIME_MODULES)
def test_importing_a_runtime_module_leaves_torch_unloaded(name):
    module = name if name == "rio_tpu_torch" else f"rio_tpu_torch.{name}"
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ONE, module],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_RESOLVE_LAZY = """
import json, sys
import rio_tpu_torch, rio_tpu_torch.object_placement as op
before = "torch" in sys.modules
obj = getattr(rio_tpu_torch if sys.argv[1] == "resolve_device" else op, sys.argv[1])
print(json.dumps({"before": before, "after": "torch" in sys.modules,
                  "module": obj.__module__, "name": obj.__name__}))
"""


@pytest.mark.parametrize("name, module", [
    ("resolve_device", "rio_tpu_torch.device"),
    ("TorchObjectPlacement", "rio_tpu_torch.object_placement.torch_placement"),
    ("AffinityTracker", "rio_tpu_torch.object_placement.torch_placement"),
    ("PersistentTorchObjectPlacement", "rio_tpu_torch.object_placement.persistent"),
])
def test_the_lazy_names_resolve_and_then_load_torch(name, module):
    out = subprocess.run(
        [sys.executable, "-c", _RESOLVE_LAZY, name],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"before": False, "after": True, "module": module, "name": name}


def test_from_import_of_the_lazy_names_is_the_providers_class():
    from rio_tpu_torch import resolve_device
    from rio_tpu_torch.device import resolve_device as direct
    from rio_tpu_torch.object_placement import PersistentTorchObjectPlacement, TorchObjectPlacement
    from rio_tpu_torch.object_placement.persistent import PersistentTorchObjectPlacement as P
    from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement as T

    assert (resolve_device, TorchObjectPlacement, PersistentTorchObjectPlacement) == (direct, T, P)
    with pytest.raises(AttributeError):
        import rio_tpu_torch.object_placement as op

        op.NoSuchProvider  # noqa: B018
