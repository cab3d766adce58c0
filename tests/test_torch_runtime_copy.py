"""The port's actor runtime, durable backends, harnesses and examples are ``rio_tpu``'s, copied word for word.

Each of the 99 files below sits at the same path under ``rio_tpu_torch/``
as under ``rio_tpu/``, or at the path ``REFERENCE_PATH`` names (the
examples and ``tools/endurance.py`` sit at the repo's root in the
reference, and ``utils/server_utils.py`` is ``tests/server_utils.py``).
With docstrings stripped, and ``rio_tpu_torch`` read as ``rio_tpu`` in
import names and string constants, the two files parse to the same tree.
These differences are deliberate, and this test names them line for line
(as ``ast.unparse`` prints them):

* ``native/__init__.py`` builds the repo's ``native/rio_native.cc`` into
  ``rio_tpu_torch/kernels/_build/`` (git-ignored, made on demand) and
  never touches the reference's ``native/librio_native.so``;
* ``utils/affinity_live.py`` and ``examples/affinity.py`` build
  ``TorchObjectPlacement`` where the reference builds
  ``JaxObjectPlacement``, with the same keywords and a ``device`` the
  caller passes (CUDA when it passes none); the demo, a module of the
  package, leaves ``sys.path`` alone;
* ``examples/migration.py`` does the same for its ``TorchObjectPlacement``;
* ``tools/endurance.py`` builds ``TorchObjectPlacement`` or
  ``PersistentTorchObjectPlacement`` on its ``--device``, patches the
  port's routing constants for ``--route-small`` and imports the copied
  cluster harness from the package, with no ``sys.path`` edit;
* the eleven runtime-only examples leave ``sys.path`` alone, and so import
  no ``sys``;
* ``tracing.py``'s spans also open a ``torch.profiler`` range, timed into a
  ring of stage times, while the profiler records: the top-level names in
  ``PORT_ONLY`` are the port's alone, and the lines that use them are
  named in ``DELIBERATE``.
"""

import ast
import difflib
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

RUNTIME_EXAMPLES = [
    f"examples/{name}.py" for name in (
        "ping_pong", "black_jack", "custom_storage", "hot_actor", "metric_aggregator",
        "observability", "presence", "qos", "reminders", "replication", "streams",
    )
]

COPIED = [
    # Wire and identity.
    "errors.py", "codec.py", "protocol.py",
    "registry/identifiable.py", "registry/handler.py", "registry/__init__.py",
    "registry/declarative.py",
    "app_data.py", "commands.py", "message_router.py", "journal.py", "spans.py",
    "utils/__init__.py", "utils/backoff.py", "utils/lru.py", "tracing.py",
    # Actors and state.
    "service_object.py", "state/__init__.py", "streams/__init__.py",
    "reminders/__init__.py", "reminders/daemon.py", "affinity/__init__.py",
    # Membership.
    "cluster/__init__.py", "cluster/storage/__init__.py",
    "cluster/membership_protocol/__init__.py",
    "cluster/membership_protocol/peer_to_peer.py",
    # The node services a default Server wires in.
    "load/__init__.py", "metrics.py", "timeseries.py", "health.py", "faults.py",
    "qos/__init__.py", "otel.py", "migration/__init__.py", "replication/__init__.py",
    "readscale/__init__.py", "admin.py", "aio.py", "native/__init__.py",
    # What a Server or Client loads for one of its options: transport="native"
    # or "auto", a StreamStorage in its AppData, autoscale_config,
    # http_members_address.
    "native/transport.py", "streams/cursor.py", "streams/saga.py",
    "autoscale/__init__.py", "cluster/storage/http.py",
    # The node and the client.
    "service.py", "server.py", "placement_daemon.py", "client/__init__.py",
    "client/pool.py",
    # The live harnesses.
    "utils/routing_live.py", "utils/affinity_live.py",
    # The durable backends: SQLite, then Postgres (each a subclass of its SQLite
    # form) and Redis, for membership, placement, state, reminders and streams.
    "utils/sqlite.py", "object_placement/sqlite.py", "cluster/storage/sqlite.py",
    "state/sqlite.py", "reminders/sqlite.py", "streams/sqlite.py",
    "utils/pg.py", "cluster/storage/postgres.py", "object_placement/postgres.py",
    "state/postgres.py", "reminders/postgres.py", "streams/postgres.py",
    "utils/resp.py", "cluster/storage/redis.py", "object_placement/redis.py",
    "state/redis.py", "reminders/redis.py", "streams/redis.py",
    # The affinity feedback loop's demo.
    "examples/affinity.py",
    # The sharded multi-process data plane and the autoscale provisioners with
    # their worker entry and demo.
    "sharded.py", "autoscale/provision.py", "autoscale/__main__.py",
    # The runtime harnesses that bench.py's runtime tiers run, and their helpers.
    "utils/autoscale_live.py", "utils/faults_live.py", "utils/hotkey_live.py",
    "utils/journal_live.py", "utils/migration_live.py", "utils/qos_live.py",
    "utils/series_live.py", "utils/spans_live.py", "utils/streams_live.py",
    "utils/tracing_live.py", "utils/routing_sim.py", "utils/loop.py",
    # The live-migration example, the endurance tool and the cluster harness it boots.
    "examples/migration.py", "tools/endurance.py", "utils/server_utils.py",
    # The runtime-only examples, the reference's acceptance surface.
    *RUNTIME_EXAMPLES,
]

# Port files whose reference sits elsewhere than the same path under rio_tpu/.
REFERENCE_PATH = {
    "examples/affinity.py": "examples/affinity.py",
    "examples/migration.py": "examples/migration.py",
    "tools/endurance.py": "tools/endurance.py",
    "utils/server_utils.py": "tests/server_utils.py",
    **{rel: rel for rel in RUNTIME_EXAMPLES},
}

# file -> (lines only in the reference, lines only in the port, the reason)
DELIBERATE = {
    "native/__init__.py": (
        ["_SO = _SRC_DIR / 'librio_native.so'"],
        [
            "_SO = Path(__file__).resolve().parent.parent / 'kernels' / '_build' / 'librio_native.so'",
            "        _SO.parent.mkdir(parents=True, exist_ok=True)",
        ],
        "the port builds the shared source into its own git-ignored directory",
    ),
    "utils/affinity_live.py": (
        [
            "from ..object_placement.jax_placement import JaxObjectPlacement",
            "async def measure_affinity_payoff(*, n_records: int=256, pad_bytes: int=4096, "
            "redelivery_period: float=0.25, transport: str='asyncio', affinity_weight: float=2.0, "
            "affinity_host_factor: float=0.05, drain_timeout: float=60.0) -> dict:",
            "    placement = JaxObjectPlacement(node_axis_size=4, mode='greedy', "
            "affinity_weight=affinity_weight, affinity_host_factor=affinity_host_factor)",
        ],
        [
            "from ..object_placement.torch_placement import TorchObjectPlacement",
            "async def measure_affinity_payoff(*, n_records: int=256, pad_bytes: int=4096, "
            "redelivery_period: float=0.25, transport: str='asyncio', affinity_weight: float=2.0, "
            "affinity_host_factor: float=0.05, drain_timeout: float=60.0, device=None) -> dict:",
            "    placement = TorchObjectPlacement(node_axis_size=4, mode='greedy', "
            "affinity_weight=affinity_weight, affinity_host_factor=affinity_host_factor, device=device)",
        ],
        "the port's provider, on the device the caller names",
    ),
    "examples/affinity.py": (
        [
            "sys.path.insert(0, '.')",
            "from rio_tpu.object_placement.jax_placement import JaxObjectPlacement",
            "async def main() -> dict:",
            "    placement = JaxObjectPlacement(node_axis_size=4, mode='greedy', "
            "affinity_weight=2.0, affinity_host_factor=0.05)",
            "    asyncio.run(main())",
        ],
        [
            "from rio_tpu.object_placement.torch_placement import TorchObjectPlacement",
            "async def main(device=None) -> dict:",
            "    placement = TorchObjectPlacement(node_axis_size=4, mode='greedy', "
            "affinity_weight=2.0, affinity_host_factor=0.05, device=device)",
            "    asyncio.run(main(sys.argv[1] if len(sys.argv) > 1 else None))",
        ],
        "the port's provider on a device named by the caller; a package module runs "
        "with ``python -m`` and leaves sys.path alone",
    ),
    "examples/migration.py": (
        [
            "sys.path.insert(0, '.')",
            "from rio_tpu.object_placement.jax_placement import JaxObjectPlacement",
            "async def main() -> None:",
            "    placement = JaxObjectPlacement(mode='greedy', move_cost=0.5)",
            "    asyncio.run(main())",
        ],
        [
            "from rio_tpu.object_placement.torch_placement import TorchObjectPlacement",
            "async def main(device=None) -> None:",
            "    placement = TorchObjectPlacement(mode='greedy', move_cost=0.5, device=device)",
            "    asyncio.run(main(sys.argv[1] if len(sys.argv) > 1 else None))",
        ],
        "as examples/affinity.py: the port's provider on a device named by the caller, "
        "sys.path left alone",
    ),
    "tools/endurance.py": (
        [
            "import os",
            "sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))",
            "sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "
            "'tests'))",
            "from rio_tpu.object_placement import jax_placement as jp_mod",
            "from rio_tpu.object_placement.jax_placement import JaxObjectPlacement",
            "    from server_utils import run_integration_test, wait_for_active_members",
            "        from rio_tpu.object_placement.persistent import PersistentJaxObjectPlacement",
            "        placement = PersistentJaxObjectPlacement(SqliteObjectPlacement(args.persistent), "
            "mode=args.mode, n_iters=10, move_cost=args.move_cost)",
            "        placement = JaxObjectPlacement(mode=args.mode, n_iters=10, move_cost=args.move_cost)",
        ],
        [
            "from rio_tpu.object_placement import torch_placement as jp_mod",
            "from rio_tpu.object_placement.torch_placement import TorchObjectPlacement",
            "    from rio_tpu.utils.server_utils import run_integration_test, wait_for_active_members",
            "        from rio_tpu.object_placement.persistent import PersistentTorchObjectPlacement",
            "        placement = PersistentTorchObjectPlacement(SqliteObjectPlacement(args.persistent), "
            "mode=args.mode, n_iters=10, move_cost=args.move_cost, device=args.device)",
            "        placement = TorchObjectPlacement(mode=args.mode, n_iters=10, move_cost=args.move_cost, "
            "device=args.device)",
            "    ap.add_argument('--device', default=None, help=\"the provider's device (CUDA when not given)\")",
        ],
        "the port's providers on a --device (CUDA when not given); --route-small patches the "
        "port's routing constants; the copied harness is a module of the package, so no "
        "sys.path edit (and no os)",
    ),
    "tracing.py": (
        ["    __slots__ = ('_span', '_token')", "        return _NULL_SPAN"],
        [
            "import sys",
            "from collections import deque",
            "    __slots__ = ('_span', '_token', '_stage')",
            "        prof = _profiler()",
            "        self._stage = None if prof is None else _StageRange(name, prof)",
            "        if self._stage is not None:",
            "            self._stage.__enter__()",
            "        if self._stage is not None:",
            "            self._stage.__exit__(*exc)",
            "        prof = _profiler()",
            "        return _NULL_SPAN if prof is None else _StageRange(name, prof)",
        ],
        "a span also opens a profiler range, timed into the stage ring, while torch's "
        "profiler records; the null path also asks whether it records",
    ),
    **{
        rel: (["import sys", "sys.path.insert(0, '.')"], [],
              "a package module runs with ``python -m`` and leaves sys.path alone (and needs no sys)")
        for rel in RUNTIME_EXAMPLES
    },
}

# file -> top-level names defined in the port's file alone; the comparison leaves them out.
PORT_ONLY = {"tracing.py": {"STAGE_RING", "_STAGES", "_profiler", "_StageRange", "device_stage_ms"}}

_PORT_NAME = re.compile(r"(?<![A-Za-z0-9_])rio_tpu_torch")


class _Normalise(ast.NodeTransformer):
    """Strip docstrings; read ``rio_tpu_torch`` as ``rio_tpu``."""

    def _strip_docstring(self, node):
        body = node.body
        if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        return node

    def visit_Module(self, node):
        self.generic_visit(node)
        return self._strip_docstring(node)

    visit_ClassDef = visit_FunctionDef = visit_AsyncFunctionDef = visit_Module

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            node.value = _PORT_NAME.sub("rio_tpu", node.value)
        return node

    def visit_Import(self, node):
        for alias in node.names:
            alias.name = _PORT_NAME.sub("rio_tpu", alias.name)
        return node

    def visit_ImportFrom(self, node):
        if node.module:
            node.module = _PORT_NAME.sub("rio_tpu", node.module)
        return node


def _defined(node) -> set[str]:
    """The top-level names a statement defines."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return {node.name}
    if isinstance(node, ast.Assign):
        return {t.id for t in node.targets if isinstance(t, ast.Name)}
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return {node.target.id}
    return set()


def _normalised_lines(path: pathlib.Path, drop: set[str] = frozenset()) -> list[str]:
    tree = _Normalise().visit(ast.parse(path.read_text(), filename=str(path)))
    tree.body = [node for node in tree.body if not _defined(node) & drop]
    return ast.unparse(tree).splitlines()


def test_the_copy_list_names_85_distinct_files():
    """The list's size, 99 files since the examples and the endurance tool joined the 85."""
    assert len(COPIED) == len(set(COPIED)) == 99
    assert set(DELIBERATE) <= set(COPIED) and set(PORT_ONLY) <= set(DELIBERATE)
    assert set(REFERENCE_PATH) <= set(COPIED)


@pytest.mark.parametrize("rel", COPIED)
def test_the_port_file_is_the_reference_file(rel):
    ref = _normalised_lines(ROOT / REFERENCE_PATH.get(rel, f"rio_tpu/{rel}"))
    port = _normalised_lines(ROOT / "rio_tpu_torch" / rel, PORT_ONLY.get(rel, set()))
    only_ref, only_port = [], []
    for line in difflib.ndiff(ref, port):
        if line.startswith("- "):
            only_ref.append(line[2:])
        elif line.startswith("+ "):
            only_port.append(line[2:])
    want_ref, want_port, _reason = DELIBERATE.get(rel, ([], [], None))
    assert (only_ref, only_port) == (want_ref, want_port)


# Modules of the reference that a copied file imports but the port does not
# carry, each with what reaches it. Every one is carried now.
NOT_COPIED = {}


def _relative_imports(rel):
    package = ".".join(("rio_tpu_torch", *pathlib.PurePosixPath(rel).parent.parts))
    for node in ast.walk(ast.parse((ROOT / "rio_tpu_torch" / rel).read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            base = package.split(".")[: len(package.split(".")) - (node.level - 1)]
            yield node, ".".join(base + ([node.module] if node.module else []))


def test_every_module_the_copies_import_is_in_the_port():
    missing = set()
    for rel in COPIED:
        for node, target in _relative_imports(rel):
            path = ROOT.joinpath(*target.split("."))
            if not (path.with_suffix(".py").exists() or (path / "__init__.py").exists()):
                missing.add(target)
    assert missing == set(NOT_COPIED)


def test_the_logger_names_name_the_port():
    for rel in COPIED:
        src = (ROOT / "rio_tpu_torch" / rel).read_text()
        assert not re.search(r'getLogger\("rio_tpu[."]', src), rel


def test_the_errors_have_the_references_names_and_mros():
    import rio_tpu.errors as ref
    import rio_tpu_torch.errors as port

    def classes(mod):
        return {
            name: obj for name, obj in vars(mod).items()
            if isinstance(obj, type) and issubclass(obj, BaseException) and obj.__module__ == mod.__name__
        }

    ref_classes, port_classes = classes(ref), classes(port)
    assert set(port_classes) == set(ref_classes)
    for name, cls in ref_classes.items():
        assert [c.__name__ for c in port_classes[name].__mro__] == [c.__name__ for c in cls.__mro__], name
    assert issubclass(port.NoSchedulableCapacity, ValueError)
    assert issubclass(port.NoSchedulableCapacity, port.ObjectPlacementError)


def test_object_placement_exports_what_the_runtime_imports_from_it():
    import rio_tpu_torch.object_placement as op

    wanted = set()
    for rel in COPIED:
        for node, target in _relative_imports(rel):
            if target == "rio_tpu_torch.object_placement":
                wanted |= {a.name for a in node.names}
    assert wanted >= {"LocalObjectPlacement", "ObjectPlacement", "ObjectPlacementItem"}
    assert all(hasattr(op, name) for name in wanted), wanted


def test_the_package_exports_the_references_prelude():
    import rio_tpu
    import rio_tpu_torch

    assert set(rio_tpu_torch.__all__) == set(rio_tpu.__all__) | {"resolve_device"}
    for name in rio_tpu_torch.__all__:
        assert getattr(rio_tpu_torch, name) is not None, name
    assert rio_tpu_torch.ObjectId("A", "1") == rio_tpu_torch.registry.ObjectId("A", "1")
    assert str(rio_tpu_torch.ObjectId("A", "1")) == str(rio_tpu.ObjectId("A", "1")) == "A.1"
