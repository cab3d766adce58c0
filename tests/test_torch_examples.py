"""The port's examples give the reference's outcomes, on the CPU.

* ``multihost_solve``: ``python -m rio_tpu_torch.examples.multihost_solve
  --device cpu`` prints the load min/max, dead-node load and overflow that
  ``JAX_PLATFORMS=cpu python examples/multihost_solve.py`` prints, alone
  (8 shards of the CPU) and as two gloo processes over loopback (4 each);
* ``migration``: both packages print the same ``(total, streak)`` pairs,
  ``(4, 4)`` after the admin migrate and ``(5, 5)`` after cordon +
  rebalance, and the same move count and coordinator stats; the provider
  ignores load derates, and a test pins why: in both packages a derate tick
  during the rebalance's solve discards it;
* the eleven runtime-only examples exit 0 in both packages, each printing
  the same last line once digits (ports, timings) are masked;
  ``metric_aggregator`` runs as a server process with ``loadall`` and
  ``show`` clients, and both packages show the same aggregates;
* the rules of ``tests/test_black_jack.py`` and the cases of
  ``tests/test_example_observability.py``, on both packages' modules.

Every subprocess has its own timeout. The two packages' runs of an
example go side by side, but for the runtime-only examples, which run one
after the other: ``qos`` asserts a latency ratio that two runs competing
for the cores can break.
"""

import asyncio
import importlib
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
RUN_TIMEOUT_S = 150  # each example process
# The port's modules run from any directory; the reference's examples from the root.
ENV = {**os.environ, "JAX_PLATFORMS": "cpu",
       "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))}
sys.path.insert(0, str(ROOT / "examples"))

RUNTIME_EXAMPLES = ["ping_pong", "black_jack", "custom_storage", "hot_actor", "observability",
                    "presence", "qos", "reminders", "replication", "streams"]
PACKAGES = ["rio_tpu", "rio_tpu_torch"]


def _command(pkg: str, name: str, *args: str) -> list[str]:
    if pkg == "rio_tpu":
        return [sys.executable, str(ROOT / "examples" / f"{name}.py"), *args]
    return [sys.executable, "-m", f"rio_tpu_torch.examples.{name}", *args]


def _side_by_side(commands: dict, cwd: dict | None = None) -> dict:
    """Run every command at once, each in ``cwd[key]`` (the root by default);
    each one's (returncode, stdout, stderr)."""
    cwd = cwd or {}
    procs = {k: subprocess.Popen(cmd, cwd=cwd.get(k, ROOT), env=ENV, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, cmd in commands.items()}
    out = {}
    try:
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=RUN_TIMEOUT_S)
            out[k] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _one_after_another(commands: dict, cwd: dict | None = None) -> dict:
    """:func:`_side_by_side`, one command at a time: for examples that time
    themselves (``qos`` asserts that its interactive p99 is at least 2x
    better with QoS on), so the two packages' runs do not compete."""
    cwd = cwd or {}
    out = {}
    for k, cmd in commands.items():
        out.update(_side_by_side({k: cmd}, {k: cwd.get(k, ROOT)}))
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ multihost_solve

_PLACED = re.compile(
    r"placed (\d+) objects on (\d+) live nodes: load min/max = (\d+)/(\d+), "
    r"dead-node load = (\d+), overflow = (\d+)"
)


def _placed(stdout: str) -> list[tuple]:
    return [tuple(int(x) for x in m.groups()) for m in _PLACED.finditer(stdout)]


@pytest.fixture(scope="module")
def multihost_reference():
    (rc, stdout, stderr), = _side_by_side({"ref": _command("rio_tpu", "multihost_solve")}).values()
    assert rc == 0, stderr
    (placed,) = _placed(stdout)
    return placed


def test_multihost_solve_alone_prints_the_references_outcome(multihost_reference):
    (rc, stdout, stderr), = _side_by_side(
        {"port": _command("rio_tpu_torch", "multihost_solve", "--device", "cpu")}).values()
    assert rc == 0, stderr
    assert "processes=1 global_devices=8 local=8 (multihost=False)" in stdout
    assert _placed(stdout) == [multihost_reference]
    n_obj, live, lo, hi, dead, overflow = multihost_reference
    assert (n_obj, live, dead, overflow) == (32_768, 63, 0, 0) and lo <= hi


def test_multihost_solve_as_two_gloo_processes_prints_the_references_outcome(multihost_reference):
    port = _free_port()
    runs = _side_by_side({
        rank: _command("rio_tpu_torch", "multihost_solve", "--device", "cpu",
                       "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                       "--process-id", str(rank))
        for rank in range(2)
    })
    for rank, (rc, stdout, stderr) in runs.items():
        assert rc == 0, stderr
        assert f"[host {rank}] processes=2 global_devices=8 local=4 (multihost=True)" in stdout
        assert _placed(stdout) == [multihost_reference]


def test_multihost_solve_main_returns_its_outcome_in_process():
    from rio_tpu_torch.examples import multihost_solve
    from rio_tpu_torch.parallel.mesh import group_up

    got = multihost_solve.main(["--device", "cpu", "--objects-per-device", "512"])
    assert got["processes"] == 1 and got["n_obj"] == 4096
    assert got["dead_node_load"] == 0 and got["overflow"] == 0
    assert not group_up()


# ------------------------------------------------------------------- migration

_REPORT = re.compile(r"total=(\d+) streak=(\d+)")
_MOVES = re.compile(r"\((\d+) move\)")
_STATS = re.compile(r"started=(\d+) completed=(\d+) state_bytes=(\d+)")


# The example's two servers share one event loop and one provider. Each server's
# load monitor turns the loop's lag into a capacity derate (``sync_load``); a new
# derate during the rebalance's solve bumps the provider's epoch and discards the
# solve, so the example prints "(0 move)" and fails its own assert. How often that
# happens follows the host's load, not the package (both do it:
# test_a_derate_tick_during_the_solve_discards_it). So here each example runs with
# its provider's sync_load a no-op, as tests/test_torch_affinity_live.py runs its.
_STEADY_PROVIDER = """
import importlib, runpy, sys
pkg, target = sys.argv[1], sys.argv[2]
module, name = {"rio_tpu": ("rio_tpu.object_placement.jax_placement", "JaxObjectPlacement"),
                "rio_tpu_torch": ("rio_tpu_torch.object_placement.torch_placement",
                                  "TorchObjectPlacement")}[pkg]
getattr(importlib.import_module(module), name).sync_load = lambda self, view: None
sys.argv = [target, *sys.argv[3:]]
if target.endswith(".py"):
    runpy.run_path(target, run_name="__main__")
else:
    runpy.run_module(target, run_name="__main__", alter_sys=True)
"""


def _with_a_steady_provider(pkg: str, name: str, *args: str) -> list[str]:
    target = str(ROOT / "examples" / f"{name}.py") if pkg == "rio_tpu" else f"rio_tpu_torch.examples.{name}"
    return [sys.executable, "-c", _STEADY_PROVIDER, pkg, target, *args]


def test_migration_prints_the_references_outcome():
    runs = _side_by_side({pkg: _with_a_steady_provider(pkg, "migration", *(["cpu"] if pkg == "rio_tpu_torch" else []))
                          for pkg in PACKAGES})
    outcomes = {}
    for pkg, (rc, stdout, stderr) in runs.items():
        assert rc == 0, stderr
        outcomes[pkg] = (
            [tuple(int(x) for x in m) for m in _REPORT.findall(stdout)],
            [int(x) for x in _MOVES.findall(stdout)],
            [tuple(int(x) for x in m) for m in _STATS.findall(stdout)],
        )
    assert outcomes["rio_tpu_torch"] == outcomes["rio_tpu"]
    assert outcomes["rio_tpu"][0] == [(3, 3), (4, 4), (5, 5)]
    assert outcomes["rio_tpu"][1] == [1]


class _LaggedView:
    """A load view in which every node's loop lags: derate 0.5, a new 1/8 bucket."""

    def derate(self, address: str) -> float:
        return 0.5


def _provider(pkg: str):
    if pkg == "rio_tpu":
        from rio_tpu.object_placement.jax_placement import JaxObjectPlacement

        return JaxObjectPlacement(mode="greedy", move_cost=0.5)
    from rio_tpu_torch.object_placement import TorchObjectPlacement

    return TorchObjectPlacement(mode="greedy", move_cost=0.5, device="cpu")


async def _cordon_and_rebalance(pkg: str, tick_during_solve: bool) -> tuple:
    """The example's second move on its provider alone: one object on node a,
    a cordoned, a rebalance into a move sink; with a derate tick, if asked, while
    the solve runs off the loop."""
    objects = importlib.import_module(f"{pkg}.object_placement")
    registry = importlib.import_module(f"{pkg}.registry")
    placement = _provider(pkg)
    placement.sync_members(["a:1", "b:2"])
    await placement.update(objects.ObjectPlacementItem(registry.ObjectId("Visits", "alice"), "a:1"))
    placement.cordon("a:1")
    planned = []

    async def sink(moves):
        planned.extend(moves)
        return len(moves)

    to_thread = asyncio.to_thread

    async def with_a_tick(fn, *args, **kwargs):
        placement.sync_load(_LaggedView())
        return await to_thread(fn, *args, **kwargs)

    if tick_during_solve:
        asyncio.to_thread = with_a_tick
    try:
        moved = await placement.rebalance(move_sink=sink)
    finally:
        asyncio.to_thread = to_thread
    return moved, planned, placement.stats.discarded


@pytest.mark.parametrize("pkg", PACKAGES)
def test_a_derate_tick_during_the_solve_discards_it(pkg):
    assert asyncio.run(_cordon_and_rebalance(pkg, False)) == (1, [("Visits.alice", "a:1", "b:2")], False)
    assert asyncio.run(_cordon_and_rebalance(pkg, True)) == (0, [], True)


# ---------------------------------------------------- the runtime-only examples


def _masked(line: str) -> str:
    return re.sub(r"\d+(\.\d+)?", "N", line)


@pytest.mark.parametrize("name", RUNTIME_EXAMPLES)
def test_the_runtime_example_runs_as_the_references_does(name, tmp_path):
    # Apart: an example may write a file into its working directory.
    runs = _one_after_another({pkg: _command(pkg, name) for pkg in PACKAGES},
                              cwd={"rio_tpu_torch": tmp_path})
    last = {}
    for pkg, (rc, stdout, stderr) in runs.items():
        assert rc == 0, f"{pkg}: {stderr[-2000:]}"
        last[pkg] = _masked(stdout.strip().splitlines()[-1])
    assert last["rio_tpu_torch"] == last["rio_tpu"]


def _wait_for_a_member(pkg: str, db: Path) -> None:
    """Until the node's membership row is active: it is written once the node
    runs, after it printed its address."""
    storage = importlib.import_module(f"{pkg}.cluster.storage.sqlite").SqliteMembershipStorage(str(db))

    async def poll():
        await storage.prepare()
        deadline = time.monotonic() + RUN_TIMEOUT_S
        while not await storage.active_members():
            assert time.monotonic() < deadline, f"{pkg}: no active member in {db}"
            await asyncio.sleep(0.05)

    try:
        asyncio.run(poll())
    finally:
        storage.close()


def _metric_aggregator(pkg: str, db: Path) -> tuple[str, str]:
    server = subprocess.Popen(_command(pkg, "metric_aggregator", "server", "--db", str(db)),
                              cwd=ROOT, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
    try:
        line = server.stdout.readline()
        assert line.startswith("[server] metric-aggregator node on "), line
        _wait_for_a_member(pkg, db)
        outs = []
        for args in (("loadall", "-n", "200"), ("show",)):
            run = subprocess.run(_command(pkg, "metric_aggregator", *args, "--db", str(db)),
                                 cwd=ROOT, env=ENV, capture_output=True, text=True,
                                 timeout=RUN_TIMEOUT_S)
            assert run.returncode == 0, run.stderr
            outs.append(run.stdout)
        return outs[0], outs[1]
    finally:
        server.terminate()
        server.communicate(timeout=30)


def test_metric_aggregator_serves_loadall_and_show_as_the_references_does(tmp_path):
    got = {pkg: _metric_aggregator(pkg, tmp_path / f"{pkg}.db") for pkg in PACKAGES}
    for pkg, (loadall, _show) in got.items():
        assert loadall.startswith("[loadall] 200 requests in "), (pkg, loadall)
    assert got["rio_tpu_torch"][1] == got["rio_tpu"][1]
    assert "[show] requests: Stats(count=200, total=9900.0, vmin=0.0, vmax=99.0)" in got["rio_tpu"][1]


# ------------------------------------------ the reference's example tests, on both


@pytest.fixture(params=PACKAGES)
def example(request):
    """``load(name)``: the example module of this package."""
    pkg = request.param

    def load(name):
        if pkg == "rio_tpu":
            return importlib.import_module(name)  # examples/ is on sys.path
        return importlib.import_module(f"rio_tpu_torch.examples.{name}")

    load.pkg = pkg
    return load


def test_black_jack_hand_values(example):
    bj = example("black_jack")
    assert bj.hand_value(["2♠", "3♥"]) == 5
    assert bj.hand_value(["K♠", "Q♥"]) == 20
    assert bj.hand_value(["A♠", "K♥"]) == 21
    assert bj.hand_value(["A♠", "A♥"]) == 12
    assert bj.hand_value(["A♠", "A♥", "A♦", "A♣"]) == 14
    assert bj.hand_value(["A♠", "9♥", "5♦"]) == 15
    assert bj.hand_value(["K♠", "Q♥", "5♦"]) == 25


def test_black_jack_blackjack_detection(example):
    bj = example("black_jack")
    assert bj.is_blackjack(["A♠", "J♥"])
    assert not bj.is_blackjack(["A♠", "5♥", "5♦"])
    assert not bj.is_blackjack(["10♠", "9♥"])


def test_black_jack_dealer_policy_draws_to_17(example):
    bj = example("black_jack")
    assert bj.dealer_should_hit(["K♠", "6♥"])
    assert not bj.dealer_should_hit(["K♠", "7♥"])
    assert not bj.dealer_should_hit(["A♠", "6♥"])


def test_black_jack_settle_outcomes(example):
    settle = example("black_jack").settle
    assert settle(["K♠", "Q♥", "5♦"], ["K♥", "7♦"]) == "player_bust"
    assert settle(["A♠", "K♥"], ["K♦", "9♣"]) == "player_blackjack"
    assert settle(["A♠", "K♥"], ["A♦", "K♣"]) == "push"
    assert settle(["A♠", "5♥", "5♦"], ["A♦", "K♣"]) == "dealer_win"
    assert settle(["A♠", "K♥"], ["A♦", "5♣", "5♥"]) == "player_blackjack"
    assert settle(["10♠", "9♥"], ["K♦", "6♣", "9♠"]) == "dealer_bust"
    assert settle(["10♠", "9♥"], ["K♦", "8♣"]) == "player_win"
    assert settle(["10♠", "7♥"], ["K♦", "8♣"]) == "dealer_win"
    assert settle(["10♠", "8♥"], ["K♦", "8♣"]) == "push"


def test_black_jack_deck_is_seeded_and_complete(example):
    Deck = example("black_jack").Deck
    d1, d2 = Deck(seed=42), Deck(seed=42)
    assert d1.cards == d2.cards
    assert len(set(d1.cards)) == 52
    assert Deck(seed=1).cards != Deck(seed=2).cards


def test_black_jack_decks_are_the_references():
    ref = importlib.import_module("black_jack")
    port = importlib.import_module("rio_tpu_torch.examples.black_jack")
    for seed in (1, 7, 42):
        assert port.Deck(seed=seed).cards == ref.Deck(seed=seed).cards


def test_black_jack_engine_full_round(example):
    bj = example("black_jack")
    eng = bj.GameEngine("t1", seed=7)
    s = eng.apply("join", "ada")
    assert s.phase in ("player_turn", "settled")
    if s.phase == "player_turn":
        s = eng.apply("stand")
    assert s.phase == "settled"
    assert s.outcome in ("player_win", "dealer_win", "push", "player_blackjack", "player_bust",
                         "dealer_bust")
    assert not bj.dealer_should_hit(s.dealer_cards) or s.outcome == "player_bust"


def test_black_jack_engine_player_bust(example):
    bj = example("black_jack")
    eng = bj.GameEngine("t2", seed=3)
    s = eng.apply("join", "bob")
    while s.phase == "player_turn":
        s = eng.apply("hit")
    assert s.phase == "settled"
    if bj.hand_value(s.player_cards) > 21:
        assert s.outcome == "player_bust"


def test_black_jack_engine_rejects_out_of_phase_commands(example):
    eng = example("black_jack").GameEngine("t3", seed=5)
    with pytest.raises(ValueError):
        eng.apply("hit")
    s = eng.apply("join", "cy")
    if s.phase == "settled":
        with pytest.raises(ValueError):
            eng.apply("stand")
    else:
        eng.apply("stand")
        with pytest.raises(ValueError):
            eng.apply("hit")


def test_black_jack_dealer_hidden_card_until_settled(example):
    eng = example("black_jack").GameEngine("t4", seed=11)
    s = eng.apply("join", "dee")
    if s.phase == "player_turn":
        assert s.visible_dealer()[1] == "??"
        s = eng.apply("stand")
    assert "??" not in s.visible_dealer()


def test_observability_example_end_to_end(example):
    demo = example("observability")
    result = asyncio.run(demo.main(n_requests=20))
    assert result["otlp_mode"] in ("in-memory", "otlp")
    if result["otlp_mode"] == "in-memory":
        assert result["snapshots"] == 2
    assert result["spans"] > 0
    assert result["tail"] > 0
    assert result["explain"] >= 5
    assert result["traces"] >= 1
    assert result["series_nodes"] == 2
    assert result["series_samples"] > 0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_admin_cli_demo_modes(pkg, capsys):
    cli_main = importlib.import_module(f"{pkg}.admin")._cli_main

    assert asyncio.run(cli_main(["--demo", "tail"])) == 0
    out = capsys.readouterr().out
    assert "migrate_pin" in out and "[tail]" in out

    assert asyncio.run(cli_main(["--demo", "explain"])) == 0
    out = capsys.readouterr().out
    assert "linked trace(s)" in out and "migrate_flip" in out

    assert asyncio.run(cli_main(["--demo", "stats"])) == 0
    out = capsys.readouterr().out
    assert "journal=" in out and "events=" in out
