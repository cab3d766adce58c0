"""rio_tpu_torch.bench against bench.py's device tiers, on the CPU.

Each tier of the port runs with ``device="cpu"`` on exactly the inputs the
reference tier draws: the test re-draws them with ``jax.random`` from the
reference's keys and hands them over as numpy. Beside it runs the
reference tier itself (``chain_budget_s=None``), and the quality keys must
agree:

* ``max_load``, ``fair_load``, ``dead_load``, ``moved``, ``displaced``,
  ``full_moved``, ``delta_moved``, ``undisplaced_moves`` and hier
  ``overflow`` equal;
* ``mean_cost`` within 1e-4, ``cost_ratio`` within 1e-6;
* ``marginal_err`` within 1e-3 relative to the row marginal's mass (1),
  both below 1e-5. After 30 iterations both errors are float32 round-off:
  JAX's CPU vector-matrix product over 4,096 rows is ~2e-6 off in relative
  terms where PyTorch's is ~1e-7, so the reference reads ~2.9e-6 and the
  port ~1e-7, and a ratio of the two would measure summation order.

Where a reference tier returns no quality key (the warm batch, the churn
cycle, the chunked hierarchical route), the test computes the reference's
own arithmetic with ``rio_tpu``'s ops on the same inputs and holds the
port's keys to it.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench as ref  # noqa: E402
from rio_tpu.ops import exact_quota_repair as jax_repair  # noqa: E402
from rio_tpu.ops.assignment import build_cost_matrix as jax_cost  # noqa: E402
from rio_tpu.ops.assignment import greedy_balanced_assign as jax_greedy  # noqa: E402
from rio_tpu.ops.structured import class_quotas as jax_class_quotas  # noqa: E402
from rio_tpu.ops.structured import expand_class_quotas as jax_expand  # noqa: E402
from rio_tpu.parallel.hierarchical import chunked_hierarchical_assign as jax_chunked  # noqa: E402

from rio_tpu_torch import bench as port  # noqa: E402

N, M = 4096, 64  # the solve, collapsed and churn tiers
HIER_N, HIER_M, HIER_G = 65_536, 64, 8  # one chunk in the reference (it chunks above 655,360)
HIER_CHUNK = 4_096  # 16 chunks, as 10,485,760 / 655,360
DELTA_N, DELTA_M = 4096, 16
WARM_BATCH = 4096  # clear of the 700-object waterfill tie (ROADMAP queue C #2)
ALLOC_BATCH = 1024

TOL_MEAN_COST = 1e-4
RTOL_MARGINAL = 1e-3
MARGINAL_MASS = 1.0  # the row marginal is normalised to unit mass
MARGINAL_ROUNDOFF = 1e-5
TOL_COST_RATIO = 1e-6
ROW_AGREEMENT = 0.99


def _np(x):
    return np.asarray(x)


def _equal_keys(got: dict, want: dict, keys) -> None:
    for k in keys:
        assert got[k] == want[k], (k, got[k], want[k])


# ------------------------------------------------------------- solve tiers


@pytest.mark.parametrize("n_nodes, n_iters", [(M, 30), (M // 4, 15)], ids=["headline", "row3"])
def test_solve_rate_matches_the_reference(n_nodes, n_iters):
    want = ref._solve_rate(N, jnp.float32, n_nodes=n_nodes, n_iters=n_iters)
    cost = _np(jax.random.uniform(jax.random.PRNGKey(0), (N, n_nodes), jnp.float32))
    got = port.solve_rate(
        N, torch.float32, n_nodes=n_nodes, n_iters=n_iters, cost=cost, chain_steps=2, device="cpu"
    )
    _equal_keys(got, want, ("max_load", "fair_load", "n_nodes", "n_iters"))
    assert got["max_load"] == got["fair_load"]
    assert abs(got["mean_cost"] - want["mean_cost"]) <= TOL_MEAN_COST
    assert abs(got["marginal_err"] - want["marginal_err"]) <= RTOL_MARGINAL * MARGINAL_MASS
    assert max(got["marginal_err"], want["marginal_err"]) < MARGINAL_ROUNDOFF
    # Warm + 3 of solve_only and of step, then 2 runs of the 2-step chain.
    assert got["solves"] == 4 + 4 + 2 * 2
    assert got["solver_impl"] == "eager" and got["compile_s"] == -1
    assert got["rate"] == pytest.approx(N / (got["full_ms"] / 1e3))


def test_greedy_rate_matches_the_reference():
    want = ref._greedy_rate(N, M)
    cost = _np(jax.random.uniform(jax.random.PRNGKey(0), (N, M), jnp.float32))
    got = port.greedy_rate(N, M, cost=cost, device="cpu")
    assert abs(got["mean_cost"] - want["mean_cost"]) <= TOL_MEAN_COST
    assert got["max_load"] - got["fair_load"] <= 2


def test_solve_rate_refuses_a_cost_of_another_shape():
    with pytest.raises(ValueError, match="shape"):
        port.solve_rate(64, n_nodes=8, cost=np.zeros((64, 9), np.float32), device="cpu")


# ----------------------------------------------------- collapsed and churn


def test_collapsed_rate_matches_the_reference():
    want = ref._collapsed_rate(N, n_nodes=M)
    cur = _np(jax.random.randint(jax.random.PRNGKey(2), (N,), 0, M, jnp.int32))
    got = port.collapsed_rate(N, M, cur=cur, chain_steps=2, device="cpu")
    _equal_keys(got, want, ("dead_nodes", "displaced", "moved", "max_load", "dead_load", "fair_load"))
    assert got["dead_load"] == 0 and got["moved"] >= got["displaced"]
    assert got["chain_steps"] == 2 and got["full_ms"] == got["decision_ms"]


def test_warm_assign_rate_counts_match_the_reference():
    want = ref._warm_assign_rate(WARM_BATCH, n_nodes=M)
    g = jax.random.normal(jax.random.PRNGKey(3), (M,), jnp.float32) * 0.1
    # The reference tier's step (bench.py:644-650) on its own inputs.
    load = jnp.ones((M,), jnp.float32) * (WARM_BATCH / M)
    cap = jnp.ones((M,), jnp.float32)
    rows = jnp.broadcast_to(jax_cost(load, cap, cap) - g[None, :], (WARM_BATCH, M))
    a = jax_greedy(rows, jnp.ones((WARM_BATCH,), jnp.float32), cap, load)
    keep: dict = {}
    got = port.warm_assign_rate(WARM_BATCH, M, g=_np(g), chain_steps=2, keep=keep, device="cpu")
    assert got["batch"] == want["batch"]
    assert np.array_equal(keep["counts"], np.bincount(_np(a), minlength=M))
    assert got["max_load"] == int(keep["counts"].max())


def _jax_cycle(cur, g_warm, alive, *, m, batch, n_iters=30, move_cost=0.5):
    """One churn cycle of the reference (bench.py:739-760): ``(assignment, extra_load)``."""
    cap = jnp.ones((m,), jnp.float32)
    seated = jnp.bincount(cur, length=m).astype(jnp.float32)
    rows = jnp.broadcast_to(jax_cost(seated, cap, alive) - g_warm[None, :], (batch, m))
    alloc = jax_greedy(rows, jnp.ones((batch,), jnp.float32), cap * alive, seated)
    base = jax_cost(jnp.zeros((m,), jnp.float32), cap, alive)[0]
    quotas, _, _ = jax_class_quotas(
        base, jnp.bincount(cur, length=m), cap * alive,
        move_cost=move_cost, eps=min(0.05, move_cost / 25.0), n_iters=n_iters,
    )
    expanded = jax_expand(quotas, cur)
    expected = cap * alive / jnp.sum(cap * alive) * cur.shape[0]
    assignment = jax_repair(expanded, expected, prefer_keep=expanded == cur)
    return assignment, jnp.bincount(alloc, length=m)


def test_incremental_rate_matches_the_reference_cycle():
    want = ref._incremental_rate(N, batch=ALLOC_BATCH, n_nodes=M)
    cur = jax.random.randint(jax.random.PRNGKey(5), (N,), 0, M, jnp.int32)
    g_warm = jax.random.normal(jax.random.PRNGKey(6), (M,), jnp.float32) * 0.1
    got = port.incremental_rate(
        N, ALLOC_BATCH, M, cur=_np(cur), g_warm=_np(g_warm), chain_steps=2, device="cpu"
    )
    _equal_keys(got, want, ("n_obj", "alloc_batch", "dead_nodes"))
    n_dead = want["dead_nodes"]
    alive = jnp.ones((M,), jnp.float32).at[:n_dead].set(0.0)
    assignment, _ = _jax_cycle(cur, g_warm, alive, m=M, batch=ALLOC_BATCH)
    a, c = _np(assignment), _np(cur)
    loads = np.bincount(a, minlength=M)
    assert got["moved"] == int((a != c).sum())
    assert got["displaced"] == int((c < n_dead).sum())
    assert got["max_load"] == int(loads.max()) and got["dead_load"] == int(loads[:n_dead].sum()) == 0
    assert got["cycles_per_sec"] == pytest.approx(1e3 / got["cycle_ms"])


def test_delta_churn_rate_matches_the_reference():
    want = ref._delta_churn_rate(DELTA_N, n_nodes=DELTA_M)
    got = port.delta_churn_rate(DELTA_N, DELTA_M, device="cpu")
    _equal_keys(
        got, want,
        ("full_mode", "delta_mode", "full_moved", "delta_moved", "displaced", "undisplaced_moves"),
    )
    assert got["undisplaced_moves"] == 0 and got["delta_moved"] == got["displaced"]
    assert abs(got["cost_ratio"] - want["cost_ratio"]) <= TOL_COST_RATIO


# ----------------------------------------------------------- hierarchical


def _hier_features():
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    obj = jax.random.normal(k1, (HIER_N, 16), jnp.float32)
    node = jax.random.normal(k2, (16, HIER_M), jnp.float32)
    return obj, node


def test_hier_rate_matches_the_reference():
    want = ref._hier_rate(HIER_N, n_nodes=HIER_M, n_groups=HIER_G)
    obj, node = _hier_features()
    got = port.hier_rate(
        HIER_N, HIER_M, HIER_G, obj_feat=_np(obj), node_feat=_np(node), chain_steps=2, device="cpu"
    )
    _equal_keys(got, want, ("overflow", "n_chunks", "n_obj", "n_nodes", "n_groups"))
    assert got["n_chunks"] == 1 and got["overflow"] == 0


def test_hier_rate_chunked_route_matches_jax_chunked():
    obj, node = _hier_features()
    keep: dict = {}
    got = port.hier_rate(
        HIER_N, HIER_M, HIER_G, chunk_rows=HIER_CHUNK, obj_feat=_np(obj), node_feat=_np(node),
        chain_steps=0, device="cpu", keep=keep,
    )
    assert got["n_chunks"] == HIER_N // HIER_CHUNK == 16 and got["chunk_rows"] == HIER_CHUNK
    ones = jnp.ones((HIER_M,), jnp.float32)
    want = jax_chunked(obj, node, ones, ones, n_groups=HIER_G, n_chunks=16)
    wa, ga = _np(want.assignment), keep["assignment"]
    assert got["overflow"] == int(want.overflow)
    assert np.array_equal(np.bincount(ga, minlength=HIER_M), np.bincount(wa, minlength=HIER_M))
    assert np.mean(ga == wa) >= ROW_AGREEMENT
    loads = np.bincount(ga, minlength=HIER_M)
    assert (got["min_load"], got["max_load"]) == (int(loads.min()), int(loads.max()))


def test_hier_rate_does_not_chunk_a_size_that_does_not_divide():
    got = port.hier_rate(6000, 16, 4, chunk_rows=4096, chain_steps=0, device="cpu")
    assert got["n_chunks"] == 1 and got["chunk_rows"] == 6000


# ------------------------------------------------- devices and the command


TINY_TIERS = {
    "solve_rate": lambda **kw: port.solve_rate(256, n_nodes=8, chain_steps=1, **kw),
    "greedy_rate": lambda **kw: port.greedy_rate(256, 8, **kw),
    "collapsed_rate": lambda **kw: port.collapsed_rate(256, 8, chain_steps=1, **kw),
    "warm_assign_rate": lambda **kw: port.warm_assign_rate(64, 8, chain_steps=1, **kw),
    "incremental_rate": lambda **kw: port.incremental_rate(256, 64, 8, chain_steps=1, **kw),
    "delta_churn_rate": lambda **kw: port.delta_churn_rate(256, 8, **kw),
    "hier_rate": lambda **kw: port.hier_rate(512, 8, 2, chain_steps=1, **kw),
}


@pytest.mark.parametrize("tier", sorted(TINY_TIERS))
def test_every_result_names_its_device(tier):
    got = TINY_TIERS[tier](device="cpu")
    assert (got["platform"], got["device"], got["power_limit"]) == ("cpu", "cpu", None)


@pytest.mark.parametrize("tier", sorted(TINY_TIERS))
def test_every_tier_raises_without_a_card(tier):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TINY_TIERS[tier]()


def test_main_raises_without_a_card_rather_than_measure_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.main(["--collapsed"])
    assert capsys.readouterr().out == ""


def test_headline_has_the_reference_shape_and_names_the_card():
    card = {"platform": "cuda", "device": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    collapsed = {**card, "n_obj": 1_048_576, "n_nodes": 1024, "full_ms": 2.0, "chain_steps": 64,
                 "single_shot_ms": 3.0, "dead_nodes": 30, "moved": 40_000, "displaced": 30_000,
                 "rate": 5.0e8}
    line = port.headline({"collapsed_tier": collapsed}, baseline=1.0e4)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["value"] == 5.0e8 and line["vs_baseline"] == 5.0e4
    assert "NVIDIA H100 80GB HBM3" in line["metric"] and "700.00 W" in line["metric"]
    assert "hops unmeasured" in line["metric"]
    solve = {**card, "n_obj": 1_048_576, "n_nodes": 1024, "rate": 1.0e7}
    assert port.headline({"solve_tier": solve}, 1.0e4)["value"] == 1.0e7


def test_sqlite_baseline_runs_the_reference_queries():
    assert port.sqlite_baseline_rate(200) > 0 and ref.sqlite_baseline_rate(200) > 0


HOP_KEYS = {"mean", "p50", "p99", "n"}


def test_live_route_hops_returns_the_references_keys():
    got = port.live_route_hops()
    assert set(got) == {"ours", "reference"}
    assert set(got["ours"]) == set(got["reference"]) == HOP_KEYS
    assert got["ours"]["n"] == got["reference"]["n"] == 2048
    assert got["ours"]["p99"] == 1.0 and got["reference"]["p99"] == 2.0


def test_row2_torch_provider_live_returns_the_references_keys():
    got = port.row2_torch_provider_live(device="cpu", n_objects=2000, sample_size=500)
    assert {"ours", "reference"} <= set(got)
    assert set(got["ours"]) == set(got["reference"]) == HOP_KEYS
    assert got["ours"]["n"] == got["reference"]["n"] == 500
    assert got["ours"]["mean"] == 1.0 and got["ours"]["p99"] == 1.0
    assert got["reference"]["p99"] == 2.0 and got["reference"]["mean"] > 1.5
    assert got["count"] == 2000 and got["n_servers"] == 8
    assert (got["platform"], got["device"], got["power_limit"]) == ("cpu", "cpu", None)
    assert got["directory_device"] == "cpu"
    assert got["alloc_s"] > 0 and got["wall_s"] >= got["alloc_s"]


def test_headline_reports_measured_hops_when_route_hops_ran():
    card = {"platform": "cuda", "device": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    hops = {"ours": {"mean": 1.0, "p50": 1.0, "p99": 1.0, "n": 2048},
            "reference": {"mean": 1.88, "p50": 2.0, "p99": 2.0, "n": 2048}}
    solve = {**card, "n_obj": 1_048_576, "n_nodes": 1024, "rate": 1.0e7}
    line = port.headline({"solve_tier": solve, "route_hops": hops}, 1.0e4)
    assert "measured p99 hops 1 vs 2" in line["metric"] and "unmeasured" not in line["metric"]
    assert "NVIDIA H100 80GB HBM3" in line["metric"] and line["unit"] == "placements/sec"
    live_only = port.headline({"route_hops": hops}, 1.0e4)
    assert set(live_only) == {"metric", "value", "unit", "vs_baseline"}
    assert live_only["value"] == 1.0 and live_only["unit"] == "hops" and live_only["vs_baseline"] == 0.5
    assert "measured p99 hops 1 vs 2" in live_only["metric"]


# ------------------------------------------------------------- runtime tiers

# The harnesses' small sizes, for both packages; each overrides what the tier passes.
ECHO_AB = {"batches": 2, "n_workers": 8, "requests_per_batch": 16, "n_objects": 32}
RUNTIME_SMALL = {
    "routing_live": {"measure_rpc_throughput": {"n_workers": 4, "requests_per_worker": 10,
                                                "n_objects": 16},
                     "measure_rpc_external": {"n_workers": 4, "requests_per_worker": 10,
                                              "n_objects": 16}},
    "migration_live": {"measure_migration_drain": {"n_objects": 32, "payload_bytes": 128}},
    "hotkey_live": {"measure_hotkey": {"n_keys": 12, "n_requests": 60, "rate": 600.0}},
    "tracing_live": {"measure_tracing_overhead": ECHO_AB},
    "journal_live": {"measure_journal_overhead": ECHO_AB},
    "series_live": {"measure_series_overhead": ECHO_AB},
    "spans_live": {"measure_spans_overhead": {**ECHO_AB, "slo_ms": 0.01}},
    "faults_live": {"measure_faults_overhead": {**ECHO_AB, "lookup_ops": 1000}},
    "streams_live": {"measure_streams_overhead": {"batches": 2, "publishes_per_batch": 16,
                                                  "n_keys": 4}},
    "qos_live": {"measure_qos_overhead": {**ECHO_AB, "batches": 4},
                 "measure_qos_flood": {"bulk_workers": 8, "interactive_probes": 8}},
    "autoscale_live": {"measure_autoscale_idle_overhead": {**ECHO_AB, "batches": 4,
                                                           "requests_per_batch": 64},
                       # the harness's warm-up; a longer wait for the scale-out,
                       # which comes once one node serves 600 requests/s
                       "measure_autoscale_ramp": {"warm_secs": 3.0, "high_timeout": 300.0}},
}


def _shrunk(fn, small: dict):
    async def run(*args, **kwargs):
        return await fn(*args, **{**kwargs, **small})

    return run


@pytest.fixture
def small_runtime(monkeypatch):
    """Both packages' harnesses at small sizes, two sharded workers, the port's
    sharded windows and load generators small (the reference's children keep
    bench.py's 16 senders x 200)."""
    import importlib
    import os

    for pkg in ("rio_tpu", "rio_tpu_torch"):
        for module, fns in RUNTIME_SMALL.items():
            mod = importlib.import_module(f"{pkg}.utils.{module}")
            for name, small in fns.items():
                monkeypatch.setattr(mod, name, _shrunk(getattr(mod, name), small))
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    monkeypatch.setattr(port, "RPC_REQUESTS_PER_WORKER", 10)
    monkeypatch.setattr(port, "SHARDED_WINDOW", {"n_workers": 4, "requests_per_worker": 10,
                                                 "n_objects": 16})
    monkeypatch.setattr(port, "SHARDED_LOADGEN", {"n_gens": 2, "n_workers": 4,
                                                  "requests_per_worker": 10, "n_objects": 16})
    # Build both native libraries here, before any worker process loads one.
    import rio_tpu.native
    import rio_tpu_torch.native

    rio_tpu.native.get()
    rio_tpu_torch.native.get()


def _key_tree(tree):
    """A result's nested keys; addresses as keys (``hot_served_by``) are data."""
    if isinstance(tree, dict):
        return {k: _key_tree(v) for k, v in tree.items() if ":" not in str(k)}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_key_tree(tree[0])]
    return None


@pytest.mark.parametrize("flag", list(port.RUNTIME_TIERS))
def test_each_runtime_tier_returns_the_reference_tiers_keys(flag, small_runtime):
    key, tier = port.RUNTIME_TIERS[flag]
    args = (1.0e4,) if flag in ("rpc", "egress", "sharded") else ()
    got = tier(*args)
    want = getattr(ref, tier.__name__)(*args)
    assert _key_tree(got) == _key_tree(want)
    if flag == "sharded":
        assert got["n_workers"]["n_workers"] == want["n_workers"]["n_workers"] == 2
        assert got["shard_aware"]["redirects"]["shard_aware"] == 0
        assert want["shard_aware"]["redirects"]["shard_aware"] == 0


def test_autoscale_stage_passes_its_ramp_keywords_on(monkeypatch):
    from rio_tpu_torch.utils import autoscale_live

    seen = {}

    async def idle(**kwargs):
        seen["idle"] = kwargs
        return {"batches": 1, "n_requests_per_batch": 1, "msgs_per_sec": {"off": 1.0, "on": 1.0},
                "autoscale_overhead_pct": 0.0, "controller_ticks_on": 1}

    async def ramp(**kwargs):
        seen["ramp"] = kwargs
        return {"seconds": 1.0, "scale_outs": 1, "scale_ins": 1, "acked_writes": 1, "lost": 0,
                "duplicates": 0, "p99_ms": 1.0, "killed_mid_drain": "a:1", "storage_blips": 0}

    monkeypatch.setattr(autoscale_live, "measure_autoscale_idle_overhead", idle)
    monkeypatch.setattr(autoscale_live, "measure_autoscale_ramp", ramp)
    port.autoscale_stage(ramp={"high_timeout": 45.0}, batches=6)
    assert seen == {"idle": {"batches": 6}, "ramp": {"high_timeout": 45.0}}
    port.autoscale_stage()
    assert seen == {"idle": {}, "ramp": {}}


def test_main_runs_a_runtime_tier_without_a_card_and_writes_its_block(small_runtime, tmp_path, capsys):
    out = tmp_path / "rt.json"
    result = port.main(["--migration", "--journal", "--out", str(out)])
    assert set(result) == {"migration_drain", "journal"}
    written = __import__("json").loads(out.read_text())
    assert set(written) == {"migration_drain", "journal"}
    for block in written.values():
        assert set(block["host"]) == {"cpu_count", "sched_affinity", "loadavg"}
    assert written["migration_drain"]["batched"]["moved"] == 32
