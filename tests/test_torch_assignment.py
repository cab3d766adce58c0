"""Parity: rio_tpu_torch.ops.assignment against rio_tpu.ops.assignment on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rio_tpu.ops import assignment as ja  # noqa: E402
from rio_tpu_torch.ops import assignment as ta  # noqa: E402


@pytest.mark.parametrize("grouped", [False, True])
def test_rank_within_group_equals_jax(grouped):
    rng = np.random.default_rng(0)
    groups = rng.integers(0, 17, 500).astype(np.int32)
    keys = groups * 2 + (rng.random(500) < 0.5) if grouped else groups
    keys = keys.astype(np.int32)
    want = ja.rank_within_group(jnp.asarray(keys), jnp.asarray(groups) if grouped else None)
    got = ta.rank_within_group(
        torch.from_numpy(keys), torch.from_numpy(groups) if grouped else None
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _rank_by_cummax(keys, group_keys=None):
    """The former form: each run's start as the running max of start positions."""
    order = torch.argsort(keys, stable=True)
    sorted_groups = (keys if group_keys is None else group_keys)[order]
    pos = torch.arange(keys.shape[0])
    is_start = torch.cat(
        [torch.ones(1, dtype=torch.bool), sorted_groups[1:] != sorted_groups[:-1]]
    )
    start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    return order, sorted_groups, (pos - start).to(torch.int32)


def _groups(case):
    rng = np.random.default_rng(7)
    if case == "one_run":
        return np.full(100_000, 3)
    if case == "distinct":
        return rng.permutation(100_000) - 50_000
    n = {"n1": 1, "n2": 2, "n100000": 100_000}[case]
    return rng.integers(-8, 9, n)


@pytest.mark.parametrize("case", ["n1", "n2", "n100000", "one_run", "distinct"])
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_rank_within_group_equals_the_cummax_form(case, grouped, dtype):
    groups = torch.from_numpy(_groups(case)).to(dtype)
    if grouped:
        bit = torch.from_numpy(np.random.default_rng(8).random(groups.shape[0]) < 0.5)
        keys = groups * 2 + bit.to(dtype)
        got, want = ta.rank_within_group(keys, groups), _rank_by_cummax(keys, groups)
    else:
        got, want = ta.rank_within_group(groups), _rank_by_cummax(groups)
    assert got[2].dtype == torch.int32
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("with_load", [False, True])
def test_greedy_balanced_assign_equals_jax(with_load):
    rng = np.random.default_rng(1)
    n, m = 400, 24
    cost = rng.random((n, m), dtype=np.float32)
    mass = rng.integers(1, 4, n).astype(np.float32)
    cap = rng.integers(1, 5, m).astype(np.float32)
    cap[[3, 9]] = 0.0
    load = rng.integers(0, 20, m).astype(np.float32) if with_load else None
    want = ja.greedy_balanced_assign(
        jnp.asarray(cost), jnp.asarray(mass), jnp.asarray(cap),
        None if load is None else jnp.asarray(load),
    )
    got = ta.greedy_balanced_assign(
        torch.from_numpy(cost), torch.from_numpy(mass), torch.from_numpy(cap),
        None if load is None else torch.from_numpy(load),
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.isin(got.numpy(), [3, 9]).any()


@pytest.mark.parametrize("n", [0, 1, 100, 1001])
def test_integer_fair_quotas_equals_jax(n):
    cap = np.array([3.0, 0.0, 1.0, 1.0, 2.5, 0.5], np.float32)
    got = ta.integer_fair_quotas(cap, n)
    np.testing.assert_array_equal(got, ja.integer_fair_quotas(cap, n))
    assert got.sum() == max(n, 0) and got[1] == 0


def test_residual_capacity_assign_equals_jax():
    score = np.array([0.3, 0.1, 0.3, 0.2])
    residual = np.array([2, 0, 3, 1])
    np.testing.assert_array_equal(
        ta.residual_capacity_assign(score, residual),
        ja.residual_capacity_assign(score, residual),
    )


@pytest.mark.parametrize("with_affinity", [False, True])
def test_build_cost_matrix_matches_jax(with_affinity):
    rng = np.random.default_rng(2)
    load = rng.random(8).astype(np.float32) * 10
    cap = rng.random(8).astype(np.float32)
    cap[2] = 0.0
    alive = np.ones(8, np.float32)
    alive[5] = 0.0
    aff = rng.random((16, 8)).astype(np.float32) if with_affinity else None
    want = ja.build_cost_matrix(
        jnp.asarray(load), jnp.asarray(cap), jnp.asarray(alive),
        None if aff is None else jnp.asarray(aff),
    )
    got = ta.build_cost_matrix(
        torch.from_numpy(load), torch.from_numpy(cap), torch.from_numpy(alive),
        None if aff is None else torch.from_numpy(aff),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_assign_from_potentials_equals_jax():
    rng = np.random.default_rng(3)
    cost = rng.random((64, 10)).astype(np.float32)
    g = rng.normal(size=10).astype(np.float32) * 0.1
    g[[1, 4]] = -np.inf
    g[6] = np.nan  # non-finite potentials never attract
    want = ja.assign_from_potentials(jnp.asarray(cost), jnp.asarray(g))
    got = ta.assign_from_potentials(torch.from_numpy(cost), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
