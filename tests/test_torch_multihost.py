"""rio_tpu_torch.parallel.multihost: the mesh across processes on torch.distributed.

The single-process contract of ``tests/test_multihost.py`` (no cluster means
one process; partial multi-process intent raises; ``process_rows`` and
``distributed_array`` degrade to the local equivalent), a world of one
process with a gloo group up (the card's NCCL check, on the CPU), and a
real two-process run over loopback: the case of ``tests/multihost_child.py``
(256 x 8 features, 16 nodes, node 3 dead, 4 groups, 8 + 8 iterations) on a
2 x 2 mesh of two CPU shards a process. Each process feeds only its own
rows; the gathered assignment must equal the port's per-shard solves
exactly and JAX's on at least 99% of the rows.

This file is also the child program: ``python tests/test_torch_multihost.py
<process_id> <num_processes> <port> <dir>`` joins the group, solves and, in
process 0, writes the result into ``<dir>``.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

N_OBJ, D, M, G, DEAD, ITERS = 256, 8, 16, 4, 3, 8
ROW_AGREEMENT = 0.99
CHILD_TIMEOUT_S = 90  # each child's whole run; the group's own timeout is 60 s


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _node_inputs():
    alive = torch.ones(M)
    alive[DEAD] = 0.0
    return torch.ones(M), alive


def _solve_kw():
    return dict(n_groups=G, coarse_iters=ITERS, fine_iters=ITERS)


# ------------------------------------------------------------ one process


@pytest.fixture
def no_cluster_env(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)


def test_initialize_without_a_cluster_is_single_process(no_cluster_env):
    from rio_tpu_torch.parallel import multihost

    assert multihost.initialize() is False
    assert multihost.is_multihost() is False


@pytest.mark.parametrize(
    "args",
    [("127.0.0.1:1", 2, None), (None, 2, 0), ("127.0.0.1:1", None, 0)],
    ids=["no_process_id", "no_coordinator", "no_num_processes"],
)
def test_partial_explicit_intent_raises(no_cluster_env, args):
    """A launcher that passes part of a world must not run as 1 of 1."""
    from rio_tpu_torch.parallel import multihost

    with pytest.raises(ValueError, match="must all be given"):
        multihost.initialize(*args)


def test_partial_environment_raises(no_cluster_env, monkeypatch):
    from rio_tpu_torch.parallel import multihost

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="partial process-group environment"):
        multihost.initialize()


def test_process_rows_covers_everything_single_process():
    from rio_tpu_torch.parallel import make_mesh, multihost

    mesh = make_mesh(["cpu"] * 8)
    n = 64 * mesh.shape["obj"]
    assert multihost.process_rows(n, mesh) == slice(0, n)
    assert multihost.process_rows(n, mesh, "obj") == slice(0, n)
    with pytest.raises(ValueError, match="do not split"):
        multihost.process_rows(n + 1, mesh)


def test_distributed_array_matches_the_local_rows_and_feeds_the_solver():
    from rio_tpu_torch.parallel import make_mesh, multihost
    from rio_tpu_torch.parallel.hierarchical import hierarchical_assign, sharded_hierarchical_assign

    mesh = make_mesh(["cpu"] * 8)
    n_obj = 64 * mesh.shape["obj"]
    rows = multihost.process_rows(n_obj, mesh)
    local = torch.arange(n_obj * 4, dtype=torch.float32).reshape(n_obj, 4)[rows]
    arr = multihost.distributed_array(mesh, ("obj", None), local)
    assert arr.shape == (n_obj, 4) and len(arr.blocks) == 8
    assert torch.equal(arr.gather(), local)
    # Each block is a view of the local rows: nothing is copied on one device.
    assert all(b.untyped_storage().data_ptr() == local.untyped_storage().data_ptr()
               for b in arr.blocks.values())

    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.normal(size=(n_obj, 4)).astype(np.float32))
    node = torch.full((4, 16), 0.1)
    cap, alive = torch.ones(16), torch.ones(16)
    sharded = multihost.distributed_array(mesh, (("obj", "node"), None), feats)
    kw = dict(n_groups=4, coarse_iters=4, fine_iters=4)
    res = sharded_hierarchical_assign(mesh, sharded, node, cap, alive, **kw)
    assert res.assignment.shape == (n_obj,)
    assert int(res.assignment.min()) >= 0 and int(res.assignment.max()) < 16
    whole = sharded_hierarchical_assign(mesh, feats, node, cap, alive, **kw)
    assert torch.equal(res.assignment, whole.assignment)
    step = n_obj // 8
    parts = [hierarchical_assign(feats[k * step:(k + 1) * step], node, cap, alive, **kw) for k in range(8)]
    assert torch.equal(res.assignment, torch.cat([p.assignment for p in parts]))


def test_a_group_of_one_runs_the_same_solve(no_cluster_env):
    """``initialize`` with an explicit world of one brings gloo up (the
    card's NCCL check runs the same at world size 1); a second call is a
    no-op; the mesh built with the group up spans this process only, and
    its solve, whose reductions now go through ``all_reduce``, equals the
    solve without a group."""
    import torch.distributed as dist

    from rio_tpu_torch.parallel import make_mesh, multihost
    from rio_tpu_torch.parallel.hierarchical import sharded_hierarchical_assign

    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.normal(size=(N_OBJ, D)).astype(np.float32))
    node = torch.from_numpy((rng.normal(size=(D, M)) * 0.2).astype(np.float32))
    cap, alive = _node_inputs()
    plain = sharded_hierarchical_assign(make_mesh(["cpu"] * 4), feats, node, cap, alive, **_solve_kw())
    assert multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, timeout=30) is False
    try:
        assert dist.get_backend() == "gloo"
        assert multihost.initialize() is False  # already up
        assert multihost.is_multihost() is False
        mesh = make_mesh(["cpu"] * 4)
        assert mesh.distributed and mesh.devices.shape == (2, 2) and (mesh.ranks == 0).all()
        grouped = sharded_hierarchical_assign(mesh, feats, node, cap, alive, **_solve_kw())
    finally:
        dist.destroy_process_group()
    assert torch.equal(grouped.assignment, plain.assignment)
    assert int(grouped.overflow) == int(plain.overflow)
    assert torch.equal(grouped.coarse_g, plain.coarse_g)


# ------------------------------------------------------------ two processes


def _child(pid: int, nproc: int, port: int, outdir: str) -> None:
    torch.set_num_threads(1)  # CPU float sums in one order, as in the parent
    import torch.distributed as dist

    from rio_tpu_torch.parallel import make_mesh, multihost
    from rio_tpu_torch.parallel.hierarchical import sharded_hierarchical_assign

    ok = multihost.initialize(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid, timeout=60)
    assert ok and multihost.is_multihost(), ok
    inputs = np.load(os.path.join(outdir, "inputs.npz"))
    mesh = make_mesh(["cpu", "cpu"])  # spans every process's shards
    assert mesh.distributed and mesh.devices.shape == (2, 2)
    rows = multihost.process_rows(N_OBJ, mesh)
    obj_feat = multihost.distributed_array(mesh, (("obj", "node"), None), inputs["obj"][rows])
    assert set(obj_feat.blocks) == set(mesh.local_cells)
    cap, alive = _node_inputs()
    res = sharded_hierarchical_assign(
        mesh, obj_feat, torch.from_numpy(inputs["node"]), cap, alive, **_solve_kw()
    )
    if pid == 0:
        np.save(os.path.join(outdir, "assignment.npy"), res.assignment.numpy())
        np.save(os.path.join(outdir, "meta.npy"),
                np.asarray([int(res.overflow), int(mesh.devices.size), rows.start, rows.stop]))
    dist.destroy_process_group()
    print(f"[{pid}] done", flush=True)


def test_two_process_gloo_solve_equals_the_per_shard_solves(tmp_path):
    """Two OS processes, two CPU shards each, joined by gloo over loopback
    into one 2 x 2 mesh; each feeds only its rows. The assignment equals the
    concatenation of per-shard ``hierarchical_assign`` calls exactly (the
    solve is shard-local by design) and JAX's per-shard solves on >= 99%."""
    import jax
    import jax.numpy as jnp

    from rio_tpu.parallel.hierarchical import hierarchical_assign as jax_hierarchical_assign

    from rio_tpu_torch.parallel.hierarchical import hierarchical_assign

    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    obj = np.array(jax.random.normal(k1, (N_OBJ, D), jnp.float32))
    node = np.array(jax.random.normal(k2, (D, M), jnp.float32)) * np.float32(0.2)
    np.savez(tmp_path / "inputs.npz", obj=obj, node=node)

    repo = str(Path(__file__).resolve().parent.parent)
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", "/tmp"),
           "PYTHONPATH": repo, "TMPDIR": os.environ.get("TMPDIR", "/tmp")}
    port = _free_port()
    procs = [
        subprocess.Popen([sys.executable, __file__, str(pid), "2", str(port), str(tmp_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert all(p.returncode == 0 for p in procs), outs

    a = np.load(tmp_path / "assignment.npy")
    overflow, n_shards, lo, hi = np.load(tmp_path / "meta.npy").tolist()
    assert (lo, hi) == (0, N_OBJ // 2)  # process 0 fed the first half only
    assert a.shape == (N_OBJ,) and overflow == 0 and n_shards == 4
    assert not (a == DEAD).any(), "the dead node attracted objects"

    cap, alive = _node_inputs()
    step = N_OBJ // n_shards
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = np.concatenate([
            hierarchical_assign(torch.from_numpy(obj[k * step:(k + 1) * step]), torch.from_numpy(node),
                                cap, alive, **_solve_kw()).assignment.numpy()
            for k in range(n_shards)
        ])
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(a, ref)

    jalive = jnp.ones((M,), jnp.float32).at[DEAD].set(0.0)
    jref = np.concatenate([
        np.asarray(jax_hierarchical_assign(obj[k * step:(k + 1) * step], node, jnp.ones((M,), jnp.float32),
                                           jalive, **_solve_kw()).assignment)
        for k in range(n_shards)
    ])
    assert np.mean(a == jref) >= ROW_AGREEMENT


if __name__ == "__main__":
    _child(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
