"""The port's AffinityTracker against the JAX provider's, on one call sequence.

Both trackers see the same ``observe`` / ``fold_rates`` /
``note_state_bytes`` calls with ``time.monotonic`` patched to the same
clock. Features (node embeddings, learned EMAs, cold hashed identities)
agree within ``FEATURE_TOL`` (the port's float32 erfinv differs from
XLA's in the last bits); rates, move weights and evictions are host
arithmetic on equal inputs and agree within the same bound or exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu.object_placement import jax_placement as jp  # noqa: E402

from rio_tpu_torch.object_placement import AffinityTracker, TorchObjectPlacement  # noqa: E402
from rio_tpu_torch.object_placement import torch_placement as tp  # noqa: E402

FEATURE_TOL = 5e-5


class _Clock:
    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(jp.time, "monotonic", c)
    monkeypatch.setattr(tp.time, "monotonic", c)
    return c


NODES = [f"10.0.0.{i}:5000" for i in range(6)]


def _drive(tracker, clock) -> list[dict]:
    """One traffic script; returns a snapshot after each phase."""
    rng = np.random.default_rng(3)
    keys = [f"Obj.{i}" for i in range(40)]
    snaps = []
    for phase in range(4):
        for _ in range(300):
            k = keys[int(rng.integers(0, len(keys) - 10 * (phase % 2)))]
            node = NODES[int(rng.integers(0, len(NODES)))]
            tracker.observe(k, node, weight=float(rng.choice([0.5, 1.0, 2.0, 0.0])))
        tracker.note_state_bytes(keys[phase], 1 << (18 + phase))
        clock.t += 0.5 + phase
        tracker.fold_rates()
        snaps.append({
            "obj": tracker.obj_features(keys + ["Cold.0", ""]),
            "node": tracker.node_features(NODES),
            "rates": tracker.object_rates(),
            "total": tracker.total_rate(),
            "weights": tracker.move_weights(keys),
            "evictions": tracker.evictions,
            "n_obj": len(tracker._obj),
        })
    return snaps


def test_tracker_matches_jax_on_one_traffic_script(clock):
    start = clock.t
    want = _drive(jp.AffinityTracker(max_objects=32), clock)
    clock.t = start
    got = _drive(AffinityTracker(max_objects=32, device="cpu"), clock)
    for a, b in zip(want, got):
        assert np.abs(a["obj"] - b["obj"]).max() <= FEATURE_TOL
        assert np.abs(a["node"] - b["node"]).max() <= FEATURE_TOL
        assert a["rates"].keys() == b["rates"].keys()
        for k in a["rates"]:
            assert abs(a["rates"][k] - b["rates"][k]) <= FEATURE_TOL * max(1.0, a["rates"][k])
        assert abs(a["total"] - b["total"]) <= FEATURE_TOL * max(1.0, a["total"])
        assert np.abs(a["weights"] - b["weights"]).max() <= FEATURE_TOL
        assert a["evictions"] == b["evictions"] and a["n_obj"] == b["n_obj"]
    assert got[-1]["evictions"] > 0
    assert got[-1]["obj"].dtype == np.float32 and got[-1]["node"].dtype == np.float32


def test_node_embeddings_are_unit_and_cold_features_are_a_tenth_of_the_hash():
    t = AffinityTracker(device="cpu")
    nf = t.node_features(NODES)
    assert nf.shape == (len(NODES), 16)
    assert np.allclose(np.linalg.norm(nf, axis=1), 1.0, atol=1e-6)
    assert t.node_features([]).shape == (0, 16)
    cold = t.obj_features(["A.1", "A.2"])
    assert np.array_equal(cold, tp._hash_features(["A.1", "A.2"]).numpy() * 0.1)


def test_observe_pulls_toward_the_serving_node():
    t = AffinityTracker(device="cpu")
    for _ in range(20):
        t.observe("A.1", NODES[2])
    f = t.obj_features(["A.1"])[0]
    assert np.isclose(np.linalg.norm(f), 1.0, atol=1e-6)
    scores = t.node_features(NODES) @ f
    assert int(np.argmax(scores)) == 2 and scores[2] > 0.99


def test_affinity_tracker_high_cardinality_stays_bounded():
    """The bound of tests/test_affinity_edges.py on the port's tracker."""
    tracker = AffinityTracker(max_objects=64, device="cpu")
    hot = [f"Hot.{i}" for i in range(8)]
    for i in range(2000):
        for k in hot:
            tracker.observe(k, "10.0.0.1:5000", weight=1.0)
        tracker.observe(f"OneShot.{i}", "10.0.0.2:5000", weight=1.0)
        assert len(tracker._obj) <= 2 * 64
    tracker.fold_rates(min_dt=0.0)
    assert len(tracker._obj) <= 64
    assert len(tracker._rates) <= 64
    assert tracker.evictions > 0
    assert all(k in tracker._obj for k in hot)


def test_provider_carries_the_tracker_and_prices_moves_with_it():
    tracker = AffinityTracker()
    assert tracker.device is None
    p = TorchObjectPlacement(affinity_tracker=tracker, device="cpu")
    assert p.affinity_tracker is tracker
    assert tracker.device == p.device == torch.device("cpu")
    assert p._object_costs == tracker.move_weights
    assert p._obj_features == tracker.obj_features
    assert p._node_features == tracker.node_features
    assert p._solver_mode() == "hierarchical"
    with pytest.raises(ValueError, match="hierarchical"):
        TorchObjectPlacement(mode="sinkhorn", affinity_tracker=tracker, device="cpu")


def test_tracker_draws_on_the_card_unless_told_otherwise(monkeypatch):
    """A tracker with no device and no provider resolves the CUDA device at
    its first draw, so with no card it raises rather than drawing on the
    CPU; one given a device keeps it when a provider carries it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loose = AffinityTracker()
    with pytest.raises(RuntimeError, match="CUDA"):
        loose.obj_features(["A.1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        loose.observe("A.1", NODES[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        AffinityTracker(device="cuda")
    pinned = AffinityTracker(device="cpu")
    TorchObjectPlacement(affinity_tracker=pinned, device="cpu")
    assert pinned.device == torch.device("cpu")
    # The batched node draw equals the one-key draws observe makes.
    batch = pinned.node_features(NODES)
    one = AffinityTracker(device="cpu")
    assert np.array_equal(np.stack([one._node_vec(a) for a in NODES]), batch)
