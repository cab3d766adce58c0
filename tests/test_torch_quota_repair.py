"""The exact-quota repair (``ops/sinkhorn.py`` ``exact_quota_repair``) waits on nothing.

The repair counts its cells by ``scatter_add_`` and ranks within a cell by a
``searchsorted`` of the sorted cells, so on a card the host can queue the
whole repair behind the rounding. The CPU case holds the repair off the two
operators that serialise it (``torch.bincount``, which sizes its output on the
host, and ``torch.cummax``, a one-block scan); the JAX parity cases live in
``test_torch_sinkhorn.py``. The cases marked ``card`` run the repair under
``torch.cuda.set_sync_debug_mode("error")`` at the flat cell's shape and at the
two-level solve's fine stage, and compare its seats with the CPU's bit for bit;
they skip without a CUDA device. On a card:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_quota_repair.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu_torch.ops.sinkhorn import exact_quota_repair  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def _inputs(shape, prefer, seed=0):
    """A rounded assignment, its expected counts and the keep mask, on the CPU.

    ``flat``: 1,048,576 objects over 1,024 columns. ``fine``: 32 groups of
    25,600 rows over 32 members and the padding sentinel, some members dead.
    """
    rng = np.random.default_rng(seed)
    if shape == "flat":
        n, m = 1 << 20, 1024
        idx = rng.integers(0, m, n).astype(np.int32)
        w = rng.random(m) + 0.5
        expected = (w / w.sum() * n).astype(np.float32)
    else:
        G, B, M = 32, 25_600, 32
        n_real = rng.integers(B // 2, B + 1, G)
        real = np.arange(B)[None, :] < n_real[:, None]
        idx = np.where(real, rng.integers(0, M, (G, B)), M).astype(np.int32)
        cap = rng.random((G, M)) + 0.5
        cap[:4, :5] = 0.0
        expected = np.concatenate(
            [cap / cap.sum(-1, keepdims=True) * n_real[:, None], (B - n_real)[:, None]], -1
        ).astype(np.float32)
    keep = torch.from_numpy(rng.random(idx.shape) < 0.5) if prefer else None
    return torch.from_numpy(idx), torch.from_numpy(expected), keep


@pytest.mark.parametrize("prefer", [False, True])
def test_the_repair_calls_neither_bincount_nor_cummax(monkeypatch, prefer):
    def refuse(*args, **kwargs):
        raise AssertionError("the repair ran an operator that serialises it")

    idx, expected, keep = _inputs("fine", prefer)
    want = exact_quota_repair(idx, expected, keep)
    monkeypatch.setattr(torch, "bincount", refuse)
    monkeypatch.setattr(torch, "cummax", refuse)
    assert torch.equal(exact_quota_repair(idx, expected, keep), want)


# --- on the card ----------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("shape", ["flat", "fine"])
@pytest.mark.parametrize("prefer", [False, True])
def test_the_repair_on_the_card_waits_on_nothing_and_equals_the_cpu(card, shape, prefer):
    idx, expected, keep = _inputs(shape, prefer, seed=1)
    want = exact_quota_repair(idx, expected, keep)
    args = [t.to(card) for t in (idx, expected)] + [None if keep is None else keep.to(card)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = exact_quota_repair(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
