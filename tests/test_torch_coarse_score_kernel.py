"""The coarse-score kernel (``ops/coarse_score.py``, ``kernels/csrc/coarse_score.cu``) and its place in the two-level solve.

The CPU cases hold the wrapper's checks, the plain twin against the eager
loop ``hierarchical_assign`` ran inline before the kernel, and the
two-level solve's CPU results bit for bit. The cases marked ``card``
compare the kernel with its twin and with float64 scores, and count its
launches; they skip without a CUDA device. On a card:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_coarse_score_kernel.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu_torch import tracing  # noqa: E402
from rio_tpu_torch.kernels.launch import launches  # noqa: E402
from rio_tpu_torch.ops import coarse_score as cs  # noqa: E402
from rio_tpu_torch.parallel import hierarchical as H  # noqa: E402

N_RAGGED = 1237  # a multiple of no block of rows or groups


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def _inputs(n, d, groups, s, *, seed=0, dead=(), device="cpu"):
    """Standard normal features (nodes scaled by 0.2, as the directory's), ``dead`` nodes off."""
    rng = np.random.default_rng(seed)
    obj = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(device)
    node = torch.from_numpy(rng.standard_normal((d, groups * s), dtype=np.float32) * 0.2).to(device)
    live = torch.ones(groups * s, dtype=torch.bool)
    live[list(dead)] = False
    return obj, node, live.to(device)


def _inline_loop(obj_feat, node_feat, live, n_groups, block_elems=1 << 26):
    """The coarse scores as ``hierarchical_assign`` computed them inline before the kernel."""
    n, m = obj_feat.shape[0], node_feat.shape[1]
    s = m // n_groups
    alive_grouped = live.reshape(n_groups, s)
    coarse_aff = torch.empty((n, n_groups), dtype=torch.float32, device=obj_feat.device)
    block = max(1, min(n_groups, block_elems // max(1, n * s)))
    for g0 in range(0, n_groups, block):
        g1 = min(n_groups, g0 + block)
        scores = (obj_feat @ node_feat[:, g0 * s : g1 * s]).view(n, g1 - g0, s)
        scores = scores.masked_fill(~alive_grouped[g0:g1], float("-inf"))
        coarse_aff[:, g0:g1] = scores.amax(dim=-1)
    return coarse_aff


def _same(x, y) -> bool:
    """Equal values, NaN where NaN, and the same dtype and shape."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    nx, ny = torch.isnan(x), torch.isnan(y)
    return torch.equal(nx, ny) and torch.equal(x.masked_fill(nx, 0), y.masked_fill(ny, 0))


def _near_float64(got, obj, node, live, groups) -> bool:
    """``got`` against the scores in float64: NaN and -inf where they are, every finite
    entry within d float32 roundings of the group's largest ``|x| @ |w|``."""
    n, d = obj.shape
    s = node.shape[1] // groups
    exact = (obj.double() @ node.double()).masked_fill(~live, float("-inf"))
    exact = exact.view(n, groups, s).amax(dim=-1)
    slack = (obj.double().abs() @ node.double().abs()).view(n, groups, s).amax(dim=-1)
    slack = slack * max(d, 1) * 2.0**-23
    finite = torch.isfinite(exact)
    return (
        got.dtype == torch.float32 and got.shape == exact.shape
        and torch.equal(torch.isnan(got), torch.isnan(exact))
        and torch.equal(got == float("-inf"), exact == float("-inf"))
        and bool(((got.double() - exact).abs() <= slack)[finite].all())
    )


# --- the wrapper's checks ----------------------------------------------------


@pytest.mark.parametrize(
    "case",
    ["obj_dtype", "node_dtype", "live_dtype", "rank", "feature_dims", "live_len", "groups",
     "zero_groups", "device", "noncontiguous"],
)
def test_the_wrapper_rejects_what_the_kernel_does_not_take(case):
    obj, node, live = _inputs(16, 4, 4, 8)
    groups, expect = 4, ValueError
    if case == "obj_dtype":
        obj, expect = obj.double(), TypeError
    elif case == "node_dtype":
        node, expect = node.half(), TypeError
    elif case == "live_dtype":
        live, expect = live.float(), TypeError
    elif case == "rank":
        obj = obj[None]
    elif case == "feature_dims":
        node = node[:3].contiguous()
    elif case == "live_len":
        live = live[:-1]
    elif case == "groups":
        groups = 5
    elif case == "zero_groups":
        groups = 0
    elif case == "device":
        obj = obj.to("meta")
    else:
        node = torch.rand(32, 4).t()
    with pytest.raises(expect):
        cs.coarse_scores(obj, node, live, groups)


# --- the twin against the inline loop ------------------------------------------


@pytest.mark.parametrize("d", [1, 16, 17])
@pytest.mark.parametrize("s", [1, 8, 32])
@pytest.mark.parametrize("groups", [1, 3, 32, 128])
def test_the_twin_equals_the_old_inline_loop(groups, s, d):
    dead = [j for j in range(groups * s) if j % 7 == 3]
    obj, node, live = _inputs(N_RAGGED, d, groups, s, seed=groups + s + d, dead=dead)
    got = cs.coarse_scores_ref(obj, node, live, groups)
    assert got.shape == (N_RAGGED, groups) and got.dtype == torch.float32
    assert _same(got, _inline_loop(obj, node, live, groups))


@pytest.mark.parametrize("groups", [3, 32])
def test_the_twin_equals_the_inline_loop_when_groups_are_scored_in_blocks(monkeypatch, groups):
    s, block = 8, 2
    obj, node, live = _inputs(N_RAGGED, 16, groups, s, seed=groups, dead=(1, 9, 10))
    elems = N_RAGGED * s * block
    monkeypatch.setattr(cs, "_COARSE_BLOCK_ELEMS", elems)
    assert _same(cs.coarse_scores_ref(obj, node, live, groups), _inline_loop(obj, node, live, groups, elems))


def test_dead_nodes_a_dead_group_and_nan_features():
    groups, s = 4, 8
    dead = [0, 5] + list(range(2 * s, 3 * s))  # two members of group 0 and all of group 2
    obj, node, live = _inputs(64, 16, groups, s, seed=3, dead=dead)
    node[:, 1] = float("nan")  # a NaN score on a live member of group 0
    node[:, 5] = float("nan")  # and on a dead member: masked away
    obj[7, 3] = float("nan")  # a row whose every score is NaN
    got = cs.coarse_scores_ref(obj, node, live, groups)
    assert _same(got, _inline_loop(obj, node, live, groups))
    assert bool(torch.isnan(got[:, 0]).all())  # the live NaN member wins group 0
    assert bool((got[:, 2] == float("-inf")).all())  # no live member
    assert int(torch.isnan(got[7]).sum()) == 3 and float(got[7, 2]) == float("-inf")
    assert _near_float64(got, obj, node, live, groups)


# --- the two-level solve on the CPU ------------------------------------------


def _solve(**kw):
    gen = torch.Generator().manual_seed(5)
    obj = torch.randn(8192, 4, generator=gen)
    node = torch.randn(4, 64, generator=gen) * 0.2
    cap = torch.ones(64)
    alive = torch.ones(64)
    alive[[3, 17, 18]] = 0.0
    return H.chunked_hierarchical_assign(
        obj, node, cap, alive, n_groups=8, n_chunks=2, coarse_iters=10, fine_iters=10, **kw,
    )


def test_the_two_level_solve_on_the_cpu_is_bit_identical_to_the_inline_loop(monkeypatch):
    got = _solve()
    monkeypatch.setattr(H, "coarse_scores", _inline_loop)
    want = _solve()
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_the_coarse_score_span_nests_in_the_coarse_stage_and_reads_eager():
    seen = []
    tracing.add_sink(seen.append)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _solve()
    finally:
        tracing.clear_sinks()
    assert [s.attrs for s in seen if s.name == "hier.coarse_score"] == [{"impl": "eager"}] * 2
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    coarse, score = sorted(ranges["hier.coarse"]), sorted(ranges["hier.coarse_score"])
    assert len(coarse) == len(score) == 2
    for (c0, c1), (s0, s1) in zip(coarse, score):
        assert c0 <= s0 and s1 <= c1


# --- on the card ----------------------------------------------------------------


@pytest.mark.card
def test_the_kernel_equals_the_twin_at_the_cells_shape(card):
    n, d, groups, s = 655_360, 16, 32, 32
    obj, node, live = _inputs(n, d, groups, s, seed=22, device=card)
    before = launches()["coarse_scores"]
    got = cs.coarse_scores(obj, node, live, groups)
    torch.cuda.synchronize()
    assert launches()["coarse_scores"] == before + 1
    want = cs.coarse_scores_ref(obj, node, live, groups)
    assert int((got != want).sum()) == 0  # bit for bit: the same FMA chain as the GEMM's


# Groups of 1,100 nodes exceed the shared-memory tile at d = 16: they take the
# kernel's any-shape path, as d = 40 does.
RAGGED_GROUPS = [(g, s) for g in (1, 3, 32, 128) for s in (1, 8, 32)] + [(1, 1100), (3, 1100)]


@pytest.mark.card
@pytest.mark.parametrize("d", [1, 16, 17, 40])
@pytest.mark.parametrize("groups,s", RAGGED_GROUPS)
def test_the_kernel_on_ragged_shapes_with_dead_nodes(card, groups, s, d):
    dead = [j for j in range(groups * s) if j % 7 == 3] + list(range(s, 2 * s) if groups > 1 else [])
    obj, node, live = _inputs(N_RAGGED, d, groups, s, seed=groups + s + d, dead=dead, device=card)
    before = launches()["coarse_scores"]
    got = cs.coarse_scores(obj, node, live, groups)
    torch.cuda.synchronize()
    assert launches()["coarse_scores"] == before + 1
    assert _near_float64(got, obj, node, live, groups)
    assert _near_float64(cs.coarse_scores_ref(obj, node, live, groups), obj, node, live, groups)


@pytest.mark.card
def test_the_kernel_propagates_nan_and_takes_an_unaligned_row_base(card):
    groups, s, d = 8, 8, 16
    obj, node, live = _inputs(999, d, groups, s, seed=4, dead=list(range(s)))
    node[:, 9] = float("nan")
    obj[5, 2] = float("nan")
    flat = torch.empty(999 * d + 1, device=card)
    shifted = flat[1:].view(999, d)  # 4-byte aligned, not 16
    shifted.copy_(obj.to(card))
    got = cs.coarse_scores(shifted, node.to(card), live.to(card), groups).cpu()
    assert bool((got[:, 0] == float("-inf")).all()) and bool(torch.isnan(got[:, 1]).all())
    assert int(torch.isnan(got[5]).sum()) == groups - 1
    assert _near_float64(got, obj, node, live, groups)


@pytest.mark.card
def test_a_card_solve_launches_the_kernel_once_a_chunk(card):
    gen = torch.Generator(device=card).manual_seed(3)
    obj = torch.randn(4 * 65_536, 16, generator=gen, device=card)
    node = torch.randn(16, 1024, generator=gen, device=card) * 0.2
    cap = torch.ones(1024, device=card)
    alive = torch.ones(1024, device=card)
    alive[[5, 700]] = 0.0
    seen = []
    tracing.add_sink(seen.append)
    try:
        before = launches()["coarse_scores"]
        res = H.chunked_hierarchical_assign(obj, node, cap, alive, n_groups=32, n_chunks=4)
        torch.cuda.synchronize()
        assert launches()["coarse_scores"] == before + 4
    finally:
        tracing.clear_sinks()
    assert int(res.overflow) == 0
    assert [s.attrs for s in seen if s.name == "hier.coarse_score"] == [{"impl": "kernel"}] * 4
