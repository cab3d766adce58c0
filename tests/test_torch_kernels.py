"""The one call path into the hand kernels (``rio_tpu_torch/kernels/launch.py``).

The CPU cases hold the kernel table against the sources and the build, the
device rule, the launch registry, and each wrapper's CPU path (its plain
twin, no launch). The cases marked ``card`` run each wrapper once on a CUDA
device against its twin and count the launch; they skip without one. On a
card: ``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py``.
"""

import ctypes
import importlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu_torch.kernels import build  # noqa: E402
from rio_tpu_torch.kernels import launch as L  # noqa: E402
from rio_tpu_torch.ops import cdf_round as cr  # noqa: E402
from rio_tpu_torch.ops import coarse_score as cs  # noqa: E402
from rio_tpu_torch.ops import kbuild as kb  # noqa: E402
from rio_tpu_torch.ops import logdomain_post as lp  # noqa: E402
from rio_tpu_torch.ops import potential_round as pr  # noqa: E402
from rio_tpu_torch.ops import scaling as ts  # noqa: E402

# The package re-exports the functions ``pallas_sinkhorn`` and ``sinkhorn`` under the modules' names.
tps = importlib.import_module("rio_tpu_torch.ops.pallas_sinkhorn")
ms = importlib.import_module("rio_tpu_torch.ops.sinkhorn")
CSRC = Path(build.__file__).resolve().parent / "csrc"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def _calls(name, n, m, device="cpu"):
    """``(wrapper, twin, args)`` of the kernel ``name`` on (n, m) inputs with padding and dead columns."""
    rng = np.random.default_rng(n + m)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)

    K = t(rng.random((n, m)) * 0.99 + 0.01)
    a = rng.random(n) / n + 1e-7
    a[::7] = 0.0
    b = np.full(m, 1.0 / m)
    b[::11] = 0.0
    v = rng.random(m) + 0.5
    if name == "fused_scaling_iteration":
        return ts.fused_scaling_iteration, ts.fused_scaling_iteration_ref, (K.bfloat16(), t(a), t(b), t(v))
    if name == "fused_iteration":
        log_a, log_b = np.log(np.where(a > 0, a, 1.0)), np.log(np.where(b > 0, b, 1.0))
        log_a[a == 0], log_b[b == 0] = -np.inf, -np.inf
        g = rng.normal(size=m) * 0.01
        return tps.fused_iteration, tps.fused_iteration_ref, (K, t(log_a), t(log_b), t(g), 0.07)
    if name == "cdf_round":
        Kb, u, vv = K.bfloat16(), t(a), t(np.where(b > 0, v, 0.0))
        return cr.cdf_round, cr.cdf_round_ref, (Kb, u, vv, t(a / a.sum()), ms.block_quantiles(u > 0))
    if name == "kbuild":
        cost = K.clone()
        cost[:, m // 2] = float("inf")  # a dead node
        return (
            lambda c: kb.kbuild(c, eps=0.05, kernel_dtype=torch.bfloat16),
            lambda c: kb.kbuild_ref(c, eps=0.05, kernel_dtype=torch.bfloat16),
            (cost,),
        )
    if name == "potential_round":
        m = min(m, pr.MAX_KERNEL_COLS - 3)  # the kernel takes rows of at most 32 columns
        f = rng.normal(size=n) * 0.1
        f[::7] = -np.inf  # padding rows
        g = rng.normal(size=m) * 0.1
        g[::11] = -np.inf  # dead columns
        q = (np.arange(n) + 0.5) / n
        return (
            lambda *a: pr.potential_round(*a, 0.05),
            lambda *a: pr.potential_round_ref(*a, 0.05),
            (t(rng.random((n, m))), t(f), t(g), t(q)),
        )
    if name == "logdomain_post":
        f = rng.normal(size=n) * 0.1
        f[::7] = -np.inf  # padding rows
        g = rng.normal(size=m) * 0.1
        g[::11] = -np.inf  # dead columns
        q = (np.arange(n) + 0.5) / n
        b = np.where(np.isfinite(g), 1.0, 0.0)

        def post(cost, f, g, q, b):
            rows = lp.logdomain_post(cost, f, g, q, 0.05)
            return rows.idx, lp.logdomain_post_finalize(rows, cost, f, g, b / b.sum(), 0.05)

        def post_ref(cost, f, g, q, b):
            return lp.logdomain_post_round_ref(cost, f, g, q, 0.05), ms.marginal_err(cost, f, g, b / b.sum(), 0.05)

        return post, post_ref, (t(rng.random((n, m))), t(f), t(g), t(q), t(b))
    groups = 4
    obj = t(rng.standard_normal((n, 16)))
    node = t(rng.standard_normal((16, groups * 8)) * 0.2)
    live = torch.ones(groups * 8, dtype=torch.bool)
    live[[3, 9]] = False
    return cs.coarse_scores, cs.coarse_scores_ref, (obj, node, live.to(device), groups)


def _outputs(x) -> tuple:
    return (x,) if torch.is_tensor(x) else tuple(x)


def _same(x, y) -> bool:
    """Equal values, NaN where NaN, and the same dtype and shape."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    nx, ny = torch.isnan(x), torch.isnan(y)
    return torch.equal(nx, ny) and torch.equal(x.masked_fill(nx, 0), y.masked_fill(ny, 0))


# --- the table, the device rule, the registry ---------------------------------------


def test_the_table_names_every_source_and_the_build_builds_the_table():
    stems = [k.stem for k in L.KERNELS.values()]
    assert sorted(stems) == sorted(p.stem for p in CSRC.glob("*.cu"))
    assert list(build.SOURCES) == stems
    assert len(set(stems)) == len(stems) == 7


@pytest.mark.parametrize("name", list(L.KERNELS))
def test_each_signature_matches_its_c_declaration(name):
    kernel = L.KERNELS[name]
    source = (CSRC / f"{kernel.stem}.cu").read_text()
    for fn_name, argtypes in kernel.signatures.items():
        (params,) = re.findall(rf"^int {fn_name}\(([^)]*)\)", source, re.M)
        params = [" ".join(p.split()) for p in params.split(",")]
        want = []
        for i, p in enumerate(params):
            if "*" not in p:
                want.append({"int": ctypes.c_int, "long long": ctypes.c_longlong,
                             "float": ctypes.c_float}[p.rsplit(" ", 1)[0]])
            elif fn_name.endswith("_parts") and i == len(params) - 1:
                want.append(ctypes.POINTER(ctypes.c_int))  # the count it writes
            else:
                want.append(ctypes.c_void_p)
        assert list(argtypes) == want, (fn_name, params)
    assert set(kernel.signatures) <= {f"{kernel.stem}_{e}" for e in ("launch", "parts", "finalize")}


def test_binding_declares_every_entry_point_once():
    class Lib:
        pass

    kernel = L.KERNELS["fused_scaling_iteration"]
    lib = Lib()
    for fn_name in kernel.signatures:
        setattr(lib, fn_name, Lib())
    kernel.bind(lib)
    for fn_name, argtypes in kernel.signatures.items():
        fn = getattr(lib, fn_name)
        assert fn.argtypes == argtypes and fn.restype is ctypes.c_int


def test_the_device_rule_reads_eager_on_the_cpu_and_refuses_other_devices():
    assert L.impl_for(torch.zeros(2)) == "eager"
    with pytest.raises(ValueError, match="no kernel for device meta"):
        L.impl_for(torch.zeros(2, device="meta"))


def test_the_registry_counts_every_kernel_by_its_wrappers_name():
    assert list(L.launches()) == [
        "fused_scaling_iteration", "fused_iteration", "cdf_round", "kbuild", "coarse_scores",
        "potential_round", "logdomain_post", "logdomain_post_finalize",
    ]
    L.reset_launches()
    assert set(L.launches().values()) == {0}
    counts = L.launches()
    counts["kbuild"] += 1  # a copy: the registry is read, not handed out
    assert L.launches()["kbuild"] == 0


def test_the_k_dtype_codes_live_in_one_module():
    assert L.K_DTYPES == {torch.float32: 0, torch.bfloat16: 1}
    for module in (ts, cr, kb):
        assert module.K_DTYPES is L.K_DTYPES


# --- each wrapper on the CPU -----------------------------------------------------------


@pytest.mark.parametrize("name", list(L.KERNELS))
def test_the_wrapper_on_the_cpu_runs_the_twin_and_counts_no_launch(name):
    fn, ref, args = _calls(name, 64, 40)
    before = L.launches()
    got = fn(*args)
    assert L.launches() == before
    want = ref(*args)
    for x, y in zip(_outputs(got), _outputs(want), strict=True):
        assert _same(x, y)


# --- on the card ------------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("name", list(L.KERNELS))
def test_each_wrapper_on_the_card_launches_once_near_its_twin(card, name):
    fn, ref, args = _calls(name, 1000, 130, device=card)
    before = L.launches()
    got = fn(*args)
    torch.cuda.synchronize()
    after = L.launches()
    counted = L.KERNELS[name].counted  # the kernel's own count, and its finalize's
    assert all(after[k] == before[k] + 1 for k in counted)
    assert all(after[k] == before[k] for k in after if k not in counted)
    for x, y in zip(_outputs(got), _outputs(ref(*args)), strict=True):
        assert x.device == y.device and x.dtype == y.dtype and x.shape == y.shape
        if name == "potential_round":  # the eager chain's order, bit for bit
            assert torch.equal(x, y)
        elif x.dtype == torch.int32:  # the rounding's seats: its sums run in another order
            assert float((x == y).float().mean()) >= 0.999
        else:  # float32 sums in another order, approximate exponentials in the log domain
            x, y = x.float(), y.float()
            scale = float(y[torch.isfinite(y)].abs().max())
            torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4 * scale, equal_nan=True)
