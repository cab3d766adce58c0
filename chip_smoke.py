#!/usr/bin/env python3
"""Run the PyTorch port's placement step on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device``  — the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. ``build``   — compiles every CUDA source of ``rio_tpu_torch/kernels/csrc`` with nvcc;
3. ``ragged``  — the fused scaling-iteration kernel against its plain PyTorch twin on
   small ragged shapes (zero-mass rows, zero-capacity columns, float32 and bfloat16 K,
   every load path), rtol 1e-4;
4. ``full_width`` — the same at 1,048,576 x 1024 bfloat16, one iteration, rtol 1e-4;
5. ``main_path`` — ``placement_step`` at 1,048,576 objects x 1024 nodes (bf16 K,
   eps 0.05, 30 iterations, rounding in 65,536-row chunks) on ``make_problem(seed=0)``:
   the kernel launched 30 times, every node seated at its quota of 1,024;
6. ``step_vs_plain`` — the solve through the kernel against the solve through the plain
   twin at 262,144 x 1024: u and v within rtol 1e-3 after 30 iterations, both
   assignments at quota, rows agreeing >= 99%;
7. ``times`` — CUDA-event medians: the kernel, its plain twin, ``torch.mv`` twice
   (the two-read yardstick, never called by the port), each over batches of
   calls; the whole step and each of its stages.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``. Any failed
check raises, so the script exits non-zero and prints no result. Without a CUDA
device it exits 1 at once.

Float32 sums are taken in another order on the card than in the plain twin
(a per-CTA split of the column sums, a shuffle tree for each row), which is
what the 1e-4 tolerance absorbs; the kernel uses no atomics.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, NVIDIA data sheet

N_OBJ, N_NODES, CHUNK, N_ITERS, EPS = 1 << 20, 1024, 65536, 30, 0.05
PLAIN_N_OBJ = 262144
RTOL_KERNEL = 1e-4
RTOL_STEP = 1e-3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def max_rel_err(got, want) -> float:
    """max |got - want| / |want| over nonzero ``want``; zeros must match exactly."""
    check(bool(((got == 0) == (want == 0)).all()), "zero pattern differs")
    nz = want != 0
    if not bool(nz.any()):
        return 0.0
    return float(((got[nz] - want[nz]).abs() / want[nz].abs()).max())


def cuda_median_ms(fn, reps: int, warmup: int = 2, batch: int = 1) -> float:
    """Median ms of one call of ``fn`` over ``reps`` samples.

    Each sample is one pair of CUDA events around ``batch`` calls, divided
    by ``batch``: with a batch, the host's work between launches overlaps
    the card's instead of sitting inside the timed window.
    """
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from rio_tpu_torch.entry import (
        make_problem,
        placement_step,
        round_and_repair,
        round_from_scaling,
        row_marginal_err,
    )
    from rio_tpu_torch.kernels import build
    from rio_tpu_torch.ops import scaling as S
    from rio_tpu_torch.ops.sinkhorn import exact_quota_repair, normalize_marginals

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    card = {"card": smi, "kind": torch.cuda.get_device_name(0)}
    emit("device", **card, torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    ptxas = [
        line.strip() for log in logs.values() for line in log.splitlines()
        if "registers" in line or ("spill" in line and " 0 bytes spill" not in line)
    ]
    emit("build", seconds=build_s, sources=list(build.SOURCES), ptxas=ptxas)

    # -- 3. ragged shapes: kernel vs plain twin -----------------------------
    gen = torch.Generator(device=dev).manual_seed(7)
    ragged = []
    for n, m, kdt, offset in [
        (1000, 130, torch.float32, 0),   # one element per lane (130*4 bytes not 16-aligned)
        (1000, 130, torch.bfloat16, 0),
        (777, 1024, torch.bfloat16, 0),  # 16-byte loads, one column tile
        (300, 96, torch.float32, 0),
        (513, 2600, torch.bfloat16, 0),  # three column tiles
        (257, 1024, torch.bfloat16, 3),  # K base not 16-byte aligned
        (5, 40, torch.float32, 0),       # fewer rows than one CTA's warps
    ]:
        K = torch.empty(n * m + offset, dtype=kdt, device=dev)[offset:].view(n, m)
        K.copy_(torch.rand((n, m), generator=gen, device=dev) * 0.99 + 0.01)
        a = torch.rand(n, generator=gen, device=dev)
        a[::7] = 0.0
        a /= a.sum()
        b = torch.full((m,), 1.0 / m, device=dev)
        b[::11] = 0.0
        v = torch.rand(m, generator=gen, device=dev) + 0.5
        u_k, v_k = S.fused_scaling_iteration(K, a, b, v)
        torch.cuda.synchronize()
        u_p, v_p = S.fused_scaling_iteration_ref(K, a, b, v)
        eu, ev = max_rel_err(u_k, u_p), max_rel_err(v_k, v_p)
        check(eu <= RTOL_KERNEL and ev <= RTOL_KERNEL, f"ragged {n}x{m} {kdt}: {eu}, {ev}")
        ragged.append({"n": n, "m": m, "dtype": str(kdt), "offset": offset,
                       "u_rel": eu, "v_rel": ev})
    emit("ragged", rtol=RTOL_KERNEL, cases=ragged)

    # -- 4. full width: kernel vs plain twin --------------------------------
    cost, mass, cap = make_problem(N_OBJ, N_NODES, seed=0, device=dev)
    a, b, K, _ = S.scaling_kernel(cost, mass, cap, eps=EPS, kernel_dtype=torch.bfloat16)
    v = torch.ones(N_NODES, device=dev)
    u_k, v_k = S.fused_scaling_iteration(K, a, b, v)
    torch.cuda.synchronize()
    u_p, v_p = S.fused_scaling_iteration_ref(K, a, b, v)
    eu, ev = max_rel_err(u_k, u_p), max_rel_err(v_k, v_p)
    max_abs = max(float((u_k - u_p).abs().max()), float((v_k - v_p).abs().max()))
    check(eu <= RTOL_KERNEL and ev <= RTOL_KERNEL, f"full width: {eu}, {ev}")
    emit("full_width", n=N_OBJ, m=N_NODES, rtol=RTOL_KERNEL, u_rel=eu, v_rel=ev, max_abs_err=max_abs)
    del K, u_k, v_k, u_p, v_p

    # -- 5. the main path ---------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    S.fused_scaling_iteration.launches = 0
    t0 = time.perf_counter()
    assignment, mean_cost, err = placement_step(
        cost, mass, cap, eps=EPS, n_iters=N_ITERS, kernel_dtype=torch.bfloat16,
        chunk=CHUNK, device=dev,
    )
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = S.fused_scaling_iteration.launches
    peak = torch.cuda.max_memory_allocated()
    check(launches == N_ITERS, f"kernel launched {launches} times, want {N_ITERS}")
    check(assignment.shape == (N_OBJ,), "assignment shape")
    check(int(assignment.min()) >= 0 and int(assignment.max()) < N_NODES, "index range")
    loads = torch.bincount(assignment.long(), minlength=N_NODES)
    quota = N_OBJ // N_NODES
    check(bool((loads == quota).all()), f"node loads {int(loads.min())}..{int(loads.max())}")
    mean_cost, err = float(mean_cost), float(err)
    check(mean_cost < 0.25, f"mean assigned cost {mean_cost} (random placement: 0.50)")
    check(err == err and err < 1e-2, f"row-marginal error {err}")
    emit("main_path", n=N_OBJ, m=N_NODES, chunk=CHUNK, n_iters=N_ITERS, launches=launches,
         quota=quota, mean_cost=mean_cost, row_marginal_err=err, first_step_s=step_s,
         peak_bytes=peak)
    del assignment, loads

    # -- 6. whole step: kernel path vs plain path ---------------------------
    pc, pm, pcap = make_problem(PLAIN_N_OBJ, N_NODES, seed=1, device=dev)
    u_k, v_k, K, _ = S.fused_scaling_core(pc, pm, pcap, eps=EPS, n_iters=N_ITERS)
    pa, pb = normalize_marginals(pm, pcap)
    u_p, v_p = torch.zeros_like(pa), torch.ones_like(pb)
    for _ in range(N_ITERS):
        u_p, v_p = S.fused_scaling_iteration_ref(K, pa, pb, v_p)
    eu, ev = max_rel_err(u_k, u_p), max_rel_err(v_k, v_p)
    check(eu <= RTOL_STEP and ev <= RTOL_STEP, f"30 iterations: {eu}, {ev}")
    asg_k, cost_k, _ = round_and_repair(pc, pm, pcap, u_k, v_k, K, chunk=CHUNK)
    asg_p, cost_p, _ = round_and_repair(pc, pm, pcap, u_p, v_p, K, chunk=CHUNK)
    pquota = PLAIN_N_OBJ // N_NODES
    for asg in (asg_k, asg_p):
        check(bool((torch.bincount(asg.long(), minlength=N_NODES) == pquota).all()), "quota")
    agree = float((asg_k == asg_p).float().mean())
    check(agree >= 0.99, f"row agreement {agree}")
    emit("step_vs_plain", n=PLAIN_N_OBJ, m=N_NODES, rtol=RTOL_STEP, u_rel=eu, v_rel=ev,
         row_agreement=agree, mean_cost_kernel=float(cost_k), mean_cost_plain=float(cost_p))
    del pc, pm, pcap, K, asg_k, asg_p

    # -- 7. times at full width ---------------------------------------------
    a, b, K, _ = S.scaling_kernel(cost, mass, cap, eps=EPS, kernel_dtype=torch.bfloat16)
    u = torch.full((N_OBJ,), 1.0 / N_OBJ, device=dev)
    v = torch.ones(N_NODES, device=dev)
    launches_before = S.fused_scaling_iteration.launches
    kernel_ms = cuda_median_ms(lambda: S.fused_scaling_iteration(K, a, b, v), reps=20, batch=10)
    plain_ms = cuda_median_ms(lambda: S.fused_scaling_iteration_ref(K, a, b, v), reps=10, batch=3)
    v16, u16 = v.to(torch.bfloat16), u.to(torch.bfloat16)
    library_ms = cuda_median_ms(
        lambda: (torch.mv(K, v16), torch.mv(K.t(), u16)), reps=10, batch=10
    )
    del K

    # The step's stages, each timed alone on a real solve's state.
    def solve(K, a, b):
        v = torch.ones(N_NODES, device=dev)
        for _ in range(N_ITERS):
            _, v = S.fused_scaling_iteration(K, a, b, v)

    u, v, K, _ = S.fused_scaling_core(cost, mass, cap, eps=EPS, n_iters=N_ITERS)
    rounded = round_from_scaling(K, u, v, chunk=CHUNK)
    expected = cap / cap.sum() * N_OBJ
    stages_ms = {
        "build_K": cuda_median_ms(
            lambda: S.scaling_kernel(cost, mass, cap, eps=EPS, kernel_dtype=torch.bfloat16), reps=5
        ),
        "solve_30_iters": cuda_median_ms(lambda: solve(K, a, b), reps=5),
        "row_marginal_err": cuda_median_ms(lambda: row_marginal_err(K, u, v, mass, cap), reps=5),
        "rounding": cuda_median_ms(lambda: round_from_scaling(K, u, v, chunk=CHUNK), reps=5),
        "quota_repair": cuda_median_ms(lambda: exact_quota_repair(rounded, expected), reps=5),
    }
    del K, rounded
    step_ms = cuda_median_ms(
        lambda: placement_step(cost, mass, cap, eps=EPS, n_iters=N_ITERS, chunk=CHUNK, device=dev),
        reps=10, warmup=1,
    )
    check(S.fused_scaling_iteration.launches > launches_before, "timed the kernel")
    n, m = N_OBJ, N_NODES
    bytes_moved = n * m * 2 + 4 * (n + 2 * m) + 4 * (n + m)  # K, a, b, v in; u, v' out
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * n * m / F32_FLOPS_PER_S * 1e3  # two float32 multiply-adds per element of K
    bound_ms = max(bytes_ms, ops_ms)
    emit("times", **card, kernel_ms_per_iter=kernel_ms, bound_ms=bound_ms,
         plain_ms_per_iter=plain_ms, library_ms=library_ms, step_ms=step_ms,
         solve_kernel_ms=kernel_ms * N_ITERS, stages_ms=stages_ms, peak_bytes=peak,
         bound_share=bound_ms / kernel_ms)

    print(json.dumps({"kernels": [{
        "name": "fused_scaling_iteration",
        "route": "cuda",
        "source": "rio_tpu_torch/kernels/csrc/scaling_iteration.cu",
        "replaces": "rio_tpu/ops/scaling.py:235",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
