#!/usr/bin/env python3
"""Run the PyTorch port's placement steps on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device``  — the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. ``build``   — compiles every CUDA source of ``rio_tpu_torch/kernels/csrc`` with nvcc
   (one process per source, all at once) and prints each kernel's ``ptxas`` line;
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
7. ``logdomain_ragged`` — the fused log-domain iteration kernel against its plain
   twin, one iteration, on small ragged shapes: m = 130, 96, 40, 2600 and 1100 (column
   tiles), fewer rows than one CTA's warps, a cost base that is not 16-byte aligned,
   zero-mass rows, dead columns (some with g = -inf on input), every column dead, and
   a whole CTA's rows at zero mass; |d| <= 1e-4 + 1e-4 |ref|, identical -inf patterns;
8. ``logdomain_full_width`` — the same at 1,048,576 x 1024 float32 on the main path's
   cost matrix;
9. ``logdomain_path`` — ``logdomain_placement_step`` at 1,048,576 x 1024 (eps 0.05,
   30 iterations, rounding in 65,536-row chunks) on the same problem: the kernel
   launched 30 times, every node at its quota of 1,024, mean cost < 0.25; it prints
   the largest |g| difference to the main path's scaling solve (not bounded);
10. ``logdomain_vs_plain`` — at 262,144 x 1024, 30 iterations: the kernel path against
   the plain twin's path and the unfused ``sinkhorn``, |d| <= 1e-3 + 1e-3 |ref| on f
   and g, assignments at quota, rows agreeing >= 99%;
11. ``times`` — CUDA-event medians: each kernel, its plain twin and one library
   yardstick that the port never calls (``torch.mv`` twice for the scaling kernel;
   two ``torch.logsumexp`` sweeps for the log-domain kernel), each over batches of
   calls; each step and its stages.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``. Any failed
check raises, so the script exits non-zero and prints no result. Without a CUDA
device it exits 1 at once.

Float32 sums are taken in another order on the card than in the plain twins
(a per-CTA split of the column sums, a shuffle tree for each row), and the
log-domain kernel multiplies by log2(e)/eps where the twin divides by eps and
takes approximate base-2 exponentials: that is what the tolerances absorb.
Neither kernel uses atomics.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, NVIDIA data sheet
EXP_PER_CLOCK_PER_SM = 16  # Hopper SM: 16 special-function results (ex2) per clock

N_OBJ, N_NODES, CHUNK, N_ITERS, EPS = 1 << 20, 1024, 65536, 30, 0.05
PLAIN_N_OBJ = 262144
RTOL_KERNEL = 1e-4
RTOL_STEP = 1e-3
# Log-domain kernel against its twin: |d| <= TOL (1 + |ref|) after one iteration,
# TOL_STEP (1 + |ref|) after 30.
TOL_LOGDOMAIN = 1e-4
TOL_LOGDOMAIN_STEP = 1e-3


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


def max_abs_close(got, want, tol: float, what: str) -> float:
    """Identical -inf patterns and |got - want| <= tol (1 + |want|) elsewhere; max |d|."""
    import torch

    check(bool((torch.isneginf(got) == torch.isneginf(want)).all()), f"{what}: -inf pattern differs")
    live = ~torch.isneginf(want)
    check(bool(torch.isfinite(got[live]).all()), f"{what}: non-finite where the twin is finite")
    if not bool(live.any()):
        return 0.0
    diff = (got[live] - want[live]).abs()
    check(bool((diff <= tol * (1.0 + want[live].abs())).all()), f"{what}: max |d| {float(diff.max())}")
    return float(diff.max())


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
        logdomain_placement_step,
        make_problem,
        placement_step,
        repair_to_quota,
        round_and_repair,
        round_from_potentials,
        round_from_scaling,
        row_marginal_err,
    )
    from rio_tpu_torch.kernels import build
    from rio_tpu_torch.ops import scaling as S
    from rio_tpu_torch.ops.pallas_sinkhorn import fused_iteration, fused_iteration_ref, pallas_sinkhorn
    from rio_tpu_torch.ops.sinkhorn import (
        exact_quota_repair,
        log_marginals,
        marginal_err,
        normalize_marginals,
        sinkhorn,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    card = {"card": smi, "kind": torch.cuda.get_device_name(0)}
    emit("device", **card, torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count(), sm_max_mhz=sm_mhz, sms=sms)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    ptxas = []  # "<kernel>: <registers line>", and any line that reports a spill
    for log in logs.values():
        kernel = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "registers" in line or re.search(r"[1-9]\d* bytes spill", line):
                ptxas.append(f"{kernel}: {line.strip()}")
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

    # -- 7. log-domain kernel on ragged shapes: kernel vs plain twin ---------
    neg_inf = float("-inf")
    ragged = []
    for n, m, offset, case in [
        (1000, 130, 0, "scalar loads"),          # 130*4 bytes is not a multiple of 16
        (300, 96, 0, "one 16-byte load a lane"),
        (5, 40, 0, "fewer rows than one CTA's warps"),
        (777, 1024, 0, "one full column tile"),
        (513, 2600, 0, "three column tiles"),
        (257, 1024, 3, "cost base not 16-byte aligned"),
        (200, 1100, 1, "misaligned, two column tiles"),
        (100, 96, 0, "every column dead"),
        (24, 128, 0, "a whole CTA's rows at zero mass"),  # 3 CTAs of 8 rows: CTA 1 is dead
    ]:
        c_r = torch.empty(n * m + offset, device=dev)[offset:].view(n, m)
        c_r.copy_(torch.rand((n, m), generator=gen, device=dev))
        mass_r = torch.rand(n, generator=gen, device=dev) + 0.1
        mass_r[::7] = 0.0
        cap_r = torch.rand(m, generator=gen, device=dev) + 0.5
        cap_r[::11] = 0.0
        g_r = torch.randn(m, generator=gen, device=dev) * 0.05
        g_r[::22] = neg_inf  # dead columns of an earlier iteration
        if case == "every column dead":
            cap_r.zero_()
            g_r.fill_(neg_inf)
        if case == "a whole CTA's rows at zero mass":
            mass_r[8:16] = 0.0
        la_r, lb_r = log_marginals(*normalize_marginals(mass_r, cap_r))
        f_k, g_k = fused_iteration(c_r, la_r, lb_r, g_r, EPS)
        torch.cuda.synchronize()
        f_p, g_p = fused_iteration_ref(c_r, la_r, lb_r, g_r, EPS)
        ef = max_abs_close(f_k, f_p, TOL_LOGDOMAIN, f"logdomain {n}x{m} ({case}) f")
        eg = max_abs_close(g_k, g_p, TOL_LOGDOMAIN, f"logdomain {n}x{m} ({case}) g")
        if case == "every column dead":
            check(bool(torch.isfinite(f_k[mass_r > 0]).all()), "every column dead: f must be finite")
        ragged.append({"n": n, "m": m, "offset": offset, "case": case, "f_max_abs": ef,
                       "g_max_abs": eg})
    emit("logdomain_ragged", tol=TOL_LOGDOMAIN, cases=ragged)

    # -- 8. log-domain kernel at full width: kernel vs plain twin ------------
    log_a, log_b = log_marginals(*normalize_marginals(mass, cap))
    g_in = torch.randn(N_NODES, generator=gen, device=dev) * 0.05
    f_k, g_k = fused_iteration(cost, log_a, log_b, g_in, EPS)
    torch.cuda.synchronize()
    f_p, g_p = fused_iteration_ref(cost, log_a, log_b, g_in, EPS)
    ef = max_abs_close(f_k, f_p, TOL_LOGDOMAIN, "logdomain full width f")
    eg = max_abs_close(g_k, g_p, TOL_LOGDOMAIN, "logdomain full width g")
    ld_max_abs = max(ef, eg)
    emit("logdomain_full_width", n=N_OBJ, m=N_NODES, tol=TOL_LOGDOMAIN, f_max_abs=ef, g_max_abs=eg)
    del f_k, g_k, f_p, g_p

    # -- 9. the log-domain path ------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    S.fused_scaling_iteration.launches = 0
    fused_iteration.launches = 0
    t0 = time.perf_counter()
    ld_assignment, ld_mean_cost, ld_err = logdomain_placement_step(
        cost, mass, cap, eps=EPS, n_iters=N_ITERS, chunk=CHUNK, device=dev,
    )
    torch.cuda.synchronize()
    ld_step_s = time.perf_counter() - t0
    ld_launches = fused_iteration.launches
    ld_peak = torch.cuda.max_memory_allocated()
    check(ld_launches == N_ITERS, f"log-domain kernel launched {ld_launches} times, want {N_ITERS}")
    check(S.fused_scaling_iteration.launches == 0, "the log-domain path launched the scaling kernel")
    check(ld_assignment.shape == (N_OBJ,), "log-domain assignment shape")
    loads = torch.bincount(ld_assignment.long(), minlength=N_NODES)
    check(loads.shape == (N_NODES,) and bool((loads == quota).all()),
          f"log-domain node loads {int(loads.min())}..{int(loads.max())}")
    ld_mean_cost, ld_err = float(ld_mean_cost), float(ld_err)
    check(ld_mean_cost < 0.25, f"log-domain mean assigned cost {ld_mean_cost} (random: 0.50)")
    check(ld_err == ld_err and ld_err < 1e-2, f"log-domain column-marginal error {ld_err}")
    # The same problem through the main path's scaling solve: tpu_pallas_check's
    # max_dg_vs_xla, printed and not bounded (bf16 K on the scaling side).
    ld_res = pallas_sinkhorn(cost, mass, cap, eps=EPS, n_iters=N_ITERS)
    sc_res = S.fused_scaling_sinkhorn(
        cost, mass, cap, eps=EPS, n_iters=N_ITERS, kernel_dtype=torch.bfloat16
    )
    live = torch.isfinite(ld_res.g) & torch.isfinite(sc_res.g)
    max_dg = float((ld_res.g[live] - sc_res.g[live]).abs().max())
    emit("logdomain_path", n=N_OBJ, m=N_NODES, chunk=CHUNK, n_iters=N_ITERS, launches=ld_launches,
         quota=quota, mean_cost=ld_mean_cost, col_marginal_err=ld_err, first_step_s=ld_step_s,
         peak_bytes=ld_peak, max_dg_vs_scaling=max_dg)
    del ld_assignment, loads, sc_res

    # -- 10. log-domain path: kernel vs plain twin vs unfused sinkhorn --------
    pc, pm, pcap = make_problem(PLAIN_N_OBJ, N_NODES, seed=1, device=dev)
    res_k = pallas_sinkhorn(pc, pm, pcap, eps=EPS, n_iters=N_ITERS)
    pla, plb = log_marginals(*normalize_marginals(pm, pcap))
    f_p, g_p = torch.zeros_like(pla), torch.zeros_like(plb)
    for _ in range(N_ITERS):
        f_p, g_p = fused_iteration_ref(pc, pla, plb, g_p, EPS)
    res_u = sinkhorn(pc, pm, pcap, eps=EPS, n_iters=N_ITERS)
    pquota = PLAIN_N_OBJ // N_NODES
    vs = {}
    asg_k, cost_k = repair_to_quota(round_from_potentials(pc, res_k.f, res_k.g, EPS, chunk=CHUNK), pc, pcap)
    for name, f_r, g_r in (("twin", f_p, g_p), ("unfused", res_u.f, res_u.g)):
        ef = max_abs_close(res_k.f, f_r, TOL_LOGDOMAIN_STEP, f"30 iterations vs {name}: f")
        eg = max_abs_close(res_k.g, g_r, TOL_LOGDOMAIN_STEP, f"30 iterations vs {name}: g")
        asg_r, cost_r = repair_to_quota(round_from_potentials(pc, f_r, g_r, EPS, chunk=CHUNK), pc, pcap)
        for asg in (asg_k, asg_r):
            check(bool((torch.bincount(asg.long(), minlength=N_NODES) == pquota).all()), "quota")
        agree = float((asg_k == asg_r).float().mean())
        check(agree >= 0.99, f"row agreement with {name} {agree}")
        vs[name] = {"f_max_abs": ef, "g_max_abs": eg, "row_agreement": agree,
                    "mean_cost": float(cost_r)}
    emit("logdomain_vs_plain", n=PLAIN_N_OBJ, m=N_NODES, tol=TOL_LOGDOMAIN_STEP,
         mean_cost_kernel=float(cost_k), **vs)
    del pc, pm, pcap, res_k, res_u, f_p, g_p, asg_k, asg_r

    # -- 11. times at full width --------------------------------------------
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

    # The log-domain kernel, its twin and the two-sweep library form (what the
    # unfused sinkhorn runs; the port never calls it), on a converged g.
    f_ld, g_ld = ld_res.f, ld_res.g
    launches_before = fused_iteration.launches
    ld_kernel_ms = cuda_median_ms(
        lambda: fused_iteration(cost, log_a, log_b, g_ld, EPS), reps=20, batch=10
    )
    ld_plain_ms = cuda_median_ms(
        lambda: fused_iteration_ref(cost, log_a, log_b, g_ld, EPS), reps=5, batch=2
    )

    def two_sweeps():
        f = EPS * (log_a - torch.logsumexp((g_ld[None, :] - cost) / EPS, 1))
        return torch.logsumexp((f[:, None] - cost) / EPS, 0)

    ld_library_ms = cuda_median_ms(two_sweeps, reps=5, batch=2)

    def ld_solve():
        g = torch.zeros(N_NODES, device=dev)
        for _ in range(N_ITERS):
            _, g = fused_iteration(cost, log_a, log_b, g, EPS)

    ld_rounded = round_from_potentials(cost, f_ld, g_ld, EPS, chunk=CHUNK)
    _, b_unit = normalize_marginals(mass, cap)
    ld_stages_ms = {
        "solve_30_iters": cuda_median_ms(ld_solve, reps=5),
        "rounding": cuda_median_ms(
            lambda: round_from_potentials(cost, f_ld, g_ld, EPS, chunk=CHUNK), reps=5
        ),
        "quota_repair": cuda_median_ms(lambda: exact_quota_repair(ld_rounded, expected), reps=5),
        "col_marginal_err": cuda_median_ms(
            lambda: marginal_err(cost, f_ld, g_ld, b_unit, EPS), reps=5
        ),
    }
    del ld_rounded
    ld_step_ms = cuda_median_ms(
        lambda: logdomain_placement_step(
            cost, mass, cap, eps=EPS, n_iters=N_ITERS, chunk=CHUNK, device=dev
        ),
        reps=5, warmup=1,
    )
    check(fused_iteration.launches > launches_before, "timed the log-domain kernel")
    # Cost read once, log_a, log_b, g in; f, g' out. Two exponentials per element
    # at the SM's special-function rate and its highest clock.
    ld_bytes = 4 * n * m + 4 * (n + 2 * m) + 4 * (n + m)
    ld_bytes_ms = ld_bytes / HBM_BYTES_PER_S * 1e3
    ld_exp_ms = 2 * n * m / (EXP_PER_CLOCK_PER_SM * sms * sm_mhz * 1e6) * 1e3
    ld_bound_ms = max(ld_bytes_ms, ld_exp_ms)

    emit("times", **card, kernel_ms_per_iter=kernel_ms, bound_ms=bound_ms,
         plain_ms_per_iter=plain_ms, library_ms=library_ms, step_ms=step_ms,
         solve_kernel_ms=kernel_ms * N_ITERS, stages_ms=stages_ms, peak_bytes=peak,
         bound_share=bound_ms / kernel_ms,
         logdomain={
             "kernel_ms_per_iter": ld_kernel_ms, "plain_ms_per_iter": ld_plain_ms,
             "library_ms": ld_library_ms, "bytes": ld_bytes, "bytes_ms": ld_bytes_ms,
             "exps": 2 * n * m, "exp_ms": ld_exp_ms, "sm_max_mhz": sm_mhz, "sms": sms,
             "bound_ms": ld_bound_ms, "bound_share": ld_bound_ms / ld_kernel_ms,
             "step_ms": ld_step_ms, "stages_ms": ld_stages_ms, "peak_bytes": ld_peak,
         })

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
    }, {
        "name": "fused_iteration",
        "route": "cuda",
        "source": "rio_tpu_torch/kernels/csrc/logdomain_iteration.cu",
        "replaces": "rio_tpu/ops/pallas_sinkhorn.py:99",
        "launches": ld_launches,
        "max_abs_err": ld_max_abs,
        "ms": ld_kernel_ms,
        "plain_ms": ld_plain_ms,
        "bound_ms": ld_bound_ms,
        "bound_by": "bytes" if ld_bytes_ms >= ld_exp_ms else "operations",
        "library_ms": ld_library_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
