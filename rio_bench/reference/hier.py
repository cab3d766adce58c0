"""Plain reference of the chunked two-level (hierarchical) placement, and its judge.

What ``rio_tpu_torch.parallel.hierarchical.chunked_hierarchical_assign``
computes, written again in plain PyTorch and NumPy from its definition.
The objects are solved in equal chunks, each against ``1/chunks`` of every
node's capacity. In each chunk:

1. coarse: each object scores each group of ``S`` consecutive nodes by its
   best live member (``obj_feat @ node_feat``); the negated scores, scaled
   by their population standard deviation over live groups, are the cost
   of one (N x G) scaling solve, which is CDF-rounded and repaired to the
   groups' exact quotas;
2. fine: each group's objects (at most ``bucket`` of them, the rest padding)
   solve a (B x S) problem on ``-(feat @ node_feat)`` scaled by one standard
   deviation over every (G, B, S) entry; the plan is CDF-rounded and
   repaired to the nodes' exact shares of the group's objects, padding on
   a sentinel column.

The scaling solves keep K and the vectors fed to its products in
bfloat16, with the products in float32, as the configuration states.
``store="float8_e4m3fn"`` keeps K in fp8 instead (each row scaled so that
its largest entry, 1, maps to 448): the control.
"""

from __future__ import annotations

import numpy as np
import torch

from .flat import FP8_MAX, quotas, repair

_NEG_INF = float("-inf")
_VEC = torch.bfloat16  # what the products read of u and v


def _std(x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Population standard deviation of ``x`` (over ``mask``), two float32 passes."""
    if mask is None:
        return torch.sqrt(((x - x.mean()) ** 2).mean())
    count = mask.sum()
    mean = torch.where(mask, x, 0.0).sum() / count
    return torch.sqrt((torch.where(mask, x - mean, 0.0) ** 2).sum() / count)


def scaling_potentials(cost, mass, cap, *, eps: float, n_iters: int, store: str):
    """``(f, g)`` of a scaling-form solve of one or a batch of problems."""
    a = mass.float() / mass.float().sum(-1, keepdim=True).clamp_min(1e-30)
    b = cap.float() / cap.float().sum(-1, keepdim=True).clamp_min(1e-30)
    shift = cost.amin(dim=-1, keepdim=True)
    shift = torch.where(torch.isfinite(shift), shift, 0.0)
    k = torch.exp((cost - shift) / -eps)
    if store == "float8_e4m3fn":
        Kf = (k * FP8_MAX).to(torch.float8_e4m3fn).float() / FP8_MAX
    else:
        Kf = k.to(getattr(torch, store)).float()
    del k
    v = torch.ones_like(b)
    u = torch.zeros_like(a)
    for _ in range(n_iters):
        kv = (Kf @ v.to(_VEC).float().unsqueeze(-1)).squeeze(-1)
        u = torch.where(a > 0, a / kv.clamp_min(1e-30), 0.0)
        ktu = (u.to(_VEC).float().unsqueeze(-2) @ Kf).squeeze(-2)
        v = torch.where(b > 0, b / ktu.clamp_min(1e-30), 0.0)
    f = torch.where(u > 0, eps * torch.log(u.clamp_min(1e-30)), _NEG_INF)
    g = torch.where(v > 0, eps * torch.log(v.clamp_min(1e-30)), _NEG_INF)
    return torch.where(torch.isfinite(f), f + shift[..., 0], f), g


def cdf_round(cost, f, g, eps: float) -> torch.Tensor:
    """Each real row at its quantile of the plan's row; padding rows uniform over live columns."""
    real = torch.isfinite(f)
    logit = (f[..., :, None] + g[..., None, :] - cost) / eps
    pad_logit = torch.where(torch.isfinite(g), 0.0, _NEG_INF)
    logit = torch.where(real[..., :, None], logit, pad_logit[..., None, :])
    cum = torch.cumsum(torch.softmax(logit, dim=-1), dim=-1)
    realf = real.float()
    rank = torch.cumsum(realf, dim=-1) - 1.0
    q = torch.where(real, (rank + 0.5) / realf.sum(-1, keepdim=True).clamp_min(1.0), 0.5)
    return (cum < q[..., None]).sum(dim=-1).clamp(0, cost.shape[-1] - 1)


def _repair_rows(idx: torch.Tensor, expected: torch.Tensor) -> np.ndarray:
    """Exact-quota repair of each row of ``idx`` (P, n) to ``expected`` (P, m)."""
    idx_np, exp_np = idx.cpu().numpy().astype(np.int64), expected.cpu().numpy()
    out = np.empty_like(idx_np)
    m = exp_np.shape[1]
    for p in range(idx_np.shape[0]):
        counts = np.bincount(idx_np[p], minlength=m)
        out[p] = repair(idx_np[p], quotas(exp_np[p], counts, idx_np.shape[1]))
    return out


def assign_chunk(obj_feat, node_feat, cap, *, groups: int, eps: float, coarse_iters: int,
                 fine_iters: int, store: str) -> np.ndarray:
    """One chunk's assignment, (n,) int64 on the host; every node is alive."""
    dev = obj_feat.device
    n, d = obj_feat.shape
    m = node_feat.shape[1]
    s = m // groups
    bucket = -(-int(1.25 * n) // groups)
    bucket = -(-bucket // 8) * 8
    live = (cap > 0).reshape(groups, s)
    group_cap = cap.reshape(groups, s).sum(dim=1)

    # Coarse: every object against every group's best live member.
    aff = torch.empty((n, groups), dtype=torch.float32, device=dev)
    for g in range(groups):
        scores = obj_feat @ node_feat[:, g * s : (g + 1) * s]
        aff[:, g] = scores.masked_fill(~live[g], _NEG_INF).amax(dim=1)
    live_group = group_cap > 0
    raw = -aff
    std = _std(raw, live_group[None, :].expand_as(raw)).clamp_min(1e-6)
    coarse_cost = torch.where(live_group[None, :], raw / std, 1e6)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    f, g_pot = scaling_potentials(coarse_cost, ones, group_cap, eps=eps, n_iters=coarse_iters, store=store)
    rounded = cdf_round(coarse_cost, f, g_pot, eps)
    group = _repair_rows(rounded[None, :], (group_cap / group_cap.sum() * n)[None, :])[0]

    # Fine: each group's objects in a (bucket,) table, padding at index n.
    order = np.argsort(group, kind="stable")
    counts = np.bincount(group, minlength=groups)
    rank = np.arange(n) - (np.cumsum(counts) - counts)[group[order]]
    in_bucket = rank < bucket
    table = np.full(groups * bucket, n, np.int64)
    table[(group[order] * bucket + rank)[in_bucket]] = order[in_bucket]
    table = torch.from_numpy(table.reshape(groups, bucket)).to(dev)
    feat = torch.cat([obj_feat, obj_feat.new_zeros((1, d))])[table]  # (G, B, d)
    fine_cost = -torch.bmm(feat, node_feat.reshape(d, groups, s).permute(1, 0, 2))
    fine_cost = fine_cost / _std(fine_cost).clamp_min(1e-6)
    real = table < n
    cap_g = cap.reshape(groups, s)
    f, g_pot = scaling_potentials(fine_cost, real.float(), cap_g, eps=eps, n_iters=fine_iters, store=store)
    local = torch.where(real, cdf_round(fine_cost, f, g_pot, eps), s)
    n_real = real.float().sum(dim=-1, keepdim=True)
    expected = torch.cat([cap_g / cap_g.sum(-1, keepdim=True) * n_real, bucket - n_real], dim=-1)
    local = torch.from_numpy(_repair_rows(local, expected)).to(dev)
    best = cap_g.argmax(dim=1, keepdim=True)
    local = torch.where(real & (local >= s), best, local)  # real rows left on the sentinel
    seat = torch.arange(groups, device=dev)[:, None] * s + local.clamp_max(s - 1)

    out = np.empty(n, np.int64)
    table_np, seat_np = table.cpu().numpy().ravel(), seat.cpu().numpy().ravel()
    placed = table_np < n
    out[table_np[placed]] = seat_np[placed]
    missed = np.ones(n, bool)
    missed[table_np[placed]] = False
    out[missed] = group[missed] * s + best.cpu().numpy()[group[missed], 0]
    return out


def place(obj_feat, node_feat, cap, *, groups: int, chunks: int, eps: float, coarse_iters: int,
          fine_iters: int, store: str = "bfloat16") -> np.ndarray:
    """The reference's assignment of every object, (N,) int64 on the host."""
    if obj_feat.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    n = obj_feat.shape[0]
    rows = n // chunks
    parts = [
        assign_chunk(obj_feat[c * rows : (c + 1) * rows], node_feat, cap / chunks, groups=groups,
                     eps=eps, coarse_iters=coarse_iters, fine_iters=fine_iters, store=store)
        for c in range(chunks)
    ]
    return np.concatenate(parts)


def mean_score(obj_feat, node_feat, assignment: np.ndarray) -> float:
    """Mean affinity ``obj_feat[i] . node_feat[:, assignment[i]]`` in float64."""
    seats = torch.from_numpy(np.asarray(assignment, np.int64)).to(obj_feat.device)
    return float((obj_feat.double() * node_feat.double().t()[seats]).sum(dim=1).mean())


def judge(obj_feat, node_feat, groups: int, ref: np.ndarray, answer: np.ndarray, overflow: int) -> dict:
    """The numbers compared for one answer against the reference's assignment.

    ``seat_mismatch`` and ``group_mismatch``: the shares of objects on
    another node, and in another group, than the reference's;
    ``score_gap``: the relative gap of the mean affinity; ``load_gap``:
    the largest distance of a node's load from the reference's exact
    quota; ``overflow``: the objects the program reports past their bucket.
    """
    n, m = obj_feat.shape[0], node_feat.shape[1]
    answer = np.asarray(answer, np.int64)
    if answer.shape != (n,) or answer.min() < 0 or answer.max() >= m:
        return {"seat_mismatch": 1.0, "group_mismatch": 1.0, "score_gap": float("inf"),
                "load_gap": float(n), "overflow": float(max(overflow, 1))}
    s = m // groups
    ref_score = mean_score(obj_feat, node_feat, ref)
    return {
        "seat_mismatch": float(np.mean(answer != ref)),
        "group_mismatch": float(np.mean(answer // s != ref // s)),
        "score_gap": abs(mean_score(obj_feat, node_feat, answer) - ref_score) / abs(ref_score),
        "load_gap": float(np.abs(np.bincount(answer, minlength=m) - np.bincount(ref, minlength=m)).max()),
        "overflow": float(overflow),
    }
