"""What the benchmark's tests know of the ``place_logdomain`` driver: its control, its faults and its stages.

Found by the driver's name (``harness.Registry.driver_tests``).
"""

import numpy as np
import torch

from rio_bench.reference import flat_logdomain


def bf16_control(cost, mass, cap, *, eps, n_iters, chunk, device):
    """``logdomain_placement_step``'s answer worked out by the reference with the cost stored in bfloat16."""
    seats = flat_logdomain.place(cost, cap, eps=eps, n_iters=n_iters, chunk=chunk, store="bfloat16")
    return torch.from_numpy(seats.astype(np.int32)), None, None


def controls(config) -> dict:
    """The control, by name, that takes the place of ``logdomain_placement_step``: ``bf16``, one
    precision below the float32 the step states."""
    return {"bf16": bf16_control}


def broken(fault, config):
    """``logdomain_placement_step`` with ``fault``: ``unchanged``, ``half`` or ``altered``."""
    from rio_tpu_torch.entry import logdomain_placement_step

    previous = []

    def step(cost, mass, cap, **kw):
        if fault == "half":
            n = cost.shape[0] // 2
            seats, mean_cost, err = logdomain_placement_step(cost[:n].contiguous(), mass[:n], cap, **kw)
            return torch.cat([seats, torch.zeros_like(seats)]), mean_cost, err
        seats, mean_cost, err = logdomain_placement_step(cost, mass, cap, **kw)
        if fault == "unchanged":  # answers with the previous call's state
            previous.append(seats)
            seats = previous[-2] if len(previous) > 1 else seats
        elif fault == "altered":
            seats = seats.clone()
            seats[0] = (seats[0] + 1) % cap.shape[0]
        return seats, mean_cost, err

    return step


# The prefix of the driver's stage metrics, and the four stages every cell of it reports.
stages = ("logdomain_stage_ms.", ("iterations", "err", "round", "repair"))
