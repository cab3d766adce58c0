"""What the benchmark's tests know of the ``place_flat`` driver: its control, its faults and its stages.

Found by the driver's name (``harness.Registry.driver_tests``); a cell of
another driver brings a file of its own beside this one.
"""

import torch

from rio_bench import control


def controls(config) -> dict:
    """The controls, by name, that take the place of ``placement_step``."""
    return {"fp8": control.flat_control}


def broken(fault, config):
    """``placement_step`` with ``fault``: ``unchanged``, ``half`` or ``altered``."""
    from rio_tpu_torch.entry import placement_step

    previous = []

    def step(cost, mass, cap, **kw):
        if fault == "half":
            n = cost.shape[0] // 2
            seats, mean_cost, err = placement_step(cost[:n].contiguous(), mass[:n], cap, **kw)
            return torch.cat([seats, torch.zeros_like(seats)]), mean_cost, err
        seats, mean_cost, err = placement_step(cost, mass, cap, **kw)
        if fault == "unchanged":  # answers with the previous call's state
            previous.append(seats)
            seats = previous[-2] if len(previous) > 1 else seats
        elif fault == "altered":
            seats = seats.clone()
            seats[0] = (seats[0] + 1) % cap.shape[0]
        return seats, mean_cost, err

    return step


# The prefix of the driver's stage metrics, and the four stages every cell of it reports.
stages = ("flat_stage_ms.", ("k_build", "row_check", "round", "repair"))
