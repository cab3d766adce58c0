"""What the benchmark's tests know of the ``place_hier`` driver: its control, its faults and its stages.

Found by the driver's name (``harness.Registry.driver_tests``).
"""

from types import SimpleNamespace

import torch

from rio_bench import control


def controls(config) -> dict:
    """The controls, by name, that take the place of ``chunked_hierarchical_assign``."""
    return {"fp8": control.hier_control}


def broken(fault, config):
    """``chunked_hierarchical_assign`` with ``fault``: ``unchanged``, ``half`` or ``altered``."""
    from rio_tpu_torch.parallel.hierarchical import chunked_hierarchical_assign

    previous = []

    def solve(obj_feat, node_feat, cap, alive, *, n_chunks, **kw):
        if fault == "half":
            n = obj_feat.shape[0] // 2
            res = chunked_hierarchical_assign(obj_feat[:n], node_feat, cap, alive, n_chunks=n_chunks // 2, **kw)
            seats = torch.cat([res.assignment, torch.zeros_like(res.assignment)])
            return SimpleNamespace(assignment=seats, overflow=res.overflow)
        res = chunked_hierarchical_assign(obj_feat, node_feat, cap, alive, n_chunks=n_chunks, **kw)
        seats = res.assignment
        if fault == "unchanged":  # answers with the previous call's state
            previous.append(seats)
            seats = previous[-2] if len(previous) > 1 else seats
        elif fault == "altered":
            seats = seats.clone()
            seats[0] = (seats[0] + 1) % cap.shape[0]
        return SimpleNamespace(assignment=seats, overflow=res.overflow)

    return solve


# The prefix of the driver's stage metrics, and the four stages every cell of it reports.
stages = ("hier_stage_ms.", ("coarse", "bucket", "fine", "map_back"))
