"""The controls that take the place of the entry each driver drives: ``correct`` has to come out false.

Each driver's test file, ``rio_bench/tests/drivers/<driver>.py``, names
its controls (``controls(config)``), found by the driver's name:

* ``place_flat`` and ``place_hier``: ``fp8``, the plain reference with K
  stored in fp8 (e4m3, rows scaled to 448), one precision below the
  bfloat16 the configuration states (:func:`flat_control`,
  :func:`hier_control`);
* ``directory_churn``, whose integer answers state no precision: two plain
  directories (:class:`~rio_bench.reference.directory.PlainDirectory`),
  each breaking one guarantee the configuration states: ``keep_all``
  the integer quotas, ``reshuffle`` the bound on a full rebalance's moves.

``rio_bench/tests/test_controls.py`` runs them at CPU sizes, and on a card
at each cell's own size (``python3 -m pytest rio_bench/tests/test_controls.py
-m card -s``, which prints each run's numbers beside their limits).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from rio_bench.reference import flat, hier

FP8 = "float8_e4m3fn"


def flat_control(cost, mass, cap, *, eps, n_iters, kernel_dtype, chunk, device):
    """``placement_step``'s answer worked out by the reference with K in fp8."""
    seats = flat.place(cost, cap, eps=eps, n_iters=n_iters, chunk=chunk, store=FP8)
    return torch.from_numpy(seats.astype(np.int32)), None, None


def hier_control(obj_feat, node_feat, cap, alive, *, n_groups, n_chunks, eps, coarse_iters, fine_iters):
    """``chunked_hierarchical_assign``'s answer worked out by the reference with K in fp8."""
    seats = hier.place(obj_feat, node_feat, cap * alive, groups=n_groups, chunks=n_chunks, eps=eps,
                       coarse_iters=coarse_iters, fine_iters=fine_iters, store=FP8)
    return SimpleNamespace(assignment=torch.from_numpy(seats.astype(np.int32)), overflow=0)

