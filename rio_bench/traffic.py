"""Inputs and traffic from ``--seed``: one general generator for every cell.

Each draw takes a sub-seed made from the run's seed and a tag, so a seed
of any size gives the same inputs on every run, and the tags keep the
draws of one run apart.

* :func:`uniform_costs`: U[0, 1) float32 costs, the distribution of
  ``rio_tpu_torch.bench.tier_inputs``, drawn on the device by a
  ``torch.Generator`` in one call instead of on the host.
* :func:`normal`: standard normal features, the distribution of
  ``bench.hier_rate``'s ``obj_feat``/``node_feat``, on the device.
* :func:`rolling_restart`: the membership changes of a churn window,
  after ``bench._alive_pair`` (which nodes are down alternates between
  events) and ``bench.incremental_rate`` (each cycle's allocation batch
  replaces an earlier one, a steady-state turnover). Every seed gets the
  same sizes and the same alternation; only which node leaves differs.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the draw named by ``tags`` in the run of ``seed``."""
    text = "/".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1


def generator(seed: int, device, *tags) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *tags))
    return gen


def uniform_costs(seed: int, index: int, n: int, m: int, device) -> torch.Tensor:
    """The ``index``-th (n, m) float32 cost matrix of the run's pool."""
    gen = generator(seed, device, "cost", index)
    return torch.rand((n, m), generator=gen, dtype=torch.float32, device=device)


def normal(seed: int, shape, device, *tags) -> torch.Tensor:
    """Standard normal float32 of ``shape`` for the draw named by ``tags``."""
    gen = generator(seed, device, "normal", *tags)
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=device)


def rolling_restart(seed: int, n_nodes: int):
    """Endless membership changes: ``("leave", node)``, then ``("return", node)``.

    The nodes leave in an order drawn from the seed, one at a time, each
    returning before the next leaves, as in a rolling restart.
    """
    rng = np.random.default_rng(sub_seed(seed, "restart"))
    while True:
        for node in rng.permutation(n_nodes).tolist():
            yield "leave", node
            yield "return", node
