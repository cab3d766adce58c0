"""Full two-level solves back to back through
``rio_tpu_torch.parallel.hierarchical.chunked_hierarchical_assign``.

A closed loop with one caller. Turn ``i`` seats every object of the
``i % pool``-th of a pool of seeded feature sets made on the device at
set-up, all nodes alive, and ends with the assignment on the host. The
check works every pool entry's solve out again with the plain reference
and judges every answer of the window against it.
"""

from __future__ import annotations

import hashlib
import numpy as np
import torch

from rio_bench import traffic
from rio_bench.reference import hier as reference


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device) -> None:
        self.n, self.m = config["objects"], config["nodes"]
        self.d = config["feature_dim"]
        self.solve = config["solve"]
        self.pool_size = mix["pool"]
        self.warm_steps = mix["warm_steps"]
        self.limits = mix["limits"]
        self.trace_turns = (mix["trace_from"], mix["trace_turns"])
        self.seed, self.device = seed, device
        self.program = None  # the entry driven; the program's by default
        self.paused_s = 0.0
        self.min_turns = 1
        self.answers: list[tuple[int, np.ndarray, int]] = []  # (pool entry, assignment, overflow)

    def _features(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        return (
            traffic.normal(self.seed, (self.n, self.d), self.device, "objects", k),
            traffic.normal(self.seed, (self.d, self.m), self.device, "nodes", k),
        )

    def setup(self) -> None:
        if self.program is None:
            from rio_tpu_torch.parallel.hierarchical import chunked_hierarchical_assign

            self.program = chunked_hierarchical_assign
        self._pool = [self._features(k) for k in range(self.pool_size)]
        self._cap = torch.ones(self.m, dtype=torch.float32, device=self.device)
        self._alive = torch.ones(self.m, dtype=torch.float32, device=self.device)
        for i in range(self.warm_steps):
            self._solve(i % self.pool_size)

    def _solve(self, k: int) -> tuple[np.ndarray, int]:
        obj_feat, node_feat = self._pool[k]
        res = self.program(
            obj_feat, node_feat, self._cap, self._alive, n_groups=self.solve["groups"],
            n_chunks=self.n // self.solve["chunk_rows"], eps=self.solve["eps"],
            coarse_iters=self.solve["coarse_iterations"], fine_iters=self.solve["fine_iterations"],
        )
        return res.assignment.cpu().numpy(), int(res.overflow)

    def turn(self, i: int) -> None:
        k = i % self.pool_size
        with torch.profiler.record_function("rio_bench.hierarchical_assign"):
            self.answers.append((k, *self._solve(k)))

    def end_to_end(self, window_s: float) -> dict:
        return {"placements_per_s.hier": len(self.answers) * self.n / window_s}

    def counters(self) -> dict:
        return {"n": self.n, "m": self.m}

    def samples(self) -> dict:
        return {"placements": len(self.answers), "objects_each": self.n}

    def release(self) -> None:
        del self.program, self._pool, self._cap, self._alive

    def check(self) -> list[tuple[str, float, float]]:
        worst = dict.fromkeys(self.limits, 0.0)
        cap = torch.ones(self.m, dtype=torch.float32, device=self.device)
        for k in range(self.pool_size):
            answers = [(a, o) for kk, a, o in self.answers if kk == k]
            if not answers:
                continue
            obj_feat, node_feat = self._features(k)
            ref = reference.place(
                obj_feat, node_feat, cap, groups=self.solve["groups"],
                chunks=self.n // self.solve["chunk_rows"], eps=self.solve["eps"],
                coarse_iters=self.solve["coarse_iterations"],
                fine_iters=self.solve["fine_iterations"], store=self.solve["kernel_dtype"],
            )
            judged = {}  # answers of one pool entry are mostly equal: judge each once
            for answer, overflow in answers:
                key = (hashlib.blake2b(answer.tobytes(), digest_size=16).digest(), overflow)
                if key not in judged:
                    judged[key] = reference.judge(
                        obj_feat, node_feat, self.solve["groups"], ref, answer, overflow
                    )
                for name, value in judged[key].items():
                    worst[name] = max(worst[name], value)
            del obj_feat, node_feat
        return [(name, worst[name], limit) for name, limit in self.limits.items()]
