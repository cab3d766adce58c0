"""Full flat placements back to back through ``rio_tpu_torch.entry.placement_step``.

A closed loop with one caller. Turn ``i`` places the ``i % pool``-th of a
pool of seeded cost matrices made on the device at set-up, rounding in
chunks of rows, and ends with the assignment on the host. The check works
every pool entry's step out again with the plain reference and judges
every answer of the window against it.
"""

from __future__ import annotations

import hashlib
import numpy as np
import torch

from rio_bench import traffic
from rio_bench.reference import flat as reference


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device) -> None:
        self.n, self.m = config["objects"], config["nodes"]
        self.solve = config["solve"]
        self.pool_size = mix["pool"]
        self.warm_steps = mix["warm_steps"]
        self.limits = mix["limits"]
        self.trace_turns = (mix["trace_from"], mix["trace_turns"])
        self.seed, self.device = seed, device
        self.program = None  # the entry driven; the program's by default
        self.paused_s = 0.0
        self.min_turns = 1
        self.answers: list[tuple[int, np.ndarray]] = []  # (pool entry, assignment)

    def setup(self) -> None:
        if self.program is None:
            from rio_tpu_torch.entry import placement_step

            self.program = placement_step
        self._pool = [
            traffic.uniform_costs(self.seed, k, self.n, self.m, self.device)
            for k in range(self.pool_size)
        ]
        self._mass = torch.ones(self.n, dtype=torch.float32, device=self.device)
        self._cap = torch.ones(self.m, dtype=torch.float32, device=self.device)
        for i in range(self.warm_steps):
            self._step(i % self.pool_size)

    def _step(self, k: int) -> np.ndarray:
        assignment, _, _ = self.program(
            self._pool[k], self._mass, self._cap, eps=self.solve["eps"],
            n_iters=self.solve["iterations"], kernel_dtype=getattr(torch, self.solve["kernel_dtype"]),
            chunk=self.solve["round_chunk_rows"], device=self.device,
        )
        return assignment.cpu().numpy()

    def turn(self, i: int) -> None:
        k = i % self.pool_size
        with torch.profiler.record_function("rio_bench.placement_step"):
            self.answers.append((k, self._step(k)))

    def end_to_end(self, window_s: float) -> dict:
        return {"placements_per_s": len(self.answers) * self.n / window_s}

    def counters(self) -> dict:
        return {
            "n": self.n, "m": self.m, "iterations": self.solve["iterations"],
            "k_bytes": torch.finfo(getattr(torch, self.solve["kernel_dtype"])).bits // 8,
        }

    def samples(self) -> dict:
        return {"placements": len(self.answers), "objects_each": self.n}

    def release(self) -> None:
        del self.program, self._pool, self._mass, self._cap

    def check(self) -> list[tuple[str, float, float]]:
        worst = dict.fromkeys(self.limits, 0.0)
        cap = torch.ones(self.m, dtype=torch.float32, device=self.device)
        for k in range(self.pool_size):
            answers = [a for kk, a in self.answers if kk == k]
            if not answers:
                continue
            cost = traffic.uniform_costs(self.seed, k, self.n, self.m, self.device)
            ref = reference.place(
                cost, cap, eps=self.solve["eps"], n_iters=self.solve["iterations"],
                chunk=self.solve["round_chunk_rows"], store=self.solve["kernel_dtype"],
            )
            judged = {}  # answers of one pool entry are mostly equal: judge each once
            for answer in answers:
                key = hashlib.blake2b(answer.tobytes(), digest_size=16).digest()
                if key not in judged:
                    judged[key] = reference.judge(cost, ref, answer)
                for name, value in judged[key].items():
                    worst[name] = max(worst[name], value)
            del cost
        return [(name, worst[name], limit) for name, limit in self.limits.items()]
