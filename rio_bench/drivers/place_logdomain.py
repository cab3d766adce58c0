"""Full log-domain placements back to back through ``rio_tpu_torch.entry.logdomain_placement_step``.

The loop of :mod:`place_flat`: one caller, turn ``i`` places the ``i % pool``-th
of a pool of seeded float32 costs made on the device at set-up, rounding in
chunks of rows, and ends with the assignment on the host. The log-domain step
reads the float32 cost itself and builds no K, so the configuration's
``kernel_dtype`` is not read. The check works every pool entry's step out
again with the plain float32 reference (``reference/flat_logdomain.py``) and
judges each distinct answer of the window against it once.
"""

from __future__ import annotations

import hashlib

import torch

from rio_bench import traffic
from rio_bench.drivers import place_flat
from rio_bench.reference import flat_logdomain as reference


class Driver(place_flat.Driver):
    def setup(self) -> None:
        if self.program is None:
            from rio_tpu_torch.entry import logdomain_placement_step

            self.program = logdomain_placement_step
        super().setup()

    def _step(self, k: int):
        assignment, _, _ = self.program(
            self._pool[k], self._mass, self._cap, eps=self.solve["eps"],
            n_iters=self.solve["iterations"], chunk=self.solve["round_chunk_rows"], device=self.device,
        )
        return assignment.cpu().numpy()

    def counters(self) -> dict:
        return {"n": self.n, "m": self.m, "iterations": self.solve["iterations"]}

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
                chunk=self.solve["round_chunk_rows"],
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
