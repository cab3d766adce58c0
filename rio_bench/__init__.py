"""The benchmark of ``rio_tpu_torch``, the PyTorch and CUDA port, on an NVIDIA H100.

Run one cell as ``python3 -m rio_bench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository's root (``BENCHMARK.json``
lists the cells). Nothing here imports ``jax`` or ``rio_tpu``; the
reference under ``reference/`` imports nothing of ``rio_tpu_torch`` either.
"""
