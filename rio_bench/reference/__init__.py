"""The plain reference: PyTorch and NumPy only, nothing of ``rio_tpu_torch``.

Each module works a cell's answers out again from the inputs the benchmark
made, and judges the program's answers against them.
"""
