"""Hand-written CUDA kernels of the port, for Hopper (``sm_90a``).

``csrc/`` holds the sources; :mod:`.build` compiles them with ``nvcc`` at
first use and loads them with ``ctypes``. Nothing is built or loaded when
this package is imported. Each kernel's wrapper, plain PyTorch twin and
launch count live in the ops module that uses it
(``rio_tpu_torch.ops.scaling.fused_scaling_iteration``).
"""
