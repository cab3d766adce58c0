"""Hand-written CUDA kernels of the port, for Hopper (``sm_90a``).

``csrc/`` holds the sources; :mod:`.build` compiles them with ``nvcc`` at
first use and loads them with ``ctypes``. Nothing is built or loaded when
this package is imported. :mod:`.launch` owns the call into every kernel:
the table of sources and entry points, their binding, the device rule,
the stream, the error and the launch counts. Each kernel's wrapper (its
shape checks, outputs and argument order) and its plain PyTorch twin live
in the ops module that uses it
(``rio_tpu_torch.ops.scaling.fused_scaling_iteration``).
"""
