"""rio-tpu's placement solver in PyTorch, with hand-written CUDA kernels.

A port of the solver stack of :mod:`rio_tpu` (JAX) to PyTorch on an NVIDIA
Hopper GPU. Modules mirror the JAX package's layout so that each function
has an obvious counterpart:

* :mod:`rio_tpu_torch.ops` — ``rio_tpu/ops`` (Sinkhorn, scaling form,
  rounding, quota repair, cost construction);
* :mod:`rio_tpu_torch.kernels` — the CUDA sources and their build;
* :mod:`rio_tpu_torch.entry` — the placement step that
  ``__graft_entry__.entry`` and ``bench.py``'s solve tier run;
* :mod:`rio_tpu_torch.convert` — JAX-side numpy arrays to the port's tensors.

The package imports neither ``jax`` nor any module of ``rio_tpu``.
Entry points run on CUDA unless the caller passes ``device="cpu"``
(:func:`rio_tpu_torch.device.resolve_device`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
