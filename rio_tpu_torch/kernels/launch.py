"""How the port calls a hand-written CUDA kernel: one table and one launch path for all of them.

:data:`KERNELS` has one entry per ``csrc/<stem>.cu``: the name of the ops
wrapper that calls it, its C entry points (``<stem>_launch``;
``<stem>_parts`` where the launch needs a workspace of that many rows;
``<stem>_finalize`` where a second, separate launch reduces that
workspace) with their ``ctypes`` signatures, the name its errors give, and whether a
call with no rows counts as a launch. :data:`~rio_tpu_torch.kernels.build.SOURCES`
is read from it.

A wrapper checks its arguments (:func:`check_operands` for the float32
vectors), asks :func:`impl_for` whether to run its plain twin or the
kernel, and for the kernel allocates its outputs and calls :func:`launch`
(after :func:`parts` where it needs a workspace; a finalize wrapper
calls :func:`finalize`). The entry points are bound at first use, once,
under the build's lock. :func:`launches` reads the launch counts by
wrapper name, :func:`reset_launches` zeroes them.
"""

from __future__ import annotations

import ctypes

import torch

# The dtype codes the kernels take for K.
K_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_OUT_INT = ctypes.POINTER(ctypes.c_int)


class Kernel:
    """One ``csrc/<stem>.cu``: its entry points' argument types and how its calls count.

    ``launch``, ``parts`` and ``finalize`` are the argument types of
    ``<stem>_launch`` (its last one the stream), ``<stem>_parts`` (its
    last one the int it writes) and ``<stem>_finalize`` (its last one the
    stream); each returns a CUDA error code.
    """

    def __init__(self, name, stem, what, launch, parts=None, finalize=None, *, count_empty=False):
        self.name, self.stem, self.what, self.count_empty = name, stem, what, count_empty
        self.signatures = {f"{stem}_launch": launch}
        if parts is not None:
            self.signatures[f"{stem}_parts"] = parts
        if finalize is not None:
            self.signatures[f"{stem}_finalize"] = finalize
        # The names its launches are counted under: its own, and its finalize's.
        self.counted = (name,) if finalize is None else (name, f"{name}_finalize")
        self.entry_points = None  # {"launch": ..., "parts": ..., "finalize": ...}, bound at first use

    def bind(self, lib: ctypes.CDLL) -> None:
        """Declare the entry points' signatures on the library just loaded."""
        for fn_name, argtypes in self.signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int

    def bound(self) -> dict:
        """The entry points by suffix (``launch``, ``parts``, ``finalize``), the library loaded at first use."""
        if self.entry_points is None:
            from .build import load

            lib = load(self.stem)
            suffix = len(self.stem) + 1
            self.entry_points = {fn_name[suffix:]: getattr(lib, fn_name) for fn_name in self.signatures}
        return self.entry_points


KERNELS = {k.name: k for k in (
    Kernel("fused_scaling_iteration", "scaling_iteration", "scaling iteration kernel",
           launch=(_I, _P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _P),
           parts=(_I, _P, _L, _L, _OUT_INT), count_empty=True),
    Kernel("fused_iteration", "logdomain_iteration", "log-domain iteration kernel",
           launch=(_P, _P, _P, _P, _P, _P, _P, _I, _F, _L, _L, _P),
           parts=(_P, _L, _L, _OUT_INT), count_empty=True),
    Kernel("cdf_round", "cdf_round", "CDF rounding kernel",
           launch=(_I, _P, _P, _P, _P, _P, _P, _P, _L, _L, _P)),
    Kernel("kbuild", "kbuild", "K-build kernel", launch=(_I, _P, _P, _P, _L, _L, _F, _P)),
    Kernel("coarse_scores", "coarse_score", "coarse-score kernel",
           launch=(_P, _P, _P, _P, _L, _L, _L, _L, _P)),
    Kernel("potential_round", "potential_round", "potential-rounding kernel",
           launch=(_P, _P, _P, _P, _P, _L, _L, _L, _F, _P)),
    Kernel("logdomain_post", "logdomain_post", "log-domain post-solve kernel",
           launch=(_P, _P, _P, _P, _P, _P, _I, _F, _L, _L, _P), parts=(_P, _L, _L, _OUT_INT),
           finalize=(_P, _I, _P, _P, _L, _P), count_empty=True),
)}

_launches = dict.fromkeys((name for k in KERNELS.values() for name in k.counted), 0)


def impl_for(x: torch.Tensor) -> str:
    """``"eager"`` for a CPU tensor (the plain twin), ``"kernel"`` for a CUDA one; raises else."""
    if x.device.type == "cpu":
        return "eager"
    if x.device.type == "cuda":
        return "kernel"
    raise ValueError(f"no kernel for device {x.device}")


def check_operands(like_name: str, like: torch.Tensor, *vectors) -> None:
    """Each ``(name, x, size)`` of ``vectors`` float32 of shape ``(size,)``; all contiguous, on ``like``'s device.

    ``like`` itself is checked for contiguity only: its dtype and rank
    are the wrapper's to check.
    """
    for name, x, size in vectors:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != (size,):
            raise ValueError(f"{name} must have shape ({size},), got {tuple(x.shape)}")
    for name, x, _ in ((like_name, like, None), *vectors):
        if x.device != like.device:
            raise ValueError(f"{name} is on {x.device}, {like_name} on {like.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def parts(name: str, like: torch.Tensor, *args) -> int:
    """``<stem>_parts(*args)`` on ``like``'s card: the rows of workspace the launch needs."""
    kernel = KERNELS[name]
    out = ctypes.c_int(0)
    with torch.cuda.device(like.device):
        rc = kernel.bound()["parts"](*args, ctypes.byref(out))
    if rc:
        raise RuntimeError(f"{kernel.stem}_parts failed: CUDA error {rc}")
    return out.value


def launch(name: str, like: torch.Tensor, *args, rows: int) -> None:
    """``<stem>_launch(*args, stream)`` on ``like``'s card and its current stream, counted.

    Raises ``RuntimeError`` on a non-zero CUDA error code. A call counts
    unless it has no ``rows`` and the kernel launches nothing for none.
    """
    kernel = KERNELS[name]
    rc = _on_stream(kernel.bound()["launch"], like, args)
    if rc:
        raise RuntimeError(f"{kernel.what} failed to launch: CUDA error {rc}")
    if rows > 0 or kernel.count_empty:
        _launches[name] += 1


def finalize(name: str, like: torch.Tensor, *args) -> None:
    """``<stem>_finalize(*args, stream)`` on ``like``'s card and its current stream, counted.

    Counted under ``<name>_finalize``. Raises ``RuntimeError`` on a non-zero
    CUDA error code.
    """
    kernel = KERNELS[name]
    rc = _on_stream(kernel.bound()["finalize"], like, args)
    if rc:
        raise RuntimeError(f"{kernel.what}'s finalize failed to launch: CUDA error {rc}")
    _launches[f"{name}_finalize"] += 1


def _on_stream(fn, like: torch.Tensor, args) -> int:
    """``fn(*args, stream)`` with ``like``'s card current: its CUDA error code."""
    with torch.cuda.device(like.device):
        return fn(*args, torch.cuda.current_stream(like.device).cuda_stream)


def launches() -> dict[str, int]:
    """Each kernel's launches since :func:`reset_launches`, by the name of its wrapper."""
    return dict(_launches)


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0
