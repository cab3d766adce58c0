"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` of :data:`SOURCES` (the stems of
:data:`~rio_tpu_torch.kernels.launch.KERNELS`) has a plain C interface and
is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``_build/lib<name>-<hash>.so``, keyed by a hash of the source and the
flags, then loaded with ``ctypes``. Nothing but the
sources in this package goes into a build. :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for every one of them.

``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin`` and
``/usr/local/cuda/bin``; without it, a build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .launch import KERNELS

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
_BY_STEM = {k.stem: k for k in KERNELS.values()}
SOURCES = tuple(_BY_STEM)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``; raises ``RuntimeError`` when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of rio_tpu_torch cannot be built")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    key = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` that is missing; return each new build's log.

    The log holds what ``-Xptxas -v`` says of each kernel (registers,
    shared memory, spills). Raises ``RuntimeError`` with the log if a
    compile fails, after every started ``nvcc`` has ended.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n" + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if it is missing.

    Its entry points' signatures are declared once, under the lock, when
    it is first loaded (:meth:`~rio_tpu_torch.kernels.launch.Kernel.bind`).
    """
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _BY_STEM[name].bind(lib)
            _loaded[name] = lib
        return lib
