"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``build/`` (beside this file) at first
use, then loaded with ``ctypes``.  The library's file name carries a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
is reused.  ``build_all`` starts one ``nvcc`` per source at once and waits
for all of them.  ``ptxas -v`` reports each kernel's registers, shared memory
and spills; the report is kept beside the library (``ptxas_report``).
Nothing is downloaded: the sources in the package are the only input.

``launch`` is every wrapper's way onto the card.  Once a library is loaded,
a launch takes no lock, asks nothing of the CUDA runtime but the current
device and stream, and switches the device only when the tensor lies on
another one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "launch", "load",
           "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# the current stream's raw handle, without building a torch.cuda.Stream
# (CUDA builds of PyTorch have it)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the CUDA kernels need a CUDA device; pass CPU tensors to use "
            "the plain PyTorch versions")


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` whose library is missing, in parallel.

    Returns ``{name: library path}``.  Raises with ``nvcc``'s output when a
    source does not compile.
    """
    _require_cuda()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent builder never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def ptxas_report(name: str) -> str:
    """What nvcc printed when it built ``csrc/<name>.cu`` (ptxas's lines on
    registers, shared memory and spills of each kernel), building it first
    if needed."""
    out = _target(name)
    if not out.exists():
        build_all()
    return out.with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed.  The first load raises when no CUDA device is present; a loaded
    library is returned by one dictionary read."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    _require_cuda()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                build_all()
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
        return lib


def _stream(index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(fn, device: torch.device, *args) -> int:
    """Call a kernel's C entry point as ``fn(*args, stream)`` on the current
    stream of ``device`` (a CUDA device) and return its status."""
    index = device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return fn(*args, _stream(index))
    return fn(*args, _stream(index))
