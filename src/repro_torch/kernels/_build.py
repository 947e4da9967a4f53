"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface under ``build/kernels/`` at the repository root; the
file name carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads at once.  No PyTorch header is
compiled in: the wrappers pass ``data_ptr()`` pointers and the current
stream through ``ctypes``.

Nothing here runs when a module is imported: :func:`load` is called by a
wrapper the first time it launches a kernel on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
_bound: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from source at "
        "first use and need the CUDA toolkit (nvcc on PATH or under "
        "/usr/local/cuda)")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source
    hash exists; returns the library's path.  ``ptxas``'s report
    (``-Xptxas -v``: registers, shared memory and spills of each kernel)
    is kept beside it for :func:`resources`."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    lib.with_suffix(".ptxas").write_text(proc.stderr)
    os.replace(tmp, lib)        # atomic: a concurrent loader sees all or none
    return lib


_NUM = {"registers": r"Used (\d+) registers",
        "smem_static": r"(\d+) bytes smem",
        "stack": r"(\d+) bytes stack frame",
        "spill_stores": r"(\d+) bytes spill stores",
        "spill_loads": r"(\d+) bytes spill loads"}


def resources(name: str) -> list:
    """Each kernel of ``csrc/<name>.cu`` as ``ptxas`` reported it when the
    library was built: ``{kernel, registers, smem_static, stack,
    spill_stores, spill_loads}`` (dynamic shared memory is the launch's,
    not in the report)."""
    report = build(name).with_suffix(".ptxas").read_text()
    out = []
    for part in report.split("Compiling entry function '")[1:]:
        row = {"kernel": part.split("'")[0]}
        for key, pat in _NUM.items():
            m = re.search(pat, part)
            row[key] = int(m.group(1)) if m else 0
        out.append(row)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib


def bind(name: str, signatures: dict) -> ctypes.CDLL:
    """:func:`load`, with ``argtypes`` set from ``{fn: [ctypes types]}``
    (every entry returns an int error code) and ``<name>_error_string``
    bound to turn a code into text.  After the first call it is one
    dict lookup: a launch takes no lock."""
    lib = _bound.get(name)
    if lib is not None:
        return lib
    lib = load(name)
    with _lock:
        if name not in _bound:
            for fn, args in signatures.items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _bound[name] = lib
    return lib


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device as the raw pointer a
    launch entry takes (the same value as ``torch.cuda.current_stream(
    t.device).cuda_stream``, for a fraction of its host time)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(lib: ctypes.CDLL, name: str, op: str, rc: int) -> None:
    """Raise if a launch entry of ``csrc/<name>.cu`` returned non-zero."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{op} kernel launch failed: {msg} (code {rc})")
