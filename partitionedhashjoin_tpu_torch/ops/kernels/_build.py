"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each library has a plain C interface, so it compiles in seconds without
PyTorch's headers.  It is built at first use, from the repository's sources
only, into ``build/kernels/`` at the repository root, under a name that
carries the hash of its source, the shared headers and the flags.  The
build writes to a temporary name and then ``os.replace``s it, so
concurrent processes are safe: each either finds the finished library or
installs an identical one.

The compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
kept beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Loaded libraries by source name, so each is built and loaded once.
_LOADED: Dict[str, ctypes.CDLL] = {}

#: C signature of an exported function: (argtypes, restype).
Signature = Tuple[Sequence[type], type]


def find_nvcc() -> str:
    """nvcc from ``PATH``, else from ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``, the toolkit's install prefix); raises if absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file() and os.access(candidate, os.X_OK):
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or in $CUDA_HOME/bin; the CUDA toolkit is "
        "needed to build the port's kernels"
    )


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: named by the
    hash of the source, every shared header ``csrc/*.cuh`` (so that editing
    a header rebuilds each library) and the flags."""
    digest = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return its path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str, signatures: Dict[str, Signature]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, declaring each function
    of ``signatures``.  Pointers and streams must be ``ctypes.c_void_p``:
    an undeclared argument is passed as a 32-bit int and cuts the pointer."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn_name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        _LOADED[name] = lib
    return lib
