"""Native host data loader bindings.

Counterpart of ``partitionedhashjoin_tpu/data/host_loader.py``.  The
engine's host-side runtime is C++ (``native/phj_host.cpp``): a worker-pool
batch executor plus the sequential/Zipf table generators, the Zipf alias
table construction and a hash-set join oracle, mirroring the reference's native
L2/L3 role (src/Common/ThreadPool.*, src/DataGenerator/*).  This module
binds its four C entries through ctypes.

The shared library is built at first use with ``g++`` (the flags of
``native/Makefile``) into ``build/host/`` at the repository root, under a
name that carries the hash of the source and the flags; ``native/`` is never
written.  The build writes a temporary name and then ``os.replace``s it, so
concurrent processes are safe.  Without ``g++`` the first use raises.

Use cases: the alias sampler's tables (``ops/generators.py::
zipf_keys_alias``), host-side generation, and fast exact join-count
verification at sizes where numpy oracles crawl.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "phj_host.cpp"
BUILD_DIR = REPO_DIR / "build" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library built from ``native/phj_host.cpp`` lives: named by
    the hash of the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(b"\0" + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libphjhost-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/phj_host.cpp`` unless its library exists; return its
    path."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found on PATH; it is needed to build the host runtime "
            f"library from {SOURCE}"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed on {SOURCE.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.phj_generate_sequential.argtypes = [
            ctypes.c_int64, i32p, i32p, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.phj_generate_sequential.restype = None
        lib.phj_generate_zipf.argtypes = [
            ctypes.c_double, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
            i32p, i32p, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.phj_generate_zipf.restype = None
        lib.phj_host_join_count.argtypes = [
            i32p, ctypes.c_int64, i32p, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.phj_host_join_count.restype = ctypes.c_int64
        lib.phj_build_zipf_alias.argtypes = [
            ctypes.c_double,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            i32p,
        ]
        lib.phj_build_zipf_alias.restype = None
        _lib = lib
        return lib


def _workers(workers: Optional[int]) -> int:
    if workers is None:
        workers = max(1, (os.cpu_count() or 2) - 1)  # main.cpp:235 convention
    return workers


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def generate_sequential(
    n: int, start: int = 1, workers: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-parallel sequential relation: keys start..start+n-1, payload=i."""
    lib = _load()
    keys = np.empty(n, np.int32)
    payloads = np.empty(n, np.int32)
    lib.phj_generate_sequential(start, _ptr(keys), _ptr(payloads), n, _workers(workers))
    return keys, payloads


def generate_zipf(
    n: int,
    alpha: float,
    key_range: Tuple[int, int],
    seed: int = 0,
    workers: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-parallel Zipf relation over closed [lo, hi], payload=i."""
    lo, hi = key_range
    if lo >= hi:
        raise ValueError(f"bad Zipf range [{lo}, {hi}]")
    lib = _load()
    keys = np.empty(n, np.int32)
    payloads = np.empty(n, np.int32)
    lib.phj_generate_zipf(
        float(alpha), lo, hi, seed, _ptr(keys), _ptr(payloads), n, _workers(workers)
    )
    return keys, payloads


def build_zipf_alias(alpha: float, cardinality: int):
    """Exact Vose alias tables for Zipf(alpha) over [1, cardinality].

    Returns (prob float32[n], alias int32[n]); sampling is then two lookups
    per draw (ops/generators.py::zipf_keys_alias) — exact, no rejection.
    """
    lib = _load()
    prob = np.empty(cardinality, np.float32)
    alias = np.empty(cardinality, np.int32)
    lib.phj_build_zipf_alias(
        float(alpha),
        cardinality,
        prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _ptr(alias),
    )
    return prob, alias


def host_join_count(
    build_keys: np.ndarray,
    probe_keys: np.ndarray,
    workers: Optional[int] = None,
) -> int:
    """Exact Get-semantics match count on the host (verification oracle)."""
    lib = _load()
    build_keys = np.ascontiguousarray(build_keys, np.int32)
    probe_keys = np.ascontiguousarray(probe_keys, np.int32)
    return int(
        lib.phj_host_join_count(
            _ptr(build_keys),
            len(build_keys),
            _ptr(probe_keys),
            len(probe_keys),
            _workers(workers),
        )
    )
