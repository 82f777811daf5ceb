"""ctypes binding to the shared native setup library (``native/``).

The port's own binding to ``native/setup_kernels.cpp`` (P1 stiffness COO
emission on structured node grids, COO -> CSR with duplicate summation).
The source is compiled at first use with g++ and the flags of
``native/Makefile`` into ``_build/`` inside the package (ignored by git),
named by a hash of the source, the flags and the building CPU (the flags
hold ``-march=native``), so an unchanged tree on the same machine loads
the existing library and a tree copied to another machine rebuilds it. Concurrent first uses (test workers) serialize on a
lock file; the library is written to a temporary name and renamed into
place. There is no fallback: a caller that asks for the native path gets
it, or an error.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile

import numpy as np
import scipy.sparse as sp

__all__ = ["build", "library_path", "load", "p1_fem_coo", "coo_to_csr",
           "CXXFLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "setup_kernels.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
# the CXXFLAGS of native/Makefile (tests/test_torch_amg.py holds them equal)
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
            "-Wall", "-D_GLIBCXX_PARALLEL"]


# /proc/cpuinfo keys that decide what -march=native compiles for (x86, arm)
_CPU_KEYS = ("vendor_id", "cpu family", "model", "model name", "flags",
             "CPU implementer", "CPU architecture", "CPU variant", "CPU part",
             "Features")


def host_cpu() -> str:
    """The machine's architecture and its first CPU's model and feature
    flags: the target ``-march=native`` resolves to."""
    ident = [platform.machine()]
    with open("/proc/cpuinfo") as fh:
        for line in fh:
            if not line.strip():
                break                       # the first processor's block
            if line.split(":", 1)[0].strip() in _CPU_KEYS:
                ident.append(line.strip())
    return "\n".join(ident)


def library_path() -> str:
    """Where the library for this source, these flags and this CPU lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(host_cpu().encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libprfdd_setup_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Path of the native setup library, compiling it if needed."""
    so = library_path()
    if os.path.exists(so):
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native setup library "
                           "(native/setup_kernels.cpp) cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(so):          # built while we waited
                return so
            tmp = tempfile.mkdtemp(dir=BUILD_DIR)
            try:
                out = os.path.join(tmp, "lib.so")
                proc = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", out,
                                       SOURCE], capture_output=True,
                                      text=True)
                if proc.returncode != 0:
                    raise RuntimeError("g++ failed on the native setup "
                                       "library:\n" + proc.stdout
                                       + proc.stderr)
                os.replace(out, so)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The loaded library with every entry's argument types declared."""
    lib = ctypes.CDLL(build())
    i64 = ctypes.c_int64
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.p1_fem_coo_3d.restype = i64
    lib.p1_fem_coo_3d.argtypes = [p_f64, i64, i64, i64, p_i64, p_i64, p_f64]
    lib.p1_fem_coo_2d.restype = i64
    lib.p1_fem_coo_2d.argtypes = [p_f64, i64, i64, p_i64, p_i64, p_f64]
    lib.coo_to_csr.restype = i64
    lib.coo_to_csr.argtypes = [p_i64, p_i64, p_f64, i64, i64, i64,
                               p_i64, p_i64, p_f64]
    return lib


def p1_fem_coo(X: np.ndarray):
    """COO entries (rows, cols, vals) of the P1 stiffness matrix on a
    structured node grid X of shape (nz, ny, nx, 3) or (ny, nx, 2)."""
    lib = load()
    X = np.ascontiguousarray(X, dtype=np.float64)
    dim = X.shape[-1]
    if dim not in (2, 3) or X.ndim != dim + 1 or min(X.shape[:-1]) < 2:
        raise ValueError(f"node grid of shape {X.shape}: expected "
                         "(nz, ny, nx, 3) or (ny, nx, 2), >= 2 nodes a side")
    cells = int(np.prod([s - 1 for s in X.shape[:-1]]))
    n_ent = cells * (96 if dim == 3 else 18)
    rows = np.empty(n_ent, dtype=np.int64)
    cols = np.empty(n_ent, dtype=np.int64)
    vals = np.empty(n_ent, dtype=np.float64)
    if dim == 3:
        lib.p1_fem_coo_3d(X, *X.shape[:3], rows, cols, vals)
    else:
        lib.p1_fem_coo_2d(X, *X.shape[:2], rows, cols, vals)
    return rows, cols, vals


def coo_to_csr(rows, cols, vals, shape) -> sp.csr_matrix:
    """COO -> CSR with duplicate summation, rows and columns sorted."""
    lib = load()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    nr, nc = shape
    if not (rows.size == cols.size == vals.size):
        raise ValueError("rows, cols and vals differ in length")
    if rows.size and (rows.min() < 0 or rows.max() >= nr
                      or cols.min() < 0 or cols.max() >= nc):
        raise ValueError(f"a COO index lies outside the shape {shape}")
    indptr = np.empty(nr + 1, dtype=np.int64)
    out_cols = np.empty(rows.size, dtype=np.int64)
    out_vals = np.empty(rows.size, dtype=np.float64)
    nnz = lib.coo_to_csr(rows, cols, vals, rows.size, nr, nc,
                         indptr, out_cols, out_vals)
    return sp.csr_matrix((out_vals[:nnz], out_cols[:nnz], indptr),
                         shape=shape)
