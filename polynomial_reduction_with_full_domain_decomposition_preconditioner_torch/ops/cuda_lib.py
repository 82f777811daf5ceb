"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, and the objects are linked into one shared
library with a plain C interface, loaded with ctypes. The build happens
at first use, into ``_build/`` inside the package (ignored by git), named
by a hash of the sources and flags, so an unchanged tree loads the
existing library. ptxas reports each kernel's registers and spills
(``-Xptxas -v``); the report is kept beside the library and
``resource_usage()`` sums it up per source. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

__all__ = ["build", "load", "resource_usage", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's kernels are built on the machine with the card")


def build() -> str:
    """Path of the kernels' shared library, compiling it if needed."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    so = os.path.join(BUILD_DIR, f"libprfdd_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs, procs = [], []
        for src in sources:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed, report = [], []
        for src, p in procs:
            out, _ = p.communicate()
            report.append(f"== {os.path.basename(src)}\n{out}")
            if p.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs,
                               "-o", tmp_so],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
        with open(so + ".ptxas.txt", "w") as fh:
            fh.write("\n".join(report))
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def resource_usage() -> dict:
    """{source: {"kernels", "max_registers", "spill_bytes"}} from the
    ptxas report of the built library (spill_bytes sums every kernel's
    spill stores and loads; 0 means nothing spilled)."""
    usage = {}
    with open(build() + ".ptxas.txt") as fh:
        for part in fh.read().split("== ")[1:]:
            name, _, text = part.partition("\n")
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
            spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
            usage[name] = {"kernels": len(regs),
                           "max_registers": max(regs, default=0),
                           "spill_bytes": sum(int(a) + int(b) for a, b in spills)}
    return usage


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The loaded library with every entry's argument types declared."""
    lib = ctypes.CDLL(build())
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # the last ints of these three are the launch plan (ops/kernels.py)
    lib.prfdd_stiffness_3d.argtypes = ([i32, i32] + [vp] * 9 + [i64] * 3
                                       + [i32] * 3 + [vp])
    lib.prfdd_stiffness_3d.restype = i32
    lib.prfdd_stiffness_split_3d.argtypes = ([i32, i32] + [vp] * 9 + [i64] * 3
                                             + [i32] * 4 + [vp])
    lib.prfdd_stiffness_split_3d.restype = i32
    lib.prfdd_stiffness_split_blocks_per_sm.argtypes = ([i32] * 4
                                                        + [ctypes.POINTER(i32)])
    lib.prfdd_stiffness_split_blocks_per_sm.restype = i32
    lib.prfdd_face_sum_3d.argtypes = ([i32, i32, i32] + [vp] * 4 + [i64] * 4
                                      + [i32] * 3 + [vp])
    lib.prfdd_face_sum_3d.restype = i32
    return lib
