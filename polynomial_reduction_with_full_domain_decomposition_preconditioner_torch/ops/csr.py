"""Sparse matrices: host CSR assembly and the device SpMV.

Port of the math of the JAX package's ``ops/csr.py``: ``assemble_csr``
(COO -> CSR with duplicate summation) and the ``sparse_spmv`` y = A x that
its ELL, BSR and COO layouts all compute. Those layouts are the TPU's
tile-padding workarounds; here one container, ``CsrMatrix``, is packed
from a scipy CSR in a dtype on an explicit device, and the route is fixed
by the dtype when the matrix is packed:

- float32 / float64: the fixed-order CSR SpMV ``kernels.csr_spmv``
  (csrc/csr_spmv.cu on the card, its plain twin on the CPU): ``lanes``
  threads a row, chosen here from the row lengths, each summing every
  L-th entry in ascending order, then a fixed butterfly over the lanes.
  Every row has one summation order, so y repeats bit for bit from
  launch to launch and the twin reproduces it. Indices int32 while they
  fit, else int64;
- bfloat16: the values are stored in bf16, multiplied with the gathered
  x in f32 and summed per row in f32 by a sorted ``segment_reduce``
  (deterministic: one fixed summation order per row), then cast once to
  bf16. The same torch ops run on the CPU and on the card.

The index tensors are built once here, never per apply.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from . import kernels

__all__ = ["assemble_csr", "CsrMatrix", "csr_from_scipy", "sparse_spmv",
           "ROUTES"]

ROUTES = {
    torch.float32: "vector_csr",    # kernels.csr_spmv, summed in f32
    torch.float64: "vector_csr",    # ... in f64
    torch.bfloat16: "segment_sum",  # bf16 values, f32 products and sums
}


def assemble_csr(rows, cols, vals, shape, drop_tol: float = 0.0):
    """COO -> CSR with duplicate summation; entries below ``drop_tol`` in
    magnitude are dropped after the summation."""
    m = sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()
    m.sum_duplicates()
    if drop_tol > 0.0:
        m.data[np.abs(m.data) < drop_tol] = 0.0
        m.eliminate_zeros()
    return m


@dataclass
class CsrMatrix:
    """A CSR matrix on a device, packed for one SpMV route (``ROUTES``)."""
    crow: torch.Tensor          # (n_rows + 1,) row offsets
    cols: torch.Tensor          # (nnz,) column indices
    vals: torch.Tensor          # (nnz,) values in the matrix dtype
    shape: tuple
    route: str
    lanes: int = 1              # vector_csr: threads a row (kernels.spmv_lanes)
    plan: dict | None = None    # vector_csr: the twin's segments (lane_plan)

    def lane_plan(self) -> dict:
        """The kernel's per-(row, lane) summation segments for the plain
        twin (kernels.spmv_lane_plan), made at first use and kept."""
        if self.plan is None:
            self.plan = kernels.spmv_lane_plan(self.crow, self.lanes)
        return self.plan

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz(self) -> int:
        return self.vals.numel()


def csr_from_scipy(m, dtype=torch.float32, *, device) -> CsrMatrix:
    """Pack a scipy sparse matrix for the SpMV route of ``dtype`` on
    ``device`` (a torch device or name; "cpu" for the CPU)."""
    if dtype not in ROUTES:
        raise ValueError(f"no SpMV route for {dtype} (use one of "
                         f"{sorted(str(d) for d in ROUTES)})")
    m = sp.csr_matrix(m)
    if not m.has_canonical_format:  # sorted, unique column indices
        m = m.copy()                # (never reorder the caller's arrays)
        m.sum_duplicates()
    n_rows, n_cols = m.shape
    fits32 = max(m.nnz, n_rows, n_cols) < 2 ** 31
    route = ROUTES[dtype]
    itype = torch.int32 if fits32 and route == "vector_csr" else torch.int64
    crow = torch.as_tensor(m.indptr.astype(np.int64), device=device).to(itype)
    cols = torch.as_tensor(m.indices.astype(np.int64), device=device).to(itype)
    vals = torch.as_tensor(m.data, dtype=torch.float64, device=device).to(dtype)
    mat = CsrMatrix(crow=crow, cols=cols, vals=vals,
                    shape=(n_rows, n_cols), route=route)
    if route == "vector_csr":
        mat.lanes = kernels.spmv_lanes(m.nnz, n_rows)
        if crow.device.type == "cpu":   # the twin is the CPU's route
            mat.lane_plan()
    return mat


def sparse_spmv(mat: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a flat x of the matrix's column count, in its dtype."""
    if x.dim() != 1 or x.numel() != mat.shape[1]:
        raise ValueError(f"x of shape {tuple(x.shape)} for a "
                         f"{mat.shape} matrix")
    if mat.route == "vector_csr":
        return kernels.csr_spmv(mat, x.to(mat.dtype).contiguous())
    prod = mat.vals.float() * x.float()[mat.cols]
    y = torch.segment_reduce(prod, "sum", offsets=mat.crow, unsafe=True)
    return y.to(mat.dtype)
