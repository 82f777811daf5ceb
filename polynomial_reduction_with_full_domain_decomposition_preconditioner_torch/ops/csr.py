"""Sparse matrices: host CSR assembly and the device SpMV.

Port of the math of the JAX package's ``ops/csr.py``: ``assemble_csr``
(COO -> CSR with duplicate summation) and the ``sparse_spmv`` y = A x that
its ELL, BSR and COO layouts all compute. Those layouts are the TPU's
tile-padding workarounds; here one container, ``CsrMatrix``, is packed
from a scipy CSR in a dtype on an explicit device, and the route is fixed
by the dtype when the matrix is packed:

- float32 / float64: a ``torch.sparse_csr_tensor`` SpMV (MKL on the CPU,
  cuSPARSE on the card), indices int32 while they fit, else int64;
- bfloat16: the values are stored in bf16, multiplied with the gathered
  x in f32 and summed per row in f32 by a sorted ``segment_reduce``
  (deterministic: one fixed summation order per row), then cast once to
  bf16. The same torch ops run on the CPU and on the card
  (``sparse_csr @ x`` has no bf16 kernel).

The index tensors are built once here, never per apply.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["assemble_csr", "CsrMatrix", "csr_from_scipy", "sparse_spmv",
           "ROUTES"]

ROUTES = {
    torch.float32: "sparse_csr",    # torch.sparse_csr_tensor @ x
    torch.float64: "sparse_csr",
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
    sparse: torch.Tensor | None = None   # the sparse_csr tensor (its route)

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
    itype = torch.int32 if fits32 and route == "sparse_csr" else torch.int64
    crow = torch.as_tensor(m.indptr.astype(np.int64), device=device).to(itype)
    cols = torch.as_tensor(m.indices.astype(np.int64), device=device).to(itype)
    vals = torch.as_tensor(m.data, dtype=torch.float64, device=device).to(dtype)
    mat = CsrMatrix(crow=crow, cols=cols, vals=vals,
                    shape=(n_rows, n_cols), route=route)
    if route == "sparse_csr":
        with warnings.catch_warnings():
            # torch flags its sparse CSR layout as beta on every construction
            warnings.simplefilter("ignore", UserWarning)
            mat.sparse = torch.sparse_csr_tensor(
                crow, cols, vals, size=(n_rows, n_cols),
                check_invariants=False)
    return mat


def sparse_spmv(mat: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a flat x of the matrix's column count, in its dtype."""
    if x.dim() != 1 or x.numel() != mat.shape[1]:
        raise ValueError(f"x of shape {tuple(x.shape)} for a "
                         f"{mat.shape} matrix")
    if mat.route == "sparse_csr":
        return torch.mv(mat.sparse, x.to(mat.dtype))
    prod = mat.vals.float() * x.float()[mat.cols]
    y = torch.segment_reduce(prod, "sum", offsets=mat.crow, unsafe=True)
    return y.to(mat.dtype)
