"""Stencil-form sparse operators on tensor node grids.

Port of the JAX package's ``ops/stencil.py``: a matrix whose pattern lies
in the box stencil of a tensor grid (27 points in 3-D, 9 in 2-D) is
stored as per-offset coefficient arrays. A wrapped neighbor has no CSR
entry, so its coefficient is zero and wraparound contributions vanish.
"""

from __future__ import annotations

from itertools import product

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

__all__ = ["stencil_offsets", "stencil_from_csr", "stencil_apply"]


def stencil_offsets(dim: int):
    return list(product((-1, 0, 1), repeat=dim))


def stencil_from_csr(A: sp.csr_matrix, grid_shape, dtype=torch.float32,
                     device=None):
    """CSR matrix over a C-order raveled tensor grid -> per-offset
    coefficients (K, *grid_shape). Raises if an entry falls outside the
    distance-1 box stencil."""
    grid_shape = tuple(grid_shape)
    dim = len(grid_shape)
    coo = A.tocoo()
    rc = np.stack(np.unravel_index(coo.row, grid_shape), axis=0)
    cc = np.stack(np.unravel_index(coo.col, grid_shape), axis=0)
    d = cc - rc
    if np.abs(d).max(initial=0) > 1:
        raise ValueError("matrix entries outside the box stencil")
    key = np.zeros(coo.nnz, dtype=np.int64)
    for a in range(dim):
        key = key * 3 + (d[a] + 1)
    coefs = np.zeros((3 ** dim,) + grid_shape)
    np.add.at(coefs.reshape(3 ** dim, -1), (key, coo.row), coo.data)
    return torch.as_tensor(coefs, dtype=dtype, device=device)


def stencil_apply(coefs, x, dim: int):
    """y = A x with A in stencil form (27 points in 3-D, 9 in 2-D); x is
    flat over the grid, or a (B, grid points) batch of such vectors (the
    composite's shards, each with its own vertex problem on the one
    replicated grid).

    The reference's rolls as one circular pad and 3^dim shifted views:
    the view for offset o at point p reads X[(p + o) mod shape], exactly
    what roll(X, -o) gives."""
    grid_shape = tuple(coefs.shape[1:])
    if len(grid_shape) != dim or dim not in (2, 3):
        raise ValueError(f"a {dim}-D stencil on grid {grid_shape}")
    pad = (1, 1) * dim
    if x.dim() == 2:
        X = x.reshape((x.shape[0], 1) + grid_shape)
        Xp = F.pad(X, pad, mode="circular")[:, 0]
        coefs = coefs[:, None]
    else:
        X = x.reshape(grid_shape)
        Xp = F.pad(X[None, None], pad, mode="circular")[0, 0]
    views = torch.stack([
        Xp[(Ellipsis,) + tuple(slice(1 + o, 1 + o + m)
                               for o, m in zip(off, grid_shape))]
        for off in stencil_offsets(dim)])
    return (coefs * views).sum(dim=0).reshape(x.shape)
