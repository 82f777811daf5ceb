"""Tensor-product order transfer and dense grid-axis contractions.

Port of the JAX package's ``ops/interp.py``: the lattice forms, and the
element-layout forms of unstructured meshes (``tensor_apply``,
``prolongate``, ``restrict``; prolongation u_f = (J x J [x J]) u_c
with J = interp(n_c -> n_f), restriction its adjoint with J^T).
"""

from __future__ import annotations

import torch

from .sem import dmul

__all__ = ["lattice_tensor_apply", "axis_contract", "tensor_apply",
           "prolongate", "restrict"]


def tensor_apply(u, M, dim: int):
    """Apply the 1-D operator M (n_out, n_in) along every node axis of an
    element-layout field u (..., E, n_in^dim); returns (..., E,
    n_out^dim)."""
    n_out, n_in = M.shape
    lead = u.shape[:-1]
    if dim == 2:
        U = u.reshape(-1, n_in, n_in)                # (e, y, x)
        U = torch.matmul(M, torch.matmul(U, M.T))    # x, then y
        return U.reshape(lead + (n_out ** 2,))
    if dim != 3:
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    U = u.reshape(-1, n_in, n_in, n_in)              # (e, z, y, x)
    U = torch.matmul(U, M.T)                         # x
    U = torch.matmul(M, U)                           # y
    B = U.shape[0]
    U = torch.matmul(M, U.reshape(B, n_in, n_out * n_out))   # z
    return U.reshape(lead + (n_out ** 3,))


def prolongate(u_c, J, dim: int):
    """Coarse -> fine: J is interp_matrix(n_c, n_f), shape (n_f, n_c)."""
    return tensor_apply(u_c, J, dim)


def restrict(r_f, J, dim: int):
    """Fine -> coarse adjoint transfer: uses J^T."""
    return tensor_apply(r_f, J.T, dim)


def lattice_tensor_apply(U, M, dim: int):
    """Apply the 1-D operator M (n_out, n_in) per element along every axis
    of a point lattice, or of each lattice of a (P, ...) stack of slab
    shards (one pass over the element-aligned (P*Mz, ...) view); returns
    the lattice at order n_out."""
    if U.dim() == dim + 1:
        P = U.shape[0]
        V = lattice_tensor_apply(U.reshape((-1,) + tuple(U.shape[2:])), M,
                                 dim)
        return V.reshape((P, -1) + tuple(V.shape[1:]))
    n_in = M.shape[1]
    for axis in range(dim):
        U = dmul(M, U, axis, n_in)
    return U


def axis_contract(M, U, axis: int):
    """Contract one full lattice axis with a dense operator M (n_out,
    n_in), U.shape[axis] == n_in (vertex-grid prolongation/restriction)."""
    V = torch.tensordot(M, U, dims=([1], [axis]))
    return torch.movedim(V, 0, axis)
