"""Tensor-product order transfer and dense grid-axis contractions.

Port of the JAX package's ``ops/interp.py`` (the lattice forms).
"""

from __future__ import annotations

import torch

from .sem import dmul

__all__ = ["lattice_tensor_apply", "axis_contract"]


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
