"""Host-side element <-> point-lattice layout conversion.

The port's copy of the JAX package's ``mesh/layout.py``: the single
definition of the lattice layout. Element-ordered data (E, n^dim [, F])
with local ordering v = i + j*n (+ k*n^2) maps to the lattice
(g_0*n, ..., g_{d-1}*n [, F]) with index X_d = e_d * n + i_d, where
``grid`` is the element grid in storage order (slowest..fastest).
"""

from __future__ import annotations

import numpy as np

__all__ = ["elements_to_lattice", "lattice_to_elements"]


def elements_to_lattice(arr, grid, n: int, dim: int) -> np.ndarray:
    """(E, n^dim [, F]) or flat (E*n^dim,) -> (g_0*n, ..., g_{dim-1}*n [, F])."""
    grid = tuple(grid)
    E = int(np.prod(grid))
    a = np.asarray(arr)
    if a.ndim == 1:
        a = a.reshape(E, n ** dim)
    F = a.shape[2:]
    U = a.reshape(grid + (n,) * dim + F)
    perm = [ax for d in range(dim) for ax in (d, dim + d)]
    perm += [2 * dim + k for k in range(len(F))]
    return U.transpose(perm).reshape(tuple(g * n for g in grid) + F)


def lattice_to_elements(U, grid, n: int, dim: int) -> np.ndarray:
    """Inverse of elements_to_lattice; returns (E*n^dim [, F])."""
    grid = tuple(grid)
    U = np.asarray(U)
    F = U.shape[dim:]
    V = U.reshape(sum(((g, n) for g in grid), ()) + F)
    perm = ([2 * d for d in range(dim)] + [2 * d + 1 for d in range(dim)]
            + [2 * dim + k for k in range(len(F))])
    E = int(np.prod(grid))
    return V.transpose(perm).reshape((E * n ** dim,) + F)
