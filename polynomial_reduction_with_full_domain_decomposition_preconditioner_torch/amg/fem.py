"""Low-order P1 finite-element matrices on structured node grids.

Port of the JAX package's ``amg/fem.py`` (host numpy/scipy setup): each
hex cell between adjacent grid nodes becomes 6 Kuhn tetrahedra with
per-simplex P1 stiffness, and each quad cell of a 2-D grid 2 triangles.
The default assembly is the shared native C++ library (utils/native.py);
the numpy assembly, 2-D and 3-D, runs only when ``use_native=False`` is
passed. ``sem_element_matrices``
gives the exact SEM element matrices (order-1 layers of the composite
FEM hierarchy use them).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..utils.gll import diff_matrix, gll_points_weights, lagrange_eval

__all__ = ["p1_stiffness_grid", "grid_interp_1d", "sem_element_matrices"]

# Kuhn triangulation of the unit cube: for each permutation pi of the axes,
# the tet 0 -> e_{pi0} -> e_{pi0}+e_{pi1} -> (1,1,1). Corners as (cz, cy, cx).
_KUHN_PERMS = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


def _kuhn_tets():
    tets = []
    for perm in _KUHN_PERMS:
        corners = [(0, 0, 0)]
        acc = [0, 0, 0]
        for ax in perm:
            acc[ax] = 1
            corners.append(tuple(acc))
        tets.append(corners)
    return tets


def _simplex_stiffness(verts):
    """P1 stiffness matrices (B, d+1, d+1) for simplices verts (B, d+1, d):
    K[a,b] = |T| grad(lambda_a) . grad(lambda_b)."""
    d = verts.shape[-1]
    M = verts[:, 1:, :] - verts[:, :1, :]
    det = np.linalg.det(M)
    vol = np.abs(det) / (2.0 if d == 2 else 6.0)
    Minv = np.linalg.inv(M)
    grads = np.empty((verts.shape[0], d + 1, d))
    grads[:, 1:, :] = np.swapaxes(Minv, 1, 2)
    grads[:, 0, :] = -grads[:, 1:, :].sum(axis=1)
    return np.einsum("bad,bcd->bac", grads, grads) * vol[:, None, None]


def _assemble(X, nid, cells):
    """COO entries of the P1 stiffness of the simplices ``cells`` (each a
    list of d + 1 corner offsets into the node grid) of every grid cell."""
    dim = X.shape[-1]
    ncell = tuple(g - 1 for g in nid.shape)
    rows, cols, vals = [], [], []
    for corners in cells:
        sl = [tuple(slice(c, c + m) for c, m in zip(off, ncell))
              for off in corners]
        verts = np.stack([X[s].reshape(-1, dim) for s in sl], axis=1)
        ids = np.stack([nid[s].reshape(-1) for s in sl], axis=1)
        K = _simplex_stiffness(verts)
        m = ids.shape[1]
        rows.append(np.repeat(ids, m, axis=1).ravel())
        cols.append(np.tile(ids, (1, m)).ravel())
        vals.append(np.swapaxes(K, 1, 2).ravel())
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


# two triangles a quad cell, corners as (cy, cx)
_QUAD_TRIS = [[(0, 0), (0, 1), (1, 1)], [(0, 0), (1, 1), (1, 0)]]


def p1_stiffness_grid(X: np.ndarray, use_native: bool = True) -> sp.csr_matrix:
    """P1 stiffness matrix on a structured node grid X (nz, ny, nx, 3) or
    (ny, nx, 2): CSR over C-order raveled node indices, no boundary
    conditions. ``use_native`` (default) assembles with the native
    library and raises if it cannot be built; False runs the numpy
    assembly."""
    X = np.asarray(X, dtype=np.float64)
    grid = X.shape[:-1]
    n = int(np.prod(grid))
    if use_native:
        from ..utils import native
        rows, cols, vals = native.p1_fem_coo(X)
        return native.coo_to_csr(rows, cols, vals, (n, n))
    dim = X.shape[-1]
    if dim not in (2, 3) or len(grid) != dim:
        raise ValueError(f"a (ny, nx, 2) or (nz, ny, nx, 3) node grid, got "
                         f"{X.shape}")
    nid = np.arange(n, dtype=np.int64).reshape(grid)
    cells = _QUAD_TRIS if dim == 2 else _kuhn_tets()
    rows, cols, vals = _assemble(X, nid, cells)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def grid_interp_1d(m: int, o_from: int, o_to: int) -> sp.csr_matrix:
    """1-D interpolation between multi-element GLL grids on [0, 1]: nodal
    values on m elements of order ``o_from`` (m*o_from + 1 shared nodes) to
    the same elements at order ``o_to``; shared rows written once."""
    n_from, n_to = m * o_from + 1, m * o_to + 1
    rf, _ = gll_points_weights(o_from + 1)
    rt, _ = gll_points_weights(o_to + 1)
    L = lagrange_eval(rf, rt)               # (o_to+1, o_from+1)
    rows, cols, vals = [], [], []
    for e in range(m):
        r0, c0 = e * o_to, e * o_from
        rr, cc = np.nonzero(np.abs(L) > 1e-15)
        keep = (rr > 0) | (e == 0)          # write shared row once
        rows.append(r0 + rr[keep])
        cols.append(c0 + cc[keep])
        vals.append(L[rr[keep], cc[keep]])
    return sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_to, n_from)).tocsr()


def sem_element_matrices(geom: np.ndarray, dim: int, n: int) -> np.ndarray:
    """Exact SEM element stiffness matrices (E, npe, npe) from geometric
    factors (E, npe, 3 or 6): K_e = sum_ab D_a^T diag(G_ab) D_b. With n=2
    these are the SEM Q1 element matrices of order-1 elements."""
    D1 = np.asarray(diff_matrix(n))
    eye = np.eye(n)
    Ds = []
    for a in range(dim):                   # a = 0 -> r (x, fastest axis)
        mats = [eye] * dim
        mats[dim - 1 - a] = D1
        M = mats[0]
        for k in range(1, dim):
            M = np.kron(M, mats[k])
        Ds.append(M)
    Ds = np.stack(Ds)                      # (dim, npe, npe)
    if dim == 2:
        comp = [(0, 0, 0), (1, 1, 1), (2, 0, 1)]
    else:
        comp = [(0, 0, 0), (1, 1, 1), (2, 2, 2),
                (3, 0, 1), (4, 0, 2), (5, 1, 2)]
    npe = n ** dim
    E = geom.shape[0]
    Gf = np.zeros((E, npe, dim, dim))
    g = geom.reshape(E, npe, -1)
    for k, a, b in comp:
        Gf[..., a, b] = g[..., k]
        Gf[..., b, a] = g[..., k]
    return np.einsum("amp,emab,bmq->epq", Ds, Gf, Ds)
