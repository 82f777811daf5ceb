"""Vertex-grid low-order hierarchy (host setup).

Port of the part of the JAX package's ``amg/composite.py`` that the
matrix-free hybrid inner preconditioner needs: the P1 re-discretization
on the global element-vertex grid and the geometric coarsen-by-2 Galerkin
chain (``coarsen_chain_info`` / ``vertex_q1_hierarchy``). Host float64
numpy/scipy; device packing lives in amg/vcycle.py. ``save_chain_info``
and ``load_chain_info`` are the port's copy of the JAX package's vertex-
chain checkpoint (``runtime/checkpoint.py``), the same npz layout. The
assembled composite FEM hierarchy (inner="fem-amg") belongs to a later
slice.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .fem import p1_stiffness_grid

__all__ = ["coarsen_chain_info", "vertex_q1_hierarchy", "save_chain_info",
           "load_chain_info"]


def _grid_map_1d(m: int, o: int) -> np.ndarray:
    """Lattice index (m*n points, n = o+1, duplicated faces) for each
    assembled grid node (m*o + 1 shared nodes)."""
    g = np.arange(m * o + 1)
    e = np.minimum(g // o, m - 1)
    return (e * (o + 1) + (g - e * o)).astype(np.int64)


def _layer_lattice(mesh, q: int, plane_shape, dim: int, field) -> np.ndarray:
    """One physical element layer of an order-o mesh as a point lattice
    (n, my*n, mx*n[, F])."""
    from ..mesh.layout import elements_to_lattice
    n = mesh.poly_degree + 1
    plane = int(np.prod(plane_shape))
    a = np.asarray(field)
    return elements_to_lattice(a[q * plane:(q + 1) * plane],
                               (1,) + tuple(plane_shape), n, dim)


def _block_grid_coords(mesh, q: int, plane_shape, dim: int) -> np.ndarray:
    """Assembled node-grid coordinates (o+1, my*o+1, mx*o+1, dim) for one
    physical element layer (in-plane duplicates removed)."""
    o = mesh.poly_degree
    lat = _layer_lattice(mesh, q, plane_shape, dim, mesh.coords)
    maps = [np.arange(o + 1)] + [_grid_map_1d(ps, o) for ps in plane_shape]
    return lat[np.ix_(*maps)]


def _power_lmax(A: sp.csr_matrix, iters: int = 25, seed: int = 7) -> float:
    """lambda_max(D^{-1} A) by power iteration, padded by 5% (power
    iteration converges from below; Chebyshev needs an upper bound)."""
    d = A.diagonal()
    invd = np.where(d > 0, 1.0 / d, 0.0)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(A.shape[0])
    lam = 1.0
    for _ in range(iters):
        w = invd * (A @ v)
        lam = np.linalg.norm(w)
        if lam == 0.0:
            return 1.0
        v = w / lam
    return float(1.05 * lam)


def _mask_fold(A: sp.csr_matrix, mask: np.ndarray) -> sp.csr_matrix:
    """Dirichlet elimination by value (pattern-preserving): zero masked
    rows/cols, unit diagonal on masked DOFs."""
    A = A.tocsr(copy=True)
    row_m = np.repeat(mask, np.diff(A.indptr))
    A.data *= row_m * mask[A.indices]
    A = A + sp.diags(1.0 - mask)
    A.sum_duplicates()
    return A.tocsr()


def _coarsen_interp_1d(nf: int) -> sp.csr_matrix:
    """1-D linear interpolation from the every-other-node coarse grid
    (endpoints always kept) to the nf-node fine grid."""
    cidx = list(range(0, nf, 2))
    if cidx[-1] != nf - 1:
        cidx.append(nf - 1)
    cpos = {f: c for c, f in enumerate(cidx)}
    rows, cols, vals = [], [], []
    for f in range(nf):
        if f in cpos:
            rows.append(f); cols.append(cpos[f]); vals.append(1.0)
        else:
            rows += [f, f]
            cols += [cpos[f - 1], cpos[f + 1]]
            vals += [0.5, 0.5]
    return sp.csr_matrix((vals, (rows, cols)), shape=(nf, len(cidx)))


def _grid_boundary_mask(shape) -> np.ndarray:
    m = np.ones(shape)
    for d in range(len(shape)):
        sl = [slice(None)] * len(shape)
        sl[d] = 0
        m[tuple(sl)] = 0.0
        sl[d] = shape[d] - 1
        m[tuple(sl)] = 0.0
    return m.reshape(-1)


def coarsen_chain_info(A0, grid_shape, max_coarse: int = 600) -> dict:
    """Geometric coarsen-by-2 Galerkin chain on a tensor node grid.

    A0 must already be Dirichlet-folded on the grid boundary. Returns a
    dict with mats (level CSR, A0 first), shapes, masks (1 interior / 0
    Dirichlet), factors (per transfer, the 1-D interpolation factors
    [Pz, Py, Px]), prolongs (the masked kron prolongations), lmaxs
    (lambda_max(D^-1 A_l) per non-coarsest level) and coarse_inv (dense
    inverse of the coarsest matrix) — the same dict as the JAX package's.
    """
    shape = tuple(grid_shape)
    info = {"mats": [A0.tocsr()], "shapes": [shape],
            "masks": [_grid_boundary_mask(shape)], "factors": [],
            "prolongs": [], "lmaxs": [], "coarse_inv": None}
    while int(np.prod(shape)) > max_coarse and max(shape) > 2:
        Ps = [_coarsen_interp_1d(s) for s in shape]
        P = Ps[0]
        for Pd in Ps[1:]:
            P = sp.kron(P, Pd, format="csr")
        cshape = tuple(Pd.shape[1] for Pd in Ps)
        cmask = _grid_boundary_mask(cshape)
        # mask P on both sides so boundary values never couple through RAP
        fmask = _grid_boundary_mask(shape)
        P = sp.diags(fmask) @ P @ sp.diags(cmask)
        Ac = _mask_fold((P.T @ info["mats"][-1] @ P).tocsr(), cmask)
        info["lmaxs"].append(_power_lmax(info["mats"][-1]))
        info["factors"].append([Pd.toarray() for Pd in Ps])
        info["prolongs"].append(P.tocsr())
        info["mats"].append(Ac)
        info["shapes"].append(cshape)
        info["masks"].append(cmask)
        shape = cshape
    info["coarse_inv"] = np.linalg.inv(info["mats"][-1].toarray())
    return info


def vertex_q1_hierarchy(mesh_order1, plane_shape, m_last: int, dim: int,
                        max_coarse: int = 600) -> dict:
    """P1 hierarchy on the global element-vertex grid of the order-1 mesh:
    direct P1 re-discretization on the warped vertex grid plus the
    coarsen-by-2 Galerkin chain (coarsen_chain_info)."""
    plane_shape = tuple(plane_shape)
    blocks = [_block_grid_coords(mesh_order1, q, plane_shape, dim)
              for q in range(m_last)]
    X = np.concatenate([blocks[0]] + [b[1:] for b in blocks[1:]], axis=0)
    vert_shape = (m_last + 1,) + tuple(ps + 1 for ps in plane_shape)
    if X.shape[:-1] != vert_shape:
        raise ValueError(f"vertex grid {X.shape[:-1]} != {vert_shape}")
    A1 = _mask_fold(p1_stiffness_grid(X), _grid_boundary_mask(vert_shape))
    return coarsen_chain_info(A1, vert_shape, max_coarse=max_coarse)


def _pack_csr(d: dict, key: str, m: sp.csr_matrix):
    d[f"{key}.data"] = m.data
    d[f"{key}.indices"] = m.indices
    d[f"{key}.indptr"] = m.indptr
    d[f"{key}.shape"] = np.asarray(m.shape)


def _unpack_csr(z, key: str) -> sp.csr_matrix:
    return sp.csr_matrix(
        (z[f"{key}.data"], z[f"{key}.indices"], z[f"{key}.indptr"]),
        shape=tuple(z[f"{key}.shape"]))


def save_chain_info(path: str, info: dict):
    """Vertex-chain checkpoint (coarsen_chain_info output: level CSRs,
    transfer factors, masks, Chebyshev bounds, dense coarse inverse) as
    raw npz; ``path`` should end in ``.npz`` (numpy appends it otherwise)."""
    d = {"num_levels": np.asarray(len(info["mats"])),
         "lmaxs": np.asarray(info["lmaxs"]),
         "coarse_inv": info["coarse_inv"]}
    for l, m in enumerate(info["mats"]):
        _pack_csr(d, f"A{l}", m.tocsr())
    for l, m in enumerate(info["prolongs"]):
        _pack_csr(d, f"P{l}", m.tocsr())
    for l, s in enumerate(info["shapes"]):
        d[f"shape{l}"] = np.asarray(s)
    for l, m in enumerate(info["masks"]):
        d[f"mask{l}"] = m
    for l, fs in enumerate(info["factors"]):
        for k, F in enumerate(fs):
            d[f"fac{l}.{k}"] = F
    np.savez_compressed(path, **d)


def load_chain_info(path: str) -> dict:
    with np.load(path) as z:
        L = int(z["num_levels"])
        dim = len(z["shape0"])
        return {
            "mats": [_unpack_csr(z, f"A{l}") for l in range(L)],
            "prolongs": [_unpack_csr(z, f"P{l}") for l in range(L - 1)],
            "shapes": [tuple(int(x) for x in z[f"shape{l}"])
                       for l in range(L)],
            "masks": [z[f"mask{l}"] for l in range(L)],
            "factors": [[z[f"fac{l}.{k}"] for k in range(dim)]
                        for l in range(L - 1)],
            "lmaxs": list(z["lmaxs"]),
            "coarse_inv": z["coarse_inv"],
        }
