"""Structured spectral-element mesh generation (box and Kershaw meshes).

Port of the JAX package's ``mesh/generator.py`` for 2-D and 3-D meshes,
with ``scramble_mesh``, which turns a structured mesh into one of unstructured
connectivity (the unstructured composite's mesh family). Node numbering,
Dirichlet mask and multiplicities are host numpy, as there; the geometric
factors run in torch float64 on the device the mesh is built for (the
H100 has native f64), with the arithmetic of the reference's numpy form
``_geometric_factors_np``.

Local intra-element ordering: arrays are stored (..., n_z, n_y, n_x) so
that raveling gives ``v = i + j*n + k*n^2`` with the x-index fastest.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..utils.gll import gll_points_weights, diff_matrix

__all__ = ["GlobalMesh", "box_mesh", "kershaw_mesh", "geometric_factors",
           "scramble_mesh"]


@dataclass
class GlobalMesh:
    """A complete spectral-element mesh, all elements, host numpy arrays.

    Per-element arrays use local ordering v = i + j*n (+ k*n^2), x
    fastest. ``geom`` holds [G_rr, G_ss, G_rs] in 2-D and [G_rr, G_ss,
    G_tt, G_rs, G_rt, G_st] in 3-D, with GLL weights and |J| folded in.
    """

    dim: int
    poly_degree: int
    elem_shape: tuple[int, ...]       # elements per dimension (mx, my[, mz])
    coords: np.ndarray                # (E, npe, dim) nodal coordinates
    glo_num: np.ndarray               # (E, npe) int64 global node ids
    node_degree: np.ndarray           # (E, npe) int32 global multiplicity
    dirichlet_mask: np.ndarray        # (E, npe) float, 0.0 on the boundary
    geom: np.ndarray                  # (E, npe, 3 or 6) geometric factors
    mass: np.ndarray | None = None    # (E, npe) diagonal GLL mass w * |J|
    structured_layout: bool = True    # elements stored in slab order

    @property
    def num_elements(self) -> int:
        return self.coords.shape[0]

    @property
    def num_points_per_elem(self) -> int:
        return self.coords.shape[1]

    @property
    def num_points(self) -> int:
        return self.coords.shape[0] * self.coords.shape[1]

    @property
    def num_nodes(self) -> int:
        return int(self.glo_num.max()) + 1

    @property
    def num_geom(self) -> int:
        return self.geom.shape[-1]

    @classmethod
    def from_numpy(cls, *, coords, geom, dirichlet_mask, node_degree,
                   elem_shape, poly_degree, mass=None) -> "GlobalMesh":
        """A mesh from host arrays of the same names and layout — e.g. the
        JAX package's ``GlobalMesh`` fields — so both packages can be fed
        the identical problem. The global numbering is rebuilt from
        ``elem_shape`` and ``poly_degree`` (structured slab order)."""
        elem_shape = tuple(int(m) for m in elem_shape)
        _, glo_num, _ = _reference_coords(elem_shape, int(poly_degree))
        coords = np.asarray(coords, dtype=np.float64)
        E, npe = coords.shape[:2]
        return cls(
            dim=len(elem_shape),
            poly_degree=int(poly_degree),
            elem_shape=elem_shape,
            coords=coords,
            glo_num=glo_num.reshape(E, npe),
            node_degree=np.asarray(node_degree, dtype=np.int32),
            dirichlet_mask=np.asarray(dirichlet_mask, dtype=np.float64),
            geom=np.asarray(geom, dtype=np.float64),
            mass=None if mass is None else np.asarray(mass, np.float64),
        )


def _reference_coords(elem_shape, poly_degree):
    """Unit-box nodal coordinates and global numbering for a structured mesh.

    Returns (coords_axes, glo_num, gdims): coords_axes is a list of per-dim
    (E, n_z, n_y, n_x)-shaped nodal coordinates in [0, 1].
    """
    dim = len(elem_shape)
    n = poly_degree + 1
    r, _ = gll_points_weights(n)
    t = (r + 1.0) / 2.0  # GLL nodes mapped to [0, 1]

    axes_1d = [(np.arange(m)[:, None] + t[None, :]) / m for m in elem_shape]
    # per-dimension global 1-D node index (shared at element interfaces)
    gidx_1d = [np.arange(m)[:, None] * poly_degree + np.arange(n)[None, :]
               for m in elem_shape]
    gdims = [m * poly_degree + 1 for m in elem_shape]

    # element ordering: x fastest (e = ex + ey*mx + ez*mx*my)
    rev = np.indices(tuple(reversed(elem_shape)))
    elem_multi = [rev[dim - 1 - d].reshape(-1) for d in range(dim)]

    E = int(np.prod(elem_shape))
    shape_local = (n,) * dim  # (n_z, n_y, n_x) storage order
    coords_axes = [np.empty((E,) + shape_local) for _ in range(dim)]
    glo_num = np.empty((E,) + shape_local, dtype=np.int64)
    for d in range(dim):
        shp = [1] * dim
        shp[dim - 1 - d] = n
        coords_axes[d][:] = axes_1d[d][elem_multi[d]].reshape((E,) + tuple(shp))

    g_parts = []
    stride = 1
    for d in range(dim):
        gi = gidx_1d[d][elem_multi[d]]  # (E, n) global 1-D index along dim d
        shp = [1] * dim
        shp[dim - 1 - d] = n
        g_parts.append(gi.reshape((E,) + tuple(shp)) * stride)
        stride *= gdims[d]
    glo_num[:] = sum(g_parts)
    return coords_axes, glo_num, gdims


def _kershaw_right(eps, x):
    return np.where(x <= 0.5, (2.0 - eps) * x, 1.0 + eps * (x - 1.0))


def _kershaw_left(eps, x):
    return 1.0 - _kershaw_right(eps, 1.0 - x)


def _kershaw_step(a, b, x):
    x = np.clip(x, 0.0, 1.0)
    s = x * x * x * (x * (6.0 * x - 15.0) + 10.0)  # smootherstep
    return a + (b - a) * s


def kershaw_transform(eps_y, eps_z, x, y, z=None):
    """The standard 6-layer Kershaw warp of the unit box (the public
    CEED/MFEM definition)."""
    layer = np.minimum((x * 6.0).astype(np.int64), 5)
    lam = x * 6.0 - layer

    def warp(eps, c):
        lo, hi = _kershaw_left(eps, c), _kershaw_right(eps, c)
        out = np.where(layer == 0, lo, 0.0)
        out = np.where((layer == 1) | (layer == 4), _kershaw_step(lo, hi, lam), out)
        out = np.where(layer == 2, _kershaw_step(hi, lo, lam / 2.0), out)
        out = np.where(layer == 3, _kershaw_step(hi, lo, (1.0 + lam) / 2.0), out)
        out = np.where(layer == 5, hi, out)
        return out

    Y = warp(eps_y, y)
    Z = warp(eps_z, z) if z is not None else None
    return x, Y, Z


_CHUNK_ELEMS = 8192   # elements per device pass of geometric_factors


def geometric_factors(coords: np.ndarray, dim: int, poly_degree: int,
                      device=None):
    """SEM geometric factors G = w |J| (J^{-1} J^{-T}) in torch float64.

    ``coords`` is (E, npe, dim). Returns host numpy ``(geom, mass)``: geom
    (E, npe, 3) ordered [G_rr, G_ss, G_rs] in 2-D, (E, npe, 6) ordered
    [G_rr, G_ss, G_tt, G_rs, G_rt, G_st] in 3-D; mass the (E, npe) lumped
    mass w |J|. Runs on ``device`` (None: the card), chunked over
    elements, with the operation order of the reference's numpy form
    (closed-form adjugate inverse).
    """
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    device = resolve_device(device)
    n = poly_degree + 1
    npe = n ** dim
    E = coords.shape[0]
    f64 = torch.float64
    Dt = torch.as_tensor(diff_matrix(n).T, dtype=f64, device=device)
    _, w = gll_points_weights(n)
    wq = w
    for _ in range(dim - 1):
        wq = np.multiply.outer(w, wq)              # (n_z,) n_y, n_x
    wq = torch.as_tensor(wq, dtype=f64, device=device)
    if dim == 2:
        pairs = [(0, 0), (1, 1), (0, 1)]
    else:
        pairs = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]
    X_all = np.asarray(coords, dtype=np.float64).reshape((E,) + (n,) * dim
                                                         + (dim,))
    g_out = np.empty((E, npe, len(pairs)))
    m_out = np.empty((E, npe))
    for s in range(0, E, _CHUNK_ELEMS):
        e = min(s + _CHUNK_ELEMS, E)
        X = torch.as_tensor(X_all[s:e], device=device)
        # J[..., d, a] = d x_d / d r_a; r_a along storage axis dim - a
        J = torch.stack([torch.movedim(torch.tensordot(X, Dt, dims=([dim - a], [0])),
                                       -1, dim - a)
                         for a in range(dim)], dim=-1)
        if dim == 2:
            a_, b_ = J[..., 0, 0], J[..., 0, 1]
            c_, d_ = J[..., 1, 0], J[..., 1, 1]
            detJ = a_ * d_ - b_ * c_
            Jinv = torch.stack([torch.stack([d_, -b_], -1),
                                torch.stack([-c_, a_], -1)], dim=-2)
        else:
            c00 = J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1]
            c01 = J[..., 1, 2] * J[..., 2, 0] - J[..., 1, 0] * J[..., 2, 2]
            c02 = J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0]
            detJ = J[..., 0, 0] * c00 + J[..., 0, 1] * c01 + J[..., 0, 2] * c02
            r0 = torch.stack([
                c00,
                J[..., 0, 2] * J[..., 2, 1] - J[..., 0, 1] * J[..., 2, 2],
                J[..., 0, 1] * J[..., 1, 2] - J[..., 0, 2] * J[..., 1, 1]], -1)
            r1 = torch.stack([
                c01,
                J[..., 0, 0] * J[..., 2, 2] - J[..., 0, 2] * J[..., 2, 0],
                J[..., 0, 2] * J[..., 1, 0] - J[..., 0, 0] * J[..., 1, 2]], -1)
            r2 = torch.stack([
                c02,
                J[..., 0, 1] * J[..., 2, 0] - J[..., 0, 0] * J[..., 2, 1],
                J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]], -1)
            Jinv = torch.stack([r0, r1, r2], dim=-2)
        Jinv = Jinv / detJ[..., None, None]
        Gfull = torch.einsum("...ad,...bd->...ab", Jinv, Jinv) \
            * detJ[..., None, None]
        Gfull = Gfull * wq[None, ..., None, None]
        g = torch.stack([Gfull[..., a, b] for a, b in pairs], dim=-1)
        mass = wq[None] * detJ
        g_out[s:e] = g.reshape(e - s, npe, len(pairs)).cpu().numpy()
        m_out[s:e] = mass.reshape(e - s, npe).cpu().numpy()
    return g_out, m_out


def _trilinear_nodes(elem_shape, poly_degree, vertex_transform):
    """Nodal coordinates for a vertex-warped mesh: the warp moves element
    vertices only; interior GLL nodes are placed by d-linear blending,
    so every element is a bilinear quad (2-D) or a trilinear hex (3-D).
    ``vertex_transform(x, y, z)`` gets z None in 2-D."""
    dim = len(elem_shape)
    n = poly_degree + 1
    r, _ = gll_points_weights(n)
    t = (r + 1.0) / 2.0
    blend = np.stack([1.0 - t, t], axis=0)  # (2, n)

    grids = np.meshgrid(*[np.arange(m + 1) / m for m in elem_shape],
                        indexing="ij")
    if dim == 2:
        wx, wy, _ = vertex_transform(grids[0], grids[1], None)
        verts = np.stack([wx, wy], axis=-1)
    else:
        verts = np.stack(vertex_transform(*grids), axis=-1)

    rev = np.indices(tuple(reversed(elem_shape)))
    emulti = [rev[dim - 1 - d].reshape(-1) for d in range(dim)]
    E = int(np.prod(elem_shape))
    corners = np.empty((E,) + (2,) * dim + (dim,))
    for c in np.ndindex(*(2,) * dim):
        sel = tuple(emulti[d] + c[d] for d in range(dim))
        corners[(slice(None),) + c] = verts[sel]

    # contract the corner axes (x, y[, z]) with the blend; the appended
    # node axes come out (E, dim, n_x, n_y[, n_z]) -> storage (E[, n_z],
    # n_y, n_x, dim)
    out = corners
    for _ in range(dim):
        out = np.tensordot(out, blend, axes=([1], [0]))
    out = np.transpose(out, (0,) + tuple(range(dim + 1, 1, -1)) + (1,))
    return out.reshape(E, n ** dim, dim)


def _build(elem_shape, poly_degree, transform=None, vertex_transform=None,
           device=None) -> GlobalMesh:
    dim = len(elem_shape)
    if dim not in (2, 3):
        raise ValueError(f"a mesh is 2-D or 3-D, got elem_shape {elem_shape}")
    npe = (poly_degree + 1) ** dim
    coords_axes, glo_num, gdims = _reference_coords(elem_shape, poly_degree)
    E = glo_num.shape[0]

    if transform is not None:
        coords_axes = transform(coords_axes)
    if vertex_transform is not None:
        coords = _trilinear_nodes(elem_shape, poly_degree, vertex_transform)
    else:
        coords = np.stack([c.reshape(E, npe) for c in coords_axes], axis=-1)
    glo_flat = glo_num.reshape(E, npe)

    degree_global = np.bincount(glo_flat.ravel(),
                                minlength=int(glo_flat.max()) + 1)
    node_degree = degree_global[glo_flat].astype(np.int32)

    # Dirichlet on the whole outer boundary (0 on boundary nodes)
    gids = glo_flat.copy()
    mask = np.ones((E, npe))
    for d in range(dim):
        gi = gids % gdims[d]
        mask *= (gi != 0) & (gi != gdims[d] - 1)
        gids //= gdims[d]

    geom, mass = geometric_factors(coords, dim, poly_degree, device=device)
    return GlobalMesh(dim=dim, poly_degree=poly_degree,
                      elem_shape=tuple(elem_shape), coords=coords,
                      glo_num=glo_flat, node_degree=node_degree,
                      dirichlet_mask=mask, geom=geom, mass=mass)


def box_mesh(elem_shape, poly_degree, extent=None, device=None) -> GlobalMesh:
    """Uniform box mesh of [0,e_0] x [0,e_1] (x [0,e_2]): the unit square
    or cube when ``extent`` is None."""
    elem_shape = tuple(elem_shape)
    if extent is None:
        return _build(elem_shape, poly_degree, device=device)
    extent = tuple(extent)

    def transform(axes):
        return [a * e for a, e in zip(axes, extent)]

    return _build(elem_shape, poly_degree, transform=transform, device=device)


def kershaw_mesh(elem_shape, poly_degree, epsilon=0.3, extent=None,
                 device=None) -> GlobalMesh:
    """Kershaw-warped box mesh: epsilon=1.0 gives the uniform box, smaller
    epsilon a higher distortion (in 2-D only y is warped). ``extent``
    scales the physical domain after the warp (the unit square or cube
    when None). The geometric factors are computed on ``device``."""
    ext = tuple(extent) if extent is not None else None

    def vtransform(x, y, z):
        X, Y, Z = kershaw_transform(epsilon, epsilon, x, y, z)
        if ext is not None:
            X, Y = X * ext[0], Y * ext[1]
            if Z is not None:
                Z = Z * ext[2]
        return X, Y, Z

    return _build(tuple(elem_shape), poly_degree,
                  vertex_transform=vtransform, device=device)


# ---------------------------------------------------------------------------
# unstructured-connectivity scrambling


def _proper_rotations(dim: int):
    """All orientation-preserving symmetries of the square (4) / cube (24)
    as (axis_perm, flip) pairs acting on local (z, y, x) index tuples."""
    import itertools
    rots = []
    for perm in itertools.permutations(range(dim)):
        for flips in itertools.product((False, True), repeat=dim):
            # the signed permutation's determinant must be +1: the
            # permutation's parity times one sign per flip
            sign = 1
            seen = [False] * dim
            for i in range(dim):
                if seen[i]:
                    continue
                j, clen = i, 0
                while not seen[j]:
                    seen[j] = True
                    j = perm[j]
                    clen += 1
                if clen % 2 == 0:
                    sign = -sign
            for f in flips:
                if f:
                    sign = -sign
            if sign == 1:
                rots.append((perm, flips))
    return rots


def _rotation_node_perm(perm, flips, n: int, dim: int) -> np.ndarray:
    """Node permutation P with new_data[P] = old_data, i.e.
    new_data[v'] = old_data[v] where v' is v's rotated position."""
    idx = np.indices((n,) * dim).reshape(dim, -1)      # old (z, y, x)
    new_idx = np.empty_like(idx)
    for d in range(dim):
        src = idx[perm[d]]
        new_idx[d] = (n - 1 - src) if flips[d] else src
    vnew = np.zeros(idx.shape[1], dtype=np.int64)      # x fastest
    for d in range(dim):
        vnew = vnew * n + new_idx[d]
    out = np.empty(n ** dim, dtype=np.int64)
    out[vnew] = np.arange(n ** dim)
    return out


def scramble_mesh(mesh: GlobalMesh, seed: int = 0, permute: bool = True,
                  device=None) -> GlobalMesh:
    """Destroy the structured element layout: a random element permutation
    and a random proper rotation of every element's local frame. With
    ``permute=False`` only the local frames rotate: elements keep their
    spatial order, so contiguous partitions stay localized while
    neighbours still meet in arbitrary orientations. The geometry is
    exact (recomputed by ``geometric_factors`` on ``device``), so
    solutions compare with the structured original's.

    The decisions depend only on (num_elements, seed), not on the order:
    ``scramble_mesh(mesh_builder(o), seed)`` gives element-wise consistent
    meshes at every order, as the composite's mesh builder must.
    """
    dim = mesh.dim
    n = mesh.poly_degree + 1
    E = mesh.num_elements
    rng = np.random.default_rng(seed)
    elem_perm = rng.permutation(E) if permute else np.arange(E)
    rots = _proper_rotations(dim)
    rot_choice = rng.integers(0, len(rots), size=E)
    node_perms = np.stack([_rotation_node_perm(p, f, n, dim)
                           for p, f in rots])
    # out[e] = arr[elem_perm[e]][node_perms[rot_choice[elem_perm[e]]]]
    rows = elem_perm[:, None]
    cols = node_perms[rot_choice[elem_perm]]

    def take(arr):
        return arr[rows, cols]

    coords = take(mesh.coords)
    geom, mass = geometric_factors(coords, dim, mesh.poly_degree,
                                   device=device)
    return GlobalMesh(dim=dim, poly_degree=mesh.poly_degree,
                      elem_shape=mesh.elem_shape, coords=coords,
                      glo_num=take(mesh.glo_num),
                      node_degree=take(mesh.node_degree),
                      dirichlet_mask=take(mesh.dirichlet_mask),
                      geom=geom, mass=mass, structured_layout=False)
