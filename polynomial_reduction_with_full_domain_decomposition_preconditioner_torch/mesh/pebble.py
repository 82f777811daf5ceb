"""Pebble-bed-style unstructured hex meshes.

The port's own copy of the JAX package's ``mesh/pebble.py`` (3-D; host
numpy / scipy, the geometric factors by the port's ``geometric_factors``
on ``device``). Hex meshes of the fluid region around packed spherical
pebbles, the class of the Nek5000 pebble-bed exports (PB_146 / PB_1568):
holes, variable vertex valence, elements meeting in arbitrary
configurations. Generated from a seed:

1. pack ``num_pebbles`` non-overlapping spheres into the unit box
   (deterministic rejection sampling from ``seed``);
2. voxelize on an ``elem_shape`` element lattice: drop every element
   whose center falls inside a pebble, keep the largest face-connected
   component of the remainder;
3. body-fit: project lattice vertices that fall inside a pebble onto its
   surface (relaxed by ``snap``), then place interior GLL nodes by
   trilinear blending (every element a straight-sided hex with positive
   Jacobian; ``snap`` is relaxed if a cut element would invert);
4. Dirichlet on every boundary face: the outer box and the pebble
   surfaces.

The result is a ``GlobalMesh`` with ``structured_layout=False``, what the
unstructured composite (solvers/unstructured.py) takes. Mesh decisions
depend only on ``(elem_shape, num_pebbles, seed, ...)``, not the order,
so ``lambda o: pebble_mesh(shape, o, ...)`` is an order-consistent
``mesh_builder`` for the composite setup.
"""

from __future__ import annotations

import numpy as np

from .generator import (GlobalMesh, _reference_coords, _trilinear_nodes,
                        geometric_factors)

__all__ = ["pebble_mesh", "pack_pebbles"]


def pack_pebbles(elem_shape, num_pebbles: int, seed: int = 0,
                 solid_fraction: float = 0.25):
    """Deterministically pack ``num_pebbles`` equal spheres into the unit
    box: radius from the target ``solid_fraction`` of the volume, centers
    by rejection sampling with a half-voxel clearance (pebbles may touch
    the walls but not cut them). Returns (centers (K, dim), radius) with
    K <= num_pebbles (as many as fit)."""
    dim = len(elem_shape)
    rng = np.random.default_rng(seed)
    h = max(1.0 / m for m in elem_shape)
    if dim == 2:
        r = float(np.sqrt(solid_fraction / (np.pi * num_pebbles)))
    else:
        r = float((solid_fraction * 3.0 / (4.0 * np.pi * num_pebbles))
                  ** (1.0 / 3.0))
    r = min(r, 0.25)
    lo, hi = r + 0.5 * h, 1.0 - r - 0.5 * h
    if hi <= lo:
        raise ValueError(f"pebble radius {r:.3f} too large for the unit "
                         f"box at lattice {elem_shape}")
    # grid-hash accept/reject: candidates only check the 3^dim neighbor
    # cells of a uniform grid with cell >= the exclusion diameter, so
    # packing PB_1568-class counts stays O(K) instead of the O(K^2)
    # all-pairs scan (which took hours at ~1.5k pebbles)
    dmin = 2.0 * r + 0.5 * h
    ncell = max(1, int(1.0 / dmin))
    cell_of: dict[tuple, list[int]] = {}
    centers: list[np.ndarray] = []
    for _ in range(400 * num_pebbles):
        if len(centers) == num_pebbles:
            break
        c = rng.uniform(lo, hi, size=dim)
        key = tuple((c * ncell).astype(np.int64))
        ok = True
        for off in np.ndindex(*(3,) * dim):
            nb = tuple(k + o - 1 for k, o in zip(key, off))
            for i in cell_of.get(nb, ()):
                if np.linalg.norm(c - centers[i]) < dmin:
                    ok = False
                    break
            if not ok:
                break
        if ok:
            cell_of.setdefault(key, []).append(len(centers))
            centers.append(c)
    return np.asarray(centers, dtype=np.float64).reshape(-1, dim), r


def _largest_component(keep, elem_shape):
    """Largest face-connected component of the kept-cell lattice."""
    from scipy import ndimage
    dim = len(elem_shape)
    lattice = keep.reshape(tuple(reversed(elem_shape)))  # (mz, my, mx)
    structure = ndimage.generate_binary_structure(dim, 1)  # faces only
    labels, num = ndimage.label(lattice, structure=structure)
    if num <= 1:
        return keep
    sizes = np.bincount(labels.ravel())
    sizes[0] = 0
    return (labels == sizes.argmax()).reshape(-1)


def _boundary_node_mask(glo, keep_lattice, kept_ids, elem_shape,
                        poly_degree, num_nodes):
    """Node mask: 0 on every node of a face with no kept neighbor (outer
    box faces and pebble surfaces). Computed per NODE then broadcast per
    element so shared edge/corner nodes are consistently masked."""
    dim = len(elem_shape)
    n = poly_degree + 1
    lattice = keep_lattice.reshape(tuple(reversed(elem_shape)))
    # lattice multi-index (reversed storage order: z slowest) per kept elem
    rev = np.indices(tuple(reversed(elem_shape)))
    multi = [rev[a].reshape(-1)[kept_ids] for a in range(dim)]  # z, y, x

    # local node ids of each face: dim d (0=x..), storage axis dim-1-d
    local = np.indices((n,) * dim).reshape(dim, -1)  # (dim, npe) z..x order
    face_nodes = {}
    for d in range(dim):
        a = dim - 1 - d
        face_nodes[(d, 0)] = np.flatnonzero(local[a] == 0)
        face_nodes[(d, 1)] = np.flatnonzero(local[a] == n - 1)

    nodemask = np.ones(num_nodes)
    Ek = kept_ids.size
    for d in range(dim):
        a = dim - 1 - d
        for side, step in ((0, -1), (1, +1)):
            nb = [m.copy() for m in multi]
            nb[a] = nb[a] + step
            inb = (nb[a] >= 0) & (nb[a] < lattice.shape[a])
            has = np.zeros(Ek, dtype=bool)
            if inb.any():
                has[inb] = lattice[tuple(m[inb] for m in nb)]
            bdry = np.flatnonzero(~has)
            if bdry.size:
                ids = glo[bdry][:, face_nodes[(d, side)]]
                nodemask[ids.ravel()] = 0.0
    return nodemask


def pebble_mesh(elem_shape, poly_degree, num_pebbles: int = 8,
                seed: int = 0, solid_fraction: float = 0.25,
                snap: float = 1.0, device=None) -> GlobalMesh:
    """Generate a pebble-bed-style unstructured hex mesh (see module doc).

    elem_shape: background element lattice (the void carving resolution);
    snap: 0..1 strength of the vertex projection onto pebble surfaces
    (relaxed automatically if a cut element would invert); device: where
    the geometric factors are computed (None: the card).
    """
    dim = len(elem_shape)
    n = poly_degree + 1
    npe = n ** dim
    centers, r = pack_pebbles(elem_shape, num_pebbles, seed, solid_fraction)

    # element centers in the flat (x fastest) ordering of _reference_coords
    rev = np.indices(tuple(reversed(elem_shape)))
    emulti = [rev[dim - 1 - d].reshape(-1) for d in range(dim)]  # x, y, z
    cpts = np.stack([(emulti[d] + 0.5) / elem_shape[d]
                     for d in range(dim)], axis=-1)
    if len(centers):
        from scipy.spatial import cKDTree
        dmin_c, _ = cKDTree(centers).query(cpts, workers=-1)
        keep = dmin_c > r
    else:
        keep = np.ones(cpts.shape[0], dtype=bool)
    keep = _largest_component(keep, elem_shape)
    kept_ids = np.flatnonzero(keep)
    if kept_ids.size == 0:
        raise ValueError("pebble carving removed every element")

    # pebbles are disjoint (packing enforces a gap), so a point inside a
    # pebble is inside its NEAREST center's pebble — one KD-tree query
    # replaces the per-center sweep (O(K * points) -> O(points log K),
    # the scaling that makes PB_1568-class counts practical)
    from scipy.spatial import cKDTree
    ctree = cKDTree(centers) if len(centers) else None

    def make_vtransform(s):
        def vtransform(x, y, z):
            pts = [np.array(x, dtype=np.float64, copy=True),
                   np.array(y, dtype=np.float64, copy=True)]
            if z is not None:
                pts.append(np.array(z, dtype=np.float64, copy=True))
            P = np.stack(pts, axis=-1)
            if ctree is not None:
                flat = P.reshape(-1, dim)
                d, which = ctree.query(flat, workers=-1)
                inside = np.flatnonzero(d < r)
                if inside.size:
                    c = centers[which[inside]]
                    dd = np.maximum(d[inside], 1e-12)[:, None]
                    proj = c + (flat[inside] - c) * (r / dd)
                    flat[inside] += s * (proj - flat[inside])
                P = flat.reshape(P.shape)
            out = [P[..., i] for i in range(dim)]
            return out[0], out[1], (out[2] if dim == 3 else None)
        return vtransform

    # the snap strength is an ORDER-INVARIANT mesh decision (the
    # composite's mesh_builder contract needs identical vertex frames at
    # every order), so the inversion retry runs at a FIXED probe order
    # — dense enough that a positive-Jacobian probe mesh is positive in
    # practice at any production order
    probe_order = 6
    for attempt in range(6):
        coords_p = _trilinear_nodes(elem_shape, probe_order,
                                    make_vtransform(snap))[kept_ids]
        _, mass_p = geometric_factors(coords_p, dim, probe_order,
                                      device=device)
        if mass_p.min() > 0:
            break
        snap *= 0.5  # a cut element inverted: relax the projection
    else:
        raise ValueError("pebble vertex snap produces inverted elements "
                         "even at snap~0; coarsen the lattice or shrink "
                         "the pebbles")

    # full-lattice structured numbering + coords, then subset
    _, glo_full, _ = _reference_coords(elem_shape, poly_degree)
    glo_sub = glo_full.reshape(-1, npe)[kept_ids]
    coords = _trilinear_nodes(elem_shape, poly_degree,
                              make_vtransform(snap))[kept_ids]
    geom, mass = geometric_factors(coords, dim, poly_degree, device=device)
    if mass.min() <= 0:
        # never relax per-order (that would silently break cross-order
        # frame consistency) — surface it instead
        raise ValueError(
            f"pebble mesh inverts at order {poly_degree} with the snap "
            f"validated at probe order {probe_order}; pass a smaller "
            "snap= explicitly")

    uniq, inv = np.unique(glo_sub.ravel(), return_inverse=True)
    glo_new = inv.reshape(-1, npe).astype(np.int64)
    NN = uniq.size
    degree = np.bincount(glo_new.ravel(), minlength=NN)
    node_degree = degree[glo_new].astype(np.int32)

    nodemask = _boundary_node_mask(glo_new, keep, kept_ids, elem_shape,
                                   poly_degree, NN)
    mask = nodemask[glo_new]

    return GlobalMesh(
        dim=dim,
        poly_degree=poly_degree,
        elem_shape=tuple(elem_shape),
        coords=coords,
        glo_num=glo_new,
        node_degree=node_degree,
        dirichlet_mask=mask,
        geom=geom,
        mass=mass,
        structured_layout=False,
    )
