"""Low-order hierarchies of the composite problem (host setup).

Port of the JAX package's ``amg/composite.py``, host float64 numpy/scipy
with the reference's operations in the reference's order:

- the vertex chain of the matrix-free inner preconditioner
  (inner="amg"): the P1 re-discretization on the global element-vertex
  grid and the geometric coarsen-by-2 Galerkin chain
  (``coarsen_chain_info`` / ``vertex_q1_hierarchy``);
- the assembled composite FEM hierarchy (inner="fem-amg",
  ``build_composite_hierarchy``): per element-layer P1 assembly on the
  GLL node grids (exact SEM Q1 for order-1 layers), the plane
  merge/slave matrix C that folds shared and cross-order (hanging) planes
  onto DOFs, the composite lattice <-> DOF map Q, the P1 prolongation
  from the element-vertex grid and the same coarsen-by-2 chain below it;
  ``pad_hier_dofs`` pads ragged shards' hierarchies to one DOF count.

Device packing lives in amg/vcycle.py; the vertex chain's checkpoint in
runtime/checkpoint.py (``save_chain_info`` / ``load_chain_info``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

from ..utils.gll import gll_points_weights
from .fem import grid_interp_1d, p1_stiffness_grid, sem_element_matrices

__all__ = ["HostHierarchy", "build_composite_hierarchy",
           "coarsen_chain_info", "coarsen_matrix_chain", "pad_hier_dofs",
           "vertex_q1_hierarchy"]


@dataclass
class HostHierarchy:
    """Host-side multilevel hierarchy of one shard's composite problem."""
    mats: list              # level CSR matrices A_0..A_L (Dirichlet-folded)
    prolongs: list          # CSR P_l: level l+1 DOFs -> level l DOFs
    lmaxs: list             # Chebyshev lambda_max(D^{-1}A) per level 0..L-1
    coarse_inv: np.ndarray  # dense inverse of the coarsest matrix
    Q: sp.csr_matrix        # composite lattice points <- A_0 DOFs (scatter)
    dof_mask: np.ndarray    # (ndof0,) 1.0 interior / 0.0 Dirichlet
    # host seconds by build stage (build_composite_hierarchy fills it)
    setup_seconds: dict = field(default_factory=dict)


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


def _plane_kron(plane_shape, o_from: int, o_to: int) -> sp.csr_matrix:
    """In-plane interpolation (fine plane nodes <- coarse plane nodes) as a
    Kronecker product of 1-D grid interpolants: the hanging-plane
    constraint J (x) J in assembled form."""
    J = None
    for ps in plane_shape:
        J1 = grid_interp_1d(ps, o_from, o_to)
        J = J1 if J is None else sp.kron(J, J1, format="csr")
    return J.tocsr()


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


def coarsen_matrix_chain(A0, grid_shape, max_coarse: int = 600):
    """(mats, prolongs, lmaxs, coarse_inv) of coarsen_chain_info."""
    info = coarsen_chain_info(A0, grid_shape, max_coarse)
    return info["mats"], info["prolongs"], info["lmaxs"], info["coarse_inv"]


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


def pad_hier_dofs(hiers) -> None:
    """Pad per-shard hierarchies to a common level-0 DOF count (ragged slab
    partitions: shards with more own layers carry more fine-order blocks,
    hence more composite FEM DOFs). Pad DOFs are isolated unit-diagonal
    rows; smoothing and transfers leave them at zero. Levels >= 1 live on
    the shared element-vertex grid and already agree. In place."""
    nd = max(h.mats[0].shape[0] for h in hiers)
    for h in hiers:
        n0 = h.mats[0].shape[0]
        if n0 == nd:
            continue
        A = h.mats[0].tocsr(copy=True)
        A.resize((nd, nd))
        pad = sp.coo_matrix(
            (np.ones(nd - n0), (np.arange(n0, nd), np.arange(n0, nd))),
            shape=(nd, nd))
        h.mats[0] = (A + pad).tocsr()
        P0 = h.prolongs[0].tocsr(copy=True)
        P0.resize((nd, P0.shape[1]))
        h.prolongs[0] = P0
        Q = h.Q.tocsr(copy=True)
        Q.resize((Q.shape[0], nd))
        h.Q = Q
        dm = np.zeros(nd)
        dm[:n0] = h.dof_mask
        h.dof_mask = dm
        h.lmaxs[0] = max(h.lmaxs[0], 1.0)


def _q1_layer_grid_matrix(mesh1, q: int, plane_shape, dim: int) -> sp.csr_matrix:
    """Exact SEM Q1 matrix of one order-1 element layer, assembled on the
    layer's node grid (2, my+1, mx+1) (order-1 layers of the composite FEM
    matrix use it in place of the simplicial P1 approximation)."""
    plane_shape = tuple(plane_shape)
    plane = int(np.prod(plane_shape))
    sel = np.arange(q * plane, (q + 1) * plane)
    K = sem_element_matrices(mesh1.geom[sel], dim, 2)  # (plane, npe, npe)
    grid = (2,) + tuple(ps + 1 for ps in plane_shape)
    nid = np.arange(int(np.prod(grid)), dtype=np.int64).reshape(grid)
    npe = 2 ** dim
    ids = np.empty((plane, npe), dtype=np.int64)
    if dim == 3:
        my, mx = plane_shape
        ey, ex = np.divmod(np.arange(plane), mx)
        loc = 0
        for cz in range(2):
            for cy in range(2):
                for cx in range(2):
                    ids[:, loc] = nid[cz, ey + cy, ex + cx]
                    loc += 1
    else:
        (mx,) = plane_shape
        ex = np.arange(plane)
        loc = 0
        for cy in range(2):
            for cx in range(2):
                ids[:, loc] = nid[cy, ex + cx]
                loc += 1
    rows = np.repeat(ids, npe, axis=1).ravel()
    cols = np.tile(ids, (1, npe)).ravel()
    A = sp.coo_matrix((K.ravel(), (rows, cols)),
                      shape=(nid.size, nid.size)).tocsr()
    A.sum_duplicates()
    return A


def build_composite_hierarchy(groups, mesh_by_order, plane_shape, m_last: int,
                              base: int, dim: int,
                              max_coarse: int = 600,
                              phys_by_group=None) -> HostHierarchy:
    """Build one shard's composite FEM matrix and multilevel hierarchy.

    groups: layer group specs with .order/.layers/.start_pos (cyclic
      positions relative to the shard's own slab, solvers/subdomain.py).
    mesh_by_order: {order: GlobalMesh} for every order of the groups.
    plane_shape: element grid of a z-layer in storage order (my, mx).
    m_last: total element layers; base: the shard's first physical layer.
    phys_by_group: optional per-group physical-layer lists with -1 pad
      slots (ragged slab partitions); pad lattice slices map to zero rows
      of Q and no FEM block.
    """
    plane_shape = tuple(plane_shape)
    t0 = time.perf_counter()

    # ---- layer blocks in cyclic order (real slots only) ----
    block_order, block_phys, block_group = [], [], []
    blk_of = []              # per group: (g.layers,) block id or -1 (pad)
    for gi, g in enumerate(groups):
        arr = np.full(g.layers, -1, dtype=np.int64)
        for k in range(g.layers):
            if phys_by_group is None:
                q = (base + g.start_pos + k) % m_last
            else:
                q = phys_by_group[gi][k]
                if q < 0:
                    continue
            arr[k] = len(block_order)
            block_order.append(g.order)
            block_phys.append(q)
            block_group.append(gi)
        blk_of.append(arr)
    nblocks = len(block_order)
    if nblocks != m_last:
        raise ValueError(f"the groups hold {nblocks} real layers, "
                         f"the mesh {m_last}")
    # cyclic physical contiguity (the plane-merge invariant): block b's
    # top plane is block b+1's bottom plane
    for b in range(nblocks):
        if (block_phys[b] + 1) % m_last != block_phys[(b + 1) % nblocks]:
            raise ValueError("the groups' layers are not cyclically "
                             "contiguous")

    grid_shapes = [
        (o + 1,) + tuple(ps * o + 1 for ps in plane_shape)
        for o in block_order]
    sizes = [int(np.prod(s)) for s in grid_shapes]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    total = int(offs[-1])

    # ---- per-block low-order assembly: Kuhn P1 on GLL subcells for
    #      order > 1; order-1 blocks use the exact SEM Q1 element matrix ----
    A_blocks = []
    for b in range(nblocks):
        mesh = mesh_by_order[block_order[b]]
        if block_order[b] == 1:
            A_blocks.append(_q1_layer_grid_matrix(
                mesh, block_phys[b], plane_shape, dim))
        else:
            X = _block_grid_coords(mesh, block_phys[b], plane_shape, dim)
            A_blocks.append(p1_stiffness_grid(X))
    A_blk = sp.block_diag(A_blocks, format="csr")
    t1 = time.perf_counter()

    # ---- plane merge/slave matrix C (shared and hanging planes) ----
    def plane_ids(b, last: bool):
        shp = grid_shapes[b]
        nid = np.arange(sizes[b], dtype=np.int64).reshape(shp)
        return offs[b] + (nid[-1] if last else nid[0]).reshape(-1)

    owner = np.arange(total, dtype=np.int64)
    slaved = np.zeros(total, dtype=bool)
    s_rows, s_cols, s_vals = [], [], []
    for b in range(nblocks):
        b2 = (b + 1) % nblocks
        o1, o2 = block_order[b], block_order[b2]
        top, bot = plane_ids(b, True), plane_ids(b2, False)
        if o1 == o2:
            owner[bot] = top
        else:
            if o1 > o2:   # lower block finer: slave its top plane
                fine, coarse, of, oc = top, bot, o1, o2
            else:
                fine, coarse, of, oc = bot, top, o2, o1
            J2 = _plane_kron(plane_shape, oc, of).tocoo()
            slaved[fine] = True
            s_rows.append(fine[J2.row])
            s_cols.append(coarse[J2.col])
            s_vals.append(J2.data)

    keep = (~slaved) & (owner == np.arange(total))
    dof_id = np.full(total, -1, dtype=np.int64)
    ndof = int(keep.sum())
    dof_id[keep] = np.arange(ndof)

    rows = [np.flatnonzero(keep), np.flatnonzero(~keep & ~slaved)]
    cols = [dof_id[keep], dof_id[owner[rows[1]]]]
    vals = [np.ones(rows[0].size), np.ones(rows[1].size)]
    if s_rows:
        rows.append(np.concatenate(s_rows))
        cols.append(dof_id[np.concatenate(s_cols)])
        vals.append(np.concatenate(s_vals))
    C = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(total, ndof))

    # ---- Dirichlet mask on DOFs ----
    node_mask = np.empty(total)
    for b in range(nblocks):
        shp = grid_shapes[b]
        m = np.ones(shp)
        for d in range(1, len(shp)):          # in-plane boundary
            sl = [slice(None)] * len(shp)
            sl[d] = 0
            m[tuple(sl)] = 0.0
            sl[d] = shp[d] - 1
            m[tuple(sl)] = 0.0
        if block_phys[b] == 0:                # physical z = 0 plane
            m[0] = 0.0
        if block_phys[b] == m_last - 1:       # physical z = 1 plane
            m[-1] = 0.0
        node_mask[offs[b]:offs[b + 1]] = m.reshape(-1)
    dof_mask = node_mask[keep].copy()
    # a merged node on the global boundary masks its owner DOF too
    merged = ~keep & ~slaved
    bad = merged & (node_mask < 0.5)
    np.minimum.at(dof_mask, dof_id[owner[np.flatnonzero(bad)]], 0.0)

    A0 = _mask_fold((C.T @ A_blk @ C).tocsr(), dof_mask)

    # ---- lattice <-> DOF map Q; pad lattice slices (ragged partitions)
    #      map to the zero row ``total`` ----
    C_ext = sp.vstack([C, sp.csr_matrix((1, C.shape[1]))], format="csr")
    offs_ext = np.concatenate([offs[:-1], [0]])   # block -1 -> off 0
    lat_rows = []
    for gi, g in enumerate(groups):
        o = g.order
        n_o = o + 1
        lat_shape = (g.layers * n_o,) + tuple(ps * n_o for ps in plane_shape)
        zi = np.arange(lat_shape[0])
        b_of_z = blk_of[gi][zi // n_o]
        valid = b_of_z >= 0
        pz = zi % n_o
        maps = [None]
        for ps, Ld in zip(plane_shape, lat_shape[1:]):
            li = np.arange(Ld)
            maps.append((li // n_o) * o + (li % n_o))
        real = blk_of[gi][blk_of[gi] >= 0]
        if real.size == 0:
            # a group made entirely of pad slots (extreme ragged shard):
            # every lattice node maps to the zero row below, so the
            # in-plane shape can come from any block
            shp = grid_shapes[0]
        else:
            shp = grid_shapes[int(real[0])]
        plane_sz = int(np.prod(shp[1:]))
        if dim == 3:
            gy = maps[1][:, None]
            gx = maps[2][None, :]
            in_plane = (gy * shp[2] + gx).reshape(-1)
        else:
            in_plane = maps[1]
        node = (offs_ext[b_of_z] + pz * plane_sz)[:, None] + in_plane[None, :]
        node = np.where(valid[:, None], node, total)
        lat_rows.append(node.reshape(-1))
    lat_nodes = np.concatenate(lat_rows)
    Q = C_ext[lat_nodes].tocsr()
    t2 = time.perf_counter()

    # ---- P1 prolongation from the global element-vertex grid, folded to
    #      DOFs ----
    t_cache = {}
    vert_shape = (m_last + 1,) + tuple(ps + 1 for ps in plane_shape)
    P_rows = []
    for b in range(nblocks):
        o = block_order[b]
        if o not in t_cache:
            r, _ = gll_points_weights(o + 1)
            t_cache[o] = (r + 1.0) / 2.0
        t = t_cache[o]
        q = block_phys[b]
        Pz = sp.csr_matrix(
            (np.concatenate([1.0 - t, t]),
             (np.tile(np.arange(o + 1), 2),
              np.concatenate([np.full(o + 1, q), np.full(o + 1, q + 1)]))),
            shape=(o + 1, m_last + 1))
        P = Pz
        for ps in plane_shape:
            P = sp.kron(P, grid_interp_1d(ps, 1, o), format="csr")
        P_rows.append(P)
    P_stack = sp.vstack(P_rows, format="csr")
    P0 = P_stack[np.flatnonzero(keep)].tocsr()
    vmask = _grid_boundary_mask(vert_shape)
    P0 = sp.diags(dof_mask) @ P0 @ sp.diags(vmask)

    A1 = _mask_fold((P0.T @ A0 @ P0).tocsr(), vmask)
    mats, prolongs, lmaxs, coarse_inv = coarsen_matrix_chain(
        A1, vert_shape, max_coarse=max_coarse)
    lmax0 = _power_lmax(A0)
    t3 = time.perf_counter()

    return HostHierarchy(
        mats=[A0] + mats,
        prolongs=[P0.tocsr()] + prolongs,
        lmaxs=[lmax0] + lmaxs,
        coarse_inv=coarse_inv,
        Q=Q,
        dof_mask=dof_mask,
        setup_seconds={"p1_assembly": t1 - t0, "plane_fold": t2 - t1,
                       "galerkin_chain": t3 - t2},
    )

