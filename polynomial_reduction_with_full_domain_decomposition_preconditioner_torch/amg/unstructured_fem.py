"""Composite low-order FEM matrix and hierarchy of UNSTRUCTURED composites.

Port of the JAX package's ``amg/unstructured_fem.py``, host float64
numpy/scipy, the same operations in the same order (the matrices equal
the JAX package's on the same inputs). The reference assembles its
low-order P1-FEM preconditioner matrix on every mesh, pebble beds
included; this is that path for the unstructured composite of
solvers/unstructured.py (inner="fem-amg"):

- per order class, each region element's GLL subcell grid is split into
  Kuhn tets with per-simplex P1 stiffness (the machinery of amg/fem.py);
  order-1 elements take the exact SEM Q1 element matrix instead;
- contributions land on the class-local assembled node spaces; hanging
  fine nodes fold onto the coarse trace through the slave constraints,
  composed across the class chain, into one composite DOF space a shard;
- the far field's algebraic superdomain block A_sup = P^T A_far P joins
  the DOF space through the interface identification;
- the hierarchy on the composite FEM matrix is smoothed aggregation
  (amg/aggregation.py).

``pad_fem_shards`` pads the shards' hierarchies to equal shapes (level
count, level sizes, DOF count) for the block-diagonal device packing of
amg/vcycle.pack_hierarchies: a short chain is extended by repeating its
coarsest matrix under identity transfers (more Chebyshev smoothing, so
arithmetic, as in the JAX package), pad DOFs are isolated unit-diagonal
rows.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp

from scipy.sparse.csgraph import reverse_cuthill_mckee

from .aggregation import aggregation_chain
from .composite import _mask_fold
from .fem import _kuhn_tets, _simplex_stiffness, sem_element_matrices

__all__ = ["p1_element_entries", "sem_element_matrices",
           "build_unstructured_fem_shard", "pad_fem_shards"]



def p1_element_entries(X: np.ndarray, dim: int, n: int):
    """Batched Kuhn-simplex P1 stiffness over a set of elements.

    X: (E, npe, dim) element nodal coordinates (storage order z, y, x —
    x fastest). Returns (lrows, lcols, vals): COO entries with
    element-LOCAL point indices (E, nnz_per_elem) so callers can map
    them through any class-local node numbering.
    (subdomain.tpp:2845-3038 per-simplex assembly, batched.)
    """
    E = X.shape[0]
    npe = n ** dim
    Xg = X.reshape((E,) + (n,) * dim + (dim,))
    nid = np.arange(npe, dtype=np.int64).reshape((n,) * dim)
    rows, cols, vals = [], [], []
    if dim == 2:
        simps = [[(0, 0), (0, 1), (1, 1)], [(0, 0), (1, 1), (1, 0)]]
        cshape = (n - 1, n - 1)
    else:
        simps = _kuhn_tets()
        cshape = (n - 1, n - 1, n - 1)
    B = int(np.prod(cshape))
    for corners in simps:
        verts = np.stack([
            Xg[(slice(None),) + tuple(slice(c[d], c[d] + cshape[d])
                                      for d in range(dim))].reshape(-1, dim)
            for c in corners], axis=1)          # (E*B, d+1, d)
        ids = np.stack([
            nid[tuple(slice(c[d], c[d] + cshape[d])
                      for d in range(dim))].reshape(-1)
            for c in corners], axis=1)          # (B, d+1)
        K = _simplex_stiffness(verts).reshape(E, B, dim + 1, dim + 1)
        m = dim + 1
        r = np.repeat(ids, m, axis=1)           # (B, m*m)
        c_ = np.tile(ids, (1, m))
        rows.append(np.broadcast_to(r, (E,) + r.shape))
        cols.append(np.broadcast_to(c_, (E,) + c_.shape))
        vals.append(np.swapaxes(K, 2, 3).reshape(E, -1))
    lrows = np.concatenate([a.reshape(E, -1) for a in rows], axis=1)
    lcols = np.concatenate([a.reshape(E, -1) for a in cols], axis=1)
    v = np.concatenate(vals, axis=1)
    return lrows, lcols, v


def _class_node_matrix(mesh_o, elems, gids, NN: int, order: int,
                       dim: int) -> sp.csr_matrix:
    """Assemble one class's low-order matrix on its class-local node
    space: Kuhn P1 on GLL subcells for order > 1, the exact SEM Q1
    element matrix for order 1 (the reference's split,
    subdomain.tpp:2845-3125)."""
    real = elems >= 0
    sel = elems[real]
    if sel.size == 0:
        return sp.csr_matrix((NN, NN))
    n = order + 1
    npe = n ** dim
    g_pts = gids.reshape(elems.shape[0], npe)[real]   # (Er, npe)
    if order == 1:
        K = sem_element_matrices(mesh_o.geom[sel], dim, n)  # (Er, npe, npe)
        rows = np.repeat(g_pts, npe, axis=1).ravel()
        cols = np.tile(g_pts, (1, npe)).ravel()
        vals = K.reshape(g_pts.shape[0], -1).ravel()
    else:
        lrows, lcols, v = p1_element_entries(
            mesh_o.coords[sel], dim, n)
        rows = np.take_along_axis(g_pts, lrows, axis=1).ravel()
        cols = np.take_along_axis(g_pts, lcols, axis=1).ravel()
        vals = v.ravel()
    A = sp.coo_matrix((vals, (rows, cols)), shape=(NN, NN)).tocsr()
    A.sum_duplicates()
    return A


def build_unstructured_fem_shard(orders, mesh_by_order, class_elems_p,
                                 cls_setups_p, slv_p, sup_p,
                                 max_coarse: int = 600,
                                 seconds: dict | None = None) -> dict:
    """One shard's composite FEM matrix + hierarchy + point<->DOF map.

    class_elems_p: per-class element id arrays (with -1 pads).
    cls_setups_p: per-class _class_setup dicts (gids, NN, nmask).
    slv_p: per class pair (ids, cols, wts) in CLASS-LOCAL node ids
      (ids (Ns,), cols (Ns, K), wts (Ns, K)).
    sup_p: None, or dict(A=A_sup CSR (ns, ns), iface=[(class_node,
      sup_idx)], mask=(ns,)) from the superdomain compression.

    seconds: a dict the host seconds by stage are added to
      ("p1_entries": the class matrices, "slave_fold": the DOF maps, the
      folded sum and the RCM, "aggregation_chain", "q_map").

    Returns dict(chain=aggregation info, Q=CSR (points+ns -> ndof),
    dof_mask, ndof, ns).
    """
    seconds = {} if seconds is None else seconds
    clock = [time.perf_counter()]

    def lap(stage):
        now = time.perf_counter()
        seconds[stage] = seconds.get(stage, 0.0) + now - clock[0]
        clock[0] = now
    dim = mesh_by_order[orders[0]].dim
    C = len(orders)
    NNs = [cls_setups_p[c]["NN"] for c in range(C)]

    # ---- composite DOF numbering: coarsest class first, then the
    #      superdomain, then finer classes (kept nodes only) ----
    ndof = NNs[C - 1]
    dof_coarse = np.arange(NNs[C - 1], dtype=np.int64)
    M = [None] * C
    M[C - 1] = sp.csr_matrix(
        (np.ones(NNs[C - 1]), (np.arange(NNs[C - 1]), dof_coarse)),
        shape=(NNs[C - 1], NNs[C - 1]))

    ns = 0
    M_sup = None
    if sup_p is not None:
        ns = sup_p["A"].shape[0]
        sup_dof = np.empty(ns, dtype=np.int64)
        is_iface = np.zeros(ns, dtype=bool)
        for ci, si in sup_p["iface"]:
            sup_dof[si] = dof_coarse[ci]
            is_iface[si] = True
        fresh = np.flatnonzero(~is_iface)
        sup_dof[fresh] = ndof + np.arange(fresh.size)
        ndof += fresh.size
        M_sup = sp.csr_matrix(
            (np.ones(ns), (np.arange(ns), sup_dof)), shape=(ns, ndof))

    # pad earlier maps' column count as the DOF space grows
    def widen(mat, nd):
        m = mat.tocsr(copy=False)
        m.resize((m.shape[0], nd))
        return m

    for c in range(C - 2, -1, -1):
        ids, cols, wts = slv_p[c]
        slaved = np.zeros(NNs[c], dtype=bool)
        if ids.size:
            slaved[ids] = True
        kept = np.flatnonzero(~slaved)
        base = ndof + np.arange(kept.size, dtype=np.int64)
        ndof += kept.size
        K_inc = sp.csr_matrix(
            (np.ones(kept.size), (kept, base)), shape=(NNs[c], ndof))
        if ids.size:
            Kc = cols.shape[1]
            S = sp.csr_matrix(
                (wts.ravel(), (np.repeat(ids, Kc), cols.ravel())),
                shape=(NNs[c], NNs[c + 1]))
            M[c] = (K_inc + S @ widen(M[c + 1], ndof)).tocsr()
        else:
            M[c] = K_inc
    for c in range(C):
        M[c] = widen(M[c], ndof)
    if M_sup is not None:
        M_sup = widen(M_sup, ndof)

    # ---- composite FEM matrix A0 = sum_c M_c^T A_c M_c (+ sup block) ----
    A0 = sp.csr_matrix((ndof, ndof))
    for c in range(C):
        lap("slave_fold")
        A_c = _class_node_matrix(
            mesh_by_order[orders[c]], class_elems_p[c],
            cls_setups_p[c]["gids"], NNs[c], orders[c], dim)
        lap("p1_entries")
        A0 = A0 + (M[c].T @ A_c @ M[c])
    if sup_p is not None:
        A0 = A0 + (M_sup.T @ sup_p["A"] @ M_sup)
    A0 = A0.tocsr()
    A0.sum_duplicates()

    # ---- Dirichlet DOF mask (class node masks + superdomain mask) ----
    dof_mask = np.ones(ndof)
    for c in range(C):
        nm = cls_setups_p[c]["nmask"][:NNs[c]]
        bad = np.flatnonzero(nm < 0.5)
        if bad.size:
            mm = M[c][bad].tocoo()
            np.minimum.at(dof_mask, mm.col, 0.0)
    if sup_p is not None:
        bad = np.flatnonzero(sup_p["mask"] < 0.5)
        if bad.size:
            mm = M_sup[bad].tocoo()
            np.minimum.at(dof_mask, mm.col, 0.0)
    A0 = _mask_fold(A0, dof_mask)

    # ---- bandwidth reduction (RCM) on the DOF space: column locality
    # for the sparse applies (the JAX package's block packing needs it;
    # kept so that the DOF numbering is the JAX package's) ----
    perm = np.asarray(reverse_cuthill_mckee(A0, symmetric_mode=True),
                      dtype=np.int64)
    A0 = A0[perm, :][:, perm].tocsr()
    dof_mask = dof_mask[perm]
    # new DOF j sits at old perm[j]: remap the M maps' columns so Q
    # lands in the permuted space (iperm[old] = new)
    iperm = np.empty(ndof, dtype=np.int64)
    iperm[perm] = np.arange(ndof)
    P_perm = sp.csr_matrix(
        (np.ones(ndof), (np.arange(ndof), iperm)), shape=(ndof, ndof))
    M = [(Mc @ P_perm).tocsr() for Mc in M]
    if M_sup is not None:
        M_sup = (M_sup @ P_perm).tocsr()

    # ---- hierarchy (the reference's BoomerAMG role) ----
    # filter_tol: diagonal-compensated sparsification of the Galerkin
    # products — Kuhn-tet fine matrices densify under plain SA
    # coarsening (amg/aggregation.filter_small_entries)
    lap("slave_fold")
    chain = aggregation_chain(A0, dof_mask, max_coarse=max_coarse,
                              filter_tol=0.02)
    lap("aggregation_chain")

    # ---- composite points (+ sup DOFs) <-> DOF map Q ----
    q_rows = []
    for c in range(C):
        M_ext = sp.vstack([M[c], sp.csr_matrix((1, ndof))], format="csr")
        q_rows.append(M_ext[cls_setups_p[c]["gids"]])
    if M_sup is not None:
        q_rows.append(M_sup)
    Q = sp.vstack(q_rows, format="csr")
    lap("q_map")

    return {"chain": chain, "Q": Q, "dof_mask": dof_mask,
            "ndof": ndof, "ns": ns}


def pad_fem_shards(shards: list[dict], ns_pad: int = 0) -> list[dict]:
    """Pad per-shard FEM hierarchies to SPMD-uniform shapes: same level
    count, same per-level sizes, same DOF count, same sup-row count.
    Pad DOFs are isolated unit-diagonal rows (smoothing and the coarse
    solve leave them at zero); pad prolongation entries are zero, so
    nothing couples."""
    nlev = max(len(s["chain"]["mats"]) for s in shards)
    # extend short chains with identity transfers (A repeated)
    for s in shards:
        ch = s["chain"]
        extended = len(ch["mats"]) < nlev
        while len(ch["mats"]) < nlev:
            nl = ch["mats"][-1].shape[0]
            ch["prolongs"].append(sp.eye(nl, format="csr"))
            ch["lmaxs"].append(ch["lmaxs"][-1] if ch["lmaxs"] else 1.0)
            ch["mats"].append(ch["mats"][-1].copy())
        if extended:
            # the repeated coarsest matrix is identical at every added
            # level — one inverse suffices (coarsest can be ~10k rows)
            ch["coarse_inv"] = np.linalg.inv(ch["mats"][-1].toarray())
    sizes = [max(s["chain"]["mats"][l].shape[0] for s in shards)
             for l in range(nlev)]
    npts = max(s["Q"].shape[0] - s["ns"] for s in shards)
    for s in shards:
        ch = s["chain"]
        for l in range(nlev):
            A = ch["mats"][l].tocsr(copy=True)
            n0 = A.shape[0]
            A.resize((sizes[l], sizes[l]))
            if sizes[l] > n0:
                pad = sp.coo_matrix(
                    (np.ones(sizes[l] - n0),
                     (np.arange(n0, sizes[l]), np.arange(n0, sizes[l]))),
                    shape=(sizes[l], sizes[l]))
                A = (A + pad).tocsr()
            ch["mats"][l] = A
        for l in range(nlev - 1):
            Pm = ch["prolongs"][l].tocsr(copy=True)
            Pm.resize((sizes[l], sizes[l + 1]))
            ch["prolongs"][l] = Pm
        ci = ch["coarse_inv"]
        n0 = ci.shape[0]
        if sizes[-1] > n0:
            big = np.eye(sizes[-1])
            big[:n0, :n0] = ci
            ch["coarse_inv"] = big
        dm = np.zeros(sizes[0])
        dm[:s["dof_mask"].size] = s["dof_mask"]
        s["dof_mask"] = dm
        # Q: pad rows to (npts + ns_pad), cols to sizes[0]
        Qm = s["Q"].tocsr(copy=True)
        pts = Qm.shape[0] - s["ns"]
        if s["ns"] or ns_pad:
            top = Qm[:pts]
            bot = Qm[pts:]
            bot.resize((ns_pad, Qm.shape[1]))
            top.resize((npts, Qm.shape[1]))
            Qm = sp.vstack([top, bot], format="csr")
        else:
            Qm.resize((npts, Qm.shape[1]))
        Qm.resize((Qm.shape[0], sizes[0]))
        s["Q"] = Qm.tocsr()
    return shards
