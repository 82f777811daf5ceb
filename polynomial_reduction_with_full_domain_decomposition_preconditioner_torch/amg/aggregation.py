"""Smoothed-aggregation AMG setup for unstructured vertex spaces.

The port's own copy of the JAX package's ``amg/aggregation.py``: classical
smoothed aggregation (greedy strength-based aggregation, Jacobi-smoothed
piecewise-constant prolongation, Galerkin RAP) on the Q1 vertex matrix of
an arbitrary hex mesh, the coarse level of the unstructured composite's
inner="amg" and its compressed far field (``superdomain_basis``). Host
float64 numpy / scipy, the same arithmetic as the JAX package's;
``pack_level_chain`` puts a hierarchy on the device for
amg/vcycle.vcycle_apply as CSR matrices (ops/csr.py).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.csr import csr_from_scipy
from .composite import _power_lmax, _mask_fold
from .vcycle import _block_diag_csr

__all__ = ["q1_vertex_matrix", "aggregation_chain", "pack_level_chain",
           "q1_vertex_matrix_subset", "superdomain_basis",
           "filter_small_entries"]


def q1_vertex_matrix(mesh1) -> tuple[sp.csr_matrix, np.ndarray]:
    """Assembled order-1 SEM (Q1) stiffness matrix on the global vertex
    space of an arbitrary hex/quad mesh, Dirichlet-folded.

    The reference's superdomain coarse matrix role (subdomain.tpp:
    1642-1848), built from the mesh's own geometric factors instead of
    allgathered per-rank pieces. Returns (A, vmask).
    """
    from ..utils.gll import diff_matrix

    dim = mesh1.dim
    npe = mesh1.num_points_per_elem
    D1 = diff_matrix(2)                    # (2, 2)
    eye = np.eye(2)

    # npe x npe derivative operators along each reference axis (x = axis
    # dim-1 is the fastest / last kron factor)
    Ds = []
    for a in range(dim):                   # a = 0 -> r (x direction)
        mats = [eye] * dim
        mats[dim - 1 - a] = D1
        M = mats[0]
        for k in range(1, dim):
            M = np.kron(M, mats[k])
        Ds.append(M)
    Ds = np.stack(Ds)                      # (dim, npe, npe)

    # symmetric G tensor from the packed components
    if dim == 2:
        comp = [(0, 0, 0), (1, 1, 1), (2, 0, 1)]
    else:
        comp = [(0, 0, 0), (1, 1, 1), (2, 2, 2),
                (3, 0, 1), (4, 0, 2), (5, 1, 2)]
    E = mesh1.num_elements
    Gf = np.zeros((E, npe, dim, dim))
    for k, a, b in comp:
        Gf[..., a, b] = mesh1.geom[..., k]
        Gf[..., b, a] = mesh1.geom[..., k]

    K = np.einsum("amp,emab,bmq->epq", Ds, Gf, Ds)   # (E, npe, npe)

    ids = mesh1.glo_num
    nv = mesh1.num_nodes
    rows = np.repeat(ids, npe, axis=1).ravel()
    cols = np.tile(ids, (1, npe)).ravel()
    A = sp.coo_matrix((K.ravel(), (rows, cols)), shape=(nv, nv)).tocsr()
    A.sum_duplicates()

    vmask = np.ones(nv)
    vmask[ids[mesh1.dirichlet_mask < 0.5]] = 0.0
    return _mask_fold(A, vmask), vmask


def q1_vertex_matrix_subset(mesh1, elems) -> sp.csr_matrix:
    """Q1 vertex stiffness assembled over a SUBSET of elements (global
    vertex numbering, no Dirichlet fold) — the per-shard superdomain
    operator source (the reference restricts the global coarse matrix to
    the superdomain rows, subdomain.tpp:2401-2452)."""
    import dataclasses
    sub = dataclasses.replace(
        mesh1,
        coords=mesh1.coords[elems], glo_num=mesh1.glo_num[elems],
        node_degree=mesh1.node_degree[elems],
        dirichlet_mask=np.ones_like(mesh1.dirichlet_mask[elems]),
        geom=mesh1.geom[elems],
        mass=None if mesh1.mass is None else mesh1.mass[elems])
    A, _ = q1_vertex_matrix(sub)
    nv = mesh1.num_nodes
    A.resize((nv, nv))
    return A.tocsr()


def superdomain_basis(A_sup: sp.csr_matrix, keep_fine: np.ndarray,
                      deep: np.ndarray, omega: float = 2.0 / 3.0,
                      theta: float = 0.08) -> sp.csr_matrix:
    """Composite superdomain prolongation P (nv x ns): identity columns on
    the kept-fine vertices + smoothed-aggregation columns (restricted to
    deep rows) for the deep far field — the TPU-native rebuild of the
    reference's AMG-as-graph-oracle composite prolongation
    (subdomain.tpp:1860-2392: BoomerAMG level interpolants composed and
    truncated outside the overlap). Here the aggregation of the
    superdomain operator IS the graph oracle and truncation = restricting
    aggregate columns to deep rows."""
    nv = A_sup.shape[0]
    agg, na = _aggregate(A_sup, deep.copy(), theta=theta)
    sel = agg >= 0
    P0 = sp.csr_matrix(
        (np.ones(int(sel.sum())), (np.flatnonzero(sel), agg[sel])),
        shape=(nv, na))
    if na:
        lmax = _power_lmax(A_sup + sp.eye(nv) * 1e-12)
        d = A_sup.diagonal()
        with np.errstate(divide="ignore"):
            invd = sp.diags(np.where(d != 0, 1.0 / d, 0.0))
        P0 = (P0 - (omega / lmax) * (invd @ (A_sup @ P0))).tocsr()
        # truncate to deep rows (no coupling growth into the kept-fine
        # zone, the reference's outside-overlap truncation)
        mask = sp.diags(deep.astype(float))
        P0 = (mask @ P0).tocsr()
        P0.eliminate_zeros()
    fine_idx = np.flatnonzero(keep_fine)
    I_f = sp.csr_matrix(
        (np.ones(fine_idx.size), (fine_idx, np.arange(fine_idx.size))),
        shape=(nv, fine_idx.size))
    return sp.hstack([I_f, P0], format="csr"), fine_idx


def _aggregate(A: sp.csr_matrix, active: np.ndarray, theta: float = 0.08):
    """Greedy strength-based aggregation (the smoothed-aggregation
    standard: seed aggregates on uncovered nodes, then attach leftovers).
    Returns agg (n,) with aggregate id or -1 (masked/inactive nodes)."""
    n = A.shape[0]
    d = A.diagonal()
    indptr, indices, data = A.indptr, A.indices, A.data

    def strong_neighbors(i):
        sl = slice(indptr[i], indptr[i + 1])
        js = indices[sl]
        vs = np.abs(data[sl])
        thr = theta * np.sqrt(abs(d[i])) * np.sqrt(np.abs(d[js]))
        sel = (js != i) & (vs > thr) & active[js]
        return js[sel]

    agg = np.full(n, -1, dtype=np.int64)
    na = 0
    # pass 1: seed aggregates on nodes with fully uncovered neighborhoods
    for i in range(n):
        if not active[i] or agg[i] >= 0:
            continue
        nb = strong_neighbors(i)
        if (agg[nb] >= 0).any():
            continue
        agg[i] = na
        agg[nb] = na
        na += 1
    # pass 2: attach leftovers to the strongest neighboring aggregate
    for i in range(n):
        if not active[i] or agg[i] >= 0:
            continue
        nb = strong_neighbors(i)
        hit = nb[agg[nb] >= 0]
        if hit.size:
            agg[i] = agg[hit[0]]
        else:
            agg[i] = na
            na += 1
    return agg, na


def filter_small_entries(A: sp.csr_matrix, tol: float) -> sp.csr_matrix:
    """Sparsify with diagonal compensation: drop off-diagonal entries
    |a_ij| < tol * sqrt(|a_ii a_jj|) and LUMP the dropped mass onto the
    diagonal (row sums — hence the action on constants — are preserved).
    Standard stencil-growth control for smoothed-aggregation Galerkin
    products: without it, coarse SA matrices on simplicial FEM problems
    densify level-over-level (measured: 8.5M -> 28M nnz while rows
    shrink 614k -> 7.7k, and the next RAP grinds for an hour)."""
    if tol <= 0.0:
        return A
    A = A.tocsr()
    d = np.sqrt(np.abs(A.diagonal()) + 1e-300)
    coo = A.tocoo()
    thr = tol * d[coo.row] * d[coo.col]
    keep = (np.abs(coo.data) >= thr) | (coo.row == coo.col)
    dropped = np.zeros(A.shape[0])
    np.add.at(dropped, coo.row[~keep], coo.data[~keep])
    # clamp: stiffness rows sum to ~0, so a row whose off-diagonals ALL
    # drop would lump to a ZERO diagonal (singular coarse solve) — keep
    # at least 10% of the original diagonal magnitude
    diag = A.diagonal()
    comp = np.where(np.abs(diag + dropped) >= 0.1 * np.abs(diag),
                    dropped, -0.9 * diag)
    Af = sp.csr_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=A.shape)
    Af = (Af + sp.diags(comp)).tocsr()
    Af.sum_duplicates()
    return Af


def aggregation_chain(A0: sp.csr_matrix, vmask: np.ndarray,
                      max_coarse: int = 600, theta: float = 0.08,
                      omega: float = 2.0 / 3.0, max_levels: int = 12,
                      filter_tol: float = 0.0):
    """Smoothed-aggregation hierarchy: returns a dict with mats, prolongs,
    lmaxs, coarse_inv (the coarsen_chain_info schema minus grid shapes).

    filter_tol > 0 applies diagonal-compensated sparsification to every
    Galerkin product (see filter_small_entries) — required for large
    simplicial-FEM fine matrices (the unstructured fem-amg oracle)."""
    info = {"mats": [A0.tocsr()], "prolongs": [], "lmaxs": [],
            "coarse_inv": None}
    A = A0.tocsr()
    active = vmask > 0.5
    slow_budget = 2
    for level in range(max_levels):
        if A.shape[0] <= max_coarse:
            break
        # stalled coarsening (filtered matrices can go near-diagonal,
        # strong-neighbor sets empty out, aggregates become singletons):
        # retry with progressively weaker strength thresholds — any
        # remaining coupling is better than a 100k-row "coarsest" level
        th = theta
        agg, na = _aggregate(A, active, theta=th)
        while na >= 0.95 * A.shape[0] and th > theta / 300.0:
            th /= 8.0
            agg, na = _aggregate(A, active, theta=th)
        if na == 0 or na >= A.shape[0]:
            break
        if na >= 0.95 * A.shape[0]:
            # slow but real coarsening (na in [0.95n, n) after every
            # theta retry): accept a bounded number of such levels —
            # they still shrink the problem, and hard-stopping here used
            # to leave a huge "coarsest" level that tripped the dense
            # guard below on legitimate hierarchies
            slow_budget -= 1
            if slow_budget < 0:
                break
        sel = agg >= 0
        P0 = sp.csr_matrix(
            (np.ones(int(sel.sum())), (np.flatnonzero(sel), agg[sel])),
            shape=(A.shape[0], na))
        lmax = _power_lmax(A)
        d = A.diagonal()
        with np.errstate(divide="ignore"):
            invd = sp.diags(np.where(d != 0, 1.0 / d, 0.0))
        # Jacobi-smoothed prolongation: P = (I - omega/lmax D^-1 A) P0
        P = (P0 - (omega / lmax) * (invd @ (A @ P0))).tocsr()
        Ac = (P.T @ A @ P).tocsr()
        Ac.sum_duplicates()
        if Ac.nnz > 45 * Ac.shape[0]:
            # filter only when stencils actually grow, with a per-level
            # DECAYING tolerance — a fixed tolerance strangles the
            # couplings of deep levels (measured on pebble-bed FEM:
            # nnz/row 12.8 -> 4.6 and the coarsening rate collapsed)
            Ac = filter_small_entries(Ac, filter_tol / (2.0 ** level))
        info["lmaxs"].append(lmax)
        info["prolongs"].append(P)
        info["mats"].append(Ac)
        A = Ac
        # decoupled rows (no off-diagonal after filtering) need no
        # coarse correction — the diagonal smoother solves them exactly;
        # representing them coarser only inflates singleton aggregates
        offd = A - sp.diags(A.diagonal())
        offd.eliminate_zeros()
        active = np.diff(offd.tocsr().indptr) > 0
    n_last = info["mats"][-1].shape[0]
    if n_last > 40 * max_coarse:
        raise RuntimeError(
            f"aggregation stalled with a {n_last}-row coarsest level "
            f"(max_coarse={max_coarse}) — refusing the dense inverse")
    dense = info["mats"][-1].toarray()
    try:
        info["coarse_inv"] = np.linalg.inv(dense)
    except np.linalg.LinAlgError:        # pragma: no cover - safety net
        info["coarse_inv"] = np.linalg.pinv(dense)
    return info


def pack_level_chain(info: dict, dtype=torch.float32, *, device,
                     shards: int = 1) -> dict:
    """Device tree of one hierarchy (``aggregation_chain`` output) for
    amg/vcycle.vcycle_apply on (shards, n) right-hand sides: each shard
    cycles its own vector through the same hierarchy, so every sparse
    operator is the block-diagonal of ``shards`` copies (one SpMV for all
    on the stacked view), ``invd`` is (shards, n), ``lmax`` (shards, 1)
    and ``coarse_inv`` (shards, nc, nc)."""
    P = shards
    pack = lambda m: csr_from_scipy(_block_diag_csr([m.tocsr()] * P),
                                    dtype=dtype, device=device)
    rep = lambda a: torch.as_tensor(
        np.stack([np.asarray(a, dtype=np.float64)] * P),
        device=device).to(dtype)
    nlev = len(info["mats"])
    levels = []
    for l in range(nlev):
        A = info["mats"][l]
        d = A.diagonal()
        with np.errstate(divide="ignore"):
            invd = np.where(d != 0, 1.0 / d, 0.0)
        levels.append({
            "A": pack(A),
            "invd": rep(invd),
            "lmax": rep([info["lmaxs"][l] if l < nlev - 1 else 1.0]),
        })
    return {
        "levels": levels,
        "prolongs": [pack(Pm) for Pm in info["prolongs"]],
        "restricts": [pack(Pm.T) for Pm in info["prolongs"]],
        "coarse_inv": rep(info["coarse_inv"]),
        "shards": P,
    }
