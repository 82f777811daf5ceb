"""Chebyshev smoothing and the multilevel V-cycles.

Port of the JAX package's ``amg/vcycle.py``: ``cheby_smooth``
(diagonal-preconditioned Chebyshev on [0.3*lmax, lmax], hypre
relax_type=16 semantics); ``pack_chain`` and ``chain_vcycle`` (a V(1,1)
cycle on the vertex grid's 27-point stencil chain with dense per-axis
transfers, inner="amg"); ``pack_hierarchies``, ``vcycle_apply`` and
``composite_preconditioner`` (the assembled composite FEM hierarchy of
inner="fem-amg": sparse level matrices and transfers through
ops/csr.sparse_spmv, a dense coarsest inverse, the lattice <-> DOF maps
Q / Q^T around the cycle; P shards' hierarchies as block-diagonal
operators on stacked vectors). Fields may be tensors or lists of tensors (the
composite problem keeps per-group lattices).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.csr import CsrMatrix, csr_from_scipy, sparse_spmv
from ..ops.interp import axis_contract
from ..ops.stencil import stencil_apply, stencil_from_csr

__all__ = ["CHEBY_FRACTION", "cheby_smooth", "pack_chain", "chain_vcycle",
           "pack_hierarchies", "vcycle_apply", "composite_preconditioner"]

CHEBY_FRACTION = 0.3   # hypre's cheby_fraction default (relax_type=16)


def _tmap(fn, *xs):
    """Map over a field: a tensor, or a list of per-group tensors."""
    if isinstance(xs[0], (list, tuple)):
        return [fn(*parts) for parts in zip(*xs)]
    return fn(*xs)


def _apply(A, x):
    """Level-operator dispatch: a CsrMatrix, or any callable x -> A x (the
    matrix-free composite operator of the hybrid V-cycle). A (P, n) stack
    goes through a block-diagonal CsrMatrix as its (P n,) view."""
    if isinstance(A, CsrMatrix):
        if x.dim() == 2:
            return sparse_spmv(A, x.reshape(-1)).view(x.shape[0], -1)
        return sparse_spmv(A, x)
    return A(x)


def cheby_smooth(A, invd, lmax, f, u, order: int):
    """Chebyshev smoothing on [CHEBY_FRACTION*lmax, lmax]: A is a CsrMatrix
    or a callable x -> A x; ``lmax`` a 0-d tensor (its dtype sets the
    scalars')."""
    lmin = CHEBY_FRACTION * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = f if u is None else _tmap(torch.sub, f, _apply(A, u))
    d = _tmap(lambda iv, rl: iv * rl / theta, invd, r)
    u = d if u is None else _tmap(torch.add, u, d)
    for _ in range(order - 1):
        r = _tmap(torch.sub, r, _apply(A, d))
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = _tmap(lambda dl, iv, rl: rho_new * rho * dl
                  + (2.0 * rho_new / delta) * (iv * rl), d, invd, r)
        rho = rho_new
        u = _tmap(torch.add, u, d)
    return u


def pack_chain(info: dict, dtype=torch.float32, device=None) -> dict:
    """Device tensors for a tensor-grid chain (amg/composite.
    coarsen_chain_info output): level matrices in stencil form, transfers
    as per-axis dense factors."""
    nlev = len(info["mats"])
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    levels = []
    for l in range(nlev):
        A = info["mats"][l]
        d = A.diagonal()
        levels.append({
            "coefs": stencil_from_csr(A, info["shapes"][l], dtype=dtype,
                                      device=device),
            "invd": as_t(np.where(d > 0, 1.0 / d, 0.0)),
            "lmax": as_t(info["lmaxs"][l] if l < nlev - 1 else 1.0),
        })
    return {
        "levels": levels,
        "factors": [[as_t(F) for F in Fs] for Fs in info["factors"]],
        "masks": [as_t(m) for m in info["masks"]],
        "coarse_inv": as_t(info["coarse_inv"]),
    }


def chain_vcycle(chain: dict, f, *, cheby_order: int = 2):
    """V(1,1) cycle on a pack_chain chain (stencil applies and dense
    per-axis contractions); f is flat over the finest vertex grid, or a
    (B, grid points) batch of right-hand sides cycled at once."""
    levels = chain["levels"]
    dim = levels[0]["coefs"].dim() - 1
    nlev = len(levels)
    lead = tuple(f.shape[:-1])      # () or (B,)

    def transfer(l, v, down: bool):
        """down: restrict level l -> l+1; up: prolong level l+1 -> l."""
        Fs = chain["factors"][l]
        V = v.reshape(lead + tuple(
            levels[l if down else l + 1]["coefs"].shape[1:]))
        for ax, F in enumerate(Fs):
            V = axis_contract(F.T if down else F, V, ax + len(lead))
        return (V.reshape(lead + (-1,))
                * chain["masks"][l + 1 if down else l])

    def cycle(l, fl):
        if l == nlev - 1:
            if lead:
                return fl @ chain["coarse_inv"].T
            return chain["coarse_inv"] @ fl
        lv = levels[l]
        A = lambda x: stencil_apply(lv["coefs"], x, dim)
        u = cheby_smooth(A, lv["invd"], lv["lmax"], fl, None, cheby_order)
        fc = transfer(l, fl - A(u), down=True)
        u = u + transfer(l, cycle(l + 1, fc), down=False)
        return cheby_smooth(A, lv["invd"], lv["lmax"], fl, u, cheby_order)

    return cycle(0, f)


def _block_diag_csr(mats) -> sp.csr_matrix:
    """The block-diagonal CSR of equally shaped CSR matrices, built from
    their index arrays (no COO round trip)."""
    mats = [sp.csr_matrix(m) for m in mats]
    n_rows, n_cols = mats[0].shape
    if any(m.shape != (n_rows, n_cols) for m in mats):
        raise ValueError("the shards' matrices differ in shape")
    nnz = np.cumsum([0] + [m.nnz for m in mats])
    indptr = np.concatenate([mats[0].indptr[:1]] + [
        m.indptr[1:].astype(np.int64) + nnz[p] for p, m in enumerate(mats)])
    indices = np.concatenate([m.indices.astype(np.int64) + p * n_cols
                              for p, m in enumerate(mats)])
    data = np.concatenate([m.data for m in mats])
    P = len(mats)
    return sp.csr_matrix((data, indices, indptr),
                         shape=(P * n_rows, P * n_cols))


def pack_hierarchies(hiers, dtype=torch.float32, *, device) -> dict:
    """Tensors on ``device`` for the shards' assembled hierarchies:
    ``hiers`` is a list of objects with HostHierarchy's fields (scipy
    sparse matrices and numpy arrays; a hierarchy the JAX package built
    packs the same way), one per shard, with equal shapes level for level
    (``pad_hier_dofs`` pads ragged shards). Every sparse operator is a
    CsrMatrix in ``dtype`` (its SpMV route follows the dtype,
    ops/csr.py).

    One hierarchy packs unstacked, for flat vectors. P > 1 pack stacked,
    for (P, n) vectors: each sparse operator is the block-diagonal matrix
    of the P shards' (one SpMV for all shards on the (P n,) view),
    ``invd`` and ``dof_mask`` are (P, n), ``lmax`` (P, 1) and
    ``coarse_inv`` (P, nc, nc); ``shards`` is P."""
    if not hiers:
        raise ValueError("no hierarchy to pack")
    P = len(hiers)
    stacked = P > 1
    pack = lambda ms: csr_from_scipy(
        _block_diag_csr(ms) if stacked else ms[0], dtype=dtype,
        device=device)
    arr = lambda xs: torch.as_tensor(
        np.stack([np.asarray(x, dtype=np.float64) for x in xs]) if stacked
        else np.asarray(xs[0], dtype=np.float64), device=device).to(dtype)
    nlev = len(hiers[0].mats)
    levels = []
    for l in range(nlev):
        invd = []
        for h in hiers:
            d = h.mats[l].diagonal()
            invd.append(np.where(d > 0, 1.0 / d, 0.0))
        lmax = [[h.lmaxs[l] if l < nlev - 1 else 1.0] for h in hiers]
        levels.append({
            "A": pack([h.mats[l] for h in hiers]),
            "invd": arr(invd),
            "lmax": arr(lmax) if stacked else arr(lmax)[0],
        })
    tree = {
        "levels": levels,
        "prolongs": [pack([h.prolongs[l] for h in hiers])
                     for l in range(nlev - 1)],
        "restricts": [pack([h.prolongs[l].T.tocsr() for h in hiers])
                      for l in range(nlev - 1)],
        "coarse_inv": arr([h.coarse_inv for h in hiers]),
        "Q": pack([h.Q for h in hiers]),
        "Qt": pack([h.Q.T.tocsr() for h in hiers]),
        "dof_mask": arr([h.dof_mask for h in hiers]),
    }
    if stacked:
        tree["shards"] = P
    return tree


def vcycle_apply(tree: dict, f, *, cheby_order: int = 2,
                 num_cycles: int = 1):
    """``num_cycles`` V(1,1) cycles on an assembled-DOF right-hand side
    (a pack_hierarchies tree): Chebyshev smoothing, sparse restriction and
    prolongation, the dense coarsest inverse."""
    levels = tree["levels"]
    prolongs = tree["prolongs"]
    restricts = tree["restricts"]
    nlev = len(levels)

    def cycle(l, fl):
        if l == nlev - 1:
            if "shards" in tree:
                return torch.bmm(tree["coarse_inv"], fl[..., None])[..., 0]
            return torch.matmul(tree["coarse_inv"], fl)
        lv = levels[l]
        u = cheby_smooth(lv["A"], lv["invd"], lv["lmax"], fl, None,
                         cheby_order)
        r = fl - _apply(lv["A"], u)
        fc = _apply(restricts[l], r)
        uc = cycle(l + 1, fc)
        u = u + _apply(prolongs[l], uc)
        return cheby_smooth(lv["A"], lv["invd"], lv["lmax"], fl, u,
                            cheby_order)

    u = cycle(0, f)
    for _ in range(num_cycles - 1):
        u = u + cycle(0, f - _apply(levels[0]["A"], u))
    return u


def composite_preconditioner(tree: dict, *, cheby_order: int = 2,
                             num_cycles: int = 1):
    """(flat composite lattice r -> z) low-order preconditioner apply:
    gather to DOFs (Q^T), V-cycle(s), scatter back (Q). A stacked tree
    takes (P, n) vectors, each shard through its own hierarchy."""
    def apply(r):
        f = _apply(tree["Qt"], r) * tree["dof_mask"]
        v = vcycle_apply(tree, f, cheby_order=cheby_order,
                         num_cycles=num_cycles)
        return _apply(tree["Q"], v * tree["dof_mask"])

    return apply
