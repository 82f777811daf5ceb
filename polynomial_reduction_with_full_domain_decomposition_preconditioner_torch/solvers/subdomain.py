"""Full-domain-decomposition + polynomial-reduction preconditioner.

Port of the JAX package's ``solvers/subdomain.composite_dd`` for ONE
structured shard: the matrix-free hybrid inner preconditioner
(inner="amg"), the assembled composite FEM hierarchy ("fem-amg"), the
assembled-diagonal stand-in ("jacobi") or plain QQt ("none"), under a
fixed inner FGMRES or FCG. On one shard the composite
problem is the whole domain at order N, a single layer group (G=1): the
composite operator is the SEM apply (kernel K1), the composite dssum the
one-pass face sum with the mask fused in (kernel K2), and the outer
residual enters the composite unchanged (the reference's restriction
cascade feeds only ring and far groups, which one shard does not have, so
it is not computed). With inner="amg" each inner step is preconditioned
by Chebyshev smoothing on the composite operator plus a vertex-grid
correction in >= f32: one chain V-cycle, or ``vertex_iters`` PCG steps
preconditioned by it. With inner="fem-amg" each inner step is
preconditioned by a V-cycle on the composite problem reassembled as a
low-order FEM matrix (amg/composite.build_composite_hierarchy, packed in
the ptype by amg/vcycle.pack_hierarchies): Q^T, the V-cycle and Q on the
flattened group lattice, then the group mask.

The layer-group specs (``_GroupSpec``, ``_build_group_specs``) are the
reference's; on one shard they give the single group. More shards raise
NotImplementedError (ROADMAP item 10b).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..amg.composite import (build_composite_hierarchy, load_chain_info,
                             save_chain_info, vertex_q1_hierarchy)
from ..amg.vcycle import (cheby_smooth, chain_vcycle,
                          composite_preconditioner, pack_chain,
                          pack_hierarchies)
from ..mesh.layout import elements_to_lattice
from ..ops import sem
from ..ops.interp import axis_contract
from ..ops.kernels import lattice_face_sum_3d
from ..ops.stencil import stencil_apply
from ..utils.gll import diff_matrix, gll_points_weights
from .preconditioners import Preconditioner
from . import krylov

__all__ = ["composite_dd"]


@dataclass(frozen=True)
class _GroupSpec:
    order: int          # polynomial order of this layer group
    layers: int         # number of element layers (in zcoarse units)
    start_pos: int      # first layer position (cyclic, FINE layer units)
    zcoarse: int = 1    # z element-merge factor (1 = fine layers)

    @property
    def fine_extent(self) -> int:
        return self.layers * self.zcoarse


def _build_group_specs(S, V, L, orders, total_layers, far_zcoarse: int = 1,
                       sup_overlap: int = 1):
    """Layer groups in cyclic position order: own slab, rings above
    (orders[0..L-1], V layers each), far field (order 1), rings below
    (mirrored). With far_zcoarse > 1 the far field is carried on z-merged
    layers, with ``sup_overlap`` coarse-layer widths of fine order-1
    layers kept on each side."""
    groups = [_GroupSpec(orders[0], S, 0)]
    if total_layers == S:
        return groups  # single shard: the composite is the whole domain
    pos = S
    for l in range(L):
        groups.append(_GroupSpec(orders[l], V, pos))
        pos += V
    far = total_layers - S - 2 * V * L
    if far < 0:
        raise ValueError(
            f"mesh too small for overlap: need >= {S + 2 * V * L} layers, "
            f"have {total_layers}")
    if far > 0:
        F = far_zcoarse
        ov = sup_overlap * F if F > 1 else 0
        if F > 1 and ((far - 2 * ov) % F != 0 or far - 2 * ov < F):
            raise ValueError(
                f"far_coarsen={F} misaligned: the far field "
                f"({far} layers minus 2x{ov} fine overlap) must be a "
                f"positive multiple of {F}")
        if ov > 0:
            groups.append(_GroupSpec(orders[-1], ov, pos))
            pos += ov
        mid = far - 2 * ov
        groups.append(_GroupSpec(orders[-1], mid // F, pos, zcoarse=F))
        pos += mid
        if ov > 0:
            groups.append(_GroupSpec(orders[-1], ov, pos))
            pos += ov
    for l in range(L - 1, -1, -1):
        groups.append(_GroupSpec(orders[l], V, pos))
        pos += V
    if pos != total_layers:
        raise ValueError(f"groups cover {pos} layers of {total_layers}")
    return groups


def composite_dd(domain, mesh_builder, poly_reduction: int,
                 subdomain_overlap: int = 1,
                 superdomain_overlap: int = 1,
                 num_iterations: int = 4,
                 inner: str = "amg",
                 inner_solver: str = "fgmres",
                 num_vcycles: int = 1,
                 cheby_order: int = 2,
                 ptype=None,
                 max_coarse: int = 600,
                 far_coarsen="auto",
                 fine_mesh=None,
                 chain_cache: str | None = None,
                 vertex_iters: int = 0,
                 chain_info: dict | None = None) -> Preconditioner:
    """Build the composite DD + polynomial-reduction preconditioner.

    domain: the fine-level Domain (one structured shard).
    mesh_builder(N_c): the same element grid meshed at order N_c.
    poly_reduction: order step of the level hierarchy N, N-r, ..., 1.
    subdomain_overlap: ring thickness in layers (checked against the
      slab depth, as in the reference).
    superdomain_overlap: fine layers kept beside a compressed far field;
      one shard has no far field, so it changes nothing here.
    num_iterations: fixed inner Krylov iterations.
    inner: the composite solve's own preconditioner: "amg" (Chebyshev on
      the composite operator + the vertex-grid chain), "fem-amg" (a
      V-cycle on the assembled composite FEM hierarchy), "jacobi" (the
      assembled diagonal) or "none" (plain composite QQt).
    inner_solver: "fgmres" or "fcg"; both run the same fixed count. FCG
      stores no Arnoldi basis and assumes the composite operator is
      effectively SPD.
    num_vcycles / cheby_order: V-cycle hyperparameters (both inners).
    ptype: preconditioner precision (default: the domain's dtype); the
      composite geometry, mask and weight are stored in it, as is the
      fem-amg hierarchy; the vertex chain of inner="amg" in >= f32.
    max_coarse: coarsest vertex-level size for the dense solve.
    far_coarsen: far-field z element-merge factor, "auto" or an integer.
      One shard's composite has no far field, so "auto" and 1 are the only
      values accepted; a larger factor raises ValueError (misaligned, as
      in the reference, or nothing to compress).
    fine_mesh: the order-N mesh if already built (must equal
      mesh_builder(N)).
    chain_cache: path of an npz checkpoint of the vertex chain
      (amg/composite.save_chain_info): loaded if the file exists, else
      written after the chain is built.
    vertex_iters: study knob of inner="amg": the vertex problem is solved
      by this many fixed PCG iterations preconditioned by the chain
      V-cycle instead of one V-cycle (0, the default).
    chain_info: a prebuilt vertex chain (amg/composite.coarsen_chain_info
      layout, e.g. the JAX package's); takes precedence over chain_cache.
    """
    if inner_solver not in ("fgmres", "fcg"):
        raise ValueError(f"inner_solver={inner_solver!r} "
                         "(use 'fgmres' or 'fcg')")
    if inner not in ("amg", "fem-amg", "jacobi", "none"):
        raise ValueError(f"inner={inner!r} "
                         "(use 'amg', 'fem-amg', 'jacobi' or 'none')")
    sd = domain.sharded
    if sd.structured is None:
        raise NotImplementedError(
            "the composite on a structured=False partition is ROADMAP item 13")
    if sd.num_shards != 1:
        raise NotImplementedError(
            "the composite on more than one shard (rings, far field, "
            "all_gather) is ROADMAP item 10b")
    dim = domain.dim
    N = domain.poly_degree
    dtype = ptype if ptype is not None else domain.dtype
    device = domain.device
    elem_shape = sd.structured.elem_shape
    m_last = elem_shape[-1]
    S = sd.structured.slab_elems
    plane_shape = tuple(reversed(elem_shape[:-1]))  # (my, mx)

    # level hierarchy N, N-r, ..., 1
    orders = [N]
    while orders[-1] > 1:
        orders.append(max(orders[-1] - poly_reduction, 1))
    V = subdomain_overlap
    if S < V * len(orders):
        raise ValueError(
            f"own slab ({S} layers) must cover the ring depth "
            f"({V * len(orders)})")
    if far_coarsen != "auto":
        Fz = int(far_coarsen)
        if Fz > 1 and (S % Fz or (V * len(orders)) % Fz or m_last % Fz):
            raise ValueError(
                f"far_coarsen={Fz} must divide the slab ({S}), the ring "
                f"extent ({V * len(orders)}) and the layer count ({m_last})")
        if Fz > 1:
            raise ValueError(
                f"far_coarsen={Fz}: one shard's composite is the whole "
                "domain and has no far field to compress")
    # one shard owns every layer, so the layer-group build gives a single
    # group: the own slab (the whole domain) at order N
    groups = _build_group_specs(S, V, len(orders), orders, m_last)
    n = N + 1

    # group geometry, mask and inverse multiplicity in the ptype
    mesh_N = fine_mesh if fine_mesh is not None else mesh_builder(N)
    grid = (m_last,) + plane_shape

    def lattice(field):
        a = elements_to_lattice(np.asarray(field), grid, n, dim)
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

    geom = tuple(lattice(mesh_N.geom[..., k]) for k in range(6))
    mask = lattice(mesh_N.dirichlet_mask)
    weight = lattice(1.0 / mesh_N.node_degree.astype(np.float64))
    D = torch.as_tensor(diff_matrix(n), dtype=dtype, device=device)

    amg = None
    setup_seconds = {}
    if inner == "fem-amg":
        # the assembled composite FEM hierarchy (host f64), packed in the
        # ptype: level matrices, transfers and Q / Q^T as CSR on the device
        hier = build_composite_hierarchy(groups, {N: mesh_N}, plane_shape,
                                         m_last, 0, dim,
                                         max_coarse=max_coarse)
        t0 = time.perf_counter()
        amg = pack_hierarchies([hier], dtype=dtype, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_seconds = dict(hier.setup_seconds,
                             pack=time.perf_counter() - t0)
    elif inner == "amg":
        # vertex chain in >= f32 (the coarse correction must not round off)
        if chain_info is None and chain_cache is not None \
                and os.path.exists(chain_cache):
            chain_info = load_chain_info(chain_cache)
        if chain_info is None:
            chain_info = vertex_q1_hierarchy(mesh_builder(1), plane_shape,
                                             m_last, dim,
                                             max_coarse=max_coarse)
            if chain_cache is not None:
                save_chain_info(chain_cache, chain_info)
        chain_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
        chain = pack_chain(chain_info, dtype=chain_dtype, device=device)

        # trilinear vertex -> lattice factors, one dense matrix per axis
        # (z, y, x): rows are the lattice points of m elements, columns the
        # m + 1 vertex planes
        r_, _ = gll_points_weights(n)
        t = (r_ + 1.0) / 2.0
        P1 = []
        for m in (m_last,) + plane_shape:
            F = np.zeros((m * n, m + 1))
            for e in range(m):
                F[e * n:(e + 1) * n, e] = 1.0 - t
                F[e * n:(e + 1) * n, e + 1] = t
            P1.append(torch.as_tensor(F, device=device).to(dtype))
        vert_shape = (m_last + 1,) + tuple(ps + 1 for ps in plane_shape)
        amg = {"chain": chain, "P1": P1}

    def comp_operator(parts):
        return [sem.stiffness_apply_lattice(parts[0], geom, D, dim)]

    def comp_dssum(parts, apply_mask=True):
        # G = 1: no group interfaces, so the composite dssum is the face
        # sum with the mask fused in
        return [lattice_face_sum_3d(parts[0], n,
                                    mask=mask if apply_mask else None)]

    def comp_dot(a, b):
        # rank-local plain point-space dot (no multiplicity weight)
        return krylov.tree_dot(a, b)

    def A_mf(x):
        return comp_dssum(comp_operator(x), apply_mask=True)

    def comp_dot2(a, b, c, d):
        return comp_dot(a, b), comp_dot(c, d)

    if inner in ("amg", "jacobi"):
        # continuous inverse assembled diagonal of the composite operator
        diag = comp_dssum([sem.stiffness_diagonal_lattice(geom, D, dim)],
                          apply_mask=False)[0]
        comp_inv_diag = [torch.where(diag > 0, 1.0 / diag,
                                     torch.zeros_like(diag))]

    if inner == "amg":
        # Chebyshev bound: lambda_max(D^-1 A) of the composite operator by
        # 20 power-iteration steps in the ptype, x 1.1 (converges from below)
        x = [(torch.sin(torch.arange(mask.numel(), dtype=torch.float64,
                                     device=device).to(dtype) * 0.7311)
              .reshape(mask.shape) * mask)]
        lam = None
        for _ in range(20):
            y = [comp_inv_diag[0] * A_mf(x)[0]]
            num = krylov.tree_dot([weight * y[0]], y)
            den = torch.clamp(krylov.tree_dot([weight * x[0]], x), min=1e-30)
            lam = torch.sqrt(num / den)
            x = [y[0] * (1.0 / torch.clamp(torch.sqrt(num), min=1e-30))]
        lmax0 = amg["lmax0"] = lam * 1.1

        def restrict_to_vertex(parts):
            Vt = parts[0] * weight
            for d, F in enumerate(P1):
                Vt = axis_contract(F.T, Vt, d)
            return Vt.reshape(-1).to(chain_dtype) * chain["masks"][0]

        def vertex_solve(w):
            """Coarse-grid correction on the vertex problem: one chain
            V-cycle, or vertex_iters fixed PCG steps preconditioned by it
            (no host reads: the guards are torch.where)."""
            z = chain_vcycle(chain, w, cheby_order=cheby_order)
            if vertex_iters <= 0:
                return z
            coefs0 = chain["levels"][0]["coefs"]
            x, r, p, rz = torch.zeros_like(w), w, z, torch.dot(w, z)
            for _ in range(vertex_iters):
                Ap = stencil_apply(coefs0, p, dim)
                alpha = rz / krylov._safe(torch.dot(p, Ap))
                x = x + alpha * p
                r = r - alpha * Ap
                z = chain_vcycle(chain, r, cheby_order=cheby_order)
                rz_new = torch.dot(r, z)
                p = z + (rz_new / krylov._safe(rz)) * p
                rz = rz_new
            return x

        def prolong_from_vertex(v):
            Vt = v.to(dtype).reshape(vert_shape)
            for d, F in enumerate(P1):
                Vt = axis_contract(F, Vt, d)
            return [Vt * mask]

        def inner_precond(rr):
            fc = comp_dssum(rr, apply_mask=True)
            x = cheby_smooth(A_mf, comp_inv_diag, lmax0, fc, None, cheby_order)
            for _ in range(num_vcycles):
                r = [fc[0] - A_mf(x)[0]]
                v = vertex_solve(restrict_to_vertex(r))
                x = [x[0] + prolong_from_vertex(v)[0]]
                x = cheby_smooth(A_mf, comp_inv_diag, lmax0, fc, x,
                                 cheby_order)
            return x
    elif inner == "fem-amg":
        # G = 1: join / split are a flatten and a reshape of the group's
        # lattice, and the composite mask is the group's mask
        amg_apply = composite_preconditioner(amg, cheby_order=cheby_order,
                                             num_cycles=num_vcycles)
        comp_mask = mask.reshape(-1)

        def inner_precond(rr):
            return [(amg_apply(rr[0].reshape(-1)) * comp_mask)
                    .reshape(mask.shape)]
    elif inner == "jacobi":
        def inner_precond(rr):
            return [comp_dssum(rr, apply_mask=True)[0] * comp_inv_diag[0]]
    else:
        def inner_precond(rr):
            return comp_dssum(rr, apply_mask=True)

    extra = {"groups": [{"geom": geom, "mask": mask, "weight": weight,
                         "D": D}]}
    if amg is not None:
        extra["amg"] = amg
    if setup_seconds:
        extra["setup_seconds"] = setup_seconds

    def build(arrays, extra_, ops):
        _, dssum_f, _, _ = ops

        def _solve_inner(r):
            # STYPE -> PTYPE cast at the tree-operator boundary; with one
            # group the composite right-hand side is the residual itself
            f_comp = [r.to(dtype)]
            dssum_c = lambda rr: comp_dssum(rr, apply_mask=True)
            if inner_solver == "fcg":
                res = krylov.fcg(
                    comp_operator, inner_precond, dssum_c, comp_dot,
                    comp_dot2, f_comp, max_iterations=num_iterations,
                    tolerance=0.0)
            else:
                res = krylov.fgmres(
                    comp_operator, inner_precond, dssum_c, comp_dot, f_comp,
                    max_iterations=num_iterations,
                    num_vectors=num_iterations, tolerance=0.0)
            z = res.u[0].to(domain.dtype)
            return (dssum_f(z, apply_mask=True, apply_weight=True),
                    res.residual_history)

        def precond(r):
            return _solve_inner(r)[0]

        # inner-solve observability: one application's inner history
        precond.probe = _solve_inner
        return precond

    return Preconditioner(build=build, extra=extra)
