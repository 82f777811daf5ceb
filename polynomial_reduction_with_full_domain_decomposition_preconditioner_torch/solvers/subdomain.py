"""Full-domain-decomposition + polynomial-reduction preconditioner.

Port of the JAX package's ``solvers/subdomain.composite_dd`` for
structured slab partitions: the matrix-free hybrid inner preconditioner
(inner="amg"), the assembled composite FEM hierarchy ("fem-amg"), the
assembled-diagonal stand-in ("jacobi") or plain QQt ("none"), under a
fixed inner FGMRES or FCG.

One shard: the composite problem is the whole domain at order N, a
single layer group (G=1): the composite operator is the SEM apply (kernel
K1), the composite dssum the one-pass face sum with the mask fused in
(kernel K2), and the outer residual enters the composite unchanged (the
restriction cascade feeds only ring and far groups, which one shard does
not have, so it is not computed). With inner="amg" each inner step is
preconditioned by Chebyshev smoothing on the composite operator plus a
vertex-grid correction in >= f32: one chain V-cycle, or ``vertex_iters``
PCG steps preconditioned by it. With inner="fem-amg" each inner step is
preconditioned by a V-cycle on the composite problem reassembled as a
low-order FEM matrix (amg/composite.build_composite_hierarchy, packed in
the ptype by amg/vcycle.pack_hierarchies): Q^T, the V-cycle and Q on the
flattened group lattice, then the group mask.

P > 1 shards (``_composite_shards``): every shard's composite covers the
whole domain as a cyclic stack of G layer groups: its own slab at order
N, rings of V layers at orders N-r, ..., 1 from the neighbours, and the
far field at order 1, z-merged by ``far_coarsen`` where the partition is
aligned. Every group is one (P, layers*n, My, Mx) tensor over the shards:
the composite operator is one K1 launch a group, the composite dssum one
batched K2 launch a group (cross-order faces collapse and spread through
J (x) J plane contractions around it), ring blocks come from the
neighbours by the comm's cyclic shift and the far field from one
all-gather of the coarsest restricted level. Ragged slabs (q or q+1
layers) carry pad slots in the own and far groups, with per-shard
interface planes and row tables built on the host. The inner solve is
rank-local: every shard runs its own Krylov recurrence
(krylov ``batched=True``, per-shard dots ``krylov.shard_dot``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..amg.composite import (_block_grid_coords, build_composite_hierarchy,
                             pad_hier_dofs, vertex_q1_hierarchy)
from ..amg.vcycle import (cheby_smooth, chain_vcycle,
                          composite_preconditioner, pack_chain,
                          pack_hierarchies)
from ..mesh.generator import geometric_factors
from ..mesh.layout import elements_to_lattice
from ..ops import sem
from ..ops.interp import axis_contract, lattice_tensor_apply
from ..ops.kernels import lattice_face_sum_3d
from ..ops.stencil import stencil_apply
from ..runtime.checkpoint import load_chain_info, save_chain_info
from ..utils.gll import diff_matrix, gll_points_weights, interp_matrix
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

    domain: the fine-level Domain: structured (one or more slab shards),
      or an unstructured partition, which goes to
      solvers/unstructured.composite_dd_unstructured (``chain_cache`` is
      then its ``setup_cache``).
    mesh_builder(N_c): the same element grid meshed at order N_c.
    poly_reduction: order step of the level hierarchy N, N-r, ..., 1.
    subdomain_overlap: ring thickness in layers (checked against the
      slab depth, as in the reference).
    superdomain_overlap: with far_coarsen > 1, this many merged-layer
      widths of fine order-1 layers are kept on each side of the
      compressed far field; no effect otherwise (one shard has no far
      field).
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
    far_coarsen: far-field z element-merge factor, "auto" (the largest
      aligned factor in {8, 4, 2, 1}; always 1 for fem-amg and on ragged
      slabs) or an integer. A factor > 1 raises ValueError where it is
      misaligned, on ragged slabs, with inner="fem-amg", and on one shard
      (whose composite has no far field to compress).
    fine_mesh: the order-N mesh if already built (must equal
      mesh_builder(N)).
    chain_cache: path of an npz checkpoint of the vertex chain
      (runtime/checkpoint.save_chain_info): loaded if the file exists, else
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
        # generic (non-slab) partitions: the unstructured composite
        from .unstructured import composite_dd_unstructured
        if far_coarsen not in ("auto", 1):
            raise ValueError("far_coarsen requires a structured slab "
                             "partition (z-layer merging)")
        return composite_dd_unstructured(
            domain, mesh_builder, poly_reduction,
            subdomain_overlap=subdomain_overlap,
            superdomain_overlap=superdomain_overlap,
            num_iterations=num_iterations, inner=inner,
            inner_solver=inner_solver, num_vcycles=num_vcycles,
            cheby_order=cheby_order, ptype=ptype, max_coarse=max_coarse,
            fine_mesh=fine_mesh, setup_cache=chain_cache)
    if sd.num_shards > 1:
        return _composite_shards(
            domain, mesh_builder, poly_reduction, subdomain_overlap,
            superdomain_overlap, num_iterations, inner, inner_solver,
            num_vcycles, cheby_order, ptype, max_coarse, far_coarsen,
            fine_mesh, chain_cache, vertex_iters, chain_info)
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
        chain_info = _chain_info(chain_info, chain_cache,
                                 lambda: mesh_builder(1), plane_shape,
                                 m_last, dim, max_coarse)
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

    def A_mf(x):
        return comp_dssum(comp_operator(x), apply_mask=True)

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
            # group the composite right-hand side is the residual itself.
            # The rank-local inner solve of every shard count, on the
            # (1, ...) stack of the one shard
            f_comp = [r.to(dtype)[None]]
            res = _rank_local_solve(
                _on_stack(comp_operator), _on_stack(inner_precond),
                _on_stack(lambda rr: comp_dssum(rr, apply_mask=True)),
                f_comp, inner_solver, num_iterations)
            z = res.u[0][0].to(domain.dtype)
            return (dssum_f(z, apply_mask=True, apply_weight=True),
                    res.residual_history[:, 0])

        def precond(r):
            return _solve_inner(r)[0]

        # inner-solve observability: one application's inner history, and
        # the composite ops (as at P > 1)
        precond.probe = _solve_inner
        precond.tree_rhs = lambda r: [r.to(dtype)]
        precond.comp_dssum = comp_dssum
        precond.comp_operator = comp_operator
        return precond

    return Preconditioner(build=build, extra=extra)


def _on_stack(fn):
    """A composite op on one shard's parts as an op on their (1, ...)
    stacks (views both ways)."""
    return lambda parts: [x[None] for x in fn([p[0] for p in parts])]


def _rank_local_solve(operator, precond, dssum_c, f_comp, inner_solver,
                      num_iterations):
    """The composite's fixed inner FGMRES or FCG, rank-local: every shard
    of the stacked parts (leading axis P >= 1) runs its own recurrence
    with its own dots (krylov ``batched=True``, ``shard_dot``), ending and
    restarting its FGMRES cycle at a breakdown as the JAX package's
    per-shard loop does."""
    dot = krylov.shard_dot
    if inner_solver == "fcg":
        return krylov.fcg(operator, precond, dssum_c, dot,
                          lambda a, b, c, d: (dot(a, b), dot(c, d)), f_comp,
                          max_iterations=num_iterations, tolerance=0.0,
                          batched=True)
    return krylov.fgmres(operator, precond, dssum_c, dot, f_comp,
                         max_iterations=num_iterations,
                         num_vectors=num_iterations, tolerance=0.0,
                         batched=True)


def _chain_info(chain_info, chain_cache, mesh1, plane_shape, m_last, dim,
                max_coarse):
    """The vertex chain of inner="amg": ``chain_info`` as given, else the
    ``chain_cache`` npz if it exists, else built on the order-1 mesh
    ``mesh1()`` (and written to ``chain_cache`` when one is named)."""
    if chain_info is None and chain_cache is not None \
            and os.path.exists(chain_cache):
        chain_info = load_chain_info(chain_cache)
    if chain_info is None:
        chain_info = vertex_q1_hierarchy(mesh1(), plane_shape, m_last, dim,
                                         max_coarse=max_coarse)
        if chain_cache is not None:
            save_chain_info(chain_cache, chain_info)
    return chain_info


def _auto_far_zcoarse(S, V, L, m_last, sup_overlap: int = 1):
    """Largest F in {8, 4, 2} aligned for every shard: F must divide the
    own slab (shard bases), the ring extent (far start offset) and m_last,
    with room for the fine overlap layers plus >= 2 merged layers; else
    1."""
    far = m_last - S - 2 * V * L
    for F in (8, 4, 2):
        if far - 2 * sup_overlap * F >= 2 * F and far % F == 0 \
                and S % F == 0 and (V * L) % F == 0 and m_last % F == 0:
            return F
    return 1


def _z_coarsen_order1_mesh(mesh1, F: int, plane_shape, dim: int, device):
    """An order-1 mesh whose z element layers each merge F fine layers.

    The mesh family is vertex-warped trilinear, so the coarse mesh's
    vertex planes are exactly every F-th fine vertex plane. Returns an
    object with the mesh fields the composite setup reads (poly_degree,
    coords, geom, dirichlet_mask, node_degree)."""
    from types import SimpleNamespace
    m_last = mesh1.elem_shape[-1]
    blocks = [_block_grid_coords(mesh1, q, plane_shape, dim)
              for q in range(m_last)]
    X = np.concatenate([blocks[0]] + [b[1:] for b in blocks[1:]], axis=0)
    Xc = X[::F]                      # (m_last/F + 1, my+1, mx+1, dim)
    vshape = Xc.shape[:-1]
    rev_elems = tuple(s - 1 for s in vshape)      # (mzc, my, mx)
    E = int(np.prod(rev_elems))

    # element corner coords (E, 2, 2, 2, dim), x-fastest element ordering
    corners = np.empty((E,) + (2,) * dim + (dim,))
    grids = np.indices(rev_elems).reshape(dim, -1)   # (dim, E) z-major
    for loc in np.ndindex(*(2,) * dim):
        sel = tuple(grids[d] + loc[d] for d in range(dim))
        corners[(slice(None),) + loc] = Xc[sel]
    coords = corners.reshape(E, 2 ** dim, dim)
    geom, _ = geometric_factors(coords, dim, 1, device=device)

    # closed-form vertex multiplicity and boundary mask on the tensor grid
    deg = np.ones(vshape)
    mask = np.ones(vshape)
    for d in range(dim):
        idx = np.arange(vshape[d])
        interior = (idx > 0) & (idx < vshape[d] - 1)
        shp = [1] * dim
        shp[d] = vshape[d]
        deg = deg * np.where(interior, 2.0, 1.0).reshape(shp)
        mask = mask * interior.astype(float).reshape(shp)

    def per_elem(field):
        out = np.empty((E,) + (2,) * dim)
        for loc in np.ndindex(*(2,) * dim):
            sel = tuple(grids[d] + loc[d] for d in range(dim))
            out[(slice(None),) + loc] = field[sel]
        return out.reshape(E, 2 ** dim)

    return SimpleNamespace(
        poly_degree=1,
        elem_shape=tuple(reversed(rev_elems[1:])) + (rev_elems[0],),
        coords=coords, geom=geom, dirichlet_mask=per_elem(mask),
        node_degree=per_elem(deg).astype(np.int32))


def _composite_shards(domain, mesh_builder, poly_reduction, V, sup_overlap,
                      num_iterations, inner, inner_solver, num_vcycles,
                      cheby_order, ptype, max_coarse, far_coarsen,
                      fine_mesh, chain_cache, vertex_iters, chain_info):
    """composite_dd on P > 1 slab shards (the JAX package's
    ``composite_dd`` under ``shard_map``, subdomain.py:300-1210): every
    tensor carries the leading shard axis, every collective is the
    domain's comm. A process of a multi-process run builds the host
    tables of its own shards only (``domain.owned``, the leading axis of
    every stack); what indexes the global shards (the all-gathered far
    field's rows, the physical layers) stays global."""
    sd = domain.sharded
    comm = domain.comm
    dim = domain.dim
    N = domain.poly_degree
    dtype = ptype if ptype is not None else domain.dtype
    device = domain.device
    Pn = sd.num_shards
    owned = domain.owned                     # this process's shards
    Po = domain.num_owned
    elem_shape = sd.structured.elem_shape
    m_last = elem_shape[-1]
    counts = sd.structured.layer_counts      # real layers per shard
    bases = sd.structured.layer_starts       # first physical layer
    S = sd.structured.slab_elems             # padded slab slots (= max)
    ragged = sd.structured.ragged
    if min(counts) < 1:
        raise ValueError(
            f"every shard needs >= 1 element layer: {m_last} layers over "
            f"{Pn} shards leaves empty shards")
    plane_shape = tuple(reversed(elem_shape[:-1]))  # (my, mx)

    # level hierarchy N, N-r, ..., 1
    orders = [N]
    while orders[-1] > 1:
        orders.append(max(orders[-1] - poly_reduction, 1))
    L = len(orders)
    if min(counts) < V * L:
        raise ValueError(
            f"own slab (min {min(counts)} layers) must cover the ring "
            f"depth ({V * L}) so rings come from nearest neighbors only")

    if ragged:
        # uneven slabs: the own and far groups carry trailing pad layers
        # so all shards share static shapes; compression assumes
        # layer-aligned shard boundaries
        if far_coarsen not in ("auto", 1) and int(far_coarsen) > 1:
            raise ValueError(
                "far_coarsen > 1 requires the shard count to divide the "
                f"last element dimension ({m_last} layers, {Pn} shards)")
        Fz = 1
        if m_last - max(counts) - 2 * V * L < 1:
            raise ValueError(
                f"mesh too small for uneven slabs: the largest shard "
                f"({max(counts)} layers) plus rings (2x{V * L}) must leave "
                f">= 1 far layer of {m_last}")
        far_slot = m_last - min(counts) - 2 * V * L
        groups = _build_group_specs(S, V, L, orders,
                                    S + 2 * V * L + far_slot,
                                    far_zcoarse=1, sup_overlap=sup_overlap)
    else:
        if far_coarsen == "auto":
            # the assembled fem-amg hierarchy assumes fine layers
            Fz = (1 if inner == "fem-amg"
                  else _auto_far_zcoarse(S, V, L, m_last, sup_overlap))
        else:
            Fz = int(far_coarsen)
            if Fz > 1 and (S % Fz or (V * L) % Fz or m_last % Fz):
                raise ValueError(
                    f"far_coarsen={Fz} must divide the slab ({S}), the "
                    f"ring extent ({V * L}) and the layer count ({m_last})")
        if Fz > 1 and inner == "fem-amg":
            raise ValueError(
                "far_coarsen > 1 requires inner='amg' (the assembled "
                "fem-amg path assumes fine layers)")
        groups = _build_group_specs(S, V, L, orders, m_last, far_zcoarse=Fz,
                                    sup_overlap=sup_overlap)
    G = len(groups)
    # far-field groups sit between the rings above and the rings below
    far_idxs = list(range(1 + L, G - L)) if G > 1 + 2 * L else []
    far_set = set(far_idxs)

    order_set = sorted(set(g.order for g in groups) | set(orders))
    mesh_by_order = {o: (fine_mesh if o == N and fine_mesh is not None
                         else mesh_builder(o)) for o in order_set}
    mesh_far = (_z_coarsen_order1_mesh(mesh_by_order[1], Fz, plane_shape,
                                       dim, device) if Fz > 1 else None)

    def layer_slice(mesh_o, phys_layers, field):
        """Per-layer element data of the order-o mesh in lattice layout
        (len(layers) * n_o, MY_o, MX_o [, F]); -1 is a zero pad layer."""
        n_o = mesh_o.poly_degree + 1
        plane = int(np.prod(plane_shape))
        a = np.asarray(field)
        row_shape = ((n_o,) + tuple(ps * n_o for ps in plane_shape)
                     + tuple(a.shape[2:]))
        rows = [elements_to_lattice(a[lz * plane:(lz + 1) * plane],
                                    (1,) + plane_shape, n_o, dim)
                if lz >= 0 else np.zeros(row_shape)
                for lz in phys_layers]
        return np.concatenate(rows, axis=0)

    def group_phys(g, gi, p):
        """Physical fine layer of each of the group's slots (z-merged
        groups: the first merged fine layer); -1 marks pad slots."""
        s, b = counts[p], bases[p]
        if not ragged:
            return [(b + g.start_pos + k * g.zcoarse) % m_last
                    for k in range(g.layers)]
        # uneven slabs: slots between own and far shift by the shard's
        # deficit (s - S); groups after the far pads sit at
        # shard-independent positions
        if gi == 0:
            off, real = 0, s
        elif far_set and gi > min(far_set):
            off, real = g.start_pos - S + min(counts), g.layers
        elif gi in far_set:
            off, real = g.start_pos + (s - S), m_last - s - 2 * V * L
        else:
            off, real = g.start_pos + (s - S), g.layers
        return ([(b + off + k) % m_last for k in range(real)]
                + [-1] * (g.layers - real))

    phys_lists = [[group_phys(g, gi, p) for gi, g in enumerate(groups)]
                  for p in range(Pn)]
    # interface gi -> gi+1 is physical unless it sits on the global z
    # boundary (the one wrap-around interface of each shard's cyclic stack)
    adj = np.array([[0.0 if phys_lists[p][(gi + 1) % G][0] == 0 else 1.0
                     for gi in range(G)] for p in owned])

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a),
                               device=device).to(dtype)

    gdata = []     # per group: geometry, mask, weight, (P, lattice) each
    for gi, g in enumerate(groups):
        mesh_o = mesh_far if g.zcoarse > 1 else mesh_by_order[g.order]
        geoms, masks, wts = [], [], []
        for p in owned:
            phys = phys_lists[p][gi]
            if g.zcoarse > 1:
                phys = [q // g.zcoarse if q >= 0 else -1 for q in phys]
            geoms.append(layer_slice(mesh_o, phys, mesh_o.geom))
            masks.append(layer_slice(mesh_o, phys,
                                     mesh_o.dirichlet_mask[..., None])[..., 0])
            wts.append(layer_slice(
                mesh_o, phys,
                (1.0 / mesh_o.node_degree.astype(np.float64))[..., None])[..., 0])
        gdata.append({
            "geom": tuple(put(np.stack([gl[..., k] for gl in geoms]))
                          for k in range(geoms[0].shape[-1])),
            "mask": put(np.stack(masks)),
            "weight": put(np.stack(wts)),
            "D": torch.as_tensor(diff_matrix(g.order + 1), device=device
                                 ).to(dtype),
            "n": g.order + 1,
        })
    adj_t = put(adj)
    adj_g = [adj_t[:, gi].reshape(Po, 1, 1) for gi in range(G)]

    # interface (coarse -> fine, 1-D) and cascade matrices
    Jmats = {}
    for gi in range(G):
        o_a, o_b = groups[gi].order, groups[(gi + 1) % G].order
        key = (min(o_a, o_b), max(o_a, o_b))
        if key not in Jmats:
            Jmats[key] = put(interp_matrix(key[0] + 1, key[1] + 1))
    Jlvl = [put(interp_matrix(orders[i + 1] + 1, orders[i] + 1))
            for i in range(L - 1)]
    n_lvl = [o + 1 for o in orders]
    n_c = n_lvl[-1]

    def rows_t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    # ragged slabs: each shard's real top planes of the own and far groups
    # (the dynamic interface planes) and the sender's rows of each
    # below-ring block, as gather indices built here
    dyn_top = {}
    below_rows = {}
    if ragged:
        dyn_top[0] = rows_t([counts[p] * n_lvl[0] - 1 for p in owned])
        if far_idxs:
            dyn_top[far_idxs[0]] = rows_t(
                [(m_last - counts[p] - 2 * V * L) * n_c - 1
                 for p in owned])
        for gi in dyn_top:
            if groups[gi].order != groups[(gi + 1) % G].order:
                raise AssertionError("a dynamic-plane group must meet a "
                                     "same-order neighbour")
        for l in range(L):
            nl = n_lvl[l]
            below_rows[l] = rows_t([[(counts[p] - (l + 1) * V) * nl + k
                                     for k in range(V * nl)]
                                    for p in owned])

    # far field: each shard's rows of the all-gathered coarsest level (P S
    # n_c rows, shard-major), rolled to its cyclic frame and sliced per far
    # group; on ragged slabs compacted to physical order first and the
    # far group's pad rows zeroed by ``far_zmask``
    far_rows, far_zmask = [], None
    if far_idxs:
        M = m_last * n_c
        if ragged:
            phys_rows = [(p * S + j) * n_c + i for p in range(Pn)
                         for j in range(counts[p]) for i in range(n_c)]
            fg = groups[far_idxs[0]]
            R = fg.layers * n_c
            far_rows.append(rows_t([[phys_rows[((bases[p] + counts[p] + V * L)
                                                * n_c + k) % M]
                                     for k in range(R)] for p in owned]))
            far_zmask = put([[1.0 if k < (m_last - counts[p] - 2 * V * L)
                              * n_c else 0.0 for k in range(R)]
                             for p in owned]).reshape(Po, R, 1, 1)
        else:
            for fi in far_idxs:
                fg = groups[fi]
                far_rows.append(rows_t(
                    [[(p * S * n_c + fg.start_pos * n_c + k) % M
                      for k in range(fg.fine_extent * n_c)]
                     for p in owned]))
    Rzfar = None
    if Fz > 1:
        # z restriction fine far -> merged far layers (order-1 linear
        # shape functions of the merged layer at the fine planes)
        fg = next(g for g in groups if g.zcoarse > 1)
        nf, nc = fg.fine_extent, fg.layers
        Pz = np.zeros((2 * nf, 2 * nc))
        for k in range(2 * nf):
            e, i = divmod(k, 2)
            c = min(e // Fz, nc - 1)
            t = (e + i - c * Fz) / Fz
            Pz[k, 2 * c] += 1.0 - t
            Pz[k, 2 * c + 1] += t
        Rzfar = put(Pz.T)

    # ---- composite ops: fields are lists of (P, lattice) group stacks ----
    def top_of(gi, U):
        if gi in dyn_top:
            idx = dyn_top[gi].view(-1, 1, 1, 1).expand(-1, 1, *U.shape[2:])
            return torch.gather(U, 1, idx)[:, 0]
        return U[:, -1]

    def add_top(gi, U, val):
        if gi in dyn_top:
            idx = dyn_top[gi].view(-1, 1, 1, 1).expand(-1, 1, *U.shape[2:])
            U.scatter_add_(1, idx, val[:, None])
        else:
            U[:, -1] += val

    def plane_to_coarse(plane, of, oc):
        return lattice_tensor_apply(plane, Jmats[(oc, of)].T, dim - 1)

    def plane_to_fine(plane, of, oc):
        return lattice_tensor_apply(plane, Jmats[(oc, of)], dim - 1)

    def comp_operator(parts):
        return [sem.stiffness_apply_lattice(U, gd["geom"], gd["D"], dim)
                for gd, U in zip(gdata, parts)]

    def comp_assemble(parts):
        """Fine interface faces collapse onto coarse planes (the adjoint
        of the hanging-node constraints), then each group's conforming
        face sum: one batched K2 launch a group, without the mask."""
        lo, hi = [None] * G, [None] * G
        for gi in range(G):
            gj = (gi + 1) % G
            o_i, o_j = groups[gi].order, groups[gj].order
            a = adj_g[gi]
            top = top_of(gi, parts[gi])
            bot = parts[gj][:, 0]
            if o_i == o_j:
                lo[gi] = a * bot
                hi[gj] = a * top
            elif o_i > o_j:
                hi[gj] = a * plane_to_coarse(top, o_i, o_j)
            else:
                lo[gi] = a * plane_to_coarse(bot, o_j, o_i)
        summed = []
        for gi in range(G):
            U = parts[gi].clone()
            if hi[gi] is not None:
                U[:, 0] += hi[gi]
            if lo[gi] is not None:
                add_top(gi, U, lo[gi])
            summed.append(lattice_face_sum_3d(U, gdata[gi]["n"]))
        return summed

    def comp_dssum(parts, apply_mask=True):
        out = comp_assemble(parts)
        # the assembled coarse plane spreads back onto the fine side
        for gi in range(G):
            gj = (gi + 1) % G
            o_i, o_j = groups[gi].order, groups[gj].order
            a = adj_g[gi]
            if o_i > o_j:
                fine = plane_to_fine(out[gj][:, 0], o_i, o_j)
                out[gi][:, -1] = a * fine + (1.0 - a) * out[gi][:, -1]
            elif o_i < o_j:
                fine = plane_to_fine(out[gi][:, -1], o_j, o_i)
                out[gj][:, 0] = a * fine + (1.0 - a) * out[gj][:, 0]
        if apply_mask:
            for U, gd in zip(out, gdata):
                U.mul_(gd["mask"])
        return out

    comp_dot = krylov.shard_dot

    def tree_cascade(r):
        # restriction cascade on the own slab (order N -> ... -> 1)
        r_lvl = [r]
        for Jl in Jlvl:
            r_lvl.append(lattice_tensor_apply(r_lvl[-1], Jl.T, dim))
        return r_lvl

    def rings_above(r_lvl):
        # level l from the shard above: its layers [l V, (l + 1) V)
        out = []
        for l in range(L):
            nl = n_lvl[l]
            block = r_lvl[l][:, l * V * nl:(l + 1) * V * nl]
            out.append(comm.cyclic_shift(block, 1).contiguous())
        return out

    def rings_below(r_lvl):
        # levels L-1 ... 0 from the shard below: its real top V layers
        out = []
        for l in range(L - 1, -1, -1):
            nl = n_lvl[l]
            if ragged:
                idx = below_rows[l].view(Po, -1, 1, 1).expand(
                    -1, -1, *r_lvl[l].shape[2:])
                block = torch.gather(r_lvl[l], 1, idx)
            else:
                block = r_lvl[l][:, (S - (l + 1) * V) * nl:(S - l * V) * nl]
            out.append(comm.cyclic_shift(block, -1).contiguous())
        return out

    def far_parts(r_lvl):
        # one all-gather of the coarsest level, then each shard's rows
        if not far_idxs:
            return []
        full = comm.all_gather(r_lvl[-1])
        out = []
        for fi, rows in zip(far_idxs, far_rows):
            far = full.index_select(0, rows.reshape(-1)).view(
                (Po, -1) + tuple(full.shape[1:]))
            if far_zmask is not None:
                far = far * far_zmask
            if groups[fi].zcoarse > 1:
                far = axis_contract(Rzfar, far, 1).contiguous()
            out.append(far)
        return out

    def tree_rhs(r):
        r_lvl = tree_cascade(r)
        return ([r_lvl[0]] + rings_above(r_lvl) + far_parts(r_lvl)
                + rings_below(r_lvl))

    def comp_inv_diag():
        diag = [sem.stiffness_diagonal_lattice(gd["geom"], gd["D"], dim)
                for gd in gdata]
        return [torch.where(d > 0, 1.0 / d, torch.zeros_like(d))
                for d in comp_dssum(diag, apply_mask=False)]

    def A_mf(x):
        return comp_dssum(comp_operator(x), apply_mask=True)

    amg = None
    setup_seconds = {}
    if inner == "amg":
        chain_info = _chain_info(chain_info, chain_cache,
                                 lambda: mesh_by_order[1], plane_shape,
                                 m_last, dim, max_coarse)
        chain_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
        chain = pack_chain(chain_info, dtype=chain_dtype, device=device)
        vert_shape = (m_last + 1,) + tuple(ps + 1 for ps in plane_shape)
        # trilinear vertex -> lattice factors: per group one dense matrix
        # per plane axis (replicated) and a z factor per shard (its
        # cyclic physical layers; pad slots are zero rows)
        P1p, P1z = [], []
        for gi, g in enumerate(groups):
            n_o = g.order + 1
            r_, _ = gll_points_weights(n_o)
            t = (r_ + 1.0) / 2.0
            facs = []
            for ps in plane_shape:
                F = np.zeros((ps * n_o, ps + 1))
                for e in range(ps):
                    F[e * n_o:(e + 1) * n_o, e] = 1.0 - t
                    F[e * n_o:(e + 1) * n_o, e + 1] = t
                facs.append(put(F))
            P1p.append(facs)
            mats = np.zeros((Po, g.layers * n_o, m_last + 1))
            for j, p in enumerate(owned):
                for k, q in enumerate(phys_lists[p][gi]):
                    if q < 0:
                        continue
                    mats[j, k * n_o:(k + 1) * n_o, q] = 1.0 - t
                    mats[j, k * n_o:(k + 1) * n_o, q + g.zcoarse] = t
            P1z.append(put(mats))
        comp_invd = comp_inv_diag()

        # Chebyshev bound per shard: lambda_max(D^-1 A) of its composite
        # operator by 20 power-iteration steps with rank-local dots, x 1.1
        x, off = [], 0
        for gd in gdata:
            m = gd["mask"]
            sz = m[0].numel()
            base = (torch.arange(sz, dtype=torch.float64, device=device)
                    .to(dtype) + off) * 0.7311
            x.append(torch.sin(base).reshape(m.shape[1:]) * m)
            off += sz
        w = [gd["weight"] for gd in gdata]

        def wdot(a, b):
            return comp_dot([wl * al for wl, al in zip(w, a)], b)

        lam = None
        for _ in range(20):
            y = [iv * ax for iv, ax in zip(comp_invd, A_mf(x))]
            num = wdot(y, y)
            den = torch.clamp(wdot(x, x), min=1e-30)
            lam = torch.sqrt(num / den)
            scale = 1.0 / torch.clamp(torch.sqrt(num), min=1e-30)
            x = [krylov._bc(scale, yl) * yl for yl in y]
        lmax0 = (lam * 1.1).reshape(Po, 1, 1, 1)
        amg = {"chain": chain, "P1p": P1p, "P1z": P1z, "lmax0": lmax0}

        def restrict_to_vertex(parts):
            acc = None
            for gi in range(G):
                U = parts[gi] * gdata[gi]["weight"]
                Vt = torch.bmm(P1z[gi].transpose(1, 2),
                               U.reshape(Po, U.shape[1], -1))
                Vt = Vt.reshape((Po, m_last + 1) + tuple(U.shape[2:]))
                for d, F in enumerate(P1p[gi]):
                    Vt = axis_contract(F.T, Vt, d + 2)
                acc = Vt if acc is None else acc + Vt
            return acc.reshape(Po, -1).to(chain_dtype) * chain["masks"][0]

        def vertex_solve(wv):
            """One chain V-cycle per shard, or vertex_iters fixed PCG
            steps preconditioned by it with per-shard scalars."""
            z = chain_vcycle(chain, wv, cheby_order=cheby_order)
            if vertex_iters <= 0:
                return z
            coefs0 = chain["levels"][0]["coefs"]
            xv, r, p, rz = torch.zeros_like(wv), wv, z, comp_dot(wv, z)
            for _ in range(vertex_iters):
                Ap = stencil_apply(coefs0, p, dim)
                alpha = (rz / krylov._safe(comp_dot(p, Ap)))[:, None]
                xv = xv + alpha * p
                r = r - alpha * Ap
                z = chain_vcycle(chain, r, cheby_order=cheby_order)
                rz_new = comp_dot(r, z)
                p = z + (rz_new / krylov._safe(rz))[:, None] * p
                rz = rz_new
            return xv

        def prolong_from_vertex(v):
            V0 = v.to(dtype).reshape(Po, m_last + 1, -1)
            outs = []
            for gi in range(G):
                Vt = torch.bmm(P1z[gi], V0).reshape(
                    (Po, P1z[gi].shape[1]) + vert_shape[1:])
                for d, F in enumerate(P1p[gi]):
                    Vt = axis_contract(F, Vt, d + 2)
                outs.append(Vt * gdata[gi]["mask"])
            return outs

        def inner_precond(rr):
            fc = comp_dssum(rr, apply_mask=True)
            x = cheby_smooth(A_mf, comp_invd, lmax0, fc, None, cheby_order)
            for _ in range(num_vcycles):
                r = [a - b for a, b in zip(fc, A_mf(x))]
                v = vertex_solve(restrict_to_vertex(r))
                x = [a + b for a, b in zip(x, prolong_from_vertex(v))]
                x = cheby_smooth(A_mf, comp_invd, lmax0, fc, x, cheby_order)
            return x
    elif inner == "fem-amg":
        # one assembled hierarchy per shard (ragged: pad slots are zero Q
        # rows, DOF counts padded to the largest), packed block-diagonal.
        # A multi-process run builds every shard's (the padded sizes are
        # global) and packs its own, as the JAX package does
        shard_set = list(range(Pn)) if domain.multiprocess else list(owned)
        hiers = [build_composite_hierarchy(
            groups, mesh_by_order, plane_shape, m_last, bases[p], dim,
            max_coarse=max_coarse,
            phys_by_group=phys_lists[p] if ragged else None)
            for p in shard_set]
        if ragged:
            pad_hier_dofs(hiers)
        t0 = time.perf_counter()
        amg = pack_hierarchies(hiers, dtype=dtype, device=device,
                               stacked=True,
                               select=[shard_set.index(p) for p in owned])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_seconds = {k: sum(h.setup_seconds[k] for h in hiers)
                         for k in hiers[0].setup_seconds}
        setup_seconds["pack"] = time.perf_counter() - t0
        amg_apply = composite_preconditioner(amg, cheby_order=cheby_order,
                                             num_cycles=num_vcycles)
        comp_mask = torch.cat([gd["mask"].reshape(Po, -1) for gd in gdata],
                              dim=1)
        sizes = [gd["mask"][0].numel() for gd in gdata]

        def inner_precond(rr):
            flat = torch.cat([g.reshape(Po, -1) for g in rr], dim=1)
            out = amg_apply(flat) * comp_mask
            parts, off = [], 0
            for g, sz in zip(rr, sizes):
                parts.append(out[:, off:off + sz].reshape(g.shape)
                             .contiguous())
                off += sz
            return parts
    elif inner == "jacobi":
        comp_invd = comp_inv_diag()

        def inner_precond(rr):
            return [d * iv for d, iv in zip(comp_dssum(rr, apply_mask=True),
                                            comp_invd)]
    else:
        def inner_precond(rr):
            return comp_dssum(rr, apply_mask=True)

    extra = {"groups": gdata, "specs": groups, "adj": adj_t}
    if amg is not None:
        extra["amg"] = amg
    if setup_seconds:
        extra["setup_seconds"] = setup_seconds

    def build(arrays, extra_, ops):
        _, dssum_f, _, _ = ops

        def _solve_inner(r):
            # STYPE -> PTYPE cast at the tree-operator boundary; each
            # shard solves its own composite problem
            f_comp = tree_rhs(r.to(dtype))
            res = _rank_local_solve(
                comp_operator, inner_precond,
                lambda rr: comp_dssum(rr, apply_mask=True), f_comp,
                inner_solver, num_iterations)
            # the own-slab group, cast back; the outer dssum stitches it
            z = res.u[0].to(domain.dtype)
            return (dssum_f(z, apply_mask=True, apply_weight=True),
                    res.residual_history)

        def precond(r):
            return _solve_inner(r)[0]

        def probe(r):
            # the shards' inner histories differ: the max over the shards,
            # as the JAX package's Domain.precond_probe reports them
            z, hist = _solve_inner(r)
            return z, torch.amax(hist, dim=-1)

        precond.probe = probe
        precond.tree_rhs = lambda r: tree_rhs(r.to(dtype))
        precond.comp_dssum = comp_dssum
        precond.comp_operator = comp_operator
        return precond

    return Preconditioner(build=build, extra=extra)
