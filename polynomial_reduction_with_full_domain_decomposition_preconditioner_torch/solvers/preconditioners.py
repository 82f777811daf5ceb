"""Preconditioners for the outer Krylov solve.

Port of the JAX package's ``solvers/preconditioners.py`` for 2-D and 3-D
partitions on one or more shards: the container, diagonal (Jacobi)
preconditioning on every partition and the polynomial-reduction
multilevel (p-multigrid) V-cycle on structured slab partitions. On P shards every level is partitioned alike and
its fields are stacked over the shards as the Domain's are. The
production preconditioner is ``solvers/subdomain.composite_dd``.

A Preconditioner carries
  build(arrays, extra, ops) -> (r -> z),
  extra: the preconditioner's own tensors,
and the returned z must be continuous and masked.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..mesh.layout import elements_to_lattice
from ..mesh.partition import partition_mesh
from ..ops import gather_scatter as gs
from ..ops import interp
from ..ops import sem
from ..utils.gll import diff_matrix, interp_matrix
from . import krylov
from .domain import top_planes

__all__ = ["Preconditioner", "jacobi", "pmultigrid"]


@dataclass
class Preconditioner:
    build: Callable[[Any, Any, tuple], Callable]
    extra: Any = None


def _inv_diag(geom, D, dim, dssum):
    """Continuous inverse assembled diagonal as a lattice field."""
    diag_c = dssum(sem.stiffness_diagonal_lattice(geom, D, dim),
                   apply_mask=False)
    return torch.where(diag_c > 0, 1.0 / diag_c, torch.zeros_like(diag_c))


def jacobi(domain) -> Preconditioner:
    """Diagonal (Jacobi) preconditioning: z = Q diag(A_assembled)^-1 Qt r.

    Uses the exact matrix-free diagonal (ops/sem.stiffness_diagonal_lattice)
    summed to nodes; both QQt r and QQt diag are continuous point fields,
    so their ratio is continuous.
    """

    def build(arrays, extra, ops):
        _, dssum, _, _ = ops
        if domain.lattice_shape is None:
            # a generic partition: element-layout factors
            d = sem.stiffness_diagonal(arrays.geom, arrays.D, domain.dim)
            d = dssum(d.reshape(arrays.mask.shape), apply_mask=False)
            inv_diag = torch.where(d > 0, 1.0 / d, torch.zeros_like(d))
        else:
            inv_diag = _inv_diag(arrays.geom, arrays.D, domain.dim, dssum)

        def precond(r):
            return dssum(r, apply_mask=True) * inv_diag

        return precond

    return Preconditioner(build=build)


def _level_arrays(domain, orders, mesh_builder):
    """Lattice-layout device tensors for each coarse order on the same
    element grid, partitioned over the domain's shards (this process's
    own, ``domain.owned``): geometry and D in
    the domain's dtype, mask and inverse multiplicity stored as the
    Domain stores its own."""
    grid = domain.local_grid
    dim = domain.dim
    small = domain.arrays.mask.dtype
    levels = []
    for N_c in orders:
        sd = partition_mesh(mesh_builder(N_c), domain.sharded.num_shards,
                            structured=True, owned=domain.owned)
        if sd.structured.local_grid() != grid:
            raise ValueError(
                f"mesh_builder({N_c}) has element grid "
                f"{sd.structured.local_grid()}, the domain has {grid}")
        n_c = N_c + 1

        def put(arr, dt):
            return domain.shard_put(np.stack(
                [elements_to_lattice(a, grid, n_c, dim) for a in arr]), dt)

        levels.append({
            "geom": tuple(put(sd.geom[..., k], domain.dtype)
                          for k in range(sd.geom.shape[-1])),
            "mask": put(sd.dirichlet_mask, small),
            "inv_degree_pts": put(sd.inv_degree_pts, small),
            "D": torch.as_tensor(diff_matrix(n_c), dtype=domain.dtype,
                                 device=domain.device),
        })
    return levels


def pmultigrid(domain, mesh_builder, poly_reduction: int = None,
               orders: list[int] | None = None, n_coarse_iterations: int = 8,
               smooth_damping: float = 2.0 / 3.0) -> Preconditioner:
    """Polynomial-reduction multilevel (p-multigrid) preconditioner.

    The level hierarchy N, N-r, N-2r, ..., 1 with the tensor-product
    transfer operators, arranged as a V-cycle: damped-Jacobi smoothing per
    level, adjoint restriction of the non-assembled residual, a fixed
    number of Jacobi-CG iterations at order 1, and interpolation back up.
    All levels live in the point-lattice layout: every level's operator is
    the fused stiffness apply and its dssum the fused face sum, at that
    level's order; order transfer is per-element contractions
    (ops/interp.lattice_tensor_apply).

    mesh_builder(N_c) must return the *same element grid* meshed at order
    N_c (e.g. partial(kershaw_mesh, shape, epsilon=eps)).
    """
    if domain.sharded.structured is None:
        raise NotImplementedError(
            "pmultigrid currently requires a structured partition")

    N = domain.poly_degree
    if orders is None:
        r = poly_reduction if poly_reduction else max(N - 1, 1)
        orders = []
        k = N - r
        while k > 1:
            orders.append(k)
            k -= r
        orders.append(1)
    orders = list(orders)

    level_extra = _level_arrays(domain, orders, mesh_builder)
    all_orders = [N] + orders
    # 1-D transfer matrices between consecutive levels (J: coarse -> fine)
    Js = [torch.as_tensor(
        interp_matrix(all_orders[i + 1] + 1, all_orders[i] + 1),
        dtype=domain.dtype, device=domain.device)
        for i in range(len(orders))]
    extra = {"levels": level_extra, "J": Js}
    dim = domain.dim

    comm = domain.comm if domain.spmd else None
    ragged = domain.spmd and domain.ragged

    def build(arrays, extra, ops):
        operator_f, dssum_f, dot, dot2 = ops

        def level_ops(lvl, n_c):
            # each level's real top plane on ragged slabs
            top = (top_planes(arrays.layers, n_c, lvl["mask"].shape[1])
                   if ragged else None)

            def op(u):
                return sem.stiffness_apply_lattice(u, lvl["geom"], lvl["D"],
                                                   dim)

            def ds(u, apply_mask=True, apply_weight=False):
                return gs.structured_dssum(
                    u, n=n_c, dim=dim, mask=lvl["mask"],
                    inv_degree_pts=lvl["inv_degree_pts"], comm=comm,
                    apply_mask=apply_mask, apply_weight=apply_weight,
                    top_plane=top)

            return op, ds, _inv_diag(lvl["geom"], lvl["D"], dim, ds)

        lvls = [(operator_f, dssum_f,
                 _inv_diag(arrays.geom, arrays.D, dim, dssum_f))]
        for lvl, N_c in zip(extra["levels"], orders):
            lvls.append(level_ops(lvl, N_c + 1))

        omega = smooth_damping

        def smooth(l, z, r):
            op, ds, invd = lvls[l]
            res = r - op(z)
            return z + omega * invd * ds(res, apply_mask=True)

        def coarse_solve(r):
            op, ds, invd = lvls[-1]

            def precond_c(rr):
                return ds(rr, apply_mask=True) * invd

            # tolerance 1e-30 as the reference: the solve still ends early
            # on an (all but) exactly solved or NaN residual, so each step
            # reads one flag on the host
            res = krylov.fcg(op, precond_c,
                             lambda rr: ds(rr, apply_mask=True), dot, dot2,
                             r, max_iterations=n_coarse_iterations,
                             tolerance=1e-30)
            return res.u

        n_levels = len(lvls)

        def vcycle(l, r):
            if l == n_levels - 1:
                return coarse_solve(r)
            op, ds, invd = lvls[l]
            z = omega * invd * ds(r, apply_mask=True)      # pre-smooth
            res = r - op(z)                                # non-assembled
            rc = interp.lattice_tensor_apply(res, extra["J"][l].T, dim)
            zc = vcycle(l + 1, rc)
            z = z + interp.lattice_tensor_apply(zc, extra["J"][l], dim)
            return smooth(l, z, r)                          # post-smooth

        def precond(r):
            return vcycle(0, r)

        return precond

    return Preconditioner(build=build, extra=extra)
