"""The fine-level SEM Poisson problem ("Domain" layer).

Port of the JAX package's ``solvers/domain.py`` for one device and a
structured slab lattice: the device-resident geometry, the matrix-free
operator (kernel K1), the structured dssum (kernel K2), the outer Krylov
solves, manufactured solutions and the host <-> device field layout.
Fields are (Mz, My, Mx) tensors on ``device`` (None: the card).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..mesh.layout import elements_to_lattice, lattice_to_elements
from ..mesh.partition import ShardedDomain
from ..ops import gather_scatter as gs
from ..ops import sem
from ..utils.gll import diff_matrix
from . import krylov

__all__ = ["Domain"]


@dataclass
class DomainArrays:
    """Device-resident state: geometry as a tuple of 6 per-factor
    lattices, the Dirichlet mask and inverse multiplicities (lattices),
    and the differentiation matrix."""
    geom: tuple
    mask: torch.Tensor
    inv_degree_pts: torch.Tensor
    D: torch.Tensor


class Domain:
    """User-facing fine-level problem on one device.

    Args:
      sharded: host partition (mesh/partition.partition_mesh, one shard).
      dtype: solver precision (torch.float32 or torch.float64).
      device: None for the card (raises without CUDA), or e.g. "cpu".
    """

    def __init__(self, sharded: ShardedDomain, *, dtype=torch.float32,
                 device=None):
        if sharded.structured is None or sharded.num_shards != 1:
            raise NotImplementedError(
                "the port's Domain is one structured shard so far")
        if sharded.dim != 3:
            raise NotImplementedError("the port's Domain is 3-D")
        self.device = resolve_device(device)
        self.sharded = sharded
        self.dtype = dtype
        self.dim = sharded.dim
        self.poly_degree = sharded.poly_degree
        n = sharded.poly_degree + 1
        self.local_grid = sharded.structured.local_grid()
        self.lattice_shape = tuple(g * n for g in self.local_grid)

        lat = self._host_elem_to_lattice(sharded.geom[0])
        # mask is 0/1 and the structured inverse multiplicities are powers
        # of two, exact in bf16: an f32 domain stores them half-width
        small = torch.bfloat16 if dtype == torch.float32 else dtype
        put = lambda a, dt: torch.as_tensor(
            np.ascontiguousarray(a), device=self.device).to(dt)
        self.arrays = DomainArrays(
            geom=tuple(put(lat[..., k], dtype) for k in range(lat.shape[-1])),
            mask=put(self._host_elem_to_lattice(sharded.dirichlet_mask[0]),
                     small),
            inv_degree_pts=put(self._host_elem_to_lattice(
                sharded.inv_degree_pts[0]), small),
            D=put(diff_matrix(n), dtype),
        )

    # ---- layout conversion (host, numpy) ----

    def _host_elem_to_lattice(self, arr):
        return elements_to_lattice(arr, self.local_grid,
                                   self.poly_degree + 1, self.dim)

    def _host_lattice_to_elem(self, U):
        return lattice_to_elements(U, self.local_grid,
                                   self.poly_degree + 1, self.dim)

    # ---- closure builders ----

    def _ops(self):
        """(operator, dssum, dot, dot2) closures over the device arrays."""
        a = self.arrays
        n = self.poly_degree + 1

        def operator(u):
            return sem.stiffness_apply_lattice(u, a.geom, a.D, self.dim)

        def dssum(u, apply_mask=True, apply_weight=False):
            return gs.structured_dssum(
                u, n=n, dim=self.dim, mask=a.mask,
                inv_degree_pts=a.inv_degree_pts, apply_mask=apply_mask,
                apply_weight=apply_weight)

        def dot(x, y):
            return krylov.tree_dot(x, y)

        def dot2(x, y, z, w):
            return krylov.tree_dot(x, y), krylov.tree_dot(z, w)

        return operator, dssum, dot, dot2

    # ---- solvers ----

    def solver(self, method="fcg", precond=None, precond_builder=None,
               max_iterations=500, num_vectors=20, tolerance=None,
               use_relative=True, z_dtype=None):
        """A solve function f -> KrylovResult, converging to ``tolerance``
        times the initial residual norm (``use_relative``, the default) or
        to the absolute ``tolerance``.

        precond: a Preconditioner (solvers/preconditioners.py). Its closure
          is built once here.
        precond_builder: used when ``precond`` is None — a bare builder
          with no extra arrays, builder(arrays, None, ops) -> (r -> z).
          With neither, the unpreconditioned path z = QQt r with mask.
        z_dtype: FGMRES only — storage dtype of the flexible Z basis.
        """
        if tolerance is None:
            tolerance = 1.0e-7 if self.dtype == torch.float64 else 1.0e-4
        operator, dssum, dot, dot2 = self._ops()
        ops = (operator, dssum, dot, dot2)

        def dssum_plain(r):
            return dssum(r, apply_mask=True, apply_weight=False)

        if precond is not None:
            pre = precond.build(self.arrays, precond.extra, ops)
        elif precond_builder is not None:
            pre = precond_builder(self.arrays, None, ops)
        else:
            pre = dssum_plain
        if method == "fcg":
            return lambda f: krylov.fcg(
                operator, pre, dssum_plain, dot, dot2, f,
                max_iterations=max_iterations, tolerance=tolerance,
                use_relative=use_relative)
        if method == "fgmres":
            return lambda f: krylov.fgmres(
                operator, pre, dssum_plain, dot, f,
                max_iterations=max_iterations, num_vectors=num_vectors,
                tolerance=tolerance, use_relative=use_relative,
                z_dtype=z_dtype)
        raise ValueError(f"unknown method {method!r}")

    # ---- fields and manufactured solutions ----

    def points_shape(self):
        """Host-field shape: (points,)."""
        return (self.sharded.points_per_shard,)

    @property
    def field_shape(self):
        return self.lattice_shape

    def to_device_field(self, host_field: np.ndarray):
        """Element-ordered host values -> (Mz, My, Mx) device field."""
        vals = np.asarray(host_field).reshape(-1)
        lat = self._host_elem_to_lattice(vals)
        return torch.as_tensor(np.ascontiguousarray(lat),
                               device=self.device).to(self.dtype)

    def from_device_field(self, u) -> np.ndarray:
        """Device field -> element-ordered host values, shape (1, E*npe)."""
        vals = u.detach()
        if vals.dtype in (torch.bfloat16, torch.float16):
            vals = vals.float()
        vals = vals.cpu().numpy().reshape(self.field_shape)
        return self._host_lattice_to_elem(vals).reshape(1, -1)

    def dssum_field(self, u, apply_mask=True, apply_weight=False):
        _, dssum, _, _ = self._ops()
        return dssum(u, apply_mask=apply_mask, apply_weight=apply_weight)

    def apply_operator(self, u):
        operator, _, _, _ = self._ops()
        return operator(u)

    def precond_probe(self, precond):
        """(r) -> (z, inner_history) for preconditioners exposing a
        ``.probe`` (the composite's inner FGMRES residuals)."""
        fn = precond.build(self.arrays, precond.extra, self._ops())
        if not hasattr(fn, "probe"):
            raise ValueError("preconditioner has no inner-solve probe")
        return fn.probe

    def residual(self, u, f):
        """(r, ||r||): non-assembled residual and its assembled norm
        sqrt(<r, QQt r>)."""
        operator, dssum, dot, _ = self._ops()
        r = f - operator(u)
        rn = torch.sqrt(torch.clamp(
            dot(r, dssum(r, apply_mask=True, apply_weight=False)), min=0.0))
        return r, rn

    def _global_random_points(self, seed: int) -> np.ndarray:
        """Uniform random values in global element order."""
        st = self.sharded
        rng = np.random.default_rng(seed)
        return rng.random(st.num_total_elements * st.num_points_per_elem)

    def initial_function(self, function_id: int = 0, seed: int = 0):
        """Manufactured solutions ids 0-4, made continuous and masked by a
        dssum with Dirichlet mask and inverse-multiplicity weight."""
        st = self.sharded
        c = st.coords.reshape(-1, st.coords.shape[-1])
        x, y, z = c[:, 0], c[:, 1], c[:, 2]
        pi = np.pi
        base = np.sin(pi * x) * np.sin(pi * y) * np.sin(pi * z)
        if function_id == 0:
            vals = base
        elif function_id == 1:
            vals = base + np.sin(2 * pi * x) * np.sin(pi * y) * np.sin(pi * z)
        elif function_id == 2:
            vals = np.exp(x) * base
        elif function_id == 3:
            vals = base + 0.2 * self._global_random_points(seed)
        elif function_id == 4:
            vals = self._global_random_points(seed)
        else:
            raise ValueError(f"unknown function id {function_id}")
        u = self.to_device_field(vals)
        return self.dssum_field(u, apply_mask=True, apply_weight=True)

    def manufacture_rhs(self, u_star):
        """f = A u* (local apply, no dssum)."""
        return self.apply_operator(u_star)
