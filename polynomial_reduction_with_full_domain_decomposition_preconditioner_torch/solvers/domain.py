"""The fine-level SEM Poisson problem ("Domain" layer).

Port of the JAX package's ``solvers/domain.py``: the device-resident
geometry, the matrix-free operator, the dssum, the outer Krylov solves,
manufactured solutions and the host <-> device field layout. A
structured slab lattice runs the operator through kernel K1 and the
structured dssum through kernel K2 (and the slab exchange across
shards). A generic partition (``sharded.structured is None``: scrambled
or pebble-bed meshes, or ``structured=False``) keeps fields in the
element layout, flat (E*npe,) on one shard and (P, E*npe) stacked, with
the element-layout operator (ops/sem.stiffness_apply); its dssum is the
face-block dssum in 3-D (ops/face_dssum.py) and the ordered generic
gather / scatter dssum in 2-D (ops/gather_scatter.dssum), as the JAX
package chooses them, each with its interface psum through the comm.

The mesh is 3-D or 2-D; a 2-D field drops the z axis: (My, Mx) and (P,
My, Mx) on a structured slab partition.

One shard: fields are (Mz, My, Mx) tensors, as the JAX package's
single-device Domain holds them. P > 1 shards (the JAX package's SPMD
Domain under ``jax.shard_map``): the shard-local code runs once on
stacked tensors, fields (P, Mz, My, Mx) with every slab padded to the
largest and zero at padding, and the collectives come from a
``runtime/comm`` object (``LocalComm(P)``: all P shards in this process,
as the card runs them; ``ProcessComm(P)``: the shards split over the
processes of a ``torch.distributed`` group, each process holding only
its own, ``sharded.owned``). Tensors live on ``device`` (None: the
card).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..mesh.layout import elements_to_lattice, lattice_to_elements
from ..mesh.partition import ShardedDomain
from ..ops import face_dssum as fd
from ..ops import gather_scatter as gs
from ..ops import sem
from ..runtime.comm import LocalComm
from ..utils.gll import diff_matrix
from . import krylov

__all__ = ["Domain", "shard_face_plans"]


def shard_face_plans(sd):
    """Each shard's face plan (ops/face_dssum.build_face_plan) from its
    global node ids, global multiplicities and interface nodes."""
    n = sd.poly_degree + 1
    plans = []
    for k in range(sd.num_owned):
        ivd = sd.inv_degree_pts[k]
        deg = np.where(ivd > 0, np.round(1.0 / np.maximum(ivd, 1e-30)),
                       0.0).astype(np.int64)
        glo_k = sd.glo_num[k].reshape(-1)
        uniq_k = np.unique(glo_k[glo_k >= 0])
        bl, bg = sd.bnode_local[k], sd.bnode_global[k]
        real_b = bl < uniq_k.size
        iface = {int(uniq_k[l]): int(g)
                 for l, g in zip(bl[real_b], bg[real_b])}
        plans.append(fd.build_face_plan(sd.glo_num[k], n,
                                        deg.reshape(sd.glo_num[k].shape),
                                        iface_of_node=iface)[0])
    return plans


@dataclass
class DomainArrays:
    """Device-resident state: geometry as a tuple of 6 per-factor
    lattices, the Dirichlet mask and inverse multiplicities (lattices; all
    stacked over the shards when P > 1), the differentiation matrix, and
    each shard's real slab layers (P,). On an unstructured partition the
    geometry factors are (E, npe) element blocks, mask and weight flat
    fields, ``layers`` is None and either ``fb`` the face-block dssum plan
    (ops/face_dssum.device_plan; 3-D) or ``gs`` the generic dssum's index
    arrays and ordered scatter plans (2-D)."""
    geom: tuple
    mask: torch.Tensor
    inv_degree_pts: torch.Tensor
    D: torch.Tensor
    layers: torch.Tensor | None
    fb: dict | None = None
    gs: dict | None = None


def top_planes(layers, n: int, planes: int):
    """Each shard's real top-plane index at order n - 1 on a ragged slab
    partition: layers * n - 1, which a shard with no layers reads as its
    last plane (the JAX package's dynamic index wraps -1)."""
    return torch.remainder(layers * n - 1, planes)


def _planes_from(t, starts, n: int):
    """Each shard's n planes from its own start plane, of a stacked
    (shards, Mz, My, Mx) tensor: a slice where the starts agree."""
    if len(set(starts)) == 1:
        return t[:, starts[0]:starts[0] + n]
    return torch.stack([t[k, h:h + n] for k, h in enumerate(starts)])


class Domain:
    """User-facing fine-level problem.

    Args:
      sharded: host partition (mesh/partition.partition_mesh).
      dtype: solver precision (torch.float32 or torch.float64).
      device: None for the card (raises without CUDA), or e.g. "cpu".
      comm: the collectives over the shards (runtime/comm.py); default
        ``LocalComm(sharded.num_shards)``. Its size must equal the shard
        count and its local shards the partition's owned ones.
    """

    def __init__(self, sharded: ShardedDomain, *, dtype=torch.float32,
                 device=None, comm=None):
        if sharded.dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {sharded.dim}")
        P = sharded.num_shards
        self.comm = LocalComm(P) if comm is None else comm
        if self.comm.size != P:
            raise ValueError(f"the comm has {self.comm.size} shards but the "
                             f"domain has {P}")
        self.owned = sharded.owned or tuple(range(P))
        self.num_owned = len(self.owned)
        if self.comm.local_shards != self.num_owned:
            raise ValueError(f"the comm holds {self.comm.local_shards} shards "
                             f"in this process but the partition owns "
                             f"{self.num_owned}")
        self.multiprocess = self.comm.processes > 1
        self.device = resolve_device(device)
        self.sharded = sharded
        self.dtype = dtype
        self.dim = sharded.dim
        self.poly_degree = sharded.poly_degree
        self.spmd = P > 1
        n = sharded.poly_degree + 1
        if sharded.structured is None:
            self._init_unstructured()
            return
        self.ragged = sharded.structured.ragged
        self.local_grid = sharded.structured.local_grid()
        self.lattice_shape = tuple(g * n for g in self.local_grid)

        lat = [self._host_elem_to_lattice(g) for g in sharded.geom]
        geom = [np.stack([l[..., k] for l in lat])
                for k in range(sharded.geom.shape[-1])]
        del lat
        stack = lambda a: np.stack([self._host_elem_to_lattice(x) for x in a])
        # mask is 0/1 and the structured inverse multiplicities are powers
        # of two, exact in bf16: an f32 domain stores them half-width
        small = torch.bfloat16 if dtype == torch.float32 else dtype
        self.arrays = DomainArrays(
            geom=tuple(self.shard_put(g, dtype) for g in geom),
            mask=self.shard_put(stack(sharded.dirichlet_mask), small),
            inv_degree_pts=self.shard_put(stack(sharded.inv_degree_pts),
                                          small),
            D=torch.as_tensor(diff_matrix(n), device=self.device).to(dtype),
            layers=torch.as_tensor(
                [sharded.structured.layer_counts[p] for p in self.owned],
                dtype=torch.int64, device=self.device),
        )
        self._top = (top_planes(self.arrays.layers, n, self.lattice_shape[0])
                     if self.spmd and self.ragged else None)
        self._edges = (self._edge_layers() if self.multiprocess
                       and (self.ragged or sharded.structured.slab_elems >= 3)
                       else None)

    def _init_unstructured(self):
        """Element-layout arrays and the dssum's plan. 3-D: the face-block
        plan, one a shard from its global node ids, global multiplicities
        and interface nodes, lowered to one index set over the stack. 2-D:
        the generic plan's index arrays (the JAX package builds face
        plans only in 3-D) and their ordered scatter plans."""
        sd = self.sharded
        n = sd.poly_degree + 1
        self.ragged = False
        self.local_grid = self.lattice_shape = None
        self._top = self._edges = None
        fb = gsa = None
        if self.dim == 3:
            fb = fd.device_plan(fd.lower_plans(shard_face_plans(sd), n,
                                               sd.elems_per_shard),
                                sd.num_boundary_global, self.device)
        else:
            gsa = {"gather_ids": self.shard_put(sd.gather_ids, torch.int64),
                   "inv_degree": self.shard_put(sd.inv_degree, self.dtype),
                   "bnode_local": self.shard_put(sd.bnode_local, torch.int64),
                   "bnode_global": self.shard_put(sd.bnode_global,
                                                  torch.int64)}
            gsa["plans"] = gs.generic_plans(
                gsa["gather_ids"], gsa["bnode_global"], sd.num_local_nodes,
                sd.num_boundary_global, self.device)
        self.arrays = DomainArrays(
            geom=tuple(self.shard_put(np.ascontiguousarray(sd.geom[..., k]),
                                      self.dtype)
                       for k in range(sd.geom.shape[-1])),
            mask=self.shard_put(sd.dirichlet_mask, self.dtype),
            inv_degree_pts=self.shard_put(sd.inv_degree_pts, self.dtype),
            D=torch.as_tensor(diff_matrix(n), device=self.device).to(
                self.dtype),
            layers=None, fb=fb, gs=gsa)

    def _edge_layers(self):
        """The boundary-first split's element layers on each owned shard:
        the bottom one at planes [0, n) and the real top one at [h, h + n)
        (h = top plane + 1 - n), with their geometry as contiguous
        stacks, kept for every apply."""
        n = self.poly_degree + 1
        Mz = self.lattice_shape[0]
        counts = self.sharded.structured.layer_counts
        hi0 = [(counts[p] * n - 1) % Mz + 1 - n for p in self.owned]
        return {"hi0": hi0,
                "geom_lo": tuple(g[:, :n].contiguous()
                                 for g in self.arrays.geom),
                "geom_hi": tuple(_planes_from(g, hi0, n).contiguous()
                                 for g in self.arrays.geom)}

    def shard_put(self, stacked, dtype=None):
        """A per-shard host array (leading axis = the owned shards) -> a
        device tensor: the one shard squeezed when P = 1, the stack
        otherwise."""
        x = np.ascontiguousarray(stacked if self.spmd else stacked[0])
        t = torch.as_tensor(x, device=self.device)
        return t if dtype is None else t.to(dtype)

    # ---- layout conversion (host, numpy) ----

    def _host_elem_to_lattice(self, arr):
        return elements_to_lattice(arr, self.local_grid,
                                   self.poly_degree + 1, self.dim)

    def _host_lattice_to_elem(self, U):
        return lattice_to_elements(U, self.local_grid,
                                   self.poly_degree + 1, self.dim)

    # ---- closure builders ----

    def _ops(self):
        """(operator, dssum, dot, dot2) closures over the device arrays.
        ``operator.fused_dssum`` is the fused p -> (A p, QQt A p) where the
        JAX package builds one (SPMD structured, and ragged or slabs of
        >= 3 layers), else None. A generic partition has the
        element-layout operator and the face-block (3-D) or generic (2-D)
        dssum."""
        a = self.arrays
        n = self.poly_degree + 1
        comm = self.comm if self.spmd else None
        top = self._top
        sd = self.sharded

        if self.lattice_shape is None:
            npe = sd.num_points_per_elem

            def operator(u):
                ue = u.reshape(u.shape[:-1] + (-1, npe))
                return sem.stiffness_apply(ue, a.geom, a.D,
                                           self.dim).reshape(u.shape)

        if a.fb is not None:
            def dssum(u, apply_mask=True, apply_weight=False):
                return fd.face_dssum(
                    u, a.fb, mask=a.mask, inv_degree_pts=a.inv_degree_pts,
                    comm=comm, apply_mask=apply_mask,
                    apply_weight=apply_weight)
        elif a.gs is not None:
            g = a.gs

            def dssum(u, apply_mask=True, apply_weight=False):
                return gs.dssum(
                    u, gather_ids=g["gather_ids"], mask=a.mask,
                    inv_degree=g["inv_degree"],
                    bnode_local=g["bnode_local"],
                    bnode_global=g["bnode_global"],
                    num_local_nodes=sd.num_local_nodes,
                    num_boundary_global=sd.num_boundary_global, comm=comm,
                    apply_mask=apply_mask, apply_weight=apply_weight,
                    plans=g["plans"])
        else:
            def operator(u):
                return sem.stiffness_apply_lattice(u, a.geom, a.D, self.dim)

            def dssum(u, apply_mask=True, apply_weight=False):
                return gs.structured_dssum(
                    u, n=n, dim=self.dim, mask=a.mask,
                    inv_degree_pts=a.inv_degree_pts, comm=comm,
                    apply_mask=apply_mask, apply_weight=apply_weight,
                    top_plane=top)

        def dot(x, y):
            return krylov.tree_dot(x, y, self.comm)

        def dot2(x, y, z, w):
            # one reduction of both local dots over the processes
            return self.comm.allreduce(krylov.tree_dot(x, y),
                                       krylov.tree_dot(z, w))

        op_dssum = None
        fused = self.spmd and self.lattice_shape is not None and (
            self.ragged or sd.structured.slab_elems >= 3)
        if fused and self.multiprocess:
            # the boundary-first split of the JAX package's SPMD Domain:
            # the two boundary element layers first, their outer planes
            # face-summed across the slab direction (the face sum of the
            # layer, K2 in 3-D: a one-element layer's slab-direction pass
            # leaves its first and last plane alone, so they equal the
            # full face sum's; in 2-D the planes are rows, summed in x)
            # and handed to the comm's exchange, which
            # travels (on NCCL's stream, or on gloo's threads from host
            # buffers) while the apply runs; then the face sum and the
            # exchanged planes' adds. Like the JAX package's ragged
            # variant it applies the whole slab after the two layers (a
            # layer apply is element-local, so the values are the same
            # either way): bitwise equal to operator then dssum.
            e = self._edges

            def op_dssum(z, apply_mask=True):
                z_lo = z[:, :n].contiguous()
                z_hi = _planes_from(z, e["hi0"], n).contiguous()
                plane_lo = gs.face_sum(sem.stiffness_apply_lattice(
                    z_lo, e["geom_lo"], a.D, self.dim), n, self.dim)[:, 0]
                plane_hi = gs.face_sum(sem.stiffness_apply_lattice(
                    z_hi, e["geom_hi"], a.D, self.dim), n, self.dim)[:, -1]
                ex = self.comm.slab_exchange_start(plane_lo, plane_hi)
                q = operator(z)
                U = self.comm.slab_exchange_finish(
                    gs.face_sum(q, n, self.dim), ex, top)
                if apply_mask:
                    U.mul_(a.mask)
                return q, U
        elif fused:
            # one process holding every shard has no exchange to hide:
            # the full apply and the dssum, the route the JAX package
            # takes where it builds its fused closure (FCG's numbers
            # depend on the route)
            def op_dssum(z, apply_mask=True):
                q = operator(z)
                return q, dssum(q, apply_mask=apply_mask)

        operator.fused_dssum = op_dssum
        return operator, dssum, dot, dot2

    # ---- solvers ----

    def solver(self, method="fcg", precond=None, precond_builder=None,
               max_iterations=500, num_vectors=20, tolerance=None,
               use_relative=True, overlap=True, z_dtype=None):
        """A solve function f -> KrylovResult, converging to ``tolerance``
        times the initial residual norm (``use_relative``, the default) or
        to the absolute ``tolerance``.

        precond: a Preconditioner (solvers/preconditioners.py). Its closure
          is built once here.
        precond_builder: used when ``precond`` is None — a bare builder
          with no extra arrays, builder(arrays, None, ops) -> (r -> z).
          With neither, the unpreconditioned path z = QQt r with mask.
        overlap: give the solver the fused operator + dssum where the
          Domain has one (``_ops``); FCG then carries the assembled
          residual.
        z_dtype: FGMRES only — storage dtype of the flexible Z basis.
        """
        if tolerance is None:
            tolerance = 1.0e-7 if self.dtype == torch.float64 else 1.0e-4
        operator, dssum, dot, dot2 = self._ops()
        ops = (operator, dssum, dot, dot2)
        fused = operator.fused_dssum if overlap else None

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
                use_relative=use_relative, op_dssum=fused)
        if method == "fgmres":
            return lambda f: krylov.fgmres(
                operator, pre, dssum_plain, dot, f,
                max_iterations=max_iterations, num_vectors=num_vectors,
                tolerance=tolerance, use_relative=use_relative,
                op_dssum=fused, z_dtype=z_dtype)
        raise ValueError(f"unknown method {method!r}")

    # ---- fields and manufactured solutions ----

    def points_shape(self):
        """Host-field shape: (points,) on one shard, (owned shards,
        points) else."""
        st = self.sharded
        if self.spmd:
            return (self.num_owned, st.points_per_shard)
        return (st.points_per_shard,)

    @property
    def field_shape(self):
        """One shard's device field shape: its lattice, or (E*npe,) flat
        on an unstructured partition."""
        if self.lattice_shape is None:
            return (self.sharded.points_per_shard,)
        return self.lattice_shape

    def to_device_field(self, host_field: np.ndarray):
        """Element-ordered host values of the owned shards, (owned,
        E*npe) or flat -> the device field, (Mz, My, Mx) ((My, Mx) in 2-D)
        on one shard and (owned, Mz, My, Mx) else. Pad points are zeroed: device fields are
        zero at padding."""
        st = self.sharded
        vals = np.asarray(host_field).reshape(self.num_owned, -1)
        if self.spmd:
            vals = np.where(np.repeat(st.elem_valid, st.num_points_per_elem,
                                      axis=1), vals, 0.0)
        if self.lattice_shape is not None:
            vals = np.stack([self._host_elem_to_lattice(v) for v in vals])
        return self.shard_put(vals, self.dtype)

    def from_device_field(self, u) -> np.ndarray:
        """Device field -> element-ordered host values of the owned
        shards, shape (owned, E*npe)."""
        vals = u.detach()
        if vals.dtype in (torch.bfloat16, torch.float16):
            vals = vals.float()
        P = self.num_owned
        vals = vals.cpu().numpy().reshape((P,) + self.field_shape)
        if self.lattice_shape is None:
            return vals
        return np.stack([self._host_lattice_to_elem(v) for v in vals]
                        ).reshape(P, -1)

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
        """Uniform random values drawn in global element order and placed
        in the padded per-shard layout (zeros at pads), flat: the field is
        the same whatever the partition."""
        st = self.sharded
        npe = st.num_points_per_elem
        rng = np.random.default_rng(seed)
        flat = rng.random(st.num_total_elements * npe)
        out = np.zeros((self.num_owned, st.elems_per_shard * npe))
        for k, p in enumerate(self.owned):
            lo, hi = st.elem_offsets[p], st.elem_offsets[p + 1]
            out[k, :(hi - lo) * npe] = flat[lo * npe:hi * npe]
        return out.reshape(-1)

    def initial_function(self, function_id: int = 0, seed: int = 0):
        """Manufactured solutions ids 0-4, made continuous and masked by a
        dssum with Dirichlet mask and inverse-multiplicity weight."""
        st = self.sharded
        c = st.coords.reshape(-1, st.coords.shape[-1])
        x, y = c[:, 0], c[:, 1]
        pi = np.pi
        base = np.sin(pi * x) * np.sin(pi * y)
        if self.dim == 3:
            base = base * np.sin(pi * c[:, 2])
        if function_id == 0:
            vals = base
        elif function_id == 1:
            extra = np.sin(2 * pi * x) * np.sin(pi * y)
            if self.dim == 3:
                extra = extra * np.sin(pi * c[:, 2])
            vals = base + extra
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
