"""Element partitioning for the structured slab lattice.

Port of the JAX package's ``mesh/partition.py`` for ONE shard: the
shard is the whole mesh, and the structured dssum needs no gather/scatter
plan, so the generic plan fields (gather ids, interface nodes) are not
carried. ``num_shards > 1`` (slab sharding) raises NotImplementedError.
Arrays keep a leading shard axis of length 1, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .generator import GlobalMesh

__all__ = ["ShardedDomain", "StructuredInfo", "partition_mesh"]


@dataclass
class StructuredInfo:
    """Marks a partition as slab-aligned on a structured box lattice. The
    element grid is (mz, my, mx) in storage order; shards split the last
    dimension (mz) into slabs of ``layer_counts[p]`` layers."""
    elem_shape: tuple[int, ...]   # global (mx, my, mz)
    slab_elems: int               # layers per shard
    poly_degree: int
    layer_counts: tuple[int, ...] = ()

    def local_grid(self):
        """Local element-grid shape in storage order (slowest..fastest)."""
        rev = tuple(reversed(self.elem_shape[:-1]))
        return (self.slab_elems,) + rev


@dataclass
class ShardedDomain:
    """Per-shard stacked host arrays of a partitioned SEM problem (P = 1)."""

    dim: int
    poly_degree: int
    num_shards: int
    num_total_elements: int
    num_global_nodes: int
    geom: np.ndarray                 # (P, E, npe, 6)
    mass: np.ndarray | None          # (P, E, npe)
    coords: np.ndarray               # (P, E, npe, dim)
    dirichlet_mask: np.ndarray       # (P, E*npe)
    glo_num: np.ndarray              # (P, E, npe) int64
    inv_degree_pts: np.ndarray       # (P, E*npe) 1/global multiplicity
    structured: StructuredInfo | None = None

    @property
    def num_points_per_elem(self) -> int:
        return self.geom.shape[2]

    @property
    def points_per_shard(self) -> int:
        return self.geom.shape[1] * self.geom.shape[2]


def partition_mesh(mesh: GlobalMesh, num_shards: int) -> ShardedDomain:
    """Partition a structured GlobalMesh into ``num_shards`` slab shards
    (only 1 in this port so far)."""
    if num_shards != 1:
        raise NotImplementedError("the port supports one shard so far")
    if not mesh.structured_layout:
        raise NotImplementedError(
            "the port supports structured slab partitions only")
    E = mesh.num_elements
    npe = mesh.num_points_per_elem
    m_last = mesh.elem_shape[-1]
    sinfo = StructuredInfo(elem_shape=tuple(mesh.elem_shape),
                           slab_elems=m_last, poly_degree=mesh.poly_degree,
                           layer_counts=(m_last,))
    # the shard IS the mesh: views, not copies
    return ShardedDomain(
        dim=mesh.dim,
        poly_degree=mesh.poly_degree,
        num_shards=1,
        num_total_elements=E,
        num_global_nodes=mesh.num_nodes,
        geom=mesh.geom[None],
        mass=None if mesh.mass is None else mesh.mass[None],
        coords=mesh.coords[None],
        dirichlet_mask=np.ascontiguousarray(
            mesh.dirichlet_mask).reshape(1, E * npe),
        glo_num=mesh.glo_num.astype(np.int64, copy=False)[None],
        inv_degree_pts=1.0 / np.ascontiguousarray(
            mesh.node_degree).reshape(1, E * npe),
        structured=sinfo,
    )
