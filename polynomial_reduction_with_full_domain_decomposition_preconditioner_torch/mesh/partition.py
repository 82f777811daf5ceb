"""Element partitioning and SPMD assembly plans.

Port of the JAX package's ``mesh/partition.py``: elements are split into
``num_shards`` contiguous chunks, padded so that every shard has the same
shapes, and every array is stacked with a leading shard axis. A
structured mesh splits its last element dimension into balanced slabs
(q or q+1 layers); otherwise the split is by element count. Every
partition also carries the generic gather/scatter plan: each shard's
local node numbering (``gather_ids``) and its interface nodes, shared
with another shard, indexed into one compact global interface vector
that the generic dssum sums across shards with one psum
(ops/gather_scatter.py).

``owned`` names the global shards whose host arrays are materialized
(default all): a process of a multi-process run (runtime/distributed.py)
passes its own contiguous run, so that its setup memory follows its own
shards. The index pass that finds the interface nodes and the padded
sizes is global and runs on every process; the global orderings
(``elem_offsets``, interface ids) stay global.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .generator import GlobalMesh

__all__ = ["ShardedDomain", "StructuredInfo", "check_int32_ids",
           "partition_mesh"]


@dataclass
class StructuredInfo:
    """Marks a partition as slab-aligned on a structured box lattice. The
    element grid is (mz, my, mx) in storage order; shards split the last
    dimension (mz) into slabs of ``layer_counts[p]`` layers (q or q+1,
    q = mz // P), each padded to ``slab_elems`` = max(layer_counts)
    layers. Pad layers carry zero geometry and mask, and every device
    field is zero there."""
    elem_shape: tuple[int, ...]   # global (mx, my, mz)
    slab_elems: int               # max layers per shard (padded slab)
    poly_degree: int
    layer_counts: tuple[int, ...] = ()   # real layers per shard

    @property
    def ragged(self) -> bool:
        """True when shards hold unequal numbers of real layers."""
        return len(set(self.layer_counts)) > 1

    @property
    def layer_starts(self) -> tuple[int, ...]:
        """First global layer of each shard."""
        return tuple(int(s) for s in
                     np.cumsum((0,) + tuple(self.layer_counts))[:-1])

    def local_grid(self):
        """Local element-grid shape in storage order (slowest..fastest)."""
        rev = tuple(reversed(self.elem_shape[:-1]))
        return (self.slab_elems,) + rev


@dataclass
class ShardedDomain:
    """Per-shard stacked host arrays of a partitioned SEM problem.

    P = num_shards, E = padded elements per shard, npe = points per
    element, NN = padded local nodes per shard (+1 trash slot at index
    NN), B = padded interface nodes per shard, BG = global interface
    nodes (+1 trash slot at index BG).
    """

    dim: int
    poly_degree: int
    num_shards: int
    num_total_elements: int          # real (unpadded) element count
    num_global_nodes: int
    geom: np.ndarray                 # (P, E, npe, 6), zero for pad elements
    mass: np.ndarray | None          # (P, E, npe), zero for pad elements
    coords: np.ndarray               # (P, E, npe, dim)
    dirichlet_mask: np.ndarray       # (P, E*npe), 0 for pad points
    glo_num: np.ndarray              # (P, E, npe) int64 (pad -> -1)
    elem_valid: np.ndarray           # (P, E) bool
    inv_degree_pts: np.ndarray       # (P, E*npe) 1/global multiplicity, pad 0
    gather_ids: np.ndarray           # (P, E*npe) int32 in [0, NN]; NN = trash
    num_local_nodes: int             # NN (max over shards)
    node_valid: np.ndarray           # (P, NN+1) float, 1 for real nodes
    inv_degree: np.ndarray           # (P, NN+1) float, 1/global multiplicity
    bnode_local: np.ndarray          # (P, B) int32 local node id (pad -> NN)
    bnode_global: np.ndarray         # (P, B) int32 interface id (pad -> BG)
    num_boundary_global: int         # BG
    structured: StructuredInfo | None = None
    elem_offsets: tuple[int, ...] = ()   # global element offset per shard (P+1)
    owned: tuple[int, ...] = ()      # global shards materialized here, in
    #   order: the leading axis of every per-shard array above

    @property
    def num_owned(self) -> int:
        return len(self.owned) if self.owned else self.num_shards

    @property
    def num_points_per_elem(self) -> int:
        return self.geom.shape[2]

    @property
    def elems_per_shard(self) -> int:
        return self.geom.shape[1]

    @property
    def points_per_shard(self) -> int:
        return self.geom.shape[1] * self.geom.shape[2]


_INT32_MAX = int(np.iinfo(np.int32).max)


def check_int32_ids(largest: int, what: str) -> None:
    """The plan stores ids up to ``largest`` (a trash slot included) as
    int32: raise where they would wrap. Kershaw 64^3 N=7 has 449^3 =
    90,518,849 nodes."""
    if largest > _INT32_MAX:
        raise ValueError(f"{what}: ids up to {largest} do not fit the "
                         f"int32 gather plan (at most {_INT32_MAX})")


def partition_mesh(mesh: GlobalMesh, num_shards: int,
                   structured: bool | str = "auto",
                   owned=None) -> ShardedDomain:
    """Partition a GlobalMesh into ``num_shards`` SPMD shards.

    structured: True or "auto" aligns shard boundaries to slabs of the
    last element-grid dimension (the structured lattice path); False
    forces the generic contiguous split by element count.
    owned: the global shard indices whose host arrays are materialized,
    in order (default all of them).
    """
    E_tot = mesh.num_elements
    npe = mesh.num_points_per_elem
    P = num_shards
    if P < 1:
        raise ValueError(f"num_shards must be at least 1, got {P}")
    owned = tuple(range(P)) if owned is None else tuple(int(p) for p in owned)
    if not owned or any(not 0 <= p < P for p in owned):
        raise ValueError(f"owned shards {owned} are not among the {P}")
    layout = getattr(mesh, "structured_layout", True)
    if structured is True and not layout:
        raise ValueError("mesh elements are not in structured slab order")
    sinfo = None
    if (structured is True or structured == "auto") and layout:
        m_last = mesh.elem_shape[-1]
        plane = int(np.prod(mesh.elem_shape[:-1]))   # elements per layer
        q, r = divmod(m_last, P)
        counts = tuple(q + (1 if p < r else 0) for p in range(P))
        E = max(counts) * plane                      # padded elements/shard
        bounds = np.concatenate(
            [[0], np.cumsum(counts)]).astype(np.int64) * plane
        sinfo = StructuredInfo(elem_shape=tuple(mesh.elem_shape),
                               slab_elems=max(counts),
                               poly_degree=mesh.poly_degree,
                               layer_counts=counts)
    else:
        E = -(-E_tot // P)
        bounds = np.linspace(0, E_tot, P + 1).astype(np.int64)

    # node ids are dense 0..N_glob-1: each shard's node set is a presence
    # bitmask, and a node touched by more than one shard is an interface
    # node
    N_glob = mesh.num_nodes
    presence = []
    for p in range(P):
        m = np.zeros((N_glob,), dtype=bool)
        m[mesh.glo_num[bounds[p]:bounds[p + 1]].ravel()] = True
        presence.append(m)
    touched = np.sum(presence, axis=0, dtype=np.int64)
    interface_mask = touched > 1
    interface = np.flatnonzero(interface_mask)
    BG = interface.size
    iface_index = np.full((N_glob,), -1, dtype=np.int64)
    iface_index[interface] = np.arange(BG)
    NN = max(int(m.sum()) for m in presence)
    B = max(max(int(np.count_nonzero(m & interface_mask)) for m in presence),
            1)
    check_int32_ids(NN, "local nodes of a shard")
    check_int32_ids(BG, "interface nodes")
    degree_global = np.bincount(mesh.glo_num.ravel(), minlength=N_glob)
    offsets = tuple(int(b) for b in bounds)

    if P == 1:
        # the shard is the mesh: views, no padded copies; its local node
        # ids are the global ones
        node_valid = np.zeros((1, NN + 1))
        node_valid[0, :NN] = 1.0
        inv_degree = np.zeros((1, NN + 1))
        inv_degree[0, :NN] = 1.0 / degree_global
        return ShardedDomain(
            dim=mesh.dim,
            poly_degree=mesh.poly_degree,
            num_shards=1,
            num_total_elements=E_tot,
            num_global_nodes=N_glob,
            geom=mesh.geom[None],
            mass=None if mesh.mass is None else mesh.mass[None],
            coords=mesh.coords[None],
            dirichlet_mask=np.ascontiguousarray(
                mesh.dirichlet_mask).reshape(1, E * npe),
            glo_num=mesh.glo_num.astype(np.int64, copy=False)[None],
            elem_valid=np.ones((1, E), dtype=bool),
            inv_degree_pts=1.0 / np.ascontiguousarray(
                mesh.node_degree).reshape(1, E * npe),
            gather_ids=np.ascontiguousarray(mesh.glo_num).reshape(
                1, E * npe).astype(np.int32),
            num_local_nodes=NN,
            node_valid=node_valid,
            inv_degree=inv_degree,
            bnode_local=np.full((1, B), NN, dtype=np.int32),
            bnode_global=np.full((1, B), BG, dtype=np.int32),
            num_boundary_global=BG,
            structured=sinfo,
            elem_offsets=offsets,
            owned=(0,),
        )

    Pl = len(owned)
    geom = np.zeros((Pl, E, npe, mesh.num_geom))
    mass = None if mesh.mass is None else np.zeros((Pl, E, npe))
    coords = np.zeros((Pl, E, npe, mesh.dim))
    mask = np.zeros((Pl, E * npe))
    glo = np.full((Pl, E, npe), -1, dtype=np.int64)
    valid = np.zeros((Pl, E), dtype=bool)
    inv_deg_pts = np.zeros((Pl, E * npe))
    gather_ids = np.full((Pl, E * npe), NN, dtype=np.int32)
    node_valid = np.zeros((Pl, NN + 1))
    inv_degree = np.zeros((Pl, NN + 1))
    bnode_local = np.full((Pl, B), NN, dtype=np.int32)
    bnode_global = np.full((Pl, B), BG, dtype=np.int32)

    for k, p in enumerate(owned):
        lo, hi = bounds[p], bounds[p + 1]
        ne = hi - lo
        geom[k, :ne] = mesh.geom[lo:hi]
        if mass is not None:
            mass[k, :ne] = mesh.mass[lo:hi]
        coords[k, :ne] = mesh.coords[lo:hi]
        mask[k, :ne * npe] = mesh.dirichlet_mask[lo:hi].ravel()
        glo[k, :ne] = mesh.glo_num[lo:hi]
        valid[k, :ne] = True
        inv_deg_pts[k, :ne * npe] = 1.0 / mesh.node_degree[lo:hi].ravel()
        # local numbering: the shard's nodes in global order, each point's
        # id its rank among them
        pres = presence[p]
        uniq = np.flatnonzero(pres)
        rank = np.cumsum(pres, dtype=np.int64) - 1
        inv = rank[mesh.glo_num[lo:hi].ravel()]
        gather_ids[k, :inv.size] = inv.astype(np.int32)
        node_valid[k, :uniq.size] = 1.0
        inv_degree[k, :uniq.size] = 1.0 / degree_global[uniq]
        is_iface = iface_index[uniq] >= 0
        bl = np.flatnonzero(is_iface).astype(np.int32)
        bnode_local[k, :bl.size] = bl
        bnode_global[k, :bl.size] = iface_index[uniq[is_iface]].astype(
            np.int32)

    return ShardedDomain(
        dim=mesh.dim,
        poly_degree=mesh.poly_degree,
        num_shards=P,
        num_total_elements=E_tot,
        num_global_nodes=N_glob,
        geom=geom,
        mass=mass,
        coords=coords,
        dirichlet_mask=mask,
        glo_num=glo,
        elem_valid=valid,
        inv_degree_pts=inv_deg_pts,
        gather_ids=gather_ids,
        num_local_nodes=NN,
        node_valid=node_valid,
        inv_degree=inv_degree,
        bnode_local=bnode_local,
        bnode_global=bnode_global,
        num_boundary_global=BG,
        structured=sinfo,
        elem_offsets=offsets,
        owned=owned,
    )
