"""Direct stiffness summation (dssum): the gather-scatter of the SEM.

Port of the JAX package's ``ops/gather_scatter.py``. Two routes:

- The structured lattice route. A 3-D face sum runs through the
  hand-written kernel ``ops/kernels.lattice_face_sum_3d``; a 2-D one is
  the plain torch roll form on every device (the JAX package leaves its
  2-D face sum to XLA), with the same arithmetic. ``face_sum`` picks the
  route by ``dim``, never by the tensor's rank: a 2-D stack (P, My, Mx)
  has the rank of a 3-D lattice. On one shard the Dirichlet mask and the
  inverse-multiplicity weight are fused into the face sum. On P slab
  shards, stacked as (P, Mz, My, Mx) or (P, My, Mx), one batched face sum
  covers every shard's own faces, the comm's slab exchange adds the
  neighbouring shards' boundary planes in place, and the weight and the
  mask follow, in the JAX package's order.
- The generic route, for any partition: scatter points to each shard's
  local nodes (Qt), sum the interface nodes across shards with one psum
  of a compact interface vector, gather back to points (Q). Both
  scatter-adds are ordered (``ordered_scatter_add`` by a plan of
  ``generic_plans``, built once): each node's copies are summed in
  ascending point order, bf16 in f32 and rounded once, the same on every
  run and on the card as on the CPU.

Sharded arrays carry the leading shard axis; the collectives are those of
a ``runtime/comm`` object (None: one shard, nothing to exchange).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["lattice_face_sum", "face_sum", "lattice_face_sum_2d",
           "structured_dssum", "scatter_to_nodes",
           "gather_to_points", "exchange", "dssum", "ordered_sum_plan",
           "ordered_scatter_add", "generic_plans"]


def ordered_sum_plan(index, size: int, device) -> dict | None:
    """Host plan of a scatter-add without atomics: ``index`` gives each
    source entry's target in [0, size) (entries outside are dropped).
    Returns the targets that receive (``rows``), the source entries sorted
    by target, ascending within a target (``perm``), and each target's
    count (``lengths``), as int64 tensors on ``device``; None when no
    entry lands."""
    idx = np.asarray(index, dtype=np.int64).reshape(-1)
    src = np.flatnonzero((idx >= 0) & (idx < size))
    if not src.size:
        return None
    perm = src[np.argsort(idx[src], kind="stable")]
    rows, lengths = np.unique(idx[perm], return_counts=True)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    return {"rows": as_t(rows), "perm": as_t(perm), "lengths": as_t(lengths)}


def ordered_scatter_add(target, src, plan):
    """``target`` (flat) plus the scatter-add of the flat ``src`` by an
    ``ordered_sum_plan``: each target's entries summed in one fixed order
    (ascending source position) by ``segment_reduce``, in f32 for
    reduced-precision fields, then added once. The same on every run, and
    the same on the card as on the CPU: the values go in as one (N, 1)
    column, which CUDA's segment_reduce sums with one thread a segment,
    first to last, as the CPU does (a 1-D input goes to a tree-ordered
    segmented reduction instead)."""
    if plan is None:
        return target
    acc = torch.float64 if src.dtype == torch.float64 else torch.float32
    seg = torch.segment_reduce(src.to(acc)[plan["perm"]].unsqueeze(1), "sum",
                               lengths=plan["lengths"], axis=0,
                               unsafe=True).squeeze(1)
    return target.index_add(0, plan["rows"], seg.to(target.dtype))


def _rows_plan(index, size: int, device) -> dict | None:
    """``ordered_sum_plan`` of a scatter along the last axis of an index
    array of any leading shape: row k's targets are offset by k * size,
    so that the rows' sums stay apart in one flat (rows * size) target."""
    idx = np.asarray(index.cpu() if isinstance(index, torch.Tensor)
                     else index, dtype=np.int64)
    idx = idx.reshape(-1, idx.shape[-1])
    offs = size * np.arange(idx.shape[0], dtype=np.int64)[:, None]
    return ordered_sum_plan(idx + offs, idx.shape[0] * size, device)


def generic_plans(gather_ids, bnode_global, num_local_nodes: int,
                  num_boundary_global: int, device) -> dict:
    """The generic dssum's two ordered scatter plans, made once on the
    host from the shapes the device arrays have ((points,) on one shard,
    (P, points) stacked): points into local nodes (``nodes``) and
    interface nodes into the compact interface vector (``iface``)."""
    return {"nodes": _rows_plan(gather_ids, num_local_nodes + 1, device),
            "iface": _rows_plan(bnode_global, num_boundary_global + 1,
                                device)}


def _ordered_rows_add(out, src, plan):
    """``out`` (zeros, (..., size)) plus the ordered scatter-add of ``src``
    by a ``_rows_plan`` over its rows."""
    return ordered_scatter_add(out.reshape(-1), src.reshape(-1),
                               plan).view(out.shape)


def scatter_to_nodes(u_pts, gather_ids, num_local_nodes: int, plan):
    """Qt apply: sum point values into local unique nodes, along the last
    axis, each node's points in ascending order (``plan``: the ``nodes``
    plan of ``generic_plans``). The result has num_local_nodes + 1
    entries; the last is the trash node that absorbs padding points.
    gather_ids are int64."""
    out = u_pts.new_zeros(u_pts.shape[:-1] + (num_local_nodes + 1,))
    return _ordered_rows_add(out, u_pts, plan)


def gather_to_points(w_nodes, gather_ids):
    """Q apply: read node values back to points."""
    return torch.gather(w_nodes, -1, gather_ids)


def exchange(w_nodes, bnode_local, bnode_global, num_boundary_global: int,
             comm, plan):
    """Sum the interface nodes' values across shards: each shard adds its
    values into a compact interface vector (num_boundary_global + 1
    entries, the last a trash slot) by the ordered scatter ``plan`` (the
    ``iface`` plan of ``generic_plans``), one psum sums the shards'
    vectors, and each shard reads its interface nodes back from the sum."""
    if comm is None or num_boundary_global == 0:
        return w_nodes
    buf = w_nodes.new_zeros(w_nodes.shape[:-1] + (num_boundary_global + 1,))
    buf = _ordered_rows_add(buf, torch.gather(w_nodes, -1, bnode_local),
                            plan)
    total = comm.psum(buf)
    return w_nodes.scatter(-1, bnode_local, total[bnode_global])


def dssum(u_pts, *, gather_ids, mask, inv_degree, bnode_local, bnode_global,
          num_local_nodes: int, num_boundary_global: int, comm, plans,
          apply_mask: bool = True, apply_weight: bool = False):
    """Generic direct stiffness summation QQt on point fields, (points,)
    on one shard or (P, points) stacked. apply_weight multiplies the node
    sums by 1/multiplicity before the exchange (the weight is the same on
    every shard, so this equals weighting after the sum). ``plans``: the
    ``generic_plans`` of these index arrays."""
    w = scatter_to_nodes(u_pts, gather_ids, num_local_nodes, plans["nodes"])
    if apply_weight:
        w = w * inv_degree
    w = exchange(w, bnode_local, bnode_global, num_boundary_global, comm,
                 plans["iface"])
    out = gather_to_points(w, gather_ids)
    if apply_mask:
        out = out * mask
    return out


@functools.lru_cache(maxsize=None)
def _roll_masks(M: int, n: int, dtype, device):
    """hi[X]=1 iff X is the last node of a non-final element (receives from
    X+1); lo[X]=1 iff X is the first node of a non-initial element. Kept
    per (M, n, dtype, device): on a card a call then copies nothing from
    the host. The callers only read them."""
    hi = np.zeros(M); hi[n - 1::n] = 1.0; hi[M - 1] = 0.0
    lo = np.zeros(M); lo[0::n] = 1.0; lo[0] = 0.0
    return (torch.as_tensor(hi, dtype=dtype, device=device),
            torch.as_tensor(lo, dtype=dtype, device=device))


def lattice_face_sum(U, n: int, axes=None):
    """Coincident-face summation per direction, the roll form:
    ``U += hi_d * roll(U,-1,d) + lo_d * roll(U,+1,d)`` along ``axes`` in
    order (None: every axis of U, the last first). Plain torch in U's
    dtype; the kernels' twins and the 2-D face sum build on it."""
    ndim = U.dim()
    for ax in (axes if axes is not None else range(ndim - 1, -1, -1)):
        M = U.shape[ax]
        hi, lo = _roll_masks(M, n, U.dtype, U.device)
        shape = [1] * ndim
        shape[ax] = M
        U = (U + hi.reshape(shape) * torch.roll(U, -1, ax)
             + lo.reshape(shape) * torch.roll(U, 1, ax))
    return U


def face_sum_rounded(U, n: int, axes, mask=None, weight=None):
    """The roll form along ``axes`` in f32 (f64 for f64 fields), then x
    weight, then x mask, then one cast to U's dtype: kernel K2's
    arithmetic, which its plain twin and the 2-D face sum share."""
    acc = torch.float64 if U.dtype == torch.float64 else torch.float32
    R = lattice_face_sum(U.to(acc), n, axes=axes)
    if weight is not None:
        R = R * weight.to(acc)
    if mask is not None:
        R = R * mask.to(acc)
    return R.to(U.dtype)


def lattice_face_sum_2d(U, n: int, mask=None, weight=None):
    """The 2-D face sum of a (My, Mx) lattice, or of each lattice of a (P,
    My, Mx) stack (the rolls wrap inside an entry, where the flags are
    0): x then y in f32 (f64 for f64 fields), then x weight, then x mask,
    then one cast to U's dtype, as kernel K2 computes its 3-D sum. In f32
    and f64 it is the JAX package's 2-D roll form bit for bit."""
    if U.dim() not in (2, 3):
        raise ValueError(f"a (My, Mx) lattice or a (P, My, Mx) stack, got "
                         f"{tuple(U.shape)}")
    d = U.dim()
    return face_sum_rounded(U, n, (d - 1, d - 2), mask=mask, weight=weight)


def face_sum(U, n: int, dim: int, mask=None, weight=None):
    """The face sum of a ``dim``-D lattice or of a (P, ...) stack of them,
    with the optional mask and weight fused in: kernel K2 (its plain twin
    on CPU tensors) in 3-D, ``lattice_face_sum_2d`` in 2-D."""
    if dim == 3:
        if U.dim() not in (3, 4):
            raise ValueError(f"a 3-D lattice or a stack of them, got shape "
                             f"{tuple(U.shape)}")
        from .kernels import lattice_face_sum_3d
        return lattice_face_sum_3d(U, n, mask=mask, weight=weight)
    if dim == 2:
        return lattice_face_sum_2d(U, n, mask=mask, weight=weight)
    raise ValueError(f"dim must be 2 or 3, got {dim}")


def structured_dssum(U, *, n: int, dim: int, mask, inv_degree_pts,
                     comm=None, apply_mask: bool = True,
                     apply_weight: bool = False, top_plane=None):
    """Direct stiffness summation on a structured lattice: face sum, then
    x inverse multiplicity (apply_weight), then x Dirichlet mask
    (apply_mask).

    One shard (comm None or of size 1): a (Mz, My, Mx) or (My, Mx)
    lattice, the three fused into one face-sum pass. P shards: a (P, Mz,
    My, Mx) or (P, My, Mx) stack, one batched face sum for all shards,
    then the comm's slab exchange (with the per-shard ``top_plane`` on
    ragged partitions), then the weight, then the mask. Every input field
    must be zero at pad points; mask and weight are zero there, so outputs
    keep that.
    """
    if comm is None or comm.size <= 1:
        return face_sum(U, n, dim,
                        mask=mask if apply_mask else None,
                        weight=inv_degree_pts if apply_weight else None)
    U = comm.slab_exchange_add(face_sum(U, n, dim), top_plane)
    if apply_weight:
        U.mul_(inv_degree_pts)
    if apply_mask:
        U.mul_(mask)
    return U
