"""Face-block direct stiffness summation for unstructured hex meshes.

Port of the JAX package's ``ops/face_dssum.py``. The host half is its
own copy of ``build_face_plan``, which sorts every multi-copy node of a
shard (or a composite class) into one of two kinds:

- deg-2 nodes on a locally matched conforming face: the face-pair
  exchange, the partner face met in one of the 8 dihedral orientations
  (``_dihedral_table``);
- everything else (edges, corners, irregular valence, cross-shard
  interface nodes): the compact rest, plus the psum of the interface
  nodes across shards.

The JAX package's plan can also route the interiors of locally
conforming edges through an edge-group pass (``use_edges``). That pass
is a row-granular scatter for the TPU. Here it would sum the same copies
in the same order as the rest path, so the port's plan sends edge nodes
down the rest path and has no such switch.

The device half is the card's. ``lower_plans`` turns the shards' plans
into index arrays over the flat stack of every shard's points, with a
zero slot after the last point. A face pair is one gather over all
points, y = x + x[partner], with the dihedral transform folded into the
partner index. The rest nodes sum their copies with one
``ordered_scatter_add``: a segment sum in ascending point order, with no
atomic adds. One gather then writes each sum back to its copies. The
result is the same on every run, and equal to the scatter assembly that
sums a node's copies in ascending point order (the generic dssum on the
CPU, numpy's bincount), as the JAX package's is on one shard. Every
array indexes the flat stack, so the shards' plans need no common shape.
"""

from __future__ import annotations

import numpy as np
import torch

from .gather_scatter import ordered_scatter_add, ordered_sum_plan

__all__ = ["build_face_plan", "lower_plans", "device_plan", "face_assemble",
           "face_dssum"]


def _dihedral_table(n: int) -> np.ndarray:
    """The 8 square symmetries as index tables: new[i] = old[table[t][i]],
    generated by the same op sequence the device transform applies
    (transpose, then flips) so the two stay consistent by construction."""
    nn = n * n
    grid = np.arange(nn).reshape(n, n)
    out = []
    for t in range(8):
        g = grid.T if t >= 4 else grid
        if t % 4 in (1, 3):
            g = g[::-1, :]
        if t % 4 in (2, 3):
            g = g[:, ::-1]
        out.append(g.reshape(-1))
    return np.stack(out)


# face f = a * 2 + s: storage axis a of the local (n, n, n) block
# (0 = z slowest ... 2 = x fastest), side s (0 = low, 1 = high)
_FIDX3 = [(a, s) for a in range(3) for s in (0, 1)]


def _face_take(g4, a, s, n):
    sl = [slice(None)] * g4.ndim
    sl[1 + a] = 0 if s == 0 else n - 1
    return g4[tuple(sl)]


def build_face_plan(glo: np.ndarray, n: int, degree: np.ndarray,
                    iface_of_node=None):
    """Host setup: build the face-exchange plan for one shard / class.

    glo:    (E, npe) int64 GLOBAL node ids; pad elements/points < 0.
    degree: (E, npe) int   GLOBAL node multiplicity (0 on pads).
    iface_of_node: optional dict global_id -> interface index for nodes
      shared with other shards (from the partition's interface vector);
      their point copies always land in the compact rest path and get an
      `exchange` psum.

    Returns (arrays, meta) — a dict of numpy arrays (the device plan)
    plus static metadata — or (None, None) when the layout is not a 3-D
    hex block (npe != n^3), so callers can tuple-unpack unconditionally.
    """
    E, npe = glo.shape
    if npe != n ** 3:
        return None, None
    nn = n * n
    g4 = glo.reshape(E, n, n, n)
    deg = degree.reshape(E, npe)

    faces_glo = np.stack([_face_take(g4, a, s, n).reshape(E, nn)
                          for a, s in _FIDX3], axis=1)     # (E, 6, nn)
    corners = faces_glo[:, :, [0, n - 1, nn - n, nn - 1]]
    keys = np.sort(corners, axis=2).reshape(E * 6, 4)

    # pair faces by sorted corner key (vectorized: lexsort + adjacent
    # equality; the per-face python dict loop cost ~5 s at PB_1568
    # sizes). Only key groups of EXACTLY two faces pair — a key shared
    # by >2 faces is non-manifold and falls to the exact rest path.
    partner = np.full((E, 6), E * 6, dtype=np.int32).reshape(-1)
    real_f = np.repeat(glo[:, 0] >= 0, 6)
    rsel = np.flatnonzero(real_f)
    if rsel.size:
        kr = keys[rsel]
        order = np.lexsort((kr[:, 3], kr[:, 2], kr[:, 1], kr[:, 0]))
        so = rsel[order]
        ks = kr[order]
        new = np.empty(so.size, dtype=bool)
        new[0] = True
        new[1:] = (ks[1:] != ks[:-1]).any(axis=1)
        starts = np.flatnonzero(new)
        counts = np.diff(np.append(starts, so.size))
        p2 = starts[counts == 2]
        partner[so[p2]] = so[p2 + 1]
        partner[so[p2 + 1]] = so[p2]
    partner = partner.reshape(E, 6)

    # orientation class + deg-2 row mask per matched face (vectorized
    # over all matched slots: batched row argsorts + one table compare)
    table = _dihedral_table(n)
    cls = np.full((E, 6), -1, dtype=np.int8)
    rowmask = np.zeros((E, 6, nn), dtype=np.float64)
    handled = np.zeros((E, npe), dtype=bool)
    pts4 = np.arange(E * npe).reshape(E, n, n, n)
    face_pts = np.stack([_face_take(pts4, a, s, n).reshape(E, nn)
                         for a, s in _FIDX3], axis=1)      # (E, 6, nn)
    me, mf = np.nonzero(partner < E * 6)
    # chunk to bound peak memory (each int64 work array is K x nn)
    for c0 in range(0, me.size, 1 << 17):
        ce, cf = me[c0:c0 + (1 << 17)], mf[c0:c0 + (1 << 17)]
        K = ce.size
        Mv = faces_glo[ce, cf]                         # (K, nn)
        pr = partner[ce, cf]
        Tv = faces_glo[pr // 6, pr % 6]
        om = np.argsort(Mv, axis=1)
        ot = np.argsort(Tv, axis=1)
        perm = np.empty((K, nn), dtype=np.int64)
        perm[np.arange(K)[:, None], om] = ot
        hit = (perm[:, None, :] == table[None]).all(axis=2)  # (K, 8)
        ok = hit.any(axis=1)
        # not a rigid match (never for conforming hexes) -> rest path
        partner[ce[~ok], cf[~ok]] = E * 6
        ce, cf = ce[ok], cf[ok]
        cls[ce, cf] = hit[ok].argmax(axis=1).astype(np.int8)
        fp = face_pts[ce, cf] % npe                    # (Kok, nn)
        rows = (deg[ce[:, None], fp] == 2) & (Mv[ok] >= 0)
        rowmask[ce, cf] = rows
        handled.reshape(-1)[(ce[:, None] * npe + fp)[rows]] = True

    # compact rest: every real point whose node still needs assembly
    flat_glo = glo.reshape(-1)
    rest = np.flatnonzero((deg.reshape(-1) >= 2) & ~handled.reshape(-1)
                          & (flat_glo >= 0))
    runiq, rids = np.unique(flat_glo[rest], return_inverse=True)
    NR = runiq.size

    # cross-shard interface wiring on the compact rest nodes
    if iface_of_node:
        ridx = np.asarray([iface_of_node.get(int(g), -1) for g in runiq],
                          dtype=np.int64)
        sel = np.flatnonzero(ridx >= 0)
        rb_local = sel.astype(np.int32)
        rb_global = ridx[sel].astype(np.int32)
    else:
        rb_local = np.zeros((0,), dtype=np.int32)
        rb_global = np.zeros((0,), dtype=np.int32)

    arrays = {
        "partner": partner.reshape(-1),        # (E*6,) int32
        "rowmask": rowmask,                    # (E, 6, nn)
        "rest": rest.astype(np.int32),         # (NRp,)
        "rest_ids": rids.astype(np.int32),     # (NRp,)
        "rb_local": rb_local,                  # (NI,) rest-compact idx
        "rb_global": rb_global,                # (NI,) interface idx
    }
    # class-grouped face rows: for each dihedral class t, the matched
    # face slots in that class (dst) and their partner slots (src) —
    # the device transforms each matched face exactly once
    flat_cls = cls.reshape(-1)
    flat_partner = partner.reshape(-1)
    for t in range(8):
        rows_t = np.flatnonzero(flat_cls == t).astype(np.int32)
        arrays["cls_src%d" % t] = flat_partner[rows_t].astype(np.int32)
        arrays["cls_dst%d" % t] = rows_t
    meta = {"n": n, "num_rest_nodes": NR, "rest_nodes": runiq}
    return arrays, meta


def _face_points(n: int):
    """(6, n^2) local point ids of each face, in the plan's face-slot
    order."""
    pts = np.arange(n ** 3).reshape(1, n, n, n)
    return np.stack([_face_take(pts, a, s, n).reshape(n * n)
                     for a, s in _FIDX3])


def lower_plans(plans, n: int, num_elements: int) -> dict:
    """The shards' face plans (``build_face_plan`` arrays, each over
    ``num_elements`` elements of n^3 points; None entries are shards with
    nothing to assemble) -> host index arrays over the flat stack of
    T = P * num_elements * n^3 points:

      partner (T,)      the face-pair copy a point adds, or T (the zero
                        slot);
      node (T,)         the rest node a point is a copy of, or -1;
      num_nodes         the count M of rest nodes over all shards;
      iface_node, iface_global, iface_shard (I,)
                        rest nodes shared with other shards (index into
                        the M nodes), their interface id and their shard,
                        for the psum (``device_plan`` places them in a
                        (P, BG + 1) buffer).
    """
    npe = n ** 3
    nn = n * n
    T = len(plans) * num_elements * npe
    fp = _face_points(n)
    table = _dihedral_table(n)
    partner = np.full(T, T, dtype=np.int64)
    node = np.full(T, -1, dtype=np.int64)
    inode, iglob, ishard = [], [], []
    node_off = 0
    for p, plan in enumerate(plans):
        if plan is None:
            continue
        off = p * num_elements * npe
        E = plan["rowmask"].shape[0]
        rowmask = plan["rowmask"].reshape(E * 6, nn) > 0.5
        for t in range(8):
            dst = plan["cls_dst%d" % t].astype(np.int64)
            src = plan["cls_src%d" % t].astype(np.int64)
            tgt = (dst // 6)[:, None] * npe + fp[dst % 6]
            frm = (src // 6)[:, None] * npe + fp[src % 6][:, table[t]]
            sel = rowmask[dst]
            partner[off + tgt[sel]] = off + frm[sel]
        rid = plan["rest_ids"].astype(np.int64)
        node[off + plan["rest"].astype(np.int64)] = node_off + rid
        bl = plan["rb_local"].astype(np.int64)
        inode.append(node_off + bl)
        iglob.append(plan["rb_global"].astype(np.int64))
        ishard.append(np.full(bl.size, p, dtype=np.int64))
        node_off += int(rid.max()) + 1 if rid.size else 0
    cat = lambda xs: (np.concatenate(xs) if xs
                      else np.zeros(0, dtype=np.int64))
    return {"partner": partner, "node": node, "num_nodes": node_off,
            "iface_node": cat(inode), "iface_global": cat(iglob),
            "iface_shard": cat(ishard)}


def device_plan(lowered: dict, num_boundary_global: int, device) -> dict:
    """The lowered plan on ``device``: the face-pair partners, the rest
    nodes' ordered segment sum (``gather_scatter.ordered_sum_plan`` over
    the points) with each sorted copy's node for the write-back, and the
    interface buffer slots for ``num_boundary_global`` interface ids."""
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    M = lowered["num_nodes"]
    sums = ordered_sum_plan(lowered["node"], M, device)
    back = None
    if sums is not None:
        back = as_t(lowered["node"][sums["perm"].cpu().numpy()])
    return {"partner": as_t(lowered["partner"]), "sums": sums,
            "back": back, "num_nodes": M,
            "iface_node": as_t(lowered["iface_node"]),
            "iface_global": as_t(lowered["iface_global"]),
            "iface_slot": as_t(lowered["iface_shard"]
                               * (num_boundary_global + 1)
                               + lowered["iface_global"]),
            "num_boundary_global": num_boundary_global}


def face_assemble(x, plan: dict, comm=None):
    """Exact assembled sums at every point, Q Qt x (no mask or weight), of
    a field x whose flat view is the plan's stack of points (a (P, ...)
    stack or one shard's flat field). comm: the psum of the interface
    nodes across shards (None: one shard)."""
    shape = x.shape
    xf = x.reshape(-1)
    y = xf + torch.cat([xf, xf.new_zeros(1)])[plan["partner"]]
    sums = plan["sums"]
    BG = plan["num_boundary_global"]
    # every process of a multi-process comm joins the psum, also one whose
    # shards hold no interface node
    join = comm is not None and comm.size > 1 and BG > 0 and (
        plan["iface_node"].numel() or comm.local_shards < comm.size)
    if sums is None:
        if join:
            comm.psum(xf.new_zeros(comm.local_shards, BG + 1))
        return y.reshape(shape)
    s = ordered_scatter_add(xf.new_zeros(plan["num_nodes"]), xf, sums)
    if join:
        buf = s.new_zeros(comm.local_shards * (BG + 1))
        buf.index_copy_(0, plan["iface_slot"], s[plan["iface_node"]])
        total = comm.psum(buf.view(comm.local_shards, BG + 1))
        s = s.index_copy(0, plan["iface_node"], total[plan["iface_global"]])
    return y.index_copy(0, sums["perm"], s[plan["back"]]).reshape(shape)


def face_dssum(x, plan: dict, *, mask, inv_degree_pts, comm=None,
               apply_mask: bool = True, apply_weight: bool = False):
    """Direct stiffness summation on unstructured hex shards: the exact
    assembly, then x inverse multiplicity (apply_weight), then x mask
    (apply_mask), as the generic dssum orders them."""
    y = face_assemble(x, plan, comm)
    if apply_weight:
        y = y * inv_degree_pts
    if apply_mask:
        y = y * mask
    return y
