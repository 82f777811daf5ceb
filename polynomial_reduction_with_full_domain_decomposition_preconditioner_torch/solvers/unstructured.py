"""Composite DD + polynomial-reduction preconditioner on unstructured meshes.

Port of the JAX package's ``solvers/unstructured.composite_dd_unstructured``
for generic (non-slab) partitions of arbitrary hex meshes: scrambled
connectivity and pebble beds. The host setup is the JAX package's, step
for step (numpy / scipy, mesh/graph.py):

- each shard's region grows from its own elements by vertex adjacency,
  ``subdomain_overlap`` steps a ring; region elements are grouped BY
  ORDER into classes (own + ring 0 at order N, ring l at order N - l r,
  the last ring and the far field at order 1), each one (P, E_c, n_c^3)
  element stack over the shards;
- same-order assembly: in 3-D by per-class face-block plans
  (ops/face_dssum.py), in 2-D (where the JAX package builds no face
  plans) by an ordered scatter of each class's points into its nodes and
  a gather back; cross-order continuity slaves fine face nodes to the
  coarse trace (graph.slave_constraints, the orientation absorbed into
  the host indices and weights), run in 3-D on a compact vector of the
  touched nodes and in 2-D on the class's node vector;
- a large far field is compressed algebraically (``far_compress``): kept
  fine vertices near the rings and smoothed aggregates for the rest, a
  sparse block per shard.

On the device every composite field is a list of per-class stacks (and
the superdomain vector, a (P, ns, 1) stack); the operator is the
element-layout contraction (ops/sem.stiffness_apply) a class and one
block-diagonal SpMV for the superdomain, and every scatter-add with
repeated targets goes through ``ordered_scatter_add`` (one fixed
summation order, no atomics). The outer residual reaches the classes
through the restriction cascade on the own elements and one
``comm.all_gather`` a level. The inner solve is rank-local at every shard
count: krylov ``batched=True`` with ``shard_dot``.

Inner preconditioners: "amg" (Chebyshev on the composite SEM operator
plus a smoothed-aggregation V-cycle on the global Q1 vertex matrix),
"fem-amg" (the composite reassembled as a low-order FEM matrix per shard,
amg/unstructured_fem.py, and a sparse V-cycle on its aggregation
hierarchy, the shards' hierarchies block-diagonal in one operator),
"jacobi" and "none". ``setup_cache`` keeps the whole host setup in one
npz (runtime/checkpoint.save_setup_payload) and rebuilds from it.
"""

from __future__ import annotations

import os
import time
import zlib

import numpy as np
import scipy.sparse as sp
import torch

from ..amg.aggregation import (aggregation_chain, pack_level_chain,
                               q1_vertex_matrix, q1_vertex_matrix_subset,
                               superdomain_basis)
from ..amg.composite import HostHierarchy, _mask_fold
from ..amg.unstructured_fem import build_unstructured_fem_shard, pad_fem_shards
from ..amg.vcycle import (_block_diag_csr, cheby_smooth,
                          composite_preconditioner, pack_hierarchies,
                          vcycle_apply)
from ..mesh import graph as gr
from ..ops import face_dssum as fd
from ..ops import interp, sem
from ..ops.csr import csr_from_scipy, sparse_spmv
from ..ops.gather_scatter import ordered_scatter_add, ordered_sum_plan
from ..runtime.checkpoint import load_setup_payload, save_setup_payload
from ..utils.gll import diff_matrix, gll_points_weights, interp_matrix
from .preconditioners import Preconditioner
from . import krylov

__all__ = ["composite_dd_unstructured"]


def _class_setup(mesh_o, elems, with_geom=True):
    """Node plan for one order class of one shard: elems (with -1 pads)
    -> dense local node ids (NN = trash), geometry (``with_geom``: the
    shards a process owns), node mask and the sorted global ids (a local
    id is a searchsorted)."""
    npe = mesh_o.num_points_per_elem
    Ec = elems.shape[0]
    real = elems >= 0
    safe = np.where(real, elems, 0)
    glo = np.where(real[:, None], mesh_o.glo_num[safe], -1)
    # unique + inverse through a presence bitmask (ids are dense)
    sel = glo[real]
    pres = np.zeros((mesh_o.num_nodes,), dtype=bool)
    pres[sel] = True
    uniq = np.flatnonzero(pres)
    rank = np.cumsum(pres, dtype=np.int64) - 1
    NN = uniq.size
    gids = np.full((Ec, npe), NN, dtype=np.int64)
    gids[real] = rank[sel].reshape(-1, npe)
    geom = None
    if with_geom:
        geom = np.zeros((Ec, npe, mesh_o.num_geom))
        geom[real] = mesh_o.geom[safe[real]]
    nmask = np.ones(NN + 1)
    nmask[NN] = 0.0
    nmask[gids[real].ravel()] = mesh_o.dirichlet_mask[safe[real]].ravel()
    return {"npe": npe, "E": Ec, "NN": NN,
            "gids": gids.reshape(-1), "geom": geom, "nmask": nmask,
            "uniq": uniq}


def _blend_matrix(n_o: int, dim: int) -> np.ndarray:
    """(n_o^dim, 2^dim) trilinear corner-blend factors of one element: the
    gather-free vertex <-> nodal transfer."""
    r_, _ = gll_points_weights(n_o)
    t = (r_ + 1.0) / 2.0
    fac = np.stack([1.0 - t, t])
    B = np.ones((2 ** dim,) + (n_o,) * dim)
    for cbit in range(2 ** dim):
        for d in range(dim):                  # storage axis (0 = slow)
            bit = (cbit >> (dim - 1 - d)) & 1
            shp = [1] * dim
            shp[d] = n_o
            B[cbit] = B[cbit] * fac[bit].reshape(shp)
    return B.reshape(2 ** dim, -1).T


# the format tag of the payloads setup_cache writes: the port's class
# layout (lowered face plans, CSR superdomain blocks), which the JAX
# package's payloads do not share
_SETUP_FORMAT = "torch-unstructured-composite-1"


def _setup_key(sd, orders, subdomain_overlap, superdomain_overlap,
               far_compress, max_coarse, dtype, owned) -> dict:
    """What shapes a host setup: a cached one is used only where its key
    equals this one (the mesh by a checksum of the partition's node ids
    and coordinates; the payload's stacks hold the ``owned`` shards)."""
    crc = zlib.crc32(np.ascontiguousarray(sd.glo_num).view(np.uint8))
    crc = zlib.crc32(np.ascontiguousarray(sd.coords).view(np.uint8), crc)
    return {"orders": [int(o) for o in orders],
            "shards": int(sd.num_shards),
            "elems_per_shard": int(sd.elems_per_shard),
            "elem_offsets": [int(x) for x in sd.elem_offsets],
            "subdomain_overlap": int(subdomain_overlap),
            "superdomain_overlap": int(superdomain_overlap),
            "far_compress": (far_compress if isinstance(far_compress, str)
                             else bool(far_compress)),
            "max_coarse": int(max_coarse), "ptype": str(dtype),
            "owned": [int(p) for p in owned],
            "mesh_crc32": int(crc)}


def _load_setup(path: str, key: dict) -> dict:
    """The payload at ``path``, which must be the port's and written for
    ``key``; anything else raises."""
    payload = load_setup_payload(path)
    if not isinstance(payload, dict) \
            or payload.get("format") != _SETUP_FORMAT:
        raise ValueError(
            f"setup_cache {path!r} is not a setup of the port's unstructured "
            "composite (the JAX package's payloads hold its own class "
            "layout): remove it or name another path")
    diff = sorted(k for k in set(key) | set(payload["key"])
                  if key.get(k) != payload["key"].get(k))
    if diff:
        raise ValueError(
            f"setup_cache {path!r} was written for another setup (it differs "
            f"in {', '.join(diff)}): remove it or name another path")
    return payload


def _host_setup(sd, mesh_builder, orders, V, superdomain_overlap,
                far_compress, fine_mesh, inner, max_coarse, lap, seconds,
                owned, build_all):
    """The composite's host setup (numpy / scipy): regions, class node
    plans, slave constraints, the compressed far field, the face plans
    and, for inner="fem-amg", the shards' FEM hierarchies. Returns what
    ``setup_cache`` keeps (numpy arrays, scipy CSR, python scalars) and
    the order-1 mesh. ``lap(stage)`` records a stage's seconds in
    ``seconds``.

    The index pass (regions, class sizes, constraint sizes, superdomain
    shapes) runs over every shard, since its maxima are the padded shapes
    that every process shares; geometry, face plans and the stacked
    arrays are made for the ``owned`` shards only, in their order (the
    JAX package's local-only setup). ``build_all``: the fem-amg
    hierarchies of every shard, padded together, of which the owned are
    kept (a multi-process run)."""
    dim = sd.dim
    N = orders[0]
    Pn = sd.num_shards
    E_pad = sd.elems_per_shard
    L = C = len(orders)                    # one class per level order
    order_set = sorted(set(orders) | {1})
    mesh_by_order = {o: (fine_mesh if o == N and fine_mesh is not None
                         else mesh_builder(o)) for o in order_set}
    mesh1 = mesh_by_order[1]
    verts = mesh1.glo_num                 # (E, 2^dim) corner vertex ids
    adj = gr.element_adjacency(verts)
    lap("meshes_graph")

    bounds = np.asarray(sd.elem_offsets, dtype=np.int64)
    own_counts = np.diff(bounds)
    owner_of = np.repeat(np.arange(Pn), own_counts)
    slot_of = np.concatenate([np.arange(c) for c in own_counts])

    # ---- per-shard regions: class 0 = own (slots [0, E_pad)) + ring 0 ----
    class_elems = [[] for _ in range(C)]
    region_sets, far_sets = [], []
    for p in range(Pn):
        own = np.arange(bounds[p], bounds[p + 1])
        rings, far = gr.grow_regions(adj, own, L, overlap=V)
        own_padded = np.concatenate(
            [own, np.full(E_pad - own.size, -1, dtype=np.int64)])
        class_elems[0].append(np.concatenate([own_padded, rings[0]]))
        for l in range(1, L - 1):
            class_elems[l].append(rings[l])
        region_sets.append((own, rings))
        far_sets.append(far)

    if far_compress == "auto":
        compress = (L > 1 and min(f.size for f in far_sets) >= 128
                    and not any(f.size == 0 for f in far_sets))
    else:
        compress = bool(far_compress) and L > 1 \
            and not any(f.size == 0 for f in far_sets)
    for p in range(Pn):
        own, rings = region_sets[p]
        far = far_sets[p]
        if L > 1:
            ring_last = rings[L - 1]
            class_elems[L - 1].append(
                ring_last if compress else np.concatenate([ring_last, far]))
        else:
            class_elems[0][p] = np.concatenate([class_elems[0][p], far])
    for c in range(C):                    # pad to the max count over shards
        Ec = max(e.size for e in class_elems[c])
        class_elems[c] = [
            np.concatenate([e, np.full(Ec - e.size, -1, dtype=np.int64)])
            for e in class_elems[c]]
    lap("regions")

    # ---- per-class node plans + slave constraints ----
    owned_set = set(owned)
    Po = len(owned)
    cls_setups = [[_class_setup(mesh_by_order[orders[c]], class_elems[c][p],
                                with_geom=p in owned_set)
                   for p in range(Pn)] for c in range(C)]
    nv = mesh1.num_nodes
    classes = []
    for c in range(C):
        mesh_o = mesh_by_order[orders[c]]
        per = cls_setups[c]
        Ec, npe_c = per[0]["E"], per[0]["npe"]
        src = np.zeros((Po, Ec), dtype=np.int64)
        valid = np.zeros((Po, Ec))
        vids = np.full((Po, Ec, 2 ** dim), nv, dtype=np.int64)
        pw = np.zeros((Po, Ec, npe_c))
        for k, p in enumerate(owned):
            e = class_elems[c][p]
            real = e >= 0
            safe = np.where(real, e, 0)
            src[k] = np.where(real, owner_of[safe] * E_pad + slot_of[safe], 0)
            valid[k] = real
            vids[k][real] = verts[safe][real]
            pw[k] = (1.0 / mesh_o.node_degree[safe]) * real[:, None]
        classes.append({
            "order": orders[c], "n": orders[c] + 1, "E": Ec, "npe": npe_c,
            "NN": max(s["NN"] for s in per),
            "geom": np.stack([per[p]["geom"] for p in owned]),
            "src": src, "valid": valid, "vids": vids, "pw": pw})

    per_slv_ids, per_slv_cols, per_slv_wts, slaves = {}, {}, {}, []
    for c in range(C - 1):
        nf, nc = orders[c] + 1, orders[c + 1] + 1
        glo_f = mesh_by_order[orders[c]].glo_num
        glo_c = mesh_by_order[orders[c + 1]].glo_num
        K = nc ** (dim - 1)
        per_ids, per_cols, per_wts = [], [], []
        for p in range(Pn):
            ef, ec = class_elems[c][p], class_elems[c + 1][p]
            pairs = gr.face_pairs(verts, ef[ef >= 0], ec[ec >= 0], dim)
            ids, cols, wts = gr.slave_constraints(pairs, verts, glo_f, glo_c,
                                                  nf, nc, dim)
            lf_u = cls_setups[c][p]["uniq"]
            lc_u = cls_setups[c + 1][p]["uniq"]
            per_ids.append(np.searchsorted(lf_u, ids).astype(np.int64))
            per_cols.append(np.searchsorted(lc_u, cols).astype(
                np.int64).reshape(ids.size, K) if ids.size
                else np.zeros((0, K), dtype=np.int64))
            per_wts.append(wts)
        per_slv_ids[c], per_slv_cols[c] = per_ids, per_cols
        per_slv_wts[c] = per_wts
        Ns = max(a.size for a in per_ids)
        ids_a = np.full((Po, Ns), classes[c]["NN"], dtype=np.int64)
        cols_a = np.full((Po, Ns, K), classes[c + 1]["NN"], dtype=np.int64)
        wts_a = np.zeros((Po, Ns, K))
        for j, p in enumerate(owned):
            k = per_ids[p].size
            ids_a[j, :k] = per_ids[p]
            cols_a[j, :k] = per_cols[p]
            wts_a[j, :k] = per_wts[p]
        slaves.append({"ids": ids_a, "cols": cols_a, "wts": wts_a})
    lap("classes_constraints")

    # ---- superdomain compression: the far field as a per-shard algebraic
    #      block (kept-fine vertices near the rings + smoothed aggregates) ----
    sup = None
    if compress:
        vmask_glob = np.ones(nv)
        vmask_glob[mesh1.glo_num[mesh1.dirichlet_mask < 0.5]] = 0.0
        degree_v = np.bincount(verts.ravel(), minlength=nv).astype(float)
        per_sup = []
        for p in range(Pn):
            own, rings = region_sets[p]
            far = far_sets[p]
            region = np.concatenate([own] + list(rings))
            reg_mask = np.zeros(adj.shape[0], dtype=bool)
            reg_mask[region] = True
            grown = reg_mask.copy()
            for _ in range(max(superdomain_overlap, 1)):
                grown |= (adj @ grown.astype(np.int8)).astype(bool)
            far_mask = np.zeros(adj.shape[0], dtype=bool)
            far_mask[far] = True
            ov_elems = np.flatnonzero(grown & far_mask)
            in_far = np.zeros(nv, dtype=bool)
            in_far[verts[far].ravel()] = True
            keep_fine = np.zeros(nv, dtype=bool)
            keep_fine[verts[ov_elems].ravel()] = True
            keep_fine &= in_far
            deep = in_far & ~keep_fine & (vmask_glob > 0.5)
            A_far = _mask_fold(q1_vertex_matrix_subset(mesh1, far),
                               vmask_glob)
            P_sup, fine_idx = superdomain_basis(A_far, keep_fine, deep)
            A_sup = (P_sup.T @ A_far @ P_sup).tocsr()
            # interface vertices shared with the coarsest SEM class
            lc_u = cls_setups[C - 1][p]["uniq"]
            pos = np.searchsorted(lc_u, fine_idx)
            inb = (pos < lc_u.size) & (
                lc_u[np.minimum(pos, lc_u.size - 1)] == fine_idx)
            iface = [(int(pos[k]), int(k)) for k in np.flatnonzero(inb)]
            mask_sup = np.ones(P_sup.shape[1])
            mask_sup[:fine_idx.size] = vmask_glob[fine_idx]
            # the far field's share of each kept vertex's residual
            far_deg = np.bincount(verts[far].ravel(), minlength=nv)
            wrest = np.ones(P_sup.shape[1])
            wrest[:fine_idx.size] = far_deg[fine_idx] / degree_v[fine_idx]
            per_sup.append({"A": A_sup, "P": P_sup, "mask": mask_sup,
                            "wrest": wrest, "iface": iface, "far": far})
        ns = max(d["A"].shape[0] for d in per_sup)
        Ef = max(d["far"].size for d in per_sup)
        Ni = max(len(d["iface"]) for d in per_sup)
        A_pad, P_pad = [], []
        mask_a, wrest_a, diag_a = (np.zeros((Po, ns)) for _ in range(3))
        ifc_a = np.full((Po, Ni), classes[C - 1]["NN"], dtype=np.int64)
        ifs_a = np.full((Po, Ni), ns, dtype=np.int64)
        sup_src = np.zeros((Po, Ef), dtype=np.int64)
        sup_valid = np.zeros((Po, Ef))
        sup_vids = np.full((Po, Ef, 2 ** dim), nv, dtype=np.int64)
        for p, d in enumerate(per_sup[q] for q in owned):
            A = sp.csr_matrix(d["A"])
            A.resize((ns, ns))
            A_pad.append(A)
            Pm = sp.csr_matrix(d["P"])
            Pm.resize((nv, ns))
            P_pad.append(Pm)
            k = d["A"].shape[0]
            mask_a[p, :k] = d["mask"]
            wrest_a[p, :k] = d["wrest"]
            diag_a[p, :k] = d["A"].diagonal()
            for i, (ci, si) in enumerate(d["iface"]):
                ifc_a[p, i] = ci
                ifs_a[p, i] = si
            f = d["far"]
            sup_src[p, :f.size] = owner_of[f] * E_pad + slot_of[f]
            sup_valid[p, :f.size] = 1.0
            sup_vids[p, :f.size] = verts[f]
        sup = {"A": A_pad, "P": P_pad, "mask": mask_a, "wrest": wrest_a,
               "diag": diag_a, "ifc": ifc_a, "ifs": ifs_a, "src": sup_src,
               "valid": sup_valid, "vids": sup_vids, "ns": ns, "Ef": Ef}
    lap("superdomain")

    if dim == 2:
        # the JAX package's 2-D route: no face plans; each class is
        # assembled by a scatter of its points into its nodes and a gather
        # back, and the constraint algebra indexes the class's own node
        # vector (NT = NN: every node counts as touched)
        for cl, per in zip(classes, cls_setups):
            NN = cl["NN"]
            per = [per[p] for p in owned]
            cl.update(NT=NN, pmask=np.stack([s["nmask"][s["gids"]]
                                             for s in per]),
                      gids=np.stack([np.where(s["gids"] == s["NN"], NN,
                                              s["gids"]) for s in per]))
        lap("scatter_plans")
    else:
        # ---- face-block plans + touched-node compaction per class ----
        for c in range(C):
            cl = classes[c]
            plans = []
            for p in owned:
                s = cls_setups[c][p]
                gl = s["gids"].reshape(s["E"], s["npe"])
                gl = np.where(gl == s["NN"], -1, gl)
                deg_c = np.bincount(gl[gl >= 0], minlength=s["NN"])
                deg_pts = np.where(gl >= 0, deg_c[np.maximum(gl, 0)], 0)
                plans.append(fd.build_face_plan(gl, cl["n"], deg_pts)[0])
            cl["fb"] = fd.lower_plans(plans, cl["n"], cl["E"])
        # touched nodes: slave cols from below, slave ids to above, the
        # superdomain interface on the coarsest class
        cls_T = []
        for c in range(C):
            per_T = []
            for p in range(Pn):
                parts_T = []
                if c > 0 and per_slv_cols[c - 1][p].size:
                    parts_T.append(per_slv_cols[c - 1][p].reshape(-1))
                if c < C - 1 and per_slv_ids[c][p].size:
                    parts_T.append(per_slv_ids[c][p])
                if c == C - 1 and sup is not None:
                    parts_T.append(np.asarray(
                        [ci for ci, _ in per_sup[p]["iface"]], dtype=np.int64))
                per_T.append(np.unique(np.concatenate(parts_T)) if parts_T
                             else np.zeros(0, np.int64))
            cls_T.append(per_T)
        cls_NT = [max(t.size for t in cls_T[c]) for c in range(C)]

        def tmap_of(c, p):
            T = cls_T[c][p]
            m = np.full(cls_setups[c][p]["NN"] + 1, cls_NT[c], dtype=np.int64)
            m[T] = np.arange(T.size)
            return m

        # slave / interface indices in touched-compact numbering
        for c in range(C - 1):
            s = slaves[c]
            for j, p in enumerate(owned):
                mf, mc = tmap_of(c, p), tmap_of(c + 1, p)
                nn_f = cls_setups[c][p]["NN"]
                nn_c = cls_setups[c + 1][p]["NN"]
                s["ids"][j] = np.where(s["ids"][j] < nn_f,
                                       mf[np.minimum(s["ids"][j], nn_f)],
                                       cls_NT[c])
                s["cols"][j] = np.where(s["cols"][j] < nn_c,
                                        mc[np.minimum(s["cols"][j], nn_c)],
                                        cls_NT[c + 1])
        if sup is not None:
            for j, p in enumerate(owned):
                mt = tmap_of(C - 1, p)
                nn_t = cls_setups[C - 1][p]["NN"]
                sup["ifc"][j] = np.where(sup["ifc"][j] < nn_t,
                                         mt[np.minimum(sup["ifc"][j], nn_t)],
                                         cls_NT[C - 1])
        for c in range(C):
            cl = classes[c]
            NT, T_pts = cls_NT[c], cl["E"] * cl["npe"]
            trep = np.zeros((Po, NT + 1), dtype=np.int64)
            tpts, tids = [], []
            pmask = np.zeros((Po, T_pts))
            for j, p in enumerate(owned):
                tm = tmap_of(c, p)
                gl = cls_setups[c][p]["gids"]
                sel = np.flatnonzero(np.isin(gl, cls_T[c][p]))
                tpts.append(j * T_pts + sel)
                tids.append(j * (NT + 1) + tm[gl[sel]])
                # a representative point per touched node: the first (the
                # trash slot NT reads point 0; every use of it is masked)
                first = np.zeros(NT + 1, dtype=np.int64)
                first[tm[gl[sel]][::-1]] = sel[::-1]
                trep[j] = j * T_pts + first
                s = cls_setups[c][p]
                pmask[j] = s["nmask"][np.minimum(s["gids"], s["NN"])]
            cl.update(NT=NT, trep=trep.reshape(-1), tpts=np.concatenate(tpts),
                      tids=np.concatenate(tids), pmask=pmask)
        lap("face_plans")

    fem = None
    if inner == "fem-amg":
        # per shard: the composite reassembled as a low-order FEM matrix
        # (Kuhn P1 on GLL subcells, exact SEM Q1 for order 1, the far
        # field's superdomain block) and its aggregation hierarchy, from
        # the class-local constraints; then padded to equal shapes
        fem_shards = []
        fem_seconds = {}
        shard_set = list(range(Pn)) if build_all else list(owned)
        for p in shard_set:
            slv_p = [(per_slv_ids[c][p], per_slv_cols[c][p],
                      per_slv_wts[c][p]) for c in range(C - 1)]
            sup_p = None
            if sup is not None:
                sup_p = {k: per_sup[p][k] for k in ("A", "iface", "mask")}
            fem_shards.append(build_unstructured_fem_shard(
                orders, mesh_by_order, [class_elems[c][p] for c in range(C)],
                [cls_setups[c][p] for c in range(C)], slv_p, sup_p,
                max_coarse=max_coarse, seconds=fem_seconds))
        lap("fem_hierarchy")
        fem = pad_fem_shards(fem_shards,
                             ns_pad=sup["ns"] if sup is not None else 0)
        fem = [fem[shard_set.index(p)] for p in owned]
        lap("fem_pad")
        seconds.update({f"fem_{k}": v for k, v in fem_seconds.items()})
    regions = [{"own": int(o.size), "rings": [int(r.size) for r in rings],
                "far": int(f.size), "compressed": bool(compress)}
               for (o, rings), f in zip(region_sets, far_sets)]
    return {"classes": classes, "slaves": slaves, "sup": sup, "nv": nv,
            "regions": regions, "fem": fem}, mesh1


def composite_dd_unstructured(domain, mesh_builder, poly_reduction: int,
                              subdomain_overlap: int = 1,
                              superdomain_overlap: int = 1,
                              num_iterations: int = 4,
                              inner: str = "jacobi",
                              inner_solver: str = "fgmres",
                              num_vcycles: int = 1,
                              cheby_order: int = 2,
                              ptype=None,
                              max_coarse: int = 600,
                              fine_mesh=None,
                              far_compress="auto",
                              setup_cache: str | None = None
                              ) -> Preconditioner:
    """Composite preconditioner for generic (non-slab) partitions; the
    contract of solvers/subdomain.composite_dd. ``mesh_builder(o)`` must
    return the same elements (same ids, same local frames) meshed at order
    o, as scramble_mesh and pebble_mesh do.

    far_compress: "auto" compresses the far field when every shard has
    one of >= 128 elements; True / False force it (where every shard has
    a far field). ``extra["setup_seconds"]`` holds the host setup's
    seconds by stage.

    setup_cache: npz path of the whole host setup (regions, node plans,
    constraints, superdomain blocks, face plans, the fem-amg hierarchies,
    the vertex chain and Chebyshev bounds of inner="amg"). An existing
    file is loaded in place of the setup; it must be the port's and have
    been written for the same mesh, partition, orders, overlaps,
    far_compress, max_coarse and ptype, else this raises. A file without
    the fem hierarchies counts as missing for inner="fem-amg". After a
    fresh setup the file is written. A process of a multi-process run
    keeps its own payload, of its own shards, at the path with
    ``_pp{rank}of{processes}_o{first}-{last}`` before the extension."""
    if inner not in ("amg", "fem-amg", "jacobi", "none"):
        raise ValueError(f"unstructured composite inner={inner!r} "
                         "(use 'amg', 'fem-amg', 'jacobi' or 'none')")
    if inner_solver not in ("fgmres", "fcg"):
        raise ValueError(f"inner_solver={inner_solver!r} "
                         "(use 'fgmres' or 'fcg')")
    from .subdomain import _rank_local_solve

    sd = domain.sharded
    dim = domain.dim
    N = domain.poly_degree
    dtype = ptype if ptype is not None else domain.dtype
    device = domain.device
    comm = domain.comm
    Pn = sd.num_shards
    owned = list(domain.owned)             # this process's shards
    Po = len(owned)
    E_pad = sd.elems_per_shard
    seconds = {}
    clock = [time.perf_counter()]

    def lap(stage):
        now = time.perf_counter()
        seconds[stage] = now - clock[0]
        clock[0] = now

    # level hierarchy N, N-r, ..., 1
    orders = [N]
    while orders[-1] > 1:
        orders.append(max(orders[-1] - poly_reduction, 1))
    L = len(orders)
    C = L                                  # one class per level order

    host = mesh1 = None
    key = None
    if setup_cache is not None and domain.multiprocess:
        # each process's payload stacks its own shards: its own file
        root, ext = os.path.splitext(setup_cache)
        setup_cache = (f"{root}_pp{comm.rank}of{comm.processes}"
                       f"_o{owned[0]}-{owned[-1]}{ext}")
    if setup_cache is not None:
        key = _setup_key(sd, orders, subdomain_overlap, superdomain_overlap,
                         far_compress, max_coarse, dtype, owned)
        if os.path.exists(setup_cache):
            host = _load_setup(setup_cache, key)
            if inner == "fem-amg" and host["fem"] is None:
                # written for another inner: the fem hierarchies need the
                # class-local constraints, which only a fresh setup has
                host = None
            lap("load")
    fresh = host is None
    if fresh:
        host, mesh1 = _host_setup(sd, mesh_builder, orders, subdomain_overlap,
                                  superdomain_overlap, far_compress,
                                  fine_mesh, inner, max_coarse, lap, seconds,
                                  owned, domain.multiprocess)
    classes, slaves, sup, nv = (host["classes"], host["slaves"],
                                host["sup"], host["nv"])
    cls_NT = [cl["NT"] for cl in classes]

    # ---- device tensors: class c's fields are (P, E_c, npe_c) stacks ----
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    device=device).to(dtype)
    idx = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64).reshape(-1),
                                    device=device)
    cls_x = []
    for c, cl in enumerate(classes):
        shp = (Po, cl["E"], cl["npe"])
        x = {
            "shape": shp,
            "geom": tuple(put(cl["geom"][..., k])
                          for k in range(cl["geom"].shape[-1])),
            "D": torch.as_tensor(diff_matrix(cl["n"]), device=device).to(
                dtype),
            "src": idx(cl["src"]),
            "valid": put(cl["valid"][..., None]),
            "pmask": put(cl["pmask"].reshape(shp)),
            "NT": cl["NT"],
            # corner vertex ids over the (P, nv + 1) vertex stack
            "vids": idx(cl["vids"] + (nv + 1) * np.arange(Po)[:, None, None]),
            "pw": put(cl["pw"]),
        }
        if dim == 3:
            x.update(fb=fd.device_plan(cl["fb"], 0, device),
                     trep=idx(cl["trep"]), tpts=idx(cl["tpts"]),
                     tids=idx(cl["tids"]))
        else:
            # each shard's class nodes at (NN + 1) p over the stack
            gids = cl["gids"] + (cl["NN"] + 1) * np.arange(Po)[:, None]
            x.update(gids=idx(gids), scatter=ordered_sum_plan(
                gids, Po * (cl["NN"] + 1), device))
        cls_x.append(x)
    slv_x = []
    for c, s in enumerate(slaves):
        NTf, NTc = cls_NT[c] + 1, cls_NT[c + 1] + 1
        offs = np.arange(Po)
        cols = s["cols"] + NTc * offs[:, None, None]
        slv_x.append({
            "ids": idx(s["ids"] + NTf * offs[:, None]),
            "cols": idx(cols), "wts": put(s["wts"]),
            "collapse": ordered_sum_plan(cols, Po * NTc, device),
        })
    Jlvl = [torch.as_tensor(interp_matrix(orders[i + 1] + 1, orders[i] + 1),
                            device=device).to(dtype) for i in range(L - 1)]
    sup_x = None
    if sup is not None:
        ns = sup["ns"]
        offs = np.arange(Po)
        block = lambda ms: csr_from_scipy(_block_diag_csr(ms), dtype=dtype,
                                          device=device)
        vids_flat = sup["vids"] + (nv + 1) * offs[:, None, None]
        sup_x = {
            "A": block(sup["A"]), "P": block(sup["P"]),
            "Pt": block([m.T.tocsr() for m in sup["P"]]),
            "mask": put(sup["mask"][..., None]),
            "wrest": put(sup["wrest"][..., None]),
            "diag": put(sup["diag"][..., None]),
            "ifc": idx(sup["ifc"] + (cls_NT[C - 1] + 1) * offs[:, None]),
            "ifs": idx(sup["ifs"] + (ns + 1) * offs[:, None]),
            "src": idx(sup["src"]), "valid": put(sup["valid"][..., None]),
            "vsum": ordered_sum_plan(vids_flat, Po * (nv + 1), device),
            "ns": ns,
        }
    lap("device")

    def spmv(mat, x):
        """A block-diagonal CsrMatrix over the shards on a (P, n[, 1])
        stack."""
        return sparse_spmv(mat, x.reshape(-1)).view(Po, -1, 1)

    def comp_operator(parts):
        out = [sem.stiffness_apply(U, cx["geom"], cx["D"], dim)
               for U, cx in zip(parts, cls_x)]
        if sup_x is not None:
            out.append(spmv(sup_x["A"], parts[C]))
        return out

    def comp_dssum(parts, apply_mask=True):
        # exact assembly per class (3-D: face blocks, then the slave /
        # superdomain constraint algebra on the compact touched vectors;
        # 2-D: an ordered scatter into the class's nodes, the algebra on
        # those node vectors)
        ys, wTs = [], []
        for c in range(C):
            cx = cls_x[c]
            if dim == 2:
                wTs.append(ordered_scatter_add(
                    parts[c].new_zeros(Po * (cx["NT"] + 1)),
                    parts[c].reshape(-1), cx["scatter"]))
                continue
            if cx["shape"][1] == 0:          # an empty class
                ys.append(parts[c])
                wTs.append(parts[c].new_zeros(Po * (cx["NT"] + 1)))
                continue
            y = fd.face_assemble(parts[c], cx["fb"])
            ys.append(y)
            wTs.append(y.reshape(-1)[cx["trep"]])
        for c in range(C - 1):               # collapse fine -> coarse
            s = slv_x[c]
            contrib = s["wts"] * wTs[c][s["ids"]].view(Po, -1, 1)
            wTs[c + 1] = ordered_scatter_add(wTs[c + 1], contrib.reshape(-1),
                                             s["collapse"])
        w_sup = None
        if sup_x is not None:
            # the superdomain's kept-fine vertices and the coarsest class
            # both take the summed value at a shared vertex
            w_sup = torch.cat([parts[C].reshape(Po, -1),
                               parts[C].new_zeros(Po, 1)], 1).reshape(-1)
            shared = wTs[C - 1][sup_x["ifc"]] + w_sup[sup_x["ifs"]]
            wTs[C - 1] = wTs[C - 1].index_copy(0, sup_x["ifc"], shared)
            w_sup = w_sup.index_copy(0, sup_x["ifs"], shared)
            w_sup = w_sup.view(Po, -1)[:, :-1].reshape(Po, -1, 1)
        for c in range(C - 2, -1, -1):       # prolong coarse -> fine
            s = slv_x[c]
            vals = (s["wts"] * wTs[c + 1][s["cols"]].view(s["wts"].shape)
                    ).sum(-1)
            wTs[c] = wTs[c].index_copy(0, s["ids"], vals.reshape(-1))
        outs = []
        for c in range(C):
            cx = cls_x[c]
            if dim == 2:
                y = wTs[c][cx["gids"]].view(cx["shape"])
            elif cx["shape"][1] == 0:
                outs.append(ys[c])
                continue
            else:
                y = ys[c].reshape(-1).index_copy(0, cx["tpts"],
                                                 wTs[c][cx["tids"]])
                y = y.view(cx["shape"])
            outs.append(y * cx["pmask"] if apply_mask else y)
        if sup_x is not None:
            outs.append(w_sup * sup_x["mask"] if apply_mask else w_sup)
        return outs

    def tree_cascade(r):
        # restriction cascade on the own elements, order N -> ... -> 1
        r_lvl = [r.reshape(Po, E_pad, -1)]
        for Jl in Jlvl:
            r_lvl.append(interp.restrict(r_lvl[-1], Jl, dim))
        return r_lvl

    def tree_rhs(r):
        # one all-gather a level; rings and far field are then per-shard
        # element takes of the gathered levels
        blocks = [comm.all_gather(rl) for rl in tree_cascade(r)]
        parts = []
        for c in range(C):
            cx = cls_x[c]
            sel = blocks[c].index_select(0, cx["src"]).view(cx["shape"])
            parts.append(sel * cx["valid"])
        if sup_x is not None:
            # the far elements' restricted residual, vertex-assembled and
            # projected with P^T
            sel = (blocks[C - 1].index_select(0, sup_x["src"])
                   .view(Po, -1, 2 ** dim) * sup_x["valid"])
            w_v = ordered_scatter_add(sel.new_zeros(Po * (nv + 1)),
                                      sel.reshape(-1), sup_x["vsum"])
            parts.append(spmv(sup_x["Pt"], w_v.view(Po, -1)[:, :nv]))
        return parts

    def comp_inv_diag():
        diag = [sem.stiffness_diagonal(cx["geom"], cx["D"], dim)
                for cx in cls_x]
        if sup_x is not None:
            diag.append(sup_x["diag"])
        return [torch.where(d > 0, 1.0 / d, torch.zeros_like(d))
                for d in comp_dssum(diag, apply_mask=False)]

    def A_mf(x):
        return comp_dssum(comp_operator(x), apply_mask=True)

    comp_mask = [cx["pmask"] for cx in cls_x]
    if sup_x is not None:
        comp_mask.append(sup_x["mask"])

    amg = None
    if inner == "amg":
        # smoothed-aggregation hierarchy on the global Q1 vertex matrix,
        # cycled per shard (a (P, nv) stack)
        if host.get("agg_info") is not None:
            agg_info, vmask = host["agg_info"], host["agg_vmask"]
        else:
            A_v, vmask = q1_vertex_matrix(
                mesh1 if mesh1 is not None else mesh_builder(1))
            agg_info = aggregation_chain(A_v, vmask, max_coarse=max_coarse)
            lap("aggregation")
        chain = pack_level_chain(agg_info, dtype=dtype, device=device,
                                 shards=Po)
        vmask_t = put(vmask)
        B = [put(_blend_matrix(cl["n"], dim)) for cl in classes]
        vplans = [ordered_sum_plan(
            cl["vids"] + (nv + 1) * np.arange(Po)[:, None, None],
            Po * (nv + 1), device) for cl in classes]
        comp_invd = comp_inv_diag()

        if host.get("lmax0") is not None:
            # kept in f64, which holds every ptype's value exactly
            lmax0 = torch.as_tensor(np.asarray(host["lmax0"], np.float64),
                                    device=device).to(dtype).reshape(Po, 1, 1)
        else:
            # Chebyshev bound per shard: lambda_max(D^-1 S A) of its
            # composite by 20 power-iteration steps with rank-local dots,
            # x 1.1
            x, off = [], 0
            for m in comp_mask:
                sz = m[0].numel()
                base = (torch.arange(sz, dtype=torch.float64, device=device)
                        .to(dtype) + off) * 0.7311
                x.append(torch.sin(base).reshape(m.shape[1:]) * m)
                off += sz
            lam = None
            for _ in range(20):
                y = [iv * ax for iv, ax in zip(comp_invd, A_mf(x))]
                num = krylov.shard_dot(y, y)
                den = torch.clamp(krylov.shard_dot(x, x), min=1e-30)
                lam = torch.sqrt(num / den)
                scale = 1.0 / torch.clamp(torch.sqrt(num), min=1e-30)
                x = [krylov._bc(scale, yl) * yl for yl in y]
            lmax0 = (lam * 1.1).reshape(Po, 1, 1)
        amg = {"chain": chain, "vmask": vmask_t, "B": B, "lmax0": lmax0}

        def restrict_to_vertex(parts):
            acc = parts[0].new_zeros(Po * (nv + 1))
            for c, cx in enumerate(cls_x):
                contrib = torch.matmul(cx["pw"] * parts[c], B[c])
                acc = ordered_scatter_add(acc, contrib.reshape(-1),
                                          vplans[c])
            acc = acc.view(Po, -1)[:, :nv]
            if sup_x is not None:
                acc = acc + spmv(sup_x["P"], parts[C] * sup_x["wrest"]
                                 ).view(Po, -1)
            return acc * vmask_t

        def prolong_from_vertex(v):
            vp = torch.cat([v * vmask_t, v.new_zeros(Po, 1)], 1).reshape(-1)
            outs = [torch.matmul(vp[cx["vids"]].view(
                cx["shape"][:2] + (2 ** dim,)), B[c].T)
                for c, cx in enumerate(cls_x)]
            if sup_x is not None:
                outs.append(spmv(sup_x["Pt"], vp.view(Po, -1)[:, :nv]))
            return [o * m for o, m in zip(outs, comp_mask)]

        def inner_precond(rr):
            fc = comp_dssum(rr, apply_mask=True)
            x = cheby_smooth(A_mf, comp_invd, lmax0, fc, None, cheby_order)
            for _ in range(num_vcycles):
                r = [a - b for a, b in zip(fc, A_mf(x))]
                v = vcycle_apply(chain, restrict_to_vertex(r),
                                 cheby_order=cheby_order)
                x = [a + b for a, b in zip(x, prolong_from_vertex(v))]
                x = cheby_smooth(A_mf, comp_invd, lmax0, fc, x, cheby_order)
            return x
        lap("lmax")
    elif inner == "fem-amg":
        # the shards' FEM hierarchies as block-diagonal operators in ptype
        # (amg/vcycle.pack_hierarchies): Q^T to the FEM DOFs, the mask,
        # num_vcycles V-cycles, the mask, Q back to the composite points
        fem_tree = pack_hierarchies(
            [HostHierarchy(mats=s["chain"]["mats"],
                           prolongs=s["chain"]["prolongs"],
                           lmaxs=s["chain"]["lmaxs"],
                           coarse_inv=s["chain"]["coarse_inv"],
                           Q=s["Q"], dof_mask=s["dof_mask"])
             for s in host["fem"]], dtype, device=device,
            stacked=domain.spmd)
        fem_apply = composite_preconditioner(
            fem_tree, cheby_order=cheby_order, num_cycles=num_vcycles)
        lap("fem_pack")

        def inner_precond(rr):
            # one flat composite vector a shard: the classes in order,
            # then the superdomain part (the rows of Q)
            flat = torch.cat([p.reshape(Po, -1) for p in rr], 1)
            z = fem_apply(flat if domain.spmd else flat[0]).reshape(Po, -1)
            parts = torch.split(z, [p[0].numel() for p in rr], dim=1)
            return [q.reshape(p.shape) for q, p in zip(parts, rr)]
    elif inner == "jacobi":
        comp_invd = comp_inv_diag()

        def inner_precond(rr):
            return [d * iv for d, iv in zip(comp_dssum(rr, apply_mask=True),
                                            comp_invd)]
    else:
        def inner_precond(rr):
            return comp_dssum(rr, apply_mask=True)

    if setup_cache is not None and fresh:
        saved = dict(host, format=_SETUP_FORMAT, key=key, agg_info=None,
                     agg_vmask=None, lmax0=None)
        if amg is not None:
            saved.update(agg_info=agg_info, agg_vmask=vmask,
                         lmax0=lmax0.reshape(-1).double().cpu().numpy())
        save_setup_payload(setup_cache, saved)
        lap("save")

    extra = {"classes": cls_x, "setup_seconds": seconds,
             "regions": host["regions"]}
    if sup_x is not None:
        extra["sup"] = sup_x
    if amg is not None:
        extra["amg"] = amg
    if inner == "fem-amg":
        extra["fem"] = fem_tree

    def build(arrays, extra_, ops):
        _, dssum_f, _, _ = ops

        def _solve_inner(r):
            # STYPE -> PTYPE cast at the tree boundary; every shard solves
            # its own composite problem
            f_comp = tree_rhs(r.to(dtype))
            res = _rank_local_solve(
                comp_operator, inner_precond,
                lambda rr: comp_dssum(rr, apply_mask=True), f_comp,
                inner_solver, num_iterations)
            # own elements sit in class 0's leading E_pad slots
            z = res.u[0][:, :E_pad].reshape(r.shape).to(domain.dtype)
            return (dssum_f(z, apply_mask=True, apply_weight=True),
                    res.residual_history)

        def precond(r):
            return _solve_inner(r)[0]

        def probe(r):
            # the max over the shards' inner histories, as the JAX
            # package's Domain.precond_probe reports them
            z, hist = _solve_inner(r)
            return z, torch.amax(hist, dim=-1)

        precond.probe = probe
        precond.tree_rhs = lambda r: tree_rhs(r.to(dtype))
        precond.comp_dssum = comp_dssum
        precond.comp_operator = comp_operator
        return precond

    return Preconditioner(build=build, extra=extra)
