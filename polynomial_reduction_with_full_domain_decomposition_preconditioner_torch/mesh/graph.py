"""Element graph, region growth, and cross-order face constraints.

The port's own copy of the JAX package's ``mesh/graph.py`` (host numpy /
scipy, the same arithmetic, so every function's output is equal to the
JAX package's):

- element adjacency from shared corner vertices (one sparse incidence
  product);
- overlap rings grown by repeated SpMV of the adjacency matrix on
  indicator vectors;
- cross-order face constraints with orientation matching: fine element
  faces meeting a lower-order neighbour are slaved to the coarse face
  trace, the orientation absorbed into the setup-side node indices and
  interpolation weights, so the device sees only padded (node, [cols],
  [weights]) arrays.

Vertex identity across polynomial orders comes from the order-1 mesh's
``glo_num`` (its nodes are the element corners), so graph construction
never compares floating-point coordinates.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..utils.gll import gll_points_weights, lagrange_eval

__all__ = ["element_adjacency", "grow_regions", "face_pairs",
           "slave_constraints", "corner_positions", "face_node_ids"]


def corner_positions(n: int, dim: int) -> np.ndarray:
    """Local node ids of the 2^dim element corners, indexed by the corner
    bit pattern (cz, cy, cx) raveled with x fastest — i.e. corner
    c = cx + 2*cy (+ 4*cz) sits at node cx*(n-1) + cy*(n-1)*n (+ ...)."""
    out = []
    for c in range(2 ** dim):
        node = 0
        stride = 1
        for d in range(dim):          # d = 0 is x (fastest)
            bit = (c >> d) & 1
            node += bit * (n - 1) * stride
            stride *= n
        out.append(node)
    return np.asarray(out, dtype=np.int64)


def element_adjacency(verts: np.ndarray) -> sp.csr_matrix:
    """Element-element adjacency (shared >= 1 vertex), boolean CSR.

    verts: (E, 2^dim) corner vertex ids (the order-1 mesh's glo_num).
    The reference's vertex->element maps + per-element adjacency sets
    (subdomain.tpp:282-430) in one incidence product.
    """
    E, npc = verts.shape
    nv = int(verts.max()) + 1
    M = sp.csr_matrix(
        (np.ones(E * npc, dtype=np.int8),
         (np.repeat(np.arange(E), npc), verts.ravel())),
        shape=(E, nv))
    A = (M @ M.T).tocsr()
    A.setdiag(0)
    A.eliminate_zeros()
    A.data[:] = 1
    return A


def grow_regions(adj: sp.csr_matrix, own: np.ndarray, num_rings: int,
                 overlap: int = 1):
    """Region growth by expander SpMV (subdomain.tpp:487-510).

    own: element indices of the shard's own partition. Returns
    (rings, far): ``rings`` is a list of ``num_rings`` element-index
    arrays (ring l = elements ``overlap`` adjacency steps beyond the
    previous region), ``far`` the remaining elements. Ring arrays are
    sorted; disjoint from each other and from own/far by construction.
    """
    E = adj.shape[0]
    reg = np.zeros(E, dtype=bool)
    reg[own] = True
    rings = []
    for _ in range(num_rings):
        prev = reg.copy()
        for _ in range(overlap):
            reg |= (adj @ reg.astype(np.int8)).astype(bool)
        rings.append(np.flatnonzero(reg & ~prev))
    far = np.flatnonzero(~reg)
    return rings, far


# face enumeration: face id f in 0..2*dim-1 = (axis, side) with axis the
# STORAGE axis (0 = slowest, dim-1 = x/fastest), side 0 = low, 1 = high.
# Face parametric axes (alpha, beta) = the remaining storage axes in
# ascending order.


def _face_axes(axis: int, dim: int):
    return [d for d in range(dim) if d != axis]


def face_node_ids(n: int, dim: int, face: int) -> np.ndarray:
    """(n^(dim-1),) local node ids of a face, raveled over the face's
    parametric axes (alpha slow, beta fast)."""
    axis, side = divmod(face, 2)
    idx = np.indices((n,) * (dim - 1))        # (dim-1, n, ..., n)
    coord = [None] * dim
    for k, d in enumerate(_face_axes(axis, dim)):
        coord[d] = idx[k]
    coord[axis] = np.full(idx.shape[1:], 0 if side == 0 else n - 1)
    node = np.zeros(idx.shape[1:], dtype=np.int64)
    for d in range(dim):                      # storage: axis 0 slowest
        node = node * n + coord[d]
    return node.reshape(-1)


def _face_corner_verts(verts_row: np.ndarray, face: int, dim: int):
    """Corner vertex ids of a face as a (2,)*(dim-1) array over the face's
    parametric axes. verts_row: (2^dim,) corner ids (x-fastest bits)."""
    axis, side = divmod(face, 2)
    # corner bit for storage axis d: x (fastest) is bit 0 = dim-1-d
    out = np.empty((2,) * (dim - 1), dtype=np.int64)
    for loc in np.ndindex(*(2,) * (dim - 1)):
        bits = [0] * dim
        bits[axis] = side
        for k, d in enumerate(_face_axes(axis, dim)):
            bits[d] = loc[k]
        c = sum(bits[d] << (dim - 1 - d) for d in range(dim))
        out[loc] = verts_row[c]
    return out


def _face_corner_table(dim: int) -> np.ndarray:
    """(2*dim, 2^(dim-1)) corner-slot indices of each face into an
    element's (2^dim,) corner row, in _face_corner_verts ravel order."""
    tab = []
    for face in range(2 * dim):
        axis, side = divmod(face, 2)
        rows = []
        for loc in np.ndindex(*(2,) * (dim - 1)):
            bits = [0] * dim
            bits[axis] = side
            for k, d in enumerate(_face_axes(axis, dim)):
                bits[d] = loc[k]
            rows.append(sum(bits[d] << (dim - 1 - d)
                            for d in range(dim)))
        tab.append(rows)
    return np.asarray(tab, dtype=np.int64)


def face_pairs(verts: np.ndarray, elems_a: np.ndarray, elems_b: np.ndarray,
               dim: int):
    """Shared faces between element sets a and b (conforming whole-face
    matches — the mesh family has no 2:1 refinement).

    Returns a list of (ea, fa, eb, fb) with ea in elems_a, eb in elems_b
    and fa/fb face ids. The reference's matching_face role
    (subdomain.tpp:1300-1494); orientation is resolved later from the
    corner arrays. Vectorized: sorted-corner keys for every (element,
    face) at once, matched with one lexsort (a per-face python dict
    cost ~5 s per class pair at pebble-bed sizes).
    """
    tab = _face_corner_table(dim)
    nf, nc = tab.shape

    def face_keys(elems):
        elems = np.asarray(elems)
        keys = np.sort(verts[elems][:, tab], axis=2).reshape(-1, nc)
        eidx = np.repeat(elems, nf)
        fidx = np.tile(np.arange(nf), elems.size)
        # dedup within the set, keeping the LAST occurrence in
        # iteration order (the dict semantics this replaces)
        order = np.lexsort(keys.T[::-1])
        ks = keys[order]
        new = np.empty(ks.shape[0], dtype=bool)
        new[0] = True
        new[1:] = (ks[1:] != ks[:-1]).any(axis=1)
        starts = np.flatnonzero(new)
        last = np.maximum.reduceat(order, starts)
        return keys[last], eidx[last], fidx[last]

    if np.asarray(elems_a).size == 0 or np.asarray(elems_b).size == 0:
        return []
    ka, ea, fa = face_keys(elems_a)
    kb, eb, fb = face_keys(elems_b)
    allk = np.concatenate([ka, kb])
    o = np.lexsort(allk.T[::-1])
    ks = allk[o]
    eq = np.flatnonzero((ks[1:] == ks[:-1]).all(axis=1))
    out = []
    for i in eq:
        ia, ib = sorted((o[i], o[i + 1]))     # per-set unique: one each
        out.append((int(ea[ia]), int(fa[ia]),
                    int(eb[ib - ka.shape[0]]), int(fb[ib - ka.shape[0]])))
    return out


def _match_orientation(cf: np.ndarray, cc: np.ndarray):
    """D4 (2D: Z2) transform sigma with cc[sigma(a, b)] == cf[a, b].

    Returns (swap, flip_a, flip_b) acting on face parametric coords:
    (u', v') = (v, u) if swap else (u, v); then negate per flip.
    In 2D the 'faces' are edges with a single parametric axis: cf/cc have
    shape (2,), sigma is (False, flip, False).
    """
    if cf.ndim == 1:
        for flip in (False, True):
            src = cc[::-1] if flip else cc
            if np.array_equal(cf, src):
                return (False, flip, False)
        raise ValueError("edge corners do not match")
    for swap in (False, True):
        for fa in (False, True):
            for fb in (False, True):
                ok = True
                for a in range(2):
                    for b in range(2):
                        aa, bb = (b, a) if swap else (a, b)
                        if fa:
                            aa = 1 - aa
                        if fb:
                            bb = 1 - bb
                        if cc[aa, bb] != cf[a, b]:
                            ok = False
                            break
                    if not ok:
                        break
                if ok:
                    return (swap, fa, fb)
    raise ValueError("face corners do not match under any orientation")


def slave_constraints(pairs, verts, glo_f, glo_c, n_f: int, n_c: int,
                      dim: int):
    """Interpolation constraints slaving fine face nodes to coarse faces.

    pairs: (ef, ff, ec, fc) from face_pairs, fine side first.
    glo_f / glo_c: (E, n^dim) global node ids of the fine-/coarse-order
    meshes. Returns (ids, cols, wts): for each slaved fine GLOBAL node id,
    the coarse GLOBAL node ids and Lagrange weights reproducing the coarse
    trace at the fine node (the Q rows of subdomain.tpp:1496-1582, with
    edge/face orientation resolved here on the host). Nodes shared by two
    slaved faces receive identical rows (1-D interpolation along the
    shared edge), so first-wins dedup is exact.
    """
    rf, _ = gll_points_weights(n_f)
    rc, _ = gll_points_weights(n_c)
    # per-axis Lagrange table for +u and -u evaluation points
    Lp = lagrange_eval(rc, rf)       # (n_f, n_c): l_q(rf_i)
    Lm = lagrange_eval(rc, -rf)      # l_q(-rf_i)

    out = {}
    nfd = dim - 1
    for ef, ff, ec, fc in pairs:
        cf = _face_corner_verts(verts[ef], ff, dim)
        cc = _face_corner_verts(verts[ec], fc, dim)
        swap, fa, fb = _match_orientation(cf, cc)
        fine_nodes = glo_f[ef][face_node_ids(n_f, dim, ff)]
        coarse_nodes = glo_c[ec][face_node_ids(n_c, dim, fc)]
        if nfd == 1:
            W = Lm if fa else Lp                       # (n_f, n_c)
            for i in range(n_f):
                gid = int(fine_nodes[i])
                if gid not in out:
                    out[gid] = (coarse_nodes, W[i])
        else:
            fine_nodes = fine_nodes.reshape(n_f, n_f)
            coarse_grid = coarse_nodes.reshape(n_c, n_c)
            Wa = Lm if fa else Lp                      # weights along alpha'
            Wb = Lm if fb else Lp
            for i in range(n_f):
                for j in range(n_f):
                    gid = int(fine_nodes[i, j])
                    if gid in out:
                        continue
                    # coarse param (s, t) of fine node (i, j)
                    ii, jj = (j, i) if swap else (i, j)
                    w = np.multiply.outer(Wa[ii], Wb[jj])  # (n_c, n_c)
                    out[gid] = (coarse_grid.reshape(-1), w.reshape(-1))
    if not out:
        z = np.zeros((0,), dtype=np.int64)
        return z, np.zeros((0, n_c ** nfd), dtype=np.int64), \
            np.zeros((0, n_c ** nfd))
    ids = np.fromiter(out.keys(), dtype=np.int64, count=len(out))
    cols = np.stack([out[g][0] for g in ids])
    wts = np.stack([np.asarray(out[g][1], dtype=np.float64) for g in ids])
    return ids, cols, wts
