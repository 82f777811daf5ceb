"""The port's unstructured-mesh host setup against the JAX package's, in
f64 on the same seeded inputs: scramble_mesh (coords, numbering and masks
bitwise, geometry to 1e-14), every mesh/graph.py function exactly, and
the smoothed-aggregation chain (amg/aggregation.py: patterns equal,
values to 1e-12)."""

import numpy as np
import pytest
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.amg import aggregation as jagg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import graph as jgr

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.amg import aggregation as tagg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import graph as tgr

from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def _pair(shape, N, seed, permute=True):
    jm = jg.scramble_mesh(jg.kershaw_mesh(shape, N, 0.3), seed=seed,
                          permute=permute)
    tm = tg.scramble_mesh(tg.kershaw_mesh(shape, N, 0.3, device="cpu"),
                          seed=seed, permute=permute, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def meshes():
    # orders 3 and 1 of one scrambled mesh (the composite's builder pair)
    return {o: _pair((3, 3, 4), o, 7) for o in (1, 3)}


@pytest.mark.parametrize("permute", [True, False])
def test_scramble_mesh_matches_reference(permute):
    jm, tm = _pair((3, 3, 4), 3, 5, permute)
    assert not tm.structured_layout
    for key in ("coords", "glo_num", "node_degree", "dirichlet_mask"):
        a, b = getattr(jm, key), getattr(tm, key)
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    for key in ("geom", "mass"):
        a, b = getattr(jm, key), getattr(tm, key)
        assert np.abs(a - b).max() <= 1e-14 * np.abs(a).max(), key


def test_rotation_tables_match_reference():
    for dim in (2, 3):
        rots = tg._proper_rotations(dim)
        assert rots == jg._proper_rotations(dim)
        assert len(rots) == (4 if dim == 2 else 24)
        for perm, flips in rots:
            for n in (2, 4):
                assert np.array_equal(
                    tg._rotation_node_perm(perm, flips, n, dim),
                    jg._rotation_node_perm(perm, flips, n, dim))


def test_graph_tables_match_reference():
    for dim in (2, 3):
        for n in (2, 3, 8):
            assert np.array_equal(tgr.corner_positions(n, dim),
                                  jgr.corner_positions(n, dim))
            for face in range(2 * dim):
                assert np.array_equal(tgr.face_node_ids(n, dim, face),
                                      jgr.face_node_ids(n, dim, face))
        assert np.array_equal(tgr._face_corner_table(dim),
                              jgr._face_corner_table(dim))


def test_adjacency_and_regions_match_reference(meshes):
    jm, tm = meshes[1]
    ja, ta = jgr.element_adjacency(jm.glo_num), \
        tgr.element_adjacency(tm.glo_num)
    assert (ja != ta).nnz == 0 and ja.shape == ta.shape
    own = np.arange(5, 12)
    for overlap in (1, 2):
        jr, jf = jgr.grow_regions(ja, own, 2, overlap=overlap)
        tr, tf = tgr.grow_regions(ta, own, 2, overlap=overlap)
        assert all(np.array_equal(a, b) for a, b in zip(jr, tr))
        assert np.array_equal(jf, tf)


def test_face_pairs_orientation_and_slaves_match_reference(meshes):
    (jm1, tm1), (jm3, tm3) = meshes[1], meshes[3]
    verts = tm1.glo_num
    a, b = np.arange(17), np.arange(17, 36)
    pairs = tgr.face_pairs(verts, a, b, 3)
    assert pairs == jgr.face_pairs(jm1.glo_num, a, b, 3)
    assert len(pairs) > 0
    # every pair's corner orientation, and the slaved nodes' rows
    seen = set()
    for ef, ff, ec, fc in pairs:
        cf = tgr._face_corner_verts(verts[ef], ff, 3)
        cc = tgr._face_corner_verts(verts[ec], fc, 3)
        seen.add(tgr._match_orientation(cf, cc))
        assert tgr._match_orientation(cf, cc) == \
            jgr._match_orientation(cf, cc)
    assert len(seen) > 1           # the scramble meets several orientations
    got = tgr.slave_constraints(pairs, verts, tm3.glo_num, tm1.glo_num, 4,
                                2, 3)
    want = jgr.slave_constraints(pairs, jm1.glo_num, jm3.glo_num,
                                 jm1.glo_num, 4, 2, 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # 2-D edges
    assert tgr._match_orientation(np.array([3, 5]), np.array([5, 3])) == \
        jgr._match_orientation(np.array([3, 5]), np.array([5, 3]))


def _same_csr(a, b, rtol=1e-12):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    assert a.shape == b.shape
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    scale = max(np.abs(a.data).max(initial=0.0), 1e-300)
    assert np.abs(a.data - b.data).max(initial=0.0) <= rtol * scale


def test_aggregation_chain_matches_reference():
    jm, tm = _pair((8, 8, 8), 1, 11)
    jA, jmask = jagg.q1_vertex_matrix(jm)
    tA, tmask = tagg.q1_vertex_matrix(tm)
    _same_csr(jA, tA)
    assert np.array_equal(jmask, tmask)
    ji = jagg.aggregation_chain(jA, jmask, max_coarse=10)
    ti = tagg.aggregation_chain(tA, tmask, max_coarse=10)
    assert len(ti["mats"]) == len(ji["mats"]) >= 3
    for a, b in zip(ji["mats"], ti["mats"]):
        _same_csr(a, b)
    for a, b in zip(ji["prolongs"], ti["prolongs"]):
        _same_csr(a, b)
    np.testing.assert_allclose(ti["lmaxs"], ji["lmaxs"], rtol=1e-12)
    np.testing.assert_allclose(ti["coarse_inv"], ji["coarse_inv"],
                               rtol=1e-12, atol=1e-12 * np.abs(
                                   ji["coarse_inv"]).max())
    # the far-field pieces: a subset's Q1 matrix and the superdomain basis
    far = np.arange(200, 512)
    jsub = jagg.q1_vertex_matrix_subset(jm, far)
    tsub = tagg.q1_vertex_matrix_subset(tm, far)
    _same_csr(jsub, tsub)
    nv = tsub.shape[0]
    keep = np.zeros(nv, dtype=bool)
    keep[tm.glo_num[far[:6]].ravel()] = True
    deep = ~keep & (tmask > 0.5)
    deep[np.setdiff1d(np.arange(nv), tm.glo_num[far].ravel())] = False
    jP, jf = jagg.superdomain_basis(jsub, keep, deep)
    tP, tf = tagg.superdomain_basis(tsub, keep, deep)
    _same_csr(jP, tP)
    assert np.array_equal(jf, tf)


def test_aggregation_chain_dense_levels_match_reference():
    # Kershaw 20^3 at order 1: the second level (1,537 rows, 5% full) forms
    # its Galerkin product densely (amg/aggregation._galerkin), the JAX
    # package's sparsely: the same pattern, the values within round-off
    jm = jg.kershaw_mesh((20, 20, 20), 1, epsilon=0.3)
    tm = tg.kershaw_mesh((20, 20, 20), 1, epsilon=0.3, device="cpu")
    jA, jmask = jagg.q1_vertex_matrix(jm)
    tA, tmask = tagg.q1_vertex_matrix(tm)
    ji = jagg.aggregation_chain(jA, jmask, max_coarse=10)
    ti = tagg.aggregation_chain(tA, tmask, max_coarse=10)
    assert any(m.shape[0] >= tagg._DENSE_MIN_ROWS
               and m.nnz >= tagg._DENSE_FILL * m.shape[0] ** 2
               for m in ti["mats"][:-1])
    assert len(ti["mats"]) == len(ji["mats"])
    for a, b in zip(ji["mats"], ti["mats"]):
        _same_csr(a, b)
    for a, b in zip(ji["prolongs"], ti["prolongs"]):
        _same_csr(a, b)
    np.testing.assert_allclose(ti["lmaxs"], ji["lmaxs"], rtol=1e-12)
    np.testing.assert_allclose(ti["coarse_inv"], ji["coarse_inv"],
                               rtol=1e-12, atol=1e-12 * np.abs(
                                   ji["coarse_inv"]).max())


def test_pack_level_chain_cycles_per_shard():
    # the packed chain (block-diagonal CSR over 3 shards) runs one V-cycle
    # per shard's right-hand side, each equal to a one-shard pack's
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.amg.vcycle import vcycle_apply
    _, tm = _pair((3, 3, 3), 1, 2)
    A, vmask = tagg.q1_vertex_matrix(tm)
    info = tagg.aggregation_chain(A, vmask, max_coarse=10)
    rng = np.random.default_rng(0)
    f = torch.as_tensor(rng.standard_normal((3, A.shape[0])))
    stacked = vcycle_apply(tagg.pack_level_chain(
        info, torch.float64, device="cpu", shards=3), f)
    one = tagg.pack_level_chain(info, torch.float64, device="cpu")
    for p in range(3):
        want = vcycle_apply(one, f[p:p + 1])
        assert torch.allclose(stacked[p:p + 1], want, rtol=1e-13,
                              atol=1e-13 * want.abs().max().item())
