"""The port's unstructured fine problem against the JAX package's, in f64:
the element-layout operator and transfers (ops/sem.py, ops/interp.py) to
1e-13, the face plan (ops/face_dssum.build_face_plan) array for array,
and the face-block dssum of the Domain bitwise at P = 1 (and equal to the
numpy ground truth and to the generic scatter dssum) and to 1e-14 at
P = 4, the bounds of tests/test_face_dssum.py."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.pebble import pebble_mesh as jpebble
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops import face_dssum as jfd
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops import interp as ji
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops import sem as js
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.pebble import pebble_mesh as tpebble
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import face_dssum as tfd
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import gather_scatter as gs
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import interp as ti
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import sem as ts
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain, shard_face_plans
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.utils.gll import diff_matrix, interp_matrix

from composite_twins import one_torch_thread  # noqa: F401 (autouse)

MESHES = {
    # tests/test_face_dssum.py's meshes
    "scrambled": (lambda: jg.scramble_mesh(jg.kershaw_mesh((3, 3, 4), 3, 0.3),
                                           seed=5),
                  lambda: tg.scramble_mesh(tg.kershaw_mesh(
                      (3, 3, 4), 3, 0.3, device="cpu"), seed=5,
                      device="cpu")),
    "scrambled-local": (lambda: jg.scramble_mesh(
        jg.kershaw_mesh((3, 3, 4), 2, 0.3), seed=5, permute=False),
        lambda: tg.scramble_mesh(tg.kershaw_mesh(
            (3, 3, 4), 2, 0.3, device="cpu"), seed=5, permute=False,
            device="cpu")),
    "pebble": (lambda: jpebble((8, 8, 8), 2, num_pebbles=4, seed=2),
               lambda: tpebble((8, 8, 8), 2, num_pebbles=4, seed=2,
                               device="cpu")),
}


@pytest.fixture(scope="module")
def meshes():
    return {k: (a(), b()) for k, (a, b) in MESHES.items()}


def _factors(geom):
    return tuple(torch.as_tensor(np.ascontiguousarray(geom[..., k]))
                 for k in range(6))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_element_operator_and_transfers_match_reference(n):
    rng = np.random.default_rng(n)
    E = 6
    u = rng.standard_normal((E, n ** 3))
    g = rng.standard_normal((E, n ** 3, 6))
    D = diff_matrix(n)
    want = np.asarray(js.stiffness_apply(jnp.asarray(u), jnp.asarray(g),
                                         jnp.asarray(D), 3))
    got = ts.stiffness_apply(torch.as_tensor(u), _factors(g),
                             torch.as_tensor(D), 3).numpy()
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    # a (P, E, npe) stack is P element stacks
    got2 = ts.stiffness_apply(torch.as_tensor(u).view(2, 3, -1),
                              tuple(x.view(2, 3, -1) for x in _factors(g)),
                              torch.as_tensor(D), 3).numpy().reshape(E, -1)
    assert np.array_equal(got2, got)
    want = np.asarray(js.stiffness_diagonal(jnp.asarray(g), jnp.asarray(D),
                                            3))
    got = ts.stiffness_diagonal(_factors(g), torch.as_tensor(D), 3).numpy()
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    for nc in (2, 3):
        J = interp_matrix(nc, n)
        want = np.asarray(ji.restrict(jnp.asarray(u), jnp.asarray(J), 3))
        got = ti.restrict(torch.as_tensor(u), torch.as_tensor(J), 3).numpy()
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
        uc = rng.standard_normal((E, nc ** 3))
        want = np.asarray(ji.prolongate(jnp.asarray(uc), jnp.asarray(J), 3))
        got = ti.prolongate(torch.as_tensor(uc), torch.as_tensor(J),
                            3).numpy()
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def test_bf16_element_operator_accumulates_in_f32():
    # bf16 fields are contracted in f32 and rounded once, as the lattice
    # kernel does (the JAX package's CPU path contracts in bf16)
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.standard_normal((5, 512))).to(torch.bfloat16)
    G = tuple(x.to(torch.bfloat16)
              for x in _factors(rng.standard_normal((5, 512, 6))))
    D = torch.as_tensor(diff_matrix(8))
    got = ts.stiffness_apply(u, G, D.to(torch.bfloat16), 3)
    want = ts.stiffness_apply(u.float(), tuple(g.float() for g in G),
                              D.float(), 3).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    got = ts.stiffness_diagonal(G, D.to(torch.bfloat16), 3)
    want = ts.stiffness_diagonal(tuple(g.float() for g in G), D.float(),
                                 3).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_dihedral_tables_match_reference():
    for n in range(2, 9):
        assert np.array_equal(tfd._dihedral_table(n), jfd._dihedral_table(n))


@pytest.mark.parametrize("name", ["scrambled", "pebble"])
def test_face_plan_matches_reference(meshes, name):
    # the port's plan sends edge nodes down the rest path: it is the JAX
    # package's plan without the edge-group pass, array for array
    jm, tm = meshes[name]
    n = tm.poly_degree + 1
    deg = tm.node_degree.astype(np.int64)
    jp, jmeta = jfd.build_face_plan(jm.glo_num, n, deg, use_edges=False)
    tp, tmeta = tfd.build_face_plan(tm.glo_num, n, deg)
    edge_keys = {"egid", "eflip", "emask", "emembers", "eM"}
    assert sorted(set(jp) - edge_keys) == sorted(tp)
    assert jmeta["num_edge_groups"] == 0
    for key in tp:
        assert jp[key].dtype == tp[key].dtype, key
        assert np.array_equal(jp[key], tp[key]), key
    assert jmeta["num_rest_nodes"] == tmeta["num_rest_nodes"]
    assert np.array_equal(jmeta["rest_nodes"], tmeta["rest_nodes"])
    if name == "scrambled":
        # the scramble meets every one of the 8 dihedral orientations
        assert all(tp["cls_dst%d" % t].size for t in range(8))


@pytest.mark.parametrize("name,Pn", [("scrambled", 1), ("pebble", 1),
                                     ("scrambled-local", 4), ("pebble", 4)])
def test_lowered_plan_covers_every_copy_once(meshes, name, Pn):
    # the lowered index arrays against the partition's own node ids: a
    # face partner is another copy of a degree-2 node; every other copy
    # of a shared node is a copy of exactly one rest node, whose copies
    # are all of one node's copies on that shard; interface rest nodes
    # carry the partition's interface ids
    _, tm = meshes[name]
    sd = tpartition(tm, Pn, structured=False)
    n = sd.poly_degree + 1
    low = tfd.lower_plans(shard_face_plans(sd), n, sd.elems_per_shard)
    glo = np.stack([g.reshape(-1) for g in sd.glo_num])       # (P, T/P)
    shard = np.repeat(np.arange(Pn), glo.shape[1])
    glo = glo.reshape(-1)
    ivd = sd.inv_degree_pts.reshape(-1)
    T = glo.size
    pair = np.flatnonzero(low["partner"] < T)
    q = low["partner"][pair]
    assert np.array_equal(glo[q], glo[pair]) and (q != pair).all()
    assert np.array_equal(shard[q], shard[pair])
    assert np.allclose(ivd[pair], 0.5)
    assert np.array_equal(low["partner"][q], pair)
    rest = low["node"] >= 0
    assert not (rest[pair]).any()
    shared = (glo >= 0) & (ivd > 0) & (ivd < 0.75)
    assert np.array_equal(shared, rest | (low["partner"] < T))
    # the rest nodes and the (shard, global id) pairs label the same sets
    # of points
    key = shard * (glo.max() + 1) + glo
    pairs = np.unique(np.stack([low["node"][rest], key[rest]]), axis=1)
    assert pairs.shape[1] == np.unique(key[rest]).size == low["num_nodes"] \
        == np.unique(low["node"][rest]).size
    if Pn > 1:
        assert low["iface_node"].size
        for k in range(Pn):
            uniq = np.unique(sd.glo_num[k][sd.glo_num[k] >= 0])
            real = sd.bnode_local[k] < uniq.size
            ids = dict(zip(uniq[sd.bnode_local[k][real]],
                           sd.bnode_global[k][real]))
            sel = low["iface_shard"] == k
            assert sorted(low["iface_global"][sel]) == sorted(ids.values())
            pts = [np.flatnonzero(low["node"] == m)[0]
                   for m in low["iface_node"][sel]]
            assert [ids[g] for g in glo[pts]] == \
                low["iface_global"][sel].tolist()


def _node_sums(mesh, vals):
    glo = mesh.glo_num.reshape(-1)
    return np.bincount(glo, weights=vals, minlength=mesh.num_nodes)[glo]


def _host_field(sd, vals):
    npe = sd.num_points_per_elem
    out = np.zeros((sd.num_shards, sd.elems_per_shard * npe))
    for p in range(sd.num_shards):
        lo, hi = sd.elem_offsets[p], sd.elem_offsets[p + 1]
        out[p, :(hi - lo) * npe] = vals[lo * npe:hi * npe]
    return out


@pytest.mark.parametrize("name,Pn", [("scrambled", 1), ("pebble", 1),
                                     ("scrambled-local", 4), ("pebble", 4)])
def test_face_dssum_matches_reference(meshes, name, Pn):
    jm, tm = meshes[name]
    rng = np.random.default_rng(3)
    vals = rng.random(tm.num_points)
    expected = _node_sums(tm, vals)
    dm = jax.make_mesh((Pn,), ("shard",)) if Pn > 1 else None
    jd = JDomain(jpartition(jm, Pn, structured=False), dtype=jnp.float64,
                 device_mesh=dm)
    td = TDomain(tpartition(tm, Pn, structured=False), dtype=torch.float64,
                 device="cpu")
    sd = td.sharded
    host = _host_field(sd, vals)
    got = td.from_device_field(td.dssum_field(td.to_device_field(host),
                                              apply_mask=False))
    ref = np.asarray(jd.from_device_field(jd.dssum_field(
        jd.to_device_field(host), apply_mask=False))).reshape(Pn, -1)
    npe = sd.num_points_per_elem
    for p in range(Pn):
        lo, hi = sd.elem_offsets[p], sd.elem_offsets[p + 1]
        g, r = got[p, :(hi - lo) * npe], ref[p, :(hi - lo) * npe]
        e = expected[lo * npe:hi * npe]
        if Pn == 1:
            assert np.array_equal(g, r) and np.array_equal(g, e)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-14, atol=1e-15)
            np.testing.assert_allclose(g, e, rtol=1e-14, atol=1e-15)


def test_face_dssum_weight_mask_match_scatter(meshes):
    # mask and weight variants equal the generic scatter dssum (in
    # ascending point order on the CPU) bit for bit
    _, tm = meshes["scrambled"]
    td = TDomain(tpartition(tm, 1, structured=False), dtype=torch.float64,
                 device="cpu")
    sd = td.sharded
    rng = np.random.default_rng(0)
    vals = rng.random(tm.num_points)
    u = td.to_device_field(vals)
    t = lambda x: torch.as_tensor(np.asarray(x))
    for am in (False, True):
        for aw in (False, True):
            got = td.dssum_field(u, apply_mask=am, apply_weight=aw)
            ref = gs.dssum(
                u[None], gather_ids=t(sd.gather_ids).long(),
                mask=t(sd.dirichlet_mask), inv_degree=t(sd.inv_degree),
                bnode_local=t(sd.bnode_local).long(),
                bnode_global=t(sd.bnode_global).long(),
                num_local_nodes=sd.num_local_nodes,
                num_boundary_global=sd.num_boundary_global, comm=None,
                apply_mask=am, apply_weight=aw)[0]
            assert torch.equal(got, ref), (am, aw)


def test_unstructured_domain_solve_matches_reference(meshes):
    # the fine problem whole: u*, f = A u* and an unpreconditioned FCG
    # solve over 4 shards; the histories agree to ~1e-12 over 20 steps
    jm, tm = meshes["scrambled-local"]
    jd = JDomain(jpartition(jm, 4), dtype=jnp.float64,
                 device_mesh=jax.make_mesh((4,), ("shard",)))
    td = TDomain(tpartition(tm, 4), dtype=torch.float64, device="cpu")
    ju, tu = jd.initial_function(4, seed=3), td.initial_function(4, seed=3)
    assert np.array_equal(np.asarray(jd.from_device_field(ju)),
                          td.from_device_field(tu))
    jf, tf = jd.manufacture_rhs(ju), td.manufacture_rhs(tu)
    a = np.asarray(jd.from_device_field(jf))
    assert np.abs(td.from_device_field(tf) - a).max() <= 1e-13 * \
        np.abs(a).max()
    rj = jd.solver(method="fcg", max_iterations=300, tolerance=1e-9)(jf)
    rt = td.solver(method="fcg", max_iterations=300, tolerance=1e-9)(tf)
    assert abs(int(rj.iterations) - rt.iterations) <= 1
    np.testing.assert_allclose(rt.residual_history.numpy()[:21],
                               np.asarray(rj.residual_history)[:21],
                               rtol=1e-9)


def test_jacobi_on_unstructured_domain_matches_reference(meshes):
    # solvers/preconditioners.jacobi on the element layout: the assembled
    # diagonal by the face dssum; FCG histories to rtol 1e-9 over 30 steps
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import preconditioners as jpc
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import preconditioners as tpc
    jm, tm = meshes["scrambled"]
    jd = JDomain(jpartition(jm, 1), dtype=jnp.float64)
    td = TDomain(tpartition(tm, 1), dtype=torch.float64, device="cpu")
    jf = jd.manufacture_rhs(jd.initial_function(4, seed=3))
    tf = td.manufacture_rhs(td.initial_function(4, seed=3))
    rj = jd.solver(method="fcg", max_iterations=300, tolerance=1e-9,
                   precond=jpc.jacobi(jd))(jf)
    rt = td.solver(method="fcg", max_iterations=300, tolerance=1e-9,
                   precond=tpc.jacobi(td))(tf)
    assert abs(int(rj.iterations) - rt.iterations) <= 1
    np.testing.assert_allclose(rt.residual_history.numpy()[:31],
                               np.asarray(rj.residual_history)[:31],
                               rtol=1e-9)
