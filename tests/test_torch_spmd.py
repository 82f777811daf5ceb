"""The port's SPMD fine problem (solvers/domain.Domain over P slab shards
through runtime/comm.LocalComm, plain twins on the CPU) against the JAX
package's shard_map Domain on the 8-device CPU mesh of tests/conftest.py,
in f64: 3-D twins of tests/test_spmd.py, tests/test_ragged.py's fine
solve and tests/test_dssum_paths.py's structured-against-generic cases,
and dry-run gate 1 (__graft_entry__.py). Both packages get the identical
mesh (GlobalMesh.from_numpy of the JAX mesh's arrays) and the same seeded
manufactured solution."""

from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import gather_scatter as tgs
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.comm import LocalComm
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import subdomain as tsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain


def port_mesh(m):
    return tg.GlobalMesh.from_numpy(
        coords=m.coords, geom=m.geom, dirichlet_mask=m.dirichlet_mask,
        node_degree=m.node_degree, elem_shape=m.elem_shape,
        poly_degree=m.poly_degree, mass=m.mass)


def jdomain(mesh, P, **kw):
    dm = jax.make_mesh((P,), ("shard",)) if P > 1 else None
    return JDomain(jpartition(mesh, P, **kw), dtype=jnp.float64,
                   device_mesh=dm)


def tdomain(mesh, P, **kw):
    return TDomain(tpartition(mesh, P, **kw), dtype=torch.float64,
                   device="cpu")


def to_global(dom, u):
    """A device field in global point order, padding dropped."""
    sd = dom.sharded
    u = dom.from_device_field(u).reshape(sd.num_shards, sd.elems_per_shard,
                                         -1)
    return np.concatenate([u[p][sd.elem_valid[p]]
                           for p in range(sd.num_shards)]).ravel()


def pack(dom, vals):
    """Global point values -> the domain's padded per-shard host layout
    -> its device field."""
    sd = dom.sharded
    npe = sd.num_points_per_elem
    buf = np.zeros((sd.num_shards, sd.elems_per_shard, npe))
    k = 0
    for p in range(sd.num_shards):
        ne = int(sd.elem_valid[p].sum())
        buf[p, :ne] = vals[k:k + ne * npe].reshape(ne, npe)
        k += ne * npe
    return dom.to_device_field(buf.reshape(sd.num_shards, -1))


def history(res):
    return np.asarray(res.residual_history)


@pytest.fixture(scope="module")
def kershaw338():
    """Kershaw (3, 3, 8) N=3: the port at P = 1 and 8, the JAX package at
    P = 8 (the 3-D stand-in for test_spmd.py's 2-D (4, 4) mesh)."""
    jm = jg.kershaw_mesh((3, 3, 8), 3, 0.3)
    tm = port_mesh(jm)
    return jdomain(jm, 8), tdomain(tm, 1), tdomain(tm, 8)


# FGMRES(20) needs 596 iterations on this mesh to 1e-10
@pytest.mark.parametrize("method,max_it", [("fcg", 400), ("fgmres", 800)])
def test_spmd_matches_single_device(kershaw338, method, max_it):
    jd8, td1, td8 = kershaw338
    results = []
    for dom in (td1, td8, jd8):
        u_star = dom.initial_function(4, seed=7)
        f = dom.manufacture_rhs(u_star)
        res = dom.solver(method=method, max_iterations=max_it,
                         tolerance=1e-10)(f)
        assert bool(res.converged)
        results.append((dom, res))
    (_, r1), (_, r8), (_, rj) = results
    n1, n8, nj = r1.iterations, r8.iterations, int(rj.iterations)
    # the original's bound between shard counts (a psum of 8 partials
    # against one serial sum moves the last step by one) and between the
    # packages at P = 8
    assert abs(n1 - n8) <= 1 and abs(n8 - nj) <= 1, (n1, n8, nj)
    k = min(n1, n8, nj, 10)
    np.testing.assert_allclose(history(r8)[:k], history(r1)[:k], rtol=1e-9)
    np.testing.assert_allclose(history(r8)[:k], history(rj)[:k], rtol=1e-9)
    g1, g8, gj = (to_global(d, r.u) for d, r in results)
    scale = np.abs(g1).max()
    np.testing.assert_allclose(g8, g1, atol=1e-7 * scale)
    np.testing.assert_allclose(g8, gj, atol=1e-7 * scale)


def test_spmd_initial_function_consistent(kershaw338):
    jd8, td1, td8 = kershaw338
    u1 = to_global(td1, td1.initial_function(4, seed=7))
    u8 = to_global(td8, td8.initial_function(4, seed=7))
    uj = to_global(jd8, jd8.initial_function(4, seed=7))
    np.testing.assert_allclose(u8, u1, atol=1e-12)
    np.testing.assert_allclose(u8, uj, atol=1e-12)


def test_spmd_dssum_weight_partition_invariant():
    # box (2, 2, 2) N=2 over 8 shards: six of them hold padding only
    jm = jg.box_mesh((2, 2, 2), 2)
    tm = port_mesh(jm)
    vals = np.random.default_rng(3).random(jm.num_points)
    w = [to_global(d, d.dssum_field(pack(d, vals), apply_weight=True))
         for d in (tdomain(tm, 1), tdomain(tm, 8), jdomain(jm, 8))]
    np.testing.assert_allclose(w[1], w[0], atol=1e-13)
    np.testing.assert_allclose(w[1], w[2], atol=1e-13)


@pytest.mark.parametrize("method", ["fgmres", "fcg"])
@pytest.mark.parametrize("Pn", [4, 5])
def test_overlap_fused_operator_matches(method, Pn):
    # twin of tests/test_spmd.py::test_overlap_fused_operator_matches: the
    # fused operator + dssum against operator then dssum, on a uniform
    # (P = 4, slabs of 3) and a ragged (P = 5 on 12 layers) partition,
    # and the port's fused route against the JAX package's
    jm = jg.box_mesh((2, 2, 12), 3, extent=(1.0, 1.0, 6.0))
    td = tdomain(port_mesh(jm), Pn)
    jd = jdomain(jm, Pn)
    assert td.ragged == (Pn == 5) == jd.ragged
    assert td._ops()[0].fused_dssum is not None
    kw = dict(method=method, max_iterations=250, tolerance=1e-8)
    u_star = td.initial_function(4, seed=2)
    f = td.manufacture_rhs(u_star)
    r_ov = td.solver(overlap=True, **kw)(f)
    r_sq = td.solver(overlap=False, **kw)(f)
    uj = jd.initial_function(4, seed=2)
    r_j = jd.solver(overlap=True, **kw)(jd.manufacture_rhs(uj))
    assert abs(r_ov.iterations - r_sq.iterations) <= 1
    assert abs(r_ov.iterations - int(r_j.iterations)) <= 1
    # fgmres: the same arithmetic; fcg: the carried assembled residual
    # drifts by round-off only (the original's bounds)
    rtol = 1e-9 if method == "fgmres" else 1e-6
    h_ov, h_sq, h_j = history(r_ov), history(r_sq), history(r_j)
    k = min(np.isfinite(h_ov).sum(), np.isfinite(h_sq).sum())
    np.testing.assert_allclose(h_ov[:k], h_sq[:k], rtol=rtol)
    k = min(np.isfinite(h_ov).sum(), np.isfinite(h_j).sum())
    np.testing.assert_allclose(h_ov[:k], h_j[:k], rtol=rtol)


@pytest.mark.parametrize("P", [3, 5])
def test_ragged_fine_solve_matches_single_device(P):
    # 3-D twin of tests/test_ragged.py: 7 layers over 3 / 5 shards (slabs
    # 3, 2, 2 / 2, 2, 1, 1, 1), the fused ragged route
    jm = jg.kershaw_mesh((3, 3, 7), 3, 0.3)
    tm = port_mesh(jm)
    out = []
    for dom in (tdomain(tm, 1), tdomain(tm, P), jdomain(jm, P)):
        u = dom.initial_function(4, seed=7)
        res = dom.solver(method="fcg", max_iterations=400,
                         tolerance=1e-10)(dom.manufacture_rhs(u))
        assert bool(res.converged)
        out.append((dom, res))
    (d1, r1), (dP, rP), (_, rj) = out
    assert dP.sharded.structured.ragged and dP._top is not None
    assert abs(r1.iterations - rP.iterations) <= 1
    assert abs(rP.iterations - int(rj.iterations)) <= 1
    k = min(r1.iterations, rP.iterations, 10)
    np.testing.assert_allclose(history(rP)[:k], history(r1)[:k], rtol=1e-9)
    np.testing.assert_allclose(history(rP)[:k], history(rj)[:k], rtol=1e-9)
    g1, gP = to_global(d1, r1.u), to_global(dP, rP.u)
    np.testing.assert_allclose(gP, g1, atol=1e-7 * np.abs(g1).max())


@pytest.mark.parametrize("kw", [dict(), dict(apply_weight=True),
                                dict(apply_mask=False)])
@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("shape,N", [((2, 3, 4), 2), ((3, 3, 3), 3)])
def test_structured_matches_generic(shape, N, P, kw):
    # twins of the 3-D cases of tests/test_dssum_paths.py: the structured
    # Domain's dssum (batched face sum + slab exchange) against the
    # generic gather/scatter dssum of ops/gather_scatter on the generic
    # partition's plan (one psum of the interface vector), and against
    # the JAX package's Domain.dssum_field
    jm = jg.box_mesh(shape, N)
    tm = port_mesh(jm)
    vals = np.random.default_rng(0).random(jm.num_points)
    td = tdomain(tm, P)
    got = to_global(td, td.dssum_field(pack(td, vals), **kw))
    sg = tpartition(tm, P, structured=False)
    assert sg.structured is None
    npe = sg.num_points_per_elem
    buf = np.zeros((P, sg.elems_per_shard * npe))
    k = 0
    for p in range(P):
        m = int(sg.elem_valid[p].sum()) * npe
        buf[p, :m] = vals[k:k + m]
        k += m
    t = lambda a, dt=torch.float64: torch.as_tensor(np.asarray(a), dtype=dt)
    gen = tgs.dssum(t(buf), gather_ids=t(sg.gather_ids, torch.int64),
                    mask=t(sg.dirichlet_mask), inv_degree=t(sg.inv_degree),
                    bnode_local=t(sg.bnode_local, torch.int64),
                    bnode_global=t(sg.bnode_global, torch.int64),
                    num_local_nodes=sg.num_local_nodes,
                    num_boundary_global=sg.num_boundary_global,
                    comm=LocalComm(P) if P > 1 else None,
                    plans=tgs.generic_plans(sg.gather_ids, sg.bnode_global,
                                            sg.num_local_nodes,
                                            sg.num_boundary_global, "cpu"),
                    **kw).numpy()
    gen = np.concatenate([gen[p, :int(sg.elem_valid[p].sum()) * npe]
                          for p in range(P)])
    jd = jdomain(jm, P)
    ref = to_global(jd, jd.dssum_field(pack(jd, vals), **kw))
    np.testing.assert_allclose(got, gen, atol=1e-13)
    np.testing.assert_allclose(got, ref, atol=1e-13)


def test_fused_route_matches_reference():
    # FCG's numbers depend on whether the Domain has a fused operator +
    # dssum: the port builds one exactly where the JAX package does (SPMD,
    # and ragged or slabs of at least 3 layers)
    for shape, P in [((2, 2, 8), 1), ((2, 2, 8), 4), ((2, 2, 12), 4),
                     ((2, 2, 7), 3), ((2, 2, 2), 8)]:
        jm = jg.box_mesh(shape, 2)
        jd, td = jdomain(jm, P), tdomain(port_mesh(jm), P)
        want = jd._ops(jd.arrays)[0].fused_dssum is not None
        assert (td._ops()[0].fused_dssum is not None) == want, (shape, P)


def test_gate1_dry_run():
    # dry-run gate 1 (__graft_entry__.py) at 8 shards: Kershaw (2, 2, 17)
    # N=3 with isotropic elements, slabs 3, 2, ..., 2 (ragged, fused
    # route), unpreconditioned f64 FCG to 1e-6; the port's count within
    # the gate's window of the JAX package's, histories at the gate's
    # rtol 1e-6 over 12 steps (and of the port's one-shard solve)
    mk = partial(jg.kershaw_mesh, (2, 2, 17), epsilon=0.3,
                 extent=(1.0, 1.0, 8.5))
    jm = mk(3)
    tm = port_mesh(jm)
    runs = []
    for dom in (jdomain(jm, 8), tdomain(tm, 8), tdomain(tm, 1)):
        u = dom.initial_function(4, seed=0)
        res = dom.solver(method="fcg", max_iterations=800,
                         tolerance=1e-6)(dom.manufacture_rhs(u))
        assert bool(res.converged)
        h = history(res)
        runs.append((int(res.iterations), h[np.isfinite(h)]))
    (ij, hj), (i8, h8), (i1, h1) = runs
    assert abs(i8 - ij) <= max(3, ij // 20), (i8, ij)
    assert abs(i8 - i1) <= max(3, i1 // 20), (i8, i1)
    np.testing.assert_allclose(h8[:12], hj[:12], rtol=1e-6)
    np.testing.assert_allclose(h8[:12], h1[:12], rtol=1e-6)
    w = min(40, h1.size, h8.size, hj.size)
    np.testing.assert_allclose(h8[:w], hj[:w], rtol=1e-4)


@pytest.mark.parametrize("P", [4, 5])
def test_one_kernel_call_per_apply_whatever_the_shard_count(P):
    # the stacked shard axis: K1 and K2 are called once per operator apply
    # and per dssum however many shards there are (on the CPU their plain
    # twins count the calls), so a sharded solve makes as many calls per
    # iteration as the one-shard solve
    jm = jg.box_mesh((2, 2, 12), 3, extent=(1.0, 1.0, 6.0))
    tm = port_mesh(jm)
    per_it = []
    for nshards in (1, P):
        dom = tdomain(tm, nshards)
        f = dom.manufacture_rhs(dom.initial_function(4, seed=2))
        kernels.reset_counts()
        res = dom.solver(method="fgmres", max_iterations=30,
                         tolerance=1e-12)(f)
        c = kernels.counts()
        per_it.append((c["stiffness_lattice_3d_plain"]["float64"],
                       c["lattice_face_sum_3d_plain"]["float64"],
                       res.iterations))
    assert per_it[0] == per_it[1], per_it


def test_refusals_name_their_roadmap_items():
    mesh = tg.box_mesh((2, 2, 4), 2, device="cpu")
    with pytest.raises(ValueError, match="comm"):
        TDomain(tpartition(mesh, 2), dtype=torch.float64, device="cpu",
                comm=LocalComm(4))
    # a structured=False partition builds (item 13a), and so does its
    # composite's fem-amg inner (item 13b)
    domu = TDomain(tpartition(mesh, 2, structured=False),
                   dtype=torch.float64, device="cpu")
    mku = partial(tg.box_mesh, (2, 2, 4), device="cpu")
    preu = tsub.composite_dd(domu, mku, poly_reduction=1, inner="fem-amg",
                             fine_mesh=mesh)
    resu = domu.solver(method="fgmres", max_iterations=60, tolerance=1e-8,
                       precond=preu)(
        domu.manufacture_rhs(domu.initial_function(4, seed=0)))
    assert bool(resu.converged), resu.residual_history
    # the composite at P > 1 (item 10b) builds and converges: two slabs
    # of 4 layers
    mk = partial(tg.box_mesh, (2, 2, 8), device="cpu")
    dom = TDomain(tpartition(mk(2), 2), dtype=torch.float64, device="cpu")
    pre = tsub.composite_dd(dom, mk, poly_reduction=1)
    f = dom.manufacture_rhs(dom.initial_function(4, seed=0))
    res = dom.solver(method="fgmres", max_iterations=60, tolerance=1e-8,
                     precond=pre)(f)
    assert bool(res.converged), res.residual_history
