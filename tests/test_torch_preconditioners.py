"""PyTorch port of the Jacobi and p-multigrid preconditioners
(solvers/preconditioners.py) vs the JAX package on the CPU, in f64: 3-D
twins of tests/test_preconditioners.py and tests/test_pmultigrid.py, on
one shard and on P slab shards (the JAX package's shard_map Domain on the
8-device CPU mesh of tests/conftest.py, the port's LocalComm). Both
packages get the identical problem: the JAX meshes of every level go
across with GlobalMesh.from_numpy."""

from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import preconditioners as jpre
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.refine import refine_solve as jrefine
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import preconditioners as tpre
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.refine import refine_solve as trefine

from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def _port_mesh(m):
    return tg.GlobalMesh.from_numpy(
        coords=m.coords, geom=m.geom, dirichlet_mask=m.dirichlet_mask,
        node_degree=m.node_degree, elem_shape=m.elem_shape,
        poly_degree=m.poly_degree, mass=m.mass)


def _pair(shape, N):
    """The same Kershaw problem in both packages, and mesh builders that
    give both the same level meshes."""
    jb = partial(jg.kershaw_mesh, shape, epsilon=0.3)
    jm = jb(N)
    jd = JDomain(jpartition(jm, 1), dtype=jnp.float64)
    td = TDomain(tpartition(_port_mesh(jm), 1), dtype=torch.float64,
                 device="cpu")
    return jd, td, jb, lambda N_c: _port_mesh(jb(N_c))


def _apply_both(jd, td, jp, tp, seed):
    """One application of both preconditioners to a seeded non-assembled
    residual (the JAX closure runs eagerly on the single device)."""
    r = np.random.default_rng(seed).standard_normal(td.lattice_shape)
    zj = jp.build(jd.arrays, jp.extra, jd._ops(jd.arrays))(jnp.asarray(r))
    zt = tp.build(td.arrays, tp.extra, td._ops())(torch.as_tensor(r))
    return np.asarray(zj), zt.numpy()


@pytest.fixture(scope="module")
def problem4():
    jd, td, jb, tb = _pair((4, 4, 4), 5)
    u = jd.initial_function(4, seed=1)
    return jd, td, jb, tb, u, jd.manufacture_rhs(u)


@pytest.mark.parametrize("shape,N,r", [((3, 3, 3), 5, 4), ((4, 4, 4), 5, 2)])
def test_vcycle_matches_reference(shape, N, r):
    jd, td, jb, tb = _pair(shape, N)
    jp = jpre.pmultigrid(jd, jb, poly_reduction=r)
    tp = tpre.pmultigrid(td, tb, poly_reduction=r)
    assert len(tp.extra["levels"]) == len(jp.extra["levels"])
    for lj, lt in zip(jp.extra["levels"], tp.extra["levels"]):
        assert np.array_equal(
            np.asarray(lj["mask"]).reshape(lt["mask"].shape),
            lt["mask"].numpy())
    zj, zt = _apply_both(jd, td, jp, tp, seed=7)
    assert np.abs(zt - zj).max() <= 1e-11 * np.abs(zj).max()
    # a zero residual (the coarse CG's breakdown guards): zero in both
    zero = np.zeros(td.lattice_shape)
    zj0 = jp.build(jd.arrays, jp.extra, jd._ops(jd.arrays))(jnp.asarray(zero))
    zt0 = tp.build(td.arrays, tp.extra, td._ops())(torch.as_tensor(zero))
    assert np.array_equal(np.asarray(zj0), zero)
    assert np.array_equal(zt0.numpy(), zero)


def test_jacobi_apply_matches_reference(problem4):
    jd, td, _, _, _, _ = problem4
    zj, zt = _apply_both(jd, td, jpre.jacobi(jd), tpre.jacobi(td), seed=8)
    assert np.abs(zt - zj).max() <= 1e-12 * np.abs(zj).max()


# Jacobi-CG amplifies the 1e-16 operator round-off until the histories
# part at rtol 1e-9 (step 88 here) and differ by 0.1 when 1e-9 is reached,
# too much for the step at which a threshold is crossed to be the same on
# every machine: it runs to 1e-6 (94 steps, histories then within 2e-8)
# and 60 steps are compared. p-multigrid converges first, so it runs to
# 1e-9 and its whole history is compared.
@pytest.mark.parametrize("which,tol,steps,max_err", [
    ("jacobi", 1e-6, 60, 1e-4), ("pmultigrid", 1e-9, None, 1e-6)])
def test_fcg_history_matches_reference(problem4, which, tol, steps, max_err):
    jd, td, jb, tb, u, f = problem4
    if which == "jacobi":
        jp, tp = jpre.jacobi(jd), tpre.jacobi(td)
    else:
        jp = jpre.pmultigrid(jd, jb, poly_reduction=2)
        tp = tpre.pmultigrid(td, tb, poly_reduction=2)
    rj = jd.solver(method="fcg", max_iterations=400, tolerance=tol,
                   precond=jp)(f)
    rt = td.solver(method="fcg", max_iterations=400, tolerance=tol,
                   precond=tp)(torch.as_tensor(np.array(f)))
    assert bool(rt.converged) and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    k = rt.iterations + 1 if steps is None else steps + 1
    assert np.allclose(rt.residual_history.numpy()[:k],
                       np.asarray(rj.residual_history)[:k],
                       rtol=1e-9, atol=0.0)
    assert np.abs(rt.u.numpy() - np.asarray(u)).max() < max_err


def test_pmg_beats_jacobi(problem4):
    # the criterion of tests/test_pmultigrid.py::test_pmg_beats_jacobi
    _, td, _, tb, u, f = problem4
    ft = torch.as_tensor(np.array(f))
    kernels.reset_counts()
    res_pmg = td.solver(method="fcg", max_iterations=400, tolerance=1e-9,
                        precond=tpre.pmultigrid(td, tb, poly_reduction=2))(ft)
    c = kernels.counts()
    res_jac = td.solver(method="fcg", max_iterations=400, tolerance=1e-9,
                        precond=tpre.jacobi(td))(ft)
    assert bool(res_pmg.converged)
    assert res_pmg.iterations < res_jac.iterations // 2, (
        res_pmg.iterations, res_jac.iterations)
    assert np.abs(res_pmg.u.numpy() - np.asarray(u)).max() < 1e-6
    # orders 5, 3, 1: per outer iteration 1 + 2 + 2 + 8 operator applies,
    # all through K1's wrapper (its plain twin on the CPU), none a kernel
    applies = c["stiffness_lattice_3d_plain"]["float64"]
    assert applies >= 13 * res_pmg.iterations
    assert c["stiffness_lattice_3d"] == {} and c["lattice_face_sum_3d"] == {}


def test_smoother_damping_matches_reference_and_matters_at_order_7():
    # damped Jacobi needs omega * lambda_max(D^-1 A) < 2. On 3-D Kershaw
    # meshes at N = 7 lambda_max is about 3.5, so the default 2/3 amplifies
    # the top modes and the V-cycle is worse than Jacobi alone (in the JAX
    # package alike: it is the same cycle to 1e-11, see above); with
    # omega = 0.5, passed through as in the JAX package, p-multigrid
    # beats Jacobi by 2x
    jd, td, jb, tb = _pair((3, 3, 3), 7)
    u = jd.initial_function(4, seed=0)
    f = jd.manufacture_rhs(u)
    ft = torch.as_tensor(np.array(f))
    jp = jpre.pmultigrid(jd, jb, poly_reduction=2, smooth_damping=0.5)
    tp = tpre.pmultigrid(td, tb, poly_reduction=2, smooth_damping=0.5)
    kw = dict(method="fcg", max_iterations=400, tolerance=1e-4)
    rj = jd.solver(precond=jp, **kw)(f)
    rt = td.solver(precond=tp, **kw)(ft)
    assert bool(rt.converged) and rt.iterations == int(rj.iterations)
    assert np.allclose(rt.residual_history.numpy()[:10],
                       np.asarray(rj.residual_history)[:10],
                       rtol=1e-9, atol=0.0)
    default = td.solver(precond=tpre.pmultigrid(td, tb, poly_reduction=2),
                        **kw)(ft)
    jac = td.solver(precond=tpre.jacobi(td), **kw)(ft)
    assert bool(default.converged) and bool(jac.converged)
    assert rt.iterations < jac.iterations // 2 < default.iterations, (
        rt.iterations, jac.iterations, default.iterations)


def test_jacobi_converges_and_helps():
    # 3-D twin of tests/test_preconditioners.py::test_jacobi_converges_and_helps
    mesh = tg.kershaw_mesh((3, 3, 3), 5, epsilon=0.3, device="cpu")
    dom = TDomain(tpartition(mesh, 1), dtype=torch.float64, device="cpu")
    u_star = dom.initial_function(4, seed=3)
    f = dom.manufacture_rhs(u_star)
    base = dom.solver(method="fcg", max_iterations=2000, tolerance=1e-9)(f)
    jac = dom.solver(method="fcg", max_iterations=2000, tolerance=1e-9,
                     precond=tpre.jacobi(dom))(f)
    assert bool(base.converged) and bool(jac.converged)
    assert jac.iterations < base.iterations
    assert (jac.u - u_star).abs().max() < 1e-6


def test_pmg_3d_converges():
    # twin of tests/test_pmultigrid.py::test_pmg_3d_converges
    shape, N, eps = (3, 3, 3), 5, 0.3
    mk = partial(tg.kershaw_mesh, shape, epsilon=eps, device="cpu")
    dom = TDomain(tpartition(mk(N), 1), dtype=torch.float64, device="cpu")
    u_star = dom.initial_function(0)
    f = dom.manufacture_rhs(u_star)
    pmg = tpre.pmultigrid(dom, mk, poly_reduction=4)
    res = dom.solver(method="fcg", max_iterations=200, tolerance=1e-9,
                     precond=pmg)(f)
    assert bool(res.converged)
    assert res.iterations < 90


def test_pmg_orders_levels_and_f32_storage():
    shape = (2, 2, 3)
    mk = partial(tg.kershaw_mesh, shape, epsilon=0.3, device="cpu")
    dom = TDomain(tpartition(mk(6), 1), dtype=torch.float32, device="cpu")
    # default reduction N-1: one coarse level at order 1
    assert len(tpre.pmultigrid(dom, mk).extra["levels"]) == 1
    pmg = tpre.pmultigrid(dom, mk, orders=[4, 2, 1])
    lv = pmg.extra["levels"]
    assert [l["D"].shape[0] for l in lv] == [5, 3, 2]
    assert [tuple(J.shape) for J in pmg.extra["J"]] == [(7, 5), (5, 3), (3, 2)]
    # an f32 domain keeps mask and inverse multiplicity half-width (exact)
    assert lv[0]["mask"].dtype == torch.bfloat16
    assert lv[0]["geom"][0].dtype == torch.float32
    assert lv[1]["mask"].shape == (3 * 3, 2 * 3, 2 * 3)
    u_star = dom.initial_function(0)
    res = dom.solver(method="fcg", max_iterations=100, precond=pmg)(
        dom.manufacture_rhs(u_star))
    assert bool(res.converged)
    assert (res.u - u_star).abs().max() < 1e-3
    # a zero right-hand side: every guard holds, the solution stays zero
    zero = dom.solver(method="fcg", max_iterations=5, precond=pmg)(
        torch.zeros_like(u_star))
    assert float(zero.u.abs().max()) == 0.0
    assert not torch.isnan(zero.residual_history[:zero.iterations + 1]).any()
    other = partial(tg.kershaw_mesh, (2, 3, 3), epsilon=0.3, device="cpu")
    with pytest.raises(ValueError):
        tpre.pmultigrid(dom, other, poly_reduction=3)


def _sharded_pair(shape, N, P, dtype=torch.float64):
    """The same Kershaw problem over P shards in both packages (and the
    port's one-shard domain), with level-mesh builders for both."""
    jb = partial(jg.kershaw_mesh, shape, epsilon=0.3)
    jm = jb(N)
    tm = _port_mesh(jm)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jd = JDomain(jpartition(jm, P), dtype=jdt,
                 device_mesh=jax.make_mesh((P,), ("shard",)))
    td = TDomain(tpartition(tm, P), dtype=dtype, device="cpu")
    return jd, td, jb, lambda N_c: _port_mesh(jb(N_c)), tm


def _gathered(dom, u):
    """A field in global point order, padding dropped."""
    sd = dom.sharded
    v = dom.from_device_field(u).reshape(sd.num_shards, sd.elems_per_shard,
                                         -1)
    return np.concatenate([v[p][sd.elem_valid[p]]
                           for p in range(sd.num_shards)]).ravel()


def test_jacobi_spmd_matches_single():
    # 3-D twin of tests/test_preconditioners.py::test_jacobi_spmd_matches_single
    # (its 2-D (4, 4) N=4 mesh becomes Kershaw (3, 3, 8) N=4, 8 shards of
    # one layer), the port at P = 8 also against the JAX package's P = 8
    jd, td8, _, _, tm = _sharded_pair((3, 3, 8), 4, 8)
    td1 = TDomain(tpartition(tm, 1), dtype=torch.float64, device="cpu")
    out = []
    for dom, pre in ((td1, tpre.jacobi(td1)), (td8, tpre.jacobi(td8)),
                     (jd, jpre.jacobi(jd))):
        u_star = dom.initial_function(0)
        res = dom.solver(method="fcg", max_iterations=1000, tolerance=1e-9,
                         precond=pre)(dom.manufacture_rhs(u_star))
        assert bool(res.converged)
        out.append(res)
    its = [int(r.iterations) for r in out]
    assert abs(its[0] - its[1]) <= 1 and abs(its[1] - its[2]) <= 1, its
    # Jacobi-CG holds rtol 1e-9 for about 90 steps (test above): 60 here
    h = [np.asarray(r.residual_history)[:61] for r in out]
    np.testing.assert_allclose(h[1], h[0], rtol=1e-9)
    np.testing.assert_allclose(h[1], h[2], rtol=1e-9)


def test_pmg_beats_jacobi_spmd():
    # 3-D twin of tests/test_pmultigrid.py::test_pmg_beats_jacobi[8]:
    # Kershaw (3, 3, 8) N=5 over 8 shards, orders 5, 2, 1; every level
    # partitioned over the same 8 shards. Port against the JAX package at
    # P = 8: the same iterations, histories at rtol 1e-9
    jd, td, jb, tb, _ = _sharded_pair((3, 3, 8), 5, 8)
    res = {}
    for key, dom, pre_mod, builder in (("port", td, tpre, tb),
                                       ("jax", jd, jpre, jb)):
        u_star = dom.initial_function(4, seed=1)
        pmg = pre_mod.pmultigrid(dom, builder, poly_reduction=3)
        r_pmg = dom.solver(method="fcg", max_iterations=400, tolerance=1e-9,
                           precond=pmg)(dom.manufacture_rhs(u_star))
        assert bool(r_pmg.converged)
        err = np.abs(_gathered(dom, r_pmg.u) - _gathered(dom, u_star)).max()
        assert err < 1e-6
        res[key] = r_pmg
    tp, jp = res["port"], res["jax"]
    # the original's criterion, on the port (92 against 309 here)
    f = td.manufacture_rhs(td.initial_function(4, seed=1))
    tj = td.solver(method="fcg", max_iterations=400, tolerance=1e-9,
                   precond=tpre.jacobi(td))(f)
    assert tp.iterations < tj.iterations // 2, (tp.iterations, tj.iterations)
    assert tp.iterations == int(jp.iterations)
    k = tp.iterations + 1
    np.testing.assert_allclose(tp.residual_history.numpy()[:k],
                               np.asarray(jp.residual_history)[:k],
                               rtol=1e-9)
    assert len(td._ops()) == 4
    levels = tpre.pmultigrid(td, tb, poly_reduction=3).extra["levels"]
    assert [lv["mask"].shape for lv in levels] == [(8, 3, 9, 9),
                                                   (8, 2, 6, 6)]


def test_refine_spmd_matches_reference():
    # f64 refinement over 4 shards, each cycle an f32 FCG solve with
    # p-multigrid (orders 3, 1): port against the JAX package. The cycle
    # counts agree exactly and each cycle's f32 solve within one iteration
    # (the f32 parity rule); the residual after the first cycle agrees as
    # far as two f32 solves to 1e-4 do, whose dots sum in different orders
    # (1.3e-4 relative measured, held at 1e-3); both reach the f64
    # tolerance with errors under 1e-10
    out = {}
    jd32, td32, jb, tb, tm = _sharded_pair((3, 3, 8), 3, 4, torch.float32)
    jd64 = JDomain(jd32.sharded, dtype=jnp.float64,
                   device_mesh=jax.make_mesh((4,), ("shard",)))
    td64 = TDomain(td32.sharded, dtype=torch.float64, device="cpu")
    for key, d32, d64, pre_mod, builder, refine in (
            ("port", td32, td64, tpre, tb, trefine),
            ("jax", jd32, jd64, jpre, jb, jrefine)):
        u = d64.initial_function(4, seed=3)
        f = d64.manufacture_rhs(u)
        solve = d32.solver(method="fcg", max_iterations=200,
                           precond=pre_mod.pmultigrid(d32, builder,
                                                      poly_reduction=2))
        rr = refine(d64, solve, f, tolerance=1e-10)
        assert rr.converged and rr.rel_residual < 1e-10
        out[key] = (rr, np.abs(_gathered(d64, rr.u)
                               - _gathered(d64, u)).max())
    (rt, et), (rj, ej) = out["port"], out["jax"]
    assert rt.cycles == rj.cycles == 3
    assert abs(rt.inner_iterations - rj.inner_iterations) <= rt.cycles
    np.testing.assert_allclose(rt.history[:2], rj.history[:2], rtol=1e-3)
    assert et < 1e-10 and ej < 1e-10
