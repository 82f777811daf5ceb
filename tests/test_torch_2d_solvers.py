"""The port's 2-D Domain and its solvers against the JAX package (CPU,
f64): the operator's symmetry, definiteness and spectral accuracy
(tests/test_operator.py, 2-D cases), FCG and FGMRES at P = 1 against P =
8 (tests/test_spmd.py), ragged slabs at P = 3 and 5 (tests/
test_ragged.py), Jacobi (tests/test_preconditioners.py), p-multigrid at
P = 1 and 8 (tests/test_pmultigrid.py), and a 2-D mesh file written by
the JAX package's runtime/checkpoint.py loaded by the port's.

Tolerances: equal iteration counts between the packages and histories
at rtol 1e-9 over the stated prefix (f64 histories part by round-off
afterwards, ROADMAP section 3); between shard counts of the port +-1
iteration, as the reference tests allow."""

from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.runtime import checkpoint as jck
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import preconditioners as jpre
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime import checkpoint as tck
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import preconditioners as tpre
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.host_oracle import owned_to_global

from composite_twins import one_torch_thread, port_mesh  # noqa: F401 (autouse)


def jdomain(jm, P):
    kw = {} if P == 1 else {"device_mesh": jax.make_mesh((P,), ("shard",))}
    return JDomain(jpartition(jm, P), dtype=jnp.float64, **kw)


def tdomain(mesh, P, dtype=torch.float64):
    return TDomain(tpartition(mesh, P), dtype=dtype, device="cpu")


def hist(res):
    h = res.residual_history
    h = h.numpy() if isinstance(h, torch.Tensor) else np.asarray(h)
    return h[:int(res.iterations) + 1]


def same_run(rj, rt, steps):
    """Equal counts, the first ``steps`` + 1 residuals at rtol 1e-9."""
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(hist(rt)[:steps + 1], hist(rj)[:steps + 1],
                               rtol=1e-9)


def dense_assembled(dom, mesh):
    """The assembled operator over the unique global nodes (port)."""
    uniq, inv = np.unique(mesh.glo_num.reshape(-1), return_inverse=True)
    nn = uniq.size
    A = np.zeros((nn, nn))
    for j in range(nn):
        e = (inv == j).astype(np.float64)
        au = dom.from_device_field(dom.apply_operator(
            dom.to_device_field(e.reshape(dom.points_shape()))))
        A[:, j] = np.bincount(inv, weights=au.ravel(), minlength=nn)
    return A


@pytest.mark.parametrize("shape,N,eps", [((2, 2), 3, None), ((2, 2), 2, 0.3)])
def test_operator_symmetric_psd_and_annihilates_constants(shape, N, eps):
    mesh = (tg.box_mesh(shape, N, device="cpu") if eps is None
            else tg.kershaw_mesh(shape, N, eps, device="cpu"))
    dom = tdomain(mesh, 1)
    A = dense_assembled(dom, mesh)
    assert np.abs(A - A.T).max() < 1e-11
    w = np.linalg.eigvalsh(A)
    assert w[0] > -1e-10 and abs(w[0]) < 1e-9 and w[1] > 1e-8
    # the same matrix as the JAX package's apply on the same mesh
    jd = jdomain(jg.box_mesh(shape, N) if eps is None
                 else jg.kershaw_mesh(shape, N, eps), 1)
    e = np.zeros(dom.points_shape())
    e[::3] = 1.0
    want = np.asarray(jd.apply_operator(jd.to_device_field(e)))
    got = dom.apply_operator(dom.to_device_field(e)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    ones = tdomain(tg.box_mesh((3, 2), 4, device="cpu"), 1)
    au = ones.apply_operator(ones.to_device_field(
        np.ones(ones.points_shape())))
    assert au.abs().max() < 1e-10


def test_true_poisson_spectral_accuracy_2d():
    # tests/test_operator.py::test_true_poisson_spectral_accuracy, dim = 2
    mesh = tg.box_mesh((4, 4), 8, device="cpu")
    dom = tdomain(mesh, 1)
    c = mesh.coords
    u_star = np.prod(np.sin(np.pi * c), axis=-1)
    f = dom.to_device_field((mesh.mass * 2 * np.pi ** 2 * u_star)
                            .reshape(dom.points_shape()))
    res = dom.solver(method="fcg", max_iterations=600, tolerance=1e-12)(f)
    err = dom.from_device_field(res.u).ravel() - u_star.ravel()
    assert np.abs(err * mesh.dirichlet_mask.ravel()).max() < 1e-7


@pytest.mark.parametrize("method", ["fcg", "fgmres"])
def test_spmd_matches_single_device_2d(method):
    # tests/test_spmd.py::test_spmd_matches_single_device: Kershaw (4, 4)
    # N=3 to 1e-10 over 1 and 8 shards; the port's P = 1 run against the
    # JAX package's (FCG 98 steps; the unpreconditioned histories part at
    # ~1e-9 by step 20, so 12 steps are compared)
    jm = jg.kershaw_mesh((4, 4), 3, 0.3)
    tm = port_mesh(jm)
    runs = {}
    for P in (1, 8):
        dom = tdomain(tm, P)
        f = dom.manufacture_rhs(dom.initial_function(4, seed=7))
        runs[P] = (dom, dom.solver(method=method, max_iterations=400,
                                   tolerance=1e-10)(f))
    (d1, r1), (d8, r8) = runs[1], runs[8]
    assert bool(r1.converged) and bool(r8.converged)
    assert abs(r1.iterations - r8.iterations) <= 1
    np.testing.assert_allclose(hist(r8)[:10], hist(r1)[:10], rtol=1e-9)
    g1 = owned_to_global(d1, d1.from_device_field(r1.u))
    g8 = owned_to_global(d8, d8.from_device_field(r8.u))
    np.testing.assert_allclose(g8, g1, atol=1e-7 * np.abs(g1).max())
    jd = jdomain(jm, 1)
    f = jd.manufacture_rhs(jd.initial_function(4, seed=7))
    rj = jd.solver(method=method, max_iterations=400, tolerance=1e-10)(f)
    same_run(rj, r1, 12)


@pytest.mark.parametrize("P", [3, 5])
def test_ragged_fine_solve_2d(P):
    # tests/test_ragged.py::test_ragged_fine_solve_matches_single_device:
    # Kershaw (4, 7) N=3, 7 element rows over 3 (3, 2, 2) or 5 (2, 2, 1,
    # 1, 1) shards, FCG to 1e-10; and the port's P-shard run against the
    # JAX package's
    jm = jg.kershaw_mesh((4, 7), 3, 0.3)
    tm = port_mesh(jm)
    d1, dP = tdomain(tm, 1), tdomain(tm, P)
    assert dP.ragged
    res = []
    for dom in (d1, dP):
        f = dom.manufacture_rhs(dom.initial_function(4, seed=7))
        res.append(dom.solver(method="fcg", max_iterations=400,
                              tolerance=1e-10)(f))
    r1, rP = res
    assert abs(r1.iterations - rP.iterations) <= 1
    k = min(r1.iterations, rP.iterations, 10)
    np.testing.assert_allclose(hist(rP)[:k], hist(r1)[:k], rtol=1e-9)
    g1 = owned_to_global(d1, d1.from_device_field(r1.u))
    gP = owned_to_global(dP, dP.from_device_field(rP.u))
    np.testing.assert_allclose(gP, g1, atol=1e-7 * np.abs(g1).max())
    jd = jdomain(jm, P)
    f = jd.manufacture_rhs(jd.initial_function(4, seed=7))
    rj = jd.solver(method="fcg", max_iterations=400, tolerance=1e-10)(f)
    same_run(rj, rP, 12)


def test_jacobi_2d():
    # tests/test_preconditioners.py::test_jacobi_converges_and_helps
    # (Kershaw (6, 6) N=5 to 1e-9) against the JAX package, and
    # ::test_jacobi_spmd_matches_single ((4, 4) N=4 over 1 and 8 shards)
    jm = jg.kershaw_mesh((6, 6), 5, epsilon=0.3)
    dom = tdomain(port_mesh(jm), 1)
    u_star = dom.initial_function(4, seed=3)
    f = dom.manufacture_rhs(u_star)
    base = dom.solver(method="fcg", max_iterations=2000, tolerance=1e-9)(f)
    jac = dom.solver(method="fcg", max_iterations=2000, tolerance=1e-9,
                     precond=tpre.jacobi(dom))(f)
    assert bool(base.converged) and bool(jac.converged)
    assert jac.iterations < base.iterations
    assert (jac.u - u_star).abs().max() < 1e-6
    jd = jdomain(jm, 1)
    fj = jd.manufacture_rhs(jd.initial_function(4, seed=3))
    rj = jd.solver(method="fcg", max_iterations=2000, tolerance=1e-9,
                   precond=jpre.jacobi(jd))(fj)
    # Jacobi FCG parts at ~1e-9 after 60 steps (ROADMAP section 3)
    same_run(rj, jac, 40)
    m4 = tg.kershaw_mesh((4, 4), 4, epsilon=0.3, device="cpu")
    its = []
    for P in (1, 8):
        d = tdomain(m4, P)
        r = d.solver(method="fcg", max_iterations=1000, tolerance=1e-9,
                     precond=tpre.jacobi(d))(
            d.manufacture_rhs(d.initial_function(0)))
        assert bool(r.converged)
        its.append(r.iterations)
    assert abs(its[0] - its[1]) <= 1


@pytest.mark.parametrize("P", [1, 8])
def test_pmultigrid_2d_matches_reference(P):
    # tests/test_pmultigrid.py::test_pmg_beats_jacobi: Kershaw (6, 6) N=7,
    # orders 7, 4, 1, FCG to 1e-9 (71 steps in both packages; the
    # histories agree to ~1e-12 over the first 40)
    shape, N = (6, 6), 7
    jb = partial(jg.kershaw_mesh, shape, epsilon=0.3)
    jm = jb(N)
    jd = jdomain(jm, P)
    td = tdomain(port_mesh(jm), P)
    u_star = td.initial_function(4, seed=1)
    f = td.manufacture_rhs(u_star)
    pmg = tpre.pmultigrid(td, lambda o: port_mesh(jb(o)), poly_reduction=3)
    res = td.solver(method="fcg", max_iterations=400, tolerance=1e-9,
                    precond=pmg)(f)
    jac = td.solver(method="fcg", max_iterations=400, tolerance=1e-9,
                    precond=tpre.jacobi(td))(f)
    assert bool(res.converged)
    assert res.iterations < jac.iterations // 2, (res.iterations,
                                                  jac.iterations)
    assert (res.u - u_star).abs().max() < 1e-6
    fj = jd.manufacture_rhs(jd.initial_function(4, seed=1))
    rj = jd.solver(method="fcg", max_iterations=400, tolerance=1e-9,
                   precond=jpre.pmultigrid(jd, jb, poly_reduction=3))(fj)
    same_run(rj, res, 40)


def test_mesh_file_written_by_reference_loads(tmp_path):
    # a 2-D mesh saved by the JAX package's runtime/checkpoint.py is the
    # port's mesh, field for field, and gives the port's Domain the same
    # operator as the port's own build of it
    jm = jg.kershaw_mesh((3, 5), 4, epsilon=0.3)
    path = str(tmp_path / "jmesh2d.npz")
    jck.save_mesh(path, jm)
    tm = tck.load_mesh(path)
    assert tm.dim == 2 and tm.elem_shape == (3, 5)
    for k in ("coords", "geom", "dirichlet_mask", "node_degree", "mass",
              "glo_num"):
        assert np.array_equal(getattr(tm, k), getattr(jm, k)), k
    d_file, d_own = tdomain(tm, 2), tdomain(port_mesh(jm), 2)
    u = d_own.initial_function(4, seed=2)
    assert torch.equal(d_file.apply_operator(u), d_own.apply_operator(u))
