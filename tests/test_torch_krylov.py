"""PyTorch port of the Krylov solvers and the one-device Domain vs the
JAX package: unpreconditioned FCG and FGMRES on Kershaw 4^3 N=5 in f64
(the recipe of .claude/skills/verify/SKILL.md), CPU."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import krylov
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain

from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def _port_mesh(m):
    return tg.GlobalMesh.from_numpy(
        coords=m.coords, geom=m.geom, dirichlet_mask=m.dirichlet_mask,
        node_degree=m.node_degree, elem_shape=m.elem_shape,
        poly_degree=m.poly_degree, mass=m.mass)


@pytest.fixture(scope="module")
def problem():
    jm = jg.kershaw_mesh((4, 4, 4), 5, epsilon=0.3)
    jd = JDomain(jpartition(jm, 1), dtype=jnp.float64)
    td = TDomain(tpartition(_port_mesh(jm), 1), dtype=torch.float64,
                 device="cpu")
    u_j = jd.initial_function(4, seed=42)
    f_j = jd.manufacture_rhs(u_j)
    return jd, td, u_j, f_j


def test_domain_fields_match_reference(problem):
    jd, td, u_j, f_j = problem
    for fid in range(5):
        a = np.asarray(jd.initial_function(fid, seed=3))
        b = td.initial_function(fid, seed=3).numpy()
        assert np.array_equal(a, b), fid
    u_t = td.initial_function(4, seed=42)
    f_t = td.manufacture_rhs(u_t)
    assert np.abs(f_t.numpy() - np.asarray(f_j)).max() \
        <= 1e-12 * np.abs(np.asarray(f_j)).max()
    host = np.random.default_rng(0).standard_normal(td.points_shape())
    assert np.array_equal(td.from_device_field(td.to_device_field(host)),
                          host.reshape(1, -1))
    r_j, rn_j = jd.residual(u_j, f_j)
    r_t, rn_t = td.residual(torch.as_tensor(np.array(u_j)),
                            torch.as_tensor(np.array(f_j)))
    assert abs(float(rn_t) - float(rn_j)) <= 1e-12 * float(np.abs(np.asarray(f_j)).max())


def test_fcg_history_matches_reference(problem):
    jd, td, u_j, f_j = problem
    rj = jd.solver(method="fcg", max_iterations=800, tolerance=1e-9)(f_j)
    rt = td.solver(method="fcg", max_iterations=800, tolerance=1e-9)(
        torch.as_tensor(np.array(f_j)))
    assert bool(rt.converged) and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    hj = np.asarray(rj.residual_history)
    ht = rt.residual_history.numpy()
    assert np.isnan(ht[rt.iterations + 1:]).all()
    # unpreconditioned CG amplifies the 1e-16 operator round-off by ~10x
    # per iteration once it loses orthogonality (~50 iterations in; by the
    # end the histories differ at O(0.1)); the recurrences agree to 1e-9
    # relative over the first 40 steps
    assert np.allclose(ht[:41], hj[:41], rtol=1e-9, atol=0.0)
    err = np.abs(rt.u.numpy() - np.asarray(u_j)).max()
    assert err < 1e-6


def test_fgmres_history_matches_reference(problem):
    jd, td, u_j, f_j = problem
    rj = jd.solver(method="fgmres", max_iterations=120, tolerance=1e-9)(f_j)
    rt = td.solver(method="fgmres", max_iterations=120, tolerance=1e-9)(
        torch.as_tensor(np.array(f_j)))
    assert rt.iterations == int(rj.iterations)
    assert bool(rt.converged) == bool(rj.converged)
    k = rt.iterations + 1
    hj = np.asarray(rj.residual_history)
    ht = rt.residual_history.numpy()
    assert np.allclose(ht[:k], hj[:k], rtol=1e-9, atol=0.0)
    assert np.isnan(ht[k:]).all()
    uj = np.asarray(rj.u)
    assert np.abs(rt.u.numpy() - uj).max() <= 1e-8 * np.abs(uj).max()


def test_fgmres_converges_with_restarts_and_bf16_z_basis():
    # restarts (m=5) and the quantized flexible Z basis on a small f64
    # problem; the converged solution matches u*
    td = TDomain(tpartition(tg.kershaw_mesh((2, 2, 3), 3, device="cpu"), 1),
                 dtype=torch.float64, device="cpu")
    u = td.initial_function(0)
    f = td.manufacture_rhs(u)
    for z_dtype in (None, torch.bfloat16):
        res = td.solver(method="fgmres", num_vectors=5, max_iterations=400,
                        tolerance=1e-8, z_dtype=z_dtype)(f)
        assert bool(res.converged), z_dtype
        assert res.iterations > 5
        assert (res.u - u).abs().max() < 1e-6


def test_tree_dot_bf16_sums_in_f32_rounds_once():
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.random(200_000)).to(torch.bfloat16)
    b = torch.as_tensor(rng.random(200_000)).to(torch.bfloat16)
    exact = torch.dot(a.double(), b.double())
    got = krylov.tree_dot(a, b)
    assert got.dtype == torch.bfloat16
    # one rounding to bf16 (8 bits): within half a bf16 ulp of the exact sum
    assert abs(float(got) - float(exact)) <= float(exact) * 2.0 ** -8
    V = torch.stack([a, b])
    h = krylov.tree_dot(V, b)
    assert h.shape == (2,) and h.dtype == torch.bfloat16
    assert abs(float(h[0]) - float(exact)) <= float(exact) * 2.0 ** -8
    assert float(krylov.tree_dot([a, b], [b, a])) == pytest.approx(
        2 * float(exact), rel=2.0 ** -7)


@pytest.mark.parametrize("method,its", [("fcg", 40), ("fgmres", 18)])
def test_absolute_tolerance_matches_reference(problem, method, its):
    # use_relative=False: the solve stops under the tolerance itself, not
    # under tolerance * ||r0|| (||r0|| = 21.7 here)
    jd, td, u_j, f_j = problem
    tol = 0.3
    rj = jd.solver(method=method, max_iterations=400, tolerance=tol,
                   use_relative=False)(f_j)
    rt = td.solver(method=method, max_iterations=400, tolerance=tol,
                   use_relative=False)(torch.as_tensor(np.array(f_j)))
    assert bool(rt.converged) and bool(rj.converged)
    assert rt.iterations == int(rj.iterations) == its
    k = rt.iterations + 1
    ht = rt.residual_history.numpy()
    assert np.allclose(ht[:k], np.asarray(rj.residual_history)[:k],
                       rtol=1e-9, atol=0.0)
    assert ht[k - 1] < tol <= ht[k - 2] and ht[0] > 20 * tol
    rel = td.solver(method=method, max_iterations=400, tolerance=tol)(
        torch.as_tensor(np.array(f_j)))
    assert rel.iterations < rt.iterations


def test_precond_builder_matches_reference(problem):
    # a bare builder (arrays, None, ops) -> (r -> z), used when precond is
    # None: here the weighted dssum W QQt r, the same in both packages
    jd, td, u_j, f_j = problem

    def builder(arrays, extra, ops):
        assert extra is None
        return lambda r: ops[1](r, apply_mask=True, apply_weight=True)

    rj = jd.solver(method="fgmres", max_iterations=400, tolerance=1e-3,
                   precond_builder=builder)(f_j)
    rt = td.solver(method="fgmres", max_iterations=400, tolerance=1e-3,
                   precond_builder=builder)(torch.as_tensor(np.array(f_j)))
    assert bool(rt.converged) and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    k = rt.iterations + 1
    assert np.allclose(rt.residual_history.numpy()[:k],
                       np.asarray(rj.residual_history)[:k],
                       rtol=1e-9, atol=0.0)
    plain = td.solver(method="fgmres", max_iterations=400, tolerance=1e-3)(
        torch.as_tensor(np.array(f_j)))
    assert plain.iterations != rt.iterations
