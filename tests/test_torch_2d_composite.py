"""The port's 2-D composite DD + polynomial-reduction preconditioner on
one shard (solvers/subdomain.composite_dd on a 2-D Domain) and the 2-D
host f64 refinement, against the JAX package (CPU, f64 unless stated):
Kershaw (4, 4) N=5 r=2 (tests/test_composite_dd.py::
test_composite_dd_single_shard_converges), the f32 and bf16 ptypes, the
lighter inners "fem-amg", "jacobi" and "none", the host oracle's
refinement at P = 1 and 8 (tests/test_host_oracle.py) and the device f64
refinement, and the two 2-D refusals. The composite over 8 and 4 shards
is tests/test_torch_2d_composite_spmd.py. Helpers: tests/
composite_twins.py.

Tolerances: one preconditioner application within 1e-12 of max and its
inner histories at rtol 1e-10 (``check_probe``); equal outer counts and
the outer f64 histories at rtol 1e-9 over the stated prefix (they part by
round-off near the end, ROADMAP section 3); an f32 ptype's count within
+-1 of the JAX package's; bf16 only against the port's own f32 run (the
port accumulates a bf16 contraction in f32, ROADMAP section 3)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import host_oracle as jho
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as jsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.comm import LocalComm
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import host_oracle as tho
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import subdomain as tsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.refine import refine_solve

from composite_twins import (check_probe, composites, history, no_k12,
                             pair2d, port_mesh, solve_one)
from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def test_composite_p1_matches_reference():
    # one shard: the composite is the whole domain at order 5 (G = 1).
    # Both packages take 7 steps; the histories part at the last (5.3e-8,
    # 2.2e-10 before it)
    jb, jm, tm, jd, td, u, f = pair2d((4, 4), 5, 1, seed=2)
    jp, tp = composites(jb, jm, tm, jd, td, poly_reduction=2)
    kernels.reset_counts()
    check_probe(jd, td, jp, tp, f)
    rj, rt = solve_one(jd, jp, f), solve_one(td, tp, f)
    assert no_k12()
    assert bool(rt.converged) and rt.iterations == int(rj.iterations)
    k = rt.iterations
    np.testing.assert_allclose(history(rt)[:k], history(rj)[:k], rtol=1e-9)
    assert np.abs(rt.u.numpy() - np.asarray(u)).max() < 1e-6
    base = td.solver(method="fgmres", max_iterations=100, tolerance=1e-8)(
        torch.as_tensor(np.array(f)))
    assert rt.iterations < base.iterations // 2


def test_reduced_ptypes_p1():
    # the f32 ptype against the JAX package's (+-1), and bf16 against the
    # port's own f32 run (the bound of ::test_composite_dd_bf16_ptype)
    jb, jm, tm, jd, td, u, f = pair2d((4, 4), 5, 1, seed=13)
    jp = jsub.composite_dd(jd, jb, 2, fine_mesh=jm, ptype=jnp.float32)
    rj = solve_one(jd, jp, f)
    tp32 = tsub.composite_dd(td, lambda o: port_mesh(jb(o)), 2,
                             fine_mesh=tm, ptype=torch.float32)
    rt = solve_one(td, tp32, f)
    assert bool(rt.converged)
    assert abs(rt.iterations - int(rj.iterations)) <= 1
    tp16 = tsub.composite_dd(td, lambda o: port_mesh(jb(o)), 2,
                             fine_mesh=tm, ptype=torch.bfloat16)
    r16 = solve_one(td, tp16, f)
    assert bool(r16.converged) and r16.iterations <= rt.iterations + 8
    assert np.abs(r16.u.numpy() - np.asarray(u)).max() < 1e-6


@pytest.mark.parametrize("inner", ["fem-amg", "jacobi", "none"])
def test_inner_variants_p1_match_reference(inner):
    # Kershaw (4, 4) N=3 r=2 on one shard: 5 / 15 / 22 steps in both
    # packages; the histories agree to 1e-9 over the first 5 / 13 / 18
    # residuals (6.4e-11, 2.7e-10, 4.4e-11 at the last compared)
    jb, jm, tm, jd, td, u, f = pair2d((4, 4), 3, 1, seed=5)
    jp, tp = composites(jb, jm, tm, jd, td, poly_reduction=2, inner=inner)
    kernels.reset_counts()
    check_probe(jd, td, jp, tp, f)
    rj, rt = solve_one(jd, jp, f), solve_one(td, tp, f)
    assert no_k12()
    if inner == "fem-amg":
        assert kernels.counts()["csr_spmv_plain"]
    assert bool(rt.converged) and rt.iterations == int(rj.iterations)
    k = {"fem-amg": 5, "jacobi": 13, "none": 18}[inner]
    np.testing.assert_allclose(history(rt)[:k], history(rj)[:k], rtol=1e-9)


def test_2d_refusals():
    # the generic (structured=False) 2-D route and a 2-D Domain across
    # processes are not ported: each raises, naming its ROADMAP item
    mesh = tg.kershaw_mesh((4, 4), 2, epsilon=0.3, device="cpu")
    with pytest.raises(NotImplementedError, match="16b"):
        TDomain(tpartition(mesh, 2, structured=False), dtype=torch.float64,
                device="cpu")

    class TwoProcesses(LocalComm):
        processes = 2

        def __init__(self):
            super().__init__(2)
            self.local_shards = 1

    with pytest.raises(NotImplementedError, match="16b"):
        TDomain(tpartition(mesh, 2, owned=(0,)), dtype=torch.float64,
                device="cpu", comm=TwoProcesses())


def _host_refine_pair(shape, N, P, tol, maxit):
    """tests/test_host_oracle.py's 2-D host refinement in the port: an
    f32 Domain over P shards, unpreconditioned f32 FGMRES as the
    correction solve, the f64 residual on the host."""
    mesh = tg.kershaw_mesh(shape, N, epsilon=0.3, device="cpu")
    dom32 = TDomain(tpartition(mesh, P), dtype=torch.float32, device="cpu")
    host = tho.HostOperator(mesh)
    u_star = tho.owned_to_global(dom32, dom32.from_device_field(
        dom32.initial_function(4, seed=0)))
    f64 = host.apply(u_star)
    res = tho.host_refine_solve(
        host, dom32, dom32.solver(method="fgmres", max_iterations=maxit),
        f64, tolerance=tol)
    return mesh, dom32, host, u_star, f64, res


def test_host_refinement_2d_matches_reference():
    # ::test_host_refinement_reaches_double_accuracy_2d: Kershaw (6, 6)
    # N=4 to 1e-9, the host operators of both packages within 1e-12, and
    # the JAX package's refinement of the same right-hand side
    mesh, dom32, host, u_star, f64, res = _host_refine_pair(
        (6, 6), 4, 1, 1e-9, 200)
    assert res.converged and res.rel_residual < 1e-9
    assert np.abs(res.u - u_star).max() <= 1e-6 * np.abs(u_star).max()
    jm = jg.kershaw_mesh((6, 6), 4, epsilon=0.3)
    jhost = jho.HostOperator(jm)
    v = np.random.default_rng(1).standard_normal(mesh.num_points)
    assert np.abs(host.apply(v) - jhost.apply(v)).max() <= \
        1e-12 * np.abs(jhost.apply(v)).max()
    jd = JDomain(jpartition(jm, 1), dtype=jnp.float32)
    jres = jho.host_refine_solve(
        jhost, jd, jd.solver(method="fgmres", max_iterations=200), f64,
        tolerance=1e-9)
    # the correction solves hit their 200 iterations in every cycle in
    # both packages, and unpreconditioned f32 FGMRES histories part by
    # round-off within the first restart (1.372 against 1.426 at step
    # 20): the cycles agree within one (5 against 6 here)
    assert jres.converged and abs(res.cycles - jres.cycles) <= 1
    # the device f64 refinement of the same f32 solve (an f64 Domain on
    # the CPU): the same cycles and the same criterion
    dom64 = TDomain(tpartition(mesh, 1), dtype=torch.float64, device="cpu")
    dev = refine_solve(dom64, dom32.solver(method="fgmres",
                                           max_iterations=200),
                       dom64.to_device_field(f64), tolerance=1e-9)
    assert dev.converged and dev.cycles == res.cycles
    np.testing.assert_allclose(dev.history[:2], res.history[:2], rtol=1e-6)


def test_host_refinement_2d_p8():
    # ::test_host_refinement_multi_shard_p8: Kershaw (8, 8) N=4 over 8
    # shards to 1e-7, with its criteria
    mesh, dom32, host, u_star, f64, res = _host_refine_pair(
        (8, 8), 4, 8, 1e-7, 300)
    g = np.random.default_rng(0).random(mesh.num_points)
    assert np.array_equal(tho.owned_to_global(
        dom32, tho.global_to_owned(dom32, g)), g)
    assert res.converged and res.rel_residual < 1e-7
    assert np.abs(res.u - u_star).max() <= 1e-5 * np.abs(u_star).max()
