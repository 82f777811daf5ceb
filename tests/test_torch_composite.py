"""PyTorch port of the one-shard composite DD preconditioner
(solvers/subdomain.composite_dd, inner='amg') and of f64 iterative
refinement vs the JAX package on the CPU. Both packages get the identical
problem: the JAX meshes go across with GlobalMesh.from_numpy."""

from functools import partial

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.amg.composite import vertex_q1_hierarchy
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as jsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import subdomain as tsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.refine import refine_solve

from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def _port_mesh(m):
    return tg.GlobalMesh.from_numpy(
        coords=m.coords, geom=m.geom, dirichlet_mask=m.dirichlet_mask,
        node_degree=m.node_degree, elem_shape=m.elem_shape,
        poly_degree=m.poly_degree, mass=m.mass)


def _pair(shape, N, r, jdt, tdt, jpt, tpt):
    """The same Kershaw problem in both packages: domains, preconditioners
    (the port gets the JAX package's vertex chain as it is) and the JAX
    right-hand side and manufactured solution."""
    jb = partial(jg.kershaw_mesh, shape, epsilon=0.3)
    jm = jb(N)
    tm = _port_mesh(jm)
    jd = JDomain(jpartition(jm, 1), dtype=jdt)
    td = TDomain(tpartition(tm, 1), dtype=tdt, device="cpu")
    jp = jsub.composite_dd(jd, jb, poly_reduction=r, inner="amg",
                           ptype=jpt, fine_mesh=jm)
    chain_info = vertex_q1_hierarchy(jb(1), shape[:2][::-1], shape[2], 3)
    tp = tsub.composite_dd(td, None, poly_reduction=r, inner="amg",
                           ptype=tpt, fine_mesh=tm, chain_info=chain_info)
    u_star = jd.initial_function(4, seed=0)
    f = jd.manufacture_rhs(u_star)
    return jd, td, jp, tp, u_star, f


@pytest.mark.parametrize("shape,N,r,tol", [((4, 4, 4), 7, 6, 1e-8),
                                           ((8, 8, 8), 3, 2, 1e-6)])
def test_composite_f64_matches_reference(shape, N, r, tol):
    jd, td, jp, tp, u_star, f = _pair(shape, N, r, jnp.float64,
                                      torch.float64, jnp.float64,
                                      torch.float64)
    lj = float(jp.extra["amg"]["lmax0"])
    lt = float(tp.extra["amg"]["lmax0"])
    assert abs(lt - lj) <= 1e-10 * lj
    ft = torch.as_tensor(np.array(f))
    # one preconditioner application: the inner FGMRES(4) history
    zj, hj = jd.precond_probe(jp)(f)
    zt, ht = td.precond_probe(tp)(ft)
    assert np.allclose(ht.numpy(), np.asarray(hj), rtol=1e-9, atol=0.0)
    zj = np.asarray(zj)
    assert np.abs(zt.numpy() - zj).max() <= 1e-9 * np.abs(zj).max()
    # the outer f64 FGMRES: same iteration count and history
    rj = jd.solver(method="fgmres", max_iterations=60, tolerance=tol,
                   precond=jp)(f)
    rt = td.solver(method="fgmres", max_iterations=60, tolerance=tol,
                   precond=tp)(ft)
    assert bool(rt.converged) and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    k = rt.iterations + 1
    assert np.allclose(rt.residual_history.numpy()[:k],
                       np.asarray(rj.residual_history)[:k],
                       rtol=1e-9, atol=0.0)


def test_bench_configuration_and_refinement():
    # the main path's precision split: f32 outer, bf16 composite, f32
    # vertex chain; then f64 iterative refinement around that solve
    shape, N, r = (8, 8, 8), 3, 2
    jd, td, jp, tp, u_star, f = _pair(shape, N, r, jnp.float32,
                                      torch.float32, jnp.bfloat16,
                                      torch.bfloat16)
    assert tp.extra["groups"][0]["mask"].dtype == torch.bfloat16
    assert tp.extra["amg"]["chain"]["coarse_inv"].dtype == torch.float32
    assert td.arrays.mask.dtype == torch.bfloat16
    rj = jd.solver(method="fgmres", max_iterations=200, precond=jp)(f)
    solve = td.solver(method="fgmres", max_iterations=200, precond=tp)
    kernels.reset_counts()
    rt = solve(torch.as_tensor(np.array(f)))
    c = kernels.counts()
    assert bool(rt.converged) and bool(rj.converged)
    assert abs(rt.iterations - int(rj.iterations)) <= 1, (
        rt.iterations, int(rj.iterations))
    # CPU tensors run the plain twins and never a kernel
    assert c["stiffness_lattice_3d"] == {} and c["lattice_face_sum_3d"] == {}
    assert c["stiffness_lattice_3d_plain"]["bfloat16"] > 0
    assert c["lattice_face_sum_3d_plain"]["float32"] > 0

    td64 = TDomain(td.sharded, dtype=torch.float64, device="cpu")
    u64 = td64.to_device_field(td.from_device_field(
        torch.as_tensor(np.array(u_star))))
    f64 = td64.manufacture_rhs(u64)
    rr = refine_solve(td64, solve, f64, tolerance=1e-10)
    assert rr.converged and rr.rel_residual <= 1e-10
    assert rr.cycles >= 2 and rr.inner_iterations > rt.iterations
    assert (rr.u - u64).abs().max() < 1e-6


def test_unported_options_raise():
    tm = tg.kershaw_mesh((2, 2, 4), 2, device="cpu")
    td = TDomain(tpartition(tm, 1), dtype=torch.float64, device="cpu")
    mk = partial(tg.kershaw_mesh, (2, 2, 4), device="cpu")
    # the Jacobi / plain-QQt inner preconditioners, the FCG inner solver
    # (tests/test_torch_composite_variants.py) and the assembled FEM
    # hierarchy (tests/test_torch_femamg.py) are ported on one shard; more
    # shards are not
    for kw in ({"inner": "jacobi"}, {"inner_solver": "fcg"},
               {"inner": "fem-amg"}):
        tsub.composite_dd(td, mk, poly_reduction=1, fine_mesh=tm, **kw)
    # two shards (the multi-shard composite, tests/
    # test_torch_composite_spmd.py): both inners build and converge on
    # slabs of 4 layers, rings of orders 2 and 1 on each side
    tm8 = tg.kershaw_mesh((2, 2, 8), 2, device="cpu")
    mk8 = partial(tg.kershaw_mesh, (2, 2, 8), device="cpu")
    two_shards = TDomain(tpartition(tm8, 2), dtype=torch.float64,
                         device="cpu")
    f = two_shards.manufacture_rhs(two_shards.initial_function(4, seed=0))
    for inner in ("amg", "fem-amg"):
        pre = tsub.composite_dd(two_shards, mk8, poly_reduction=1,
                                fine_mesh=tm8, inner=inner)
        assert len(pre.extra["specs"]) == 5
        res = two_shards.solver(method="fgmres", max_iterations=60,
                                tolerance=1e-8, precond=pre)(f)
        assert bool(res.converged), (inner, res.residual_history)
    with pytest.raises(ValueError):
        tsub.composite_dd(td, mk, poly_reduction=1, subdomain_overlap=3,
                          fine_mesh=tm)
