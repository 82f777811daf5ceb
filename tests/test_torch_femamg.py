"""PyTorch port of composite_dd(inner="fem-amg") on one shard vs the JAX
package, CPU: one preconditioner application and the outer f64 FGMRES on
Kershaw 4^3 N=3, and the one-shard half of the dry-run's gate 4 (the bf16
hierarchy under a bf16 Z basis, Kershaw (2, 2, 17) N=3) in both
packages. Both get the identical problem: the JAX meshes go across with
GlobalMesh.from_numpy."""

from functools import partial

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as jsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import subdomain as tsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain

from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def _port_mesh(m):
    return tg.GlobalMesh.from_numpy(
        coords=m.coords, geom=m.geom, dirichlet_mask=m.dirichlet_mask,
        node_degree=m.node_degree, elem_shape=m.elem_shape,
        poly_degree=m.poly_degree, mass=m.mass)


def _pair(shape, N, r, jdt, tdt, jpt, tpt, extent=None):
    jb = partial(jg.kershaw_mesh, shape, epsilon=0.3, extent=extent)
    jm = jb(N)
    tm = _port_mesh(jm)
    jd = JDomain(jpartition(jm, 1), dtype=jdt)
    td = TDomain(tpartition(tm, 1), dtype=tdt, device="cpu")
    jp = jsub.composite_dd(jd, jb, poly_reduction=r, inner="fem-amg",
                           ptype=jpt, fine_mesh=jm)
    tp = tsub.composite_dd(td, None, poly_reduction=r, inner="fem-amg",
                           ptype=tpt, fine_mesh=tm)
    u_star = jd.initial_function(4, seed=0)
    f = jd.manufacture_rhs(u_star)
    return jd, td, jp, tp, u_star, f


def test_femamg_f64_matches_reference():
    jd, td, jp, tp, u_star, f = _pair((4, 4, 4), 3, 2, jnp.float64,
                                      torch.float64, jnp.float64,
                                      torch.float64)
    ft = torch.as_tensor(np.array(f))
    # one preconditioner application: the inner FGMRES(4) on the
    # composite, each step preconditioned by Q^T, V-cycle, Q, mask
    zj, hj = jd.precond_probe(jp)(f)
    zt, ht = td.precond_probe(tp)(ft)
    zj = np.asarray(zj)
    assert np.abs(zt.numpy() - zj).max() <= 1e-12 * np.abs(zj).max()
    assert np.allclose(ht.numpy(), np.asarray(hj), rtol=1e-12, atol=0.0)
    # the outer f64 FGMRES: same count; the histories drift apart ~10x a
    # step from round-off (1e-13 at step 4, 7e-11 at step 6, 1.4e-9 at
    # the last), so rtol 1e-9 holds over the first 6 steps
    kernels.reset_counts()
    rt = td.solver(method="fgmres", max_iterations=60, tolerance=1e-8,
                   precond=tp)(ft)
    c = kernels.counts()
    rj = jd.solver(method="fgmres", max_iterations=60, tolerance=1e-8,
                   precond=jp)(f)
    assert bool(rt.converged) and bool(rj.converged)
    assert rt.iterations == int(rj.iterations) == 7
    assert np.allclose(rt.residual_history.numpy()[:7],
                       np.asarray(rj.residual_history)[:7],
                       rtol=1e-9, atol=0.0)
    assert (rt.u - torch.as_tensor(np.array(u_star))).abs().max() < 1e-6
    # CPU tensors run the plain twins of K1 and K2, never a kernel
    assert c["stiffness_lattice_3d"] == {} and c["lattice_face_sum_3d"] == {}
    assert c["stiffness_lattice_3d_plain"]["float64"] > 0
    assert c["lattice_face_sum_3d_plain"]["float64"] > 0


def test_gate4_one_shard_bf16_matches_reference():
    # __graft_entry__.dryrun_multichip's gate 4 at P = 1: f32 outer
    # FGMRES to 1e-6 with a bf16 Z basis, the bf16 fem-amg hierarchy.
    # The JAX package sums bf16 SpMV products in bf16, the port in f32
    jd, td, jp, tp, u_star, f = _pair((2, 2, 17), 3, 2, jnp.float32,
                                      torch.float32, jnp.bfloat16,
                                      torch.bfloat16,
                                      extent=(1.0, 1.0, 8.5))
    tree = tp.extra["amg"]
    assert tree["levels"][0]["A"].route == "segment_sum"
    assert tree["Q"].dtype == tree["coarse_inv"].dtype == torch.bfloat16
    rj = jd.solver(method="fgmres", max_iterations=200, tolerance=1e-6,
                   precond=jp, z_dtype=jnp.bfloat16)(f)
    rt = td.solver(method="fgmres", max_iterations=200, tolerance=1e-6,
                   precond=tp, z_dtype=torch.bfloat16)(
        torch.as_tensor(np.array(f)))
    assert bool(rt.converged) and bool(rj.converged)
    assert abs(rt.iterations - int(rj.iterations)) <= 1, (
        rt.iterations, int(rj.iterations))
    u = np.asarray(u_star)
    assert np.abs(np.asarray(rj.u) - u).max() < 1e-3
    assert np.abs(rt.u.double().numpy() - u).max() < 1e-3


def test_femamg_setup_stages_and_refusals():
    tm = tg.kershaw_mesh((2, 2, 4), 2, device="cpu")
    td = TDomain(tpartition(tm, 1), dtype=torch.float32, device="cpu")
    mk = partial(tg.kershaw_mesh, (2, 2, 4), device="cpu")
    pre = tsub.composite_dd(td, mk, poly_reduction=1, fine_mesh=tm,
                            inner="fem-amg", far_coarsen="auto")
    assert set(pre.extra["setup_seconds"]) == {
        "p1_assembly", "plane_fold", "galerkin_chain", "pack"}
    tree = pre.extra["amg"]
    # the hierarchy is packed in the ptype (the domain's f32 here)
    assert tree["levels"][0]["A"].route == "sparse_csr"
    assert tree["Q"].shape == (tm.num_points, tree["levels"][0]["A"].shape[0])
    u = td.initial_function(4, seed=0)
    res = td.solver(method="fgmres", max_iterations=50, precond=pre)(
        td.manufacture_rhs(u))
    assert bool(res.converged)
    # one shard's composite has no far field to compress
    with pytest.raises(ValueError):
        tsub.composite_dd(td, mk, poly_reduction=1, fine_mesh=tm,
                          inner="fem-amg", far_coarsen=2)
    # two shards: one hierarchy per shard, packed block-diagonal, builds
    # and converges (slabs of 4 layers)
    tm8 = tg.kershaw_mesh((2, 2, 8), 2, device="cpu")
    two = TDomain(tpartition(tm8, 2), dtype=torch.float32, device="cpu")
    pre = tsub.composite_dd(two, partial(tg.kershaw_mesh, (2, 2, 8),
                                         device="cpu"),
                            poly_reduction=1, fine_mesh=tm8,
                            inner="fem-amg")
    assert pre.extra["amg"]["shards"] == 2
    res = two.solver(method="fgmres", max_iterations=50, precond=pre)(
        two.manufacture_rhs(two.initial_function(4, seed=0)))
    assert bool(res.converged)
