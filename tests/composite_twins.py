"""Shared helpers of the composite's CPU twins (tests/
test_torch_composite_*.py): the same problem in both packages, the JAX
composite's tree_rhs under shard_map, and the f64 check of one
configuration (tree_rhs, one preconditioner application, the outer
FGMRES) that several files run on their own configurations."""

from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import domain as jdomain_mod
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as jsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import subdomain as tsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for the test module that imports this
    fixture, put back after it: the port's CPU tensors in these tests are
    small, and a pool of a thread a core made them several times slower
    and took the cores from the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the ragged box of tests/test_ragged.py: 8 layers, isotropic elements
BOX = partial(jg.box_mesh, (2, 2, 8), extent=(1.0, 1.0, 4.0))
KERSHAW2216 = partial(jg.kershaw_mesh, (2, 2, 16), epsilon=0.3)
EPS16 = 16 * np.finfo(np.float64).eps


def port_mesh(m):
    return tg.GlobalMesh.from_numpy(
        coords=m.coords, geom=m.geom, dirichlet_mask=m.dirichlet_mask,
        node_degree=m.node_degree, elem_shape=m.elem_shape,
        poly_degree=m.poly_degree, mass=m.mass)


def pair(jb, N, Pn, seed):
    """The order-N mesh of the builder jb over Pn shards in both packages
    (f64), u* = initial_function(4, seed) and its right-hand side."""
    jm = jb(N)
    tm = port_mesh(jm)
    jd = JDomain(jpartition(jm, Pn), dtype=jnp.float64,
                 device_mesh=jax.make_mesh((Pn,), ("shard",)))
    td = TDomain(tpartition(tm, Pn), dtype=torch.float64, device="cpu")
    u = jd.initial_function(4, seed=seed)
    f = jd.manufacture_rhs(u)
    return jm, tm, jd, td, u, f


def composites(jb, jm, tm, jd, td, **kw):
    return (jsub.composite_dd(jd, jb, fine_mesh=jm, **kw),
            tsub.composite_dd(td, lambda o: port_mesh(jb(o)), fine_mesh=tm,
                              **kw))


def jax_tree_rhs(jd, jp, r):
    """The JAX composite's tree_rhs under shard_map: its G parts, each
    stacked over the shards as (P, rows, My, Mx)."""
    ax = jd.axis_name
    specs = jp.extra_specs(ax)

    def impl(arrays, extra, r):
        arrays = jdomain_mod._squeeze_shard(arrays)
        fn = jp.build(arrays, jd._squeeze_extra(extra, specs),
                      jd._ops(arrays))
        return [part[None] for part in fn.parts["tree_rhs"](r[0])]

    fn = jax.jit(jax.shard_map(
        impl, mesh=jd.device_mesh,
        in_specs=(jdomain_mod._specs(ax, jd.arrays), specs, P(ax)),
        out_specs=P(ax)))
    return [np.asarray(p) for p in fn(jd.arrays, jp.extra, r)]


def check_tree_rhs(jd, td, jp, tp, f, exact_orders, eps=EPS16):
    """tree_rhs per shard: groups at an order in exact_orders (slices and
    shifts of the residual, or restricted by an exact cascade) bitwise,
    the others within eps of max (16 eps by default; ROADMAP section
    3)."""
    got = tp.build(td.arrays, tp.extra, td._ops()).parts["tree_rhs"](
        torch.as_tensor(np.array(f)))
    want = jax_tree_rhs(jd, jp, f)
    assert len(got) == len(want) == len(tp.extra["specs"])
    for g, w, spec in zip(got, want, tp.extra["specs"]):
        assert g.shape == w.shape
        if spec.order in exact_orders:
            assert np.array_equal(g.numpy(), w), np.abs(g.numpy() - w).max()
        else:
            assert np.abs(g.numpy() - w).max() <= eps * np.abs(w).max()


def check_probe(jd, td, jp, tp, f, groups=None):
    """One preconditioner application within 1e-12 of max, its inner
    histories (the max over the shards, as the JAX package's
    precond_probe reports them) within 1e-10; with ``groups``, every
    group's operator one (plain twin) K1 call over all shards."""
    jz, jh = jd.precond_probe(jp)(f)
    kernels.reset_counts()
    tz, th = td.precond_probe(tp)(torch.as_tensor(np.array(f)))
    jz, jh = np.asarray(jz), np.asarray(jh)
    assert np.abs(tz.numpy() - jz).max() <= 1e-12 * np.abs(jz).max()
    np.testing.assert_allclose(th.numpy(), jh, rtol=1e-10, atol=0.0)
    if groups is not None:
        c = kernels.counts()
        assert c["stiffness_lattice_3d_plain"]["float64"] % groups == 0
        assert c["stiffness_lattice_3d"] == {}


def solve_both(jd, td, jp, tp, f, tol=1e-8, maxit=150):
    rj = jd.solver(method="fgmres", max_iterations=maxit, tolerance=tol,
                   precond=jp)(f)
    rt = td.solver(method="fgmres", max_iterations=maxit, tolerance=tol,
                   precond=tp)(torch.as_tensor(np.array(f)))
    assert bool(rj.converged) and bool(rt.converged)
    return rj, rt


def check_outer(rj, rt, steps, u=None, max_err=None):
    """Equal outer counts, histories at rtol 1e-9 over the first steps."""
    assert rt.iterations == int(rj.iterations)
    np.testing.assert_allclose(rt.residual_history.numpy()[:steps + 1],
                               np.asarray(rj.residual_history)[:steps + 1],
                               rtol=1e-9)
    if u is not None:
        assert np.abs(rt.u.numpy() - np.asarray(u)).max() < max_err


def check_kershaw2216_p8(far_coarsen, groups):
    """Kershaw (2, 2, 16) N=3 r=2 over 8 shards (tests/
    test_composite_dd.py's 3-D case): tree_rhs, one application, lmax0 and
    the outer FGMRES to 1e-8. The outer f64 histories agree to ~1e-10
    over the first 16 steps and then drift ~3x a step (ROADMAP section
    3): far_coarsen 2 is 2.8e-10 apart at step 18 and 1.0e-9 at step 20
    of 36, far_coarsen 1 6.3e-10 at step 24 of 34; the counts agree."""
    jm, tm, jd, td, u, f = pair(KERSHAW2216, 3, 8, seed=5)
    jp, tp = composites(KERSHAW2216, jm, tm, jd, td, poly_reduction=2,
                        far_coarsen=far_coarsen)
    specs = tp.extra["specs"]
    assert len(specs) == groups
    assert max(g.zcoarse for g in specs) == (2 if far_coarsen == "auto"
                                             else 1)
    np.testing.assert_allclose(
        tp.extra["amg"]["lmax0"].reshape(-1).numpy(),
        np.asarray(jp.extra["amg"]["lmax0"]).reshape(-1), rtol=1e-12)
    # the own slab and the order-3 rings are slices and shifts of the
    # residual; the order-1 parts pass the restriction cascade (J^T sums 4
    # rounded products a point, in XLA's order in the JAX package and in
    # torch's in the port) and, z-merged, Rzfar: 5.1 eps of max measured
    check_tree_rhs(jd, td, jp, tp, f, exact_orders={3})
    check_probe(jd, td, jp, tp, f, groups=groups)
    rj, rt = solve_both(jd, td, jp, tp, f, maxit=100)
    check_outer(rj, rt, 16, u=u, max_err=1e-6)


# ---- the 2-D twins (tests/test_torch_2d_composite*.py) ----

_K12 = ("stiffness_lattice_3d", "stiffness_lattice_3d_plain",
        "lattice_face_sum_3d", "lattice_face_sum_3d_plain")


def pair2d(shape, N, P, seed):
    """The 2-D Kershaw eps=0.3 mesh of ``shape`` at order N over P shards
    in both packages (f64; the JAX package's single-device Domain at P =
    1), its builder, u* = initial_function(4, seed) and its right-hand
    side."""
    jb = partial(jg.kershaw_mesh, shape, epsilon=0.3)
    jm = jb(N)
    tm = port_mesh(jm)
    kw = {} if P == 1 else {"device_mesh": jax.make_mesh((P,), ("shard",))}
    jd = JDomain(jpartition(jm, P), dtype=jnp.float64, **kw)
    td = TDomain(tpartition(tm, P), dtype=torch.float64, device="cpu")
    u = jd.initial_function(4, seed=seed)
    f = jd.manufacture_rhs(u)
    return jb, jm, tm, jd, td, u, f


def history(res):
    """A solve's residual history up to its last iteration, numpy."""
    h = res.residual_history
    h = h.numpy() if isinstance(h, torch.Tensor) else np.asarray(h)
    return h[:int(res.iterations) + 1]


def solve_one(dom, pre, f, method="fgmres", tol=1e-8, maxit=150):
    """One outer solve of the JAX field f on either package's Domain."""
    if isinstance(dom, TDomain):
        f = torch.as_tensor(np.array(f))
    return dom.solver(method=method, max_iterations=maxit, tolerance=tol,
                      precond=pre)(f)


def no_k12():
    """Neither K1 nor K2 (nor their plain twins) ran since the counts
    were last reset."""
    c = kernels.counts()
    return all(not c[k] for k in _K12)
