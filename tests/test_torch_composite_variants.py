"""PyTorch port of the composite DD preconditioner's variants on one
shard (solvers/subdomain.composite_dd: inner "jacobi" and "none", the FCG
inner solver, vertex_iters, chain_cache) vs the JAX package on the CPU in
f64, on Kershaw 4^3 N=3. Both packages get the identical problem."""

from functools import partial

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.runtime import checkpoint as jckpt
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as jsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime import checkpoint as tckpt
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import subdomain as tsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain

from composite_twins import one_torch_thread  # noqa: F401 (autouse)

SHAPE, N, R = (4, 4, 4), 3, 2


def _port_mesh(m):
    return tg.GlobalMesh.from_numpy(
        coords=m.coords, geom=m.geom, dirichlet_mask=m.dirichlet_mask,
        node_degree=m.node_degree, elem_shape=m.elem_shape,
        poly_degree=m.poly_degree, mass=m.mass)


@pytest.fixture(scope="module")
def problem():
    jb = partial(jg.kershaw_mesh, SHAPE, epsilon=0.3)
    jm = jb(N)
    tm = _port_mesh(jm)
    jd = JDomain(jpartition(jm, 1), dtype=jnp.float64)
    td = TDomain(tpartition(tm, 1), dtype=torch.float64, device="cpu")
    u = jd.initial_function(4, seed=0)
    f = jd.manufacture_rhs(u)
    return jd, td, jb, (lambda N_c: _port_mesh(jb(N_c))), jm, tm, f


def _compare(problem, tol, steps, **kw):
    """First inner history, preconditioned residual and the outer FGMRES
    run of both packages for one composite variant: the same iteration
    count to ``tol``, and the history at rtol 1e-9 over its first ``steps``
    steps (all of it if None): under the Jacobi inner preconditioner with
    the FCG inner solver the 1e-16 operator round-off grows to 1.05e-9 by
    the 16th and last outer step."""
    jd, td, jb, tb, jm, tm, f = problem
    jp = jsub.composite_dd(jd, jb, poly_reduction=R, fine_mesh=jm, **kw)
    tp = tsub.composite_dd(td, tb, poly_reduction=R, fine_mesh=tm, **kw)
    ft = torch.as_tensor(np.array(f))
    zj, hj = jd.precond_probe(jp)(f)
    zt, ht = td.precond_probe(tp)(ft)
    assert np.allclose(ht.numpy(), np.asarray(hj), rtol=1e-9, atol=0.0)
    zj = np.asarray(zj)
    assert np.abs(zt.numpy() - zj).max() <= 1e-9 * np.abs(zj).max()
    rj = jd.solver(method="fgmres", max_iterations=200, tolerance=tol,
                   precond=jp)(f)
    rt = td.solver(method="fgmres", max_iterations=200, tolerance=tol,
                   precond=tp)(ft)
    assert bool(rt.converged) and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    k = rt.iterations + 1 if steps is None else steps + 1
    assert np.allclose(rt.residual_history.numpy()[:k],
                       np.asarray(rj.residual_history)[:k],
                       rtol=1e-9, atol=0.0)
    return tp, rt


@pytest.mark.parametrize("kw,tol,steps", [
    ({"inner": "jacobi"}, 1e-6, None),
    ({"inner": "none"}, 1e-6, None),
    ({"inner": "jacobi", "inner_solver": "fcg"}, 1e-6, 10),
    ({"inner": "amg", "inner_solver": "fcg"}, 1e-6, None),
    ({"inner": "amg", "vertex_iters": 4}, 1e-8, None),
    ({"inner": "amg", "far_coarsen": 1, "superdomain_overlap": 2}, 1e-8, None),
], ids=lambda v: "-".join(f"{k}={x}" for k, x in v.items())
    if isinstance(v, dict) else None)
def test_variant_matches_reference(problem, kw, tol, steps):
    tp, rt = _compare(problem, tol, steps, **kw)
    assert ("amg" in tp.extra) == (kw["inner"] == "amg")


def test_jacobi_inner_needs_no_vertex_chain(problem):
    _, td, _, _, _, tm, _ = problem
    # no mesh builder at all: jacobi and none build nothing at order 1
    for inner in ("jacobi", "none"):
        tp = tsub.composite_dd(td, None, poly_reduction=R, inner=inner,
                               fine_mesh=tm)
        assert set(tp.extra) == {"groups"}


def test_chain_cache_round_trip(problem, tmp_path):
    jd, td, jb, tb, jm, tm, f = problem
    path = str(tmp_path / "chain.npz")
    first = tsub.composite_dd(td, tb, poly_reduction=R, fine_mesh=tm,
                              chain_cache=path)
    info = tckpt.load_chain_info(path)
    # the port's checkpoint is the JAX package's format: its loader reads
    # the same chain, and the port loads what the JAX package saves
    jinfo = jckpt.load_chain_info(path)
    assert info["shapes"] == jinfo["shapes"]
    for a, b in zip(info["mats"], jinfo["mats"]):
        assert (a != b).nnz == 0
    assert np.array_equal(info["coarse_inv"], jinfo["coarse_inv"])
    jpath = str(tmp_path / "jchain.npz")
    jsub.composite_dd(jd, jb, poly_reduction=R, fine_mesh=jm,
                      chain_cache=jpath)
    # second build: the cache is read and no order-1 mesh is built
    def no_builder(N_c):
        raise AssertionError("the cached chain must be used")
    ft = torch.as_tensor(np.array(f))
    ref = td.precond_probe(first)(ft)[0]
    for cached in (path, jpath):
        again = tsub.composite_dd(td, no_builder, poly_reduction=R,
                                  fine_mesh=tm, chain_cache=cached)
        for a, b in zip(first.extra["amg"]["chain"]["levels"],
                        again.extra["amg"]["chain"]["levels"]):
            if cached == path:      # its own checkpoint: bitwise
                assert torch.equal(a["coefs"], b["coefs"])
            else:                   # the JAX package's own P1 assembly
                assert torch.allclose(a["coefs"], b["coefs"],
                                      rtol=1e-10, atol=1e-12)
        z = td.precond_probe(again)(ft)[0]
        assert (z - ref).abs().max() <= 1e-10 * ref.abs().max()


def test_new_keywords_reject_what_the_reference_rejects(problem):
    jd, td, jb, tb, jm, tm, _ = problem
    bad = [
        ({"inner_solver": "gmres"}, ValueError),
        ({"far_coarsen": 3}, ValueError),          # 3 divides neither 4 nor 2
        ({"far_coarsen": "coarse"}, ValueError),   # int() of a word
        ({"subdomain_overlap": 3}, ValueError),    # ring depth 6 > 4 layers
    ]
    for kw, exc in bad:
        with pytest.raises(exc):
            jsub.composite_dd(jd, jb, poly_reduction=R, fine_mesh=jm, **kw)
        with pytest.raises(exc):
            tsub.composite_dd(td, tb, poly_reduction=R, fine_mesh=tm, **kw)
    # an aligned factor > 1 on one shard: there is no far field to
    # compress; the reference stops there too, without a message
    with pytest.raises(StopIteration):
        jsub.composite_dd(jd, jb, poly_reduction=R, fine_mesh=jm,
                          far_coarsen=2)
    with pytest.raises(ValueError):
        tsub.composite_dd(td, tb, poly_reduction=R, fine_mesh=tm,
                          far_coarsen=2)
    # the assembled FEM hierarchy builds on one shard; with an aligned
    # far_coarsen > 1 both packages refuse it (it assumes fine layers)
    assert tsub.composite_dd(td, tb, poly_reduction=R, fine_mesh=tm,
                             inner="fem-amg").extra["amg"]["levels"]
    with pytest.raises(ValueError):
        jsub.composite_dd(jd, jb, poly_reduction=R, fine_mesh=jm,
                          inner="fem-amg", far_coarsen=2)
    with pytest.raises(ValueError):
        tsub.composite_dd(td, tb, poly_reduction=R, fine_mesh=tm,
                          inner="fem-amg", far_coarsen=2)
    with pytest.raises(ValueError):
        tsub.composite_dd(td, tb, poly_reduction=R, fine_mesh=tm,
                          inner="ilu")
