"""The port's 2-D unstructured composite against the JAX package (CPU,
f64): ``composite_dd`` on a generic partition of a scrambled 2-D mesh,
where both packages assemble each order class by scatter and gather (the
JAX package builds face plans only in 3-D).

- tests/test_unstructured.py::test_unstructured_2d_composite (scrambled
  Kershaw (6, 6), order 4, seed 4, r = 3, inner "amg", FGMRES to 1e-8) at
  P = 4, and at P = 1: equal counts, the f64 histories at rtol 1e-9 over
  the prefix that round-off allows (ROADMAP section 3: all 11 steps at P
  = 1, 15 of 16 at P = 4);
- the other inners on the same problem: "jacobi", "none" and "fem-amg"
  (the JAX package runs each of them in 2-D; the compressed far field is
  tests/test_torch_2d_unstructured_far.py), over the prefixes of ROADMAP
  section 3 (every step but fem-amg's last two at P = 1);
- the 2-D ``setup_cache`` round trip: a cached build reads no mesh and
  gives the fresh build's history bit for bit.

The JAX mesh crosses to the port whole (its node ids, coordinates and
geometry), since the port's 2-D geometry equals the JAX package's numpy
form and not its XLA form (ROADMAP section 3)."""

import os

import numpy as np
import pytest
import torch
import jax
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


def port_mesh_whole(m):
    """The JAX package's mesh as the port's, every array as it is (node
    ids included: a scrambled mesh has no slab order to rebuild them
    from)."""
    return tg.GlobalMesh(
        dim=m.dim, poly_degree=m.poly_degree,
        elem_shape=tuple(int(x) for x in m.elem_shape),
        coords=np.asarray(m.coords), glo_num=np.asarray(m.glo_num, np.int64),
        node_degree=np.asarray(m.node_degree, np.int32),
        dirichlet_mask=np.asarray(m.dirichlet_mask, np.float64),
        geom=np.asarray(m.geom), mass=np.asarray(m.mass),
        structured_layout=bool(m.structured_layout))


def scrambled(shape, seed, permute=True):
    def jb(o):
        return jg.scramble_mesh(jg.kershaw_mesh(shape, o, epsilon=0.3),
                                seed=seed, permute=permute)
    return jb, lambda o: port_mesh_whole(jb(o))


TEST_MESH = scrambled((6, 6), 4)           # test_unstructured_2d_composite


def run_both(builders, N, P, maxit=100, **kw):
    """Both packages' composites on the order-N mesh over P shards, f64
    FGMRES to 1e-8 from u* = initial_function(4, seed=2); returns (JAX
    result, port result, port domain, port u*)."""
    jb, tb = builders
    jm = jb(N)
    tm = port_mesh_whole(jm)
    dm = jax.make_mesh((P,), ("shard",)) if P > 1 else None
    jd = JDomain(jpartition(jm, P), dtype=jnp.float64, device_mesh=dm)
    td = TDomain(tpartition(tm, P), dtype=torch.float64, device="cpu")
    assert td.sharded.structured is None and td.arrays.gs is not None
    jf = jd.manufacture_rhs(jd.initial_function(4, seed=2))
    tu = td.initial_function(4, seed=2)
    tf = td.manufacture_rhs(tu)
    jp = jsub.composite_dd(jd, jb, fine_mesh=jm, **kw)
    kernels.reset_counts()
    tp = tsub.composite_dd(td, tb, fine_mesh=tm, **kw)
    solve = dict(method="fgmres", max_iterations=maxit, tolerance=1e-8)
    rj = jd.solver(precond=jp, **solve)(jf)
    rt = td.solver(precond=tp, **solve)(tf)
    # the 2-D path reaches no 3-D kernel
    assert not any(v for k, v in kernels.counts().items()
                   if "stiffness" in k or "face_sum" in k)
    return rj, rt, td, tu


def same_history(rj, rt, steps):
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged) == bool(rj.converged)
    hj = np.asarray(rj.residual_history)[:steps + 1]
    ht = rt.residual_history.numpy()[:steps + 1]
    np.testing.assert_allclose(ht, hj, rtol=1e-9)


@pytest.mark.parametrize("P,steps", [(1, 11), (4, 15)])
def test_2d_unstructured_composite_matches_reference(P, steps):
    rj, rt, td, tu = run_both(TEST_MESH, 4, P, poly_reduction=3,
                              inner="amg")
    same_history(rj, rt, steps)
    assert bool(rt.converged) and rt.iterations <= 30
    assert (rt.u - tu).abs().max() < 1e-6


@pytest.mark.parametrize("inner,P,steps,maxit", [
    ("jacobi", 4, 73, 100), ("none", 1, 30, 30), ("fem-amg", 1, 20, 100),
    ("fem-amg", 4, 15, 100)])
def test_2d_inners_match_reference(inner, P, steps, maxit):
    rj, rt, _, _ = run_both(TEST_MESH, 4, P, maxit=maxit, poly_reduction=3,
                            inner=inner)
    same_history(rj, rt, steps)


def test_2d_setup_cache_round_trip(tmp_path):
    _, tb = TEST_MESH
    tm = tb(4)
    td = TDomain(tpartition(tm, 4), dtype=torch.float64, device="cpu")
    f = td.manufacture_rhs(td.initial_function(4, seed=2))
    cache = str(tmp_path / "usetup2d.npz")

    def no_builder(order):
        raise AssertionError("a cached setup builds no mesh")

    def hist(pre):
        res = td.solver(method="fgmres", max_iterations=60, tolerance=1e-8,
                        precond=pre)(f)
        assert bool(res.converged)
        return res.residual_history.numpy()

    for inner in ("amg", "fem-amg"):
        fresh = tsub.composite_dd(td, tb, poly_reduction=3, inner=inner,
                                  fine_mesh=tm, chain_cache=cache)
        assert os.path.exists(cache)
        loaded = tsub.composite_dd(td, no_builder, poly_reduction=3,
                                   inner=inner, chain_cache=cache)
        assert "load" in loaded.extra["setup_seconds"]
        assert loaded.extra["regions"] == fresh.extra["regions"]
        assert np.array_equal(hist(fresh), hist(loaded), equal_nan=True)
        os.remove(cache)
