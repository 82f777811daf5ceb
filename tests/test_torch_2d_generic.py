"""The port's generic 2-D route against the JAX package (CPU, f64): the
element-layout Domain on a ``structured=False`` partition, whose dssum
is the generic gather / scatter dssum (ops/gather_scatter.dssum; the
JAX package builds face-block plans only in 3-D).

- the 2-D cases of tests/test_dssum_paths.py::
  test_structured_matches_generic: Kershaw eps=0.4 (3, 4) N=3 and (5, 2)
  N=2 at P = 1 and 8, plain, weighted and unmasked; the port's generic
  dssum against the JAX package's generic dssum and against the port's
  structured dssum, at 1e-13;
- ::test_structured_solve_matches_generic in 2-D: FCG to 1e-10 on
  Kershaw (4, 4) N=4 over 8 shards, the histories at rtol 1e-9 over the
  first 10 steps (against the JAX package's generic run and the port's
  structured run), and Jacobi, FCG and FGMRES on the generic route at P
  = 1 and 4 against the JAX package's;
- the generic dssum's scatter-adds are ordered (no atomic scatter): the
  same bits as the CPU's sequential ``scatter_add_`` in f32 and f64,
  the same on a second call, and a bf16 field summed in f32 and rounded
  once."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import preconditioners as jpre
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import gather_scatter as tgs
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.comm import LocalComm
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import preconditioners as tpre
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain

from composite_twins import one_torch_thread, port_mesh  # noqa: F401 (autouse)


def jdomain(jm, P, structured):
    kw = {} if P == 1 else {"device_mesh": jax.make_mesh((P,), ("shard",))}
    return JDomain(jpartition(jm, P, structured=structured),
                   dtype=jnp.float64, **kw)


def tdomain(tm, P, structured, dtype=torch.float64):
    return TDomain(tpartition(tm, P, structured=structured), dtype=dtype,
                   device="cpu")


def pack(dom, vals):
    """Global element-ordered point values -> the domain's device field."""
    sd = dom.sharded
    npe = sd.num_points_per_elem
    buf = np.zeros((sd.num_shards, sd.elems_per_shard * npe))
    k = 0
    for p in range(sd.num_shards):
        m = int(sd.elem_valid[p].sum()) * npe
        buf[p, :m] = vals[k:k + m]
        k += m
    return dom.to_device_field(buf)


def unpack(dom, u):
    sd = dom.sharded
    npe = sd.num_points_per_elem
    u = np.asarray(dom.from_device_field(u)).reshape(sd.num_shards, -1)
    return np.concatenate([u[p, :int(sd.elem_valid[p].sum()) * npe]
                           for p in range(sd.num_shards)])


def hist(res):
    h = res.residual_history
    h = h.numpy() if isinstance(h, torch.Tensor) else np.asarray(h)
    return h[:int(res.iterations) + 1]


@pytest.mark.parametrize("kw", [dict(), dict(apply_weight=True),
                                dict(apply_mask=False)])
@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("shape,N", [((3, 4), 3), ((5, 2), 2)])
def test_generic_dssum_matches_reference(shape, N, P, kw):
    jm = jg.kershaw_mesh(shape, N, 0.4)
    tm = port_mesh(jm)
    vals = np.random.default_rng(0).random(jm.num_points)
    tg_ = tdomain(tm, P, False)
    assert tg_.sharded.structured is None and tg_.arrays.gs is not None
    ts = tdomain(tm, P, True)
    jd = jdomain(jm, P, False)
    kernels.reset_counts()
    got = unpack(tg_, tg_.dssum_field(pack(tg_, vals), **kw))
    assert not any(kernels.counts().values())     # no 3-D kernel in 2-D
    ref = unpack(jd, jd.dssum_field(pack(jd, vals), **kw))
    st = unpack(ts, ts.dssum_field(pack(ts, vals), **kw))
    np.testing.assert_allclose(got, ref, atol=1e-13)
    np.testing.assert_allclose(got, st, atol=1e-13)


def test_generic_solve_matches_reference():
    # tests/test_dssum_paths.py::test_structured_solve_matches_generic:
    # Kershaw (4, 4) N=4, 8 shards, FCG to 1e-10
    jm = jg.kershaw_mesh((4, 4), 4, 0.3)
    tm = port_mesh(jm)
    runs = {}
    for name, dom in (("port generic", tdomain(tm, 8, False)),
                      ("port structured", tdomain(tm, 8, True)),
                      ("jax generic", jdomain(jm, 8, False))):
        f = dom.manufacture_rhs(dom.initial_function(0))
        res = dom.solver(method="fcg", max_iterations=300,
                         tolerance=1e-10)(f)
        assert bool(res.converged), name
        runs[name] = res
    h = hist(runs["port generic"])[:10]
    np.testing.assert_allclose(h, hist(runs["jax generic"])[:10], rtol=1e-9)
    np.testing.assert_allclose(h, hist(runs["port structured"])[:10],
                               rtol=1e-9)
    assert runs["port generic"].iterations == int(
        runs["jax generic"].iterations)


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("method,pre", [("fcg", "jacobi"),
                                        ("fgmres", "jacobi"),
                                        ("fcg", None)])
def test_generic_solvers_match_reference(P, method, pre):
    # the generic route's Domain whole: u*, f = A u*, the residual, and a
    # Jacobi (or unpreconditioned) solve on Kershaw (4, 5) N=3 against the
    # JAX package's generic Domain; histories at rtol 1e-9 over 12 steps
    jm = jg.kershaw_mesh((4, 5), 3, 0.3)
    td, jd = tdomain(port_mesh(jm), P, False), jdomain(jm, P, False)
    tu, ju = td.initial_function(4, seed=5), jd.initial_function(4, seed=5)
    assert np.array_equal(td.from_device_field(tu),
                          np.asarray(jd.from_device_field(ju)))
    tf, jf = td.manufacture_rhs(tu), jd.manufacture_rhs(ju)
    a = np.asarray(jd.from_device_field(jf))
    assert np.abs(td.from_device_field(tf) - a).max() <= 1e-13 * \
        np.abs(a).max()
    z = td.to_device_field(np.zeros(td.points_shape()))
    _, rn = td.residual(z, tf)
    _, jrn = jd.residual(jd.to_device_field(np.zeros(jd.points_shape())),
                         jf)
    assert abs(float(rn) - float(jrn)) <= 1e-12 * float(jrn)
    kw = dict(method=method, max_iterations=500, tolerance=1e-9)
    rt = td.solver(precond=tpre.jacobi(td) if pre else None, **kw)(tf)
    rj = jd.solver(precond=jpre.jacobi(jd) if pre else None, **kw)(jf)
    assert bool(rt.converged) and bool(rj.converged)
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 1
    np.testing.assert_allclose(hist(rt)[:13], hist(rj)[:13], rtol=1e-9)
    assert (rt.u - tu).abs().max() < 1e-6


def test_pmultigrid_raises_on_a_generic_partition_as_the_reference():
    jm = jg.kershaw_mesh((4, 4), 3, 0.3)
    td, jd = tdomain(port_mesh(jm), 1, False), jdomain(jm, 1, False)
    with pytest.raises(NotImplementedError):
        jpre.pmultigrid(jd, lambda o: jg.kershaw_mesh((4, 4), o, 0.3),
                        poly_reduction=2)
    with pytest.raises(NotImplementedError):
        tpre.pmultigrid(td, lambda o: port_mesh(
            jg.kershaw_mesh((4, 4), o, 0.3)), poly_reduction=2)


def _old_scatter(u, gid, nn):
    # the route the ordered scatter replaced: torch's scatter_add_, which
    # the CPU runs in index order
    out = u.new_zeros(u.shape[:-1] + (nn + 1,))
    return out.scatter_add_(-1, gid, u)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [1, 4])
def test_ordered_scatter_is_the_cpu_scatter_bitwise(P, dtype):
    jm = jg.kershaw_mesh((5, 4), 3, 0.3)
    sd = tpartition(port_mesh(jm), P, structured=False)
    rng = np.random.default_rng(1)
    u = torch.as_tensor(rng.standard_normal(sd.gather_ids.shape),
                        dtype=dtype)
    gid = torch.as_tensor(sd.gather_ids, dtype=torch.int64)
    bl = torch.as_tensor(sd.bnode_local, dtype=torch.int64)
    bgl = torch.as_tensor(sd.bnode_global, dtype=torch.int64)
    plans = tgs.generic_plans(sd.gather_ids, sd.bnode_global,
                              sd.num_local_nodes, sd.num_boundary_global,
                              "cpu")
    w = tgs.scatter_to_nodes(u, gid, sd.num_local_nodes, plans["nodes"])
    assert torch.equal(w, _old_scatter(u, gid, sd.num_local_nodes))
    assert torch.equal(w, tgs.scatter_to_nodes(u, gid, sd.num_local_nodes,
                                               plans["nodes"]))
    if P > 1:
        comm = LocalComm(P)
        got = tgs.exchange(w, bl, bgl, sd.num_boundary_global, comm,
                           plans["iface"])
        buf = _old_scatter(torch.gather(w, -1, bl), bgl,
                           sd.num_boundary_global)
        want = w.scatter(-1, bl, comm.psum(buf)[bgl])
        assert torch.equal(got, want)
    kw = dict(gather_ids=gid, mask=torch.as_tensor(sd.dirichlet_mask,
                                                   dtype=dtype),
              inv_degree=torch.as_tensor(sd.inv_degree, dtype=dtype),
              bnode_local=bl, bnode_global=bgl,
              num_local_nodes=sd.num_local_nodes,
              num_boundary_global=sd.num_boundary_global,
              comm=LocalComm(P) if P > 1 else None, apply_weight=True)
    a = tgs.dssum(u, plans=plans, **kw)
    assert torch.equal(a, tgs.dssum(u, plans=plans, **kw))


def test_bf16_nodes_are_summed_in_f32_and_rounded_once():
    jm = jg.kershaw_mesh((5, 4), 3, 0.3)
    sd = tpartition(port_mesh(jm), 4, structured=False)
    gid = torch.as_tensor(sd.gather_ids, dtype=torch.int64)
    # values whose bf16 running sums would round: 1 + many small terms
    u = torch.as_tensor(np.random.default_rng(2).random(gid.shape) * 0.01
                        + 1.0).to(torch.bfloat16)
    plan = tgs.generic_plans(sd.gather_ids, sd.bnode_global,
                             sd.num_local_nodes, sd.num_boundary_global,
                             "cpu")["nodes"]
    w = tgs.scatter_to_nodes(u, gid, sd.num_local_nodes, plan)
    assert w.dtype == torch.bfloat16
    want = tgs.scatter_to_nodes(u.float(), gid, sd.num_local_nodes, plan)
    assert torch.equal(w, want.to(torch.bfloat16))
    # where it shows: 300 ones into one node sum to 300 in f32, where a
    # bf16 running sum (the card's atomic adds) stops at 256 (257 is not a
    # bf16 value)
    ones = torch.ones(1, 300, dtype=torch.bfloat16)
    one_node = torch.zeros(1, 300, dtype=torch.int64)
    assert float(tgs.scatter_to_nodes(
        ones, one_node, 1, tgs.ordered_sum_plan(one_node, 2, "cpu"))[0, 0]
    ) == 300.0
