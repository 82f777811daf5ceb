"""The port's multi-shard composite (solvers/subdomain.composite_dd at
P > 1 through runtime/comm.LocalComm, plain twins on the CPU) against the
JAX package's shard_map composite on the 8-device CPU mesh of
tests/conftest.py, in f64: the 3-D case of tests/test_composite_dd.py
(Kershaw (2, 2, 16) N=3 r=2 at P = 8, far field z-merged by 2; the fine
far field is tests/test_torch_composite_fine_far.py), the rank-local
batched Krylov solves of the inner problem, and the guards the JAX
package raises. Helpers: tests/composite_twins.py."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as jsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import krylov
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import subdomain as tsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain

from composite_twins import (KERSHAW2216, check_kershaw2216_p8, check_outer,
                             check_probe, check_tree_rhs, composites, pair,
                             port_mesh, solve_both)
from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def test_composite_p8_matches_reference():
    # G = 8: own slab (order 3, 2 layers), rings of orders 3 and 1, fine
    # far overlaps of 2 layers and 3 far layers merged by 2
    check_kershaw2216_p8("auto", 8)


def test_composite_p8_order7_matches_reference():
    # the main configuration's order jump, N=7 r=6 (rings of orders 7 and
    # 1, J (x) J from 8 points to 2, the 7 -> 1 cascade), over 8 shards
    # of Kershaw (2, 2, 16): the groups of the 16^3 P = 8 composite.
    # The order-1 parts restrict 8 rounded products a point (38.9 eps of
    # max measured on the merged far field). The outer f64 histories agree
    # to 3.4e-11 over the first 9 steps, then part by ~10x a step (2.4e-10
    # at step 10, 2.2e-8 at 13); neither package reaches 1e-8 in 300
    # iterations here (ROADMAP section 3), so the counts are compared at
    # 2.5e-3, which both reach at step 9 (2.377e-3; 2.793e-3 at step 8)
    jm, tm, jd, td, u, f = pair(KERSHAW2216, 7, 8, seed=5)
    jp, tp = composites(KERSHAW2216, jm, tm, jd, td, poly_reduction=6)
    assert [(g.order, g.layers, g.zcoarse) for g in tp.extra["specs"]] == [
        (7, 2, 1), (7, 1, 1), (1, 1, 1), (1, 2, 1), (1, 3, 2), (1, 2, 1),
        (1, 1, 1), (7, 1, 1)]
    check_tree_rhs(jd, td, jp, tp, f, exact_orders={7},
                   eps=64 * np.finfo(np.float64).eps)
    check_probe(jd, td, jp, tp, f, groups=8)
    rj, rt = solve_both(jd, td, jp, tp, f, tol=2.5e-3, maxit=20)
    assert rt.iterations == 9
    check_outer(rj, rt, 9)


def _stack_problem(P, seed=0):
    """P different SPD problems on a two-leaf field ((P, 3, 4), (P, 5)):
    per-shard matrices A_p of widely different scales, applied as one
    bmm on the concatenated leaves."""
    rng = np.random.default_rng(seed)
    n = 17
    mats = []
    for p in range(P):
        B = rng.standard_normal((n, n))
        mats.append((B @ B.T + n * np.eye(n)) * 10.0 ** (p - P // 2))
    A = torch.as_tensor(np.stack(mats))
    f = [torch.as_tensor(rng.standard_normal((P, 3, 4))),
         torch.as_tensor(rng.standard_normal((P, 5)))]
    invd = torch.as_tensor(np.stack([1.0 / np.diag(m) for m in mats]))

    def join(x):
        return torch.cat([x[0].reshape(x[0].shape[0], -1), x[1]], dim=1)

    def split(v):
        return [v[:, :12].reshape(-1, 3, 4), v[:, 12:]]

    return A, f, invd, join, split


@pytest.mark.parametrize("method", ["fgmres", "fcg"])
def test_batched_krylov_is_rank_local(method):
    # the rank-local inner solve on a P-stack equals P one-shard solves;
    # dots summed across the shards make another (coupled) solve
    Pn, its = 5, 6
    A, f, invd, join, split = _stack_problem(Pn)
    ident = lambda x: x

    def run(Ap, fp, dp, dot, batched):
        op = lambda x: split(torch.bmm(Ap, join(x)[..., None])[..., 0])
        pre = lambda x: split(join(x) * dp)
        dot2 = lambda a, b, c, d: (dot(a, b), dot(c, d))
        kw = dict(max_iterations=its, tolerance=0.0, batched=batched)
        if method == "fcg":
            res = krylov.fcg(op, pre, ident, dot, dot2, fp, **kw)
        else:
            res = krylov.fgmres(op, pre, ident, dot, fp, num_vectors=4,
                                **kw)
        return join(res.u), res.residual_history

    ub, hb = run(A, f, invd, krylov.shard_dot, True)
    assert hb.shape == (its + 1, Pn)
    for p in range(Pn):
        fp = [x[p:p + 1] for x in f]
        up, hp = run(A[p:p + 1], fp, invd[p:p + 1], krylov.tree_dot, False)
        assert (ub[p] - up[0]).abs().max() <= 1e-13 * up.abs().max()
        np.testing.assert_allclose(hb[:, p].numpy(), hp.numpy(), rtol=1e-13)
    def coupled(a, b):
        d = krylov.shard_dot(a, b)
        return d.sum(-1, keepdim=True).expand_as(d)

    uc, _ = run(A, f, invd, coupled, True)
    gap = max(((uc[p] - ub[p]).abs().max() / ub[p].abs().max()).item()
              for p in range(Pn))
    assert gap > 1e-3, gap


@pytest.mark.parametrize("seed,neg,breakdowns", [(0, 1.0, False),
                                                 (1, 2.0, True)])
def test_batched_fgmres_matches_reference_restarts(seed, neg, breakdowns):
    # the JAX package's fgmres under shard_map with a rank-local dot: per
    # shard, a cycle ends at a full basis (m = 3 of 7 steps) or at a
    # breakdown (alpha = 0: an indefinite "dssum" drives <q, D q> below
    # 0 on the odd shards, as the composite's can at order 7 against 1)
    # and restarts from the shard's fresh residual; the lockstep batched
    # solve must give the same histories and solutions
    Pn, n, T, m = 4, 13, 7, 3
    rng = np.random.default_rng(seed)
    A, D = [], np.ones((Pn, n))
    for p in range(Pn):
        B = rng.standard_normal((n, n))
        A.append(B @ B.T + n * np.eye(n))
        if p % 2:
            D[p, rng.choice(n, 1, replace=False)] = -neg
    A = np.stack(A)
    f = rng.standard_normal((Pn, n))
    invd = 1.0 / np.stack([np.diag(a) for a in A])
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import krylov as jkrylov

    def impl(A, D, f, invd):
        A, D, f, invd = A[0], D[0], f[0], invd[0]
        res = jkrylov.fgmres(lambda x: A @ x, lambda x: invd * x,
                             lambda x: D * x, jkrylov.tree_dot, f,
                             max_iterations=T, num_vectors=m,
                             tolerance=0.0)
        return res.u[None], res.residual_history[None]

    fn = jax.jit(jax.shard_map(
        impl, mesh=jax.make_mesh((Pn,), ("shard",)),
        in_specs=(P("shard"),) * 4, out_specs=(P("shard"), P("shard"))))
    ju, jh = (np.asarray(x) for x in fn(A, D, f, invd))
    At, Dt, ft, it = (torch.as_tensor(x) for x in (A, D, f, invd))
    res = krylov.fgmres(
        lambda x: torch.bmm(At, x[..., None])[..., 0], lambda x: it * x,
        lambda x: Dt * x, krylov.shard_dot, ft, max_iterations=T,
        num_vectors=m, tolerance=0.0, batched=True)
    th = res.residual_history.numpy().T
    assert ((jh[:, 1:] == 0).any()) == breakdowns
    assert np.array_equal(np.isnan(th), np.isnan(jh))
    np.testing.assert_allclose(np.nan_to_num(th), np.nan_to_num(jh),
                               rtol=1e-10, atol=0.0)
    assert np.abs(res.u.numpy() - ju).max() <= 1e-13 * np.abs(ju).max()


@pytest.mark.parametrize("inner_solver", ["fgmres", "fcg"])
def test_one_shard_inner_solve_restarts_at_breakdown(inner_solver):
    # the composite's inner solve at P = 1 runs the rank-local batched
    # path on the (1, ...) stack of the one shard: an indefinite "dssum"
    # drives <q, D q> to 0 at step 5 of 7 (a full-length basis, so only a
    # breakdown ends the cycle); the JAX package's one-device fgmres ends
    # the cycle there, adds its correction and restarts, and so must the
    # port; FCG runs the same count with the same scalars
    n, T = 13, 7
    rng = np.random.default_rng(1)
    B = rng.standard_normal((n, n))
    A = B @ B.T + n * np.eye(n)
    D = np.ones(n)
    D[rng.choice(n, 1, replace=False)] = -2.0
    f = rng.standard_normal(n)
    invd = 1.0 / np.diag(A)
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import krylov as jkrylov
    jargs = (lambda x: A @ x, lambda x: invd * x, lambda x: D * x,
             jkrylov.tree_dot)
    if inner_solver == "fcg":
        jr = jkrylov.fcg(*jargs, lambda a, b, c, d: (jkrylov.tree_dot(a, b),
                                                     jkrylov.tree_dot(c, d)),
                         jnp.asarray(f), max_iterations=T, tolerance=0.0)
    else:
        jr = jkrylov.fgmres(*jargs, jnp.asarray(f), max_iterations=T,
                            num_vectors=T, tolerance=0.0)
    jh, ju = np.asarray(jr.residual_history), np.asarray(jr.u)
    At, Dt, it = (torch.as_tensor(x) for x in (A, D, invd))
    one = lambda fn: lambda parts: [fn(parts[0])]
    res = tsub._rank_local_solve(
        one(lambda x: (At @ x[0])[None]), one(lambda x: it * x),
        one(lambda x: Dt * x), [torch.as_tensor(f)[None]], inner_solver, T)
    th = res.residual_history[:, 0].numpy()
    if inner_solver == "fgmres":
        assert (jh[1:] == 0).any()           # the breakdown happened
    np.testing.assert_allclose(th, jh, rtol=1e-10, atol=0.0)
    assert np.abs(res.u[0][0].numpy() - ju).max() <= 1e-13 * np.abs(ju).max()


def test_shard_dot_is_per_shard():
    rng = np.random.default_rng(1)
    a = [torch.as_tensor(rng.standard_normal((4, 3, 5))),
         torch.as_tensor(rng.standard_normal((4, 7)))]
    b = [torch.as_tensor(rng.standard_normal((4, 3, 5))),
         torch.as_tensor(rng.standard_normal((4, 7)))]
    want = np.array([a[0][p].flatten() @ b[0][p].flatten()
                     + a[1][p] @ b[1][p] for p in range(4)])
    np.testing.assert_allclose(krylov.shard_dot(a, b).numpy(), want,
                               rtol=1e-14)
    # a stacked basis prefix (k, P, ...) against a field: (k, P)
    V = [torch.stack([a[0], 2 * a[0]]), torch.stack([a[1], 2 * a[1]])]
    got = krylov.shard_dot(V, b).numpy()
    np.testing.assert_allclose(got, np.stack([want, 2 * want]), rtol=1e-14)
    # batched solves run a fixed count
    with pytest.raises(ValueError):
        krylov.fgmres(None, None, None, None, a, max_iterations=2,
                      tolerance=1e-3, batched=True)


def _doms(shape, N, Pn):
    jb = lambda o: jg.box_mesh(shape, o, extent=(1.0, 1.0, shape[2] / 2))
    jm = jb(N)
    tm = port_mesh(jm)
    dm = jax.make_mesh((Pn,), ("shard",)) if Pn > 1 else None
    jd = JDomain(jpartition(jm, Pn), dtype=jnp.float64, device_mesh=dm)
    td = TDomain(tpartition(tm, Pn), dtype=torch.float64, device="cpu")
    return jb, jm, tm, jd, td


@pytest.mark.parametrize("shape,N,Pn,kw,match", [
    # a shard with no element layer
    ((2, 2, 3), 2, 4, {"poly_reduction": 1}, "every shard"),
    # slabs of 1 layer under rings of 2 (orders 3, 1)
    ((2, 2, 8), 3, 8, {"poly_reduction": 2}, "ring depth"),
    # ragged slabs 3, 2, 2 leave no far layer beside the largest
    ((2, 2, 7), 2, 3, {"poly_reduction": 1}, "uneven slabs"),
    # z-merging the far field of ragged slabs
    ((2, 2, 9), 2, 4, {"poly_reduction": 1, "far_coarsen": 2},
     "far_coarsen > 1"),
    # z-merging under the assembled fem-amg hierarchy
    ((2, 2, 16), 3, 8, {"poly_reduction": 2, "far_coarsen": 2,
                        "inner": "fem-amg"}, "inner='amg'"),
    # a factor that does not divide the slab
    ((2, 2, 16), 3, 8, {"poly_reduction": 2, "far_coarsen": 4},
     "must divide"),
    # aligned, but no merged layer is left between the fine overlaps
    ((2, 2, 16), 2, 4, {"poly_reduction": 1, "subdomain_overlap": 2,
                        "far_coarsen": 4}, "misaligned"),
])
def test_guards_raise_as_reference(shape, N, Pn, kw, match):
    jb, jm, tm, jd, td = _doms(shape, N, Pn)
    tb = lambda o: port_mesh(jb(o))
    with pytest.raises(ValueError, match=match):
        jsub.composite_dd(jd, jb, fine_mesh=jm, **kw)
    with pytest.raises(ValueError, match=match):
        tsub.composite_dd(td, tb, fine_mesh=tm, **kw)


def test_one_shard_has_no_far_field_to_compress():
    tm = tg.box_mesh((2, 2, 4), 2, device="cpu")
    td = TDomain(tpartition(tm, 1), dtype=torch.float64, device="cpu")
    mk = lambda o: tg.box_mesh((2, 2, 4), o, device="cpu")
    with pytest.raises(ValueError, match="no far field"):
        tsub.composite_dd(td, mk, poly_reduction=1, fine_mesh=tm,
                          far_coarsen=2)
