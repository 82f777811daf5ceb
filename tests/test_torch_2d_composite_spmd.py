"""The port's 2-D composite DD + polynomial-reduction preconditioner over
several slab shards (solvers/subdomain.composite_dd at P > 1 through
runtime/comm.LocalComm) against the JAX package's shard_map composite on
the 8-device CPU mesh of tests/conftest.py, in f64: Kershaw (4, 16) N=4
r=3 over 8 shards under FGMRES (tests/test_composite_dd.py::
test_composite_dd_spmd_converges; the JAX side runs once, at this its one
2-D shape). The FCG outer, the f32 ptype and the lighter inners over
several shards are tests/test_torch_2d_composite_variants.py, the
one-shard composite tests/test_torch_2d_composite.py. Helpers: tests/
composite_twins.py.

Tolerances: tree_rhs bitwise on the order-N groups and 16 eps of max on
the order-1 ones (``check_tree_rhs``); equal outer counts and the outer f64 histories at rtol
1e-9 over the stated prefix (they part by round-off later, ROADMAP
section 3)."""

import numpy as np
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels

from composite_twins import (check_tree_rhs, composites, history, no_k12,
                             pair2d, solve_one)
from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def test_composite_p8_matches_reference():
    # (4, 16) N=4 r=3 over 8 shards: own slab of 2 rows at order 4, rings
    # of orders 4 and 1, fine far overlaps and 3 far rows merged by 2.
    # Both packages take 46 steps to 1e-10; the histories agree to 1.7e-10
    # over the first 19 residuals and to 1.1e-9 at the 20th
    jb, jm, tm, jd, td, u, f = pair2d((4, 16), 4, 8, seed=5)
    jp, tp = composites(jb, jm, tm, jd, td, poly_reduction=3)
    assert [(g.order, g.layers, g.zcoarse) for g in tp.extra["specs"]] == [
        (4, 2, 1), (4, 1, 1), (1, 1, 1), (1, 2, 1), (1, 3, 2), (1, 2, 1),
        (1, 1, 1), (4, 1, 1)]
    check_tree_rhs(jd, td, jp, tp, f, exact_orders={4})
    kernels.reset_counts()
    rt = solve_one(td, tp, f, tol=1e-10, maxit=250)
    assert no_k12()
    rj = solve_one(jd, jp, f, tol=1e-10, maxit=250)
    assert bool(rt.converged) and rt.iterations == int(rj.iterations)
    np.testing.assert_allclose(history(rt)[:19], history(rj)[:19],
                               rtol=1e-9)
    assert np.abs(rt.u.numpy() - np.asarray(u)).max() < 1e-6
    base = td.solver(method="fgmres", max_iterations=150, tolerance=1e-8)(
        torch.as_tensor(np.array(f)))
    assert rt.iterations < base.iterations
