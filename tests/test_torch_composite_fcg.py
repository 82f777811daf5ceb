"""The rank-local FCG inner solver of the multi-shard composite against
the JAX package on the CPU, in f64: Kershaw (2, 2, 16) N=2 r=1 over 8
shards (slabs of 2, the far field z-merged by 2). Helpers: tests/
composite_twins.py."""

from functools import partial

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg

from composite_twins import (check_outer, check_probe, composites, pair,
                             solve_both)
from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def test_fcg_inner_p8_matches_reference():
    jb = partial(jg.kershaw_mesh, (2, 2, 16), epsilon=0.3)
    jm, tm, jd, td, u, f = pair(jb, 2, 8, seed=5)
    jp, tp = composites(jb, jm, tm, jd, td, poly_reduction=1,
                        inner_solver="fcg")
    assert max(g.zcoarse for g in tp.extra["specs"]) == 2
    check_probe(jd, td, jp, tp, f)
    rj, rt = solve_both(jd, td, jp, tp, f, tol=1e-6, maxit=100)
    check_outer(rj, rt, 10)
