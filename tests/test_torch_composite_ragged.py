"""The port's multi-shard composite on ragged slabs against the JAX
package on the 8-device CPU mesh of tests/conftest.py, in f64: tests/
test_ragged.py's composite case, the box (2, 2, 8) over 3 shards, slabs 3,
3, 2 (pad slots in the own and far groups, per-shard interface planes,
the sender's ring slices and the compacted all-gather). Helpers: tests/
composite_twins.py."""

import numpy as np

from composite_twins import (BOX, check_outer, check_probe, check_tree_rhs,
                             composites, pair, solve_both)
from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def test_ragged_composite_matches_reference():
    # orders 3, 1: the outer f64 histories agree to ~1e-10 over the first
    # 5 steps and then drift ~15x a step (ROADMAP section 3: 1.6e-9 at the
    # last of 6 on the seed-5 problem)
    jm, tm, jd, td, u, f = pair(BOX, 3, 3, seed=1)
    assert td.sharded.structured.layer_counts == (3, 3, 2)
    jp, tp = composites(BOX, jm, tm, jd, td, poly_reduction=2)
    assert [(g.order, g.layers) for g in tp.extra["specs"]] == [
        (3, 3), (3, 1), (1, 1), (1, 2), (1, 1), (3, 1)]
    # the order-3 parts are slices of the residual (bitwise), the order-1
    # parts pass the restriction cascade (16 eps of max, as at P = 8)
    check_tree_rhs(jd, td, jp, tp, f, exact_orders={3})
    check_probe(jd, td, jp, tp, f, groups=6)
    rj, rt = solve_both(jd, td, jp, tp, f, maxit=100)
    check_outer(rj, rt, 5, u=u, max_err=1e-7)
