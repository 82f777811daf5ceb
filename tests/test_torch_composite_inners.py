"""The multi-shard composite's inner variants against the JAX package on
the CPU, in f64: tests/test_ragged.py's Jacobi, plain-QQt and fem-amg
inners on the ragged box (2, 2, 8) N=2 r=1 over 3 shards. Helpers:
tests/composite_twins.py."""

import numpy as np
import pytest

from composite_twins import (BOX, check_outer, check_probe, check_tree_rhs,
                             composites, pair, solve_both)
from composite_twins import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("inner", ["jacobi", "none"])
def test_ragged_inner_variants_match_reference(inner):
    jm, tm, jd, td, u, f = pair(BOX, 2, 3, seed=1)
    jp, tp = composites(BOX, jm, tm, jd, td, poly_reduction=1, inner=inner)
    # orders 2 and 1: the cascade's J^T has the entries 1, 1/2 and 0, so
    # every restricted point is one rounded sum of two exact products and
    # the whole tree_rhs (pad slots, dynamic planes, the compacted
    # all-gather) equals the JAX package's bit for bit
    check_tree_rhs(jd, td, jp, tp, f, exact_orders={1, 2})
    rj, rt = solve_both(jd, td, jp, tp, f)
    check_outer(rj, rt, 5)


def test_ragged_femamg_matches_reference():
    # one hierarchy per shard, pad slots as zero Q rows, DOF counts padded
    # to the largest, packed block-diagonal (test_ragged.py: <= 10)
    jm, tm, jd, td, u, f = pair(BOX, 2, 3, seed=1)
    jp, tp = composites(BOX, jm, tm, jd, td, poly_reduction=1,
                        inner="fem-amg")
    tree = tp.extra["amg"]
    assert tree["shards"] == 3 and tree["dof_mask"].shape[0] == 3
    assert tree["coarse_inv"].dim() == 3
    check_probe(jd, td, jp, tp, f)
    rj, rt = solve_both(jd, td, jp, tp, f)
    assert rt.iterations == int(rj.iterations) <= 10
