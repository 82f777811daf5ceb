"""The port's multi-shard composite against the JAX package with the far
field on fine layers (far_coarsen=1), in f64: the checks of tests/
test_torch_composite_spmd.py's z-merged case on the same Kershaw (2, 2,
16) N=3 r=2 over 8 shards (G = 6: own slab, rings of orders 3 and 1 on
each side, a 10-layer order-1 far field). Helpers: tests/
composite_twins.py."""

from composite_twins import check_kershaw2216_p8
from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def test_composite_p8_fine_far_matches_reference():
    check_kershaw2216_p8(1, 6)
