"""The unstructured composite's far field over 4 shards against the JAX
package's in f64: scrambled Kershaw (8, 8, 8) N=2, seed 11,
permute=False, r=1 (tests/test_unstructured.py's superdomain
configuration, 13 and 13 iterations there): the compressed far field (a
per-shard sparse block) in a whole outer solve. The uncompressed far
field: tests/test_torch_unstructured_far_fine.py. Helpers:
tests/unstructured_twins.py."""

import pytest

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.unstructured import composite_dd_unstructured as jcomposite
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.unstructured import composite_dd_unstructured as tcomposite

from unstructured_twins import Twin, scrambled
from unstructured_twins import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def twin():
    return Twin(scrambled((8, 8, 8), 11, permute=False), 2, 4)


def test_compressed_far_field_matches_reference(twin):
    # 13 outer iterations in both; the histories agree to ~1e-11 over the
    # first 10 steps (2.1e-10 at step 11, 9.2e-9 at 13)
    jp, tp = twin.composites(jcomposite, tcomposite, poly_reduction=1,
                             inner="amg", far_compress=True)
    assert tp.extra["sup"]["ns"] == jp.extra["sup"]["mask"].shape[-1] == 190
    assert all(r["compressed"] for r in tp.extra["regions"])
    rj, rt = twin.solve_both(jp, tp, maxit=200)
    assert rt.iterations == 13
    twin.check_outer(rj, rt, 10)

