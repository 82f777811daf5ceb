"""The port's unstructured composite over 4 shards (runtime/comm.LocalComm)
against the JAX package's shard_map composite on the CPU mesh of
tests/conftest.py, in f64: scrambled Kershaw (4, 4, 4) N=3, seed 11, r=2
with inner "amg" (tests/test_unstructured.py's smallest configuration),
whole outer solves. Helpers: tests/unstructured_twins.py."""

import pytest

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as jsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import subdomain as tsub

from unstructured_twins import Twin, scrambled
from unstructured_twins import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def twin():
    return Twin(scrambled((4, 4, 4), 11), 3, 4)


def test_amg_inner_p4_matches_reference(twin):
    # 7 outer iterations in both; the histories agree to 1.0e-10 at step
    # 6 and 5.8e-9 at step 7, so rtol 1e-9 holds over 6 steps
    jp, tp = twin.composites(jsub.composite_dd, tsub.composite_dd,
                             poly_reduction=2, inner="amg")
    rj, rt = twin.solve_both(jp, tp)
    assert rt.iterations == 7
    twin.check_outer(rj, rt, 6)
