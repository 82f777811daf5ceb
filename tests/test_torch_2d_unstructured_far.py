"""The port's 2-D unstructured composite with a compressed far field
against the JAX package (CPU, f64): scrambled Kershaw (12, 12), order 2,
seed 5, element order kept, r = 1, P = 4, ``far_compress=True`` (every
shard's far field a superdomain block), inner "amg" and "fem-amg" (the
only 2-D fem-amg run with a superdomain block). Equal counts, the f64
histories at rtol 1e-9 over the stated prefix (ROADMAP section 3).
Helpers from tests/test_torch_2d_unstructured.py."""

import jax
import jax.numpy as jnp
import pytest
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.unstructured import composite_dd_unstructured as jcdu

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.unstructured import composite_dd_unstructured as tcdu

from composite_twins import one_torch_thread  # noqa: F401 (autouse)
from test_torch_2d_unstructured import port_mesh_whole, same_history, scrambled


@pytest.mark.parametrize("inner,steps", [("amg", 17), ("fem-amg", 13)])
def test_2d_compressed_far_field_matches_reference(inner, steps):
    jb, tb = scrambled((12, 12), 5, permute=False)
    jm = jb(2)
    tm = port_mesh_whole(jm)
    P = 4
    jd = JDomain(jpartition(jm, P), dtype=jnp.float64,
                 device_mesh=jax.make_mesh((P,), ("shard",)))
    td = TDomain(tpartition(tm, P), dtype=torch.float64, device="cpu")
    jf = jd.manufacture_rhs(jd.initial_function(4, seed=2))
    tf = td.manufacture_rhs(td.initial_function(4, seed=2))
    kw = dict(poly_reduction=1, inner=inner, far_compress=True)
    jp = jcdu(jd, jb, fine_mesh=jm, **kw)
    tp = tcdu(td, tb, fine_mesh=tm, **kw)
    assert all(r["compressed"] for r in tp.extra["regions"])
    assert "sup" in tp.extra
    solve = dict(method="fgmres", max_iterations=100, tolerance=1e-8)
    same_history(jd.solver(precond=jp, **solve)(jf),
                 td.solver(precond=tp, **solve)(tf), steps)
