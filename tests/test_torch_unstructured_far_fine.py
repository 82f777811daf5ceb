"""The unstructured composite's far field carried as fine order-1
elements (far_compress=False) over 4 shards. Against the JAX package's,
in f64: one application on scrambled Kershaw (4, 4, 8) N=2, seed 11,
permute=False, r=1, where every shard has an uncompressed far field (the
smallest such mesh; about 47 s on one core). Port only, on
tests/test_torch_unstructured_far.py's mesh ((8, 8, 8), the same
settings): the whole solve takes the 13 iterations tests/test_unstructured.py
records for the JAX package's. Helpers: tests/unstructured_twins.py."""

import numpy as np
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.unstructured import composite_dd_unstructured as jcomposite
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.generator import kershaw_mesh, scramble_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.unstructured import composite_dd_unstructured

from unstructured_twins import Twin, scrambled
from unstructured_twins import one_torch_thread  # noqa: F401 (autouse)


def _far_in_order1_class(pre):
    # every shard's far field is uncompressed, in its order-1 class with
    # its last ring
    assert "sup" not in pre.extra
    regions = pre.extra["regions"]
    E1 = pre.extra["classes"][-1]["shape"][1]
    assert all(r["far"] > 0 and not r["compressed"] for r in regions)
    assert E1 == max(r["rings"][-1] + r["far"] for r in regions)


def test_uncompressed_far_field_matches_reference():
    twin = Twin(scrambled((4, 4, 8), 11, permute=False), 2, 4)
    jp, tp = twin.composites(jcomposite, composite_dd_unstructured,
                             poly_reduction=1, inner="amg",
                             far_compress=False)
    _far_in_order1_class(tp)
    assert jp.extra.get("sup") is None
    twin.check_apply(jp, tp)


def test_uncompressed_far_field_takes_the_reference_count():
    mk = lambda o: scramble_mesh(kershaw_mesh((8, 8, 8), o, 0.3,
                                              device="cpu"),
                                 seed=11, permute=False, device="cpu")
    mesh = mk(2)
    dom = Domain(partition_mesh(mesh, 4), dtype=torch.float64, device="cpu")
    u = dom.initial_function(4, seed=3)
    pre = composite_dd_unstructured(dom, mk, poly_reduction=1, inner="amg",
                                    fine_mesh=mesh, far_compress=False)
    _far_in_order1_class(pre)
    res = dom.solver(method="fgmres", max_iterations=200, tolerance=1e-8,
                     precond=pre)(dom.manufacture_rhs(u))
    assert bool(res.converged) and res.iterations == 13
    err = np.abs(dom.from_device_field(res.u)
                 - dom.from_device_field(u)).max()
    assert err < 1e-6
