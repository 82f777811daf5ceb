"""The port's phase taxonomy against the JAX package (CPU): the region
chains (``Domain.phase_chain``) over 4 shards in f64 at tests/
test_runtime.py::test_phase_chain_spmd's configuration and kinds, rtol
1e-12 (both packages return the scalar in f32); the chains' errors and
that they leave their input alone; and ``runtime/phases.phase_report`` at
tests/test_runtime.py::test_phase_report's configuration, whose rows
must be the JAX package's for that path. The region closures the chains
run are held to the JAX package's in tests/test_torch_composite_parts.py.
"""

from functools import partial
import io

import numpy as np
import pytest
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.config import Config
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.phases import phase_report
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import preconditioners as tpre
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import subdomain as tsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain

from composite_twins import composites, pair
from composite_twins import one_torch_thread  # noqa: F401 (autouse)

CHAIN_KINDS = ("op", "tree_rhs", "comp_op", "inner_precond", "tree_rings",
               "tree_coarse", "comp_assemble")


def test_chains_across_shards_match_reference():
    # ::test_phase_chain_spmd: (2, 2, 8) N=2 over 4 shards, r=1, amg
    jb = partial(jg.kershaw_mesh, (2, 2, 8), epsilon=0.3)
    jm, tm, jd, td, u, f = pair(jb, 2, 4, seed=0)
    jp, tp = composites(jb, jm, tm, jd, td, poly_reduction=1, inner="amg")
    tf = torch.as_tensor(np.array(f))
    for kind in CHAIN_KINDS:
        want = float(jd.phase_chain(jp, kind, 3)(f))
        got = td.phase_chain(tp, kind, 3)(tf)
        assert isinstance(got, float)
        assert np.isfinite(got), kind
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=kind)


def test_chain_errors_and_input_left_alone():
    mesh = tg.kershaw_mesh((2, 2, 8), 2, 0.3, device="cpu")
    dom = TDomain(tpartition(mesh, 1), dtype=torch.float64, device="cpu")
    f = dom.manufacture_rhs(dom.initial_function(4, seed=0))
    pre = tsub.composite_dd(dom, lambda o: tg.kershaw_mesh(
        (2, 2, 8), o, 0.3, device="cpu"), poly_reduction=1, fine_mesh=mesh)
    with pytest.raises(ValueError, match="exposes"):
        dom.phase_chain(pre, "no_such_kind", 2)
    for other in (None, tpre.jacobi(dom)):
        with pytest.raises(ValueError, match="needs a composite"):
            dom.phase_chain(other, "comp_op", 2)
    with pytest.raises(KeyError):
        dom.phase_chain(pre, "tree_levels", 2)   # structured: no levels
    assert np.isfinite(dom.phase_chain(None, "op", 2)(f))
    before = f.clone()
    for kind in ("tree_rhs", "tree_cascade", "comp_op"):
        assert np.isfinite(dom.phase_chain(pre, kind, 3)(f))
    assert torch.equal(f, before)


# the JAX package's row names for a structured one-shard composite with
# inner="amg" and 4 inner iterations (runtime/phases.py)
REPORT_KEYS = [
    "domain.operator+vector_operations (FCG floor)",
    "domain.krylov_basis (GMRES - FCG)",
    "subdomain.tree+inner_solver (QQt inner)",
    "subdomain.inner_preconditioner.jacobi",
    "subdomain.preconditioner.vcycle (amg - jacobi)",
    "total per iteration",
    "region.domain.operator_application",
    "region.domain.inner_products+vector_operations (1 dot + 1 scale)",
    "region.subdomain.stitching (outer dssum)",
    "region.subdomain.tree_construction (restriction cascade)",
    "region.subdomain.tree_exchange (rings+coarse gather+far)",
    "region.subdomain.operator_application (x4)",
    "region.subdomain.preconditioner.assemble+unassemble (x4)",
    "region.subdomain.preconditioner.vcycle legs+coarse (x4)",
    "region.subdomain.preconditioner.smooth_leg (x4, 1 Chebyshev)",
    "region.subdomain.preconditioner.transfer_legs (x4, R+P)",
    "region.subdomain.preconditioner.coarse_grid_solver (x4)",
    "region.subdomain.inner_products+vector_operations (1 dot + 1 scale)",
    "region.subdomain.tree_exchange.rings (ppermute legs)",
    "region.subdomain.tree_exchange.coarse (all_gather)",
    "region.subdomain.tree_exchange.superdomain (far restrict)",
    "region.subdomain.preconditioner.assemble (x4, gather)",
    "region.subdomain.preconditioner.unassemble (x4, scatter+stitch)",
]


def test_phase_report_rows():
    # ::test_phase_report: (2, 2, 8) N=2, f32, Config(poly_reduction=1),
    # 4 iterations
    shape = (2, 2, 8)
    mesh = tg.kershaw_mesh(shape, 2, 0.3, device="cpu")
    dom = TDomain(tpartition(mesh, 1), dtype=torch.float32, device="cpu")
    buf = io.StringIO()
    rep = phase_report(dom, lambda o: tg.kershaw_mesh(shape, o, 0.3,
                                                      device="cpu"),
                       cfg=Config(poly_reduction=1), iterations=4, out=buf)
    assert list(rep) == REPORT_KEYS
    assert all(np.isfinite(v) for v in rep.values())
    assert all(rep[k] >= 0.0 for k in rep if k.startswith("region."))
    text = buf.getvalue()
    assert text.count("phase report") == 2
    assert "total per iteration" in text
