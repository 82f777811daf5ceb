"""Variants of the port's 2-D composite DD + polynomial-reduction
preconditioner over several slab shards: the lighter inners "fem-amg",
"jacobi" and "none" over 4 shards against the JAX package's shard_map
composite (CPU, f64), and on Kershaw (4, 16) N=4 r=3 over 8 shards the
FCG outer (tests/test_composite_dd.py::test_composite_dd_fcg_outer) and
the f32 ptype (::test_composite_dd_mixed_precision_ptype) on the port
alone, with their reference tests' criteria (tests/
test_torch_2d_composite_spmd.py holds this configuration's FGMRES against
the JAX package). Helpers: tests/composite_twins.py.

Tolerances: one preconditioner application within 1e-12 of max and its
inner histories at rtol 1e-10 (``check_probe``); the outer counts equal
to the JAX package's."""

import pytest
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import subdomain as tsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain

from composite_twins import check_probe, composites, no_k12, pair2d, solve_one
from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def test_composite_p8_fcg_outer_and_f32_ptype():
    # ::test_composite_dd_fcg_outer and ::test_composite_dd_mixed_
    # precision_ptype on the port alone, with their criteria
    mk = lambda o: tg.kershaw_mesh((4, 16), o, epsilon=0.3, device="cpu")
    mesh = mk(4)
    dom = TDomain(tpartition(mesh, 8), dtype=torch.float64, device="cpu")
    u0 = dom.initial_function(0)
    pre = tsub.composite_dd(dom, mk, poly_reduction=3, fine_mesh=mesh)
    res = solve_one(dom, pre, dom.manufacture_rhs(u0), method="fcg",
                    tol=1e-10, maxit=250)
    assert bool(res.converged)
    assert (res.u - u0).abs().max() < 1e-6
    u9 = dom.initial_function(4, seed=9)
    f9 = dom.manufacture_rhs(u9)
    pre32 = tsub.composite_dd(dom, mk, poly_reduction=3, fine_mesh=mesh,
                              ptype=torch.float32)
    r64 = solve_one(dom, pre, f9, tol=1e-9, maxit=200)
    r32 = solve_one(dom, pre32, f9, tol=1e-9, maxit=200)
    assert bool(r32.converged)
    assert r32.iterations <= r64.iterations + 8, (r32.iterations,
                                                  r64.iterations)
    assert (r32.u - u9).abs().max() < 1e-7


@pytest.mark.parametrize("inner", ["fem-amg", "jacobi", "none"])
def test_inner_variants_p4_match_reference(inner):
    # Kershaw (4, 8) N=3 r=2 over 4 shards (own slab of 2 rows, rings of
    # orders 3 and 1, 2 far rows): one application against the JAX
    # package's, and the port's outer FGMRES to 1e-8 with the count the
    # JAX package takes (14 / 31 / 57 steps; the f64 histories agree to
    # 1.7e-8 / 1.1e-9 / 1.8e-4 over all of them)
    jb, jm, tm, jd, td, u, f = pair2d((4, 8), 3, 4, seed=5)
    jp, tp = composites(jb, jm, tm, jd, td, poly_reduction=2, inner=inner)
    check_probe(jd, td, jp, tp, f)
    kernels.reset_counts()
    rt = solve_one(td, tp, f)
    assert no_k12()
    if inner == "fem-amg":
        assert kernels.counts()["csr_spmv_plain"]
    assert bool(rt.converged)
    assert rt.iterations == {"fem-amg": 14, "jacobi": 31, "none": 57}[inner]
