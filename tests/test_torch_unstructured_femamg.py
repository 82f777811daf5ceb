"""The unstructured composite's inner="fem-amg" (amg/unstructured_fem.py,
the shards' FEM hierarchies block-diagonal on the card) on one shard
against the JAX package's on the CPU: scrambled Kershaw (4, 4, 4) N=3,
seed 11, r=2 (tests/test_unstructured.py's fem-amg configuration).

The host hierarchies (chain matrices, transfers, Chebyshev bounds, the
coarsest inverse, Q, the DOF mask) are compared through both packages'
setup_cache payloads; one application and the whole f64 outer solve
against the JAX package's; the FCG inner solver in one application; a
bf16 hierarchy's count against the JAX package's count
(reference/jax_unstructured.py femamg: 9 iterations in f64, 7 with the
bf16 ptype). Over 4 shards: tests/test_torch_unstructured_femamg_spmd.py.
Helpers: tests/unstructured_twins.py."""

import numpy as np
import pytest
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.unstructured import composite_dd_unstructured as jcomposite
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.unstructured import composite_dd_unstructured as tcomposite

from unstructured_twins import Twin, check_fem_hierarchies, scrambled
from unstructured_twins import one_torch_thread  # noqa: F401 (autouse)

JAX_F64_ITERATIONS = 9      # reference/jax_unstructured.py femamg, P = 1
JAX_BF16_ITERATIONS = 7     # the same, f32 outer with a bf16 ptype


@pytest.fixture(scope="module")
def p1(tmp_path_factory):
    d = tmp_path_factory.mktemp("femamg_p1")
    twin = Twin(scrambled((4, 4, 4), 11), 3, 1)
    jpath, tpath = str(d / "j.npz"), str(d / "t.npz")
    jp = jcomposite(twin.jd, twin.jmk, fine_mesh=twin.jm, poly_reduction=2,
                    inner="fem-amg", setup_cache=jpath)
    tp = tcomposite(twin.td, twin.tmk, fine_mesh=twin.tm, poly_reduction=2,
                    inner="fem-amg", setup_cache=tpath)
    return twin, jp, tp, jpath, tpath


def test_fem_hierarchy_matches_reference(p1):
    _, _, tp, jpath, tpath = p1
    fem = check_fem_hierarchies(jpath, tpath)
    # the device tree is that hierarchy, unstacked on one shard
    tree = tp.extra["fem"]
    assert "shards" not in tree
    assert len(tree["levels"]) == len(fem[0]["chain"]["mats"])
    assert tree["Q"].shape == fem[0]["Q"].shape


def test_fem_amg_application_matches_reference(p1):
    twin, jp, tp, _, _ = p1
    twin.check_apply(jp, tp)


def test_fem_amg_solve_matches_reference(p1):
    # equal counts; the f64 histories agree to ~1e-13 over the first 8
    # of 9 steps, and the last is 1.2e-9 apart (the round-off drift of
    # ROADMAP section 3)
    twin, jp, tp, _, _ = p1
    rj, rt = twin.solve_both(jp, tp)
    assert rt.iterations == JAX_F64_ITERATIONS
    twin.check_outer(rj, rt, 8)


def test_fem_amg_fcg_inner_matches_reference(p1):
    twin = p1[0]
    jp, tp = twin.composites(jcomposite, tcomposite, poly_reduction=2,
                             inner="fem-amg", inner_solver="fcg")
    twin.check_apply(jp, tp)


def test_fem_amg_bf16_count(p1):
    # a bf16 hierarchy under the f32 outer solve: the port's bf16 SpMV
    # sums in f32 and rounds once where the JAX package sums in bf16
    # (ROADMAP section 3), so the count is held to +-2 of the JAX
    # package's
    twin = p1[0]
    dom = Domain(partition_mesh(twin.tm, 1), dtype=torch.float32,
                 device="cpu")
    u = dom.initial_function(4, seed=3)
    pre = tcomposite(dom, twin.tmk, fine_mesh=twin.tm, poly_reduction=2,
                     inner="fem-amg", ptype=torch.bfloat16)
    assert pre.extra["fem"]["levels"][0]["A"].dtype == torch.bfloat16
    res = dom.solver(method="fgmres", max_iterations=60, tolerance=1e-6,
                     precond=pre)(dom.manufacture_rhs(u))
    assert bool(res.converged)
    assert abs(res.iterations - JAX_BF16_ITERATIONS) <= 2, res.iterations
    err = np.abs(dom.from_device_field(res.u)
                 - dom.from_device_field(u)).max()
    assert err < 1e-3
