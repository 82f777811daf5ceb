"""The unstructured composite's inner="fem-amg" over 4 shards against the
JAX package's on the CPU, in f64: scrambled Kershaw (4, 4, 4) N=3, seed
11, r=2 with max_coarse=170, where two shards' aggregation chains stop a
level short and are extended to the others' (amg/unstructured_fem.
pad_fem_shards): the host hierarchies and one application. The default
max_coarse: the port's whole solve against the JAX package's count
(reference/jax_unstructured.py femamg: 9). Scrambled (8, 8, 8) N=2 r=1,
permute=False, with the far field compressed: one application (the
superdomain block joins each shard's FEM matrix), and the port's whole
solves, compressed and not, against the JAX package's counts. Helpers:
tests/unstructured_twins.py."""

import numpy as np
import pytest
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.unstructured import composite_dd_unstructured as jcomposite
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.unstructured import composite_dd_unstructured as tcomposite

from unstructured_twins import Twin, check_fem_hierarchies, scrambled
from unstructured_twins import one_torch_thread  # noqa: F401 (autouse)

JAX_P4_ITERATIONS = 9       # reference/jax_unstructured.py femamg, P = 4
# the same script on (8, 8, 8) N=2 r=1 over 4 shards, by far field
# compressed (tests/test_unstructured.py:156-187 measures 19 and 19)
JAX_FAR_ITERATIONS = {False: 19, True: 19}


@pytest.fixture(scope="module")
def p4():
    return Twin(scrambled((4, 4, 4), 11), 3, 4)


def _extended(chain):
    """Levels a chain was extended by: transfers that are a bare
    identity (pad_fem_shards repeats the coarsest matrix under them)."""
    out = 0
    for P in chain["prolongs"]:
        c = P.tocoo()
        out += bool(c.nnz and np.all(c.data == 1.0) and np.all(c.row == c.col))
    return out


def test_fem_hierarchies_and_application_match_reference(p4, tmp_path):
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    kw = dict(poly_reduction=2, inner="fem-amg", max_coarse=170)
    jp = jcomposite(p4.jd, p4.jmk, fine_mesh=p4.jm, setup_cache=jpath, **kw)
    tp = tcomposite(p4.td, p4.tmk, fine_mesh=p4.tm, setup_cache=tpath, **kw)
    fem = check_fem_hierarchies(jpath, tpath)
    assert len(fem) == 4
    assert [_extended(s["chain"]) for s in fem] == [1, 0, 0, 1]
    # the device tree: every operator block-diagonal over the 4 shards
    tree = tp.extra["fem"]
    assert tree["shards"] == 4
    assert tree["levels"][0]["A"].shape == tuple(
        4 * n for n in fem[0]["chain"]["mats"][0].shape)
    assert tuple(tree["coarse_inv"].shape[:1]) == (4,)
    p4.check_apply(jp, tp)


def test_fem_amg_p4_count(p4):
    # the port alone, on the default max_coarse: the JAX package's count
    twin = p4
    tp = tcomposite(twin.td, twin.tmk, fine_mesh=twin.tm, poly_reduction=2,
                    inner="fem-amg")
    res = twin.td.solver(method="fgmres", max_iterations=60, tolerance=1e-8,
                         precond=tp)(twin.tf)
    assert bool(res.converged) and res.iterations == JAX_P4_ITERATIONS
    err = np.abs(twin.td.from_device_field(res.u)
                 - twin.td.from_device_field(twin.tu)).max()
    assert err < 1e-6


def test_fem_amg_compressed_far_field_matches_reference():
    twin = Twin(scrambled((8, 8, 8), 11, permute=False), 2, 4)
    jp, tp = twin.composites(jcomposite, tcomposite, poly_reduction=1,
                             inner="fem-amg", far_compress=True)
    assert tp.extra["sup"]["ns"] == 190
    assert all(r["compressed"] for r in tp.extra["regions"])
    # Q's rows: the classes' points, then the superdomain's
    pts = sum(cx["shape"][1] * cx["shape"][2]
              for cx in tp.extra["classes"])
    assert tp.extra["fem"]["Q"].shape[0] == 4 * (pts + 190)
    twin.check_apply(jp, tp)


@pytest.mark.parametrize("far_compress", [False, True])
def test_fem_amg_far_field_counts(far_compress):
    twin_mk = scrambled((8, 8, 8), 11, permute=False)[1]
    mesh = twin_mk(2)
    dom = Domain(partition_mesh(mesh, 4), dtype=torch.float64, device="cpu")
    u = dom.initial_function(4, seed=3)
    pre = tcomposite(dom, twin_mk, fine_mesh=mesh, poly_reduction=1,
                     inner="fem-amg", far_compress=far_compress)
    assert ("sup" in pre.extra) == far_compress
    res = dom.solver(method="fgmres", max_iterations=200, tolerance=1e-8,
                     precond=pre)(dom.manufacture_rhs(u))
    assert bool(res.converged)
    assert res.iterations == JAX_FAR_ITERATIONS[far_compress]
    err = np.abs(dom.from_device_field(res.u)
                 - dom.from_device_field(u)).max()
    assert err < 1e-6
