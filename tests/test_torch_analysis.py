"""The port's runtime/analysis.py against the JAX package's (CPU, f64),
and the analysis tests' twins: the assembled dense operator (equal to the
JAX package's within 1e-12 relative) as the oracle of the port's
matrix-free FCG (tests/test_parity.py::test_cg_iteration_parity_vs_scipy)
and 2-D FGMRES (::test_fgmres_history_matches_scipy_gmres), of the 2-D
matrix-free apply and dssum (tests/test_runtime.py::
test_analysis_dense_oracle_matches_matrix_free), ``compare_histories``
(::test_compare_histories) and the pebble bed's solve (tests/
test_pebble.py::test_pebble_solve_matches_dense_oracle). The port runs
on the port's own meshes; the JAX package's matrix is built on the JAX
package's mesh of the same shape."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.pebble import pebble_mesh as jpebble
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.runtime import analysis as jan

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.pebble import pebble_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime import analysis as an
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain

from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _node_mask_and_rhs(mesh, dom, f):
    """The nodes' Dirichlet mask and the assembled, masked right-hand
    side Q^T f of a one-shard Domain's field."""
    mask = np.ones(mesh.num_nodes)
    np.minimum.at(mask, mesh.glo_num.reshape(-1),
                  mesh.dirichlet_mask.reshape(-1))
    f_nodes = np.zeros(mesh.num_nodes)
    np.add.at(f_nodes, mesh.glo_num.reshape(-1),
              dom.from_device_field(f).reshape(-1))
    return mask, f_nodes * mask


@pytest.mark.parametrize("shape,N", [((3, 3, 4), 3), ((3, 4), 2),
                                     ((3, 4), 3)])
def test_dense_operator_matches_reference(shape, N):
    tm = tg.kershaw_mesh(shape, N, epsilon=0.3, device="cpu")
    jm = jg.kershaw_mesh(shape, N, epsilon=0.3)
    A = an.assembled_operator_dense(tm)
    assert _rel(A, jan.assembled_operator_dense(jm)) <= 1e-12
    # on the same arrays too (the JAX mesh's geometry)
    assert _rel(an.assembled_operator_dense(jm),
                jan.assembled_operator_dense(jm)) <= 1e-12
    assert np.abs(A - A.T).max() < 1e-10


def test_cg_iteration_parity_vs_scipy():
    mesh = tg.kershaw_mesh((3, 3, 4), 3, epsilon=0.3, device="cpu")
    dom = Domain(partition_mesh(mesh, 1), dtype=torch.float64, device="cpu")
    f = dom.manufacture_rhs(dom.initial_function(4, seed=11))
    res = dom.solver(method="fcg", max_iterations=500, tolerance=1e-8)(f)
    assert bool(res.converged)
    ours = int(res.iterations)

    A = an.assembled_operator_dense(mesh)
    _, b = _node_mask_and_rhs(mesh, dom, f)
    # unpreconditioned CG on the assembled system, same relative tolerance
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rz = r @ r
    b0 = np.sqrt(rz)
    oracle = 0
    for oracle in range(1, 501):
        Ap = A @ p
        alpha = rz / (p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        rz_new = r @ r
        if np.sqrt(rz_new) < 1e-8 * b0:
            break
        p = r + (rz_new / rz) * p
        rz = rz_new
    assert abs(ours - oracle) <= max(3, int(0.15 * oracle)), (ours, oracle)


def test_fgmres_history_matches_scipy_gmres():
    mesh = tg.kershaw_mesh((3, 4), 2, epsilon=0.3, device="cpu")
    dom = Domain(partition_mesh(mesh, 1), dtype=torch.float64, device="cpu")
    f = dom.manufacture_rhs(dom.initial_function(1))
    res = dom.solver(method="fgmres", max_iterations=300, num_vectors=30,
                     tolerance=1e-8)(f)
    assert bool(res.converged)
    hist = res.residual_history.numpy()
    hist = hist[np.isfinite(hist)]

    A = an.assembled_operator_dense(mesh)
    _, b = _node_mask_and_rhs(mesh, dom, f)
    oracle_hist = [np.linalg.norm(b)]

    def cb(rk):
        oracle_hist.append(rk * np.linalg.norm(b))

    spla.gmres(A, b, rtol=1e-8, restart=30, maxiter=300, callback=cb,
               callback_type="pr_norm")
    assert abs(len(hist) - len(oracle_hist)) <= max(
        4, int(0.15 * len(oracle_hist))), (len(hist), len(oracle_hist))
    rep = an.compare_histories(hist, oracle_hist, rtol=0.5)
    assert rep["max_log_rel_dev"] < 0.5, rep
    # the JAX package's compare_histories reads the same
    assert rep == jan.compare_histories(hist, oracle_hist, rtol=0.5)


@pytest.mark.parametrize("structured", [True, False])
def test_analysis_dense_oracle_matches_matrix_free(structured):
    # the 2-D matrix-free apply and dssum of the port's Domain (the slab
    # route and the generic route) against the dense assembled operator
    mesh = tg.kershaw_mesh((3, 4), 3, epsilon=0.3, device="cpu")
    A = an.assembled_operator_dense(mesh)
    assert np.abs(A - A.T).max() < 1e-10
    dom = Domain(partition_mesh(mesh, 1, structured=structured),
                 dtype=torch.float64, device="cpu")
    mask, _ = _node_mask_and_rhs(mesh, dom, dom.to_device_field(
        np.zeros(dom.points_shape())))
    v_nodes = np.random.default_rng(0).standard_normal(mesh.num_nodes)
    v_nodes *= mask
    u_pts = v_nodes[mesh.glo_num.reshape(-1)]
    au = dom.dssum_field(dom.apply_operator(dom.to_device_field(
        u_pts.reshape(dom.points_shape()))))
    au_elem = dom.from_device_field(au).reshape(-1)
    want = (A @ v_nodes)[mesh.glo_num.reshape(-1)]
    free = mask[mesh.glo_num.reshape(-1)] > 0
    assert np.abs(au_elem[free] - want[free]).max() < 1e-9


def test_compare_histories():
    for mod in (an, jan):
        assert mod.compare_histories([1.0, 0.1, 0.01, 0.001],
                                     [1.0, 0.11, 0.012, 0.0011])["match"]
        assert not mod.compare_histories([1.0, 0.5, 0.25, 0.12, 0.06, 0.03],
                                         [1.0, 1e-6])["match"]
    a, b = [1.0, 0.3, np.nan, 0.02], [1.0, 0.25, 0.03]
    assert an.compare_histories(a, b) == jan.compare_histories(a, b)


def test_pebble_solve_matches_dense_oracle():
    kw = dict(num_pebbles=2, seed=4, solid_fraction=0.15)
    m = pebble_mesh((4, 4, 4), 2, device="cpu", **kw)
    A = an.assembled_operator_dense(m)
    assert _rel(A, jan.assembled_operator_dense(
        jpebble((4, 4, 4), 2, **kw))) <= 1e-12
    free = np.flatnonzero(np.bincount(m.glo_num.ravel(),
                                      weights=m.dirichlet_mask.ravel()) > 0)
    Af = A[np.ix_(free, free)]
    np.testing.assert_allclose(Af, Af.T, atol=1e-10)
    assert np.linalg.eigvalsh(Af).min() > 0

    dom = Domain(partition_mesh(m, 1, structured=False), dtype=torch.float64,
                 device="cpu")
    u_star = dom.initial_function(0)
    f = dom.manufacture_rhs(u_star)
    res = dom.solver(method="fcg", max_iterations=400, tolerance=1e-10)(f)
    assert bool(res.converged)
    err = np.abs(dom.from_device_field(res.u)
                 - dom.from_device_field(u_star)).max()
    assert err <= 1e-7 * np.abs(dom.from_device_field(u_star)).max()
    # the dense oracle's solution on the free nodes is the solve's
    _, b = _node_mask_and_rhs(m, dom, f)
    x = np.zeros(m.num_nodes)
    x[free] = np.linalg.solve(Af, b[free])
    got = dom.from_device_field(res.u).reshape(-1)
    np.testing.assert_allclose(got, x[m.glo_num.reshape(-1)],
                               atol=1e-7 * np.abs(x).max())
