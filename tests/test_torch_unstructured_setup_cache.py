"""The unstructured composite's setup checkpoint (``setup_cache``,
runtime/checkpoint.save_setup_payload) in the port: the twin of
tests/test_unstructured.py::test_unstructured_setup_cache_roundtrip
(scrambled Kershaw (4, 4, 4) N=3, seed 11, r=2, f64), where a fresh and a
cache-loaded build must give bitwise equal outer histories, for inner
"amg" and "fem-amg"; an "amg" cache asked for "fem-amg" is rebuilt and
rewritten; the Chebyshev bounds kept in f64 read back bitwise in bf16 and
f32; composite_dd's chain_cache reaches the same cache; a payload of
another setup or of the JAX package raises."""

import os

import numpy as np
import pytest
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.checkpoint import load_setup_payload, save_setup_payload
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.subdomain import composite_dd
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.unstructured import composite_dd_unstructured

from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def mk(o):
    return tg.scramble_mesh(tg.kershaw_mesh((4, 4, 4), o, 0.3, device="cpu"),
                            seed=11, device="cpu")


def no_builder(order):
    raise AssertionError("a cached setup builds no mesh")


@pytest.fixture(scope="module")
def problem():
    mesh = mk(3)
    dom = Domain(partition_mesh(mesh, 1), dtype=torch.float64, device="cpu")
    u = dom.initial_function(4, seed=3)
    return mesh, dom, dom.manufacture_rhs(u)


def _history(dom, pre, f):
    res = dom.solver(method="fgmres", max_iterations=60, tolerance=1e-8,
                     precond=pre)(f)
    assert bool(res.converged)
    h = res.residual_history.numpy()
    return h[np.isfinite(h)]


@pytest.mark.parametrize("inner", ["amg", "fem-amg"])
def test_setup_cache_round_trip(problem, tmp_path, inner):
    mesh, dom, f = problem
    cache = str(tmp_path / "usetup.npz")
    fresh = composite_dd(dom, mk, poly_reduction=2, inner=inner,
                         fine_mesh=mesh, chain_cache=cache)
    assert os.path.exists(cache)
    assert os.listdir(tmp_path) == ["usetup.npz"]
    # the cached build reads everything from the file: no mesh at all
    loaded = composite_dd(dom, no_builder, poly_reduction=2, inner=inner,
                          fine_mesh=None, chain_cache=cache)
    assert "load" in loaded.extra["setup_seconds"]
    assert "regions" not in loaded.extra["setup_seconds"]
    assert loaded.extra["regions"] == fresh.extra["regions"]
    h1, h2 = _history(dom, fresh, f), _history(dom, loaded, f)
    assert np.array_equal(h1, h2)
    if inner == "amg":
        assert torch.equal(fresh.extra["amg"]["lmax0"],
                           loaded.extra["amg"]["lmax0"])


def test_amg_cache_asked_for_fem_amg_is_rebuilt(problem, tmp_path):
    mesh, dom, f = problem
    cache = str(tmp_path / "usetup.npz")
    composite_dd_unstructured(dom, mk, poly_reduction=2, inner="amg",
                              fine_mesh=mesh, setup_cache=cache)
    assert load_setup_payload(cache)["fem"] is None
    pre = composite_dd_unstructured(dom, mk, poly_reduction=2,
                                    inner="fem-amg", fine_mesh=mesh,
                                    setup_cache=cache)
    assert "regions" in pre.extra["setup_seconds"]       # a fresh setup
    pay = load_setup_payload(cache)                      # ... rewritten
    assert pay["fem"] is not None and pay["agg_info"] is None
    again = composite_dd_unstructured(dom, no_builder, poly_reduction=2,
                                      inner="fem-amg", setup_cache=cache)
    assert np.array_equal(_history(dom, pre, f), _history(dom, again, f))


@pytest.mark.parametrize("ptype", [torch.bfloat16, torch.float32])
def test_lmax0_reads_back_bitwise(problem, tmp_path, ptype):
    mesh = problem[0]
    dom = Domain(partition_mesh(mesh, 1), dtype=torch.float32, device="cpu")
    cache = str(tmp_path / "usetup.npz")
    fresh = composite_dd_unstructured(dom, mk, poly_reduction=2, inner="amg",
                                      ptype=ptype, fine_mesh=mesh,
                                      setup_cache=cache)
    lm = fresh.extra["amg"]["lmax0"]
    assert lm.dtype == ptype
    stored = load_setup_payload(cache)["lmax0"]
    assert stored.dtype == np.float64
    assert np.array_equal(stored, lm.double().reshape(-1).numpy())
    loaded = composite_dd_unstructured(dom, no_builder, poly_reduction=2,
                                       inner="amg", ptype=ptype,
                                       setup_cache=cache)
    assert torch.equal(loaded.extra["amg"]["lmax0"], lm)


def test_foreign_or_mismatched_payload_raises(problem, tmp_path):
    mesh, dom, _ = problem
    cache = str(tmp_path / "usetup.npz")
    composite_dd_unstructured(dom, mk, poly_reduction=2, inner="jacobi",
                              fine_mesh=mesh, setup_cache=cache)
    # another reduction, another ptype: the file does not fit
    with pytest.raises(ValueError, match="orders"):
        composite_dd_unstructured(dom, mk, poly_reduction=1, inner="jacobi",
                                  fine_mesh=mesh, setup_cache=cache)
    with pytest.raises(ValueError, match="ptype"):
        composite_dd_unstructured(dom, mk, poly_reduction=2, inner="jacobi",
                                  ptype=torch.float32, fine_mesh=mesh,
                                  setup_cache=cache)
    # another mesh of the same shape (another scramble)
    other = tg.scramble_mesh(tg.kershaw_mesh((4, 4, 4), 3, 0.3,
                                             device="cpu"),
                             seed=12, device="cpu")
    dom2 = Domain(partition_mesh(other, 1), dtype=torch.float64,
                  device="cpu")
    with pytest.raises(ValueError, match="mesh_crc32"):
        composite_dd_unstructured(dom2, mk, poly_reduction=2, inner="jacobi",
                                  fine_mesh=other, setup_cache=cache)
    # a payload without the port's format tag (the JAX package's layout)
    pay = load_setup_payload(cache)
    pay.pop("format")
    save_setup_payload(cache, pay)
    with pytest.raises(ValueError, match="not a setup of the port"):
        composite_dd_unstructured(dom, mk, poly_reduction=2, inner="jacobi",
                                  fine_mesh=mesh, setup_cache=cache)
