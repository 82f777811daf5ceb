"""PyTorch port vs the JAX package: GLL tables, layout, mesh generation
and the one-shard partition (CPU, float64)."""

import numpy as np
import pytest
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import layout as jlayout
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.utils import gll as jgll

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import layout as tlayout
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.utils import gll as tgll

from composite_twins import one_torch_thread  # noqa: F401 (autouse)

_MESH_FIELDS = ("coords", "geom", "dirichlet_mask", "node_degree", "mass",
                "glo_num")


@pytest.mark.parametrize("n", range(2, 10))
def test_gll_tables_bitwise(n):
    for a, b in zip(jgll.gll_points_weights(n), tgll.gll_points_weights(n)):
        assert np.array_equal(a, b)
    assert np.array_equal(jgll.diff_matrix(n), tgll.diff_matrix(n))
    assert np.array_equal(jgll.interp_matrix(n, n + 2),
                          tgll.interp_matrix(n, n + 2))
    assert np.array_equal(jgll.interp_matrix(n + 1, n),
                          tgll.interp_matrix(n + 1, n))
    x = np.linspace(-1.0, 1.0, 7)
    r, _ = jgll.gll_points_weights(n)
    assert np.array_equal(jgll.lagrange_eval(r, x), tgll.lagrange_eval(r, x))


def test_layout_bitwise():
    rng = np.random.default_rng(0)
    grid, n = (3, 2, 4), 3
    a = rng.standard_normal((24, n ** 3, 2))
    lat = tlayout.elements_to_lattice(a, grid, n, 3)
    assert np.array_equal(lat, jlayout.elements_to_lattice(a, grid, n, 3))
    assert np.array_equal(tlayout.lattice_to_elements(lat, grid, n, 3),
                          a.reshape(-1, 2))


@pytest.mark.parametrize("builder", ["kershaw", "box"])
def test_mesh_matches_reference(builder):
    shape, N = (4, 4, 4), 5
    if builder == "kershaw":
        jm = jg.kershaw_mesh(shape, N, epsilon=0.3)
        tm = tg.kershaw_mesh(shape, N, epsilon=0.3, device="cpu")
    else:
        jm = jg.box_mesh(shape, N, extent=(1.0, 2.0, 0.5))
        tm = tg.box_mesh(shape, N, extent=(1.0, 2.0, 0.5), device="cpu")
    assert tm.elem_shape == jm.elem_shape
    assert tm.num_nodes == jm.num_nodes
    for k in _MESH_FIELDS:
        a, b = getattr(jm, k), getattr(tm, k)
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= 1e-13, k


def test_from_numpy_round_trips():
    tm = tg.kershaw_mesh((3, 2, 4), 3, epsilon=0.5, device="cpu")
    back = tg.GlobalMesh.from_numpy(
        coords=tm.coords, geom=tm.geom, dirichlet_mask=tm.dirichlet_mask,
        node_degree=tm.node_degree, elem_shape=tm.elem_shape,
        poly_degree=tm.poly_degree, mass=tm.mass)
    for k in _MESH_FIELDS:
        assert np.array_equal(getattr(back, k), getattr(tm, k)), k
    assert back.elem_shape == tm.elem_shape
    assert back.poly_degree == tm.poly_degree
    # and from the JAX package's mesh: the identical problem
    jm = jg.kershaw_mesh((3, 2, 4), 3, epsilon=0.5)
    fj = tg.GlobalMesh.from_numpy(
        coords=jm.coords, geom=jm.geom, dirichlet_mask=jm.dirichlet_mask,
        node_degree=jm.node_degree, elem_shape=jm.elem_shape,
        poly_degree=jm.poly_degree, mass=jm.mass)
    for k in _MESH_FIELDS:
        assert np.array_equal(getattr(fj, k), getattr(jm, k)), k


def test_one_shard_partition_matches_reference():
    jm = jg.kershaw_mesh((2, 3, 4), 3, epsilon=0.3)
    tm = tg.GlobalMesh.from_numpy(
        coords=jm.coords, geom=jm.geom, dirichlet_mask=jm.dirichlet_mask,
        node_degree=jm.node_degree, elem_shape=jm.elem_shape,
        poly_degree=jm.poly_degree, mass=jm.mass)
    js, ts = jpartition(jm, 1), tpartition(tm, 1)
    for k in ("geom", "coords", "dirichlet_mask", "inv_degree_pts",
              "glo_num", "mass"):
        assert np.array_equal(getattr(js, k), getattr(ts, k)), k
    assert ts.structured.local_grid() == js.structured.local_grid()
    assert ts.structured.layer_counts == js.structured.layer_counts
    assert ts.num_global_nodes == js.num_global_nodes
    assert ts.points_per_shard == js.points_per_shard
    # more shards partition too (tests/test_torch_partition.py holds every
    # field against the reference)
    js2, ts2 = jpartition(jm, 2), tpartition(tm, 2)
    assert ts2.structured.layer_counts == js2.structured.layer_counts
    assert np.array_equal(ts2.geom, js2.geom)


def test_geometric_factors_on_the_given_device():
    # the device argument is honoured: float64 arithmetic on the CPU here
    tm = tg.kershaw_mesh((2, 2, 2), 2, device=torch.device("cpu"))
    assert tm.geom.dtype == np.float64 and np.isfinite(tm.geom).all()
