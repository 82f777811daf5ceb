"""The port's Nek5000-export I/O (mesh/nek.py) on the CPU: the twins of
the six tests of tests/test_nek_io.py (write / read round trips in 3-D,
2-D and scrambled, the order listing and builder, a truncated file
refused, a composite solve on a read-back mesh equal to the original's),
and the format across the packages: both writers give the same bytes for
the same mesh, and an export written by either package reads in the
other to the same arrays, bitwise."""

import filecmp
import os

import numpy as np
import pytest
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import nek as jnek

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import nek
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import subdomain as sub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain

from composite_twins import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
FIELDS = ("coords", "glo_num", "dirichlet_mask", "node_degree", "geom")


def _roundtrip(mesh, tmp_path, num_ranks):
    level = nek.write_nek_dir(str(tmp_path), mesh, num_ranks=num_ranks)
    assert os.path.isdir(level)
    return nek.read_nek_dir(str(tmp_path), mesh.poly_degree,
                            validate_geom=True, device=CPU)


@pytest.mark.parametrize("num_ranks", [1, 3])
def test_roundtrip_kershaw_3d(tmp_path, num_ranks):
    mesh = tg.kershaw_mesh((3, 4, 5), 3, epsilon=0.3, device=CPU)
    back = _roundtrip(mesh, tmp_path, num_ranks)
    assert back.dim == 3 and back.poly_degree == 3
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(back, name), getattr(mesh, name))
    np.testing.assert_allclose(back.mass, mesh.mass, rtol=1e-13)
    assert back.structured_layout is False


def test_roundtrip_2d(tmp_path):
    mesh = tg.kershaw_mesh((4, 6), 4, epsilon=0.5, device=CPU)
    back = _roundtrip(mesh, tmp_path, 2)
    assert back.dim == 2 and back.num_geom == 3
    np.testing.assert_array_equal(back.coords, mesh.coords)
    np.testing.assert_array_equal(back.geom, mesh.geom)


def test_roundtrip_unstructured_scrambled(tmp_path):
    mesh = tg.scramble_mesh(tg.kershaw_mesh((3, 3, 3), 2, epsilon=0.3,
                                            device=CPU), seed=5, device=CPU)
    back = _roundtrip(mesh, tmp_path, 2)
    np.testing.assert_array_equal(back.coords, mesh.coords)
    np.testing.assert_array_equal(back.glo_num, mesh.glo_num)
    assert back.structured_layout is False


def test_available_orders_and_builder(tmp_path):
    for o in (3, 1):
        nek.write_nek_dir(str(tmp_path), tg.box_mesh((2, 2, 2), o, device=CPU),
                          num_ranks=1)
    assert nek.available_orders(str(tmp_path)) == [1, 3]
    builder = nek.nek_mesh_builder(str(tmp_path), device=CPU)
    m1 = builder(1)
    assert m1.poly_degree == 1 and m1.num_elements == 8


def test_corrupt_sizes_rejected(tmp_path):
    mesh = tg.box_mesh((2, 2), 2, device=CPU)
    level = nek.write_nek_dir(str(tmp_path), mesh, num_ranks=1)
    # truncate one binary file -> loud failure, not silent garbage
    path = os.path.join(level, "x_0.2.dat")
    with open(path, "rb") as fh:
        data = fh.read()
    with open(path, "wb") as fh:
        fh.write(data[:-8])
    with pytest.raises(ValueError, match="expected"):
        nek.read_nek_dir(str(tmp_path), 2, device=CPU)


def test_solve_on_nek_readback_matches_original(tmp_path):
    """The composite solve on the read-back mesh repeats the original
    mesh's history (the format carries everything the solver uses)."""
    shape = (2, 2, 4)
    base = lambda o: tg.scramble_mesh(
        tg.kershaw_mesh(shape, o, epsilon=0.4, device=CPU), seed=2,
        permute=False, device=CPU)
    for o in (3, 1):
        nek.write_nek_dir(str(tmp_path), base(o), num_ranks=2)
    builder = nek.nek_mesh_builder(str(tmp_path), device=CPU)
    hists = []
    for mk in (base, builder):
        mesh = mk(3)
        dom = Domain(partition_mesh(mesh, 1), dtype=torch.float64, device=CPU)
        u_star = dom.initial_function(4, seed=3)
        f = dom.manufacture_rhs(u_star)
        pre = sub.composite_dd(dom, mk, poly_reduction=2, inner="amg",
                               fine_mesh=mesh)
        res = dom.solver(method="fgmres", max_iterations=60,
                         tolerance=1e-8, precond=pre)(f)
        assert bool(res.converged)
        h = res.residual_history.numpy()
        hists.append(h[np.isfinite(h)])
    np.testing.assert_allclose(hists[0], hists[1], rtol=1e-10)


# ---- across the packages ----

@pytest.mark.parametrize("mesh_of", [
    lambda: jg.kershaw_mesh((3, 4, 5), 3, epsilon=0.3),
    lambda: jg.kershaw_mesh((4, 6), 4, epsilon=0.5),
    lambda: jg.scramble_mesh(jg.kershaw_mesh((3, 3, 3), 2, epsilon=0.3),
                             seed=5),
], ids=["kershaw-3d", "kershaw-2d", "scrambled"])
def test_both_writers_give_the_same_bytes(tmp_path, mesh_of):
    mesh = mesh_of()
    a = nek.write_nek_dir(str(tmp_path / "port"), mesh, num_ranks=3)
    b = jnek.write_nek_dir(str(tmp_path / "jax"), mesh, num_ranks=3)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == 3 * (
        4 + mesh.dim + mesh.num_geom)
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors and len(match) == len(names)


def _same_arrays(got, want):
    assert got.dim == want.dim and got.poly_degree == want.poly_degree
    assert tuple(got.elem_shape) == tuple(want.elem_shape)
    assert got.structured_layout is False and want.structured_layout is False
    for name in FIELDS:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_jax_export_reads_in_the_port(tmp_path):
    mesh = jg.scramble_mesh(jg.kershaw_mesh((3, 3, 4), 3, epsilon=0.3),
                            seed=5)
    jnek.write_nek_dir(str(tmp_path), mesh, num_ranks=4)
    _same_arrays(nek.read_nek_dir(str(tmp_path), 3, validate_geom=True,
                                  device=CPU),
                 jnek.read_nek_dir(str(tmp_path), 3, validate_geom=True))


def test_port_export_reads_in_the_jax_package(tmp_path):
    mesh = tg.scramble_mesh(tg.kershaw_mesh((3, 3, 4), 3, epsilon=0.3,
                                            device=CPU), seed=5, device=CPU)
    nek.write_nek_dir(str(tmp_path), mesh, num_ranks=4)
    got = jnek.read_nek_dir(str(tmp_path), 3, validate_geom=True)
    _same_arrays(got, nek.read_nek_dir(str(tmp_path), 3, validate_geom=True,
                                       device=CPU))
    for name in FIELDS:
        assert np.array_equal(np.asarray(getattr(got, name)),
                              getattr(mesh, name)), name
