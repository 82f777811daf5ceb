"""The port's pebble-bed meshes (mesh/pebble.py) against the JAX
package's: packing, the carving helpers and the mesh bitwise (geometry
to 1e-14), and the unstructured composite on a pebble bed (6^3
background, 4 pebbles, seed 2: tests/test_pebble.py's configuration),
whole outer solves in f64 against the JAX package's. Helpers:
tests/unstructured_twins.py."""

import numpy as np
import pytest

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import pebble as jpb
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.unstructured import composite_dd_unstructured as jcomposite
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import pebble as tpb
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.unstructured import composite_dd_unstructured as tcomposite

from unstructured_twins import Twin, pebbles
from unstructured_twins import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("shape,num,seed,frac", [
    ((6, 6, 6), 4, 2, 0.25), ((16, 16, 16), 24, 5, 0.3),
    ((8, 8, 8), 40, 1, 0.25),
    # the reference's families PB_146 and PB_1568
    # (artifacts/run_pebble_production.py)
    ((32, 32, 32), 146, 5, 0.2), ((48, 48, 48), 1568, 5, 0.15)])
def test_pack_pebbles_matches_reference(shape, num, seed, frac):
    jc, jr = jpb.pack_pebbles(shape, num, seed, frac)
    tc, tr = tpb.pack_pebbles(shape, num, seed, frac)
    assert np.array_equal(jc, tc) and jr == tr


@pytest.mark.parametrize("shape,N,num,seed", [((6, 6, 6), 3, 4, 2),
                                              ((8, 8, 8), 2, 4, 2),
                                              ((5, 6, 7), 2, 6, 3)])
def test_pebble_mesh_matches_reference(shape, N, num, seed):
    jm = jpb.pebble_mesh(shape, N, num_pebbles=num, seed=seed)
    tm = tpb.pebble_mesh(shape, N, num_pebbles=num, seed=seed, device="cpu")
    assert not tm.structured_layout
    for key in ("coords", "glo_num", "node_degree", "dirichlet_mask"):
        a, b = getattr(jm, key), getattr(tm, key)
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    for key in ("geom", "mass"):
        a, b = getattr(jm, key), getattr(tm, key)
        assert np.abs(a - b).max() <= 1e-14 * np.abs(a).max(), key
    # the carving helpers on the same lattice
    rng = np.random.default_rng(seed)
    keep = rng.random(int(np.prod(shape))) > 0.4
    lc = tpb._largest_component(keep, shape)
    assert np.array_equal(lc, jpb._largest_component(keep, shape))
    kept = np.flatnonzero(lc)
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.generator import _reference_coords
    _, glo, _ = _reference_coords(shape, N)
    glo = glo.reshape(-1, (N + 1) ** 3)[kept]
    nn = int(glo.max()) + 1
    assert np.array_equal(
        tpb._boundary_node_mask(glo, lc, kept, shape, N, nn),
        jpb._boundary_node_mask(glo, lc, kept, shape, N, nn))


@pytest.fixture(scope="module")
def twin():
    return Twin(pebbles((6, 6, 6), 4, 2), 3, 1, seed=0)


def test_pebble_composite_matches_reference(twin):
    # the amg inner: 4 outer iterations to 1e-8 in both, each step ~200x
    # down; the histories agree to ~1e-12 over 3 steps, 5.6e-9 at step 4
    # (2.2e-9 of r0 10.5: 1.2e-17 apart)
    jp, tp = twin.composites(jcomposite, tcomposite, poly_reduction=2,
                             inner="amg")
    twin.check_apply(jp, tp)
    rj, rt = twin.solve_both(jp, tp)
    assert rt.iterations == 4
    twin.check_outer(rj, rt, 3)
