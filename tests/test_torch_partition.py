"""The port's partition_mesh against the JAX package's, field by field and
bitwise: balanced q / q+1 slab layers with padding, the generic
contiguous split, the gather/scatter plan and the interface nodes, at
P = 1, 3, 4, 5 and 8, structured and generic, including shards with no
layers. Both packages partition the identical mesh (the JAX mesh's arrays
go across with GlobalMesh.from_numpy)."""

import numpy as np
import pytest

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition

ARRAYS = ("geom", "mass", "coords", "dirichlet_mask", "glo_num",
          "elem_valid", "inv_degree_pts", "gather_ids", "node_valid",
          "inv_degree", "bnode_local", "bnode_global")
SCALARS = ("dim", "poly_degree", "num_shards", "num_total_elements",
           "num_global_nodes", "num_local_nodes", "num_boundary_global",
           "elem_offsets", "elems_per_shard", "points_per_shard",
           "num_points_per_elem")
MESHES = {
    "box_2x2x8_N2": lambda: jg.box_mesh((2, 2, 8), 2),
    "kershaw_4x4x7_N3": lambda: jg.kershaw_mesh((4, 4, 7), 3, 0.3),
    "box_2x2x2_N2": lambda: jg.box_mesh((2, 2, 2), 2),
}
CASES = ([("box_2x2x8_N2", P) for P in (1, 3, 4, 5, 8)]
         + [("kershaw_4x4x7_N3", P) for P in (1, 3, 4, 5, 8)]
         + [("box_2x2x2_N2", 8)])


def port_mesh(m):
    return tg.GlobalMesh.from_numpy(
        coords=m.coords, geom=m.geom, dirichlet_mask=m.dirichlet_mask,
        node_degree=m.node_degree, elem_shape=m.elem_shape,
        poly_degree=m.poly_degree, mass=m.mass)


@pytest.fixture(scope="module")
def meshes():
    out = {}
    for name, make in MESHES.items():
        jm = make()
        out[name] = (jm, port_mesh(jm))
    return out


@pytest.mark.parametrize("structured", [True, False])
@pytest.mark.parametrize("name,P", CASES)
def test_partition_matches_reference_bitwise(meshes, name, P, structured):
    jm, tm = meshes[name]
    a = jpartition(jm, P, structured=structured)
    b = tpartition(tm, P, structured=structured)
    for f in ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f
    for f in SCALARS:
        assert getattr(a, f) == getattr(b, f), f
    if structured:
        sa, sb = a.structured, b.structured
        assert sb is not None
        for f in ("elem_shape", "slab_elems", "poly_degree", "layer_counts",
                  "ragged", "layer_starts"):
            assert getattr(sa, f) == getattr(sb, f), f
        assert sa.local_grid() == sb.local_grid()
    else:
        assert b.structured is None


def test_balanced_partition_layout():
    # twin of tests/test_ragged.py::test_balanced_partition_layout
    mesh = tg.box_mesh((2, 2, 8), 2, device="cpu")
    sd = tpartition(mesh, 3)
    st = sd.structured
    assert st.layer_counts == (3, 3, 2)
    assert st.layer_starts == (0, 3, 6)
    assert st.ragged and st.slab_elems == 3
    assert int(sd.elem_valid.sum()) == mesh.num_elements
    sd4 = tpartition(mesh, 4)
    assert sd4.structured.layer_counts == (2, 2, 2, 2)
    assert not sd4.structured.ragged
    # more shards than layers: the last shards hold padding only
    sd8 = tpartition(tg.box_mesh((2, 2, 2), 2, device="cpu"), 8)
    assert sd8.structured.layer_counts == (1, 1, 0, 0, 0, 0, 0, 0)
    assert not sd8.elem_valid[2:].any()
    assert not sd8.dirichlet_mask[2:].any()
    assert (sd8.glo_num[2:] == -1).all()


def test_partition_refusals():
    mesh = tg.box_mesh((2, 2, 2), 2, device="cpu")
    with pytest.raises(ValueError):
        tpartition(mesh, 0)
    mesh.structured_layout = False
    with pytest.raises(ValueError):
        tpartition(mesh, 2, structured=True)
    assert tpartition(mesh, 2).structured is None     # "auto" goes generic
