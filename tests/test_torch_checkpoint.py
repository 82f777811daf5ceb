"""The port's setup checkpoints (runtime/checkpoint.py) against the JAX
package's on the CPU: hierarchies, meshes, generic setup payloads and the
vertex chain round trip in the port, and a file either package writes
loads in the other with equal arrays (the same npz layouts)."""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.amg import composite as jcomp
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops.csr import bsr_from_csr
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.runtime import checkpoint as jck
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.subdomain import _build_group_specs as j_group_specs

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.amg import composite as tcomp
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime import checkpoint as tck
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.subdomain import _build_group_specs as t_group_specs

from composite_twins import one_torch_thread  # noqa: F401 (autouse)

MESH_FIELDS = ("coords", "glo_num", "node_degree", "dirichlet_mask", "geom",
               "mass")


def _csr_equal(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def _hier_equal(a, b):
    assert len(a.mats) == len(b.mats) and len(a.prolongs) == len(b.prolongs)
    assert all(_csr_equal(x, y) for x, y in zip(a.mats, b.mats))
    assert all(_csr_equal(x, y) for x, y in zip(a.prolongs, b.prolongs))
    assert _csr_equal(a.Q, b.Q)
    assert np.array_equal(np.asarray(a.lmaxs), np.asarray(b.lmaxs))
    assert np.array_equal(a.coarse_inv, b.coarse_inv)
    assert np.array_equal(a.dof_mask, b.dof_mask)


def _mesh_equal(a, b):
    assert (a.dim, a.poly_degree, tuple(a.elem_shape),
            bool(a.structured_layout)) == (b.dim, b.poly_degree,
                                           tuple(b.elem_shape),
                                           bool(b.structured_layout))
    for k in MESH_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert isinstance(y, np.ndarray), k
        assert np.array_equal(np.asarray(x), y), k


@pytest.fixture(scope="module")
def hierarchies():
    """The same one-shard composite hierarchy built by both packages
    (tests/test_runtime.py::test_checkpoint_roundtrip's configuration)."""
    jm = jg.box_mesh((3, 3, 6), 2)
    tm = tg.box_mesh((3, 3, 6), 2, device="cpu")
    jh = jcomp.build_composite_hierarchy(j_group_specs(6, 1, 1, [2], 6),
                                         {2: jm}, (3, 3), 6, 0, 3)
    th = tcomp.build_composite_hierarchy(t_group_specs(6, 1, 1, [2], 6),
                                         {2: tm}, (3, 3), 6, 0, 3)
    return jh, th


def test_checkpoint_roundtrip(hierarchies, tmp_path):
    _, th = hierarchies
    path = str(tmp_path / "setup.npz")
    tck.save_hierarchies(path, [th])
    back = tck.load_hierarchies(path)
    assert len(back) == 1
    h0, h1 = th, back[0]
    assert len(h0.mats) == len(h1.mats)
    for a, b in zip(h0.mats, h1.mats):
        assert abs(a - b).max() == 0.0
    assert abs(h0.Q - h1.Q).max() == 0.0
    assert np.allclose(h0.coarse_inv, h1.coarse_inv)
    assert np.allclose(h0.lmaxs, h1.lmaxs)
    _hier_equal(h0, h1)


def test_hierarchies_cross_load(hierarchies, tmp_path):
    jh, th = hierarchies
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_hierarchies(jpath, [jh, jh])
    tck.save_hierarchies(tpath, [th])
    # a JAX-written pair of shards loads in the port with equal arrays,
    # and the port's file in the JAX package
    for h in tck.load_hierarchies(jpath):
        _hier_equal(jh, h)
    _hier_equal(th, jck.load_hierarchies(tpath)[0])


def test_mesh_round_trip_and_cross_load(tmp_path):
    tm = tg.scramble_mesh(tg.kershaw_mesh((2, 2, 3), 2, 0.3, device="cpu"),
                          seed=4, device="cpu")
    path = str(tmp_path / "tmesh.npz")
    tck.save_mesh(path, tm)
    _mesh_equal(tm, tck.load_mesh(path))
    assert not tck.load_mesh(path).structured_layout
    # a field held as a torch tensor is saved as numpy
    tm.geom = torch.as_tensor(tm.geom)
    tck.save_mesh(path, tm)
    assert np.array_equal(tck.load_mesh(path).geom, tm.geom.numpy())
    # the JAX package's file loads in the port, the port's in the JAX
    # package
    jm = jg.kershaw_mesh((2, 2, 3), 3, 0.3)
    jpath = str(tmp_path / "jmesh.npz")
    jck.save_mesh(jpath, jm)
    _mesh_equal(jm, tck.load_mesh(jpath))
    _mesh_equal(tck.load_mesh(jpath), jck.load_mesh(jpath))


def test_cached_mesh_builder_builds_each_order_once(tmp_path):
    calls = []

    def builder(order):
        calls.append(order)
        return tg.box_mesh((2, 2, 2), order, device="cpu")

    cached = tck.cached_mesh_builder(builder, str(tmp_path / "cache"), "box")
    first = {o: cached(o) for o in (1, 3, 1, 3, 2)}
    assert calls == [1, 3, 2]
    again = tck.cached_mesh_builder(builder, str(tmp_path / "cache"), "box")
    for o in (1, 2, 3):
        _mesh_equal(first[o], again(o))
    assert calls == [1, 3, 2]
    assert sorted(os.listdir(tmp_path / "cache")) == [
        f"mesh_box_N{o}.npz" for o in (1, 2, 3)]


def _payload():
    rng = np.random.default_rng(0)
    A = sp.random(7, 5, density=0.4, random_state=1, format="csr")
    return {
        "arr": rng.random((3, 4)), "ints": np.arange(6, dtype=np.int32),
        "csr": A, "coo": sp.random(4, 4, density=0.5, random_state=2,
                                   format="coo"),
        "nested": {"list": [1, 2.5, "s", None, True, np.float64(0.1)],
                   "tuple": (np.int64(3), rng.random(2), [A, None])},
        "none": None, "flag": False, "x": 1e-300, "n": 7, "name": "abc",
    }


def _tree_equal(a, b):
    if sp.issparse(a):
        assert sp.isspmatrix_csr(b) and _csr_equal(a, b)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        assert np.array_equal(a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    else:
        assert a == b and type(b) is type(a.item() if hasattr(a, "item")
                                           else a)


def test_setup_payload_round_trip_and_cross_load(tmp_path):
    pay = _payload()
    path = str(tmp_path / "pay.npz")
    tck.save_setup_payload(path, pay)
    # written atomically: no temporary file stays behind
    assert os.listdir(tmp_path) == ["pay.npz"]
    _tree_equal(pay, tck.load_setup_payload(path))
    # raw npz: no member is compressed
    import zipfile
    with zipfile.ZipFile(path) as z:
        assert {i.compress_type for i in z.infolist()} == {zipfile.ZIP_STORED}
    # the JAX package's file of the same tree loads in the port, and the
    # port's in the JAX package
    jpath = str(tmp_path / "jpay.npz")
    jck.save_setup_payload(jpath, pay)
    _tree_equal(pay, tck.load_setup_payload(jpath))
    _tree_equal(pay, jck.load_setup_payload(path))
    # a BSR node, which only the JAX package writes, does not load
    jck.save_setup_payload(jpath, {"A": bsr_from_csr(pay["csr"], block=2)})
    with pytest.raises(ValueError, match="BSR"):
        tck.load_setup_payload(jpath)
    with pytest.raises(TypeError):
        tck.save_setup_payload(path, {"t": torch.zeros(2)})


def test_chain_info_lives_in_checkpoint(tmp_path):
    # the vertex chain's checkpoint moved from amg/composite.py to
    # runtime/checkpoint.py, where the JAX package keeps it
    assert not hasattr(tcomp, "save_chain_info")
    assert not hasattr(tcomp, "load_chain_info")
    tm = tg.kershaw_mesh((3, 3, 4), 1, 0.3, device="cpu")
    jm = jg.kershaw_mesh((3, 3, 4), 1, 0.3)
    tinfo = tcomp.vertex_q1_hierarchy(tm, (3, 3), 4, 3, max_coarse=20)
    jinfo = jcomp.vertex_q1_hierarchy(jm, (3, 3), 4, 3, max_coarse=20)
    assert len(tinfo["mats"]) > 1
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tck.save_chain_info(tpath, tinfo)
    jck.save_chain_info(jpath, jinfo)
    for path, info in ((tpath, tinfo), (jpath, jinfo)):
        for load in (tck.load_chain_info, jck.load_chain_info):
            back = load(path)
            assert back["shapes"] == [tuple(s) for s in info["shapes"]]
            for key in ("mats", "prolongs"):
                assert all(_csr_equal(a, b)
                           for a, b in zip(info[key], back[key]))
            for key in ("masks", "lmaxs"):
                assert all(np.array_equal(a, b)
                           for a, b in zip(info[key], back[key]))
            assert all(np.array_equal(a, b)
                       for fa, fb in zip(info["factors"], back["factors"])
                       for a, b in zip(fa, fb))
            assert np.array_equal(info["coarse_inv"], back["coarse_inv"])
