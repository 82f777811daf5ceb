"""The composite's region field dump (io/fields.save_composite_fields)
against the JAX package's, both called directly on the same Domain and
right-hand side with no solve: tests/test_runtime.py::
test_composite_region_field_dump's Kershaw (4, 4, 4) N=3 r=2 on one shard
and its _spmd (4, 4, 8) over 2 shards (one file a shard), f64; the
unstructured composite on scrambled Kershaw (4, 4, 4) N=3 r=2 (seed 11),
whose payload-loaded setup has no region_info and raises in both
packages; and a bf16 ptype, whose values both packages write as the same
2-byte records.

Every file holds the same keys, and every array equals the JAX package's
within 1e-13 of its max (bf16: equal as uint16 views). The dump is
tree_rhs(r): the inner composite is "none", which the dump does not
read."""

from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.io.fields import save_composite_fields as jsave
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as jsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import unstructured as jun
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.io.fields import save_composite_fields as tsave
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import subdomain as tsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain

from composite_twins import composites, port_mesh
from composite_twins import one_torch_thread  # noqa: F401 (autouse)
from unstructured_twins import scrambled


def check_files(jpath, tpath, exact=False):
    j, t = np.load(jpath), np.load(tpath)
    assert sorted(t.files) == sorted(j.files)
    assert "group0_values" in t.files and "group0_coords" in t.files
    for k in j.files:
        a, b = j[k], t[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind in "USV":
            if a.dtype.kind == "V":
                a, b = a.view(np.uint16), b.view(np.uint16)
            assert np.array_equal(a, b), k
        elif exact:
            assert np.array_equal(a, b), k
        else:
            assert np.abs(a - b).max(initial=0.0) <= 1e-13 * np.abs(a).max(
                initial=0.0), k
    return t


@pytest.mark.parametrize("shape,P", [((4, 4, 4), 1), ((4, 4, 8), 2)])
def test_structured_dump_matches_reference(tmp_path, shape, P):
    jb = partial(jg.kershaw_mesh, shape, epsilon=0.3)
    jm = jb(3)
    tm = port_mesh(jm)
    kw = {} if P == 1 else {"device_mesh": jax.make_mesh((P,), ("shard",))}
    jd = JDomain(jpartition(jm, P), dtype=jnp.float64, **kw)
    td = TDomain(tpartition(tm, P), dtype=torch.float64, device="cpu")
    r = np.random.default_rng(0).standard_normal(
        ((P,) if P > 1 else ()) + td.field_shape)
    jp, tp = composites(jb, jm, tm, jd, td, poly_reduction=2, inner="none")
    jsave(str(tmp_path / "j.npz"), jd, jp, jb, jnp.asarray(r))
    tsave(str(tmp_path / "t.npz"), td, tp, lambda o: port_mesh(jb(o)),
          torch.as_tensor(r))
    names = ["j.npz"] if P == 1 else [f"j_s{p}.npz" for p in range(P)]
    assert sorted(x.name for x in tmp_path.iterdir()) == sorted(
        names + [n.replace("j", "t", 1) for n in names])
    for n in names:
        t = check_files(tmp_path / n, tmp_path / n.replace("j", "t", 1))
        assert t["group0_values"].shape + (3,) == t["group0_coords"].shape


def test_bf16_dump_matches_reference_bitwise(tmp_path):
    jb = partial(jg.kershaw_mesh, (4, 4, 4), epsilon=0.3)
    jm = jb(3)
    tm = port_mesh(jm)
    jd = JDomain(jpartition(jm, 1), dtype=jnp.float32)
    td = TDomain(tpartition(tm, 1), dtype=torch.float32, device="cpu")
    r = np.random.default_rng(0).standard_normal(td.field_shape).astype(
        np.float32)
    jp = jsub.composite_dd(jd, jb, 2, inner="none", ptype=jnp.bfloat16,
                           fine_mesh=jm)
    tp = tsub.composite_dd(td, lambda o: port_mesh(jb(o)), 2, inner="none",
                           ptype=torch.bfloat16, fine_mesh=tm)
    jsave(str(tmp_path / "j.npz"), jd, jp, jb, jnp.asarray(r))
    tsave(str(tmp_path / "t.npz"), td, tp, lambda o: port_mesh(jb(o)),
          torch.as_tensor(r))
    t = check_files(tmp_path / "j.npz", tmp_path / "t.npz", exact=True)
    assert t["group0_values"].dtype == np.dtype("V2")


def test_unstructured_dump_matches_reference(tmp_path):
    jmk, tmk = scrambled((4, 4, 4), 11)
    jm, tm = jmk(3), tmk(3)
    jd = JDomain(jpartition(jm, 1), dtype=jnp.float64)
    td = TDomain(tpartition(tm, 1), dtype=torch.float64, device="cpu")
    r = np.random.default_rng(1).standard_normal(td.field_shape)
    jp = jun.composite_dd_unstructured(jd, jmk, 2, inner="none",
                                       fine_mesh=jm)
    tp = tsub.composite_dd(td, tmk, 2, inner="none", fine_mesh=tm)
    jsave(str(tmp_path / "j.npz"), jd, jp, jmk, jnp.asarray(r))
    tsave(str(tmp_path / "t.npz"), td, tp, tmk, torch.as_tensor(r))
    t = check_files(tmp_path / "j.npz", tmp_path / "t.npz")
    assert str(t["kind"]) == "unstructured"
    assert t["group0_values"].shape + (3,) == t["group0_coords"].shape
    # a setup loaded from its payload carries no region provenance
    for build, dom, mk, save, name in (
            (lambda path: jun.composite_dd_unstructured(
                jd, jmk, 2, inner="none", fine_mesh=jm, setup_cache=path),
             jd, jmk, jsave, "j"),
            (lambda path: tsub.composite_dd(
                td, tmk, 2, inner="none", fine_mesh=tm, chain_cache=path),
             td, tmk, tsave, "t")):
        cache = str(tmp_path / f"{name}_setup.npz")
        assert build(cache).region_info is not None
        loaded = build(cache)
        assert loaded.region_info is None
        rr = jnp.asarray(r) if name == "j" else torch.as_tensor(r)
        with pytest.raises(ValueError, match="no region_info"):
            save(str(tmp_path / f"{name}_cached.npz"), dom, loaded, mk, rr)
