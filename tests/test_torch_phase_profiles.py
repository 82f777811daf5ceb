"""The port of the JAX package's region profiles (``artifacts/
phase_p8_32cubed.py``, ``phase_unstructured.py``, ``phase_64cubed.py``;
``..._torch/studies/phase_profiles.py``): the region arithmetic against
both records' chains and regions, the ``p8`` profile over P = 8 in f64
(every part its chains run against the JAX package's within 1e-12 of
max, the tree kinds' chain scalars against its ``Domain.phase_chain`` at
rtol 1e-12), and the ``unstructured`` and ``cube`` profiles' records at
(4, 4, 4) N=3."""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import PartitionSpec as P

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import domain as jdomain_mod
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as jsub

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies import phase_profiles as pp

from composite_twins import KERSHAW2216, pair, port_mesh
from composite_twins import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kinds whose chain scalar is a value of the part (the others end in
# a normalization, whose scalar reads 1 for any input)
TREE_KINDS = {"tree_cascade", "tree_rhs", "tree_rings", "tree_coarse"}
# the structured composite's parts with inner="amg"
P8_PARTS = {"tree_rhs", "tree_cascade", "tree_rings", "tree_coarse",
            "comp_operator", "comp_dssum", "comp_assemble", "inner_precond",
            "inner_smooth", "inner_transfer", "inner_coarse"}
RECORDS = {"p8": ("phase_p8_32cubed.json", "raw_ms", pp.p8_regions),
           "unstructured": ("phase_unstructured_16cubed.json", "chains_ms",
                            pp.unstructured_regions)}


def _record(name):
    with open(os.path.join(ROOT, "artifacts", name)) as fh:
        return json.load(fh)


@pytest.mark.parametrize("profile", sorted(RECORDS))
def test_regions_reproduce_the_record(profile):
    name, chains, regions = RECORDS[profile]
    rec = _record(name)
    # the script forms its regions in seconds and writes them in ms
    got = regions({k: v / 1e3 for k, v in rec[chains].items()})
    got = {k: v * 1e3 for k, v in got.items()}
    assert list(got) == list(rec["regions_ms"])
    for k, want in rec["regions_ms"].items():
        assert got[k] == pytest.approx(want, rel=1e-12, abs=0.0), k
    assert list(rec[chains]) == list(pp.KINDS[profile])


def test_clipping_is_the_scripts():
    # p8 clips at 0 (its superdomain region reads 0.0 from a negative
    # difference); the unstructured record keeps its negative operator row
    raw = _record("phase_p8_32cubed.json")["raw_ms"]
    assert (raw["tree_rhs"] - raw["tree_rings"] - raw["tree_coarse"]
            + raw["tree_cascade"]) < 0.0
    assert pp.p8_regions(raw)[
        "subdomain.tree_exchange.superdomain (far restrict)"] == 0.0
    ch = _record("phase_unstructured_16cubed.json")["chains_ms"]
    assert pp.unstructured_regions(ch)["domain.operator_application"] == \
        pytest.approx(-0.2677241961161294, rel=1e-12)


def jax_parts(jd, jp, f):
    """Every part of the JAX composite on f under shard_map (the tree
    parts on f, the composite-space parts on its composite right-hand
    side), each output's leaves stacked over the shards as (P, ...)."""
    ax = jd.axis_name
    specs = jp.extra_specs(ax)
    keys = set()

    def call(key, x):
        def impl(arrays, extra, x):
            arrays = jdomain_mod._squeeze_shard(arrays)
            fn = jp.build(arrays, jd._squeeze_extra(extra, specs),
                          jd._ops(arrays))
            keys.update(fn.parts)
            out = fn.parts[key](jax.tree.map(lambda a: a[0], x))
            return jax.tree.map(lambda a: a[None], out)

        return jax.jit(jax.shard_map(
            impl, mesh=jd.device_mesh,
            in_specs=(jdomain_mod._specs(ax, jd.arrays), specs, P(ax)),
            out_specs=P(ax)))(jd.arrays, jp.extra, x)

    rhs = call("tree_rhs", f)
    return rhs, {k: [np.asarray(w) for w in jax.tree.leaves(
        call(k, f if k.startswith("tree_") else rhs))]
        for k in sorted(keys)}


def test_p8_chains_match_reference():
    # the p8 profile's 15 kinds over 8 shards of Kershaw (2, 2, 16) N=3,
    # r=2, in f64. Every part the chains run against the JAX package's
    # within 1e-12 of its max (tests/test_torch_composite_parts.py's check
    # at P = 1), and the tree kinds' chain scalars at rtol 1e-12; the
    # composite-space chains' scalars are |x|^2 after a scale by the rsqrt
    # of x's own dot, 1 for any x, so they hold nothing and are held only
    # finite
    jb = KERSHAW2216
    jm, tm, jd, td, _, f = pair(jb, 3, 8, seed=0)
    jp = jsub.composite_dd(jd, jb, poly_reduction=2, inner="amg",
                           ptype=jnp.float64, num_iterations=4, fine_mesh=jm)
    tf = torch.as_tensor(np.array(f))
    s = pp.build_setup("p8", shards=8, device="cpu", setup=pp.Setup(
        mesh_builder=lambda o: port_mesh(jb(o)), mesh=tm, f=tf),
        shape=(2, 2, 16), order=3, poly_reduction=2, dtype=torch.float64,
        ptype=torch.float64)
    buf = io.StringIO()
    rec = pp.run("p8", shards=8, chain_iters=1, repeats=1, setup=s, out=buf,
                 shape=(2, 2, 16), order=3, poly_reduction=2)
    assert list(rec["raw_ms"]) == list(pp.KINDS["p8"])
    assert buf.getvalue().count("ms/app") == len(pp.KINDS["p8"])
    assert set(rec) >= {"mesh", "shards", "backend", "chain_iters",
                        "raw_ms", "regions_ms", "card", "stages"}
    assert rec["shards"] == 8 and rec["chain_iters"] == 1
    assert list(rec["regions_ms"]) == list(
        _record("phase_p8_32cubed.json")["regions_ms"])
    assert all(v >= 0.0 for v in rec["regions_ms"].values())
    assert set(rec["stages"]["seconds"]) == {"chains"}

    # the parts: the composite-space ones on the JAX package's composite
    # right-hand side, in the port's layout
    jrhs, want = jax_parts(jd, jp, f)
    parts = s.precond.build(s.dom.arrays, s.precond.extra,
                            s.dom._ops()).parts
    assert set(parts) == set(want) == P8_PARTS
    tx = [torch.as_tensor(np.array(j)).reshape(t.shape)
          for j, t in zip(jrhs, parts["tree_rhs"](tf))]
    for key in sorted(want):
        out = parts[key](tf if key.startswith("tree_") else tx)
        got = [g.numpy() for g in jax.tree.leaves(out)]
        assert len(got) == len(want[key]), key
        scale = max(np.abs(w).max(initial=0.0) for w in want[key])
        assert scale > 0.0, key
        err = max(np.abs(g.reshape(-1) - w.reshape(-1)).max(initial=0.0)
                  for g, w in zip(got, want[key]))
        assert err <= 1e-12 * scale, (key, err, scale)

    # the chains: every kind's scalar finite, the tree kinds' equal
    for kind in pp.KINDS["p8"]:
        got = s.dom.phase_chain(s.precond, kind, 1)(tf)
        assert np.isfinite(got), kind
        if kind in TREE_KINDS:
            want = float(jd.phase_chain(jp, kind, 1)(f))
            np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=kind)
    assert abs(s.dom.phase_chain(s.precond, "tree_rhs", 1)(tf)) > 1e-6


@pytest.mark.parametrize("profile", ["unstructured", "cube"])
def test_small_profiles_give_every_record_key(profile):
    buf = io.StringIO()
    rec = pp.run(profile, chain_iters=1, repeats=1, device="cpu", out=buf,
                 shape=(4, 4, 4), order=3, poly_reduction=2)
    if profile == "unstructured":
        want = _record("phase_unstructured_16cubed.json")
        assert list(rec["chains_ms"]) == list(want["chains_ms"])
        assert list(rec["regions_ms"]) == list(want["regions_ms"])
        values = list(rec["chains_ms"].values())
    else:
        # the record predates the round-5 kinds: its 9 keys come first
        want = _record("phase_64cubed.json")
        assert list(pp.KINDS["cube"])[:len(want)] == list(want)
        values = [rec[k] for k in pp.KINDS["cube"]]
    assert all(np.isfinite(v) and v >= 0.0 for v in values)
    assert rec["card"] == "cpu" and rec["backend"] == "cpu"
    assert set(rec["stages"]["seconds"]) == {
        "mesh", "partition", "domain", "preconditioner", "rhs", "chains"}
    assert json.loads(json.dumps(rec)) == rec
    assert buf.getvalue().count("ms/app") == len(pp.KINDS[profile])


def test_command_line_rejects_extra_numbers():
    with pytest.raises(SystemExit):
        pp.main(["cube", "8", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="profile"):
        pp.run("p16", device="cpu")
