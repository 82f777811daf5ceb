"""The port's host f64 oracle (solvers/host_oracle.py) on the CPU: the
twins of tests/test_host_oracle.py's operator parity and refinement
tests, with the port's HostOperator bitwise equal to the JAX package's on
the same mesh arrays, 3-D and 2-D (the 2-D branch on the JAX package's
2-D mesh and on the port's own, where it also equals the port's 2-D
Domain; the 2-D refinement twins are tests/test_torch_2d_composite.py's).
The JAX test of multi-shard refinement is 2-D; its twin here runs the
same steps on a 3-D mesh over 8 shards. The owned <-> global maps across
two processes cover 3-D and 2-D partitions."""

from functools import partial

import numpy as np
import pytest
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.host_oracle import HostOperator as JHostOperator

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.host_oracle import (
    HostOperator, global_to_owned, host_refine_solve, owned_to_global)
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.refine import refine_solve
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.subdomain import composite_dd

from composite_twins import one_torch_thread  # noqa: F401 (autouse)
import multiprocess_twins as mt


def _bitwise_vs_reference(mesh, vals):
    """The port's HostOperator and the JAX package's on the same mesh
    arrays: apply, dssum and residual norm bitwise."""
    t, j = HostOperator(mesh, chunk=7), JHostOperator(mesh, chunk=7)
    assert np.array_equal(t.D, j.D)
    au = t.apply(vals)
    assert np.array_equal(au, j.apply(vals))
    for mask in (True, False):
        assert np.array_equal(t.dssum(vals, apply_mask=mask),
                              j.dssum(vals, apply_mask=mask))
    assert t.residual_norm(au) == j.residual_norm(au)
    r_t, rn_t = t.residual(vals, 2.0 * au)
    r_j, rn_j = j.residual(vals, 2.0 * au)
    assert np.array_equal(r_t, r_j) and rn_t == rn_j
    return au


def test_host_operator_matches_device_f64():
    mesh = tg.kershaw_mesh((3, 4, 5), 3, epsilon=0.3, device="cpu")
    dom64 = Domain(partition_mesh(mesh, 1), dtype=torch.float64,
                   device="cpu")
    host = HostOperator(mesh, chunk=7)

    rng = np.random.default_rng(3)
    vals = rng.random(mesh.num_points)
    u = dom64.to_device_field(vals.reshape(1, -1))
    au_dev = dom64.from_device_field(dom64.manufacture_rhs(u)).reshape(-1)
    au_host = host.apply(vals)
    assert np.allclose(au_dev, au_host, rtol=1e-12, atol=1e-12)

    f = dom64.manufacture_rhs(u)
    _, rn_dev = dom64.residual(u, f)
    _, rn_host = host.residual(vals, au_host)
    assert abs(float(rn_dev) - rn_host) <= 1e-10 * max(rn_host, 1.0)

    s_dev = dom64.from_device_field(dom64.dssum_field(u)).reshape(-1)
    assert np.allclose(s_dev, host.dssum(vals), rtol=1e-12, atol=1e-12)

    # the JAX package's HostOperator on the JAX package's mesh of the same
    # shape: the port's on those arrays is bitwise equal to it, and the
    # two meshes agree
    jm = jg.kershaw_mesh((3, 4, 5), 3, epsilon=0.3)
    np.testing.assert_allclose(mesh.geom, jm.geom, rtol=1e-13, atol=1e-14)
    _bitwise_vs_reference(jm, vals)
    _bitwise_vs_reference(mesh, vals)


def test_host_operator_2d_matches_reference():
    # the 2-D branch on the JAX package's 2-D mesh and on the port's own
    jm = jg.kershaw_mesh((6, 5), 4, epsilon=0.3)
    assert jm.dim == 2 and jm.geom.shape[-1] == 3
    vals = np.random.default_rng(1).random(jm.num_points)
    au = _bitwise_vs_reference(jm, vals)
    # a constant field has a zero image (the operator's null space)
    assert np.abs(HostOperator(jm).apply(np.ones(jm.num_points))).max() \
        <= 1e-12 * np.abs(au).max()
    tm = tg.kershaw_mesh((6, 5), 4, epsilon=0.3, device="cpu")
    au_t = _bitwise_vs_reference(tm, vals)
    np.testing.assert_allclose(au_t, au, rtol=0, atol=1e-12 * np.abs(au).max())
    # the port's 2-D Domain (structured and generic) applies the same
    # operator and sums the same nodes
    host = HostOperator(tm)
    for structured in (True, False):
        dom = Domain(partition_mesh(tm, 1, structured=structured),
                     dtype=torch.float64, device="cpu")
        u = dom.to_device_field(vals.reshape(1, -1))
        got = dom.from_device_field(dom.apply_operator(u)).reshape(-1)
        assert np.allclose(got, au_t, rtol=1e-12, atol=1e-12)
        got = dom.from_device_field(dom.dssum_field(u)).reshape(-1)
        assert np.allclose(got, host.dssum(vals), rtol=1e-12, atol=1e-12)


def test_host_refinement_multi_shard_p8():
    # the JAX package's test on Kershaw (8, 8) N=4 over 8 shards, in 3-D:
    # Kershaw (2, 2, 8) N=4 over 8 slab shards, the f32 solver unpreconditioned
    mesh = tg.kershaw_mesh((2, 2, 8), 4, epsilon=0.3, device="cpu")
    dom32 = Domain(partition_mesh(mesh, 8), dtype=torch.float32,
                   device="cpu")
    host = HostOperator(mesh)

    # layout round trip: global -> owned -> global is the identity
    g = np.random.default_rng(0).random(mesh.num_points)
    owned = global_to_owned(dom32, g)
    assert owned.shape == (8, dom32.sharded.points_per_shard)
    assert np.array_equal(owned_to_global(dom32, owned), g)

    u_star = owned_to_global(
        dom32, dom32.from_device_field(dom32.initial_function(4, seed=0)))
    f64 = host.apply(u_star)
    solve32 = dom32.solver(method="fgmres", max_iterations=300)
    res = host_refine_solve(host, dom32, solve32, f64, tolerance=1e-7)
    assert res.converged, res.history
    assert res.rel_residual < 1e-7
    assert res.history[-1] == res.rel_residual and res.cycles >= 1
    err = np.abs(res.u - u_star).max()
    assert err <= 1e-5 * np.abs(u_star).max(), err


def test_host_refinement_matches_device_refinement_3d():
    shape, N, r = (4, 4, 4), 3, 2
    mk = partial(tg.kershaw_mesh, shape, epsilon=0.3, device="cpu")
    mesh = mk(N)
    sd = partition_mesh(mesh, 1)
    dom32 = Domain(sd, dtype=torch.float32, device="cpu")
    host = HostOperator(mesh)
    pre = composite_dd(dom32, mk, poly_reduction=r, inner="amg",
                       fine_mesh=mesh)
    solve32 = dom32.solver(method="fgmres", max_iterations=100, precond=pre)

    u_star = np.asarray(
        dom32.from_device_field(dom32.initial_function(4, seed=0)),
        dtype=np.float64).reshape(-1)
    f64 = host.apply(u_star)
    seen = []
    res = host_refine_solve(host, dom32, solve32, f64, tolerance=1e-9,
                            verbose=lambda c, rel: seen.append((c, rel)))
    assert res.converged
    assert res.rel_residual < 1e-9
    assert res.cycles <= 4, res.history
    assert seen == list(enumerate(res.history))
    err = np.abs(res.u - u_star).max()
    assert err <= 1e-7 * np.abs(u_star).max(), err

    # the device refinement of the same f32 solve (solvers/refine.py, an
    # f64 Domain on the CPU): the same cycles, the same criterion, and
    # the two f64 residual histories close
    dom64 = Domain(sd, dtype=torch.float64, device="cpu")
    dev = refine_solve(dom64, solve32, dom64.to_device_field(f64),
                       tolerance=1e-9)
    assert dev.converged and dev.cycles == res.cycles
    np.testing.assert_allclose(dev.history[:2], res.history[:2], rtol=1e-6)
    u_dev = dom64.from_device_field(dev.u).reshape(-1)
    assert np.abs(u_dev - res.u).max() <= 1e-7 * np.abs(u_star).max()


def test_zero_rhs_takes_no_cycle():
    mesh = tg.box_mesh((2, 2, 2), 2, device="cpu")
    dom32 = Domain(partition_mesh(mesh, 1), dtype=torch.float32,
                   device="cpu")
    res = host_refine_solve(HostOperator(mesh), dom32, None,
                            np.zeros(mesh.num_points))
    assert res.converged and res.cycles == 0 and res.history == [0.0]
    assert not res.u.any()


def test_owned_to_global_across_two_processes(tmp_path):
    # two gloo processes, each with its own shards (P = 4 uniform and
    # generic, P = 2 ragged; 3-D, and 2-D slabs and generic): each fills
    # its shards' slots of the global field and one all_reduce sums the
    # parts; equal to the one-process map, and global_to_owned gives each
    # process its own rows back
    import json
    import os
    worker = os.path.join(mt.ROOT, "tests", "torch_multiprocess_worker.py")
    init, out = mt.store(tmp_path), tmp_path / "oracle"
    mt.finish(mt.start(lambda r: [worker, str(r), "2", init, str(out),
                                  "host_oracle"], 2), timeout=120)
    for r in range(2):
        results = json.loads((tmp_path / f"oracle.rank{r}.json").read_text())
        assert len(results) == 5 and all(ok for _, ok, _ in results), results


# ---- the driver's host refinement mode (tests/test_host_oracle.py) ----

def test_driver_host_refine_mode():
    import io
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.config import Config
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.driver import run_simulation
    out = io.StringIO()
    cfg = Config(mesh="kershaw", shape=(4, 4, 4), poly_degree=3,
                 poly_reduction=2, max_iterations=60,
                 refine_tolerance=1e-7, refine_mode="host")
    rec = run_simulation(cfg, out=out, device="cpu")
    assert rec["converged"]
    assert rec["refined_converged"]
    assert rec["refined_rel_residual"] < 1e-7
    assert rec["refined_max_error"] < 1e-6
    text = out.getvalue()
    assert "refinement cycle:  0  rel residual: 1.000000e+00" in text
    assert "f64 refinement (host): rel_res=" in text


def test_driver_host_refine_mode_p8():
    import io
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.config import Config
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.driver import run_simulation
    cfg = Config(mesh="kershaw", shape=(4, 4, 16), poly_degree=3,
                 poly_reduction=2, max_iterations=120, num_shards=8,
                 refine_tolerance=1e-7, refine_mode="host")
    rec = run_simulation(cfg, out=io.StringIO(), device="cpu")
    assert rec["converged"]
    assert rec["refined_converged"]
    assert rec["refined_rel_residual"] < 1e-7
