"""The port of ``artifacts/run_64cubed.py`` (``..._torch/studies/
scaleup.py``) against the JAX package's calls as that script makes them,
on the CPU at Kershaw eps=0.3 2^3 N=7 r=6, the smallest mesh both
composites take at one shard (the slab of 2 layers covers the ring depth
of orders 7 and 1). Both packages get the JAX package's mesh."""

import json
import os
from functools import partial

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as jsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import check_int32_ids
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.config import Config
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies import scaleup

from composite_twins import one_torch_thread, port_mesh  # noqa: F401 (autouse)

M = 2
ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts")
# the keys the script writes (artifacts/run_64cubed.py:147-161); a record
# file may also hold a note added by hand
SCRIPT_KEYS = {"mesh", "points", "solver", "iterations", "converged",
               "residual_history", "max_error", "solve_seconds",
               "first_solve_seconds", "setup_mesh_seconds",
               "setup_preconditioner_seconds"}
# the records of round 2, whose solver string ends at the inner solve
ROUND2_SOLVER = {
    "scaleup_32cubed_fgmres-z165i4.json":
        "fgmres-z16(5) + composite(bf16, inner GMRES(4))",
    "scaleup_32cubed_fgmres-z168i4.json":
        "fgmres-z16(8) + composite(bf16, inner GMRES(4))"}
REFINED_KEYS = {"refined_rel_residual", "refined_cycles",
                "refined_inner_iterations", "refined_max_error",
                "refined_converged", "refine_seconds"}
# the recorded forms: (inner_iters, method, nv, inner_solver, ptype,
# cheby_order, num_vcycles)
FORMS = {"fgmres-z16 bf16": (4, "fgmres-z16", 4, "fgmres", "bf16", 2, 1),
         "fcg bf16": (4, "fcg", 8, "fgmres", "bf16", 2, 1),
         "fgmres-z16 f32 inner fcg": (4, "fgmres-z16", 4, "fcg", "f32", 2, 1),
         "fgmres-z16 bf16 cheby 4": (4, "fgmres-z16", 4, "fgmres", "bf16",
                                     4, 1),
         "fgmres-z16 bf16 inner fcg": (4, "fgmres-z16", 4, "fcg", "bf16",
                                       2, 1)}


def jax_run(inner_iters, method, nv, inner_solver, ptype, cheby_order=2,
            num_vcycles=1):
    """artifacts/run_64cubed.py:50-102 at m = M, without its cache and file
    writes: iterations, finite residual history, max|u - u*|."""
    jb = partial(jg.kershaw_mesh, (M, M, M), epsilon=0.3)
    mesh = jb(7)
    dom = JDomain(jpartition(mesh, 1), dtype=jnp.float32)
    pre = jsub.composite_dd(
        dom, jb, poly_reduction=6, inner="amg",
        ptype={"bf16": jnp.bfloat16, "f32": jnp.float32}[ptype],
        num_iterations=inner_iters, fine_mesh=mesh,
        inner_solver=inner_solver, cheby_order=cheby_order,
        num_vcycles=num_vcycles)
    u_star_dev = dom.initial_function(4, seed=0)
    f = dom.manufacture_rhs(u_star_dev)
    u_star = dom.from_device_field(u_star_dev)
    if method == "fcg":
        solve = dom.solver(method="fcg", precond=pre, max_iterations=100)
    else:
        zdt = jnp.bfloat16 if method.endswith("z16") else None
        solve = dom.solver(method="fgmres", precond=pre, max_iterations=100,
                           num_vectors=nv, z_dtype=zdt)
    res = solve(f)
    hist = np.asarray(res.residual_history)
    hist = hist[np.isfinite(hist)]
    err = float(np.abs(dom.from_device_field(res.u) - u_star).max())
    return int(res.iterations), hist, err


@pytest.fixture(scope="module")
def setup():
    """The port's setup on the JAX package's mesh (every order), shared by
    the runs as chip_smoke.py's scaleup-64 phase shares it."""
    jb = partial(jg.kershaw_mesh, (M, M, M), epsilon=0.3)
    return scaleup.build_setup(M, device="cpu",
                               mesh_builder=lambda o: port_mesh(jb(o)))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_scaleup_matches_reference(form, setup):
    inner_iters, method, nv, inner_solver, ptype, cheby, nvc = FORMS[form]
    j_its, j_hist, j_err = jax_run(inner_iters, method, nv, inner_solver,
                                   ptype, cheby, nvc)
    rec = scaleup.run(M, inner_iters, method, nv, cheby_order=cheby,
                      num_vcycles=nvc, inner_solver=inner_solver,
                      ptype=ptype, refine_mode="none", setup=setup)
    t_hist = np.asarray(rec["residual_history"])
    assert rec["converged"] and rec["points"] == 8 * 512
    # r0 is the same f32 sum in both packages
    np.testing.assert_allclose(t_hist[0], j_hist[0], rtol=1e-6)
    if ptype == "f32":
        # one application agrees to ~1e-6; the residual norms then carry
        # f32 round-off of r0's size, which grows relative to r_k as r_k
        # falls (up to 5.3e-3 of r2 with the bf16 Z basis, ROADMAP §3)
        assert rec["iterations"] == j_its
        np.testing.assert_allclose(t_hist, j_hist, rtol=2e-2)
    else:
        # bf16 rounds at other places in the two packages (ROADMAP §3)
        assert abs(rec["iterations"] - j_its) <= 1
    assert 0.5 <= rec["max_error"] / j_err <= 2.0


@pytest.mark.parametrize("name,args,refined", [
    ("scaleup_64cubed.json", (64, 4, "fcg", 8, 0.3, 2, 1, "fgmres", "bf16"),
     False),
    ("scaleup_64cubed_fgmres-z164i4.json",
     (64, 4, "fgmres-z16", 4, 0.3, 2, 1, "fgmres", "bf16"), True),
    ("scaleup_32cubed_fgmres-z164i4_isfcg_ptf32.json",
     (32, 4, "fgmres-z16", 4, 0.3, 2, 1, "fcg", "f32"), True),
    ("scaleup_32cubed_fgmres-z164i4_c4v1.json",
     (32, 4, "fgmres-z16", 4, 0.3, 4, 1, "fgmres", "bf16"), False),
    ("scaleup_32cubed_fgmres-z164i4_isfcg.json",
     (32, 4, "fgmres-z16", 4, 0.3, 2, 1, "fcg", "bf16"), True),
    ("scaleup_32cubed_fgmres-z165i4.json",
     (32, 4, "fgmres-z16", 5, 0.3, 2, 1, "fgmres", "bf16"), False),
    ("scaleup_32cubed_fgmres-z168i4.json",
     (32, 4, "fgmres-z16", 8, 0.3, 2, 1, "fgmres", "bf16"), False),
])
def test_record_keys_solver_and_file_match_the_script(name, args, refined,
                                                      setup):
    with open(os.path.join(ARTIFACTS, name)) as fh:
        jrec = json.load(fh)
    m, inner_iters, method, nv, eps, cheby, nvc, inner_solver, ptype = args
    assert scaleup.record_file(*args) == name
    solver = scaleup.solver_name(method, nv, inner_iters, inner_solver,
                                 ptype, cheby, nvc)
    if name in ROUND2_SOLVER:
        # a round-2 record: the script named no smoother strength then
        # ("... inner GMRES(4))"); the port keeps today's form
        assert jrec["solver"] == ROUND2_SOLVER[name] \
            == solver.replace(", cheby 2, 1 vcycle)", ")")
    else:
        assert solver == jrec["solver"]
    assert jrec["mesh"] == f"kershaw eps={eps} {m}^3 N=7 r=6"
    want = SCRIPT_KEYS | (REFINED_KEYS if refined else set())
    assert set(jrec) - {"note"} == want
    # the port's record at m = M: the script's keys, every one of them
    rec = scaleup.run(M, *args[1:], refine_mode="host" if refined
                      else "none", setup=setup)
    assert want <= set(rec)
    assert refined or not REFINED_KEYS & set(rec)
    assert rec["solver"] == solver
    assert rec["mesh"] == f"kershaw eps=0.3 {M}^3 N=7 r=6"
    assert rec["file"] == name.replace(f"_{m}cubed", f"_{M}cubed")
    stages = {"mesh", "partition", "domain", "preconditioner", "rhs",
              "solve"} | ({"refinement"} if refined else set())
    assert set(rec["memory"]["host_peak_rss_gb"]) == stages
    assert all(v is None for v in rec["memory"]["card_peak_gb"].values())


def test_host_and_device_refinement_agree(setup):
    recs = {mode: scaleup.run(M, 4, "fgmres-z16", 4, refine_mode=mode,
                              setup=setup)
            for mode in ("host", "device")}
    for rec in recs.values():
        assert rec["refined_converged"]
        assert rec["refined_rel_residual"] <= scaleup.REFINE_TOLERANCE
        assert rec["refined_max_error"] < 1e-5
    assert abs(recs["host"]["refined_cycles"]
               - recs["device"]["refined_cycles"]) <= 1
    # each host f64 residual (an apply and a dssum) timed, one a cycle and
    # the last; the device refinement has none
    assert len(recs["host"]["refined_residual_seconds"]) == \
        recs["host"]["refined_cycles"] + 1
    assert "refined_residual_seconds" not in recs["device"]
    # the same f32 solves on the same Domain: the same first solve
    assert recs["host"]["residual_history"] == \
        recs["device"]["residual_history"]


def test_study_cli_writes_only_its_record(tmp_path):
    out = tmp_path / "rec.json"
    before = sorted(os.listdir(ARTIFACTS))
    assert scaleup.main([str(M), "4", "fgmres-z16", "4", "0.3", "2", "1",
                         "fgmres", "bf16", "norefine", "--device", "cpu",
                         "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["refine_mode"] == "none" and rec["converged"]
    assert sorted(os.listdir(ARTIFACTS)) == before
    with pytest.raises(ValueError):
        scaleup.run(M, refine_mode="cards", device="cpu")


def test_int32_gather_plan_is_checked():
    # the plan's gather ids are int32: 64^3 N=7's 449^3 nodes fit, a mesh
    # past 2^31 - 1 nodes raises instead of wrapping
    check_int32_ids(449 ** 3, "nodes")
    check_int32_ids(2 ** 31 - 1, "nodes")
    with pytest.raises(ValueError, match="int32"):
        check_int32_ids(2 ** 31, "nodes")


def test_study_runs_the_cli_configuration():
    # the study is the driver's run: its configuration is the one the CLI
    # takes from the script's settings as options
    argv = ["7", "6", "1", "1", "--mesh", "kershaw", "--shape", "64,64,64",
            "--epsilon", "0.3", "--ptype", "bfloat16", "--solver", "fgmres",
            "--num-vectors", "4", "--ztype", "bfloat16",
            "--max-iterations", "100", "--inner-iterations", "4",
            "--refine-tolerance", "1e-7", "--refine-mode", "device"]
    assert scaleup.config(64, 4, "fgmres-z16", 4, refine_mode="device") \
        == Config.from_args(argv)
    fcg = ["7", "6", "1", "1", "--mesh", "kershaw", "--shape", "32,32,32",
           "--ptype", "float32", "--solver", "fcg", "--num-vectors", "8",
           "--max-iterations", "100", "--inner-iterations", "3",
           "--inner-solver", "fcg"]
    assert scaleup.config(32, 3, "fcg", inner_solver="fcg", ptype="f32",
                          refine_mode="none") == Config.from_args(fcg)


def test_shared_setup_is_held_to_its_configuration(setup):
    # a setup serves runs of its own mesh only, on its own device
    with pytest.raises(ValueError, match="problem is"):
        scaleup.run(M + 1, 4, "fcg", refine_mode="none", setup=setup)
    with pytest.raises(ValueError, match="problem is"):
        scaleup.run(M, 4, "fcg", epsilon=1.0, refine_mode="none",
                    setup=setup)
    with pytest.raises(ValueError, match="problem is on"):
        scaleup.run(M, 4, "fcg", refine_mode="none", setup=setup,
                    device="meta")


def test_rounding_spread_runs_the_f32_record_three_ways():
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies import rounding_spread
    out = rounding_spread.run(M, small=M, seeds=1, device="cpu")
    assert out["solver"] == ("fgmres-z16(4) + composite(f32, inner FCG(4), "
                             "cheby 2, 1 vcycle)")
    # a right-hand side one f32 ulp away: the same first residual to ~1e-6
    (ulp,) = out["one_ulp_rhs"]
    assert abs(ulp["r_over_unperturbed"][0] - 1.0) < 1e-4
    # the f32 Z basis is another run; on one device the two small runs
    # are the same
    assert out["f32_z_basis"]["r0_r3"][0] == out["run"]["r0_r3"][0]
    assert out["small"]["max_rel_diff_device_vs_cpu"] == 0.0
