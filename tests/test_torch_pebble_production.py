"""The port of ``artifacts/run_pebble_production.py`` (``..._torch/studies/
pebble_production.py``) against the JAX package: the script's
configuration as the script builds it, the records' configurations, the
driver with the f64 refinement on the host on a tiny bed (6^3 lattice, 4
pebbles, N=3, r=2) against the JAX package's ``run_simulation``, and the
study's command line on a stand-in mesh."""

import ast
import io
import json
import os
from functools import partial

import numpy as np
import pytest

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.runtime.config import Config as JConfig
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.runtime.driver import run_simulation as jrun

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.pebble import pebble_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.config import Config
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.driver import run_simulation
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies import pebble_production as pp

from composite_twins import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(ROOT, "artifacts")
SCRIPT = os.path.join(ARTIFACTS, "run_pebble_production.py")
# the keys run_simulation returns with the host refinement, and the two the
# script adds (artifacts/run_pebble_production.py:57-59)
SCRIPT_KEYS = {"config", "converged", "iterations", "residual_history",
               "max_error", "solve_seconds", "timers",
               "refined_rel_residual", "refined_cycles", "refined_max_error",
               "refined_converged", "wall_seconds", "family"}
# PB_146's record configuration as a user types it
CLI_146 = ["7", "6", "1", "1", "--mesh", "pebble", "--shape", "32,32,32",
           "--num-pebbles", "146", "--solid-fraction", "0.2",
           "--mesh-seed", "5", "--ptype", "bfloat16", "--num-vectors", "8",
           "--ztype", "bfloat16", "--max-iterations", "200",
           "--refine-tolerance", "1e-7", "--refine-mode", "host"]
# the tiny bed: both packages carve the same 6^3 lattice
TINY = dict(mesh="pebble", shape=(6, 6, 6), num_pebbles=4, mesh_seed=2,
            solid_fraction=0.25, poly_degree=3, poly_reduction=2,
            solver="fgmres", num_vectors=6, inner="amg",
            refine_tolerance=1e-7, refine_mode="host")


def script_config(k):
    """The keywords of the script's ``Config(...)`` for family ``k``, read
    from its source, and its FAMILIES table."""
    tree = ast.parse(open(SCRIPT).read())
    node = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "FAMILIES")
    # {k: dict(...)} of literals: evaluated with nothing but dict
    families = eval(compile(ast.Expression(node), SCRIPT, "eval"),
                    {"__builtins__": {}, "dict": dict})
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "Config")
    kw = {}
    for a in call.keywords:
        v = a.value
        if isinstance(v, ast.Name) and v.id == "k":
            kw[a.arg] = k
        elif isinstance(v, ast.Subscript):     # fam["..."]
            kw[a.arg] = families[k][ast.literal_eval(v.slice)]
        else:
            kw[a.arg] = ast.literal_eval(v)
    return families, kw


def record(k):
    with open(os.path.join(ARTIFACTS, f"pebble_production_pb{k}.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("k", [146, 1568])
def test_config_matches_the_script(k):
    families, kw = script_config(k)
    assert pp.FAMILIES == families
    # the script's checkpoint directory is a path of its own machine: the
    # study takes one as an argument (default none), field for field else
    jcfg = JConfig(**dict(kw, checkpoint="ckpt"))
    assert pp.config(k, checkpoint="ckpt").to_json() == jcfg.to_json()
    assert pp.config(k) == pp.config(k, checkpoint="ckpt").replace(
        checkpoint=None)
    assert pp.config(k, refine_mode="device").refine_mode == "device"
    assert pp.config(k, refine_mode="none").refine_tolerance is None
    with pytest.raises(ValueError):
        pp.config(k, refine_mode="cards")


@pytest.mark.parametrize("k", [146, 1568])
def test_record_configs_parse(k):
    s = record(k)["config"]
    assert Config.from_json(s).to_json() == JConfig.from_json(s).to_json()
    assert pp.record_config(k) == Config.from_json(s).replace(checkpoint=None)
    assert pp.record_config(k, checkpoint="c").checkpoint == "c"
    # the record differs from the script's configuration only in the
    # checkpoint and, for PB_146 (round 2), the FGMRES restart
    diff = {f for f, v in json.loads(pp.config(k).to_json()).items()
            if json.loads(s).get(f, v) != v}
    assert diff == ({"checkpoint", "num_vectors"} if k == 146
                    else {"checkpoint"})


def test_record_146_is_the_cli_line():
    assert Config.from_args(CLI_146) == pp.record_config(146)
    assert JConfig.from_args(CLI_146).to_json() == \
        pp.record_config(146).to_json()


def _run(fn, cfg, **kw):
    out = io.StringIO()
    return fn(cfg, out=out, **kw)


@pytest.fixture(scope="module")
def tiny_runs():
    runs = {}
    for name, dt in (("f64", "float64"), ("f32", "float32")):
        cfg = dict(TINY, stype=dt, ptype=dt)
        runs[name] = (_run(jrun, JConfig(**cfg)),
                      _run(run_simulation, Config(**cfg), device="cpu"))
    return runs


def test_host_refinement_f64_matches_reference(tiny_runs):
    jrec, rec = tiny_runs["f64"]
    assert rec["converged"] and jrec["converged"]
    assert rec["iterations"] == jrec["iterations"]
    np.testing.assert_allclose(rec["residual_history"],
                               jrec["residual_history"], rtol=1e-9)
    assert sorted(rec) == sorted(jrec)
    assert rec["config"] == jrec["config"]
    for r in (rec, jrec):
        assert r["refined_converged"] and r["refined_rel_residual"] <= 1e-7


def test_host_refinement_f32_matches_reference(tiny_runs):
    jrec, rec = tiny_runs["f32"]
    assert rec["converged"] and jrec["converged"]
    assert rec["iterations"] == jrec["iterations"]
    assert rec["refined_cycles"] == jrec["refined_cycles"]
    for r in (rec, jrec):
        assert r["refined_converged"] and r["refined_rel_residual"] <= 1e-7
        assert r["refined_max_error"] * 100 <= r["max_error"]
    assert sorted(rec) == sorted(jrec)


def test_study_cli_writes_only_its_record(tmp_path, monkeypatch):
    # PB_146's configuration on a stand-in bed (3^3 lattice, 1 pebble) at
    # N=7: the record has the script's keys and the port's, and the run
    # writes its --out file and nothing else
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "rec.json"
    before = sorted(os.listdir(ARTIFACTS))
    mb = partial(pebble_mesh, (3, 3, 3), num_pebbles=1, seed=2,
                 solid_fraction=0.25, device="cpu")
    assert pp.main(["146", "--device", "cpu", "--out", str(out)],
                   mesh_builder=mb) == 0
    assert sorted(os.listdir(ARTIFACTS)) == before
    assert os.listdir(tmp_path) == ["rec.json"]
    rec = json.loads(out.read_text())
    assert SCRIPT_KEYS <= set(rec)
    assert set(record(146)) <= set(rec)
    assert rec["family"] == "PB_146" and rec["device"] == "cpu"
    assert rec["config"] == pp.config(146).to_json()
    assert rec["points"] == rec["elements"] * 512
    assert rec["refine_mode"] == "host" and rec["refined_converged"]
    assert rec["refined_rel_residual"] <= pp.REFINE_TOLERANCE
    assert len(rec["refined_history"]) == rec["refined_cycles"] + 1
    stages = {"mesh", "partition", "domain", "preconditioner", "rhs",
              "solve", "refinement"}
    assert set(rec["stage_seconds"]) == stages
    assert set(rec["memory"]["host_peak_rss_gb"]) == stages
    assert all(v is None for v in rec["memory"]["card_peak_gb"].values())


def test_run_is_held_to_its_family():
    with pytest.raises(ValueError, match="not PB_1568"):
        pp.run(1568, config=pp.config(146), device="cpu")
    with pytest.raises(ValueError, match="pebble family"):
        pp.config(24)
