"""The port's runtime layer on the CPU (runtime/config.py, timer.py,
driver.py, sweep.py and the CLI, __main__.py), the twins of
tests/test_runtime.py's config, timer, driver, sweep, NaN-guard,
multishard-CLI, checkpoint and inner-history tests.

Against the JAX package: the Config JSON for the same argv, field names
and defaults; the Timer's report text for the same recorded values; the
driver on test_driver_end_to_end's configuration in f64 (equal counts,
histories at rtol 1e-9 over the first 10 of 13 entries, the prefix
ROADMAP section 3 records for it; the run-info block and the record's
keys equal); the VTK output of test_driver_vtk_output's configuration
(header, points and cells line for line but the title, which names the
package; u within 2e-6 of max: f32 solves with another summation order,
1.15e-6 measured); a checkpoint directory the JAX driver wrote, run by
the port's driver with no mesh or chain built. The remaining twins hold
the port to the reference tests' own criteria."""

import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.runtime.config import Config as JConfig
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.runtime.driver import run_simulation as jrun
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.runtime.timer import Timer as JTimer

import polynomial_reduction_with_full_domain_decomposition_preconditioner_torch as port
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch import __main__ as cli
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.amg import composite as amgc
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime import sweep as sw
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.config import Config
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.driver import run_simulation
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.timer import Timer
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import subdomain as sub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain

from composite_twins import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
ARGVS = (["5", "4", "1", "1", "--mesh", "box", "--shape", "4,4,8",
          "--num-shards", "2", "--solver", "fcg", "--ptype", "float32"],
         ["2", "1", "--phase-report", "--shape", "2,2,4", "--mesh", "box"])
# test_driver_end_to_end's configuration; its f64 twin in both packages
END_TO_END = dict(mesh="kershaw", shape=(3, 3, 8), epsilon=0.3,
                  poly_degree=3, poly_reduction=2, solver="fgmres",
                  preconditioner="composite", inner="amg",
                  max_iterations=80, stype="float64", ptype="float32",
                  tolerance=1e-9)
F64_PREFIX = 10
VTK = dict(mesh="box", shape=(2, 2, 4), poly_degree=2, poly_reduction=1,
           preconditioner="jacobi", max_iterations=300, tolerance=1e-6)
CHECKPOINT = dict(mesh="kershaw", shape=(4, 4, 4), poly_degree=3,
                  poly_reduction=2, max_iterations=60)


def _run(run, cfg, **kw):
    out = io.StringIO()
    rec = run(cfg, out=out, **kw)
    return rec, out.getvalue()


def _run_info(text):
    return text.split("\niteration:")[0].splitlines()


# ---- config ----

@pytest.mark.parametrize("argv", ARGVS)
def test_config_json_matches_reference(argv):
    cfg, jcfg = Config.from_args(argv), JConfig.from_args(argv)
    assert cfg.to_json() == jcfg.to_json()
    assert Config.from_json(cfg.to_json()) == cfg


def test_config_fields_and_defaults_match_reference():
    ours = [(f.name, f.default, f.type) for f in dataclasses.fields(Config)]
    theirs = [(f.name, f.default, f.type)
              for f in dataclasses.fields(JConfig)]
    assert ours == theirs
    cfg = Config(stype="float64", ptype="bfloat16")
    assert cfg.stype_dtype() is torch.float64
    assert cfg.ptype_dtype() is torch.bfloat16
    assert cfg.replace(num_shards=3).num_shards == 3


def test_config_cli_roundtrip():
    cfg = Config.from_args(ARGVS[0])
    assert cfg.poly_degree == 5 and cfg.poly_reduction == 4
    assert cfg.shape == (4, 4, 8) and cfg.mesh == "box"
    assert cfg.solver == "fcg" and cfg.num_shards == 2
    assert Config.from_json(cfg.to_json()) == cfg
    cfg = Config.from_args(ARGVS[1])
    assert cfg.phase_report
    assert Config.from_json(cfg.to_json()) == cfg


# ---- timer ----

@pytest.mark.parametrize("num_shards", [None, 4])
def test_timer_report_matches_reference(num_shards):
    timers = [Timer(sync=False), JTimer(sync=False)]
    for t in timers:
        t.initialize()
        for name, s in (("setup.domain", 0.25), ("solve.run", 0.0123456),
                        ("solve.run", 1.5), ("setup", 3.0),
                        ("solve.refine.cycle", 2e-7)):
            t.record(name, s)
    assert timers[0].report(num_shards) == timers[1].report(num_shards)
    assert timers[0].as_dict() == timers[1].as_dict()


def test_timer_accumulates_and_reports(tmp_path):
    t = Timer(sync=False)
    t.initialize()
    with t("solve.run"):
        x = sum(range(1000))
    with t("solve.run"):
        pass
    assert t.as_dict()["solve.run"]["count"] == 2
    assert "solve.run" in t.report()
    assert x == 499500
    t.dump_json(str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == t.as_dict()
    # a synchronizing timer on the CPU has nothing to wait for
    s = Timer(device=CPU)
    s.initialize()
    with s("a"):
        pass
    assert s.as_dict()["a"]["count"] == 1


# ---- driver against the JAX package ----

@pytest.fixture(scope="module")
def end_to_end_f64():
    cfg = dict(END_TO_END, ptype="float64")
    return _run(jrun, JConfig(**cfg)), _run(run_simulation, Config(**cfg),
                                            device=CPU)


def test_driver_f64_matches_reference(end_to_end_f64):
    (jrec, jtext), (rec, text) = end_to_end_f64
    assert rec["converged"] and jrec["converged"]
    assert rec["iterations"] == jrec["iterations"]
    h, hj = np.array(rec["residual_history"]), np.array(jrec["residual_history"])
    assert h.shape == hj.shape and h.size > F64_PREFIX
    np.testing.assert_allclose(h[:F64_PREFIX], hj[:F64_PREFIX], rtol=1e-9)
    assert _run_info(text) == _run_info(jtext)
    assert len(_run_info(text)) == 7
    assert sorted(rec) == sorted(jrec)
    assert sorted(rec["timers"]) == sorted(jrec["timers"])
    assert rec["config"] == jrec["config"]


def test_driver_end_to_end(tmp_path, end_to_end_f64):
    cfg = Config(**END_TO_END, output=str(tmp_path / "fields.npz"))
    rec, text = _run(run_simulation, cfg, device=CPU)
    assert rec["converged"]
    assert rec["iterations"] < 25
    assert rec["max_error"] < 1e-6
    data = np.load(tmp_path / "fields.npz")
    assert "u" in data and "u_star" in data and "coords" in data
    assert np.isfinite(data["u"]).all()
    # the run-info block is the JAX driver's for this configuration: its
    # f64 twin's with the preconditioner's ptype
    (_, jtext), _ = end_to_end_f64
    want = [l.replace("ptype=float64", "ptype=float32")
            for l in _run_info(jtext)]
    assert _run_info(text) == want
    (jrec, _), _ = end_to_end_f64
    assert sorted(rec) == sorted(jrec)


def test_driver_vtk_output_matches_reference(tmp_path):
    paths = [tmp_path / "port.vtk", tmp_path / "jax.vtk"]
    rec, _ = _run(run_simulation, Config(**VTK, output=str(paths[0])),
                  device=CPU)
    jrec, _ = _run(jrun, JConfig(**VTK, output=str(paths[1])))
    assert rec["converged"] and jrec["converged"]
    ours, theirs = (p.read_text().splitlines() for p in paths)
    assert "DATASET UNSTRUCTURED_GRID" in ours and "SCALARS u double 1" in ours
    assert ours[1].endswith("_torch fields") and theirs[1].endswith("_tpu fields")
    assert len(ours) == len(theirs)
    data = ours.index(next(l for l in ours if l.startswith("POINT_DATA")))
    # header, points and cells line for line, the title aside
    assert ours[2:data + 1] == theirs[2:data + 1]
    npts = int(ours[data].split()[1])
    for name in ("u", "u_star", "f"):
        i = ours.index(f"SCALARS {name} double 1")
        assert theirs[i] == ours[i]
        a = np.array(ours[i + 2:i + 2 + npts], dtype=np.float64)
        b = np.array(theirs[i + 2:i + 2 + npts], dtype=np.float64)
        tol = 2e-6 if name == "u" else 0.0
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), name


# ---- the remaining twins, on the port ----

def test_sweep_runs_and_resumes(tmp_path):
    base = Config(**VTK)
    out = str(tmp_path / "sweep")
    res1 = sw.sweep(base, {"solver": ["fcg", "fgmres"]}, out, device=CPU)
    assert len(res1) == 2 and all(r["converged"] for r in res1)
    files = sorted(os.listdir(out))
    stamps = {f: os.stat(os.path.join(out, f)).st_mtime_ns for f in files}
    res2 = sw.sweep(base, {"solver": ["fcg", "fgmres"]}, out, device=CPU)
    assert sorted(os.listdir(out)) == files
    assert {f: os.stat(os.path.join(out, f)).st_mtime_ns
            for f in files} == stamps
    assert res2 == res1 and len(res2) == 2


@pytest.mark.parametrize("method", ["fcg", "fgmres"])
def test_nan_guard_stops_solver(method):
    mesh = tg.box_mesh((2, 2, 4), 2, device=CPU)
    dom = Domain(partition_mesh(mesh, 1), dtype=torch.float64, device=CPU)
    f = dom.to_device_field(np.full((1, mesh.num_points), np.nan))
    res = dom.solver(method=method, max_iterations=50, tolerance=1e-8)(f)
    assert not bool(res.converged)
    assert int(res.iterations) <= 2  # stopped immediately, no hang


def test_driver_multishard_cli():
    cfg = Config(mesh="kershaw", shape=(2, 2, 8), epsilon=0.3,
                 poly_degree=2, poly_reduction=1, num_shards=4,
                 preconditioner="composite", inner="amg",
                 max_iterations=100, tolerance=1e-8)
    rec, text = _run(run_simulation, cfg, device=CPU)
    assert rec["converged"]
    assert rec["max_error"] < 1e-5
    assert "shards:               4" in text


def test_checkpoint_skips_setup(tmp_path, monkeypatch):
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    rec1, _ = _run(run_simulation, Config(**CHECKPOINT, checkpoint=str(mine)),
                   device=CPU)
    _run(jrun, JConfig(**CHECKPOINT, checkpoint=str(theirs)))
    names = sorted(p.name for p in mine.iterdir())
    assert any("mesh_" in n for n in names)
    assert any("chain_" in n for n in names)
    # the JAX driver's checkpoint has the same file names
    assert sorted(p.name for p in theirs.iterdir()) == names

    def boom(*a, **k):
        raise AssertionError("setup was not skipped on checkpoint resume")

    monkeypatch.setattr(tg, "kershaw_mesh", boom)
    monkeypatch.setattr(amgc, "vertex_q1_hierarchy", boom)
    monkeypatch.setattr(sub, "vertex_q1_hierarchy", boom)  # its caller's name
    for d in (mine, theirs):
        rec2, _ = _run(run_simulation, Config(**CHECKPOINT, checkpoint=str(d)),
                       device=CPU)
        assert rec1["converged"] and rec2["converged"]
        np.testing.assert_allclose(rec2["residual_history"],
                                   rec1["residual_history"], rtol=1e-12)
        assert sorted(p.name for p in d.iterdir()) == names


def test_inner_history_probe():
    cfg = Config(mesh="kershaw", shape=(4, 4, 8), poly_degree=3,
                 poly_reduction=2, max_iterations=60, num_shards=4,
                 inner_history=True)
    rec, text = _run(run_simulation, cfg, device=CPU)
    assert rec["converged"]
    assert "inner iteration:   0" in text
    assert "inner iteration:   4" in text  # 4 fixed inner iterations
    # per-shard timing vectors in the reference's report schema
    assert "mean:" in text and "[ " in text
    run = [l for l in text.splitlines() if l.strip().startswith("mean:")]
    assert run and all(len(l.split("[")[1].split("]")[0].split()) == 4
                       for l in run)


# ---- the CLI ----

def test_cli_solves_on_the_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(port.__file__)))
    out = subprocess.run(
        [sys.executable, "-m", port.__name__, "2", "1", "--mesh", "box",
         "--shape", "2,2,4", "--preconditioner", "jacobi", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "converged: True" in out.stdout
    assert "solve.run:" in out.stdout


def test_cli_takes_the_device_off_the_argv():
    assert cli.take_device(["2", "--device", "cpu", "--mesh", "box"]) == (
        "cpu", ["2", "--mesh", "box"])
    assert cli.take_device(["--device=cuda:1", "3"]) == ("cuda:1", ["3"])
    assert cli.take_device(["3", "1"]) == (None, ["3", "1"])


@pytest.mark.parametrize("flag", [["--phase-report"],
                                  ["--output-composite", "comp.npz"]])
def test_cli_refuses_the_options_of_item_15b(flag):
    with pytest.raises(NotImplementedError, match="15b"):
        cli.main(["2", "1", "--mesh", "box", "--shape", "2,2,4",
                  "--device", "cpu"] + flag)


def test_cli_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["2", "1", "--mesh", "box", "--shape", "2,2,4",
                  "--preconditioner", "jacobi"])
