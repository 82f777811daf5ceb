"""The port of ``artifacts/run_femamg_i4_ablate.py`` (``..._torch/studies/
femamg_i4_ablate.py``) against the JAX package: the script's knob sets
and Config read from its source, "base" against the configuration of
``artifacts/femamg_production_16cubed.json``, and each knob set on
Kershaw eps=0.3 4^3 N=3 r=2 in f64 through both packages' drivers
(``run_simulation`` with the same Config): equal counts, histories at
rtol 1e-9 over every entry but the last (f64 histories drift 5-30x a
step: 9.8e-10 at c4v2's last but one entry, ROADMAP section 3)."""

import ast
import io
import json
import os

import numpy as np
import pytest

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.runtime.config import Config as JConfig
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.runtime.driver import run_simulation as jrun

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies import femamg_i4_ablate as fa

from composite_twins import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(ROOT, "artifacts")
SCRIPT = os.path.join(ARTIFACTS, "run_femamg_i4_ablate.py")
SMALL = dict(shape=(4, 4, 4), poly_degree=3, poly_reduction=2,
             stype="float64", ptype="float64")


def _script_tree():
    return ast.parse(open(SCRIPT).read())


def test_ablations_and_config_are_the_scripts():
    tree = _script_tree()
    node = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "ABLATIONS"
                        for t in n.targets))
    script = {ast.literal_eval(k): {kw.arg: ast.literal_eval(kw.value)
                                    for kw in v.keywords}
              for k, v in zip(node.keys, node.values)}
    assert fa.ABLATIONS == script and list(fa.ABLATIONS) == list(script)
    # the script's Config(...): every literal keyword but its checkpoint
    # (a directory of its own machine), then **kw, the tag's knobs
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "Config")
    kws = {kw.arg: ast.literal_eval(kw.value) for kw in call.keywords
           if kw.arg not in (None, "checkpoint")}
    assert [kw.arg for kw in call.keywords if kw.arg is None] == [None]
    for tag, knobs in fa.ABLATIONS.items():
        cfg = fa.config(tag)
        want = json.loads(JConfig(**kws, **knobs).to_json())
        assert json.loads(cfg.to_json()) == want
        assert cfg.checkpoint is None
    with pytest.raises(ValueError):
        fa.config("v44")


def test_base_is_the_production_record():
    # every field of the record's (an earlier JAX Config's) configuration
    with open(os.path.join(ARTIFACTS, "femamg_production_16cubed.json")) as fh:
        rec_cfg = json.loads(json.load(fh)["config"])
    cfg = json.loads(fa.config("base").to_json())
    assert {k: cfg[k] for k in rec_cfg} == rec_cfg


@pytest.fixture(scope="module")
def port_runs():
    return fa.run(device="cpu", fields=SMALL)


@pytest.mark.parametrize("tag", list(fa.ABLATIONS))
def test_ablation_matches_reference(tag, port_runs):
    rec = port_runs[tag]
    jrec = jrun(JConfig.from_json(fa.config(tag, **SMALL).to_json()),
                out=io.StringIO())
    assert rec["config"] == jrec["config"]
    assert rec["knobs"] == fa.ABLATIONS[tag]
    assert rec["converged"] and jrec["converged"]
    assert rec["iterations"] == jrec["iterations"]
    h = np.array(rec["residual_history"])
    hj = np.array(jrec["residual_history"])
    assert h.shape == hj.shape and h.size > 4
    np.testing.assert_allclose(h[:-1], hj[:-1], rtol=1e-9)
    assert 0.5 <= rec["max_error"] / jrec["max_error"] <= 2.0
    # the script's keys and the port's additions
    assert {"knobs", "iterations", "converged", "solve_seconds"} <= set(rec)
    assert {"mesh", "partition", "domain", "preconditioner", "rhs",
            "solve"} == set(rec["stage_seconds"])
    assert rec["card"] == "cpu"


def test_cli_writes_only_its_record(tmp_path, monkeypatch, capsys):
    # the command line at the script's order and reduction on a 2^3 mesh
    # (the script's 16^3 is the card's)
    monkeypatch.setattr(fa, "SHAPE", (2, 2, 2))
    out = tmp_path / "rec.json"
    before = sorted(os.listdir(ARTIFACTS))
    assert fa.main(["--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert list(rec) == list(fa.ABLATIONS)
    assert all(r["converged"] for r in rec.values())
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {t: r["iterations"] for t, r in rec.items()}
    assert sorted(os.listdir(ARTIFACTS)) == before
