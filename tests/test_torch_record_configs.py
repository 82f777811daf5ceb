"""The configurations of two of the JAX package's driver records that
chip_smoke.py runs on the card through the port's driver: fem-amg with 8
inner steps (``artifacts/run_femamg_i8.py`` ->
``femamg_production_16cubed_i8.json``), through the CLI line the script
passes, and ``runtime/sweep.kershaw_sweep`` (``artifacts/kershaw_sweep/
epsilon-{1.0,0.3}.json``). Every Config field a record holds must be the
port's (the records predate ``inner_solver``, ``output_composite``,
``refine_mode`` and, the sweep's, ``nek_dir`` and ``ztype``), and the
JAX package's Config of the same run must agree with the port's."""

import ast
import importlib.util
import json
import os

import pytest

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.runtime import sweep as jsw
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.runtime.config import Config as JConfig

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime import sweep as sw
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(ROOT, "artifacts")


def _chip_smoke():
    # chip_smoke.py imports nothing heavy at its top: its constants load
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record_config(name):
    with open(os.path.join(ARTIFACTS, name)) as fh:
        return json.loads(json.load(fh)["config"])


def _shared_equal(cfg: Config, rec: dict):
    mine = json.loads(cfg.to_json())
    assert set(rec) - set(mine) == set()
    diff = {k: (mine[k], v) for k, v in rec.items() if mine[k] != v}
    assert not diff


def test_femamg_i8_cli_is_the_records_config():
    argv = _chip_smoke().FEMAMG_I8
    cfg = Config.from_args(argv)
    rec = _record_config("femamg_production_16cubed_i8.json")
    _shared_equal(cfg, rec)
    assert (cfg.inner, cfg.inner_iterations, cfg.ptype) == \
        ("fem-amg", 8, "float32")
    # the script's own Config, as it constructs it, in the JAX package
    src = open(os.path.join(ARTIFACTS, "run_femamg_i8.py")).read()
    call = next(n for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.Call) and getattr(n.func, "id", "")
                == "Config")
    jcfg = JConfig(**{k.arg: ast.literal_eval(k.value)
                      for k in call.keywords})
    theirs = json.loads(jcfg.to_json())
    assert {k: theirs[k] for k in rec} == rec
    assert JConfig.from_args(argv).to_json() == jcfg.to_json()


def test_kershaw_sweep_configs_are_the_records(monkeypatch, tmp_path):
    seen = {}

    def fake(cfg, out=None, device=None):
        seen[cfg.epsilon] = cfg
        return {"config": cfg.to_json()}

    monkeypatch.setattr(sw, "run_simulation", fake)
    recs = sw.kershaw_sweep(str(tmp_path), device="cpu")
    assert [r["name"] for r in recs] == ["epsilon-1.0", "epsilon-0.3"]
    assert sorted(os.listdir(tmp_path)) == ["epsilon-0.3.json",
                                            "epsilon-1.0.json"]
    jseen = {}
    monkeypatch.setattr(jsw, "run_simulation",
                        lambda cfg, out=None: jseen.setdefault(
                            cfg.epsilon, cfg) and {})
    jsw.kershaw_sweep(str(tmp_path / "jax"))
    for eps in (1.0, 0.3):
        rec = _record_config(os.path.join("kershaw_sweep",
                                          f"epsilon-{eps}.json"))
        _shared_equal(seen[eps], rec)
        mine = json.loads(seen[eps].to_json())
        theirs = json.loads(jseen[eps].to_json())
        assert {k: mine[k] for k in theirs} == theirs


@pytest.mark.parametrize("eps", [1.0, 0.3])
def test_sweep_records_hold_what_chip_smoke_reads(eps):
    with open(os.path.join(ARTIFACTS, "kershaw_sweep",
                           f"epsilon-{eps}.json")) as fh:
        rec = json.load(fh)
    assert rec["name"] == f"epsilon-{eps}"
    assert rec["converged"] and rec["iterations"] == \
        len(rec["residual_history"]) - 1
    cs = _chip_smoke()
    assert cs.SWEEP_RECORDS == "artifacts/kershaw_sweep"
