"""The port of ``artifacts/run_strong_scaling_ablate.py`` (``..._torch/
studies/strong_scaling_ablate.py``) against the JAX package: the
script's knob sets read from its source, the base knobs at P = 1 and 2
and the i8 knobs at P = 1 against the JAX package's ``composite_dd`` +
f64 FGMRES on the script's configuration (equal counts, histories at
rtol 1e-9 over a prefix, ROADMAP section 3; i8 at P = 2 is left out for
the JAX side's time, about 30 s), and the v2 knob at P = 8, which both
packages' composite builds refuse."""

import ast
import io
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as jsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies import strong_scaling_ablate as sa

from composite_twins import port_mesh
from composite_twins import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "artifacts", "run_strong_scaling_ablate.py")
JB = partial(jg.kershaw_mesh, sa.SHAPE, epsilon=0.3)
# history entries held at rtol 1e-9: at most the first 8 steps, and
# never the last finite one (f64 histories drift 5-10x a step)
PREFIX = 8


def _script_value(name):
    tree = ast.parse(open(SCRIPT).read())
    node = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in n.targets))
    return ast.literal_eval(node)


def test_configs_are_the_scripts():
    assert sa.CONFIGS == _script_value("CONFIGS")
    assert list(sa.CONFIGS) == list(_script_value("CONFIGS"))
    src = open(SCRIPT).read()
    assert f"shape, N, red = {sa.SHAPE}, {sa.ORDER}, {sa.POLY_REDUCTION}" \
        in src
    assert f"for Pn in {sa.SHARDS}" in src
    assert (f"max_iterations={sa.MAX_ITERATIONS}" in src
            and "tolerance=1e-8" in src and sa.TOLERANCE == 1e-8)


@pytest.fixture(scope="module")
def meshes():
    jm = JB(sa.ORDER)
    return jm, port_mesh(jm)


def _jax_solve(jm, P, knobs):
    dm = jax.make_mesh((P,), ("shard",)) if P > 1 else None
    dom = JDomain(jpartition(jm, P), dtype=jnp.float64, device_mesh=dm)
    f = dom.manufacture_rhs(dom.initial_function(4, seed=0))
    pre = jsub.composite_dd(dom, JB, poly_reduction=sa.POLY_REDUCTION,
                            inner="amg", fine_mesh=jm, **knobs)
    return dom.solver(method="fgmres", max_iterations=sa.MAX_ITERATIONS,
                      tolerance=sa.TOLERANCE, precond=pre)(f)


@pytest.mark.parametrize("tag,P", [("base", 1), ("base", 2), ("i8", 1)])
def test_counts_and_histories_match_reference(meshes, tag, P):
    jm, tm = meshes
    knobs = sa.CONFIGS[tag]
    rj = _jax_solve(jm, P, knobs)
    rt = sa.solve_one(tm, lambda o: port_mesh(JB(o)), P, knobs, "cpu")
    hj = np.asarray(rj.residual_history)
    ht = rt.residual_history.numpy()
    # the script's count: the finite entries of the history
    k = int(np.isfinite(hj).sum())
    assert int(np.isfinite(ht).sum()) == k
    assert bool(rt.converged) and bool(rj.converged)
    n = min(PREFIX + 1, k - 1)
    np.testing.assert_allclose(ht[:n], hj[:n], rtol=1e-9)


def test_v2_at_eight_shards_is_refused_by_both(meshes):
    jm, tm = meshes
    with pytest.raises(ValueError, match="ring depth"):
        _jax_solve(jm, 8, sa.CONFIGS["v2"])
    with pytest.raises(ValueError, match="ring depth"):
        sa.solve_one(tm, lambda o: port_mesh(JB(o)), 8, sa.CONFIGS["v2"],
                     "cpu")


def test_run_records_the_refusal_and_counts(meshes):
    # the sweep's record on two of its points: a count and the refusal
    buf = io.StringIO()
    rec = sa.run({"v2": sa.CONFIGS["v2"], "i8": sa.CONFIGS["i8"]}, (8, 1),
                 device="cpu", out=buf)
    per = rec["configs"]["v2"]["per_P"]
    assert list(per) == ["8", "1"] and "ring depth (4)" in per["8"]["error"]
    assert rec["configs"]["i8"]["per_P"]["1"] == {"iterations": 7,
                                                  "converged": True}
    assert rec["configs"]["i8"]["knobs"] == {"num_iterations": 8}
    assert rec["points"] == 16384
    assert "v2 P=8: ERROR" in buf.getvalue()
