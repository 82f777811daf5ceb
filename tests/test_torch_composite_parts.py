"""The composites' region closures (``precond.parts``, the phase
taxonomy's regions) against the JAX package's, on one shard, f64: the
structured composite on Kershaw (2, 2, 8) N=2 r=1 with inner="amg" and
with "fem-amg" (no V-cycle legs), the unstructured one on scrambled
Kershaw (4, 4, 4) N=2 r=1, and the 2-D structured one on Kershaw (6, 6)
N=4 r=3.

Every key of the JAX package's ``parts``, called eagerly on the same
numpy-seeded input (the composite-space keys on the JAX package's
composite right-hand side of it), within 1e-12 of max, with the same key
set. At one shard the JAX package's ``tree_cascade`` returns every
restriction level and the port's level 0 only (the one level the chains
read), so that key compares level 0."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import unstructured as jun
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import subdomain as tsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain

from composite_twins import composites, pair2d
from composite_twins import one_torch_thread  # noqa: F401 (autouse)
from unstructured_twins import scrambled

STRUCTURED_KEYS = {"tree_rhs", "tree_cascade", "tree_rings", "tree_coarse",
                   "comp_operator", "comp_dssum", "comp_assemble",
                   "inner_precond"}
VCYCLE_KEYS = {"inner_smooth", "inner_transfer", "inner_coarse"}
UNSTRUCTURED_KEYS = {"tree_rhs", "tree_cascade", "tree_levels",
                     "comp_operator", "comp_dssum", "comp_assemble",
                     "inner_precond"} | VCYCLE_KEYS


def _leaves(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _seeded(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape)


def check_parts(jd, jp, td, tp, f, keys):
    """Every part of both packages on f (numpy): the port's key set is
    ``keys`` and the JAX package's, and every output within 1e-12 of its
    max."""
    jparts = jp.build(jd.arrays, jp.extra, jd._ops(jd.arrays)).parts
    tparts = tp.build(td.arrays, tp.extra, td._ops()).parts
    assert set(tparts) == keys == set(jparts)
    jf, tf = jnp.asarray(f), torch.as_tensor(f)
    # the composite-space parts take the JAX package's composite
    # right-hand side, in the port's layout (the unstructured classes and
    # the superdomain vector carry the shard axis)
    jx = jparts["tree_rhs"](jf)
    tx = [torch.as_tensor(np.array(j)).reshape(t.shape)
          for j, t in zip(jx, tparts["tree_rhs"](tf))]
    for key in sorted(keys):
        tree = key.startswith("tree_")
        want = [np.asarray(w) for w in _leaves(jparts[key](jf if tree
                                                           else jx))]
        got = [g.numpy() for g in _leaves(tparts[key](tf if tree else tx))]
        if key == "tree_cascade" and len(got) == 1:
            want = want[:1]           # one shard: level 0
        assert len(got) == len(want), key
        # (a class may be empty)
        scale = max(np.abs(w).max(initial=0.0) for w in want)
        err = max(np.abs(g.reshape(-1) - w.reshape(-1)).max(initial=0.0)
                  for g, w in zip(got, want))
        assert err <= 1e-12 * scale, (key, err, scale)


@pytest.fixture(scope="module")
def box():
    """Kershaw (2, 2, 8) N=2 on one shard in both packages."""
    jb, jm, tm, jd, td, _, _ = pair2d((2, 2, 8), 2, 1, seed=5)
    return jb, jm, tm, jd, td


@pytest.mark.parametrize("inner", ["amg", "fem-amg"])
def test_structured_parts_match_reference(box, inner):
    jb, jm, tm, jd, td = box
    jp, tp = composites(jb, jm, tm, jd, td, poly_reduction=1, inner=inner)
    check_parts(jd, jp, td, tp, _seeded(td.field_shape),
                STRUCTURED_KEYS | (VCYCLE_KEYS if inner == "amg" else set()))


def test_unstructured_parts_match_reference():
    jmk, tmk = scrambled((4, 4, 4), 3)
    jm, tm = jmk(2), tmk(2)
    jd = JDomain(jpartition(jm, 1), dtype=jnp.float64)
    td = TDomain(tpartition(tm, 1), dtype=torch.float64, device="cpu")
    jp = jun.composite_dd_unstructured(jd, jmk, 1, inner="amg", fine_mesh=jm)
    tp = tsub.composite_dd(td, tmk, 1, inner="amg", fine_mesh=tm)
    check_parts(jd, jp, td, tp, _seeded(td.field_shape), UNSTRUCTURED_KEYS)


def test_2d_parts_match_reference():
    jb, jm, tm, jd, td, _, _ = pair2d((6, 6), 4, 1, seed=5)
    jp, tp = composites(jb, jm, tm, jd, td, poly_reduction=3)
    check_parts(jd, jp, td, tp, _seeded(td.field_shape),
                STRUCTURED_KEYS | VCYCLE_KEYS)
