"""PyTorch port of the vertex-grid hierarchy (amg/composite, amg/fem) and
the stencil V-cycle (amg/vcycle, ops/stencil, ops/interp) vs the JAX
package, in f64 on the CPU. Kershaw 8^3: the 9^3 vertex grid coarsens
once, so the chain has two levels."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.amg import composite as jcomp
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.amg import fem as jfem
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.amg import vcycle as jvc
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops import interp as jinterp
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops import stencil as jstencil

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.amg import composite as tcomp
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.amg import fem as tfem
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.amg import vcycle as tvc
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import interp as tinterp
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import stencil as tstencil

from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-300)


@pytest.fixture(scope="module")
def chains():
    shape = (8, 8, 8)
    jm1 = jg.kershaw_mesh(shape, 1, epsilon=0.3)
    tm1 = tg.kershaw_mesh(shape, 1, epsilon=0.3, device="cpu")
    jinfo = jcomp.vertex_q1_hierarchy(jm1, (8, 8), 8, 3)
    tinfo = tcomp.vertex_q1_hierarchy(tm1, (8, 8), 8, 3)
    return jinfo, tinfo


def test_chain_info_matches_reference(chains):
    jinfo, tinfo = chains
    assert tinfo["shapes"] == jinfo["shapes"] == [(9, 9, 9), (5, 5, 5)]
    for A, B in zip(jinfo["mats"], tinfo["mats"]):
        _close(A.toarray(), B.toarray())
    for P, Q in zip(jinfo["prolongs"], tinfo["prolongs"]):
        _close(P.toarray(), Q.toarray())
    for a, b in zip(jinfo["masks"], tinfo["masks"]):
        assert np.array_equal(a, b)
    for Fa, Fb in zip(jinfo["factors"], tinfo["factors"]):
        for a, b in zip(Fa, Fb):
            assert np.array_equal(a, b)
    _close(jinfo["lmaxs"], tinfo["lmaxs"])
    _close(jinfo["coarse_inv"], tinfo["coarse_inv"])


def test_chain_vcycle_matches_reference(chains):
    jinfo, tinfo = chains
    f = np.random.default_rng(0).standard_normal(9 ** 3)
    f *= jinfo["masks"][0]
    ref = np.asarray(jvc.chain_vcycle(jvc.pack_chain(jinfo, jnp.float64),
                                      jnp.asarray(f)))
    out = tvc.chain_vcycle(tvc.pack_chain(tinfo, torch.float64, "cpu"),
                           torch.as_tensor(f)).numpy()
    _close(ref, out)


def test_stencil_apply_matches_reference(chains):
    jinfo, _ = chains
    A = jinfo["mats"][0]
    x = np.random.default_rng(1).standard_normal(A.shape[0])
    jc = jstencil.stencil_from_csr(A, (9, 9, 9), dtype=np.float64)
    tc = tstencil.stencil_from_csr(A, (9, 9, 9), dtype=torch.float64)
    assert np.array_equal(np.asarray(jc), tc.numpy())
    ref = np.asarray(jstencil.stencil_apply(jc, jnp.asarray(x), 3))
    _close(ref, tstencil.stencil_apply(tc, torch.as_tensor(x), 3).numpy(),
           1e-13)
    _close(A @ x, ref, 1e-13)
    with pytest.raises(ValueError):
        tstencil.stencil_from_csr(sp.csr_matrix(np.ones((27, 27))), (3, 3, 3))


def test_cheby_smooth_matches_reference(chains):
    jinfo, tinfo = chains
    A = jinfo["mats"][0]
    d = A.diagonal()
    invd = np.where(d > 0, 1.0 / d, 0.0)
    rng = np.random.default_rng(2)
    f, u = rng.standard_normal(A.shape[0]), rng.standard_normal(A.shape[0])
    lmax = jinfo["lmaxs"][0]
    for u0 in (None, u):
        ref = np.asarray(jvc.cheby_smooth(
            lambda x: jnp.asarray(A @ np.asarray(x)), jnp.asarray(invd),
            jnp.asarray(lmax), jnp.asarray(f),
            None if u0 is None else jnp.asarray(u0), 3))
        out = tvc.cheby_smooth(
            lambda x: torch.as_tensor(A @ x.numpy()), torch.as_tensor(invd),
            torch.tensor(lmax, dtype=torch.float64), torch.as_tensor(f),
            None if u0 is None else torch.as_tensor(u0), 3).numpy()
        _close(ref, out, 1e-13)


def test_p1_fem_and_transfers_match_reference():
    rng = np.random.default_rng(3)
    X = np.stack(np.meshgrid(*[np.linspace(0, 1, s) for s in (3, 4, 5)],
                             indexing="ij"), axis=-1)
    X = X + 0.02 * rng.standard_normal(X.shape)
    _close(jfem.p1_stiffness_grid(X, use_native=False).toarray(),
           tfem.p1_stiffness_grid(X).toarray(), 1e-13)
    for m, o1, o2 in [(3, 1, 4), (2, 5, 2)]:
        assert np.array_equal(jfem.grid_interp_1d(m, o1, o2).toarray(),
                              tfem.grid_interp_1d(m, o1, o2).toarray())
    M = rng.standard_normal((5, 7))
    U = rng.standard_normal((7, 4, 7))
    for axis in (0, 2):
        _close(np.asarray(jinterp.axis_contract(jnp.asarray(M),
                                                jnp.asarray(U), axis)),
               tinterp.axis_contract(torch.as_tensor(M), torch.as_tensor(U),
                                     axis).numpy(), 1e-14)
    J = rng.standard_normal((3, 4))
    V = rng.standard_normal((8, 12, 4))
    _close(np.asarray(jinterp.lattice_tensor_apply(jnp.asarray(V),
                                                   jnp.asarray(J), 3)),
           tinterp.lattice_tensor_apply(torch.as_tensor(V),
                                        torch.as_tensor(J), 3).numpy(), 1e-13)
