"""PyTorch port of the fused SEM stiffness apply (kernel K1,
ops/kernels.stiffness_lattice_3d): its plain twin vs the JAX package's
lattice apply and vs the JAX Pallas kernel in interpret mode (CPU)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops import sem as jsem
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops.pallas_kernels import stiffness_lattice_3d as pallas_stiffness
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.utils.gll import diff_matrix

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import sem as tsem

from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def _problem(n, shape, seed=0):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal(shape)
    G = [rng.standard_normal(shape) for _ in range(6)]
    return U, G


@pytest.mark.parametrize("n,shape", [(3, (6, 9, 12)), (6, (12, 18, 24)),
                                     (8, (16, 24, 40))])
def test_plain_matches_reference_f64(n, shape):
    U, G = _problem(n, shape)
    ref = np.asarray(jsem.stiffness_apply_lattice(
        jnp.asarray(U), tuple(jnp.asarray(g) for g in G),
        jnp.asarray(diff_matrix(n)), 3))
    out = kernels.stiffness_lattice_3d_plain(
        torch.as_tensor(U), [torch.as_tensor(g) for g in G], n).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-12


def _offset_view(a, offset):
    """A contiguous tensor of ``a``'s values that starts ``offset`` items
    into a larger buffer (no address of it is vector-aligned)."""
    buf = torch.empty(a.size + offset + 8, dtype=torch.float64)
    view = buf[offset:offset + a.size].view(a.shape)
    view.copy_(torch.as_tensor(a))
    return view


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("n,shape", [(7, (21, 14, 35)), (3, (9, 6, 15)),
                                     (5, (10, 15, 25))])
def test_plain_matches_reference_f64_odd_shapes_and_offset_views(n, shape, offset):
    # odd n with row pitches no vector divides, and operands at an odd
    # item offset into a larger buffer: the shapes at which the card's
    # scalar path is held to this twin
    U, G = _problem(n, shape, seed=7)
    ref = np.asarray(jsem.stiffness_apply_lattice(
        jnp.asarray(U), tuple(jnp.asarray(g) for g in G),
        jnp.asarray(diff_matrix(n)), 3))
    Ut = _offset_view(U, offset)
    Gt = [_offset_view(g, offset) for g in G]
    assert Ut.is_contiguous() and Ut.data_ptr() % 16 == (8 * offset) % 16
    out = kernels.stiffness_lattice_3d_plain(Ut, Gt, n).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-12
    assert torch.equal(kernels.stiffness_lattice_3d(Ut, Gt, n),
                       kernels.stiffness_lattice_3d_plain(Ut, Gt, n))


def test_sem_apply_dispatches_to_plain_on_cpu():
    n, shape = 4, (8, 12, 8)
    U, G = _problem(n, shape, seed=1)
    Ut, Gt = torch.as_tensor(U), tuple(torch.as_tensor(g) for g in G)
    kernels.reset_counts()
    out = tsem.stiffness_apply_lattice(Ut, Gt, torch.as_tensor(diff_matrix(n)), 3)
    c = kernels.counts()
    assert c["stiffness_lattice_3d"] == {}
    assert c["stiffness_lattice_3d_plain"] == {"float64": 1}
    assert torch.equal(out, kernels.stiffness_lattice_3d_plain(Ut, Gt, n))


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-6), ("bf16", 1e-2)])
def test_plain_matches_pallas_interpret(dtype, tol):
    # the bound of tests/test_pallas_stiffness.py for f32; bf16 I/O with
    # f32 accumulation on both sides
    n, shape = 8, (16, 128, 128)
    U, G = _problem(n, shape, seed=3)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    Uj = jnp.asarray(U, jdt)
    Gj = tuple(jnp.asarray(g, jdt) for g in G)
    Db, Dbt, D_np = jsem._pallas_lattice_consts(n, jnp.float32)
    ref = np.asarray(pallas_stiffness(Uj, Gj, Db, Dbt, n, D_np,
                                      interpret=True).astype(jnp.float32))
    # identical inputs: the JAX arrays rounded to the I/O dtype
    Ut = torch.as_tensor(np.array(Uj.astype(jnp.float32))).to(tdt)
    Gt = [torch.as_tensor(np.array(g.astype(jnp.float32))).to(tdt) for g in Gj]
    out = kernels.stiffness_lattice_3d_plain(Ut, Gt, n).float().numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < tol


def test_bf16_plain_close_to_f64_oracle():
    # bf16 inputs, f32 accumulation, no intermediate bf16 rounding: within
    # the 0.05-of-max bound of tests/test_pallas_stiffness.py
    n, shape = 8, (8, 16, 24)
    U, G = _problem(n, shape, seed=4)
    Ub = torch.as_tensor(U).to(torch.bfloat16)
    Gb = [torch.as_tensor(g).to(torch.bfloat16) for g in G]
    oracle = kernels.stiffness_lattice_3d_plain(
        Ub.double(), [g.double() for g in Gb], n).numpy()
    out = kernels.stiffness_lattice_3d_plain(Ub, Gb, n).double().numpy()
    assert np.abs(out - oracle).max() / np.abs(oracle).max() < 0.05


@pytest.mark.parametrize("n,shape", [(3, (6, 9, 12)), (8, (16, 24, 40))])
def test_diagonal_matches_reference_f64(n, shape):
    _, G = _problem(n, shape, seed=5)
    D = diff_matrix(n)
    ref = np.asarray(jsem.stiffness_diagonal_lattice(
        tuple(jnp.asarray(g) for g in G), jnp.asarray(D), 3))
    out = tsem.stiffness_diagonal_lattice(
        [torch.as_tensor(g) for g in G], torch.as_tensor(D), 3).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-12


def test_dmul_order_transfer_matches_reference():
    rng = np.random.default_rng(6)
    U = rng.standard_normal((8, 12, 16))
    M = rng.standard_normal((3, 4))
    for axis in range(3):
        ref = np.asarray(jsem.dmul(jnp.asarray(M), jnp.asarray(U), axis, 4))
        out = tsem.dmul(torch.as_tensor(M), torch.as_tensor(U), axis, 4).numpy()
        assert out.shape == ref.shape
        assert np.abs(out - ref).max() < 1e-13
