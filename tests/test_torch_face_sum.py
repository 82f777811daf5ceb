"""PyTorch port of the one-pass face sum (kernel K2,
ops/kernels.lattice_face_sum_3d): its plain twin vs the JAX roll path and
vs the JAX Pallas kernel in interpret mode (CPU)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops import gather_scatter as jgs
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops import pallas_kernels as jpk

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import gather_scatter as tgs
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels

from composite_twins import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)


_SHAPES = [((16, 16, 16), 4), ((24, 12, 8), 4), ((8, 8, 8), 2),
           ((32, 16, 16), 8), ((16, 8, 24), 8)]


@pytest.mark.parametrize("shape,n", _SHAPES)
def test_plain_bitwise_vs_rolls_and_pallas(interpret_pallas, shape, n):
    rng = np.random.default_rng(0)
    U = rng.standard_normal(shape).astype(np.float32)
    out = kernels.lattice_face_sum_3d_plain(torch.as_tensor(U), n).numpy()
    rolls = np.asarray(jgs.lattice_face_sum(jnp.asarray(U), n, axes=(2, 1, 0)))
    pallas = np.asarray(jpk.lattice_face_sum_3d(jnp.asarray(U), n))
    assert np.array_equal(out, rolls)
    assert np.array_equal(out, pallas)


def _offset_view(a, offset):
    """A contiguous tensor of ``a``'s values that starts ``offset`` items
    into a larger buffer (no address of it is vector-aligned)."""
    buf = torch.empty(a.size + offset + 8, dtype=torch.as_tensor(a).dtype)
    view = buf[offset:offset + a.size].view(a.shape)
    view.copy_(torch.as_tensor(a))
    return view


# odd n: row pitches that no 16-byte vector divides (the kernel's scalar
# path on the card is held to this twin)
_ODD_SHAPES = [((21, 14, 35), 7), ((9, 6, 15), 3), ((10, 15, 25), 5)]


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,n", _ODD_SHAPES)
def test_plain_bitwise_vs_rolls_odd_shapes_and_offset_views(shape, n, dtype, offset):
    rng = np.random.default_rng(5)
    U = rng.standard_normal(shape).astype(dtype)
    mask = rng.integers(0, 2, shape).astype(dtype)
    w = (1.0 / 2.0 ** rng.integers(0, 4, shape)).astype(dtype)
    base = jgs.lattice_face_sum(jnp.asarray(U), n, axes=(2, 1, 0))
    Ut, mt, wt = (_offset_view(a, offset) for a in (U, mask, w))
    assert Ut.is_contiguous() and Ut.data_ptr() % 16 == (offset * U.itemsize) % 16
    plain = kernels.lattice_face_sum_3d_plain
    assert np.array_equal(plain(Ut, n).numpy(), np.asarray(base))
    assert np.array_equal(plain(Ut, n, mask=mt, weight=wt).numpy(),
                          np.asarray(base * w * mask))
    # on the CPU the wrapper is the twin
    assert np.array_equal(kernels.lattice_face_sum_3d(Ut, n, mask=mt).numpy(),
                          np.asarray(base * mask))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_mask_weight_bitwise(interpret_pallas, dtype):
    rng = np.random.default_rng(2)
    shape, n = (16, 16, 16), 4
    U = rng.standard_normal(shape).astype(dtype)
    mask = rng.integers(0, 2, shape).astype(dtype)
    w = (1.0 / rng.integers(1, 5, shape)).astype(dtype)
    base = jgs.lattice_face_sum(jnp.asarray(U), n, axes=(2, 1, 0))
    Ut, mt, wt = (torch.as_tensor(a) for a in (U, mask, w))
    plain = kernels.lattice_face_sum_3d_plain
    assert np.array_equal(plain(Ut, n, mask=mt, weight=wt).numpy(),
                          np.asarray(base * w * mask))
    assert np.array_equal(plain(Ut, n, mask=mt).numpy(),
                          np.asarray(base * mask))
    assert np.array_equal(plain(Ut, n, weight=wt).numpy(),
                          np.asarray(base * w))
    if dtype == np.float32:
        fused = jpk.lattice_face_sum_3d(jnp.asarray(U), n,
                                        mask=jnp.asarray(mask),
                                        weight=jnp.asarray(w))
        assert np.array_equal(plain(Ut, n, mask=mt, weight=wt).numpy(),
                              np.asarray(fused))


def test_bf16_within_reference_bound():
    # bf16 I/O computed in f32 and cast once, vs the JAX bf16 roll path
    # (the 0.02-relative bound of tests/test_pallas_kernels.py)
    rng = np.random.default_rng(1)
    U = jnp.asarray(rng.standard_normal((32, 16, 128)), jnp.bfloat16)
    want = np.asarray(jgs.lattice_face_sum(U, 8, axes=(2, 1, 0)).astype(jnp.float32))
    Ut = torch.as_tensor(np.array(U.astype(jnp.float32))).to(torch.bfloat16)
    got = kernels.lattice_face_sum_3d_plain(Ut, 8).float().numpy()
    denom = np.maximum(np.abs(want), 1.0)
    assert (np.abs(want - got) / denom).max() < 0.02


@pytest.mark.parametrize("apply_mask,apply_weight",
                         [(True, False), (True, True), (False, True)])
def test_structured_dssum_f32_bf16_mask_bitwise(apply_mask, apply_weight):
    # the f32 Domain's dssum: f32 field, bf16 mask and weight (exact 0/1
    # and powers of two), against the reference's one-shard XLA path
    rng = np.random.default_rng(3)
    shape, n = (12, 8, 16), 4
    U = rng.standard_normal(shape).astype(np.float32)
    mask = rng.integers(0, 2, shape).astype(np.float32)
    w = (1.0 / 2.0 ** rng.integers(0, 4, shape)).astype(np.float32)
    ref = np.asarray(jgs.structured_dssum(
        jnp.asarray(U), n=n, dim=3, mask=jnp.asarray(mask, jnp.bfloat16),
        inv_degree_pts=jnp.asarray(w, jnp.bfloat16), axis_name=None,
        apply_mask=apply_mask, apply_weight=apply_weight))
    out = tgs.structured_dssum(
        torch.as_tensor(U), n=n, dim=3,
        mask=torch.as_tensor(mask).to(torch.bfloat16),
        inv_degree_pts=torch.as_tensor(w).to(torch.bfloat16),
        apply_mask=apply_mask, apply_weight=apply_weight)
    assert out.dtype == torch.float32
    assert np.array_equal(out.numpy(), ref)


def test_lattice_face_sum_axes_subset_matches_reference():
    rng = np.random.default_rng(4)
    U = rng.standard_normal((8, 12, 6))
    for axes in [(1,), (2, 0), None]:
        ref = np.asarray(jgs.lattice_face_sum(jnp.asarray(U), 2, axes=axes))
        out = tgs.lattice_face_sum(torch.as_tensor(U), 2, axes=axes).numpy()
        assert np.array_equal(out, ref), axes


_BATCH_DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
                 (torch.float64, torch.float64)]


@pytest.mark.parametrize("io,mw", _BATCH_DTYPES)
@pytest.mark.parametrize("layers,n", [((2, 2, 2, 2), 4), ((2, 1, 1, 1, 1), 4),
                                      ((3, 3, 2, 0), 2)])
def test_batched_twin_equals_separate_calls(io, mw, layers, n):
    # the (P, Mz, My, Mx) stack of slab shards: one batched call of the
    # twin (the kernel's arithmetic) equals P separate 3-D calls value for
    # value, for uniform slabs and for ragged ones whose trailing planes
    # are zero padding (an empty shard is all padding); no sum crosses from
    # one shard into the next
    rng = np.random.default_rng(5)
    P, S = len(layers), max(layers)
    shape = (P, S * n, 3 * n, 2 * n)
    U = rng.standard_normal(shape)
    mask = rng.integers(0, 2, shape).astype(np.float64)
    w = 1.0 / 2.0 ** rng.integers(0, 4, shape)
    for p, m in enumerate(layers):
        U[p, m * n:] = 0.0
        mask[p, m * n:] = 0.0
        w[p, m * n:] = 0.0
    Ut = torch.as_tensor(U).to(io)
    mt, wt = torch.as_tensor(mask).to(mw), torch.as_tensor(w).to(mw)
    for kw in ({}, {"mask": mt}, {"mask": mt, "weight": wt}):
        batched = kernels.lattice_face_sum_3d(Ut, n, **kw)
        assert batched.shape == Ut.shape and batched.dtype == io
        for p in range(P):
            one = kernels.lattice_face_sum_3d(
                Ut[p], n, **{k: v[p] for k, v in kw.items()})
            assert torch.equal(batched[p], one), (p, sorted(kw))
        # the first pad plane receives the real top plane's face (its lo
        # flag is set); the mask, zero there, keeps padding zero
        for p, m in enumerate(layers):
            assert batched[p, m * n + 1:].abs().sum() == 0
            if "mask" in kw:
                assert not batched[p, m * n:].any()
