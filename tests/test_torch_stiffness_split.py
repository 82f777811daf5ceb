"""PyTorch port of the bf16-split stiffness apply (kernel K3,
ops/kernels.stiffness_lattice_3d_split) and of its precision study: the
plain twin vs the study's Pallas kernel
(artifacts/bench_stiffness_precision.py::apply_split) and vs the JAX
package's K1, both run in Pallas interpret mode on the CPU.

Tolerances, all relative to the reference's largest magnitude:
- f32 twin vs apply_split: 1e-5. The bf16x3 split rounds lo = x - hi to 8
  bits, a truncation of up to 2^-17 of the value, and which way a lo rounds
  depends on the last f32 bit of the W intermediates; two summation orders
  of the same passes therefore differ by a few 1e-6 of max (2.8e-6 here),
  not by the 2e-7 of plain f32 round-off that K1's 2e-6 bound covers.
- bf16 twin vs apply_split and vs K1: 1e-2, one bf16 rounding of the output.
- f32 twin vs K1: 1e-4, the accuracy of the split itself (1.2e-5 here).
"""

import functools
import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import jax.experimental.pallas as pl

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops import sem as jsem
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops.pallas_kernels import stiffness_lattice_3d as pallas_stiffness

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies import stiffness_precision as study

from composite_twins import one_torch_thread  # noqa: F401 (autouse)

_ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "bench_stiffness_precision.py")
N = 8
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def artifact():
    """The study script as a module whose pallas_call runs in interpret
    mode. Importing it edits sys.path and two jax cache options; all
    three are put back before anything compiles."""
    path0 = list(sys.path)
    opts = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in opts}
    spec = importlib.util.spec_from_file_location("_bench_stiffness_precision",
                                                  _ARTIFACT)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path0
        for k, v in saved.items():
            jax.config.update(k, v)
    mod.pl = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return mod


def _inputs(shape, key, seed):
    """Seeded numpy inputs rounded to the I/O dtype, in both frameworks."""
    jdt, tdt = DTYPES[key]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape) for _ in range(7)]
    J = [jnp.asarray(a, jdt) for a in arrs]
    T = [torch.as_tensor(np.array(a.astype(jnp.float32))).to(tdt) for a in J]
    return (J[0], tuple(J[1:])), (T[0], T[1:])


def _consts():
    return jsem._pallas_lattice_consts(N, jnp.float32)


def _rel(out, ref):
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("shape", [(8, 128, 128), (16, 128, 128)])
@pytest.mark.parametrize("key,tol", [("f32", 1e-5), ("bf16", 1e-2)])
def test_twin_matches_study_kernel_interpret(artifact, shape, key, tol):
    (Uj, Gj), (Ut, Gt) = _inputs(shape, key, seed=shape[0])
    Db, Dbt, D_np = _consts()
    ref = np.asarray(artifact.apply_split(Uj, Gj, Db, Dbt, N, D_np)
                     .astype(jnp.float32))
    out = kernels.stiffness_lattice_3d_split_plain(Ut, Gt, N)
    assert out.dtype == Ut.dtype and out.shape == Ut.shape
    assert _rel(out.float().numpy(), ref) <= tol


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("key,tol", [("f32", 1e-5), ("bf16", 1e-2)])
def test_twin_matches_study_kernel_interpret_at_low_orders(artifact, n, key, tol):
    # the Pallas kernel takes every n with 128 % n == 0 through the
    # block-diagonal kron(I_{128/n}, D); so does the card kernel at 8 for
    # n = 2 and 4, and the twin computes element by element
    shape = (2 * n, 128, 128)
    (Uj, Gj), (Ut, Gt) = _inputs(shape, key, seed=10 + n)
    Db, Dbt, D_np = jsem._pallas_lattice_consts(n, jnp.float32)
    ref = np.asarray(artifact.apply_split(Uj, Gj, Db, Dbt, n, D_np)
                     .astype(jnp.float32))
    out = kernels.stiffness_lattice_3d_split_plain(Ut, Gt, n)
    assert out.dtype == Ut.dtype and out.shape == Ut.shape
    assert _rel(out.float().numpy(), ref) <= tol


@pytest.mark.parametrize("n", range(2, 9))
def test_card_kernel_takes_the_orders_of_the_tpu_kernel(n):
    # n = 2, 4, 8 tile the 8-wide contraction (the TPU kernel's
    # 128 % n == 0 at 8); on a CUDA tensor any other n raises ValueError,
    # which the launch plan decides for every lattice and dtype
    assert kernels.SPLIT_ORDERS == (2, 4, 8)
    shape = (2 * n, 3 * n, 4 * n)
    for isz in (2, 4):
        if n in (2, 4, 8):
            plan = kernels._split_plan(shape, n, isz, (0, 1 << 20))
            assert plan.vec >= 2 and plan.blocks >= 1
        else:
            with pytest.raises(ValueError):
                kernels._split_plan(shape, n, isz, (0, 1 << 20))
    # the wrapper's own check comes before any launch: a tensor that lies
    # on neither the CPU nor a card raises ValueError for every n
    meta = torch.empty(shape, device="meta")
    with pytest.raises(ValueError):
        kernels.stiffness_lattice_3d_split(meta, [meta] * 6, n)


@pytest.mark.parametrize("key,tol", [("f32", 1e-4), ("bf16", 1e-2)])
def test_twin_close_to_reference_k1_interpret(key, tol):
    (Uj, Gj), (Ut, Gt) = _inputs((8, 128, 128), key, seed=5)
    Db, Dbt, D_np = _consts()
    ref = np.asarray(pallas_stiffness(Uj, Gj, Db, Dbt, N, D_np,
                                      interpret=True).astype(jnp.float32))
    out = kernels.stiffness_lattice_3d_split_plain(Ut, Gt, N).float().numpy()
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("n", [2, 3, 5, 6])
def test_twin_takes_every_order(n):
    # the twin is element-wise, so any n = 2..8 on an element-aligned
    # lattice; against K1's twin the split costs at most 1e-4 of max
    rng = np.random.default_rng(n)
    shape = (2 * n, 3 * n, 4 * n)
    U = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    G = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
         for _ in range(6)]
    out = kernels.stiffness_lattice_3d_split_plain(U, G, n)
    ref = kernels.stiffness_lattice_3d_plain(U, G, n)
    assert _rel(out.numpy(), ref.numpy()) <= 1e-4
    Ub, Gb = U.bfloat16(), [g.bfloat16() for g in G]
    outb = kernels.stiffness_lattice_3d_split_plain(Ub, Gb, n)
    refb = kernels.stiffness_lattice_3d_plain(Ub, Gb, n)
    assert _rel(outb.float().numpy(), refb.float().numpy()) <= 1e-2


def test_bf16_u_contracts_exactly():
    # split2: a bf16 u against D_hi + D_lo is the contraction with
    # D_hi + D_lo up to f32 summation, and D_hi + D_lo is D to 2^-16
    rng = np.random.default_rng(9)
    shape = (8, 16, 24)
    U = torch.as_tensor(rng.standard_normal(shape)).to(torch.bfloat16)
    D = kernels._diff(N, torch.float32, U.device)
    D_hi, D_lo = kernels._split_bf16(D)
    exact = kernels.dmul(D_hi + D_lo, U.float(), 2, N)
    got = kernels._split_dmul(D, U.float(), 2, N, True)
    assert _rel(got.numpy(), exact.numpy()) <= 1e-6
    assert _rel((D_hi + D_lo).numpy(), D.numpy()) <= 2.0 ** -16


def test_f64_raises_type_error():
    U = torch.zeros((8, 8, 8), dtype=torch.float64)
    with pytest.raises(TypeError):
        kernels.stiffness_lattice_3d_split_plain(U, [U] * 6, N)
    with pytest.raises(TypeError):
        kernels.stiffness_lattice_3d_split(U, [U] * 6, N)


def test_wrapper_runs_the_twin_on_cpu_tensors_only():
    rng = np.random.default_rng(2)
    U = torch.as_tensor(rng.standard_normal((8, 8, 16)), dtype=torch.float32)
    G = [torch.as_tensor(rng.standard_normal((8, 8, 16)), dtype=torch.float32)
         for _ in range(6)]
    kernels.reset_counts()
    out = kernels.stiffness_lattice_3d_split(U, G, N)
    c = kernels.counts()
    assert c["stiffness_lattice_3d_split"] == {}
    assert c["stiffness_lattice_3d_split_plain"] == {"float32": 1}
    assert torch.equal(out, kernels.stiffness_lattice_3d_split_plain(U, G, N))
    # a tensor that is neither on the CPU nor on a card has no kernel
    meta = torch.empty((8, 8, 8), device="meta")
    with pytest.raises(ValueError):
        kernels.stiffness_lattice_3d_split(meta, [meta] * 6, N)


def test_study_error_columns_match_reference_kernels(artifact):
    # the study at m = 128 on the CPU (plain twins) against the same
    # quantities from the two JAX kernels in interpret mode on the same
    # seeded inputs; the oracle is the JAX package's f64 lattice apply
    m = 128
    rows = {(r["dtype"], r["kernel"][:2]): r
            for r in study.run(m, device="cpu")}
    assert len(rows) == 4
    assert all(r["ms"] is None and r["gb_per_s"] is None
               and r["shape"] == (m, m, m) for r in rows.values())
    Db, Dbt, D_np = _consts()
    D64 = jnp.asarray(D_np, jnp.float64)
    for name, (jdt, tdt) in (("bfloat16", DTYPES["bf16"]),
                             ("float32", DTYPES["f32"])):
        U, G = study.make_inputs(m, tdt, "cpu")
        Uj = jnp.asarray(U.float().numpy(), jdt)
        Gj = tuple(jnp.asarray(g.float().numpy(), jdt) for g in G)
        k1 = np.asarray(pallas_stiffness(Uj, Gj, Db, Dbt, N, D_np,
                                         interpret=True).astype(jnp.float64))
        k3 = np.asarray(artifact.apply_split(Uj, Gj, Db, Dbt, N, D_np)
                        .astype(jnp.float64))
        oracle = np.asarray(jsem.stiffness_apply_lattice(
            Uj.astype(jnp.float64), tuple(g.astype(jnp.float64) for g in Gj),
            D64, 3))
        r1, r3 = rows[(name, "K1")], rows[(name, "K3")]
        assert r1["rel_err_vs_k1"] == 0.0
        if name == "float32":
            # the split's error is the same quantity in both packages
            assert r3["rel_err_vs_k1"] == pytest.approx(_rel(k3, k1), rel=0.25)
            assert r3["rel_err_vs_f64"] == pytest.approx(_rel(k3, oracle),
                                                         rel=0.25)
            assert r1["rel_err_vs_f64"] <= 2e-6 and _rel(k1, oracle) <= 2e-6
        else:
            # bf16: every column is one rounding of the output; the JAX K1
            # itself contracts bf16 input by the split, the port's by f32
            # FMAs, so K3-vs-K1 agrees in class (<= 1e-2), not in value
            assert r3["rel_err_vs_k1"] <= 1e-2 and _rel(k3, k1) <= 1e-2
            assert r1["rel_err_vs_f64"] == pytest.approx(_rel(k1, oracle),
                                                         rel=0.25)
            assert r3["rel_err_vs_f64"] == pytest.approx(_rel(k3, oracle),
                                                         rel=0.25)
