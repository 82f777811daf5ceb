"""PyTorch port of the sparse layer (ops/csr.py) vs scipy and the JAX
package's CSR assembly and BSR / COO SpMV, on the shapes of
tests/test_csr.py, CPU. The route is fixed by the dtype: torch's sparse
CSR SpMV in f32 / f64, a gather and a sorted f32 segment sum in bf16."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops import csr as jcsr

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import csr

from composite_twins import one_torch_thread  # noqa: F401 (autouse)

TDT = {"float64": torch.float64, "float32": torch.float32,
       "bfloat16": torch.bfloat16}
JDT = {"float64": jnp.float64, "float32": jnp.float32,
       "bfloat16": jnp.bfloat16}
TOL = {"float64": 1e-13, "float32": 1e-6, "bfloat16": 1e-2}


def random_coo(m, n, density, seed):
    rng = np.random.default_rng(seed)
    nnz = int(m * n * density)
    return (rng.integers(0, m, nnz), rng.integers(0, n, nnz),
            rng.standard_normal(nnz))


def _matrices():
    """test_csr.py's shapes, a matrix with empty rows, a non-square one
    and a matrix with no entries at all."""
    out = {}
    for shape, density in [((50, 70), 0.05), ((200, 200), 0.02),
                           ((33, 17), 0.3), ((5, 5), 1.0)]:
        out[f"{shape[0]}x{shape[1]}"] = csr.assemble_csr(
            *random_coo(*shape, density, seed=1), shape)
    out["empty_rows"] = sp.csr_matrix(
        (np.array([1.0, -2.5]), (np.array([3, 3]), np.array([2, 0]))),
        shape=(5, 4))
    out["523x377"] = sp.random(523, 377, density=0.015, random_state=5,
                               format="csr")
    out["no_entries"] = sp.csr_matrix((6, 3))
    return out


MATS = _matrices()


@pytest.mark.parametrize("drop_tol", [0.0, 1e-12])
def test_assemble_matches_reference(drop_tol):
    rows, cols, vals = random_coo(40, 30, 0.2, seed=4)
    vals[:5] = 1e-15                      # dropped with drop_tol
    a = csr.assemble_csr(rows, cols, vals, (40, 30), drop_tol=drop_tol)
    b = jcsr.assemble_csr(rows, cols, vals, (40, 30), drop_tol=drop_tol)
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.data, b.data)
    m = csr.assemble_csr([0, 0, 1], [1, 1, 0], [2.0, 3.0, 4.0], (2, 2))
    assert m[0, 1] == 5.0 and m[1, 0] == 4.0 and m.nnz == 2


@pytest.mark.parametrize("dt", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MATS))
def test_spmv_matches_scipy_and_reference(name, dt):
    A = MATS[name]
    x = np.random.default_rng(2).standard_normal(A.shape[1])
    mat = csr.csr_from_scipy(A, dtype=TDT[dt], device="cpu")
    xt = torch.as_tensor(x).to(TDT[dt])
    y = csr.sparse_spmv(mat, xt)
    assert y.dtype == TDT[dt] and y.shape == (A.shape[0],)
    y = y.double().numpy()
    # scipy in f64 on the x the port was given
    want = A @ xt.double().numpy()
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(y - want).max() <= TOL[dt] * scale
    # the JAX package's BSR and row-sorted COO SpMV in the same dtype
    xj = jnp.asarray(xt.double().numpy(), dtype=JDT[dt])
    for jm in (jcsr.bsr_from_csr(A, block=8, dtype=JDT[dt]),
               jcsr.coo_from_csr(A, dtype=JDT[dt])):
        yj = np.asarray(jcsr.sparse_spmv(jm, xj), dtype=np.float64)
        assert np.abs(y - yj).max() <= TOL[dt] * scale


def test_route_is_fixed_by_dtype_when_packed():
    A = MATS["200x200"]
    for dt in (torch.float32, torch.float64):
        m = csr.csr_from_scipy(A, dtype=dt, device="cpu")
        assert m.route == "sparse_csr" and m.sparse is not None
        assert m.crow.dtype == m.cols.dtype == torch.int32
        assert m.sparse.layout == torch.sparse_csr
    m = csr.csr_from_scipy(A, dtype=torch.bfloat16, device="cpu")
    assert m.route == "segment_sum" and m.sparse is None
    assert m.vals.dtype == torch.bfloat16 and m.nnz == A.nnz
    assert m.crow.dtype == m.cols.dtype == torch.int64
    assert set(csr.ROUTES) == {torch.float32, torch.float64, torch.bfloat16}
    with pytest.raises(ValueError):
        csr.csr_from_scipy(A, dtype=torch.float16, device="cpu")
    with pytest.raises(TypeError):          # the device is never implied
        csr.csr_from_scipy(A, dtype=torch.float32)
    with pytest.raises(ValueError):
        csr.sparse_spmv(m, torch.zeros(199, dtype=torch.bfloat16))


def test_bf16_route_sums_in_f32_and_rounds_once():
    # one dense row of 4096 products: a bf16 running sum stalls once the
    # sum outgrows the addends; the f32 sum rounded once does not
    rng = np.random.default_rng(3)
    n = 4096
    A = sp.csr_matrix(rng.random((1, n)) + 0.5)
    x = torch.as_tensor(rng.random(n) + 0.5).to(torch.bfloat16)
    m = csr.csr_from_scipy(A, dtype=torch.bfloat16, device="cpu")
    y = csr.sparse_spmv(m, x)
    want = (m.vals.float() * x.float()).sum().to(torch.bfloat16)
    assert y.dtype == torch.bfloat16 and float(y[0]) == float(want)
    exact = float((m.vals.double() * x.double()).sum())
    assert abs(float(y[0]) - exact) <= exact * 2.0 ** -8
    # one fixed summation order: repeated applies are bitwise equal
    assert torch.equal(csr.sparse_spmv(m, x), y)
