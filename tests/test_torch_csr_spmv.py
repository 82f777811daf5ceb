"""The fixed-order CSR SpMV (ops/kernels.csr_spmv, csrc/csr_spmv.cu): its
plain twin against scipy and against a scalar emulation of the kernel's
summation order, its lane plan, its wrapper's routes, and a packed
block-diagonal chain over 4 shards. The kernel itself runs only on the
card (chip_smoke.py's spmv phase holds it to this twin bitwise)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.amg.aggregation import (
    aggregation_chain, pack_level_chain, q1_vertex_matrix)
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import csr, kernels

from composite_twins import one_torch_thread  # noqa: F401 (autouse)

NP = {torch.float32: np.float32, torch.float64: np.float64}


def _lengths_matrix(lengths, n_cols=700, seed=0):
    """A CSR matrix whose rows hold ``lengths`` entries, random columns
    and values of mixed sign and magnitude."""
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    indices = np.concatenate([np.sort(rng.choice(n_cols, k, replace=False))
                              for k in lengths]).astype(np.int64)
    data = rng.standard_normal(indptr[-1]) * 10.0 ** rng.integers(
        -3, 4, indptr[-1])
    return sp.csr_matrix((data, indices, indptr), shape=(len(lengths), n_cols))


def _emulate(mat, x):
    """The kernel's order, one scalar at a time in the matrix dtype: lane
    l sums entries start + l, start + l + L, ... from 0, then lane
    l + off is added into lane l for off = L/2, ..., 1."""
    t = NP[mat.dtype]
    crow, cols = mat.crow.numpy(), mat.cols.numpy()
    vals, xv = mat.vals.numpy(), x.numpy()
    L = mat.lanes
    y = np.zeros(mat.shape[0], dtype=t)
    for r in range(mat.shape[0]):
        part = [t(0)] * L
        for lane in range(L):
            for j in range(crow[r] + lane, crow[r + 1], L):
                part[lane] = t(part[lane] + t(vals[j] * xv[cols[j]]))
        off = L // 2
        while off >= 1:
            part = [t(part[k] + part[k + off]) for k in range(off)]
            off //= 2
        y[r] = part[0]
    return y


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_twin_matches_scipy(dtype):
    A = _lengths_matrix([0, 1, 14, 560, 3, 31, 0, 33, 14, 9] * 20)
    x = np.random.default_rng(1).standard_normal(A.shape[1])
    m = csr.csr_from_scipy(A, dtype=dtype, device="cpu")
    y = csr.sparse_spmv(m, torch.as_tensor(x).to(dtype)).double().numpy()
    xr = torch.as_tensor(x).to(dtype).double().numpy()
    ref = A.astype(np.float64) @ xr if dtype == torch.float64 else \
        A.astype(np.float32).astype(np.float64) @ xr
    # of each row's sum of |a_ij x_j|: the f64 round-off bound; f32 holds
    # each row to a few f32 ulps of that sum
    scale = np.abs(A) @ np.abs(xr) + 1e-300
    tol = 1e-14 if dtype == torch.float64 else 2e-6
    assert np.all(np.abs(y - ref) <= tol * scale)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lengths", [[14] * 30, [560, 559, 1, 0, 17],
                                     [1, 0, 1, 2], [5, 3, 9, 0, 0, 4]])
def test_twin_is_the_kernel_order_bitwise(dtype, lengths):
    A = _lengths_matrix(lengths, seed=len(lengths))
    m = csr.csr_from_scipy(A, dtype=dtype, device="cpu")
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        A.shape[1])).to(dtype)
    y = kernels.csr_spmv_plain(m, x).numpy()
    assert y.dtype == NP[dtype]
    assert np.array_equal(y, _emulate(m, x))


def test_twin_repeats_bitwise_under_any_thread_count():
    A = _lengths_matrix([560] * 6 + [14] * 200 + [0, 1] * 30, seed=4)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(A.shape[1]))
    outs = []
    before = torch.get_num_threads()
    try:
        for threads in (1, 3, 2, 4):
            torch.set_num_threads(threads)
            for dt in (torch.float32, torch.float64):
                m = csr.csr_from_scipy(A, dtype=dt, device="cpu")
                outs.append((dt, csr.sparse_spmv(m, x.to(dt))))
    finally:
        torch.set_num_threads(before)
    for dt, y in outs:
        first = next(v for d, v in outs if d == dt)
        assert torch.equal(y, first)


def test_lane_plan_for_short_long_and_empty_rows():
    # as few lanes as give the card 2^21 threads, at most the mean row
    # length rounded down to a power of two, at most 32
    assert [kernels.spmv_lanes(nnz, rows) for nnz, rows in
            ((0, 0), (0, 5), (5, 5), (11, 5), (14, 1), (70, 5),
             (560, 1), (10 ** 6, 3), (20025391, 1430128),
             (2097152, 1430128), (7414875, 4913), (10514292, 265726))] \
        == [1, 1, 1, 2, 8, 8, 32, 32, 2, 1, 32, 8]
    A = _lengths_matrix([0, 1, 14, 560])
    m = csr.csr_from_scipy(A, dtype=torch.float64, device="cpu")
    assert m.lanes == 32                       # mean 143.75 entries a row
    plan = m.lane_plan()
    lengths = plan["lengths"].view(4, 32)
    assert lengths[0].sum() == 0               # the empty row: no entry
    assert lengths[1].tolist() == [1] + [0] * 31
    assert lengths[2].tolist() == [1] * 14 + [0] * 18
    assert lengths[3].tolist() == [18] * 16 + [17] * 16   # 560 = 16*18 + 16*17
    # segment order: row by row, lane by lane, each lane's entries
    # ascending, every entry once
    perm = plan["perm"].numpy()
    assert sorted(perm.tolist()) == list(range(A.nnz))
    assert perm[:2].tolist() == [0, 1]          # row 1, then row 2's lane 0
    row3 = perm[15:]
    assert row3[:18].tolist() == [15 + 32 * k for k in range(18)]
    assert row3[18:36].tolist() == [16 + 32 * k for k in range(18)]
    # one lane: CSR order already is the order, no permutation
    one = csr.csr_from_scipy(_lengths_matrix([1, 0, 1]), dtype=torch.float32,
                             device="cpu")
    assert one.lanes == 1 and one.lane_plan()["perm"] is None
    # an empty matrix and a matrix without entries
    for shape in ((0, 4), (3, 4)):
        e = csr.csr_from_scipy(sp.csr_matrix(shape), dtype=torch.float64,
                               device="cpu")
        y = csr.sparse_spmv(e, torch.ones(4, dtype=torch.float64))
        assert y.shape == (shape[0],) and not y.any()


def test_wrapper_routes_cpu_to_twin_and_never_to_cusparse(monkeypatch):
    A = _lengths_matrix([14] * 40)
    m = csr.csr_from_scipy(A, dtype=torch.float32, device="cpu")
    x = torch.ones(A.shape[1])

    def refuse(*a, **k):
        raise AssertionError("the SpMV reached a library route")

    monkeypatch.setattr(torch, "mv", refuse)
    monkeypatch.setattr(torch, "sparse_csr_tensor", refuse)
    kernels.reset_counts()
    y = csr.sparse_spmv(m, x)
    c = kernels.counts()
    assert c["csr_spmv_plain"] == {"float32": 1} and c["csr_spmv"] == {}
    assert torch.equal(y, kernels.csr_spmv_plain(m, x))
    assert kernels.take_signatures()["csr_spmv"] == []
    # a tensor on no CPU and no card has no kernel: the wrapper raises
    # (on a card it launches the kernel or raises, and has no fallback)
    meta = torch.empty(A.shape[1], device="meta")
    with pytest.raises(ValueError):
        kernels.csr_spmv(m, meta)
    # bf16 keeps its own deterministic route
    assert csr.csr_from_scipy(A, dtype=torch.bfloat16,
                              device="cpu").route == "segment_sum"


def test_packed_block_diagonal_chain_over_four_shards():
    mesh = tg.kershaw_mesh((4, 4, 4), 1, epsilon=0.3, device="cpu")
    A_v, vmask = q1_vertex_matrix(mesh)
    info = aggregation_chain(A_v, vmask, max_coarse=20)
    one = pack_level_chain(info, dtype=torch.float64, device="cpu", shards=1)
    four = pack_level_chain(info, dtype=torch.float64, device="cpu",
                            shards=4)
    rng = np.random.default_rng(5)
    mats = ([(lv["A"], lv1["A"]) for lv, lv1 in zip(four["levels"],
                                                     one["levels"])]
            + list(zip(four["prolongs"], one["prolongs"]))
            + list(zip(four["restricts"], one["restricts"])))
    for m4, m1 in mats:
        assert m4.lanes == m1.lanes and m4.shape == (4 * m1.shape[0],
                                                     4 * m1.shape[1])
        for dt in (torch.float64, torch.float32):
            xs = torch.as_tensor(rng.standard_normal((4, m1.shape[1])))
            y4 = csr.sparse_spmv(
                csr.csr_from_scipy(_as_scipy(m4), dtype=dt, device="cpu"),
                xs.reshape(-1).to(dt)).view(4, -1)
            m1d = csr.csr_from_scipy(_as_scipy(m1), dtype=dt, device="cpu")
            for p in range(4):
                # each shard's rows, in the same order: bitwise equal
                assert torch.equal(y4[p], csr.sparse_spmv(m1d, xs[p].to(dt)))
        ref = _as_scipy(m1) @ xs[0].numpy()
        np.testing.assert_allclose(
            csr.sparse_spmv(m1, xs[0]).numpy(), ref, rtol=0,
            atol=1e-14 * max(np.abs(ref).max(), 1.0))


def _as_scipy(m):
    return sp.csr_matrix((m.vals.double().numpy(), m.cols.numpy(),
                          m.crow.numpy()), shape=m.shape)
