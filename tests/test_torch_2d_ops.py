"""The port's 2-D lattice layer against the JAX package (CPU, f64 unless
stated): the 2-D box and Kershaw meshes, the 2-D operator and diagonal
(lattice and element layouts), the 2-D order transfer, the face sum and
the structured dssum at P = 1, 3 (ragged) and 8, the 9-point stencil and
the 2-D P1 assembly; and that no 2-D tensor ever reaches kernels K1 or K2.

Tolerances: meshes bitwise against the JAX package's numpy forms, 1e-13
of max against its XLA forms; operators and diagonals 1e-12 of max; the
face sum and the dssum bitwise; the stencil 1e-14 of max."""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.amg import fem as jfem
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops import gather_scatter as jgs
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops import interp as jinterp
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops import sem as jsem
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops import stencil as jstencil
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.amg import fem as tfem
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.layout import elements_to_lattice
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import gather_scatter as tgs
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import interp as tinterp
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import sem as tsem
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import stencil as tstencil
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.comm import LocalComm
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.host_oracle import global_to_owned, owned_to_global
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.utils.gll import (
    diff_matrix, gll_points_weights, interp_matrix)

from composite_twins import no_k12, port_mesh
from composite_twins import one_torch_thread  # noqa: F401 (autouse)

_FIELDS = ("coords", "geom", "dirichlet_mask", "node_degree", "mass",
           "glo_num")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _builders(which):
    if which == "kershaw":
        return ((lambda: jg.kershaw_mesh((6, 6), 7, epsilon=0.3)),
                (lambda: tg.kershaw_mesh((6, 6), 7, epsilon=0.3,
                                         device="cpu")))
    return ((lambda: jg.box_mesh((3, 2), 4, extent=(1.0, 2.0))),
            (lambda: tg.box_mesh((3, 2), 4, extent=(1.0, 2.0), device="cpu")))


@pytest.mark.parametrize("which", ["kershaw", "box"])
def test_mesh_2d_matches_reference(which, monkeypatch):
    jb, tb = _builders(which)
    tm = tb()
    assert tm.dim == 2 and tm.geom.shape[-1] == 3
    jm = jb()
    # the JAX package's default forms are XLA kernels: 1e-13 of max
    for k in _FIELDS:
        a, b = getattr(tm, k), getattr(jm, k)
        assert a.shape == b.shape, k
        assert _rel(a, b) <= 1e-13, k
    # its numpy forms (the fallback it keeps as the oracle), bitwise: the
    # port's geometry runs the same operations in torch f64
    monkeypatch.setattr(jg, "_blend_corners_xla", _raise_import)
    monkeypatch.setattr(jg, "_geometric_factors_xla", _raise_import)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jn = jb()
    for k in _FIELDS:
        assert np.array_equal(getattr(tm, k), getattr(jn, k)), k


def _raise_import(*a, **k):
    raise ImportError


def test_geometric_factors_affine_box_2d():
    # tests/test_mesh.py::test_geometric_factors_affine_box at dim = 2
    N, shape = 4, (2, 2)
    mesh = tg.box_mesh(shape, N, device="cpu")
    _, w = gll_points_weights(N + 1)
    h = 1.0 / shape[0]
    detJ = (h / 2) ** 2
    wq = np.multiply.outer(w, w)
    expected = wq.ravel() * detJ * (2 / h) ** 2
    for d in range(2):
        np.testing.assert_allclose(mesh.geom[0, :, d], expected, atol=1e-13)
    assert np.abs(mesh.geom[0, :, 2]).max() < 1e-13
    np.testing.assert_allclose(mesh.mass[0], wq.ravel() * detJ, atol=1e-14)
    # tests/test_mesh.py::test_mass_sums_to_volume, 2-D cases
    for m in (tg.box_mesh((3, 2), 4, device="cpu"),
              tg.kershaw_mesh((6, 6), 3, 0.3, device="cpu")):
        assert abs(m.mass.sum() - 1.0) < 1e-10


def _lattice_problem(shape=(4, 7), N=5, seed=0):
    jm = jg.kershaw_mesh(shape, N, epsilon=0.3)
    n = N + 1
    grid = tuple(reversed(shape))
    G = [elements_to_lattice(jm.geom[..., k], grid, n, 2) for k in range(3)]
    rng = np.random.default_rng(seed)
    U = rng.standard_normal(G[0].shape)
    return jm, n, G, U


def test_lattice_apply_and_diagonal_2d_match_reference():
    jm, n, G, U = _lattice_problem()
    D = diff_matrix(n)
    want = np.asarray(jsem.stiffness_apply_lattice(
        jnp.asarray(U), tuple(jnp.asarray(g) for g in G), jnp.asarray(D), 2))
    Gt = tuple(torch.as_tensor(g) for g in G)
    Dt = torch.as_tensor(D)
    got = tsem.stiffness_apply_lattice(torch.as_tensor(U), Gt, Dt, 2)
    assert got.shape == U.shape and _rel(got, want) <= 1e-12
    dwant = np.asarray(jsem.stiffness_diagonal_lattice(
        tuple(jnp.asarray(g) for g in G), jnp.asarray(D), 2))
    dgot = tsem.stiffness_diagonal_lattice(Gt, Dt, 2)
    assert _rel(dgot, dwant) <= 1e-12
    # a (P, My, Mx) stack of slabs (whole element rows) is each slab's own
    # apply: the stack of three slabs of 2, 3 and 2 element rows padded to
    # 3 with zeros
    rows = [(0, 2), (2, 5), (5, 7)]
    stack = lambda a: torch.stack([torch.as_tensor(np.pad(
        a[r0 * n:r1 * n], ((0, (3 - (r1 - r0)) * n), (0, 0))))
        for r0, r1 in rows])
    Gs = tuple(stack(g) for g in G)
    out = tsem.stiffness_apply_lattice(stack(U), Gs, Dt, 2)
    dout = tsem.stiffness_diagonal_lattice(Gs, Dt, 2)
    for k, (r0, r1) in enumerate(rows):
        h = (r1 - r0) * n
        sl = slice(r0 * n, r1 * n)
        ref = tsem.stiffness_apply_lattice(
            torch.as_tensor(U[sl]), tuple(torch.as_tensor(g[sl]) for g in G),
            Dt, 2)
        assert torch.equal(out[k, :h], ref)
        assert torch.equal(dout[k, :h], dgot[sl])


def test_element_apply_and_diagonal_2d_match_reference():
    jm, n, _, _ = _lattice_problem()
    rng = np.random.default_rng(1)
    u = rng.standard_normal(jm.coords.shape[:2])
    D = diff_matrix(n)
    want = np.asarray(jsem.stiffness_apply(jnp.asarray(u), jnp.asarray(jm.geom),
                                           jnp.asarray(D), 2))
    Gt = tuple(torch.as_tensor(np.ascontiguousarray(jm.geom[..., k]))
               for k in range(3))
    got = tsem.stiffness_apply(torch.as_tensor(u), Gt, torch.as_tensor(D), 2)
    assert _rel(got, want) <= 1e-12
    dwant = np.asarray(jsem.stiffness_diagonal(jnp.asarray(jm.geom),
                                               jnp.asarray(D), 2))
    assert _rel(tsem.stiffness_diagonal(Gt, torch.as_tensor(D), 2),
                dwant) <= 1e-12


def test_bf16_apply_accumulates_in_f32():
    # a bf16 field is contracted in f32 with D from the f64 GLL table and
    # rounded once (K1's arithmetic; the JAX package's 2-D CPU path
    # contracts in bf16): bitwise the f32 apply of the same values,
    # rounded, and nearer the f64 apply than bf16's half ulp allows for
    jm, n, G, U = _lattice_problem(N=7)
    Dt = torch.as_tensor(diff_matrix(n))
    Ub = torch.as_tensor(U).to(torch.bfloat16)
    Gb = tuple(torch.as_tensor(g).to(torch.bfloat16) for g in G)
    out = tsem.stiffness_apply_lattice(Ub, Gb, Dt.to(torch.bfloat16), 2)
    assert out.dtype == torch.bfloat16
    ref32 = tsem.stiffness_apply_lattice(
        Ub.float(), tuple(g.float() for g in Gb), Dt.float(), 2)
    assert torch.equal(out, ref32.to(torch.bfloat16))
    ref64 = tsem.stiffness_apply_lattice(
        Ub.double(), tuple(g.double() for g in Gb), Dt, 2)
    err = (out.double() - ref64).abs().max() / ref64.abs().max()
    assert err <= 2.0 ** -8


def test_prolongation_exact_and_transfers_match_reference():
    # tests/test_pmultigrid.py::test_prolongation_exact_on_polynomials
    nc, nf = 4, 8
    rc, _ = gll_points_weights(nc + 1)
    rf, _ = gll_points_weights(nf + 1)
    J = torch.as_tensor(interp_matrix(nc + 1, nf + 1))
    xc, yc = np.meshgrid(rc, rc, indexing="ij")
    poly = lambda x, y: 1 + 2 * x - y + 3 * x * y + x ** 3 * y ** 2
    u_c = torch.as_tensor(poly(yc, xc).reshape(1, -1))
    u_f = tinterp.prolongate(u_c, J, 2).numpy()
    xf, yf = np.meshgrid(rf, rf, indexing="ij")
    np.testing.assert_allclose(u_f.reshape((nf + 1,) * 2), poly(yf, xf),
                               atol=1e-12)
    # element and lattice transfers against the JAX package, and the
    # restriction the adjoint of the prolongation
    rng = np.random.default_rng(2)
    uc = rng.standard_normal((6, (nc + 1) ** 2))
    vf = rng.standard_normal((6, (nf + 1) ** 2))
    Jj = jnp.asarray(interp_matrix(nc + 1, nf + 1))
    for fn_t, fn_j, x in ((tinterp.prolongate, jinterp.prolongate, uc),
                          (tinterp.restrict, jinterp.restrict, vf)):
        got = fn_t(torch.as_tensor(x), J, 2)
        assert _rel(got, fn_j(jnp.asarray(x), Jj, 2)) <= 1e-12
    lhs = float(torch.sum(tinterp.prolongate(torch.as_tensor(uc), J, 2)
                          * torch.as_tensor(vf)))
    rhs = float(torch.sum(torch.as_tensor(uc)
                          * tinterp.restrict(torch.as_tensor(vf), J, 2)))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))
    L = rng.standard_normal((3 * (nc + 1), 2 * (nc + 1)))
    got = tinterp.lattice_tensor_apply(torch.as_tensor(L), J, 2)
    want = jinterp.lattice_tensor_apply(jnp.asarray(L), Jj, 2)
    assert _rel(got, want) <= 1e-12
    # a (P, My, Mx) stack goes slab by slab
    S = np.stack([L, 2 * L])
    gs = tinterp.lattice_tensor_apply(torch.as_tensor(S), J, 2)
    assert torch.equal(gs[1], tinterp.lattice_tensor_apply(
        torch.as_tensor(2 * L), J, 2))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_face_sum_2d_bitwise(dtype):
    rng = np.random.default_rng(3)
    n = 4
    U = rng.standard_normal((5 * n, 3 * n)).astype(dtype)
    want = np.asarray(jgs.lattice_face_sum(jnp.asarray(U), n))
    got = tgs.face_sum(torch.as_tensor(U), n, 2)
    assert np.array_equal(got.numpy(), want)
    # with weight and mask: the JAX package's structured_dssum order
    wt = (rng.integers(1, 3, U.shape) / 2.0).astype(dtype)
    mk = rng.integers(0, 2, U.shape).astype(dtype)
    want = np.asarray(jgs.structured_dssum(
        jnp.asarray(U), n=n, dim=2, mask=jnp.asarray(mk),
        inv_degree_pts=jnp.asarray(wt), axis_name=None, apply_mask=True,
        apply_weight=True))
    got = tgs.structured_dssum(torch.as_tensor(U), n=n, dim=2,
                               mask=torch.as_tensor(mk),
                               inv_degree_pts=torch.as_tensor(wt),
                               apply_mask=True, apply_weight=True)
    assert np.array_equal(got.numpy(), want)
    # a (P, My, Mx) stack: each entry on its own, bitwise
    S = np.stack([U, 2 * U, -U])
    gs = tgs.face_sum(torch.as_tensor(S), n, 2)
    for k in range(3):
        assert torch.equal(gs[k], tgs.face_sum(torch.as_tensor(S[k]), n, 2))


@pytest.mark.parametrize("P", [1, 3, 8])
def test_structured_dssum_2d_bitwise(P):
    # Kershaw (3, 8) N=3: 8 element rows over 1, 3 (3, 3, 2: ragged) or 8
    # shards; the Domains' dssum of one field, weighted and masked, against
    # the JAX package's, and the port's P shards against its one
    jm = jg.kershaw_mesh((3, 8), 3, epsilon=0.3)
    kw = {} if P == 1 else {"device_mesh": jax.make_mesh((P,), ("shard",))}
    jd = JDomain(jpartition(jm, P), dtype=jnp.float64, **kw)
    td = TDomain(tpartition(port_mesh(jm), P), dtype=torch.float64,
                 device="cpu")
    assert td.ragged == (P == 3)
    u = jd.initial_function(4, seed=11)
    f = np.array(jd.manufacture_rhs(u))
    for w in (False, True):
        want = np.asarray(jd.dssum_field(jnp.asarray(f), apply_mask=True,
                                         apply_weight=w))
        got = td.dssum_field(torch.as_tensor(f), apply_mask=True,
                             apply_weight=w)
        assert got.shape == want.shape
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(td.initial_function(4, seed=11).numpy(),
                          np.asarray(u))
    # and the port's stack against its one shard, in global point order
    d1 = TDomain(tpartition(port_mesh(jm), 1), dtype=torch.float64,
                 device="cpu")
    g = np.random.default_rng(12).standard_normal(jm.num_points)
    glob = lambda d, x: owned_to_global(d, d.from_device_field(x))
    for w in (False, True):
        outs = [glob(d, d.dssum_field(d.to_device_field(global_to_owned(
            d, g)), apply_mask=True, apply_weight=w)) for d in (d1, td)]
        assert np.array_equal(outs[1], outs[0])


def test_slab_exchange_2d_matches_sliced_form():
    # a (P, My, Mx) stack's slab exchange adds rows, uniform and ragged
    rng = np.random.default_rng(4)
    U = torch.as_tensor(rng.standard_normal((4, 6, 5)))
    comm = LocalComm(4)
    want = U.clone()
    want[1:, 0] += U[:-1, -1]
    want[:-1, -1] += U[1:, 0]
    assert torch.equal(comm.slab_exchange_add(U.clone()), want)
    top = torch.tensor([5, 3, 3, 5])
    want = U.clone()
    for k in range(4):
        if k > 0:
            want[k, 0] += U[k - 1, top[k - 1]]
        if k < 3:
            want[k, top[k]] += U[k + 1, 0]
    assert torch.equal(comm.slab_exchange_add(U.clone(), top), want)


def _nine_point(grid, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(grid))
    ids = np.arange(n).reshape(grid)
    rows, cols = [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            r = ids[max(0, -dy):grid[0] - max(0, dy),
                    max(0, -dx):grid[1] - max(0, dx)]
            rows.append(r.ravel())
            cols.append((r + dy * grid[1] + dx).ravel())
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                         shape=(n, n))


def test_nine_point_stencil_matches_reference():
    grid = (5, 6)
    A = _nine_point(grid, 5)
    ct = tstencil.stencil_from_csr(A, grid, dtype=torch.float64)
    cj = jstencil.stencil_from_csr(A, grid, dtype=np.float64)
    assert ct.shape == (9,) + grid and np.array_equal(ct.numpy(), cj)
    rng = np.random.default_rng(6)
    x = rng.standard_normal(A.shape[0])
    got = tstencil.stencil_apply(ct, torch.as_tensor(x), 2)
    assert _rel(got, jstencil.stencil_apply(jnp.asarray(cj), jnp.asarray(x),
                                            2)) <= 1e-14
    assert _rel(got, A @ x) <= 1e-14
    X = rng.standard_normal((3, A.shape[0]))
    gb = tstencil.stencil_apply(ct, torch.as_tensor(X), 2)
    for k in range(3):
        assert _rel(gb[k], A @ X[k]) <= 1e-14


def _warped_grid(shape, seed=0):
    axes = [np.linspace(0.0, 1.0, s) for s in shape]
    G = np.meshgrid(*axes, indexing="ij")
    X = np.stack(list(reversed(G)), axis=-1)
    return X + 0.03 * np.random.default_rng(seed).standard_normal(X.shape)


@pytest.mark.parametrize("use_native", [False, True])
def test_p1_assembly_2d(use_native):
    # tests/test_amg.py: the 5-point identity on the uniform grid
    n = 5
    x, y = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                       indexing="ij")
    A = tfem.p1_stiffness_grid(np.stack([y, x], axis=-1),
                               use_native=use_native)
    A = A.toarray().reshape(n, n, n, n)
    assert np.isclose(A[2, 2, 2, 2], 4.0)
    for di, dj in [(1, 0), (-1, 0), (0, 1), (0, -1)]:
        assert np.isclose(A[2, 2, 2 + di, 2 + dj], -1.0)
    assert np.isclose(A[2, 2, 3, 3], 0.0)
    # symmetric, PSD, constants in the nullspace on a warped grid, and
    # equal to the JAX package's numpy assembly (bitwise for numpy)
    X = _warped_grid((5, 6))
    A = tfem.p1_stiffness_grid(X, use_native=use_native)
    assert abs(A - A.T).max() < 1e-12
    assert np.abs(A @ np.ones(A.shape[0])).max() < 1e-10
    assert np.linalg.eigvalsh(A.toarray()).min() > -1e-10
    B = jfem.p1_stiffness_grid(X, use_native=False)
    if use_native:
        assert abs(A - B).max() <= 1e-14 * abs(B).max()
    else:
        assert np.array_equal(A.indptr, B.indptr)
        assert np.array_equal(A.indices, B.indices)
        assert np.array_equal(A.data, B.data)


def test_2d_never_reaches_k1_or_k2(monkeypatch):
    # the launch counters: a 2-D lattice and a (P, My, Mx) stack, which has
    # a 3-D lattice's rank, go through the 2-D forms; a 3-D lattice still
    # goes through the kernels' wrappers (their plain twins on the CPU)
    jm, n, G, U = _lattice_problem()
    Gt = tuple(torch.as_tensor(g) for g in G)
    Dt = torch.as_tensor(diff_matrix(n))
    Ut = torch.as_tensor(U)
    S = torch.stack([Ut, Ut])
    Gs = tuple(torch.stack([g, g]) for g in Gt)
    m = torch.ones_like(S)
    kernels.reset_counts()
    tsem.stiffness_apply_lattice(Ut, Gt, Dt, 2)
    tsem.stiffness_apply_lattice(S, Gs, Dt, 2)
    tsem.stiffness_apply(Ut.reshape(-1, n * n), tuple(
        g.reshape(-1, n * n) for g in Gt), Dt, 2)
    tgs.face_sum(Ut, n, 2)
    tgs.face_sum(S, n, 2, mask=m, weight=m)
    tgs.structured_dssum(S.clone(), n=n, dim=2, mask=m, inv_degree_pts=m,
                         comm=LocalComm(2), apply_weight=True)
    assert no_k12(), kernels.counts()
    # and the wrappers themselves are never entered
    def refuse(*a, **k):
        raise AssertionError("a 2-D tensor reached a 3-D kernel")
    monkeypatch.setattr(kernels, "stiffness_lattice_3d", refuse)
    monkeypatch.setattr(kernels, "lattice_face_sum_3d", refuse)
    tsem.stiffness_apply_lattice(S, Gs, Dt, 2)
    tgs.structured_dssum(S.clone(), n=n, dim=2, mask=m, inv_degree_pts=m,
                         comm=LocalComm(2))
    monkeypatch.undo()
    # a 3-D lattice: one K1 and one K2 call (plain twins here)
    V = torch.zeros(2 * n, 2 * n, 2 * n, dtype=torch.float64)
    kernels.reset_counts()
    tsem.stiffness_apply_lattice(V, (V,) * 6, Dt, 3)
    tgs.face_sum(V, n, 3)
    c = kernels.counts()
    assert c["stiffness_lattice_3d_plain"] == {"float64": 1}
    assert c["lattice_face_sum_3d_plain"] == {"float64": 1}
    # and dim, not rank, decides: a 2-D stack named 3-D is refused by the
    # operator's factor count
    with pytest.raises(ValueError):
        tsem.stiffness_apply_lattice(S, Gs, Dt, 3)
