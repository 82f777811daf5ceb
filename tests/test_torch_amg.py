"""PyTorch port of the assembled composite FEM hierarchy vs the JAX
package, CPU: the native P1 assembly (the port's own binding to native/),
the exact SEM element matrices, build_composite_hierarchy (single group,
multi-group with cross-order slaving, ragged pad slots) and pad_hier_dofs
level for level, and the sparse V-cycle and composite preconditioner on a
hierarchy carried across from the JAX package. Sizes are those of
tests/test_amg.py and tests/test_ragged.py."""

import copy
import os
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.amg import composite as jcomp
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.amg import fem as jfem
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.amg import vcycle as jvc
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.subdomain import (
    _build_group_specs as j_group_specs)

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.amg import composite as tcomp
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.amg import fem as tfem
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.amg import vcycle as tvc
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.subdomain import (
    _build_group_specs as t_group_specs)
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.utils import native

from composite_twins import one_torch_thread  # noqa: F401 (autouse)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_mesh(m):
    return tg.GlobalMesh.from_numpy(
        coords=m.coords, geom=m.geom, dirichlet_mask=m.dirichlet_mask,
        node_degree=m.node_degree, elem_shape=m.elem_shape,
        poly_degree=m.poly_degree, mass=m.mass)


def _warped_grid(shape, seed=0):
    axes = [np.linspace(0.0, 1.0, s) for s in shape]
    G = np.meshgrid(*axes, indexing="ij")
    X = np.stack(list(reversed(G)), axis=-1)
    return X + 0.03 * np.random.default_rng(seed).standard_normal(X.shape)


def _close(a, b, rtol):
    """Max-norm relative agreement of two arrays or sparse matrices."""
    d = a - b
    d = abs(d).max() if sp.issparse(d) else np.abs(d).max()
    scale = abs(b).max() if sp.issparse(b) else np.abs(b).max()
    return d <= rtol * scale


def _same_sparse(a, b, rtol=1e-12):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and _close(a.data, b.data, rtol))


# ---- native P1 assembly and the SEM element matrices ----


def test_native_flags_are_the_makefiles():
    with open(os.path.join(_REPO, "native", "Makefile")) as fh:
        line = re.search(r"^CXXFLAGS\s*\?=\s*(.*)$", fh.read(), re.M)
    assert line.group(1).split() == native.CXXFLAGS
    so = native.build()
    assert os.path.dirname(so).endswith("_build") and os.path.exists(so)
    assert native.build() == so            # an unchanged tree reuses it


def test_native_library_is_named_by_the_building_cpu(monkeypatch):
    # -march=native: a tree copied to another CPU must not load this one's
    here = native.library_path()
    assert native.host_cpu() and native.library_path() == here
    monkeypatch.setattr(native, "host_cpu", lambda: "another machine")
    other = native.library_path()
    assert other != here and os.path.dirname(other) == os.path.dirname(here)


@pytest.mark.parametrize("shape", [(4, 5, 3), (3, 6, 7), (5, 6), (7, 4)])
def test_native_p1_matches_reference_and_numpy(shape):
    X = _warped_grid(shape)
    A = tfem.p1_stiffness_grid(X)
    assert _same_sparse(A, jfem.p1_stiffness_grid(X))
    assert _same_sparse(A, jfem.p1_stiffness_grid(X, use_native=False))
    assert _same_sparse(A, tfem.p1_stiffness_grid(X, use_native=False))


def test_native_coo_to_csr_sums_duplicates():
    rng = np.random.default_rng(2)
    rows, cols = rng.integers(0, 30, 500), rng.integers(0, 20, 500)
    vals = rng.standard_normal(500)
    A = native.coo_to_csr(rows, cols, vals, (30, 20))
    B = sp.coo_matrix((vals, (rows, cols)), shape=(30, 20)).tocsr()
    B.sum_duplicates()
    assert _same_sparse(A, B, rtol=1e-14)
    with pytest.raises(ValueError):
        native.coo_to_csr([30], [0], [1.0], (30, 20))
    with pytest.raises(ValueError):
        native.p1_fem_coo(np.zeros((4, 4, 4)))


@pytest.mark.parametrize("dim,n", [(3, 2), (3, 3), (2, 2), (2, 4)])
def test_sem_element_matrices_match_reference(dim, n):
    ng = 6 if dim == 3 else 3
    geom = np.random.default_rng(dim * 10 + n).random((5, n ** dim, ng))
    a = tfem.sem_element_matrices(geom, dim, n)
    b = jfem.sem_element_matrices(geom, dim, n)
    assert a.shape == (5, n ** dim, n ** dim)
    assert _close(a, b, 1e-13)


# ---- the composite hierarchy ----


def _same_hierarchy(ht, hj):
    assert len(ht.mats) == len(hj.mats) and len(ht.prolongs) == len(hj.prolongs)
    for a, b in zip(ht.mats, hj.mats):
        assert _same_sparse(a, b)
    for a, b in zip(ht.prolongs, hj.prolongs):
        assert _same_sparse(a, b)
    assert _same_sparse(ht.Q, hj.Q)
    assert np.allclose(ht.lmaxs, hj.lmaxs, rtol=1e-12, atol=0.0)
    assert _close(ht.coarse_inv, hj.coarse_inv, 1e-12)
    assert np.array_equal(ht.dof_mask, hj.dof_mask)


def _single_group(shape=(4, 4, 8), order=2):
    jm = jg.kershaw_mesh(shape, order, epsilon=0.3)
    m_last = shape[-1]
    plane = tuple(reversed(shape[:-1]))
    args = ({order: jm}, plane, m_last, 0, 3)
    hj = jcomp.build_composite_hierarchy(
        j_group_specs(m_last, 1, 1, [order], m_last), *args, max_coarse=100)
    ht = tcomp.build_composite_hierarchy(
        t_group_specs(m_last, 1, 1, [order], m_last),
        {order: _port_mesh(jm)}, *args[1:], max_coarse=100)
    return ht, hj


def _multi_groups(shape=(3, 3, 8), N=3, reduction=2, S=2, V=1):
    m_last = shape[-1]
    orders = [N]
    while orders[-1] > 1:
        orders.append(max(orders[-1] - reduction, 1))
    jgroups = j_group_specs(S, V, len(orders), orders, m_last)
    tgroups = t_group_specs(S, V, len(orders), orders, m_last)
    assert [(g.order, g.layers, g.start_pos) for g in jgroups] == \
        [(g.order, g.layers, g.start_pos) for g in tgroups]
    jmeshes = {o: jg.box_mesh(shape, o)
               for o in sorted(set(g.order for g in jgroups))}
    return jgroups, tgroups, jmeshes


def test_single_group_hierarchy_matches_reference():
    ht, hj = _single_group()
    _same_hierarchy(ht, hj)
    A0 = ht.mats[0]
    assert abs(A0 - A0.T).max() < 1e-12 and len(ht.mats) >= 3
    assert set(ht.setup_seconds) == {"p1_assembly", "plane_fold",
                                     "galerkin_chain"}


@pytest.mark.parametrize("base", [0, 2, 4, 6])
def test_multigroup_hierarchy_matches_reference(base):
    # orders 3 and 1 with cross-order (hanging-plane) slaving; the base
    # rotates the cyclic layer order, as each shard of 4 sees it
    jgroups, tgroups, jmeshes = _multi_groups()
    tmeshes = {o: _port_mesh(m) for o, m in jmeshes.items()}
    hj = jcomp.build_composite_hierarchy(jgroups, jmeshes, (3, 3), 8, base, 3)
    ht = tcomp.build_composite_hierarchy(tgroups, tmeshes, (3, 3), 8, base, 3)
    _same_hierarchy(ht, hj)


def _ragged_phys(groups, counts, S, V, L, m_last):
    """Per-shard physical layer lists with -1 pad slots: the group_phys
    map of the JAX package's composite_dd for ragged slab partitions."""
    G = len(groups)
    far_set = set(range(1 + L, G - L)) if G > 1 + 2 * L else set()
    bases = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out = []
    for s, b in zip(counts, bases):
        lists = []
        for gi, g in enumerate(groups):
            if gi == 0:
                off, real = 0, s
            elif far_set and gi > min(far_set):
                off, real = g.start_pos - S + min(counts), g.layers
            elif gi in far_set:
                off, real = g.start_pos + (s - S), m_last - s - 2 * V * L
            else:
                off, real = g.start_pos + (s - S), g.layers
            lists.append([int(b + off + k) % m_last for k in range(real)]
                         + [-1] * (g.layers - real))
        out.append((int(b), lists))
    return out


def test_ragged_hierarchies_and_padding_match_reference():
    # 8 layers over 3 shards (3, 3, 2): pad slots in the own and far
    # groups, then pad_hier_dofs across hierarchies of different sizes
    shape, N, r, V = (2, 2, 8), 2, 1, 1
    counts, m_last = (3, 3, 2), shape[-1]
    orders = [N, max(N - r, 1)]
    S, L = max(counts), len(orders)
    total = S + 2 * V * L + (m_last - min(counts) - 2 * V * L)
    jgroups = j_group_specs(S, V, L, orders, total)
    tgroups = t_group_specs(S, V, L, orders, total)
    jmeshes = {o: jg.box_mesh(shape, o, extent=(1.0, 1.0, 4.0))
               for o in orders}
    tmeshes = {o: _port_mesh(m) for o, m in jmeshes.items()}
    hjs, hts = [], []
    for base, phys in _ragged_phys(jgroups, counts, S, V, L, m_last):
        hjs.append(jcomp.build_composite_hierarchy(
            jgroups, jmeshes, (2, 2), m_last, base, 3, phys_by_group=phys))
        hts.append(tcomp.build_composite_hierarchy(
            tgroups, tmeshes, (2, 2), m_last, base, 3, phys_by_group=phys))
    ndofs = [h.mats[0].shape[0] for h in hts]
    assert len(set(ndofs)) > 1, ndofs
    for ht, hj in zip(hts, hjs):
        _same_hierarchy(ht, hj)
    jcomp.pad_hier_dofs(hjs)
    tcomp.pad_hier_dofs(hts)
    assert len(set(h.mats[0].shape[0] for h in hts)) == 1
    for ht, hj in zip(hts, hjs):
        _same_hierarchy(ht, hj)


# ---- the sparse V-cycle ----


def _apply_both(hj, f_np, cheby_order=2, num_cycles=1):
    tree_j = jvc.pack_hierarchies([hj], dtype=jnp.float64, stack=False)
    # the JAX package's own HostHierarchy, carried across as it is
    tree_t = tvc.pack_hierarchies([hj], dtype=torch.float64, device="cpu")
    yj = np.asarray(jax.jit(lambda f: jvc.vcycle_apply(
        tree_j, f, cheby_order=cheby_order, num_cycles=num_cycles))(
            jnp.asarray(f_np)))
    yt = tvc.vcycle_apply(tree_t, torch.as_tensor(f_np),
                          cheby_order=cheby_order,
                          num_cycles=num_cycles).numpy()
    return yt, yj, tree_j, tree_t


@pytest.mark.parametrize("num_cycles", [1, 2])
def test_vcycle_on_carried_hierarchy_matches_reference(num_cycles):
    _, hj = _single_group()
    f = hj.dof_mask * np.random.default_rng(1).standard_normal(
        hj.mats[0].shape[0])
    yt, yj, tree_j, tree_t = _apply_both(hj, f, num_cycles=num_cycles)
    assert _close(yt, yj, 1e-12)
    # the composite preconditioner: Q^T, mask, V-cycle, mask, Q
    r = np.random.default_rng(2).standard_normal(hj.Q.shape[0])
    zj = np.asarray(jvc.composite_preconditioner(
        tree_j, num_cycles=num_cycles)(jnp.asarray(r)))
    zt = tvc.composite_preconditioner(tree_t, num_cycles=num_cycles)(
        torch.as_tensor(r)).numpy()
    assert _close(zt, zj, 1e-12)


def test_multigroup_vcycle_on_carried_hierarchy_matches_reference():
    jgroups, _, jmeshes = _multi_groups()
    hj = jcomp.build_composite_hierarchy(jgroups, jmeshes, (3, 3), 8, 2, 3)
    f = hj.dof_mask * np.random.default_rng(3).standard_normal(
        hj.mats[0].shape[0])
    yt, yj, _, _ = _apply_both(hj, f)
    assert _close(yt, yj, 1e-12)


def _pcg_iterations(A0, M, b, max_it):
    x = np.zeros_like(b)
    r = b.copy()
    z = M(r)
    p = z.copy()
    rz = r @ z
    b0 = np.linalg.norm(b)
    iters = 0
    for iters in range(1, max_it):
        Ap = A0 @ p
        alpha = rz / (p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        if np.linalg.norm(r) < 1e-8 * b0:
            break
        z = M(r)
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
    return iters


def test_port_vcycle_contracts_and_pcg_converges():
    # tests/test_amg.py's bounds, on the port's own hierarchy and V-cycle
    ht, _ = _single_group()
    A0 = ht.mats[0]
    n = A0.shape[0]
    b = A0 @ (ht.dof_mask * np.random.default_rng(1).standard_normal(n))
    tree = tvc.pack_hierarchies([ht], dtype=torch.float64, device="cpu")
    M = lambda v: tvc.vcycle_apply(tree, torch.as_tensor(v)).numpy()
    x = np.zeros(n)
    norms = [np.linalg.norm(b)]
    for _ in range(4):
        x = x + M(b - A0 @ x)
        norms.append(np.linalg.norm(b - A0 @ x))
    assert norms[-1] / norms[-2] < 0.7, norms
    assert _pcg_iterations(A0, M, b, 60) < 20

    jgroups, tgroups, jmeshes = _multi_groups()
    tmeshes = {o: _port_mesh(m) for o, m in jmeshes.items()}
    hm = tcomp.build_composite_hierarchy(tgroups, tmeshes, (3, 3), 8, 2, 3)
    assert abs(hm.mats[0] - hm.mats[0].T).max() < 1e-11
    tree = tvc.pack_hierarchies([hm], dtype=torch.float64, device="cpu")
    M = lambda v: tvc.vcycle_apply(tree, torch.as_tensor(v)).numpy()
    b = hm.dof_mask * np.random.default_rng(3).standard_normal(
        hm.mats[0].shape[0])
    assert _pcg_iterations(hm.mats[0], M, b, 80) < 30


def test_pack_hierarchies_dtype_and_refusals():
    ht, hj = _single_group()
    tree = tvc.pack_hierarchies([copy.deepcopy(hj)], dtype=torch.bfloat16,
                                device="cpu")
    assert tree["Q"].route == "segment_sum"
    assert tree["levels"][0]["A"].dtype == torch.bfloat16
    assert tree["coarse_inv"].dtype == torch.bfloat16
    assert len(tree["restricts"]) == len(tree["prolongs"]) == len(hj.mats) - 1
    y = tvc.vcycle_apply(tree, torch.ones(hj.mats[0].shape[0],
                                          dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
    # shards pack block-diagonally (the multi-shard composite): a (2, n)
    # stack through one SpMV per operator, each shard its own cycle
    one = tvc.pack_hierarchies([ht], dtype=torch.float64, device="cpu")
    two = tvc.pack_hierarchies([ht, ht], dtype=torch.float64, device="cpu")
    n = ht.mats[0].shape[0]
    assert two["shards"] == 2 and two["levels"][0]["A"].shape == (2 * n, 2 * n)
    assert two["coarse_inv"].dim() == 3 and two["dof_mask"].shape == (2, n)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((2, n)))
    ys = tvc.vcycle_apply(two, x)
    for p in range(2):
        torch.testing.assert_close(ys[p], tvc.vcycle_apply(one, x[p]),
                                   rtol=1e-13, atol=1e-13)
    with pytest.raises(ValueError):
        tvc.pack_hierarchies([], dtype=torch.float32, device="cpu")
    with pytest.raises(TypeError):          # the device is never implied
        tvc.pack_hierarchies([ht], dtype=torch.float32)
