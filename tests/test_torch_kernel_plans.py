"""Launch plans of the port's two lattice kernels (ops/kernels.py
``_face_sum_plan`` for K2, ``_stiffness_plan`` for K1): pure Python that
chooses vector width, block and grid, checked here against what the
card would refuse (too many threads, too much shared memory, a grid past
its limits, a vector that a pointer or the row pitch does not divide) and
for covering the lattice exactly once. No kernel runs in these tests."""

import itertools

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels

SM_COUNT = 132
MAX_SHARED_OPT_IN = 232_448
MAX_SHARED_STATIC = 48 * 1024        # neither source opts in to more
ITEMSIZE = {"bf16": 2, "f32": 4, "f64": 8}
OFFSETS = (0, 2, 4, 8, 16)

# the lattices chip_smoke.py drives (main path, p-multigrid levels, the
# 4^3-element card-against-CPU meshes, its odd shapes) and a few more
LATTICES = [((128, 128, 128), 8), ((96, 96, 96), 6), ((64, 64, 64), 4),
            ((32, 32, 32), 2), ((48, 40, 56), 8), ((24, 16, 40), 8),
            ((12, 10, 14), 2), ((16, 16, 16), 4), ((24, 24, 24), 6),
            ((8, 8, 8), 2), ((21, 14, 35), 7), ((9, 6, 15), 3),
            ((10, 15, 25), 5), ((512, 512, 512), 8), ((7, 7, 4095), 7),
            ((3, 3, 3), 3)]
ALL_N = [((2 * n, 3 * n, 5 * n), n) for n in range(2, 9)]


def _aligned(ptr, nbytes):
    return ptr % nbytes == 0


def _check_face_sum(shape, n, isz, mw_isz, ptrs, mw_ptrs):
    plan = kernels._face_sum_plan(shape, n, isz, mw_isz, ptrs, mw_ptrs)
    mz, my, mx = shape
    # the vector divides the row and every address, in both types
    assert plan.vec >= 1 and plan.vec * isz <= 16
    assert mx % plan.vec == 0
    assert all(_aligned(p, plan.vec * isz) for p in ptrs)
    mw_vec = min(16, plan.vec * mw_isz)
    assert all(_aligned(p, mw_vec) for p in mw_ptrs)
    assert (mx * mw_isz) % mw_vec == 0
    # what the card takes
    assert plan.threads == plan.tx * plan.by
    assert 1 <= plan.threads <= 256                     # csrc kMaxThreads
    assert not hasattr(plan, "smem_bytes")    # the kernel uses none
    gx, gy, gz = plan.grid
    assert 1 <= gx <= 2 ** 31 - 1 and 1 <= gy <= 65535 and 1 <= gz <= 65535
    # the blocks cover the lattice exactly once: consecutive, disjoint
    # ranges per axis that reach the end and not a whole block beyond it
    for m, t, g in ((mx, plan.tx * plan.vec, gx), (my, plan.by, gy),
                    (mz, 1, gz)):
        assert (g - 1) * t < m <= g * t
    return plan


def _check_stiffness(shape, n, isz):
    # K1 moves one point per access: no address or pitch can misalign it
    plan = kernels._stiffness_plan(shape, n, isz)
    mz, my, mx = shape
    assert plan == kernels._stiffness_launch(shape, n, isz, plan.ey, plan.ez)
    assert plan.ex == kernels._stiffness_strip(n, isz)
    assert plan.threads == plan.ex * n * plan.ey * n
    assert 1 <= plan.threads <= 256                     # csrc kMaxThreads
    assert plan.smem_bytes <= MAX_SHARED_STATIC <= MAX_SHARED_OPT_IN
    gx, gy, gz = plan.grid
    assert 1 <= gx <= 2 ** 31 - 1 and 1 <= gy <= 65535 and 1 <= gz <= 65535
    for m, e, g in ((mx, plan.ex, gx), (my, plan.ey, gy), (mz, plan.ez, gz)):
        elems = m // n
        assert (g - 1) * e < elems <= g * e
    return plan


@pytest.mark.parametrize("shape,n", LATTICES + ALL_N)
@pytest.mark.parametrize("u,mw", [("bf16", "bf16"), ("f32", "bf16"),
                                  ("f64", "f64"), ("f32", "f32"),
                                  ("bf16", "f64")])
def test_face_sum_plan_is_launchable(shape, n, u, mw):
    isz, mw_isz = ITEMSIZE[u], ITEMSIZE[mw]
    base = 1 << 20
    for off, mw_off in itertools.product(OFFSETS, repeat=2):
        if off % isz or mw_off % mw_isz:
            continue          # a tensor's address is a multiple of its item
        _check_face_sum(shape, n, isz, mw_isz, (base + off, base + 4096 + off),
                        (base + mw_off, base + 8192 + mw_off))
        _check_face_sum(shape, n, isz, mw_isz, (base + off, base), ())


@pytest.mark.parametrize("shape,n", LATTICES + ALL_N)
@pytest.mark.parametrize("dtype", ["bf16", "f32", "f64"])
def test_stiffness_plan_is_launchable(shape, n, dtype):
    _check_stiffness(shape, n, ITEMSIZE[dtype])


@pytest.mark.parametrize("u,mw,want", [("bf16", "bf16", 8), ("f32", "bf16", 4),
                                       ("f64", "f64", 2)])
def test_face_sum_vector_is_16_bytes_on_the_main_path(u, mw, want):
    # aligned 128^3 operands move as 16-byte vectors of the field ...
    plan = _check_face_sum((128, 128, 128), 8, ITEMSIZE[u], ITEMSIZE[mw],
                           (0, 1 << 24), (1 << 25,))
    assert plan.vec == want
    # ... a block is whole rows, 128 threads ...
    assert plan.tx * plan.vec == 128 and plan.threads == 128
    # ... and one misaligned operand narrows it, down to scalar access
    isz = ITEMSIZE[u]
    assert _check_face_sum((128, 128, 128), 8, isz, ITEMSIZE[mw],
                           (isz, 1 << 24), (1 << 25,)).vec == 1
    half = _check_face_sum((128, 128, 128), 8, isz, ITEMSIZE[mw],
                           (0, (1 << 24) + 8), (1 << 25,))
    assert half.vec == 8 // isz


@pytest.mark.parametrize("shape,n", [((21, 14, 35), 7), ((9, 6, 15), 3),
                                     ((10, 15, 25), 5)])
def test_odd_pitch_forces_scalar_face_sum(shape, n):
    # 35, 15 and 25 points a row: no vector of two or more divides them
    for isz in (2, 4, 8):
        assert _check_face_sum(shape, n, isz, isz, (0, 4096), (8192,)).vec == 1


def test_small_lattices_narrow_the_face_sum_vector():
    # too few points for 65,536 threads of 16 bytes each: fewer a thread
    assert _check_face_sum((32, 32, 32), 2, 2, 2, (0, 1 << 20), ()).vec == 1
    assert _check_face_sum((64, 64, 64), 4, 2, 2, (0, 1 << 20), ()).vec == 4
    assert _check_face_sum((96, 96, 96), 6, 2, 2, (0, 1 << 20), ()).vec == 8


def test_small_lattices_fill_the_card():
    # 32^3, n = 2: blocks small enough that every SM has one
    for isz in (2, 4, 8):
        plan = _check_face_sum((32, 32, 32), 2, isz, isz, (0, 1 << 20), ())
        assert np.prod(plan.grid) >= SM_COUNT
        plan = _check_stiffness((32, 32, 32), 2, isz)
        assert np.prod(plan.grid) >= SM_COUNT


@pytest.mark.parametrize("shape,n,dtype,ey,ez,blocks", [
    ((128, 128, 128), 8, "bf16", 1, 4, 256), ((128, 128, 128), 8, "f32", 1, 4, 256),
    ((128, 128, 128), 8, "f64", 2, 1, 1024), ((96, 96, 96), 6, "f32", 1, 4, 256),
    ((64, 64, 64), 4, "f32", 1, 2, 256), ((32, 32, 32), 2, "f32", 1, 1, 256),
    ((512, 512, 512), 8, "bf16", 1, 8, 8192), ((48, 40, 56), 8, "f32", 1, 1, 60)])
def test_stiffness_plan_rules(shape, n, dtype, ey, ez, blocks):
    # ey gives way until two blocks per SM are there, ez doubles while it
    # divides the lattice and every SM keeps a block; f64 walks no z
    plan = _check_stiffness(shape, n, ITEMSIZE[dtype])
    assert (plan.ey, plan.ez, int(np.prod(plan.grid))) == (ey, ez, blocks)
    if plan.ez > 1:
        assert np.prod(plan.grid) >= SM_COUNT and (shape[0] // n) % plan.ez == 0


def test_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        kernels._stiffness_plan((9, 8, 8), 8, 4)          # not element-aligned
    with pytest.raises(ValueError):
        kernels._stiffness_plan((18, 18, 18), 9, 4)       # n outside 2..8
    with pytest.raises(ValueError):
        kernels._face_sum_plan((8, 8, 8), 0, 4, 4)
    with pytest.raises(ValueError):                       # grid.y past 65535
        kernels._stiffness_plan((8, 8 * 140000, 8), 8, 8)
    with pytest.raises(ValueError):
        kernels._face_sum_plan((2, 16 * 70000, 8), 2, 4, 4)
    # what the previous kernels took is still taken: 65535 rows or elements
    kernels._stiffness_plan((8, 8 * 65535, 8), 8, 8)
    kernels._face_sum_plan((2, 65535, 8), 1, 4, 4)


@settings(max_examples=200, deadline=None)
@given(n=st.integers(2, 8), ez=st.integers(1, 40), ey=st.integers(1, 40),
       ex=st.integers(1, 40), dtype=st.sampled_from(["bf16", "f32", "f64"]),
       mw=st.sampled_from(["bf16", "f32", "f64"]),
       off=st.sampled_from(OFFSETS), mw_off=st.sampled_from(OFFSETS))
def test_plans_on_random_element_counts(n, ez, ey, ex, dtype, mw, off, mw_off):
    shape = (ez * n, ey * n, ex * n)
    isz, mw_isz = ITEMSIZE[dtype], ITEMSIZE[mw]
    off -= off % isz
    mw_off -= mw_off % mw_isz
    base = 1 << 20
    _check_face_sum(shape, n, isz, mw_isz, (base + off, base),
                    (base + mw_off, base + mw_off))
    _check_stiffness(shape, n, isz)


def test_launch_plan_sweep_forces_a_plan_and_needs_a_card():
    # the sweep (studies/launch_plan_sweep.py) puts a fixed plan in the
    # wrapper's way for one call and takes it out again, also on an error
    import torch
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies import launch_plan_sweep as sweep
    plan = kernels._stiffness_launch((16, 16, 16), 8, 4, 1, 2)
    before = kernels._stiffness_plan
    seen = sweep._forced("_stiffness_plan", plan,
                         lambda: kernels._stiffness_plan((8, 8, 8), 8, 4))
    assert seen is plan and kernels._stiffness_plan is before
    with pytest.raises(ZeroDivisionError):
        sweep._forced("_face_sum_plan", plan, lambda: 1 // 0)
    assert kernels._face_sum_plan((8, 8, 8), 2, 4, 4).vec >= 1
    # every lattice of the sweep is one the plans take
    for shape, n in sweep.K2_LATTICES:
        for isz in ITEMSIZE.values():
            _check_stiffness(shape, n, isz)
            _check_face_sum(shape, n, isz, isz, (0, 1 << 20), ())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sweep.run()
