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


# K3 (ops/kernels.py _split_plan): one warp per 8^3 tile, a block takes a
# super-tile of tx x-adjacent tiles, a 1-D grid walks the super-tiles; the
# lattices chip_smoke.py drives at n = 8, 4 and 2, aligned and ragged
SPLIT_LATTICES = [((128, 128, 128), 8), ((512, 512, 512), 8),
                  ((16, 8, 24), 8), ((48, 40, 56), 8), ((128, 128, 128), 4),
                  ((128, 128, 128), 2), ((32, 32, 64), 4), ((12, 20, 28), 4),
                  ((16, 16, 16), 2), ((6, 10, 14), 2), ((8, 8, 8), 8),
                  ((2, 2, 2), 2), ((4, 4, 4092), 4)]
SPLIT_OFFSETS = (0, 4, 8, 16)


def _check_split(shape, n, isz, ptrs):
    plan = kernels._split_plan(shape, n, isz, ptrs)
    mz, my, mx = shape
    # the vector moves a point pair at least, 16 bytes at most, and
    # divides the row pitch and every address
    assert 2 <= plan.vec and plan.vec * isz <= 16 and 8 % plan.vec == 0
    assert mx % plan.vec == 0
    assert all(_aligned(p, plan.vec * isz) for p in ptrs)
    # what the card takes
    assert plan.threads == 32 * plan.tx and 1 <= plan.tx <= 8
    assert plan.threads <= 1024
    assert plan.stages in (2, 3)
    assert plan.smem_bytes == plan.stages * 7 * plan.tx * 512 * isz
    assert plan.smem_bytes <= MAX_SHARED_OPT_IN
    assert plan.opt_in == (plan.smem_bytes > MAX_SHARED_STATIC)
    assert kernels._split_resident(isz, plan.tx, plan.stages) >= 1
    assert 1 <= plan.blocks <= 2 ** 31 - 1
    # the super-tiles cover the lattice exactly once, and the blocks walk
    # every super-tile once (block b takes b, b + blocks, ...)
    sx, sy, sz = plan.supertiles
    for m, t, s in ((mx, plan.tx * 8, sx), (my, 8, sy), (mz, 8, sz)):
        assert (s - 1) * t < m <= s * t
    total = sx * sy * sz
    assert plan.blocks <= total
    walk = -(-total // plan.blocks)
    assert (walk - 1) * plan.blocks < total <= walk * plan.blocks
    return plan


@pytest.mark.parametrize("shape,n", SPLIT_LATTICES)
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_split_plan_is_launchable(shape, n, dtype):
    isz = ITEMSIZE[dtype]
    base = 1 << 20
    for off in SPLIT_OFFSETS:
        if off % (2 * isz):
            continue          # the kernel takes lattices aligned to a pair
        ptrs = [base + k * (1 << 16) + (off if k == 3 else 0) for k in range(8)]
        _check_split(shape, n, isz, ptrs)


@pytest.mark.parametrize("dtype,off,vec", [("bf16", 0, 8), ("bf16", 4, 2),
                                           ("bf16", 8, 4), ("bf16", 16, 8),
                                           ("f32", 0, 4), ("f32", 8, 2),
                                           ("f32", 16, 4)])
def test_split_vector_follows_the_least_aligned_operand(dtype, off, vec):
    # one operand 4, 8 or 16 bytes past a 16-byte boundary narrows the
    # vector of every operand, down to a point pair; nothing is copied
    isz = ITEMSIZE[dtype]
    ptrs = [1 << 24] * 7 + [(1 << 25) + off]
    assert _check_split((48, 40, 56), 8, isz, ptrs).vec == vec


@pytest.mark.parametrize("shape,n,dtype,tx,stages,blocks", [
    ((128, 128, 128), 8, "bf16", 2, 3, 512), ((128, 128, 128), 8, "f32", 2, 2, 256),
    ((512, 512, 512), 8, "bf16", 4, 2, 264), ((512, 512, 512), 8, "f32", 2, 2, 264),
    ((16, 8, 24), 8, "bf16", 2, 3, 4), ((6, 10, 14), 2, "f32", 2, 3, 2),
    ((8, 8, 8), 8, "f32", 1, 3, 1)])
def test_split_plan_rules(shape, n, dtype, tx, stages, blocks):
    # inputs that fit in the L2: 2 tiles a block, 3 stages, every resident
    # block; else super-tile rows of 64 bytes, 2 stages, 2 blocks an SM;
    # fewer tiles where the lattice is narrower
    isz = ITEMSIZE[dtype]
    plan = _check_split(shape, n, isz, (0, 1 << 20))
    assert (plan.tx, plan.stages, plan.blocks) == (tx, stages, blocks)
    fits = 7 * np.prod(shape) * isz <= 40 << 20
    resident = kernels._split_resident(isz, plan.tx, plan.stages)
    walk = -(-np.prod(plan.supertiles) // plan.blocks)
    per_sm = resident if fits else 2
    assert walk == -(-np.prod(plan.supertiles) // (per_sm * SM_COUNT))


def test_split_resident_model():
    # the plan's model of the blocks an SM holds (chip_smoke.py reads the
    # card's own count beside it): 4 blocks of 57,344 bytes, 5 of 43,008
    assert kernels._split_resident(2, 4, 2) == 4
    assert kernels._split_resident(4, 2, 2) == 4
    assert kernels._split_resident(2, 2, 3) == 5
    assert kernels._split_resident(2, 8, 3) == 1
    assert kernels._split_resident(2, 1, 2) == 15


def test_split_plan_refuses_what_the_kernel_does_not_take():
    for n in (3, 5, 6, 7, 9):
        with pytest.raises(ValueError):
            kernels._split_plan((2 * n, 2 * n, 2 * n), n, 4)
    with pytest.raises(ValueError):
        kernels._split_plan((8, 8, 12), 8, 4)             # not element-aligned
    with pytest.raises(ValueError):
        kernels._split_plan((8, 8, 8), 8, 8)              # f64
    with pytest.raises(ValueError):                       # not pair-aligned
        kernels._split_plan((8, 8, 8), 8, 4, (0, 4))
    with pytest.raises(ValueError):                       # past the indices
        kernels._split_plan((8, 8 * 2 ** 28, 8 * 16), 8, 2)


@settings(max_examples=150, deadline=None)
@given(n=st.sampled_from([2, 4, 8]), ez=st.integers(1, 40),
       ey=st.integers(1, 40), ex=st.integers(1, 40),
       dtype=st.sampled_from(["bf16", "f32"]),
       off=st.sampled_from(SPLIT_OFFSETS))
def test_split_plan_on_random_element_counts(n, ez, ey, ex, dtype, off):
    isz = ITEMSIZE[dtype]
    off -= off % (2 * isz)
    _check_split((ez * n, ey * n, ex * n), n, isz, (1 << 20, (1 << 21) + off))
