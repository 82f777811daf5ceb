"""The port's hand-written Hopper kernels, their plain twins and counts.

Each kernel keeps the JAX name of the Pallas TPU kernel it replaces
(``..._tpu/ops/pallas_kernels.py``; the bf16-split study kernel K3
replaces ``artifacts/bench_stiffness_precision.py::apply_split`` and is
named after K1; the fixed-order CSR SpMV ``csr_spmv`` replaces no TPU
kernel, see csrc/csr_spmv.cu) and has a plain PyTorch twin,
``*_plain``, with the same arithmetic. Dispatch: a CPU tensor goes to the
plain twin; a CUDA tensor goes to the kernel (csrc/*.cu, built on first
use by ops/cuda_lib.py) or raises — there is no fallback.

Every wrapper counts its kernel launches per I/O dtype in ``.launches``
(K2 also counts, in ``.batched_launches``, which of them took a stack of
shards);
each plain twin counts its calls in ``.calls``, so a run on the card can
show that it went through the kernels and never through a plain twin.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.gll import diff_matrix
from . import cuda_lib
from .gather_scatter import face_sum_rounded
from .sem import dmul

__all__ = ["stiffness_lattice_3d", "stiffness_lattice_3d_plain",
           "stiffness_lattice_3d_split", "stiffness_lattice_3d_split_plain",
           "lattice_face_sum_3d", "lattice_face_sum_3d_plain",
           "csr_spmv", "csr_spmv_plain", "spmv_lanes", "spmv_lane_plan",
           "LaunchCount", "reset_counts", "counts", "take_signatures"]

_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}


def _dtype_name(dtype) -> str | None:
    return None if dtype is None else str(dtype).replace("torch.", "")


class LaunchCount:
    """Launches (or calls) of one function, per I/O dtype name, and the
    distinct launch signatures (shape, order, dtypes) seen since the last
    ``take_signatures``; ``reset`` clears the counts only."""

    def __init__(self):
        self.by_dtype: dict[str, int] = {}
        self.signatures: set = set()

    def add(self, dtype, signature=None) -> None:
        key = _dtype_name(dtype)
        self.by_dtype[key] = self.by_dtype.get(key, 0) + 1
        if signature is not None:
            self.signatures.add((key,) + tuple(signature))

    def reset(self) -> None:
        self.by_dtype.clear()


def _acc_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


@functools.lru_cache(maxsize=None)
def _diff(n: int, dtype, device) -> torch.Tensor:
    """GLL differentiation matrix of order n-1 from the host f64 table."""
    return torch.as_tensor(diff_matrix(n), dtype=dtype, device=device)


def _check_lattice(name, U, n, others, batched=False):
    """A CUDA lattice (Mz, My, Mx), or with ``batched`` also a stack
    (B, Mz, My, Mx) of them, that the kernel takes."""
    if U.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {U.device} have no kernel")
    if U.dim() != 3 and not (batched and U.dim() == 4):
        raise ValueError(f"{name}: need a 3-D (Mz, My, Mx) lattice"
                         f"{' or a (B, Mz, My, Mx) stack' if batched else ''}"
                         f", got {tuple(U.shape)}")
    if U.dtype not in _CODE:
        raise TypeError(f"{name}: unsupported dtype {U.dtype}")
    if any(m % n for m in U.shape[-3:]):
        raise ValueError(f"{name}: lattice {tuple(U.shape)} is not element-aligned for n={n}")
    for o in others:
        if o.shape != U.shape or o.device != U.device or not o.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous lattices "
                             f"of shape {tuple(U.shape)} on {U.device}")
    if not U.is_contiguous():
        raise ValueError(f"{name}: the input lattice must be contiguous")


def _widest_vector(row_items: int, itemsize: int, ptrs) -> int:
    """The most items (a power of two, at most 16 bytes' worth) that
    one aligned vector access can move for rows of ``row_items`` items of
    ``itemsize`` bytes behind the byte addresses ``ptrs``: the vector
    divides the row pitch and every address. 1 means scalar access."""
    v = max(16 // itemsize, 1)
    while v > 1 and (row_items % v or any(p % (v * itemsize) for p in ptrs)):
        v //= 2
    return v


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {err}")


# ---------------------------------------------------------------------------
# K1: fused SEM stiffness apply (replaces pallas_kernels.stiffness_lattice_3d)


def stiffness_lattice_3d_plain(U, G, n: int):
    """Au = sum_a D_a^T sum_b G_ab D_b u, element by element, accumulated
    in f32 (f64 for f64 I/O) with D from the f64 GLL table; one cast to
    the I/O dtype at the end, as the kernel does."""
    stiffness_lattice_3d_plain.calls.add(U.dtype)
    acc = _acc_dtype(U.dtype)
    D = _diff(n, acc, U.device)
    Dt = D.T
    Uc = U.to(acc)
    G0, G1, G2, G3, G4, G5 = (g.to(acc) for g in G)
    Dr = dmul(D, Uc, 2, n)
    Ds = dmul(D, Uc, 1, n)
    Dt_ = dmul(D, Uc, 0, n)
    Wr = G0 * Dr + G3 * Ds + G4 * Dt_
    Ws = G3 * Dr + G1 * Ds + G5 * Dt_
    Wt = G4 * Dr + G5 * Ds + G2 * Dt_
    out = dmul(Dt, Wr, 2, n) + dmul(Dt, Ws, 1, n) + dmul(Dt, Wt, 0, n)
    return out.to(U.dtype)


class StiffnessPlan(NamedTuple):
    """Launch of csrc/stiffness.cu: a block takes ex x ey elements in x
    and y (one thread per (i, j) column, which moves one point per global
    access) and walks ez elements in z."""
    ex: int
    ey: int
    ez: int
    threads: int
    grid: tuple          # blocks in x, y, z
    smem_bytes: int      # static shared memory of a block


_SM_COUNT = 132                      # H100
_GRID_YZ_MAX = 65535                 # a launch's blocks in y and in z
_STIFFNESS_MAX_THREADS = 256         # csrc/stiffness.cu kMaxThreads
_STIFFNESS_BLOCKS_PER_SM = 2         # csrc/stiffness.cu kMinBlocks
_STIFFNESS_MAX_EZ = 8


def _stiffness_strip(n: int, itemsize: int) -> int:
    """Elements per block along x (csrc/stiffness.cu Strip<Tio, N>::EX):
    the largest power of two whose points fit in 32 (16 for f64)."""
    ex = 1
    while 2 * ex * n <= (16 if itemsize == 8 else 32):
        ex *= 2
    return ex


def _stiffness_launch(shape, n: int, itemsize: int, ey: int, ez: int) -> StiffnessPlan:
    """The launch that blocks of ey x ez elements in y and z give on an
    element-aligned (Mz, My, Mx) lattice (the x-strip follows from n and
    the dtype)."""
    mz, my, mx = shape
    ex = _stiffness_strip(n, itemsize)
    grid = (-(-(mx // n) // ex), -(-(my // n) // ey), -(-(mz // n) // ez))
    acc = 8 if itemsize == 8 else 4
    return StiffnessPlan(ex=ex, ey=ey, ez=ez, threads=ex * n * ey * n,
                         grid=grid,
                         smem_bytes=((n + 4) * _STIFFNESS_MAX_THREADS
                                     + n * (n + 1)) * acc)


@functools.lru_cache(maxsize=None)
def _stiffness_plan(shape, n: int, itemsize: int) -> StiffnessPlan:
    """Block and grid of K1 for an element-aligned (Mz, My, Mx) lattice
    (a tuple) of ``itemsize``-byte points.

    The x-strip is fixed per (n, dtype) at compile time. ey fills the
    block up to 256 threads and gives way until the grid has the two
    blocks per SM that the kernel's register budget lets an SM hold. ez,
    the elements a block walks in z and over which it shares its set-up
    (D into registers), doubles for bf16 and f32 as long as it divides
    the lattice and the grid keeps a block for every SM: 128^3 at n = 8
    then runs as one wave of 256 blocks (f64 gains nothing from it;
    studies/launch_plan_sweep.py times the choices)."""
    if not 2 <= n <= 8 or any(m <= 0 or m % n for m in shape):
        raise ValueError(f"no stiffness plan for lattice {tuple(shape)}, n={n}")
    gey, gez = shape[1] // n, shape[0] // n
    ex = _stiffness_strip(n, itemsize)

    def blocks(ey, ez):
        gx, gy, gz = _stiffness_launch(shape, n, itemsize, ey, ez).grid
        return gx * gy * gz

    ey = 1
    while 2 * ey * ex * n * n <= _STIFFNESS_MAX_THREADS and 2 * ey <= gey:
        ey *= 2
    while ey > 1 and blocks(ey, 1) < _STIFFNESS_BLOCKS_PER_SM * _SM_COUNT:
        ey //= 2
    ez = 1
    while (itemsize < 8 and ez < _STIFFNESS_MAX_EZ and gez % (2 * ez) == 0
           and blocks(ey, 2 * ez) >= _SM_COUNT):
        ez *= 2
    plan = _stiffness_launch(shape, n, itemsize, ey, ez)
    if plan.grid[1] > _GRID_YZ_MAX or plan.grid[2] > _GRID_YZ_MAX:
        raise ValueError(f"lattice {tuple(shape)} exceeds the launch grid")
    return plan


@functools.lru_cache(maxsize=None)
def _stiffness_chunks(shape, n: int, itemsize: int):
    """K1's launches on an element-aligned (Mz, My, Mx) lattice (a
    tuple): ((first element in z, elements in z, plan), ...), one launch
    unless the plan's grid would pass 65535 blocks in z (an element view
    (E * n, n, n) of more than 65,535 elements that the plan's ez does not
    fold under the limit); then near-equal runs of whole elements in z,
    each with its own plan. The apply is element-local, so the runs are
    independent."""
    elems = shape[0] // n
    try:
        return ((0, elems, _stiffness_plan(shape, n, itemsize)),)
    except ValueError:
        if elems <= _GRID_YZ_MAX:
            raise
    k = -(-elems // _GRID_YZ_MAX)
    out, z0 = [], 0
    for c in range(k):
        ez = elems // k + (c < elems % k)
        out.append((z0, ez, _stiffness_plan((ez * n,) + tuple(shape[1:]), n,
                                            itemsize)))
        z0 += ez
    return tuple(out)


def stiffness_lattice_3d(U, G, n: int):
    """One-pass fused SEM stiffness apply on a (Mz, My, Mx) lattice with
    the six factor lattices G (G_rr, G_ss, G_tt, G_rs, G_rt, G_st), all
    of U's dtype (bf16, f32 or f64); any element-aligned shape, n = 2..8.

    A (P, Mz, My, Mx) stack of slab shards is taken as its (P*Mz, My, Mx)
    view: each shard is a whole number of elements in z and the apply is
    element-local, so one launch gives every shard's own apply.
    """
    if U.dim() == 4:
        flat = lambda t: t.reshape((-1,) + tuple(t.shape[2:]))
        return stiffness_lattice_3d(flat(U), [flat(g) for g in G],
                                    n).view(U.shape)
    if U.device.type == "cpu":
        return stiffness_lattice_3d_plain(U, G, n)
    if len(G) != 6:
        raise ValueError("stiffness_lattice_3d: need 6 geometric factor lattices")
    _check_lattice("stiffness_lattice_3d", U, n, G)
    if any(g.dtype != U.dtype for g in G):
        raise TypeError("stiffness_lattice_3d: factors must have U's dtype")
    if not 2 <= n <= 8:
        raise ValueError(f"stiffness_lattice_3d: n={n} outside 2..8")
    mz, my, mx = U.shape
    out = torch.empty_like(U)
    if U.numel() == 0:
        return out
    isz = U.element_size()
    # the host's f64 GLL table; the launch casts it to the accumulation
    # type and hands it to the kernel by value
    D = diff_matrix(n)
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        for z0, ez, plan in _stiffness_chunks(tuple(U.shape), n, isz):
            off = z0 * n * my * mx * isz
            err = cuda_lib.load().prfdd_stiffness_3d(
                _CODE[U.dtype], n, U.data_ptr() + off,
                *(g.data_ptr() + off for g in G), D.ctypes.data,
                out.data_ptr() + off, ez * n, my, mx, plan.ex, plan.ey,
                plan.ez, stream)
            _raise_on(err, "stiffness_lattice_3d")
            stiffness_lattice_3d.launches.add(U.dtype, (tuple(U.shape), n))
    return out


# ---------------------------------------------------------------------------
# K3: K1 with bf16-split tensor-core contractions (replaces
# artifacts/bench_stiffness_precision.py::apply_split, a precision study)


def _split_bf16(x):
    """x = hi + lo with both parts bf16 values (round to nearest even),
    returned as f32 tensors: hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    lo = (x.float() - hi.float()).to(torch.bfloat16)
    return hi.float(), lo.float()


def _split_dmul(M, X, axis: int, n: int, exact: bool):
    """dmul(M, X) as bf16 passes with f32 accumulation: 2 passes when X
    holds bf16 values exactly (X M_hi + X M_lo), else the bf16x3 split
    (hi hi + the two cross terms; the lo lo term is dropped). The cross
    terms come in the order of the study's x-form (axis 2) and y-form."""
    M_hi, M_lo = _split_bf16(M)
    if exact:
        return dmul(M_hi, X, axis, n) + dmul(M_lo, X, axis, n)
    X_hi, X_lo = _split_bf16(X)
    out = dmul(M_hi, X_hi, axis, n)
    if axis == 2:
        return out + dmul(M_lo, X_hi, axis, n) + dmul(M_hi, X_lo, axis, n)
    return out + dmul(M_hi, X_lo, axis, n) + dmul(M_lo, X_hi, axis, n)


def stiffness_lattice_3d_split_plain(U, G, n: int):
    """K1's apply with the x- and y-contractions as bf16 passes summed in
    f32 (the products of two bf16 values are exact in f32): f32 I/O splits
    u and D (3 passes), bf16 I/O contracts the exact u with the split D (2
    passes), the f32 W intermediates always take 3. The z-contractions use
    the unsplit f32 D; one cast at the end. D is the f64 GLL table in f32,
    the same table K1 uses, so the two differ by the split only. On a card
    the f32 products need TF32 off, as the package root sets it."""
    if U.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("stiffness_lattice_3d_split: bf16 or f32 I/O, "
                        f"got {U.dtype}")
    stiffness_lattice_3d_split_plain.calls.add(U.dtype)
    exact_u = U.dtype == torch.bfloat16
    D = _diff(n, torch.float32, U.device)
    Dt = D.T
    Uf = U.float()
    G0, G1, G2, G3, G4, G5 = (g.float() for g in G)
    Dr = _split_dmul(D, Uf, 2, n, exact_u)
    Ds = _split_dmul(D, Uf, 1, n, exact_u)
    Dt_ = dmul(D, Uf, 0, n)
    Wr = G0 * Dr + G3 * Ds + G4 * Dt_
    Ws = G3 * Dr + G1 * Ds + G5 * Dt_
    Wt = G4 * Dr + G5 * Ds + G2 * Dt_
    out = (_split_dmul(Dt, Wr, 2, n, False) + _split_dmul(Dt, Ws, 1, n, False)
           + dmul(Dt, Wt, 0, n))
    return out.to(U.dtype)


class SplitPlan(NamedTuple):
    """Launch of csrc/stiffness_split.cu: one warp per 8^3 tile, a block
    takes a super-tile of ``tx`` x-adjacent tiles and walks the super-tiles
    with the grid's stride, ``stages`` of them staged at once in dynamic
    shared memory by vectors of ``vec`` points."""
    vec: int             # points a global access (a pair at least)
    tx: int              # tiles (warps) a block
    stages: int          # shared buffers: stages - 1 super-tiles in flight
    threads: int
    blocks: int          # 1-D grid
    supertiles: tuple    # super-tiles in x, y, z
    smem_bytes: int      # dynamic shared memory of a block
    opt_in: bool         # above 48 KB: the kernel's attribute is raised


SPLIT_ORDERS = (2, 4, 8)       # n with an 8 x 8 block-diagonal kron(I, D_n)
_SPLIT_TILE = 8
_SPLIT_LATTICES = 7
_SPLIT_MAX_TX = 8              # csrc/stiffness_split.cu kMaxThreads / 32
_SPLIT_ROW_BYTES = 64          # a super-tile row of two whole 32-byte sectors
_SPLIT_REGS = 128              # __launch_bounds__(256, 2)
_SPLIT_L2_INPUT_BYTES = 40 << 20   # inputs that fit in the H100's 50 MB L2
_SM_SHARED = 233_472           # H100: shared memory of an SM
_SM_BLOCK_RESERVED = 1024      # shared memory CUDA reserves per resident block
_SM_THREADS = 2048
_SM_BLOCKS = 32
_SM_REGS = 65_536
MAX_SHARED_BLOCK = 232_448     # a block's most, with the opt-in
MAX_SHARED_STATIC = 48 * 1024  # a block's most without it


def _split_resident(itemsize: int, tx: int, stages: int) -> int:
    """Blocks of ``tx`` warps and ``stages`` buffers that one SM holds at
    once, by the card's limits on shared memory (a block's own and what
    CUDA reserves for it), threads, blocks and registers."""
    threads = 32 * tx
    smem = stages * _SPLIT_LATTICES * tx * _SPLIT_TILE ** 3 * itemsize
    return min(_SM_SHARED // (smem + _SM_BLOCK_RESERVED),
               _SM_THREADS // threads, _SM_BLOCKS,
               _SM_REGS // (threads * _SPLIT_REGS))


def _split_launch(shape, itemsize: int, vec: int, tx: int, stages: int,
                  per_sm: int | None = None) -> SplitPlan:
    """The launch that ``tx`` tiles a block and ``stages`` buffers give on
    a (Mz, My, Mx) lattice with ``per_sm`` blocks an SM (by default all
    that fit): one block for each of them, evened out so that every block
    walks the same number of super-tiles (give or take one)."""
    mz, my, mx = shape
    t = _SPLIT_TILE
    sup = (-(-mx // (tx * t)), -(-my // t), -(-mz // t))
    total = sup[0] * sup[1] * sup[2]
    threads = 32 * tx
    smem = stages * _SPLIT_LATTICES * tx * t ** 3 * itemsize
    resident = _split_resident(itemsize, tx, stages)
    per_sm = resident if per_sm is None else min(per_sm, resident)
    walk = -(-total // max(per_sm * _SM_COUNT, 1))
    blocks = -(-total // walk)
    return SplitPlan(vec=vec, tx=tx, stages=stages, threads=threads,
                     blocks=blocks, supertiles=sup, smem_bytes=smem,
                     opt_in=smem > MAX_SHARED_STATIC)


def _split_plan(shape, n: int, itemsize: int, ptrs=()) -> SplitPlan:
    """Vector width, tiles a block, stages and grid of K3 for an
    element-aligned (Mz, My, Mx) lattice of ``itemsize``-byte points
    (bf16 or f32) behind the byte addresses ``ptrs`` (the seven operands
    and the output).

    The vector is the widest (16 bytes at most) that divides the row and
    every address; a point pair at least, or the lattice is refused. Then
    one of two launches, after studies/launch_plan_sweep.py:
    - the seven inputs fit in the L2 (bf16 at 128^3): the time is set by
      how many tiles an SM works on at once, not by the device memory, so
      a block takes 2 tiles, keeps 3 stages (two super-tiles in flight)
      and every block the card holds is launched;
    - else device memory sets it, and its pages are read best in long
      runs by few streams: a block takes as many tiles as make super-tile
      rows of 64 bytes, two whole sectors (4 in bf16, 2 in f32), 2 stages,
      and each SM runs 2 blocks.
    Fewer tiles a block where the lattice is narrower."""
    return _split_plan_of(tuple(shape), n, itemsize,
                          tuple(p % 16 for p in ptrs))


@functools.lru_cache(maxsize=None)
def _split_plan_of(shape, n, itemsize, ptrs):
    if (n not in SPLIT_ORDERS or itemsize not in (2, 4) or len(shape) != 3
            or any(m <= 0 or m % n for m in shape)):
        raise ValueError(f"no bf16-split stiffness plan for lattice "
                         f"{tuple(shape)}, n={n}, {itemsize}-byte points")
    if max(shape) > 2 ** 31 - 1:
        raise ValueError(f"lattice {tuple(shape)} exceeds the kernel's indices")
    mz, my, mx = shape
    vec = _widest_vector(mx, itemsize, ptrs)
    if vec < 2:
        raise ValueError("lattices must be aligned to a point pair")
    tiles_x = -(-mx // _SPLIT_TILE)
    if _SPLIT_LATTICES * mz * my * mx * itemsize <= _SPLIT_L2_INPUT_BYTES:
        tx, stages, per_sm = 2, 3, None
    else:
        tx, stages, per_sm = _SPLIT_ROW_BYTES // (_SPLIT_TILE * itemsize), 2, 2
    while tx > 1 and tx // 2 >= tiles_x:
        tx //= 2
    plan = _split_launch(shape, itemsize, vec, tx, stages, per_sm)
    if plan.supertiles[0] * plan.supertiles[1] * plan.supertiles[2] > 2 ** 31 - 1:
        raise ValueError(f"lattice {tuple(shape)} exceeds the kernel's indices")
    return plan


def stiffness_lattice_3d_split(U, G, n: int):
    """The bf16-split tensor-core stiffness apply on a (Mz, My, Mx)
    lattice, bf16 or f32 I/O. The kernel takes n = 2, 4 and 8 (the orders
    whose elements tile the 8-wide contraction) on any element-aligned
    lattice whose operands are aligned to a point pair; another n on a
    CUDA tensor raises ValueError."""
    if U.device.type == "cpu":
        return stiffness_lattice_3d_split_plain(U, G, n)
    name = "stiffness_lattice_3d_split"
    if len(G) != 6:
        raise ValueError(f"{name}: need 6 geometric factor lattices")
    _check_lattice(name, U, n, G)
    if U.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: bf16 or f32 I/O, got {U.dtype}")
    if any(g.dtype != U.dtype for g in G):
        raise TypeError(f"{name}: factors must have U's dtype")
    if n not in SPLIT_ORDERS:
        raise ValueError(f"{name}: the kernel contracts K = 8 with "
                         f"kron(I, D_n), n in {SPLIT_ORDERS}; got n={n}")
    out = torch.empty_like(U)
    if U.numel() == 0:
        return out
    mz, my, mx = U.shape
    ptrs = [t.data_ptr() for t in (U, *G, out)]
    plan = _split_plan(U.shape, n, U.element_size(), ptrs)
    # the host's f64 GLL table; the launch lays it out as kron(I_{8/n}, D)
    # in f32 and hands it to the kernel by value
    D = diff_matrix(n)
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        err = cuda_lib.load().prfdd_stiffness_split_3d(
            _CODE[U.dtype], n, *ptrs[:7], D.ctypes.data, ptrs[7],
            mz, my, mx, plan.vec * U.element_size(), plan.tx, plan.stages,
            plan.blocks, stream)
    _raise_on(err, name)
    stiffness_lattice_3d_split.launches.add(U.dtype)
    return out


def split_blocks_per_sm(dtype, plan: SplitPlan) -> int:
    """The card's own count of the blocks of ``plan`` (bf16 or f32 I/O)
    that one SM of the current device holds at once: what
    ``_split_resident`` models."""
    per_sm = ctypes.c_int(0)
    _raise_on(cuda_lib.load().prfdd_stiffness_split_blocks_per_sm(
        _CODE[dtype], plan.vec * dtype.itemsize, plan.tx, plan.stages,
        ctypes.byref(per_sm)), "split_blocks_per_sm")
    return per_sm.value


# ---------------------------------------------------------------------------
# K2: one-pass face sum (replaces pallas_kernels.lattice_face_sum_3d)


def lattice_face_sum_3d_plain(U, n: int, mask=None, weight=None):
    """The roll form along x, y, z in f32 (f64 for f64 I/O), then
    x weight, then x mask, then one cast to U's dtype — the kernel's
    exact arithmetic, so f32/f64/bf16 results are bitwise equal. A
    (B, Mz, My, Mx) stack sums each lattice on its own (the rolls wrap
    inside an entry, where the flags are 0)."""
    lattice_face_sum_3d_plain.calls.add(U.dtype)
    d = U.dim()
    return face_sum_rounded(U, n, (d - 1, d - 2, d - 3), mask=mask,
                            weight=weight)


class FaceSumPlan(NamedTuple):
    """Launch of csrc/face_sum.cu: a thread owns ``vec`` x-contiguous
    points, a block tx threads along x times by rows of one plane."""
    vec: int             # points per thread
    tx: int              # threads along x
    by: int              # rows (y) per block
    threads: int
    grid: tuple          # blocks in x, y, z


_FACE_SUM_THREADS = 128
_FACE_SUM_MIN_THREADS = 1 << 16  # a quarter of what the card holds at once
_FACE_SUM_MAX_ROWS = 16


def _face_sum_plan(shape, n: int, itemsize: int, mw_itemsize: int,
                   ptrs=(), mw_ptrs=()) -> FaceSumPlan:
    """Vector width, block and grid of K2 for a (Mz, My, Mx) lattice of
    ``itemsize``-byte points whose mask and weight have ``mw_itemsize``
    bytes; ``ptrs`` are the byte addresses of the field and the output,
    ``mw_ptrs`` those of mask and weight.

    The vector is the widest (16 bytes of the field at most) that divides
    the row and every address, narrowed on a small lattice until the grid
    has 65,536 threads (32^3 then runs one point a thread: what counts
    there is the length of a thread's chain, not the instructions). A
    block takes a whole row (up to 128 vectors of it) and as many
    consecutive rows of one plane, a power of two up to 16, as give about
    128 threads (neighbouring rows then share the block's L1), fewer
    while the grid has no block for every SM."""
    # only an address's remainder by the widest vector matters
    return _face_sum_plan_of(tuple(shape), n, itemsize, mw_itemsize,
                             tuple(p % 16 for p in ptrs),
                             tuple(p % 16 for p in mw_ptrs))


def _face_sum_launch(shape, vec: int, by: int) -> FaceSumPlan:
    """The launch that ``vec`` points a thread and ``by`` rows a block
    give on a (Mz, My, Mx) lattice."""
    mz, my, mx = shape
    tx = min(mx // vec, _FACE_SUM_THREADS)
    return FaceSumPlan(vec=vec, tx=tx, by=by, threads=tx * by,
                       grid=(-(-mx // (tx * vec)), -(-my // by), mz))


@functools.lru_cache(maxsize=None)
def _face_sum_plan_of(shape, n, itemsize, mw_itemsize, ptrs, mw_ptrs):
    mz, my, mx = shape
    if n < 1 or min(shape) <= 0:
        raise ValueError(f"no face-sum plan for lattice {tuple(shape)}, n={n}")
    vec = _widest_vector(mx, itemsize, ptrs)
    while vec > 1 and any(p % min(16, vec * mw_itemsize) for p in mw_ptrs):
        vec //= 2
    while vec > 1 and mz * my * mx // vec < _FACE_SUM_MIN_THREADS:
        vec //= 2

    def blocks(by):
        gx, gy, gz = _face_sum_launch(shape, vec, by).grid
        return gx * gy * gz

    tx = min(mx // vec, _FACE_SUM_THREADS)
    by = 1
    while (2 * by * tx <= _FACE_SUM_THREADS and 2 * by <= _FACE_SUM_MAX_ROWS
           and 2 * by <= my):
        by *= 2
    while by > 1 and blocks(by) < _SM_COUNT:
        by //= 2
    plan = _face_sum_launch(shape, vec, by)
    if plan.grid[1] > _GRID_YZ_MAX or plan.grid[2] > _GRID_YZ_MAX:
        raise ValueError(f"lattice {tuple(shape)} exceeds the launch grid")
    return plan


def lattice_face_sum_3d(U, n: int, mask=None, weight=None):
    """One-pass fused face summation on a (Mz, My, Mx) lattice, or on each
    lattice of a (B, Mz, My, Mx) stack in one launch (no sum crosses from
    one entry into the next), with the optional same-shape ``weight`` and
    ``mask`` multiplied in before the single output cast. mask and weight
    share one dtype, which may differ from U's (an f32 field carries a
    bf16 mask and weight)."""
    if U.device.type == "cpu":
        return lattice_face_sum_3d_plain(U, n, mask=mask, weight=weight)
    mw = [t for t in (mask, weight) if t is not None]
    _check_lattice("lattice_face_sum_3d", U, n, mw, batched=True)
    if len({t.dtype for t in mw}) > 1 or any(t.dtype not in _CODE for t in mw):
        raise TypeError("lattice_face_sum_3d: mask and weight need one "
                        "dtype among bf16, f32, f64")
    out = torch.empty_like(U)
    if U.numel() == 0:
        return out
    batch = U.shape[0] if U.dim() == 4 else 1
    mz, my, mx = U.shape[-3:]
    mw_dtype = mw[0].dtype if mw else U.dtype
    # the plan sees the batch as one lattice of batch * mz planes
    plan = _face_sum_plan((batch * mz, my, mx), n, U.element_size(),
                          mw_dtype.itemsize,
                          (U.data_ptr(), out.data_ptr()),
                          [t.data_ptr() for t in mw])
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        err = cuda_lib.load().prfdd_face_sum_3d(
            _CODE[U.dtype], _CODE[mw_dtype], n, U.data_ptr(),
            None if mask is None else mask.data_ptr(),
            None if weight is None else weight.data_ptr(),
            out.data_ptr(), batch, mz, my, mx, plan.vec, plan.tx, plan.by,
            stream)
    _raise_on(err, "lattice_face_sum_3d")
    lattice_face_sum_3d.launches.add(
        U.dtype, (tuple(U.shape), n, _dtype_name(mw_dtype) if mw else None,
                  mask is not None, weight is not None))
    if U.dim() == 4:
        lattice_face_sum_3d.batched_launches.add(U.dtype)
    return out


# ---------------------------------------------------------------------------
# The fixed-order CSR SpMV (no TPU counterpart: the JAX package leaves its
# SpMV to XLA's gather and sorted segment_sum)


# threads the SpMV aims to start: about 8 resident grids of the H100
# (132 SMs x 2,048 threads), enough to hide its dependent loads
_SPMV_THREADS = 1 << 21


def spmv_lanes(nnz: int, n_rows: int) -> int:
    """Lanes a row for the SpMV kernel, a power of two from 1 to 32: as
    few as give the card _SPMV_THREADS threads, and no more than the mean
    row length (rounded down to a power of two)."""
    mean = nnz / max(n_rows, 1)
    lanes = 1
    while (lanes < 32 and 2 * lanes <= mean
           and lanes * n_rows < _SPMV_THREADS):
        lanes *= 2
    return lanes


def spmv_lane_plan(crow, lanes: int) -> dict:
    """The kernel's summation order as segments of one ordered sum: lane l
    of a row sums its entries start + l, start + l + L, ... in ascending
    order. Returns ``lengths``, the (n_rows * L,) entries of each (row,
    lane) segment, and ``perm``, the entries in segment order (None when
    L = 1: CSR order already is), as int64 tensors on crow's device."""
    crow = crow.to(torch.int64)
    rl = crow[1:] - crow[:-1]
    n = rl.numel()
    lane = torch.arange(lanes, device=crow.device)
    lengths = ((rl[:, None] - lane + (lanes - 1)) // lanes).reshape(-1)
    if lanes == 1:
        return {"lengths": lengths, "perm": None}
    nnz = int(crow[-1])
    row_of = torch.repeat_interleave(torch.arange(n, device=crow.device), rl)
    q = torch.arange(nnz, device=crow.device) - crow[:-1][row_of]
    seg_start = torch.cumsum(lengths, 0) - lengths
    dest = seg_start[row_of * lanes + q % lanes] + q // lanes
    perm = torch.empty(nnz, dtype=torch.int64, device=crow.device)
    perm[dest] = torch.arange(nnz, device=crow.device)
    return {"lengths": lengths, "perm": perm}


def csr_spmv_plain(mat, x):
    """The kernel's arithmetic in torch: the products vals * x[cols] in
    the matrix dtype, each (row, lane) segment summed first to last from 0
    (an ordered ``segment_reduce`` on an (N, 1) column, which sums in this
    order on the CPU and on the card), then the lanes added by the
    kernel's xor butterfly: lane l + off into lane l, off = L/2, ..., 1."""
    csr_spmv_plain.calls.add(mat.vals.dtype)
    n_rows, lanes = mat.shape[0], mat.lanes
    plan = mat.lane_plan()
    prod = mat.vals * x[mat.cols]
    if plan["perm"] is not None:
        prod = prod[plan["perm"]]
    part = torch.segment_reduce(prod.unsqueeze(1), "sum",
                                lengths=plan["lengths"], axis=0,
                                unsafe=True).view(n_rows, lanes)
    off = lanes // 2
    while off >= 1:
        part = part[:, :off] + part[:, off:2 * off]
        off //= 2
    return part[:, 0]


_INDEX_BITS = {torch.int32: 32, torch.int64: 64}


def csr_spmv(mat, x):
    """y = A x for a CsrMatrix (ops/csr.py) in f32 or f64 and a flat x of
    its column count and dtype: the fixed-order kernel on a CUDA tensor,
    its plain twin on a CPU one."""
    if x.device.type == "cpu":
        return csr_spmv_plain(mat, x)
    name = "csr_spmv"
    if x.device.type != "cuda" or mat.vals.device != x.device:
        raise ValueError(f"{name}: x on {x.device} and the matrix on "
                         f"{mat.vals.device} have no kernel")
    if mat.vals.dtype not in (torch.float32, torch.float64) \
            or x.dtype != mat.vals.dtype:
        raise TypeError(f"{name}: need f32 or f64 values and an x of "
                        f"their dtype, got {mat.vals.dtype} and {x.dtype}")
    bits = _INDEX_BITS.get(mat.cols.dtype)
    if bits is None or mat.crow.dtype != mat.cols.dtype:
        raise TypeError(f"{name}: crow and cols need one of int32, int64")
    if not (x.is_contiguous() and mat.vals.is_contiguous()
            and mat.cols.is_contiguous() and mat.crow.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    n_rows = mat.shape[0]
    y = torch.empty(n_rows, dtype=x.dtype, device=x.device)
    if n_rows == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = cuda_lib.load().prfdd_csr_spmv(
            _CODE[x.dtype], bits, mat.crow.data_ptr(), mat.cols.data_ptr(),
            mat.vals.data_ptr(), x.data_ptr(), y.data_ptr(), n_rows,
            mat.lanes, stream)
    _raise_on(err, name)
    csr_spmv.launches.add(x.dtype, (n_rows, mat.shape[1], mat.nnz,
                                    mat.lanes, bits))
    return y


stiffness_lattice_3d.launches = LaunchCount()
stiffness_lattice_3d_split.launches = LaunchCount()
lattice_face_sum_3d.launches = LaunchCount()
# the launches on (B, Mz, My, Mx) stacks among lattice_face_sum_3d's
lattice_face_sum_3d.batched_launches = LaunchCount()
csr_spmv.launches = LaunchCount()
stiffness_lattice_3d_plain.calls = LaunchCount()
stiffness_lattice_3d_split_plain.calls = LaunchCount()
lattice_face_sum_3d_plain.calls = LaunchCount()
csr_spmv_plain.calls = LaunchCount()
_COUNTS = {
    "stiffness_lattice_3d": stiffness_lattice_3d.launches,
    "stiffness_lattice_3d_split": stiffness_lattice_3d_split.launches,
    "lattice_face_sum_3d": lattice_face_sum_3d.launches,
    "lattice_face_sum_3d_batched": lattice_face_sum_3d.batched_launches,
    "stiffness_lattice_3d_plain": stiffness_lattice_3d_plain.calls,
    "stiffness_lattice_3d_split_plain": stiffness_lattice_3d_split_plain.calls,
    "lattice_face_sum_3d_plain": lattice_face_sum_3d_plain.calls,
    "csr_spmv": csr_spmv.launches,
    "csr_spmv_plain": csr_spmv_plain.calls,
}


def reset_counts() -> None:
    """Set every kernel's launch count and every plain twin's call count
    to 0."""
    for c in _COUNTS.values():
        c.reset()


def counts() -> dict:
    """{name: {dtype: count}} for the kernels and their plain twins."""
    return {k: dict(c.by_dtype) for k, c in _COUNTS.items()}


def take_signatures() -> dict:
    """{name: sorted signatures} of K1's, K2's and the SpMV's launches
    since the last call, and forget them. A K1 signature is (dtype, (Mz,
    My, Mx), n) of the launched lattice (a stack as its (P * Mz, My, Mx)
    view); a K2 one (dtype, shape, n, mask/weight dtype, has mask, has
    weight); an SpMV one (dtype, rows, cols, nnz, lanes, index bits)."""
    out = {}
    for name in ("stiffness_lattice_3d", "lattice_face_sum_3d", "csr_spmv"):
        c = _COUNTS[name]
        out[name] = sorted(c.signatures, key=repr)
        c.signatures.clear()
    return out
