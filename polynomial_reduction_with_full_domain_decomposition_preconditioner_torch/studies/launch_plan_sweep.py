"""Sweep of the launch plans of K1, K2 and K3: what the rules of
``ops/kernels._stiffness_plan``, ``_face_sum_plan`` and ``_split_plan``
were chosen from.

For K1 (``stiffness_lattice_3d``) every block of ey x ez elements in y
and z that the kernel takes, for K2 (``lattice_face_sum_3d``, mask only)
every vector width and every number of rows a block, on the main path's
lattice, the p-multigrid level lattices, a lattice between one and two
blocks per SM (96^3 at n = 8) and one with an odd row pitch; bf16, f32
and f64. For K3 (``stiffness_lattice_3d_split``, bf16 and f32) at 128^3
and 512^3, n = 8, every number of tiles a block and of stages that fits
in shared memory, each with the blocks an SM holds by the card's own
count (``kernels.split_blocks_per_sm``, printed beside the plan's model
of it) and by 1 and 2; at 128^3 also L2-cold (``utils/timing.cuda_cold_ms``). Each launch is forced through the wrapper, checked against the
plan's own result, and timed warm on the card by ``utils/timing.cuda_ms``.
One JSON line per launch; ``"chosen": true`` marks the plan the wrapper
picks by itself.

Usage: python -m polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies.launch_plan_sweep [k1] [k2] [k3]
(no argument: all three)
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops import kernels
from ..utils.timing import cuda_cold_ms, cuda_ms

__all__ = ["run"]

K1_LATTICES = [((128, 128, 128), 8), ((96, 96, 96), 8), ((96, 96, 96), 6),
               ((64, 64, 64), 4), ((32, 32, 32), 2)]
K2_LATTICES = K1_LATTICES + [((21, 14, 35), 7)]
K3_LATTICES = [((128, 128, 128), 8), ((512, 512, 512), 8)]
DTYPES = (torch.bfloat16, torch.float32, torch.float64)
POWERS = (1, 2, 4, 8, 16)


def _name(dtype):
    return str(dtype).replace("torch.", "")


def _forced(attr, plan, fn):
    """``fn()`` with the wrapper's plan function ``attr`` answering
    ``plan`` whatever it is asked."""
    saved = getattr(kernels, attr)
    setattr(kernels, attr, lambda *args: plan)
    try:
        return fn()
    finally:
        setattr(kernels, attr, saved)


def _sweep_k1(gen, emit):
    for shape, n in K1_LATTICES:
        U64 = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float64)
        G64 = [torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float64) for _ in range(6)]
        for dtype in DTYPES:
            U, G = U64.to(dtype), [g.to(dtype) for g in G64]
            isz = U.element_size()
            chosen = kernels._stiffness_plan(shape, n, isz)
            ref = kernels.stiffness_lattice_3d(U, G, n)
            for ey in POWERS:
                for ez in POWERS[:4]:
                    plan = kernels._stiffness_launch(shape, n, isz, ey, ez)
                    if (plan.threads > 256 or ey > shape[1] // n
                            or (shape[0] // n) % ez):
                        continue
                    call = lambda: kernels.stiffness_lattice_3d(U, G, n)
                    out = _forced("_stiffness_plan", plan, call)
                    # a block's arithmetic does not depend on the plan
                    same = bool((out == ref).all())
                    ms = _forced("_stiffness_plan", plan,
                                 lambda: cuda_ms(call, 20))
                    emit({"kernel": "stiffness_lattice_3d", "shape": shape,
                          "n": n, "dtype": _name(dtype), "ey": ey, "ez": ez,
                          "threads": plan.threads, "grid": plan.grid,
                          "ms": ms, "same_result": same,
                          "chosen": plan == chosen})
                    if not same:
                        raise AssertionError(f"K1 under {plan} differs")


def _sweep_k2(gen, emit):
    for shape, n in K2_LATTICES:
        U64 = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float64)
        mask64 = (torch.randn(shape, generator=gen, device="cuda") > 0).double()
        for dtype, mw_dtype in [(torch.bfloat16, torch.bfloat16),
                                (torch.float32, torch.bfloat16),
                                (torch.float64, torch.float64)]:
            U, mask = U64.to(dtype), mask64.to(mw_dtype)
            isz = U.element_size()
            ref = kernels.lattice_face_sum_3d(U, n, mask=mask)
            chosen = kernels._face_sum_plan(
                shape, n, isz, mask.element_size(),
                (U.data_ptr(), ref.data_ptr()), (mask.data_ptr(),))
            for vec in POWERS[:4]:
                for by in POWERS:
                    if vec * isz > 16 or shape[2] % vec or by > shape[1]:
                        continue
                    plan = kernels._face_sum_launch(shape, vec, by)
                    if plan.threads > 256:
                        continue
                    call = lambda: kernels.lattice_face_sum_3d(U, n, mask=mask)
                    out = _forced("_face_sum_plan", plan, call)
                    same = bool((out == ref).all())
                    ms = _forced("_face_sum_plan", plan,
                                 lambda: cuda_ms(call, 50))
                    emit({"kernel": "lattice_face_sum_3d", "shape": shape,
                          "n": n, "dtype": _name(dtype), "vec": vec, "by": by,
                          "threads": plan.threads, "grid": plan.grid,
                          "ms": ms, "same_result": same,
                          "chosen": plan == chosen})
                    if not same:
                        raise AssertionError(f"K2 under {plan} differs")


def _time_split(emit, U, G, n, ref, plan, chosen, card, model, iters):
    """One forced K3 launch: same result as the chosen plan's, timed warm
    and, where the operands fit in the L2, cold too."""
    call = lambda: kernels.stiffness_lattice_3d_split(U, G, n)
    out = _forced("_split_plan", plan, call)
    # a tile's arithmetic does not depend on the plan
    same = bool((out == ref).all())
    ms = _forced("_split_plan", plan, lambda: cuda_ms(call, iters))
    cold = (_forced("_split_plan", plan, lambda: cuda_cold_ms(call, iters))
            if U.shape[0] <= 128 else None)
    emit({"kernel": "stiffness_lattice_3d_split", "shape": tuple(U.shape),
          "n": n, "dtype": _name(U.dtype), "vec": plan.vec, "tx": plan.tx,
          "stages": plan.stages, "blocks": plan.blocks,
          "per_sm": -(-plan.blocks // 132), "card_per_sm": card,
          "model_per_sm": model,
          "smem_bytes": plan.smem_bytes, "ms": ms, "cold_ms": cold,
          "same_result": same, "chosen": plan == chosen})
    if not same:
        raise AssertionError(f"K3 under {plan} differs")


def _sweep_k3(gen, emit):
    for shape, n in K3_LATTICES:
        for dtype in (torch.bfloat16, torch.float32):
            # drawn in the I/O dtype: 512^3 in f64 would not fit beside it
            U = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            G = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for _ in range(6)]
            isz = U.element_size()
            ref = kernels.stiffness_lattice_3d_split(U, G, n)
            chosen = kernels._split_plan(shape, n, isz,
                                         [t.data_ptr() for t in (U, *G, ref)])
            iters = 20 if shape[0] <= 128 else 3
            for tx in POWERS[:4]:
                for stages in (2, 3):
                    base = kernels._split_launch(shape, isz, chosen.vec, tx, stages)
                    if base.smem_bytes > kernels.MAX_SHARED_BLOCK:
                        continue
                    card = kernels.split_blocks_per_sm(dtype, base)
                    model = kernels._split_resident(isz, tx, stages)
                    # the blocks an SM runs are capped at what it holds
                    plans = {kernels._split_launch(shape, isz, chosen.vec, tx,
                                                   stages, per_sm)
                             for per_sm in (1, 2, card)}
                    for plan in sorted(plans, key=lambda p: p.blocks):
                        _time_split(emit, U, G, n, ref, plan, chosen, card,
                                    model, iters)
            del U, G, ref


SWEEPS = {"k1": _sweep_k1, "k2": _sweep_k2, "k3": _sweep_k3}


def run(which=tuple(SWEEPS)):
    """Every row of the sweeps named in ``which`` ("k1", "k2", "k3"), on
    the current CUDA device, printed as it comes."""
    if not torch.cuda.is_available():
        raise RuntimeError("the launch-plan sweep times kernels: it needs a card")
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for name in which:
        SWEEPS[name](gen, emit)
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(tuple(argv) or tuple(SWEEPS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
