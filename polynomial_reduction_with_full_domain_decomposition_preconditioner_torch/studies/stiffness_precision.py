"""Precision study of the fused stiffness apply: f32 FMAs against bf16
tensor-core passes.

Port of ``artifacts/bench_stiffness_precision.py`` (its ``main``). K1
(``ops/kernels.stiffness_lattice_3d``) contracts with f32 FMAs; K3
(``stiffness_lattice_3d_split``) runs the x- and y-contractions as bf16
tensor-core passes on split operands x = hi + lo:

- f32 I/O ("split3"): U.D = U_hi.D_hi + U_hi.D_lo + U_lo.D_hi, 3 passes
  for each of the four contractions;
- bf16 I/O ("split2"): U is exactly bf16, so U.D_hi + U.D_lo is exact up
  to f32 accumulation (2 passes); the f32 W intermediates take 3.

For bf16 and f32 at (m, m, m), n = 8, the study applies both kernels to
the same seeded inputs and reports, per kernel: milliseconds by CUDA
events, GB/s counted as 8 lattices of the I/O type moved once, the
largest deviation from K1's result and from an f64 oracle (K1's plain
twin in f64 on the same inputs), each relative to the reference's
largest magnitude.

Usage: python -m polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies.stiffness_precision [m]
"""

from __future__ import annotations

import sys

import torch

from .. import resolve_device
from ..ops import kernels
from ..utils.timing import cuda_ms

__all__ = ["make_inputs", "run"]

N = 8
_ORACLE_SLAB = 64   # z-planes per oracle piece (the apply is element-local)


def make_inputs(m: int, dtype, device):
    """The study's seeded inputs: U and the six factor lattices, standard
    normal in f32, rounded to ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    draw = lambda: torch.randn((m, m, m), generator=gen, device=device,
                               dtype=torch.float32).to(dtype)
    return draw(), tuple(draw() for _ in range(6))


def _rel_err_vs_oracle(outs, U, G):
    """max|out - oracle| / max|oracle| for each of ``outs``, the oracle
    being K1's plain twin in f64, evaluated slab by slab along z."""
    errs = [0.0] * len(outs)
    scale = 0.0
    for z0 in range(0, U.shape[0], _ORACLE_SLAB):
        sl = slice(z0, z0 + _ORACLE_SLAB)
        ref = kernels.stiffness_lattice_3d_plain(
            U[sl].double(), [g[sl].double() for g in G], N)
        scale = max(scale, ref.abs().max().item())
        for i, out in enumerate(outs):
            errs[i] = max(errs[i], (out[sl].double() - ref).abs().max().item())
    return [e / scale for e in errs]


def run(m: int = 512, device=None):
    """Rows of the study at (m, m, m), one per (dtype, kernel), printed as
    they come. On a card both kernels are timed; on the CPU
    (``device="cpu"``) the plain twins compute the error columns and the
    time columns are None."""
    if m % N:
        raise ValueError(f"m={m} must be a multiple of n={N}")
    device = resolve_device(device)
    on_card = device.type == "cuda"
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        U, G = make_inputs(m, dtype, device)
        label = "split2(2p+3p)" if dtype == torch.bfloat16 else "split3(3p)"
        cases = [("K1 f32-fma", kernels.stiffness_lattice_3d),
                 (f"K3 {label}", kernels.stiffness_lattice_3d_split)]
        outs = [fn(U, G, N) for _, fn in cases]
        ref = outs[0].float()
        scale = ref.abs().max().item()
        vs_k1 = [0.0, (outs[1].float() - ref).abs().max().item() / scale]
        del ref
        vs_f64 = _rel_err_vs_oracle(outs, U, G)
        nbytes = 8 * U.numel() * U.element_size()
        for (name, fn), e1, e64 in zip(cases, vs_k1, vs_f64):
            ms = cuda_ms(lambda: fn(U, G, N), 10) if on_card else None
            row = {"dtype": str(dtype).replace("torch.", ""),
                   "shape": (m, m, m), "kernel": name, "ms": ms,
                   "gb_per_s": None if ms is None else nbytes / ms / 1e6,
                   "rel_err_vs_k1": e1, "rel_err_vs_f64": e64}
            rows.append(row)
            timing = ("time not measured (CPU)" if ms is None else
                      f"{ms:.4f} ms  {row['gb_per_s']:.0f} GB/s")
            print(f"{row['dtype']} {row['shape']} {name}: {timing}  "
                  f"rel_err_vs_k1={e1:.2e}  rel_err_vs_f64={e64:.2e}",
                  flush=True)
        del U, G, outs
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else 512)
    return 0


if __name__ == "__main__":
    sys.exit(main())
