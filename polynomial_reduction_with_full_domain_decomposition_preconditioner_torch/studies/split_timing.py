"""Device times of K3 (``stiffness_lattice_3d_split``) and K1
(``stiffness_lattice_3d``) on the precision study's inputs: n = 8, bf16
and f32, at 128^3 and 512^3, warm (``utils/timing.cuda_ms``) and L2-cold
(``cuda_cold_ms``). Prints one JSON line with the card's name and power
limit.

The imports are absolute, so the script times whichever checkout of the
port is first on ``sys.path``; two versions of the kernels compare within
one call to the card as

    PYTHONPATH=<checkout A> python <this file>
    PYTHONPATH=<checkout B> python <this file>      (and B, A again)
"""

from __future__ import annotations

import json
import sys

import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies.stiffness_precision import make_inputs
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.utils.timing import card, cuda_cold_ms, cuda_ms

N = 8


def run(sizes=(128, 512)) -> dict:
    """{"card": ..., "k3": {...}, "k1": {...}} with one entry per
    "<dtype> <m>^3 warm|cold" in ms."""
    if not torch.cuda.is_available():
        raise RuntimeError("split_timing times kernels: it needs a card")
    out = {"card": card(), "k3": {}, "k1": {}}
    for m in sizes:
        iters = 20 if m <= 128 else 5
        for dtype in (torch.bfloat16, torch.float32):
            U, G = make_inputs(m, dtype, torch.device("cuda"))
            name = str(dtype).replace("torch.", "")
            for key, fn in (("k3", kernels.stiffness_lattice_3d_split),
                            ("k1", kernels.stiffness_lattice_3d)):
                call = lambda: fn(U, G, N)
                out[key][f"{name} {m}^3 warm"] = cuda_ms(call, iters)
                out[key][f"{name} {m}^3 cold"] = cuda_cold_ms(call, iters)
            del U, G
    return out


def main() -> int:
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
