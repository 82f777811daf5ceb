"""How far rounding alone moves a scale-up run's residual history.

    python -m polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies.rounding_spread \\
        [m] [--small M] [--seeds K] [--device DEV]

The run is the JAX package's f32-composite record of the scale-up script
(``artifacts/scaleup_32cubed_fgmres-z164i4_isfcg_ptf32.json``: FGMRES(4)
with a bf16 Z basis, an f32 composite with inner FCG(4)) through
``studies/scaleup.py`` at Kershaw m^3 N=7 (m = 32 by default) on
``device`` (None: the card). Beside it:

- the same solve of K right-hand sides that differ from f by at most one
  f32 unit in the last place an entry (a random sign per entry, seeds
  1..K): what an other summation order of f = A u* would give;
- the same run with an f32 Z basis (``fgmres``), i.e. without the bf16
  rounding of the flexible basis;
- the same run at Kershaw M^3 (``--small``, 8 by default) on the device
  and on the CPU, where the port's plain twins run.

It prints one JSON line: each run's iterations and r1..r3, each
perturbed run's r_k over the unperturbed run's, the record's, and the
small mesh's largest per-entry relative difference between the device
and the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import scaleup

__all__ = ["run", "main"]

FORM = dict(inner_iters=4, nv=4, inner_solver="fcg", ptype="f32",
            refine_mode="none")


def _summary(rec, base=None):
    h = rec["residual_history"]
    out = {"iterations": rec["iterations"], "r0_r3": h[:4],
           "max_error": rec["max_error"]}
    if base is not None:
        b = base["residual_history"]
        k = min(len(h), len(b))
        out["r_over_unperturbed"] = [h[i] / b[i] for i in range(1, k)]
    return out


def run(m: int = 32, small: int = 8, seeds: int = 3, device=None) -> dict:
    setup = scaleup.build_setup(m, device=device)
    perturbed = []

    def one_ulp(dom, solve, f, _precond):
        for seed in range(1, seeds + 1):
            gen = torch.Generator(device=f.device).manual_seed(seed)
            sign = (2 * torch.randint(0, 2, f.shape, generator=gen,
                                      device=f.device) - 1).double()
            res = solve((f.double() * (1 + 2.0 ** -23 * sign)).to(f.dtype))
            hist = res.residual_history.double().cpu().numpy()
            perturbed.append({"iterations": int(res.iterations),
                              "residual_history":
                                  hist[np.isfinite(hist)].tolist(),
                              "max_error": None})

    base = scaleup.run(m, method="fgmres-z16", **FORM, setup=setup,
                       after_solve=one_ulp)
    f32z = scaleup.run(m, method="fgmres", **FORM, setup=setup)
    del setup
    at_small = [scaleup.run(small, method="fgmres-z16", **FORM, device=d)
                for d in (device, "cpu")]
    a, b = (np.asarray(r["residual_history"]) for r in at_small)
    k = min(len(a), len(b))
    return {
        "mesh": base["mesh"], "solver": base["solver"],
        "device": base["device"],
        "run": _summary(base),
        "one_ulp_rhs": [_summary(p, base) for p in perturbed],
        "f32_z_basis": _summary(f32z, base),
        "small": {"m": small,
                  "iterations": [r["iterations"] for r in at_small],
                  "max_rel_diff_device_vs_cpu":
                      float(np.abs(a[:k] / b[:k] - 1).max())},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("m", type=int, nargs="?", default=32)
    p.add_argument("--small", type=int, default=8)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    print(json.dumps(run(a.m, a.small, a.seeds, a.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
