"""The strong-scaling ablation: which composite ingredient loses quality
as the slabs shrink. Port of the JAX package's
``artifacts/run_strong_scaling_ablate.py``.

    python -m polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies.strong_scaling_ablate \\
        [--device DEV] [--out PATH]

Kershaw eps=0.3 on (4, 4, 16) elements at N=3 over P = 1, 2, 4 and 8
slab shards, in f64: for each knob set of ``CONFIGS`` (the script's),
``composite_dd(poly_reduction=2, inner="amg", **knobs)`` under f64
FGMRES(20), at most 100 iterations, to 1e-8 of r0, u* =
initial_function(4, seed 0). "iterations" counts the finite entries of
the residual history, as the script counts them (r0 included). A knob
set the composite rejects at some P (its build raises ``ValueError``,
e.g. rings deeper than a slab) is recorded as ``{"error": ...}``, as the
script records it; nothing else is caught. It runs on the card unless
``--device`` names another device, prints the record (the script's
layout: mesh, points, configs.<tag>.knobs / per_P) as one JSON line and
writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import sys
from functools import partial

import torch

from .. import resolve_device

__all__ = ["CONFIGS", "SHAPE", "SHARDS", "build_one", "main", "run",
           "solve_one"]

CONFIGS = {
    "base":  {},
    "v2":    {"subdomain_overlap": 2},
    "w2":    {"superdomain_overlap": 2},
    "i8":    {"num_iterations": 8},
    "nofar": {"far_coarsen": 1},
    "vx2":   {"vertex_iters": 2},
}
SHAPE, ORDER, POLY_REDUCTION = (4, 4, 16), 3, 2
SHARDS = (1, 2, 4, 8)
MAX_ITERATIONS = 100
TOLERANCE = 1e-8


def build_one(mesh, mk, shards: int, knobs: dict, device):
    """One point's setup: the f64 Domain over ``shards`` slabs, f = A u*
    and the composite with ``knobs``; raises the composite build's
    ``ValueError`` where the knobs do not fit the partition."""
    from ..mesh.partition import partition_mesh
    from ..solvers.domain import Domain
    from ..solvers.subdomain import composite_dd

    dom = Domain(partition_mesh(mesh, shards), dtype=torch.float64,
                 device=device)
    f = dom.manufacture_rhs(dom.initial_function(4, seed=0))
    pre = composite_dd(dom, mk, poly_reduction=POLY_REDUCTION, inner="amg",
                       fine_mesh=mesh, **knobs)
    return dom, f, pre


def _solve(dom, f, pre):
    return dom.solver(method="fgmres", max_iterations=MAX_ITERATIONS,
                      tolerance=TOLERANCE, precond=pre)(f)


def solve_one(mesh, mk, shards: int, knobs: dict, device):
    """One point of the sweep (``build_one``, then the FGMRES solve);
    returns the solve's result."""
    return _solve(*build_one(mesh, mk, shards, knobs, device))


def run(configs=None, shards=SHARDS, *, device=None,
        out=sys.stderr) -> dict:
    """The sweep over ``configs`` (tag -> knobs; None: ``CONFIGS``) and
    ``shards`` on ``device`` (None: the card); returns the script's
    record."""
    from ..mesh.generator import kershaw_mesh

    device = resolve_device(device)
    configs = CONFIGS if configs is None else configs
    mk = partial(kershaw_mesh, SHAPE, epsilon=0.3, device=device)
    mesh = mk(ORDER)
    rec = {"mesh": f"kershaw eps=0.3 {SHAPE} N={ORDER} r={POLY_REDUCTION}",
           "points": mesh.num_points, "configs": {}}
    for tag, kw in configs.items():
        per_P = {}
        for P in shards:
            try:
                point = build_one(mesh, mk, P, kw, device)
            except ValueError as e:    # a knob the composite rejects here
                per_P[str(P)] = {"error": str(e)}
                print(f"{tag} P={P}: ERROR {e}", file=out)
                continue
            res = _solve(*point)
            k = int(torch.isfinite(res.residual_history).sum())
            per_P[str(P)] = {"iterations": k,
                             "converged": bool(res.converged)}
            print(f"{tag} P={P}: {k} iterations", file=out)
        rec["configs"][tag] = {"knobs": kw, "per_P": per_P}
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m polynomial_reduction_with_full_domain_decomposition_"
             "preconditioner_torch.studies.strong_scaling_ablate",
        description="The strong-scaling ablation of the composite's knobs.")
    p.add_argument("--device", default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(sys.argv[1:] if argv is None else argv)
    rec = run(device=a.device)
    line = json.dumps(rec)
    print(line, flush=True)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
