"""How far two timings of the same solve part within one run on the card.

The main path's configuration (Kershaw eps=0.3 16^3 N=7, f32 FGMRES(20),
composite_dd(poly_reduction=6, inner="amg", ptype=bfloat16)). Each of
``rounds`` rounds prints one JSON line: the solve's milliseconds an outer
iteration, the best and every one of ``runs`` runs, by CUDA events and by
the CUDA-synchronized host clock, converged (to 1e-4, as the main path)
and at 10 outer iterations with tolerance 1e-30 (phase_report's solves);
then ``runtime/phases.phase_report``'s marginals on the same Domain and
the converged solve's best again just after the report. The card's name
and power limit are on every line. Run from the repo root:

    python -m polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies.solve_timing_spread [rounds]
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
from functools import partial

import torch

from ..mesh.generator import kershaw_mesh
from ..mesh.partition import partition_mesh
from ..ops import cuda_lib
from ..runtime.config import Config
from ..runtime.phases import phase_report
from ..solvers.domain import Domain
from ..solvers.subdomain import composite_dd


def _events(solve, f, runs):
    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        res = solve(f)
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / 1e3)
    return out, res.iterations


def _host(solve, f, runs):
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(f)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out, res.iterations


def _ms(seconds, iterations):
    ms = [1e3 * s / iterations for s in seconds]
    return {"iterations": iterations, "best": min(ms), "all": ms}


def run(rounds: int = 2, runs: int = 5) -> list:
    cuda_lib.build()
    cuda_lib.load()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    meshes = {}

    def mk(order):
        if order not in meshes:
            meshes[order] = kershaw_mesh((16, 16, 16), order, epsilon=0.3,
                                         device=dev)
        return meshes[order]

    dom = Domain(partition_mesh(mk(7), 1), dtype=torch.float32, device=dev)
    pre = composite_dd(dom, mk, poly_reduction=6, inner="amg",
                       ptype=torch.bfloat16, fine_mesh=mk(7))
    f = dom.manufacture_rhs(dom.initial_function(4, seed=0))
    solves = {"converged": dom.solver(method="fgmres", max_iterations=200,
                                      precond=pre),
              "10 at 1e-30": dom.solver(method="fgmres", max_iterations=10,
                                        tolerance=1e-30, precond=pre)}
    for solve in solves.values():
        solve(f)
    cfg = Config(poly_reduction=6, ptype="bfloat16")
    lines = []
    for r in range(rounds):
        line = {"round": r, "card": card}
        for name, solve in solves.items():
            line[f"{name}, events"] = _ms(*_events(solve, f, runs))
            line[f"{name}, host"] = _ms(*_host(solve, f, runs))
        rep = phase_report(dom, mk, cfg=cfg, iterations=10, out=io.StringIO())
        line["phase_report_ms"] = {k: 1e3 * v for k, v in rep.items()
                                   if not k.startswith("region.")}
        line["converged, events, after the report"] = _ms(
            *_events(solves["converged"], f, 3))
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
