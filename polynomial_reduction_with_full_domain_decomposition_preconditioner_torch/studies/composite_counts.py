"""The main-path composite over P shards in the port: outer iterations
and residuals, the twin of ``reference/jax_composite.py main`` (which runs
the JAX package).

    python -m polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies.composite_counts SHAPE P [PTYPE] [MAXIT] [DEVICE]

Kershaw eps=0.3 on SHAPE elements (e.g. 4,4,16) at N=7 over P slab
shards (one process), f32 FGMRES(20) to 1e-4 with composite_dd(
poly_reduction=6, inner="amg", ptype=PTYPE) (float32 or bfloat16,
default float32), u* = initial_function(4, seed=0), at most MAXIT outer
iterations (default 200), on DEVICE (default cuda; cpu runs the plain
twins). Prints one JSON line.
"""

from __future__ import annotations

import json
import sys
import time
from functools import partial

import torch

from ..mesh.generator import kershaw_mesh
from ..mesh.partition import partition_mesh
from ..solvers.domain import Domain
from ..solvers.subdomain import composite_dd


def run(shape, shards: int, ptype=torch.float32, max_iterations: int = 200,
        device="cuda") -> dict:
    t0 = time.time()
    mk = partial(kershaw_mesh, tuple(shape), epsilon=0.3, device=device)
    mesh = mk(7)
    dom = Domain(partition_mesh(mesh, shards), dtype=torch.float32,
                 device=device)
    u = dom.initial_function(4, seed=0)
    f = dom.manufacture_rhs(u)
    pre = composite_dd(dom, mk, poly_reduction=6, inner="amg", ptype=ptype,
                       fine_mesh=mesh)
    t1 = time.time()
    res = dom.solver(method="fgmres", max_iterations=max_iterations,
                     precond=pre)(f)
    hist = res.residual_history.cpu().double()
    hist = hist[torch.isfinite(hist)]
    return {"shape": list(shape), "shards": shards,
            "ptype": str(ptype).replace("torch.", ""),
            "iterations": res.iterations, "converged": bool(res.converged),
            "residuals": [float(x) for x in hist[:6]],
            "last_residual": float(hist[-1]),
            "max_error": (res.u - u).abs().max().item(),
            "setup_s": t1 - t0, "solve_s": time.time() - t1}


if __name__ == "__main__":
    a = sys.argv[1:]
    print(json.dumps(run(
        [int(x) for x in a[0].split(",")], int(a[1]),
        getattr(torch, a[2]) if len(a) > 2 else torch.float32,
        int(a[3]) if len(a) > 3 else 200,
        a[4] if len(a) > 4 else "cuda")), flush=True)
