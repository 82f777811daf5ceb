"""The main path's solve on the card, measured for whichever checkout of
the port is first on ``sys.path``: Kershaw eps=0.3 16^3 N=7, f32
FGMRES(20) to 1e-4 with composite_dd(poly_reduction=6, inner="amg",
ptype=bfloat16). Prints one JSON line: iterations and residuals, the
solve seconds of ``solves`` runs (CUDA-synchronized host clock, after two
warm-up solves), K1 and K2 launches an outer iteration, the device
activities of one profiled solve, the host milliseconds of ``applies``
preconditioner applications alone and their top host ops, f64 refinement
to 1e-10, and the card's name and power limit. Two versions compare
within one call to the card as

    PYTHONPATH=<checkout A> python <this file> A
    PYTHONPATH=<checkout B> python <this file> B      (and B, A again)

With ``spmd`` after the tag it measures the same configuration over
P = 8 slab shards (ptype bfloat16, 20 outer steps) and P = 5 (ptype
float32, to 1e-4 in at most 200), as ``chip_smoke.py``'s composite-spmd
phase runs them, where the composite's inner solve is the rank-local
batched FGMRES: one JSON line a shard count with the same measures and
the ``cudaLaunchKernel`` calls of one preconditioner application.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from functools import partial

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.generator import kershaw_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import cuda_lib, kernels
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.refine import refine_solve
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.subdomain import composite_dd


def _seconds(fn, n):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return sorted(out)


def run(tag: str, solves: int = 5, applies: int = 20) -> dict:
    cuda_lib.build()
    cuda_lib.load()
    dev = torch.device("cuda")
    mk = partial(kershaw_mesh, (16, 16, 16), epsilon=0.3, device=dev)
    mesh = mk(7)
    sd = partition_mesh(mesh, 1)
    dom = Domain(sd, dtype=torch.float32, device=dev)
    pre = composite_dd(dom, mk, poly_reduction=6, inner="amg",
                       ptype=torch.bfloat16, fine_mesh=mesh)
    u = dom.initial_function(4, seed=0)
    f = dom.manufacture_rhs(u)
    solve = dom.solver(method="fgmres", max_iterations=200, precond=pre)
    for _ in range(2):
        solve(f)
    kernels.reset_counts()
    res = solve(f)
    counts = kernels.counts()
    its = res.iterations
    hist = res.residual_history.cpu()
    hist = hist[torch.isfinite(hist)]
    solve_s = _seconds(lambda: solve(f), solves)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve(f)
        torch.cuda.synchronize()
    activities = sum(1 for e in prof.events()
                     if e.device_type == DeviceType.CUDA)

    fn = pre.build(dom.arrays, pre.extra, dom._ops())
    apply_s = _seconds(lambda: fn(f), applies)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            fn(f)
        torch.cuda.synchronize()
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)

    dom64 = Domain(sd, dtype=torch.float64, device=dev)
    u64 = dom64.to_device_field(dom.from_device_field(u))
    rr = refine_solve(dom64, solve, dom64.manufacture_rhs(u64),
                      tolerance=1e-10)
    return {
        "tag": tag, "card": _card(), "iterations": its,
        "residuals": [float(x) for x in hist[:6]],
        "solve_seconds": solve_s,
        "k1_per_iteration": sum(counts["stiffness_lattice_3d"].values()) / its,
        "k2_per_iteration": sum(counts["lattice_face_sum_3d"].values()) / its,
        "device_activities_per_iteration": activities / its,
        "precond_apply_ms": [1e3 * t for t in apply_s],
        "top_host_ms_per_apply": [(e.key[:40], e.count // 5,
                                   e.self_cpu_time_total / 5e3)
                                  for e in top[:8]],
        "refine_cycles": rr.cycles, "refine_rel_residual": rr.rel_residual,
    }


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def run_spmd(tag: str, solves: int = 3) -> list:
    cuda_lib.build()
    cuda_lib.load()
    dev = torch.device("cuda")
    mk = partial(kershaw_mesh, (16, 16, 16), epsilon=0.3, device=dev)
    mesh = mk(7)
    out = []
    for P, ptype, maxit in ((8, torch.bfloat16, 20),
                            (5, torch.float32, 200)):
        dom = Domain(partition_mesh(mesh, P), dtype=torch.float32,
                     device=dev)
        pre = composite_dd(dom, mk, poly_reduction=6, inner="amg",
                           ptype=ptype, fine_mesh=mesh)
        u = dom.initial_function(4, seed=0)
        f = dom.manufacture_rhs(u)
        solve = dom.solver(method="fgmres", max_iterations=maxit,
                           precond=pre)
        solve(f)
        kernels.reset_counts()
        res = solve(f)
        counts = kernels.counts()
        its = res.iterations
        hist = res.residual_history.cpu()
        hist = hist[torch.isfinite(hist)]
        solve_s = _seconds(lambda: solve(f), solves)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            solve(f)
            torch.cuda.synchronize()
        activities = sum(1 for e in prof.events()
                         if e.device_type == DeviceType.CUDA)
        fn = pre.build(dom.arrays, pre.extra, dom._ops())
        fn(f)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                fn(f)
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if e.key == "cudaLaunchKernel") / 3
        out.append({
            "tag": tag, "card": _card(), "shards": P,
            "ptype": str(ptype).replace("torch.", ""),
            "iterations": its, "converged": bool(res.converged),
            "residuals": [float(x) for x in hist[:6]],
            "last_residual": float(hist[-1]), "solve_seconds": solve_s,
            "k1_per_iteration":
                sum(counts["stiffness_lattice_3d"].values()) / its,
            "k2_per_iteration":
                sum(counts["lattice_face_sum_3d"].values()) / its,
            "device_activities_per_iteration": activities / its,
            "cuda_launch_kernel_per_apply": launches})
        del pre, solve, res, fn, dom
    return out


if __name__ == "__main__":
    tag = sys.argv[1] if len(sys.argv) > 1 else "run"
    if len(sys.argv) > 2 and sys.argv[2] == "spmd":
        for line in run_spmd(tag):
            print(json.dumps(line), flush=True)
    else:
        print(json.dumps(run(tag)), flush=True)
