#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):
  env      torch/CUDA versions, the card, and nvidia-smi's name and power
           limit (also printed raw on a line of its own)
  build    nvcc build of csrc/*.cu for sm_90a (seconds)
  kernels  every kernel against its plain PyTorch twin on the card, in
           bf16, f32 and f64, with the stated tolerances
  small    a Kershaw 4^3 N=3 composite-DD solve on the card vs the same
           solve on the CPU (plain twins): same iterations and history
  solve    the main path: Kershaw eps=0.3, 16^3 elements, N=7 (2,097,152
           points), f32 FGMRES(20) to 1e-4 preconditioned by
           composite_dd(poly_reduction=6, inner="amg", ptype=bfloat16);
           best of 3 timed with CUDA events, launch counts of one solve
  profile  one more solve under torch.profiler: the union of device
           activity over the solve's wall time, and the top kernels
  refine   f64 iterative refinement of that solve to 1e-10
Then one {"kernels": [...]} line (each kernel variant of the main path:
its launches there, error, time, plain time and bound) and, last, the
{"ok": true, "device": {...}} line.
"""

import json
import subprocess
import sys
import time
from functools import partial

PKG = "polynomial_reduction_with_full_domain_decomposition_preconditioner_torch"
TPU_KERNELS = ("polynomial_reduction_with_full_domain_decomposition_"
               "preconditioner_tpu/ops/pallas_kernels.py")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 67e12,   # f32 non-tensor (bf16
              "float64": 34e12}                      # I/O computes in f32)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters):
    """Mean milliseconds of fn() over ``iters`` calls, by CUDA events,
    after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def check_kernels(torch, kernels, dev):
    """Each kernel vs its plain twin on the card; returns the timed
    main-path variants keyed by (kernel, dtype)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rand = lambda shape: torch.randn(shape, generator=gen, device=dev,
                                     dtype=torch.float64)
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}
    timed = {}
    for shape, n in [((128, 128, 128), 8), ((48, 40, 56), 8),
                     ((12, 10, 14), 2)]:
        U64, G64 = rand(shape), [rand(shape) for _ in range(6)]
        for name, dt in dts.items():
            U, G = U64.to(dt), [g.to(dt) for g in G64]
            out = kernels.stiffness_lattice_3d(U, G, n)
            ref = kernels.stiffness_lattice_3d_plain(U, G, n)
            torch.cuda.synchronize()
            scale = ref.double().abs().max().item()
            err = (out.double() - ref.double()).abs().max().item()
            line = {"phase": "kernels", "kernel": "stiffness_lattice_3d",
                    "shape": shape, "n": n, "dtype": name,
                    "max_abs_err": err, "rel_err": err / scale}
            tol = {"float32": 2e-6, "float64": 1e-12, "bfloat16": 1e-2}[name]
            ok = err <= tol * scale
            if name == "bfloat16":
                oracle = kernels.stiffness_lattice_3d_plain(
                    U.double(), [g.double() for g in G], n)
                e64 = (out.double() - oracle).abs().max().item()
                line["rel_err_vs_f64"] = e64 / oracle.abs().max().item()
                ok = ok and e64 <= 0.05 * oracle.abs().max().item()
            line["ok"] = ok
            emit(line)
            if not ok:
                raise AssertionError(f"stiffness_lattice_3d disagrees: {line}")
            if shape == (128, 128, 128):
                npts = U.numel()
                timed[("stiffness_lattice_3d", name)] = {
                    "max_abs_err": err,
                    "ms": cuda_ms(lambda: kernels.stiffness_lattice_3d(U, G, n), 20),
                    "plain_ms": cuda_ms(
                        lambda: kernels.stiffness_lattice_3d_plain(U, G, n), 3),
                    "bytes": 8 * npts * U.element_size(),
                    "flops": npts * (12 * n + 18),
                }
    for shape, n in [((128, 128, 128), 8), ((24, 16, 40), 8)]:
        U64 = rand(shape)
        mask64 = (rand(shape) > 0).double()
        w64 = 1.0 / 2.0 ** torch.randint(0, 4, shape, generator=gen,
                                         device=dev).double()
        # the main path's dtype pairs: the f32 Domain keeps a bf16 mask
        # and weight, the bf16 composite a bf16 mask, the f64 Domain f64
        for name, mwdt in [("float32", torch.bfloat16),
                           ("bfloat16", torch.bfloat16),
                           ("float64", torch.float64)]:
            U = U64.to(dts[name])
            mask, w = mask64.to(mwdt), w64.to(mwdt)
            for kw in ({}, {"mask": mask, "weight": w}, {"mask": mask}):
                out = kernels.lattice_face_sum_3d(U, n, **kw)
                ref = kernels.lattice_face_sum_3d_plain(U, n, **kw)
                torch.cuda.synchronize()
                diff = (out.double() - ref.double()).abs()
                err = diff.max().item()
                if name == "bfloat16":
                    rel = (diff / ref.double().abs().clamp(min=1.0)).max().item()
                    ok = rel <= 0.02
                else:
                    rel = err
                    ok = err == 0.0
                line = {"phase": "kernels", "kernel": "lattice_face_sum_3d",
                        "shape": shape, "n": n, "dtype": name,
                        "mask_weight": sorted(kw), "max_abs_err": err,
                        "rel_err": rel, "ok": ok}
                emit(line)
                if not ok:
                    raise AssertionError(f"lattice_face_sum_3d disagrees: {line}")
                if shape == (128, 128, 128) and set(kw) == {"mask"}:
                    npts = U.numel()
                    timed[("lattice_face_sum_3d", name)] = {
                        "max_abs_err": err,
                        "ms": cuda_ms(lambda: kernels.lattice_face_sum_3d(U, n, **kw), 50),
                        "plain_ms": cuda_ms(
                            lambda: kernels.lattice_face_sum_3d_plain(U, n, **kw), 3),
                        "bytes": npts * (2 * U.element_size()
                                         + mask.element_size()),
                        "flops": npts * 13,
                    }
    return timed


def profile_solve(torch, solve, f):
    """Device busy share and top kernels of one solve (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(f)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        key = e.name if len(e.name) < 60 else e.name[:60]
        cnt, tot = by_name.get(key, (0, 0.0))
        by_name[key] = (cnt + 1, tot + (b - a))
    if not spans:
        return {"phase": "profile", "device_busy_share": "not measured",
                "reason": "the profiler recorded no device activity"}
    spans.sort()
    busy, cur_a, cur_b = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {"phase": "profile", "profiled_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us,
            "device_activities": len(spans),
            "top": [{"name": k, "count": c, "ms": t / 1e3}
                    for k, (c, t) in top]}


def small_reference(torch, dev):
    """A small composite-DD solve on the card vs the CPU (plain twins)."""
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.generator import kershaw_mesh
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.subdomain import composite_dd
    out = {}
    for where in ("cpu", dev):
        mk = partial(kershaw_mesh, (4, 4, 4), epsilon=0.3, device=where)
        mesh = mk(3)
        dom = Domain(partition_mesh(mesh, 1), dtype=torch.float64, device=where)
        pre = composite_dd(dom, mk, poly_reduction=2, fine_mesh=mesh)
        u = dom.initial_function(4, seed=1)
        res = dom.solver(method="fgmres", max_iterations=60, tolerance=1e-8,
                         precond=pre)(dom.manufacture_rhs(u))
        out[str(where)] = (res.iterations, res.residual_history.cpu(),
                           (res.u - u).abs().max().item())
    (ic, hc, _), (ig, hg, eg) = out["cpu"], out[str(dev)]
    k = ic + 1
    rel = ((hg[:k] - hc[:k]).abs() / hc[:k].abs()).max().item()
    line = {"phase": "small", "mesh": "kershaw 4^3 N=3 f64", "iterations_cpu": ic,
            "iterations_gpu": ig, "history_max_rel_diff": rel,
            "max_err_gpu": eg, "ok": ic == ig and rel <= 1e-6 and eg < 1e-6}
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"card and CPU solves disagree: {line}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.generator import kershaw_mesh
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import cuda_lib, kernels
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.refine import refine_solve
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.subdomain import composite_dd

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": card})

    t0 = time.time()
    so = cuda_lib.build()
    cuda_lib.load()
    emit({"phase": "build", "seconds": time.time() - t0, "library": so[-40:]})

    timed = check_kernels(torch, kernels, dev)
    small_reference(torch, dev)

    # ---- the main path ----
    shape, N = (16, 16, 16), 7
    t0 = time.time()
    mk = partial(kershaw_mesh, shape, epsilon=0.3, device=dev)
    mesh = mk(N)
    sd = partition_mesh(mesh, 1)
    dom = Domain(sd, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    t0 = time.time()
    pre = composite_dd(dom, mk, poly_reduction=6, inner="amg",
                       ptype=torch.bfloat16, fine_mesh=mesh)
    torch.cuda.synchronize()
    precond_s = time.time() - t0
    u_star = dom.initial_function(4, seed=0)
    f = dom.manufacture_rhs(u_star)
    solve = dom.solver(method="fgmres", max_iterations=200, precond=pre)
    t0 = time.time()
    res = solve(f)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    best = float("inf")
    for _ in range(3):
        kernels.reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        res = solve(f)
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / 1e3)
    solve_counts = kernels.counts()
    hist = res.residual_history.cpu()
    hist = hist[torch.isfinite(hist)]
    its = res.iterations
    conv = bool(res.converged)
    finite = bool(torch.isfinite(res.u).all()) and tuple(res.u.shape) == (128, 128, 128)
    plain_calls = sum(sum(c.values()) for k, c in solve_counts.items()
                      if k.endswith("_plain"))
    line = {"phase": "solve", "mesh": "kershaw eps=0.3 16^3 N=7",
            "points": mesh.num_points, "setup_seconds": setup_s,
            "precond_setup_seconds": precond_s, "first_solve_seconds": first_s,
            "solve_seconds": best, "iterations": its, "converged": conv,
            "ms_per_iteration": 1e3 * best / max(its, 1),
            "residuals": [float(x) for x in hist[:8]],
            "launches": solve_counts, "finite": finite,
            "lmax0": float(pre.extra["amg"]["lmax0"]),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(line)
    if not (conv and 11 <= its <= 13 and finite and plain_calls == 0
            and sum(solve_counts["stiffness_lattice_3d"].values()) > 0
            and sum(solve_counts["lattice_face_sum_3d"].values()) > 0):
        raise AssertionError(f"main-path solve failed its checks: {line}")
    emit(profile_solve(torch, solve, f))

    dom64 = Domain(sd, dtype=torch.float64, device=dev)
    u64 = dom64.to_device_field(dom.from_device_field(u_star))
    f64 = dom64.manufacture_rhs(u64)
    kernels.reset_counts()
    t0 = time.time()
    rr = refine_solve(dom64, solve, f64, tolerance=1e-10)
    torch.cuda.synchronize()
    ref_s = time.time() - t0
    refine_counts = kernels.counts()
    err64 = (rr.u - u64).abs().max().item()
    line = {"phase": "refine", "rel_residual": rr.rel_residual,
            "max_error": err64, "cycles": rr.cycles,
            "inner_iterations": rr.inner_iterations, "seconds": ref_s,
            "history": rr.history, "launches": refine_counts}
    emit(line)
    plain_calls = sum(sum(c.values()) for k, c in refine_counts.items()
                      if k.endswith("_plain"))
    if not (rr.rel_residual <= 1e-10 and plain_calls == 0):
        raise AssertionError(f"refinement failed its checks: {line}")

    entries = []
    for (name, dt), t in sorted(timed.items()):
        launches = (solve_counts[name].get(dt, 0)
                    + refine_counts[name].get(dt, 0))
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["flops"] / PEAK_FLOPS[dt] * 1e3
        entries.append({
            "name": f"{name}[{dt}]", "route": "cuda",
            "source": f"{PKG}/csrc/"
                      + ("stiffness.cu" if name == "stiffness_lattice_3d"
                         else "face_sum.cu"),
            "replaces": TPU_KERNELS + (":295" if name == "stiffness_lattice_3d"
                                       else ":102"),
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
    print("no single PyTorch call computes either kernel's function: "
          "library_ms is null", flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
