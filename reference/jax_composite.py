"""Reference counts of the JAX package's multi-shard composite, for the
PyTorch port to be held to.

Runs the JAX package on the CPU with 8 virtual devices (x64 enabled, so
an f64 run is f64) and prints one JSON line per run:

  python reference/jax_composite.py scaling
      artifacts/strong_scaling.json's configuration (Kershaw eps=0.3,
      (4, 4, 16) elements, N=3, r=2, f64 FGMRES to 1e-8, inner "amg") at
      P = 1, 2, 3, 4, 6, 8, counting finite history entries as that
      record does; writes no file.
  python reference/jax_composite.py main SHAPE P [MAXIT] [PTYPE]
      the main-path configuration on SHAPE (e.g. 16,16,16): N=7, f32
      FGMRES(20) to 1e-4, composite_dd(poly_reduction=6, inner="amg",
      ptype=PTYPE) (float32, the default, or bfloat16), u* =
      initial_function(4, seed=0); MAXIT outer iterations at most
      (default 200). The port's twin:
      ..._torch/studies/composite_counts.py.
  python reference/jax_composite.py refine SHAPE P MAXIT PTYPE CYCLES
      f64 refinement (solvers/refine.refine_solve) of the main-path
      configuration's f32 solve on SHAPE over P shards, at most MAXIT
      outer iterations per cycle, for CYCLES cycles: the relative f64
      residual after each cycle.
  python reference/jax_composite.py gates
      gates 2 and 4 of __graft_entry__.dryrun_multichip at P = 1 and 8
      (Kershaw (2, 2, 17) N=3 r=2): the ragged f32 composite with inner
      "amg", and inner "fem-amg" in bf16 with a bf16 Z basis.

Each line carries its wall seconds and the process's peak RSS.
"""

import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", True)
    return jax


def _emit(**kw):
    kw["maxrss_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(json.dumps(kw), flush=True)


def _solve(jax, mesh, mk, Pn, dtype, *, red, tol, maxit, seed=0,
           inner="amg", ptype=None, z_dtype=None):
    import numpy as np
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as sub
    t0 = time.time()
    dm = jax.make_mesh((Pn,), ("shard",)) if Pn > 1 else None
    dom = Domain(partition_mesh(mesh, Pn), dtype=dtype, device_mesh=dm)
    u_star = dom.initial_function(4, seed=seed)
    f = dom.manufacture_rhs(u_star)
    pre = sub.composite_dd(dom, mk, poly_reduction=red, inner=inner,
                           ptype=ptype, fine_mesh=mesh)
    t1 = time.time()
    kw = {} if z_dtype is None else {"z_dtype": z_dtype}
    res = dom.solver(method="fgmres", max_iterations=maxit, tolerance=tol,
                     precond=pre, **kw)(f)
    hist = np.asarray(res.residual_history, dtype=np.float64)
    t2 = time.time()
    err = float(np.abs(dom.from_device_field(res.u)
                       - dom.from_device_field(u_star)).max())
    return {"P": Pn, "iterations": int(res.iterations),
            "finite_history": int(np.isfinite(hist).sum()),
            "converged": bool(res.converged), "max_error": err,
            "history": [float(h) for h in hist[np.isfinite(hist)]],
            "setup_s": t1 - t0, "solve_s": t2 - t1}


def scaling(jax):
    import jax.numpy as jnp
    from functools import partial
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as mg
    shape, N, red = (4, 4, 16), 3, 2
    mk = partial(mg.kershaw_mesh, shape, epsilon=0.3)
    mesh = mk(N)
    for Pn in (1, 2, 3, 4, 6, 8):
        out = _solve(jax, mesh, mk, Pn, jnp.float64, red=red, tol=1e-8,
                     maxit=100)
        out.pop("history")
        _emit(run="scaling", **out)


def main_path(jax, shape, Pn, maxit, ptype="float32"):
    import jax.numpy as jnp
    from functools import partial
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as mg
    mk = partial(mg.kershaw_mesh, shape, epsilon=0.3)
    t0 = time.time()
    mesh = mk(7)
    out = _solve(jax, mesh, mk, Pn, jnp.float32, red=6, tol=1e-4,
                 maxit=maxit, ptype=getattr(jnp, ptype))
    _emit(run="main", shape=list(shape), ptype=ptype,
          wall_s=time.time() - t0, **out)


def refine(jax, shape, Pn, maxit, ptype, cycles):
    import jax.numpy as jnp
    from functools import partial
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as mg
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as sub
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.refine import refine_solve
    mk = partial(mg.kershaw_mesh, shape, epsilon=0.3)
    t0 = time.time()
    mesh = mk(7)
    dm = jax.make_mesh((Pn,), ("shard",)) if Pn > 1 else None
    sd = partition_mesh(mesh, Pn)
    dom = Domain(sd, dtype=jnp.float32, device_mesh=dm)
    u = dom.initial_function(4, seed=0)
    pre = sub.composite_dd(dom, mk, poly_reduction=6, inner="amg",
                           ptype=getattr(jnp, ptype), fine_mesh=mesh)
    solve = dom.solver(method="fgmres", max_iterations=maxit, tolerance=1e-4,
                       precond=pre)
    dom64 = Domain(sd, dtype=jnp.float64, device_mesh=dm)
    f64 = dom64.manufacture_rhs(dom64.to_device_field(dom.from_device_field(u)))
    rr = refine_solve(dom64, solve, f64, tolerance=1e-10, max_cycles=cycles)
    _emit(run="refine", shape=list(shape), P=Pn, ptype=ptype,
          max_iterations_per_cycle=maxit, cycles=rr.cycles,
          inner_iterations=rr.inner_iterations, history=rr.history,
          wall_s=time.time() - t0)


def gates(jax):
    import jax.numpy as jnp
    from functools import partial
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as mg
    shape = (2, 2, 17)
    mk = partial(mg.kershaw_mesh, shape, epsilon=0.3, extent=(1.0, 1.0, 8.5))
    mesh = mk(3)
    for Pn in (1, 8):
        out = _solve(jax, mesh, mk, Pn, jnp.float32, red=2, tol=1e-6,
                     maxit=200)
        out.pop("history")
        _emit(run="gate2", **out)
        out = _solve(jax, mesh, mk, Pn, jnp.float32, red=2, tol=1e-6,
                     maxit=200, inner="fem-amg", ptype=jnp.bfloat16,
                     z_dtype=jnp.bfloat16)
        out.pop("history")
        _emit(run="gate4", **out)


if __name__ == "__main__":
    jax = _jax()
    what = sys.argv[1] if len(sys.argv) > 1 else "scaling"
    if what == "scaling":
        scaling(jax)
    elif what == "main":
        main_path(jax, tuple(int(x) for x in sys.argv[2].split(",")),
                  int(sys.argv[3]),
                  int(sys.argv[4]) if len(sys.argv) > 4 else 200,
                  sys.argv[5] if len(sys.argv) > 5 else "float32")
    elif what == "refine":
        refine(jax, tuple(int(x) for x in sys.argv[2].split(",")),
               int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
               int(sys.argv[6]))
    elif what == "gates":
        gates(jax)
    else:
        raise SystemExit(f"unknown run {what!r}")
