"""Reference counts of the JAX package on the structured 2-D path, for the
PyTorch port to be held to (chip_smoke.py's pmg-2d and spmd-2d phases).

Runs the JAX package on the CPU with 8 virtual devices (x64 enabled, so
an f64 run is f64) and prints one JSON line per run. The configuration is
Kershaw eps=0.3 on SHAPE elements (e.g. 192,192) at N=7, f32 FCG to a
relative residual of 1e-4, u* = initial_function(4, seed=0):

  python reference/jax_2d.py pmg SHAPE P [OMEGA] [MAXIT]
      pmultigrid(poly_reduction=2, smooth_damping=OMEGA) (orders 7, 5, 3,
      1; OMEGA 0.5 by default, the package's own default is 2/3) over P
      slab shards, at most MAXIT iterations (default 400).
  python reference/jax_2d.py jacobi SHAPE P [MAXIT] [DTYPE]
      the Jacobi preconditioner, at most MAXIT iterations (default 8000),
      in DTYPE (float32, the default, or float64).

  python reference/jax_2d.py composite SHAPE P DTYPE PTYPE [MAXIT]
      the composite, composite_dd(poly_reduction=6, inner="amg",
      ptype=PTYPE), under FGMRES(20) to 1e-4 in DTYPE (float32 or
      float64; reference/jax_composite.py's ``main`` is DTYPE float32),
      at most MAXIT iterations (default 200); beside the run's r0 the f64
      norm of the same right-hand side (``r0_f64``: an f64 Domain's
      residual of u = 0 with f = A u* from the same u*), which shows how
      far the DTYPE norm is from it.

The composite runs of reference/jax_composite.py's ``main`` take a 2-D
SHAPE too. Each line carries the iteration count, the first residuals,
the last relative residual, the wall seconds and the process's peak RSS.
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


def _run(jax, what, shape, Pn, maxit, omega=None, dtype="float32"):
    import numpy as np
    import jax.numpy as jnp
    from functools import partial
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as mg
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import preconditioners as pc
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain
    t0 = time.time()
    mk = partial(mg.kershaw_mesh, shape, epsilon=0.3)
    sd = partition_mesh(mk(7), Pn)
    dm = jax.make_mesh((Pn,), ("shard",)) if Pn > 1 else None
    dom = Domain(sd, dtype=getattr(jnp, dtype), device_mesh=dm)
    f = dom.manufacture_rhs(dom.initial_function(4, seed=0))
    if what == "pmg":
        pre = pc.pmultigrid(dom, mk, poly_reduction=2, smooth_damping=omega)
    else:
        pre = pc.jacobi(dom)
    t1 = time.time()
    res = dom.solver(method="fcg", max_iterations=maxit, tolerance=1e-4,
                     precond=pre)(f)
    hist = np.asarray(res.residual_history, dtype=np.float64)
    hist = hist[np.isfinite(hist)]
    t2 = time.time()
    out = {"run": what, "shape": list(shape), "P": Pn, "dtype": dtype,
           "layers": list(sd.structured.layer_counts),
           "iterations": int(res.iterations),
           "converged": bool(res.converged),
           "first_residuals": [float(h) for h in hist[:4]],
           "last_relative": float(hist[-1] / hist[0]),
           "setup_s": t1 - t0, "solve_s": t2 - t1}
    if omega is not None:
        out["smooth_damping"] = omega
    _emit(**out)


def _composite(jax, shape, Pn, dtype, ptype, maxit):
    import numpy as np
    import jax.numpy as jnp
    from functools import partial
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as mg
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as sub
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain
    t0 = time.time()
    mk = partial(mg.kershaw_mesh, shape, epsilon=0.3)
    mesh = mk(7)
    sd = partition_mesh(mesh, Pn)
    dm = jax.make_mesh((Pn,), ("shard",)) if Pn > 1 else None
    dom = Domain(sd, dtype=getattr(jnp, dtype), device_mesh=dm)
    u_star = dom.initial_function(4, seed=0)
    f = dom.manufacture_rhs(u_star)
    dom64 = Domain(sd, dtype=jnp.float64, device_mesh=dm)
    f64 = dom64.manufacture_rhs(dom64.to_device_field(
        np.asarray(dom.from_device_field(u_star), dtype=np.float64)))
    _, r0_64 = dom64.residual(jnp.zeros_like(f64), f64)
    pre = sub.composite_dd(dom, mk, poly_reduction=6, inner="amg",
                           ptype=getattr(jnp, ptype), fine_mesh=mesh)
    t1 = time.time()
    res = dom.solver(method="fgmres", max_iterations=maxit, tolerance=1e-4,
                     precond=pre)(f)
    hist = np.asarray(res.residual_history, dtype=np.float64)
    hist = hist[np.isfinite(hist)]
    t2 = time.time()
    _emit(run="composite", shape=list(shape), P=Pn, dtype=dtype,
          ptype=ptype, iterations=int(res.iterations),
          converged=bool(res.converged), r0_f64=float(r0_64),
          first_residuals=[float(h) for h in hist[:6]],
          last_relative=float(hist[-1] / hist[0]), setup_s=t1 - t0,
          solve_s=t2 - t1)


if __name__ == "__main__":
    jax = _jax()
    what = sys.argv[1] if len(sys.argv) > 1 else "pmg"
    if what not in ("pmg", "jacobi", "composite") or len(sys.argv) < 4:
        raise SystemExit(__doc__)
    shape = tuple(int(x) for x in sys.argv[2].split(","))
    Pn = int(sys.argv[3])
    if what == "composite":
        _composite(jax, shape, Pn, sys.argv[4], sys.argv[5],
                   int(sys.argv[6]) if len(sys.argv) > 6 else 200)
    elif what == "pmg":
        omega = float(sys.argv[4]) if len(sys.argv) > 4 else 0.5
        maxit = int(sys.argv[5]) if len(sys.argv) > 5 else 400
        _run(jax, "pmg", shape, Pn, maxit, omega)
    else:
        _run(jax, "jacobi", shape, Pn,
             int(sys.argv[4]) if len(sys.argv) > 4 else 8000,
             dtype=sys.argv[5] if len(sys.argv) > 5 else "float32")
