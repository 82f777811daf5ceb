"""Reference counts of the JAX package's unstructured composite, for the
PyTorch port to be held to.

Runs the JAX package on the CPU with 8 virtual devices (x64 enabled, so
an f64 run is f64) and prints one JSON line per run:

  python reference/jax_unstructured.py spmd SHAPE P [MAXIT] [PTYPE]
      scrambled Kershaw eps=0.3 on SHAPE (e.g. 16,16,16), N=7, scramble
      seed 7 with permute=False (element order kept, so every shard has
      a far field and far_compress="auto" can engage), over P shards:
      f32 FGMRES(20) to 1e-4 preconditioned by
      composite_dd(poly_reduction=6, inner="amg", ptype=PTYPE) (float32,
      the default, or bfloat16), u* = initial_function(4, seed=0); MAXIT
      outer iterations at most (default 200). Prints the count, the
      history, the far-field sizes and whether the far field was
      compressed. chip_smoke.py's unstructured-spmd phase runs the port's
      twin on the card.
  python reference/jax_unstructured.py regions SHAPE P
      the same mesh's per-shard region sizes (own, rings, far) only.
  python reference/jax_unstructured.py femamg
      inner="fem-amg" on tests/test_unstructured.py's configurations:
      scrambled Kershaw eps=0.3 (4, 4, 4) N=3, scramble seed 11, r=2, at
      P = 1 and 4 in f64 (FGMRES to 1e-8) and at P = 1 in f32 with a
      bf16 ptype (to 1e-6), u* = initial_function(4, seed=3); then
      (8, 8, 8) N=2 r=1, permute=False, over 4 shards in f64 with the far
      field compressed and without. The counts the port's CPU tests
      (tests/test_torch_unstructured_femamg.py) are held to.

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


def _builder(shape):
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as mg
    return lambda o: mg.scramble_mesh(mg.kershaw_mesh(shape, o, epsilon=0.3),
                                      seed=7, permute=False)


def regions(shape, Pn):
    import numpy as np
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import graph as gr
    adj = gr.element_adjacency(_builder(shape)(1).glo_num)
    E = adj.shape[0]
    bounds = np.linspace(0, E, Pn + 1).astype(np.int64)
    out = []
    for p in range(Pn):
        own = np.arange(bounds[p], bounds[p + 1])
        rings, far = gr.grow_regions(adj, own, 2, overlap=1)
        out.append({"own": int(own.size),
                    "rings": [int(r.size) for r in rings],
                    "far": int(far.size)})
    _emit(what="regions", shape=list(shape), shards=Pn, regions=out)


def spmd(jax, shape, Pn, maxit, ptype):
    import numpy as np
    import jax.numpy as jnp
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as sub
    t0 = time.time()
    mk = _builder(shape)
    mesh = mk(7)
    dm = jax.make_mesh((Pn,), ("shard",)) if Pn > 1 else None
    dom = Domain(partition_mesh(mesh, Pn), dtype=jnp.float32,
                 device_mesh=dm)
    u_star = dom.initial_function(4, seed=0)
    f = dom.manufacture_rhs(u_star)
    pre = sub.composite_dd(dom, mk, poly_reduction=6, inner="amg",
                           ptype=getattr(jnp, ptype), fine_mesh=mesh)
    setup_s = time.time() - t0
    sup = pre.extra.get("sup")
    res = dom.solver(method="fgmres", max_iterations=maxit,
                     precond=pre)(f)
    hist = np.asarray(res.residual_history)
    hist = hist[np.isfinite(hist)]
    err = float(np.abs(dom.from_device_field(res.u)
                       - dom.from_device_field(u_star)).max())
    _emit(what="spmd", shape=list(shape), shards=Pn, ptype=ptype,
          iterations=int(res.iterations), converged=bool(res.converged),
          r0=float(hist[0]), rel_residual=float(hist[-1] / hist[0]),
          history=[float(x) for x in hist], max_error=err,
          compressed=sup is not None,
          superdomain_size=(int(sup["mask"].shape[-1]) if sup is not None
                            else 0),
          setup_seconds=setup_s, seconds=time.time() - t0)


def femamg(jax):
    import numpy as np
    import jax.numpy as jnp
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as mg
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.unstructured import composite_dd_unstructured

    def run(shape, N, r, Pn, dtype, ptype, tol, permute=True, **kw):
        t0 = time.time()
        mk = lambda o: mg.scramble_mesh(mg.kershaw_mesh(shape, o, 0.3),
                                        seed=11, permute=permute)
        mesh = mk(N)
        dm = jax.make_mesh((Pn,), ("shard",)) if Pn > 1 else None
        dom = Domain(partition_mesh(mesh, Pn), dtype=dtype, device_mesh=dm)
        u_star = dom.initial_function(4, seed=3)
        pre = composite_dd_unstructured(dom, mk, poly_reduction=r,
                                        inner="fem-amg", ptype=ptype,
                                        fine_mesh=mesh, **kw)
        res = dom.solver(method="fgmres", max_iterations=200,
                         tolerance=tol, precond=pre)(
            dom.manufacture_rhs(u_star))
        hist = np.asarray(res.residual_history)
        err = float(np.abs(dom.from_device_field(res.u)
                           - dom.from_device_field(u_star)).max())
        _emit(what="femamg", shape=list(shape), N=N, r=r, shards=Pn,
              dtype=str(np.dtype(dtype)), ptype=str(ptype), options=kw,
              iterations=int(res.iterations), converged=bool(res.converged),
              history=[float(x) for x in hist[np.isfinite(hist)]],
              max_error=err, seconds=time.time() - t0)

    for Pn in (1, 4):
        run((4, 4, 4), 3, 2, Pn, jnp.float64, None, 1e-8)
    run((4, 4, 4), 3, 2, 1, jnp.float32, jnp.bfloat16, 1e-6)
    for fc in (False, True):
        run((8, 8, 8), 2, 1, 4, jnp.float64, None, 1e-8, permute=False,
            far_compress=fc)


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "regions"
    shape = tuple(int(x) for x in sys.argv[2].split(",")) \
        if len(sys.argv) > 2 else (16, 16, 16)
    Pn = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    if what == "regions":
        regions(shape, Pn)
    elif what == "femamg":
        femamg(_jax())
    elif what == "spmd":
        spmd(_jax(), shape, Pn,
             int(sys.argv[4]) if len(sys.argv) > 4 else 200,
             sys.argv[5] if len(sys.argv) > 5 else "float32")
    else:
        raise SystemExit(f"unknown run {what!r}")
