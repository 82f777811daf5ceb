"""Helpers of the unstructured port twins (tests/test_torch_unstructured*.py,
test_torch_pebble.py): the same seeded mesh built by both packages, their
Domains on it, and the comparisons of a preconditioner application and of
whole outer solves. Imported by name (tests/ is on sys.path under
pytest)."""

import numpy as np
import scipy.sparse as sp
import torch
import jax
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.pebble import pebble_mesh as jpebble
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.runtime.checkpoint import load_setup_payload as jload
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.pebble import pebble_mesh as tpebble
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.checkpoint import load_setup_payload as tload
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain

from composite_twins import one_torch_thread  # noqa: F401 (autouse, re-exported)


def scrambled(shape, seed, permute=True):
    """(JAX builder, port builder) of a scrambled Kershaw eps=0.3 mesh."""
    return (lambda o: jg.scramble_mesh(jg.kershaw_mesh(shape, o, 0.3),
                                       seed=seed, permute=permute),
            lambda o: tg.scramble_mesh(
                tg.kershaw_mesh(shape, o, 0.3, device="cpu"), seed=seed,
                permute=permute, device="cpu"))


def pebbles(shape, num_pebbles, seed):
    """(JAX builder, port builder) of a pebble-bed mesh."""
    return (lambda o: jpebble(shape, o, num_pebbles=num_pebbles, seed=seed),
            lambda o: tpebble(shape, o, num_pebbles=num_pebbles, seed=seed,
                              device="cpu"))


class Twin:
    """Both packages' f64 Domains on the order-N mesh over Pn shards, with
    u* = initial_function(4, seed) and f = A u*."""

    def __init__(self, builders, N, Pn, seed=3):
        self.jmk, self.tmk = builders
        self.jm, self.tm = self.jmk(N), self.tmk(N)
        dm = jax.make_mesh((Pn,), ("shard",)) if Pn > 1 else None
        self.jd = JDomain(jpartition(self.jm, Pn), dtype=jnp.float64,
                          device_mesh=dm)
        self.td = TDomain(tpartition(self.tm, Pn), dtype=torch.float64,
                          device="cpu")
        self.ju = self.jd.initial_function(4, seed=seed)
        self.tu = self.td.initial_function(4, seed=seed)
        self.jf = self.jd.manufacture_rhs(self.ju)
        self.tf = self.td.manufacture_rhs(self.tu)

    def composites(self, jbuild, tbuild, **kw):
        """The same preconditioner from both packages: jbuild / tbuild are
        composite constructors taking (domain, builder, fine_mesh=..., **kw)."""
        return (jbuild(self.jd, self.jmk, fine_mesh=self.jm, **kw),
                tbuild(self.td, self.tmk, fine_mesh=self.tm, **kw))

    def check_apply(self, jp, tp, rtol=1e-12):
        """One preconditioner application (and its inner history) on f."""
        zj, hj = self.jd.precond_probe(jp)(self.jf)
        zt, ht = self.td.precond_probe(tp)(self.tf)
        zj = np.asarray(self.jd.from_device_field(zj))
        zt = self.td.from_device_field(zt)
        assert np.abs(zj - zt).max() <= rtol * np.abs(zj).max()
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=rtol)

    def solve_both(self, jp, tp, tol=1e-8, maxit=60):
        rj = self.jd.solver(method="fgmres", max_iterations=maxit,
                            tolerance=tol, precond=jp)(self.jf)
        rt = self.td.solver(method="fgmres", max_iterations=maxit,
                            tolerance=tol, precond=tp)(self.tf)
        return rj, rt

    def check_outer(self, rj, rt, steps, max_err=1e-6):
        """Equal counts, both converged, the histories at rtol 1e-9 over the
        first ``steps`` steps (the f64 histories part by round-off after
        that, ROADMAP section 3), the error against u*."""
        assert int(rj.iterations) == rt.iterations
        assert bool(rj.converged) and bool(rt.converged)
        hj = np.asarray(rj.residual_history)[:steps + 1]
        ht = rt.residual_history.numpy()[:steps + 1]
        np.testing.assert_allclose(ht, hj, rtol=1e-9)
        err = np.abs(self.td.from_device_field(rt.u)
                     - self.td.from_device_field(self.tu)).max()
        assert err < max_err


def _rel(a, b):
    """max |a - b| over max |a| (dense or sparse)."""
    d = abs(a - b).max()
    m = abs(a).max()
    return float(d) / float(m) if m else float(d)


def check_fem_hierarchies(jpath, tpath, tol=1e-14):
    """The shards' padded FEM hierarchies of both packages' setup
    payloads, level for level, to ``tol`` of max; returns the port's."""
    jf, tf = jload(jpath)["fem"], tload(tpath)["fem"]
    assert len(jf) == len(tf)
    for js, ts in zip(jf, tf):
        jc, tc = js["chain"], ts["chain"]
        assert len(jc["mats"]) == len(tc["mats"])
        for key in ("mats", "prolongs"):
            for a, b in zip(jc[key], tc[key]):
                assert sp.isspmatrix_csr(b) and a.shape == b.shape
                assert _rel(a, b) <= tol, key
        np.testing.assert_allclose(tc["lmaxs"], jc["lmaxs"], rtol=tol)
        assert _rel(jc["coarse_inv"], tc["coarse_inv"]) <= tol
        assert js["Q"].shape == ts["Q"].shape
        assert _rel(js["Q"], ts["Q"]) <= tol
        assert np.array_equal(js["dof_mask"], ts["dof_mask"])
        assert (js["ndof"], js["ns"]) == (ts["ndof"], ts["ns"])
    return tf
