"""Dry-run gates 2 and 4 (__graft_entry__.py:124-134, :146-173) in the
port against the JAX package on the CPU: Kershaw (2, 2, 17) N=3 r=2 with
isotropic elements, the one-shard halves against the 8-shard halves (slabs
3, 2, ..., 2). Gate 2: the f32 composite with inner "amg", FGMRES to
1e-6 (MULTICHIP_r05.json: 8 -> 14). Gate 4: inner "fem-amg" with a bf16
hierarchy and a bf16 Z basis (11 -> 18). Both packages get the identical
mesh and the same seeded manufactured solution."""

from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh import generator as jg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.mesh.partition import partition_mesh as jpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers import subdomain as jsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.solvers.domain import Domain as JDomain

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh as tpartition
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers import subdomain as tsub
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain as TDomain

from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def port_mesh(m):
    return tg.GlobalMesh.from_numpy(
        coords=m.coords, geom=m.geom, dirichlet_mask=m.dirichlet_mask,
        node_degree=m.node_degree, elem_shape=m.elem_shape,
        poly_degree=m.poly_degree, mass=m.mass)


JB = partial(jg.kershaw_mesh, (2, 2, 17), epsilon=0.3, extent=(1.0, 1.0, 8.5))


@pytest.fixture(scope="module")
def gate_mesh():
    jm = JB(3)
    return jm, port_mesh(jm)


def run_port(tm, Pn, gate):
    td = TDomain(tpartition(tm, Pn), dtype=torch.float32, device="cpu")
    u = td.initial_function(4, seed=0)
    f = td.manufacture_rhs(u)
    tb = lambda o: port_mesh(JB(o))
    if gate == 2:
        pre = tsub.composite_dd(td, tb, poly_reduction=2, inner="amg",
                                fine_mesh=tm)
        kw = {}
    else:
        pre = tsub.composite_dd(td, tb, poly_reduction=2, inner="fem-amg",
                                ptype=torch.bfloat16, fine_mesh=tm)
        kw = {"z_dtype": torch.bfloat16}
    res = td.solver(method="fgmres", max_iterations=200, tolerance=1e-6,
                    precond=pre, **kw)(f)
    err = (res.u.double() - u.double()).abs().max().item()
    return bool(res.converged), res.iterations, err


def run_jax(jm, Pn, gate):
    jd = JDomain(jpartition(jm, Pn), dtype=jnp.float32,
                 device_mesh=jax.make_mesh((Pn,), ("shard",)))
    u = jd.initial_function(4, seed=0)
    f = jd.manufacture_rhs(u)
    if gate == 2:
        pre = jsub.composite_dd(jd, JB, poly_reduction=2, inner="amg",
                                fine_mesh=jm)
        kw = {}
    else:
        pre = jsub.composite_dd(jd, JB, poly_reduction=2, inner="fem-amg",
                                ptype=jnp.bfloat16, fine_mesh=jm)
        kw = {"z_dtype": jnp.bfloat16}
    res = jd.solver(method="fgmres", max_iterations=200, tolerance=1e-6,
                    precond=pre, **kw)(f)
    return bool(res.converged), int(res.iterations)


# the port's count against the JAX package's 8-shard count, and the
# gate's own bound over the port's one-shard half: gate 2 in f32 agrees to
# +-1 (14 in both on the CPU); gate 4's bf16 SpMV sums once in f32 in the
# port where the JAX package sums in bf16 (ROADMAP section 3), +-2 (19
# against 18 on the CPU; its one-shard half 10 against 11)
@pytest.mark.parametrize("gate,window,bound", [(2, 1, 8), (4, 2, 10)])
def test_gate_eight_shard_half_matches_reference(gate_mesh, gate, window,
                                                 bound):
    jm, tm = gate_mesh
    c1, i1, e1 = run_port(tm, 1, gate)
    c8, i8, e8 = run_port(tm, 8, gate)
    cj, ij = run_jax(jm, 8, gate)
    assert c1 and c8 and cj
    assert e1 < 1e-3 and e8 < 1e-3, (e1, e8)
    assert abs(i8 - ij) <= window, (i8, ij)
    assert i8 <= i1 + bound, (i1, i8)
