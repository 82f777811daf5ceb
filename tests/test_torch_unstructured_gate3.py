"""Dry-run gate 3 (__graft_entry__.dryrun_multichip) on the port, CPU:
scrambled (seed 5, permute=False) Kershaw (2, 2, 17) N=3, extent (1, 1,
8.5), f32 FGMRES to 1e-6 with composite_dd(poly_reduction=2, inner="amg")
at P = 1 and 8 shards: the gate's own checks and the counts
MULTICHIP_r05.json records (9 -> 14), +-1 each. The JAX side of the gate
costs minutes on the CPU; the port's own P = 1 and 8 solves are held to
the record."""

import numpy as np
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.generator import kershaw_mesh, scramble_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.subdomain import composite_dd

from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def test_gate3_dry_run():
    shape = (2, 2, 17)
    mk = lambda o: scramble_mesh(kershaw_mesh(
        shape, o, epsilon=0.3, extent=(1.0, 1.0, shape[-1] / 2.0),
        device="cpu"), seed=5, permute=False, device="cpu")
    mesh = mk(3)
    out = {}
    for Pn in (1, 8):
        dom = Domain(partition_mesh(mesh, Pn), dtype=torch.float32,
                     device="cpu")
        u = dom.initial_function(4, seed=0)
        pre = composite_dd(dom, mk, poly_reduction=2, inner="amg",
                           fine_mesh=mesh)
        res = dom.solver(method="fgmres", max_iterations=200, tolerance=1e-6,
                         precond=pre)(dom.manufacture_rhs(u))
        err = np.abs(dom.from_device_field(res.u)
                     - dom.from_device_field(u)).max()
        out[Pn] = (bool(res.converged), res.iterations, err)
    (c1, k1, e1), (cn, kn, en) = out[1], out[8]
    assert c1 and cn and e1 < 1e-3 and en < 1e-3
    assert kn <= k1 + 8
    assert abs(k1 - 9) <= 1 and abs(kn - 14) <= 1, (k1, kn)
