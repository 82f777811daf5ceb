"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, defaults to the card (raising without one) and launches no
kernel on CPU tensors."""

import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

import polynomial_reduction_with_full_domain_decomposition_preconditioner_torch as port
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.ops import kernels
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain

from composite_twins import one_torch_thread  # noqa: F401 (autouse)

_PKG_DIR = os.path.dirname(port.__file__)
_REPO = os.path.dirname(_PKG_DIR)

_ISOLATED = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys
    from functools import partial

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith("jax.") or "_tpu" in name:
                raise ImportError("blocked: " + name)
            return None

    sys.modules["jax"] = None
    sys.meta_path.insert(0, Block())
    import polynomial_reduction_with_full_domain_decomposition_preconditioner_torch as port
    names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    assert port.__name__ + ".runtime.comm" in names
    import torch
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.subdomain import composite_dd
    mk = partial(tg.kershaw_mesh, (4, 4, 4), epsilon=0.3, device="cpu")
    mesh = mk(3)
    dom = Domain(partition_mesh(mesh, 1), dtype=torch.float32, device="cpu")
    pre = composite_dd(dom, mk, poly_reduction=2, ptype=torch.bfloat16,
                       fine_mesh=mesh)
    u = dom.initial_function(4, seed=0)
    res = dom.solver(method="fgmres", max_iterations=50, precond=pre)(
        dom.manufacture_rhs(u))
    assert bool(res.converged), res.residual_history
    # this slice's modules: the preconditioners, the composite variants
    # and the precision study (plain twins on the CPU)
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.preconditioners import jacobi, pmultigrid
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies import stiffness_precision
    for pre in (jacobi(dom), pmultigrid(dom, mk, poly_reduction=2),
                composite_dd(dom, mk, poly_reduction=2, inner="jacobi",
                             inner_solver="fcg", fine_mesh=mesh)):
        r2 = dom.solver(method="fcg", max_iterations=200, precond=pre)(
            dom.manufacture_rhs(u))
        assert bool(r2.converged), r2.residual_history
    assert len(stiffness_precision.run(16, device="cpu")) == 4
    # the assembled FEM hierarchy: the native setup library and the
    # sparse V-cycle, with JAX blocked
    pre = composite_dd(dom, mk, poly_reduction=2, inner="fem-amg",
                       fine_mesh=mesh)
    r3 = dom.solver(method="fgmres", max_iterations=50, precond=pre)(
        dom.manufacture_rhs(u))
    assert bool(r3.converged), r3.residual_history
    # P slab shards through the single-process comm (runtime/comm.py):
    # uniform and ragged, Jacobi and p-multigrid, with JAX blocked
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.comm import LocalComm
    for P in (2, 3):
        domP = Domain(partition_mesh(mesh, P), dtype=torch.float32,
                      device="cpu", comm=LocalComm(P))
        uP = domP.initial_function(4, seed=0)
        for pre in (jacobi(domP), pmultigrid(domP, mk, poly_reduction=2)):
            r4 = domP.solver(method="fcg", max_iterations=200, precond=pre)(
                domP.manufacture_rhs(uP))
            assert bool(r4.converged) and r4.u.shape[0] == P, r4.iterations
    assert not any(k == "jax" or k.startswith("jax.") or "_tpu" in k
                   for k, v in sys.modules.items() if v is not None)
    print("modules", len(names), "iterations", res.iterations)
""")


def test_port_runs_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=_REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "iterations" in out.stdout
    # every module of the port was imported there, the new ones included
    summary = [l for l in out.stdout.splitlines() if l.startswith("modules")]
    assert int(summary[0].split()[1]) >= 25


_UNSTRUCTURED = textwrap.dedent("""
    import importlib, importlib.abc, sys
    from functools import partial

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith("jax.") or "_tpu" in name:
                raise ImportError("blocked: " + name)
            return None

    sys.modules["jax"] = None
    sys.meta_path.insert(0, Block())
    import torch
    pkg = "polynomial_reduction_with_full_domain_decomposition_preconditioner_torch"
    for name in ("mesh.graph", "mesh.pebble", "ops.face_dssum",
                 "amg.aggregation", "solvers.unstructured",
                 "amg.unstructured_fem", "runtime.checkpoint",
                 "solvers.host_oracle"):
        importlib.import_module(pkg + "." + name)
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.pebble import pebble_mesh
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.subdomain import composite_dd
    scr = lambda o: tg.scramble_mesh(tg.kershaw_mesh((3, 3, 4), o, 0.3,
                                                     device="cpu"),
                                     seed=5, permute=False, device="cpu")
    peb = partial(pebble_mesh, (6, 6, 6), num_pebbles=4, seed=2,
                  device="cpu")
    its = []
    for mk, P, kw in ((scr, 1, {"ptype": torch.bfloat16}), (scr, 2, {}),
                      (peb, 1, {"inner": "jacobi"})):
        mesh = mk(3)
        dom = Domain(partition_mesh(mesh, P), dtype=torch.float32,
                     device="cpu")
        pre = composite_dd(dom, mk, poly_reduction=2, fine_mesh=mesh,
                           **{"inner": "amg", **kw})
        u = dom.initial_function(4, seed=0)
        res = dom.solver(method="fgmres", max_iterations=60, precond=pre)(
            dom.manufacture_rhs(u))
        assert bool(res.converged), res.residual_history
        its.append(res.iterations)
    # inner="fem-amg" through a setup cache, fresh and loaded, and the
    # host f64 oracle refining the f32 solve
    import os, tempfile
    import numpy as np
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.host_oracle import HostOperator, host_refine_solve
    mesh = scr(3)
    dom = Domain(partition_mesh(mesh, 1), dtype=torch.float32, device="cpu")
    u = dom.initial_function(4, seed=0)
    with tempfile.TemporaryDirectory() as d:
        cache = os.path.join(d, "setup.npz")
        for mk in (scr, None):
            pre = composite_dd(dom, mk, poly_reduction=2, inner="fem-amg",
                               fine_mesh=mesh, chain_cache=cache)
            res = dom.solver(method="fgmres", max_iterations=60,
                             precond=pre)(dom.manufacture_rhs(u))
            assert bool(res.converged), res.residual_history
            its.append(res.iterations)
    host = HostOperator(mesh)
    ustar = dom.from_device_field(u).astype(np.float64).reshape(-1)
    ref = host_refine_solve(host, dom, dom.solver(method="fgmres",
                            max_iterations=60, precond=pre),
                            host.apply(ustar), tolerance=1e-9)
    assert ref.converged, ref.history
    assert not any(k == "jax" or k.startswith("jax.") or "_tpu" in k
                   for k, v in sys.modules.items() if v is not None)
    print("unstructured iterations", its)
""")


def test_unstructured_path_runs_with_jax_blocked():
    # scrambled (one and two shards, bf16 composite) and pebble-bed meshes
    # through the unstructured composite, inner="fem-amg" through its setup
    # cache and the host f64 oracle, every new module imported
    out = subprocess.run([sys.executable, "-c", _UNSTRUCTURED], cwd=_REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "unstructured iterations" in out.stdout


def test_no_jax_or_reference_imports_in_sources():
    pat = re.compile(r"^\s*(import|from)\s+[\w.]*(jax|_tpu)\b", re.M)
    seen = 0
    for root, _, files in os.walk(_PKG_DIR):
        for name in files:
            if name.endswith(".py"):
                seen += 1
                with open(os.path.join(root, name)) as fh:
                    src = fh.read()
                assert not pat.search(src), name
                assert "import jax" not in src and "_tpu import" not in src, name
    assert seen >= 20


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: None resolves to it")
    with pytest.raises(RuntimeError):
        port.resolve_device(None)
    with pytest.raises(RuntimeError):
        tg.kershaw_mesh((2, 2, 2), 2)
    sd = partition_mesh(tg.kershaw_mesh((2, 2, 2), 2, device="cpu"), 1)
    with pytest.raises(RuntimeError):
        Domain(sd, dtype=torch.float32, device=None)
    assert port.resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_never_launch_kernels():
    sd = partition_mesh(tg.kershaw_mesh((2, 2, 2), 3, device="cpu"), 1)
    dom = Domain(sd, dtype=torch.float32, device="cpu")
    kernels.reset_counts()
    u = dom.initial_function(0)
    dom.solver(method="fcg", max_iterations=5)(dom.manufacture_rhs(u))
    c = kernels.counts()
    assert c["stiffness_lattice_3d"] == {} and c["lattice_face_sum_3d"] == {}
    assert c["stiffness_lattice_3d_plain"]["float32"] > 0
    assert c["lattice_face_sum_3d_plain"]["float32"] > 0
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    # a tensor that is neither on the CPU nor on a card has no kernel
    meta = torch.empty((4, 4, 4), device="meta")
    with pytest.raises(ValueError):
        kernels.lattice_face_sum_3d(meta, 2)
    with pytest.raises(ValueError):
        kernels.stiffness_lattice_3d(meta, [meta] * 6, 2)
    with pytest.raises(ValueError):
        kernels.stiffness_lattice_3d_split(meta, [meta] * 6, 8)


def test_launch_signatures_are_kept_until_taken():
    # chip_smoke.py holds K1 and K2 to their twins at every signature a
    # phase launched: reset_counts clears the counts, not the signatures
    kernels.take_signatures()
    kernels.stiffness_lattice_3d.launches.add(torch.float32, ((16, 8, 8), 2))
    kernels.stiffness_lattice_3d.launches.add(torch.float32, ((16, 8, 8), 2))
    kernels.lattice_face_sum_3d.launches.add(
        torch.bfloat16, ((2, 8, 8, 8), 2, None, False, False))
    kernels.reset_counts()
    assert kernels.counts()["stiffness_lattice_3d"] == {}
    assert kernels.take_signatures() == {
        "stiffness_lattice_3d": [("float32", (16, 8, 8), 2)],
        "lattice_face_sum_3d": [("bfloat16", (2, 8, 8, 8), 2, None, False,
                                 False)]}
    assert kernels.take_signatures() == {"stiffness_lattice_3d": [],
                                         "lattice_face_sum_3d": []}
    # a CPU tensor goes to the plain twin and leaves no signature
    kernels.lattice_face_sum_3d(torch.ones((2, 4, 4, 4)), 2)
    assert kernels.take_signatures()["lattice_face_sum_3d"] == []
