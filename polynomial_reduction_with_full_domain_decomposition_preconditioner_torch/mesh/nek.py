"""Nek5000-export mesh I/O: the reference's on-disk mesh format.

Port of the JAX package's ``mesh/nek.py``, byte for byte the same files.
The reference reads per-rank binary dumps exported from Nek5000: for
each polynomial order N a directory ``lx1_<N+1>/`` holding, per rank p,

  size_<p>.<N>.dat         ASCII  "dim n_x n_y n_z num_local_elements"
  x_<p>.<N>.dat            binary float64, per-element (N+1)^dim values
  y_<p>.<N>.dat            binary float64            (dim >= 2)
  z_<p>.<N>.dat            binary float64            (dim >= 3)
  glo_num_<p>.<N>.dat      binary int64 global node ids (shared at
                           element interfaces; Nek convention 1-based)
  node_degree_<p>.<N>.dat  binary int32 global node multiplicity
  p_mask_<p>.<N>.dat       binary float64, 0.0 on Dirichlet nodes
  g_1..g_<nG>_<p>.<N>.dat  binary float64 geometric factors
                           (2D: G_rr,G_ss,G_rs; 3D: G_rr,G_ss,G_tt,
                            G_rs,G_rt,G_st)

``read_nek_dir`` reads that format into a :class:`GlobalMesh` and
``write_nek_dir`` writes one out, so meshes generated here feed the
reference and either package reads the other's exports. Local
intra-element ordering is the same on both sides: v = i + j*n + k*n^2
with x fastest. Host numpy throughout; the mass (and, on request, the
geometry check) comes from ``geometric_factors`` on the device given.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from .generator import GlobalMesh, geometric_factors

__all__ = ["read_nek_dir", "write_nek_dir", "nek_mesh_builder",
           "available_orders"]


def _level_dir(directory: str, poly_degree: int) -> str:
    return os.path.join(directory, f"lx1_{poly_degree + 1}")


def _rank_file(level_dir, name, rank, poly_degree):
    return os.path.join(level_dir, f"{name}_{rank}.{poly_degree}.dat")


def available_orders(directory: str) -> list[int]:
    """Polynomial orders with an ``lx1_<n>`` level directory present."""
    orders = []
    for d in glob.glob(os.path.join(directory, "lx1_*")):
        m = re.fullmatch(r"lx1_(\d+)", os.path.basename(d))
        if m and int(m.group(1)) >= 2:
            orders.append(int(m.group(1)) - 1)
    return sorted(orders)


def _num_ranks(level_dir: str, poly_degree: int) -> int:
    pat = os.path.join(level_dir, f"size_*.{poly_degree}.dat")
    ranks = []
    for f in glob.glob(pat):
        m = re.fullmatch(rf"size_(\d+)\.{poly_degree}\.dat",
                         os.path.basename(f))
        if m:
            ranks.append(int(m.group(1)))
    if not ranks:
        raise FileNotFoundError(f"no size files match {pat}")
    P = max(ranks) + 1
    if sorted(ranks) != list(range(P)):
        raise FileNotFoundError(
            f"rank files are not contiguous in {level_dir}: {sorted(ranks)}")
    return P


def read_nek_dir(directory: str, poly_degree: int,
                 validate_geom: bool = False, device=None) -> GlobalMesh:
    """Read all ranks of one level directory into a single GlobalMesh.

    Global node ids are densely re-ranked to 0-based (the reference uses
    them only for matching, so any order-preserving relabel is
    equivalent). ``mass`` (w|J|), which the format does not carry, is
    recomputed from the coordinates by ``geometric_factors`` on
    ``device`` (None: the card). With ``validate_geom`` the read g_*
    factors are checked against those recomputed from the coordinates
    (exact for element maps in the SEM polynomial space, e.g. trilinear
    hexes).

    Returns a mesh with ``structured_layout=False``: nothing in the format
    says the elements form a lattice, so the generic paths are used.
    """
    level = _level_dir(directory, poly_degree)
    P = _num_ranks(level, poly_degree)

    dim = None
    coords_parts, glo_parts, deg_parts, mask_parts, geom_parts = \
        [], [], [], [], []
    for p in range(P):
        with open(_rank_file(level, "size", p, poly_degree)) as fh:
            vals = fh.read().split()
        d, E_p = int(vals[0]), int(vals[4])
        if dim is None:
            dim = d
        elif dim != d:
            raise ValueError(f"rank {p} dim {d} != {dim}")
        n = poly_degree + 1
        npe = n ** dim
        nG = 3 if dim == 2 else 6

        def rd(name, dtype, count=E_p * npe):
            path = _rank_file(level, name, p, poly_degree)
            arr = np.fromfile(path, dtype=dtype)
            if arr.size != count:
                raise ValueError(
                    f"{path}: expected {count} {np.dtype(dtype).name} "
                    f"values, found {arr.size}")
            return arr

        axes = [rd("xyz"[a], np.float64) for a in range(dim)]
        coords_parts.append(
            np.stack(axes, axis=-1).reshape(E_p, npe, dim))
        glo_parts.append(rd("glo_num", np.int64).reshape(E_p, npe))
        deg_parts.append(rd("node_degree", np.int32).reshape(E_p, npe))
        mask_parts.append(rd("p_mask", np.float64).reshape(E_p, npe))
        g = np.stack([rd(f"g_{k + 1}", np.float64) for k in range(nG)],
                     axis=-1)
        geom_parts.append(g.reshape(E_p, npe, nG))

    coords = np.concatenate(coords_parts)
    glo_raw = np.concatenate(glo_parts)
    node_degree = np.concatenate(deg_parts)
    mask = np.concatenate(mask_parts)
    geom = np.concatenate(geom_parts)
    E, npe = glo_raw.shape

    # dense 0-based ranking of the global ids
    uniq, inv = np.unique(glo_raw.ravel(), return_inverse=True)
    glo_num = inv.reshape(E, npe).astype(np.int64)

    # the file's node_degree must equal the recomputed multiplicity for a
    # whole-mesh read
    counts = np.bincount(glo_num.ravel(), minlength=uniq.size)
    if not np.array_equal(counts[glo_num], node_degree):
        raise ValueError(
            f"{level}: node_degree files disagree with glo_num "
            "multiplicities — partial export?")

    g_chk, mass = geometric_factors(coords, dim, poly_degree, device=device)
    if validate_geom:
        scale = max(1.0, float(np.abs(geom).max()))
        err = float(np.abs(g_chk - geom).max()) / scale
        if err > 1e-8:
            raise ValueError(
                f"{level}: g_* files disagree with factors recomputed "
                f"from coordinates (rel err {err:.2e}) — element maps "
                "outside the SEM space or mismatched quadrature")

    return GlobalMesh(
        dim=dim,
        poly_degree=poly_degree,
        elem_shape=(E,) + (1,) * (dim - 1),
        coords=coords,
        glo_num=glo_num,
        node_degree=node_degree,
        dirichlet_mask=mask,
        geom=geom,
        mass=mass,
        structured_layout=False,
    )


def nek_mesh_builder(directory: str, device=None):
    """A ``mesh_builder(order) -> GlobalMesh`` over a Nek export tree, as
    ``composite_dd`` takes one (one mesh a level from the same
    directory)."""
    return lambda order: read_nek_dir(directory, order, device=device)


def _rank_slices(E: int, P: int):
    """Balanced contiguous element chunks (the reference's per-rank files
    partition elements contiguously in Nek order)."""
    bounds = np.linspace(0, E, P + 1).round().astype(int)
    return [slice(bounds[p], bounds[p + 1]) for p in range(P)]


def write_nek_dir(directory: str, mesh: GlobalMesh,
                  num_ranks: int = 1) -> str:
    """Write one GlobalMesh as a reference-format level directory.

    Elements are split into ``num_ranks`` balanced contiguous chunks;
    global node ids are written 1-based (Nek convention). Returns the
    level directory path. Call once per order to build the tree the
    reference driver consumes::

        for o in (7, 1):
            write_nek_dir(path, mesh_builder(o), num_ranks=P)
    """
    N = mesh.poly_degree
    level = _level_dir(directory, N)
    os.makedirs(level, exist_ok=True)
    E = mesh.num_elements
    dim = mesh.dim
    n = N + 1
    nG = mesh.num_geom
    for p, sl in enumerate(_rank_slices(E, num_ranks)):
        E_p = sl.stop - sl.start
        with open(_rank_file(level, "size", p, N), "w") as fh:
            ns = [n, n, n if dim == 3 else 1]
            fh.write(f"{dim} {ns[0]} {ns[1]} {ns[2]} {E_p}\n")

        def wr(name, arr, dtype):
            arr.astype(dtype).tofile(_rank_file(level, name, p, N))

        for a in range(dim):
            wr("xyz"[a], mesh.coords[sl, :, a], np.float64)
        wr("glo_num", mesh.glo_num[sl] + 1, np.int64)
        wr("node_degree", mesh.node_degree[sl], np.int32)
        wr("p_mask", mesh.dirichlet_mask[sl], np.float64)
        for g in range(nG):
            wr(f"g_{g + 1}", mesh.geom[sl, :, g], np.float64)
    return level
