"""Field output: npz and legacy-VTK export.

Port of the JAX package's ``io/fields.py`` (``save_fields``,
``save_vtk``): the reference's Silo output (per-element node meshes with
the u*, f and u variables gathered to rank 0) as dependency-free formats,
compressed npz (lossless, reads back through numpy) and legacy ASCII VTK
unstructured grids (ParaView / VisIt). Host numpy on the values of
``Domain.from_device_field``. The composite-region dump
(``save_composite_fields``) is ROADMAP item 15b.
"""

from __future__ import annotations

import numpy as np

__all__ = ["save_fields", "save_vtk"]

_TITLE = ("polynomial_reduction_with_full_domain_decomposition_"
          "preconditioner_torch fields")


def save_fields(path: str, dom, **fields):
    """Write fields + coordinates to ``path`` (npz if it ends with .npz,
    legacy VTK if .vtk). Fields are device tensors in the domain's
    layout; they are written as element-ordered host values of the owned
    shards, (owned, E*npe)."""
    host = {k: dom.from_device_field(v) for k, v in fields.items()}
    coords = dom.sharded.coords  # (P, E, npe, dim)
    if path.endswith(".vtk"):
        save_vtk(path, dom, host)
        return
    np.savez_compressed(
        path if path.endswith(".npz") else path + ".npz",
        coords=coords,
        elem_valid=dom.sharded.elem_valid,
        poly_degree=dom.poly_degree,
        dim=dom.dim,
        **host)


def save_vtk(path: str, dom, host_fields: dict):
    """Legacy ASCII VTK: every SEM element becomes N^dim linear quad /
    hex sub-cells on its GLL nodes (the sub-cell mesh the reference builds
    for Silo)."""
    sd = dom.sharded
    dim = dom.dim
    n = dom.poly_degree + 1
    coords = sd.coords.reshape(-1, sd.coords.shape[-1])
    valid = np.repeat(sd.elem_valid.reshape(-1), sd.num_points_per_elem)
    pts = coords[valid]
    npe = sd.num_points_per_elem
    E = int(sd.elem_valid.sum())

    # sub-cell connectivity within one element (local lattice i fastest)
    def local_id(k, j, i):
        return (k * n + j) * n + i if dim == 3 else j * n + i

    cells = []
    rng = range(n - 1)
    if dim == 3:
        for k in rng:
            for j in rng:
                for i in rng:
                    cells.append([local_id(k, j, i), local_id(k, j, i + 1),
                                  local_id(k, j + 1, i + 1),
                                  local_id(k, j + 1, i),
                                  local_id(k + 1, j, i),
                                  local_id(k + 1, j, i + 1),
                                  local_id(k + 1, j + 1, i + 1),
                                  local_id(k + 1, j + 1, i)])
        cell_type = 12  # VTK_HEXAHEDRON
    else:
        for j in rng:
            for i in rng:
                cells.append([local_id(0, j, i), local_id(0, j, i + 1),
                              local_id(0, j + 1, i + 1),
                              local_id(0, j + 1, i)])
        cell_type = 9   # VTK_QUAD
    cells = np.asarray(cells)

    with open(path, "w") as fh:
        fh.write(f"# vtk DataFile Version 3.0\n{_TITLE}\nASCII\n"
                 "DATASET UNSTRUCTURED_GRID\n")
        fh.write(f"POINTS {pts.shape[0]} double\n")
        p3 = np.zeros((pts.shape[0], 3))
        p3[:, :dim] = pts
        np.savetxt(fh, p3, fmt="%.10g")
        ncell = E * cells.shape[0]
        fh.write(f"CELLS {ncell} {ncell * (cells.shape[1] + 1)}\n")
        all_cells = (cells[None, :, :]
                     + (np.arange(E) * npe)[:, None, None]
                     ).reshape(-1, cells.shape[1])
        conn = np.column_stack(
            [np.full(all_cells.shape[0], cells.shape[1]), all_cells])
        np.savetxt(fh, conn, fmt="%d")
        fh.write(f"CELL_TYPES {ncell}\n")
        np.savetxt(fh, np.full(ncell, cell_type, dtype=np.int64), fmt="%d")
        fh.write(f"POINT_DATA {pts.shape[0]}\n")
        for name, vals in host_fields.items():
            fh.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
            np.savetxt(fh, np.asarray(vals).reshape(-1)[valid], fmt="%.10g")
