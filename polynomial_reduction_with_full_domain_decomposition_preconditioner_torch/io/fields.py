"""Field output: npz and legacy-VTK export.

Port of the JAX package's ``io/fields.py`` (``save_fields``,
``save_vtk``, ``save_composite_fields``): the reference's Silo output
(per-element node meshes with the u*, f and u variables gathered to rank
0, and the composite's subdomain / superdomain fields) as
dependency-free formats, compressed npz (lossless, reads back through
numpy) and legacy ASCII VTK unstructured grids (ParaView / VisIt). Host
numpy on the values of ``Domain.from_device_field``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_fields", "save_vtk", "save_composite_fields"]

_TITLE = ("polynomial_reduction_with_full_domain_decomposition_"
          "preconditioner_torch fields")


def _host(t):
    """A device tensor as numpy, bf16 as the JAX package's npz holds it:
    the same bits in 2-byte void records (numpy has no bfloat16, and
    np.savez of an ml_dtypes bfloat16 array writes "|V2")."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def save_composite_fields(path: str, dom, pre, mesh_builder, r):
    """Dump the composite's region fields for visualization, the
    reference's subdomain / superdomain output: the composite right-hand
    side tree_rhs(r) that the inner solve sees, one array a group (or
    class), with nodal coordinates regenerated by ``mesh_builder`` at each
    group's order (left out for a z-merged far group).

    One shard writes one npz; P > 1 shards write one npz per owned shard
    with the suffix ``_s{p}``, in one process or across processes (each
    process its own shards). Each shard's composite covers the whole
    domain. Keys: kind, orders, group{i}_values / _order / _coords, and
    sup_values for the unstructured superdomain vector. Returns the dict
    written (the last shard's)."""
    info = pre.region_info
    if info is None:
        raise ValueError("preconditioner carries no region_info (cached "
                         "unstructured setups skip it — rebuild without "
                         "the setup cache to dump regions)")
    fn = pre.build(dom.arrays, pre.extra, dom._ops())
    host = [_host(p) for p in fn.parts["tree_rhs"](r)]
    if dom.spmd:
        shard_sets = [(p, [h[k] for h in host])
                      for k, p in enumerate(dom.owned)]
    elif info["kind"] == "unstructured":
        # one shard's class stacks still carry the shard axis
        shard_sets = [(None, [h[0] for h in host])]
    else:
        shard_sets = [(None, host)]

    mesh_cache = {}

    def mesh_at(o):
        if o not in mesh_cache:
            mesh_cache[o] = mesh_builder(o)
        return mesh_cache[o]

    base = path[:-4] if path.endswith(".npz") else path
    for p, parts in shard_sets:
        out = {"kind": info["kind"], "orders": np.asarray(info["orders"])}
        key = sorted(info["phys" if info["kind"] == "structured"
                     else "elems"])[0] if p is None else p
        if info["kind"] == "structured":
            from ..mesh.layout import elements_to_lattice
            plane_shape = tuple(info["plane_shape"])
            plane = int(np.prod(plane_shape))
            phys = info["phys"][key]
            for gi, o in enumerate(info["orders"]):
                vals = parts[gi]
                out[f"group{gi}_values"] = vals
                out[f"group{gi}_order"] = o
                if info["zcoarse"][gi] != 1:
                    continue    # z-merged far mesh: geometry not dumped
                mesh_o = mesh_at(o)
                n_o = o + 1
                rows = []
                for q in phys[gi]:
                    if q < 0:
                        rows.append(np.zeros((n_o,) + vals.shape[1:]
                                             + (dom.dim,)))
                        continue
                    rows.append(elements_to_lattice(
                        mesh_o.coords[q * plane:(q + 1) * plane],
                        (1,) + plane_shape, n_o, dom.dim))
                out[f"group{gi}_coords"] = np.concatenate(rows, axis=0)
        else:
            C = len(info["orders"])
            elems = info["elems"][key]
            for c, o in enumerate(info["orders"]):
                out[f"group{c}_values"] = parts[c]
                out[f"group{c}_order"] = o
                e = elems[c]
                safe = np.where(e >= 0, e, 0)
                out[f"group{c}_coords"] = (mesh_at(o).coords[safe]
                                           * (e >= 0)[:, None, None])
            if len(parts) > C:
                # the superdomain vector, flat as the JAX package's
                out["sup_values"] = parts[C].reshape(-1)
        fname = f"{base}.npz" if p is None else f"{base}_s{p}.npz"
        np.savez_compressed(fname, **out)
    return out


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
