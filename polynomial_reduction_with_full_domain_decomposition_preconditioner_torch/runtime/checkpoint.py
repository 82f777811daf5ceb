"""Checkpoint / resume of expensive setup artifacts.

Port of the JAX package's ``runtime/checkpoint.py``, the same npz layouts,
so a file either package writes loads in the other with equal arrays:

- ``save_hierarchies`` / ``load_hierarchies``: the shards' composite FEM
  hierarchies (amg/composite.HostHierarchy), one compressed npz;
- ``save_mesh`` / ``load_mesh`` / ``cached_mesh_builder``: a GlobalMesh,
  raw npz (host numpy; a torch tensor field is saved as numpy);
- ``save_setup_payload`` / ``load_setup_payload``: a generic payload, a
  tree of dicts, lists and tuples over numpy arrays, scipy sparse
  matrices (saved as CSR) and python scalars, flattened into one raw npz
  plus a JSON structure descriptor, written atomically (a ``.tmp`` file,
  then ``os.replace``). The unstructured composite keeps its whole host
  setup this way (solvers/unstructured.py ``setup_cache``). The JAX
  package's BSR nodes have no counterpart here: a payload holding one
  raises;
- ``save_chain_info`` / ``load_chain_info``: the vertex chain of the
  structured composite's inner="amg" (amg/composite.coarsen_chain_info).
"""

from __future__ import annotations

import json
import os

import numpy as np
import scipy.sparse as sp

from ..amg.composite import HostHierarchy

__all__ = ["save_hierarchies", "load_hierarchies", "save_mesh", "load_mesh",
           "cached_mesh_builder", "save_chain_info", "load_chain_info",
           "save_setup_payload", "load_setup_payload"]


def _pack_csr(d: dict, key: str, m: sp.csr_matrix):
    d[f"{key}.data"] = m.data
    d[f"{key}.indices"] = m.indices
    d[f"{key}.indptr"] = m.indptr
    d[f"{key}.shape"] = np.asarray(m.shape)


def _unpack_csr(z, key: str) -> sp.csr_matrix:
    return sp.csr_matrix(
        (z[f"{key}.data"], z[f"{key}.indices"], z[f"{key}.indptr"]),
        shape=tuple(int(s) for s in z[f"{key}.shape"]))


def _host(a):
    """A numpy view of a mesh field (a torch tensor is copied to the
    host)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_hierarchies(path: str, hiers: list[HostHierarchy]):
    """Write per-shard composite hierarchies to ``path`` (.npz)."""
    d = {"num_shards": np.asarray(len(hiers)),
         "num_levels": np.asarray(len(hiers[0].mats))}
    for p, h in enumerate(hiers):
        for l, m in enumerate(h.mats):
            _pack_csr(d, f"s{p}.A{l}", m)
        for l, m in enumerate(h.prolongs):
            _pack_csr(d, f"s{p}.P{l}", m)
        _pack_csr(d, f"s{p}.Q", h.Q)
        d[f"s{p}.lmaxs"] = np.asarray(h.lmaxs)
        d[f"s{p}.coarse_inv"] = h.coarse_inv
        d[f"s{p}.dof_mask"] = h.dof_mask
    np.savez_compressed(path, **d)


def load_hierarchies(path: str) -> list[HostHierarchy]:
    with np.load(path) as z:
        P = int(z["num_shards"])
        L = int(z["num_levels"])
        return [HostHierarchy(
            mats=[_unpack_csr(z, f"s{p}.A{l}") for l in range(L)],
            prolongs=[_unpack_csr(z, f"s{p}.P{l}") for l in range(L - 1)],
            lmaxs=list(z[f"s{p}.lmaxs"]),
            coarse_inv=z[f"s{p}.coarse_inv"],
            Q=_unpack_csr(z, f"s{p}.Q"),
            dof_mask=z[f"s{p}.dof_mask"]) for p in range(P)]


def save_mesh(path: str, mesh):
    # uncompressed: a large mesh is gigabytes of float64 that zlib would
    # make slow to load; a raw npz reads at disk speed
    np.savez(
        path, dim=np.asarray(mesh.dim),
        poly_degree=np.asarray(mesh.poly_degree),
        elem_shape=np.asarray(mesh.elem_shape),
        coords=_host(mesh.coords), glo_num=_host(mesh.glo_num),
        node_degree=_host(mesh.node_degree),
        dirichlet_mask=_host(mesh.dirichlet_mask),
        geom=_host(mesh.geom), mass=_host(mesh.mass),
        structured_layout=np.asarray(mesh.structured_layout))


def load_mesh(path: str):
    """The GlobalMesh ``save_mesh`` wrote (either package's), as host
    numpy arrays like every GlobalMesh of the port."""
    from ..mesh.generator import GlobalMesh
    with np.load(path) as z:
        return GlobalMesh(
            dim=int(z["dim"]), poly_degree=int(z["poly_degree"]),
            elem_shape=tuple(int(x) for x in z["elem_shape"]),
            coords=z["coords"], glo_num=z["glo_num"],
            node_degree=z["node_degree"], dirichlet_mask=z["dirichlet_mask"],
            geom=z["geom"], mass=z["mass"],
            structured_layout=bool(z["structured_layout"]))


def cached_mesh_builder(builder, directory: str, tag: str):
    """Wrap mesh_builder(order) with an npz cache under ``directory``.
    The tag must encode every mesh parameter; orders are cached
    independently as they are built."""
    os.makedirs(directory, exist_ok=True)

    def cached(order: int):
        path = os.path.join(directory, f"mesh_{tag}_N{order}.npz")
        if os.path.exists(path):
            return load_mesh(path)
        mesh = builder(order)
        save_mesh(path, mesh)
        return mesh

    return cached


# ---------------------------------------------------------------------------
# generic host-setup payload: one raw npz (compression off, as save_mesh)
# plus a JSON structure descriptor


def _enc(obj, arrays: dict, pfx: str):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "lit", "v": obj}
    if isinstance(obj, np.generic):
        return {"t": "lit", "v": obj.item()}
    if isinstance(obj, np.ndarray):
        arrays[pfx] = obj
        return {"t": "arr", "k": pfx}
    if sp.issparse(obj):
        _pack_csr(arrays, pfx, sp.csr_matrix(obj))
        return {"t": "csr", "k": pfx}
    if isinstance(obj, dict):
        return {"t": "dict",
                "items": [[k, _enc(v, arrays, f"{pfx}.{k}")]
                          for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        return {"t": "list" if isinstance(obj, list) else "tuple",
                "items": [_enc(v, arrays, f"{pfx}.{i}")
                          for i, v in enumerate(obj)]}
    raise TypeError(f"unsupported payload node {type(obj)} at {pfx}")


def _dec(node, z):
    t = node["t"]
    if t == "lit":
        return node["v"]
    if t == "arr":
        return z[node["k"]]
    if t == "csr":
        return _unpack_csr(z, node["k"])
    if t == "dict":
        return {k: _dec(v, z) for k, v in node["items"]}
    if t == "list":
        return [_dec(v, z) for v in node["items"]]
    if t == "tuple":
        return tuple(_dec(v, z) for v in node["items"])
    if t == "bsr":
        raise ValueError(
            f"payload node {node['k']!r} is a BSR matrix, which only the "
            "JAX package writes: the port's payloads hold CSR")
    raise TypeError(f"bad payload node {t}")


def save_setup_payload(path: str, payload):
    arrays = {}
    struct = _enc(payload, arrays, "r")
    arrays["__struct__"] = np.frombuffer(
        json.dumps(struct).encode(), dtype=np.uint8).copy()
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_setup_payload(path: str):
    with np.load(path) as z:
        struct = json.loads(bytes(z["__struct__"]).decode())
        return _dec(struct, z)


def save_chain_info(path: str, info: dict):
    """Vertex-chain checkpoint (amg/composite.coarsen_chain_info output:
    level CSRs, transfer factors, masks, Chebyshev bounds, dense coarse
    inverse), compressed npz."""
    d = {"num_levels": np.asarray(len(info["mats"])),
         "lmaxs": np.asarray(info["lmaxs"]),
         "coarse_inv": info["coarse_inv"]}
    for l, m in enumerate(info["mats"]):
        _pack_csr(d, f"A{l}", m.tocsr())
    for l, m in enumerate(info["prolongs"]):
        _pack_csr(d, f"P{l}", m.tocsr())
    for l, s in enumerate(info["shapes"]):
        d[f"shape{l}"] = np.asarray(s)
    for l, m in enumerate(info["masks"]):
        d[f"mask{l}"] = m
    for l, fs in enumerate(info["factors"]):
        for k, F in enumerate(fs):
            d[f"fac{l}.{k}"] = F
    np.savez_compressed(path, **d)


def load_chain_info(path: str) -> dict:
    with np.load(path) as z:
        L = int(z["num_levels"])
        dim = len(z["shape0"])
        return {
            "mats": [_unpack_csr(z, f"A{l}") for l in range(L)],
            "prolongs": [_unpack_csr(z, f"P{l}") for l in range(L - 1)],
            "shapes": [tuple(int(x) for x in z[f"shape{l}"])
                       for l in range(L)],
            "masks": [z[f"mask{l}"] for l in range(L)],
            "factors": [[z[f"fac{l}.{k}"] for k in range(dim)]
                        for l in range(L - 1)],
            "lmaxs": list(z["lmaxs"]),
            "coarse_inv": z["coarse_inv"],
        }
