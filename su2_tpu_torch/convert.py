"""Carry state from the JAX package into the port.

Every function takes the JAX package's pytree leaves as numpy arrays, with
the static metadata (t0, dt, nt, nspecies, ...) as plain values, and
returns the port's tensors.  Nothing here imports JAX: the caller turns
its arrays into numpy (np.asarray) first.
"""

from __future__ import annotations

import numpy as np
import torch

from su2_tpu_torch.chemistry.library import _TABLE_FIELDS, ChemLib
from su2_tpu_torch.geometry.mesh_data import MeshArrays

_META = ("t0", "dt", "nt", "nspecies", "nreactions", "species")


def _t(x, dtype, device, integer=False):
    a = np.asarray(x)
    t = torch.as_tensor(a.astype(np.int64) if integer else
                        a.astype(np.float64))
    return t.to(device=device, dtype=None if integer else dtype)


def chemlib_from_numpy(d: dict, dtype=torch.float64,
                       device="cpu") -> ChemLib:
    """ChemLib from a dict of the JAX ChemLib's fields (tables as numpy
    arrays, metadata as plain values)."""
    return ChemLib(**{k: _t(d[k], dtype, device) for k in _TABLE_FIELDS},
                   **{k: (tuple(d[k]) if k == "species" else d[k])
                      for k in _META})


def mesh_from_numpy(d: dict, dtype=torch.float64, device="cpu") -> MeshArrays:
    """MeshArrays from a dict of the JAX MeshArrays' fields: numpy leaves
    (markers as tag -> (nodes, normal)), plus ndim, npoint, nedge,
    max_degree, stencil_offsets and fam_offsets.  The zero-padded marker
    fields and the viscous area^2 weight are derived from the markers."""
    f = lambda x: _t(x, dtype, device)
    i = lambda x: _t(x, dtype, device, integer=True)
    n = int(d["npoint"])
    dense = {}
    w2 = np.zeros((n,), np.float64)
    for tag, (nodes, normal) in d["markers"].items():
        nodes = np.asarray(nodes, np.int64)
        nm = np.asarray(normal, np.float64)
        ndn = np.zeros((n, nm.shape[1]))
        ndn[nodes] = nm
        ad = np.zeros((n,))
        ad[nodes] = np.linalg.norm(nm, axis=1)
        dense[tag] = (f(ndn), f(ad))
        np.add.at(w2, nodes, np.sum(nm ** 2, axis=1))
    return MeshArrays(
        ndim=int(d["ndim"]), npoint=n, nedge=int(d["nedge"]),
        max_degree=int(d["max_degree"]),
        coords=f(d["coords"]), volume=f(d["volume"]), edges=i(d["edges"]),
        edge_normal=f(d["edge_normal"]), edge_area=f(d["edge_area"]),
        node_edges=i(d["node_edges"]), node_sign=f(d["node_sign"]),
        n_neighbors=i(d["n_neighbors"]),
        bnd_accum_normal=f(d["bnd_accum_normal"]),
        markers={t: (i(a), f(b)) for t, (a, b) in d["markers"].items()},
        marker_nn={t: i(a) for t, a in d["marker_nn"].items()},
        marker_dense=dense,
        node_edges_t=i(d["node_edges_t"]), node_sign_t=f(d["node_sign_t"]),
        stencil_sel=i(d["stencil_sel"]),
        stencil_offsets=tuple(int(o) for o in d["stencil_offsets"]),
        wls_coeff=f(d["wls_coeff"]), gg_snormal=f(d["gg_snormal"]),
        stencil_pvec=f(d["stencil_pvec"]), fam_normal=f(d["fam_normal"]),
        fam_evec=f(d["fam_evec"]),
        fam_offsets=tuple(int(o) for o in d["fam_offsets"]),
        visc_w2=f(w2))


def state_from_numpy(u, t, q, mu_t, grad_k, sigma_k, dtype=torch.float64,
                     device="cpu"):
    """The coupled step's carry (u, t_guess, q, mu_t, grad_k, sigma_k) as
    tensors."""
    return tuple(_t(x, dtype, device) for x in (u, t, q, mu_t, grad_k,
                                                sigma_k))
