"""The NumPy host modules carried into su2_tpu_torch give outputs identical
to the su2_tpu originals on the synthetic case; su2_tpu_torch imports no
JAX and no su2_tpu module."""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "su2_tpu_torch")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_case")
    return str(d), th.write_case(d)


def _equal(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and not np.isscalar(a):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, np.asarray(b)), where
    else:
        assert a == b, where


def _fields(obj):
    return {k: v for k, v in vars(obj).items() if not callable(v)}


def test_config_values_identical(case):
    from su2_tpu.config import Config as JC
    from su2_tpu_torch.config import Config as TC
    _equal(_fields(JC(text=case[1])), _fields(TC(text=case[1])), "cfg")


@pytest.mark.parametrize("backward_rate", [False, True])
def test_tables_identical(tmp_path, backward_rate):
    from su2_tpu.io import tables as jt
    from su2_tpu_torch.io import tables as tt_
    man = th.cases.write_library(str(tmp_path), backward_rate)
    a, b = jt.read_manifest(man), tt_.read_manifest(man)
    _equal(vars(a.mixture), vars(b.mixture), "mixture")
    _equal(vars(a.chemistry), vars(b.chemistry), "chemistry")
    assert bool(b.chemistry.has_backward[1]) == backward_rate
    for x, y in zip(a.transport + a.thermo, b.transport + b.thermo):
        _equal(vars(x), vars(y), x.name)


@pytest.fixture(scope="module")
def grids():
    from su2_tpu.geometry import dual_grid as jd, structured as js
    from su2_tpu_torch.geometry import dual_grid as td, structured as ts
    ra, rb = js.channel_mesh(*th.CHANNEL), ts.channel_mesh(*th.CHANNEL)
    _equal(vars(ra), vars(rb), "raw mesh")
    return jd.build_dual_grid(ra), td.build_dual_grid(rb)


def test_dual_grid_identical(grids):
    _equal(vars(grids[0]), vars(grids[1]), "dual grid")


def test_stencil_identical(grids):
    from su2_tpu.geometry import stencil as js
    from su2_tpu_torch.geometry import stencil as ts
    ga, gb = grids
    oa, ob = js.edge_offsets(ga.edges), ts.edge_offsets(gb.edges)
    assert np.array_equal(oa, ob)
    offs = tuple(int(o) for o in oa)
    assert np.array_equal(js.stencil_select(ga.edges, ga.npoint, offs),
                          ts.stencil_select(gb.edges, gb.npoint, offs))


def test_mesh_arrays_identical(grids):
    """The JAX MeshArrays carried through convert.mesh_from_numpy equal the
    port's own mesh_arrays on the same dual grid (stencil_sel, WLS and
    family geometry included)."""
    from su2_tpu.geometry.mesh_data import mesh_arrays as jm
    from su2_tpu_torch.convert import mesh_from_numpy
    from su2_tpu_torch.geometry.mesh_data import mesh_arrays as tm
    ja = jm(grids[0], jnp.float64)
    d = {k: getattr(ja, k) for k in (
        "ndim", "npoint", "nedge", "max_degree", "coords", "volume", "edges",
        "edge_normal", "edge_area", "node_edges", "node_sign", "n_neighbors",
        "bnd_accum_normal", "node_edges_t", "node_sign_t", "node_nbrs",
        "nbr_mask", "node_edges_sel", "stencil_sel",
        "stencil_offsets", "wls_coeff", "gg_snormal", "stencil_pvec",
        "fam_normal", "fam_evec", "fam_offsets")}
    d["markers"] = {t: (np.asarray(a), np.asarray(b))
                    for t, (a, b) in ja.markers.items()}
    d["marker_nn"] = {t: np.asarray(a) for t, a in ja.marker_nn.items()}
    got = mesh_from_numpy({k: (np.asarray(v) if hasattr(v, "shape") else v)
                           for k, v in d.items()})
    want = tm(grids[1])
    for k, v in vars(want).items():
        g = getattr(got, k)
        if isinstance(v, torch.Tensor):
            assert torch.equal(g, v), k
        elif isinstance(v, dict):
            for t in v:
                gx, vx = g[t], v[t]
                pairs = zip(gx, vx) if isinstance(vx, tuple) else [(gx, vx)]
                for x, y in pairs:
                    assert torch.equal(x, y), (k, t)
        else:
            assert g == v, k


def test_wall_distance_identical(grids):
    from su2_tpu.turbulence.sst import wall_distance as jw
    from su2_tpu_torch.turbulence.sst import wall_distance as tw
    g = grids[0]
    pts = np.concatenate([g.coords[g.bnd_nodes[t]]
                          for t in ("lower_wall", "upper_wall")])
    assert np.array_equal(jw(g.coords, pts), tw(g.coords, pts))


def test_spline_and_host_scalars_identical(case):
    from su2_tpu.chemistry import host as jh, library as jl
    from su2_tpu.chemistry.spline import spline_second_derivatives as js2
    from su2_tpu_torch.chemistry import host as thh, library as tl
    from su2_tpu_torch.chemistry.spline import spline_second_derivatives as ts2
    man = os.path.join(case[0], "manifest.txt")
    x = th.cases.T_GRID
    y = np.random.default_rng(0).normal(size=(3, x.shape[0]))
    assert np.array_equal(js2(x, y), ts2(x, y))
    ja, tb = jl.load_library(man), tl.load_library(man)
    ys = [0.1, 0.05, 0.6, 0.05, 0.1, 0.02, 0.03, 0.02, 0.03]
    assert jh.freestream_scalars(ja, 1234.5, ys) \
        == thh.freestream_scalars(tb, 1234.5, ys)


@pytest.mark.parametrize("backward_rate", [False, True])
def test_chemlib_convert_matches_build(tmp_path, backward_rate):
    """convert.chemlib_from_numpy(JAX ChemLib) == the port's load_library
    on the same files."""
    from su2_tpu.chemistry import library as jl
    from su2_tpu_torch.chemistry import library as tl
    from su2_tpu_torch.convert import chemlib_from_numpy
    man = th.cases.write_library(str(tmp_path), backward_rate)
    got = chemlib_from_numpy(th.chemlib_numpy(jl.load_library(man)))
    want = tl.load_library(man)
    for k, v in vars(want).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(getattr(got, k), v), k
        else:
            assert getattr(got, k) == v, k


def test_su2_mesh_io_identical(tmp_path):
    from su2_tpu.io import mesh as jm
    from su2_tpu_torch.geometry.structured import channel_mesh
    from su2_tpu_torch.io import mesh as tm
    path = str(tmp_path / "channel.su2")
    tm.write_su2_mesh(channel_mesh(*th.CHANNEL), path)
    _equal(vars(jm.read_su2_mesh(path)), vars(tm.read_su2_mesh(path)), "su2")


def test_port_imports_no_jax():
    """AST scan: no module of su2_tpu_torch, and not chip_smoke.py, imports
    jax or su2_tpu."""
    bad = []
    paths = [os.path.join(os.path.dirname(PORT), "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, name) for name in files
                  if name.endswith(".py")]
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "su2_tpu"):
                    bad.append(f"{path}: {m}")
    assert not bad, bad
