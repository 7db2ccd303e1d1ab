"""The port's solution output, restart and force monitoring against
su2_tpu's on the 153-node synthetic channel in float64 (explicit RANS,
JACOBI): (a) each writer, the force integration and the CGNS mesh reader
on the same numpy inputs; (b) write_solution in every OUTPUT_FORMAT on a
mesh file whose node order is not stencil order; (c) RESTART_SOL; (d)
MARKER_MONITORING: monitor_forces, the history's force columns and
forces_breakdown.dat; (e) CONV_CRITERIA= CAUCHY; (f) the iterations the
WRT_SOL_FREQ writes come after; (g) the CLI's files.

Numbers compare at |port - su2_tpu| <= RTOL |su2_tpu| + ATOL_FRAC
max|su2_tpu's column|.  A number printed in a text file also keeps one
unit of its format's last significant digit (two values within the
tolerance can round to neighbouring decimals); everything else in a file
is byte for byte su2_tpu's.  A force coefficient's scale is at least
th.force_scale's (the state's atol on the pressure, carried through the
force integration)."""

import os
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL_FRAC = 1e-12, 1e-12
# the mixed start of the implicit comparison (test_torch_multistep)
MIXED_YS = (0.01, 0.1, 0.59, 0.05, 0.15, 0.02, 0.03, 0.03, 0.02)
# OUTPUT_FORMAT -> the volume file write_solution writes
VOLUME = {"TECPLOT": "flow.dat", "TECPLOT_BINARY": "flow.plt",
          "PARAVIEW": "flow.vtk", "FIELDVIEW": "flow.uns",
          "CGNS_SOL": "flow.cgns"}
# the history file's force columns (after "Iteration") and its wall clock
# Time(min) (the RANS case's last)
FORCE_COLUMNS = range(1, 13)
TIME_COLUMN = 22
WALL = "( lower_wall )"


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    return th.with_prec(th.write_case(tmp_path_factory.mktemp("output")),
                        "JACOBI")


def shuffled_channel(seed=3):
    """The channel with its nodes in a seeded random order (not stencil
    order): (su2_tpu's RawMesh, the port's)."""
    from su2_tpu_torch.driver import _permute_raw_mesh
    from su2_tpu_torch.geometry.structured import channel_mesh
    raw = channel_mesh(*th.CHANNEL)
    raw = _permute_raw_mesh(
        raw, np.random.default_rng(seed).permutation(raw.npoint))
    return th.jax_raw(raw), raw


def make_sims(text, mesh=None):
    """(su2_tpu Simulation, port Simulation on the CPU) of text in
    float64, on mesh ((su2_tpu's RawMesh, the port's); None: the
    channel)."""
    from su2_tpu.config import Config as JConfig
    from su2_tpu.driver import Simulation as JSimulation
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    if mesh is None:
        return th.jax_sim(text), th.torch_sim(text)
    return (JSimulation(JConfig(text=text), dtype=jnp.float64,
                        raw_mesh=mesh[0]),
            Simulation(Config(text=text), raw_mesh=mesh[1],
                       dtype=torch.float64, device="cpu"))


def turb_pair(out):
    """(q, mu_t) of a RANS run's result."""
    return (out[3][0], out[3][1])


# ----------------------------------------------------------------------
# comparison of files

NUMBER = re.compile(r"(?<![\w\"\[.])[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"
                    r"(?![\w\"])")
INTEGER = re.compile(r"-?\d+")
# significant digits of each text file's numbers (its writer's format)
DIGITS = {"restart_flow.dat": 15, "flow.dat": 7, "surface_flow.dat": 7,
          "flow.vtk": 7, "flow.uns": 16, "history.dat": 10,
          "forces_breakdown.dat": 6}


def tokens(text, nblock=None):
    """(skeleton, [(column key, token)]): the text with each number
    replaced by '#', and the numbers.  A number's column is its position
    in its line under the last line holding a word (the block's header);
    nblock splits a block of one-number lines into columns of nblock
    lines (FieldView's variables)."""
    skel, nums = [], []
    block, count = "", 0
    for line in text.splitlines():
        found = NUMBER.findall(line)
        bare = NUMBER.sub("#", line)
        skel.append(bare)
        header = bool(re.search(r"[A-Za-z]{2}", bare)) \
            and "LOOKUP_TABLE" not in bare
        if header:
            block, count = bare, 0
        for pos, tok in enumerate(found):
            col = pos if nblock is None or header or len(found) > 1 \
                else count // nblock
            nums.append(((block, len(found), col), tok))
        if not header:
            count += 1
    return "\n".join(skel), nums


def assert_text_close(got, want, digits, nblock=None, floor=None,
                      skip=()):
    """The text got is want's but for its numbers: integers equal, the
    others at the tolerance plus one unit of their digits-th significant
    digit (floor: {column position: least scale}; skip: column positions
    left out)."""
    gs, gn = tokens(got, nblock)
    ws, wn = tokens(want, nblock)
    assert gs == ws
    scale = {}
    for key, tok in wn:
        scale[key] = max(scale.get(key, 0.0), abs(float(tok)))
    for (key, g), (_, w) in zip(gn, wn):
        if key[2] in skip:
            continue
        if INTEGER.fullmatch(g) and INTEGER.fullmatch(w):
            assert g == w, (key, g, w)
            continue
        gv, wv = float(g), float(w)
        big = max(abs(gv), abs(wv))
        unit = 10.0 ** (np.floor(np.log10(big)) + 1 - digits) if big else 0
        sc = max(scale[key], (floor or {}).get(key[2], 0.0))
        assert abs(gv - wv) <= RTOL * abs(wv) + ATOL_FRAC * sc + unit, \
            (key, g, w)


def assert_arrays_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if not np.issubdtype(want.dtype, np.floating):
        assert np.array_equal(got, want), name
        return
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_FRAC * np.abs(want).max(),
                               err_msg=name)


def assert_tecplot_binary_close(got, want, npoint, nelem):
    """Header and connectivity byte for byte; the min/max pairs and the
    block-packed columns at the tolerance."""
    ints = np.frombuffer(want, "<i4", offset=8)
    title = int(np.argmax(ints[2:] == 0))       # the title's characters
    ncols = int(ints[2 + title + 1])
    nconn, ndata = 16 * nelem, 8 * ncols * npoint
    head = len(want) - nconn - ndata - 16 * ncols
    assert len(got) == len(want) and got[:head] == want[:head]
    assert got[len(got) - nconn:] == want[len(want) - nconn:]
    for off, shape in ((head, (ncols, 2)), (head + 16 * ncols,
                                            (ncols, npoint))):
        n = shape[0] * shape[1]
        g = np.frombuffer(got, "<f8", n, off).reshape(shape)
        w = np.frombuffer(want, "<f8", n, off).reshape(shape)
        for k in range(ncols):
            assert_arrays_close(g[k], w[k], f"column {k}")


def cgns_tree(path):
    """{HDF5 path: (attributes, dataset or None)} of a CGNS file."""
    import h5py
    out = {}

    def visit(name, obj):
        attrs = {k: np.asarray(v).tobytes() for k, v in obj.attrs.items()}
        data = obj[()] if isinstance(obj, h5py.Dataset) else None
        out[name] = (attrs, data)
    with h5py.File(path, "r") as f:
        out[""] = ({k: np.asarray(v).tobytes() for k, v in f.attrs.items()},
                   None)
        f.visititems(visit)
    return out


def assert_cgns_close(got, want):
    g, w = cgns_tree(got), cgns_tree(want)
    assert g.keys() == w.keys()
    for name in w:
        assert g[name][0] == w[name][0], name
        if w[name][1] is not None:
            assert_arrays_close(g[name][1], w[name][1], name)


def assert_file_close(got, want, npoint, nelem):
    """The files got and want (by extension) as the module docstring
    compares them."""
    ext = os.path.splitext(want)[1]
    if ext == ".cgns":
        return assert_cgns_close(got, want)
    with open(got, "rb") as f:
        gb = f.read()
    with open(want, "rb") as f:
        wb = f.read()
    if ext == ".plt":
        return assert_tecplot_binary_close(gb, wb, npoint, nelem)
    assert_text_close(gb.decode(), wb.decode(),
                      DIGITS[os.path.basename(want)],
                      nblock=2 * npoint if ext == ".uns" else None)


def assert_forces_close(got, want, scale, where="forces"):
    """monitor_forces' dicts (totals, splits, per_marker) at rtol and
    ATOL_FRAC * scale."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            assert_forces_close(got[k], want[k], scale, f"{where}.{k}")
    elif isinstance(want, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            assert_forces_close(g, w, scale, f"{where}[{i}]")
    else:
        assert abs(float(got) - float(want)) \
            <= RTOL * abs(float(want)) + ATOL_FRAC * scale, \
            (where, float(got), float(want))


# ----------------------------------------------------------------------
# (a) the writers, the force integration and the CGNS mesh reader

def writer_inputs(seed=5):
    """The channel and numpy fields as a write_solution hands them over:
    a surface node set, forces_breakdown's dicts."""
    from types import SimpleNamespace
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.geometry.structured import channel_mesh
    raw = channel_mesh(*th.CHANNEL)
    rng = np.random.default_rng(seed)
    n = raw.npoint
    names = ([f"Conservative_{k + 1}" for k in range(13)]
             + ["Pressure", "Temperature", "Mach", "Y_C4H6", "Y_O2",
                "Laminar_Viscosity", "Turb_Kin_Energy", "Omega",
                "Eddy_Viscosity"])
    fields = {k: rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6)
              for k in names}
    nodes = np.unique(np.concatenate([raw.markers[t].ravel()
                                      for t in ("lower_wall", "outlet")]))
    cfg = Config(text="MARKER_MONITORING= ( lower_wall )")
    return SimpleNamespace(raw=raw, fields=fields, nodes=nodes,
                           turb=rng.standard_normal((n, 2)), cfg=cfg,
                           u=rng.standard_normal((n, 13)), rng=rng)


def force_inputs(x):
    """surface_forces' arguments of both packages on random rows: the
    channel's two walls (su2_tpu: the whole field and its node ids; the
    port: the rows at the markers' nodes, numbered into them)."""
    from types import SimpleNamespace
    from su2_tpu_torch.geometry.dual_grid import build_dual_grid
    from su2_tpu_torch.state import Layout
    grid = build_dual_grid(x.raw)
    lay, n, rng = Layout(2, 9), x.raw.npoint, x.rng
    v = rng.uniform(0.5, 2.0, (n, lay.nprim)) * 1e3
    v[:, lay.P] = 101325.0 + rng.standard_normal(n) * 50.0
    grad = rng.standard_normal((n, lay.ndim + 1 + lay.ns + 1, 2))
    mu, kappa, mu_t = (rng.uniform(1e-5, 1e-4, n) for _ in range(3))
    tags = ("lower_wall", "upper_wall")
    jmark = {t: (grid.bnd_nodes[t], grid.bnd_normal[t], grid.bnd_nn[t])
             for t in tags}
    nodes = np.unique(np.concatenate([grid.bnd_nodes[t] for t in tags]))
    tmark = {t: (np.searchsorted(nodes, grid.bnd_nodes[t]),
                 grid.bnd_normal[t]) for t in tags}
    common = dict(lay=lay, p_inf=101325.0, rho_inf=0.3,
                  vel_inf=np.array([12.0, 0.0]),
                  ref_area=1.0, viscous=True, origin=(0.25, 0.0, 0.0),
                  ref_len=1.0, aoa_deg=3.0)
    jargs = dict(mesh=None, v=v, grad=grad,
                 trans=SimpleNamespace(mu=mu, kappa=kappa), markers=jmark,
                 mu_t=mu_t, coords=grid.coords, **common)
    targs = dict(v=v[nodes], grad=grad[nodes, :1 + lay.ndim],
                 mu=mu[nodes], kappa=kappa[nodes], markers=tmark,
                 mu_t=mu_t[nodes], coords=grid.coords[nodes], **common)
    return jargs, targs


def cgns_mesh_file(path, x):
    """A CGNS mesh of the channel built with h5py: the cgns_out tree, its
    volume section rewritten as uniform QUAD_4 (no type codes)."""
    import h5py
    from su2_tpu_torch.io.cgns_out import write_cgns_volume
    write_cgns_volume(path, x.raw, {})
    with h5py.File(path, "r+") as f:
        el = f["Base/Zone/Elements"]
        conn = el["ElementConnectivity/ data"][...].reshape(-1, 5)
        el[" data"][...] = np.asarray([7, 0], np.int32)
        del el["ElementConnectivity/ data"]
        el["ElementConnectivity"].create_dataset(
            " data", data=conn[:, 1:].ravel().astype(np.int32))


WRITERS = ["restart", "restart_laminar", "tecplot", "tecplot_binary",
           "paraview", "surface", "fieldview", "cgns", "forces_breakdown",
           "surface_forces", "cgns_mesh"]


@pytest.mark.parametrize("what", WRITERS)
def test_writers_match_jax(tmp_path, what):
    """Each writer of io/restart, io/output, io/cgns_out writes su2_tpu's
    bytes from the same numpy fields and mesh (CGNS: the same HDF5 tree,
    names, labels and data); surface_forces gives su2_tpu's coefficients
    bit for bit from the same rows; a CGNS mesh built with h5py reads to
    the same RawMesh in both packages (MESH_FORMAT= CGNS)."""
    from su2_tpu.io import cgns_mesh as jcm, cgns_out as jco
    from su2_tpu.io import output as jo, restart as jr
    from su2_tpu.solvers import forces as jf
    from su2_tpu_torch.io import cgns_mesh as tcm, cgns_out as tco
    from su2_tpu_torch.io import output as to, restart as tr
    from su2_tpu_torch.solvers import forces as tf
    x = writer_inputs()
    raw, fields = x.raw, x.fields
    pair = {
        "restart": lambda m, p: m.write_restart(p, raw.coords, x.u, x.turb),
        "restart_laminar": lambda m, p: m.write_restart(p, raw.coords, x.u),
        "tecplot": lambda m, p: m.write_tecplot_volume(p, raw, fields),
        "tecplot_binary": lambda m, p: m.write_tecplot_binary_volume(
            p, raw, fields),
        "paraview": lambda m, p: m.write_paraview_volume(p, raw, fields),
        "surface": lambda m, p: m.write_surface_csv(p, raw, fields,
                                                    x.nodes),
        "fieldview": lambda m, p: m.write_fieldview_volume(
            p, raw, fields, mach=0.2, aoa=1.5, reynolds=1e6),
        "cgns": lambda m, p: m.write_cgns_volume(p, raw, fields),
    }
    mods = {"restart": (tr, jr), "restart_laminar": (tr, jr),
            "cgns": (tco, jco)}
    if what in pair:
        tmod, jmod = mods.get(what, (to, jo))
        got, want = str(tmp_path / "port"), str(tmp_path / "jax")
        pair[what](tmod, got)
        pair[what](jmod, want)
        if what == "cgns":
            assert_cgns_close(got, want)
            return
        with open(got, "rb") as f, open(want, "rb") as g:
            assert f.read() == g.read()
        if what.startswith("restart"):
            # read back: the values at their 15 printed digits
            printed = np.vectorize(lambda a: float(f"{a:.15g}"))
            u, turb = tr.read_restart(got, 2, 13, 2 if what == "restart"
                                      else 0)
            assert np.array_equal(u, printed(x.u))
            assert turb is None if what != "restart" \
                else np.array_equal(turb, printed(x.turb))
        return
    if what in ("forces_breakdown", "surface_forces"):
        jargs, targs = force_inputs(x)
        want = jf.surface_forces(None, **jargs)
        got = tf.surface_forces(**targs)
        if what == "surface_forces":
            assert_forces_close(got, want, 0.0)
            assert got["CL"] == want["CL"] and got["CMz"] == want["CMz"]
            return
        fs = {"ndim": 2, "Free-stream static pressure": "101325 Pa."}
        to.write_forces_breakdown(str(tmp_path / "port"), x.cfg, got, fs)
        jo.write_forces_breakdown(str(tmp_path / "jax"), x.cfg, want, fs)
        with open(tmp_path / "port", "rb") as f, \
                open(tmp_path / "jax", "rb") as g:
            assert f.read() == g.read()
        return
    path = str(tmp_path / "mesh.cgns")
    cgns_mesh_file(path, x)
    got, want = tcm.read_mesh(path, "CGNS"), jcm.read_mesh(path, "CGNS")
    assert got.ndim == want.ndim == 2
    for k in ("coords", "elem_types", "elem_nodes"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
        assert np.array_equal(getattr(got, k), getattr(raw, k)), k
    for k in ("markers", "marker_types"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.keys() == w.keys() == raw.markers.keys()
        assert all(np.array_equal(g[t], w[t]) for t in w), k


def test_cgns_mesh_format_runs(text, tmp_path):
    """MESH_FORMAT= CGNS: a Simulation reads the channel from the CGNS
    file of cgns_mesh_file and runs 2 iterations bit for bit as from the
    channel's RawMesh."""
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    path = str(tmp_path / "channel.cgns")
    cgns_mesh_file(path, writer_inputs())
    sim = Simulation(Config(text=th.with_lines(
        text, MESH_FORMAT="CGNS", MESH_FILENAME=path)),
        dtype=torch.float64, device="cpu")
    got, want = sim.run(2, quiet=True), th.torch_sim(text).run(2, quiet=True)
    assert torch.equal(got[0], want[0]) and np.array_equal(got[2], want[2])


# ----------------------------------------------------------------------
# (b) write_solution

@pytest.fixture(scope="module")
def ran(text):
    """Both packages on the shuffled channel after 3 iterations from the
    freestream: (su2_tpu Simulation, port Simulation, su2_tpu's result,
    port's)."""
    js, ts = make_sims(text, shuffled_channel())
    assert ts.perm is not None and np.array_equal(ts.perm, js.perm)
    return js, ts, js.run(3, quiet=True), ts.run(3, quiet=True)


@pytest.mark.parametrize("fmt", list(VOLUME))
def test_write_solution_matches_jax(ran, tmp_path, fmt):
    """write_solution after 3 iterations on a mesh file in a shuffled node
    order (the port renumbers it into stencil order: sim.perm), in each
    OUTPUT_FORMAT: the restart, the volume file and the surface file as
    su2_tpu's, in the file's node order."""
    js, ts, jo, to = ran
    for sim, out, d in ((js, jo, "jax"), (ts, to, "port")):
        (tmp_path / d).mkdir()
        sim.enable_output(str(tmp_path / d))
        sim.cfg.output_format = fmt
        sim.write_solution(out[0], out[1], turb_pair(out))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert {"restart_flow.dat", "surface_flow.dat", VOLUME[fmt]} \
        <= set(names)
    raw = ts.raw
    for name in names:
        assert_file_close(str(tmp_path / "port" / name),
                          str(tmp_path / "jax" / name), raw.npoint,
                          raw.nelem)


# ----------------------------------------------------------------------
# (c) RESTART_SOL

@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_restart_matches_jax(text, tmp_path, implicit):
    """RESTART_SOL= YES from a restart file the port wrote: the explicit
    case on the shuffled channel after 2 iterations from the freestream,
    the implicit case on the channel from th.mixed_state.  u0 and q as
    su2_tpu's bit for bit; mu_t, grad_k and sigma_k recomputed from them,
    and 3 iterations from the restart, as su2_tpu's."""
    from su2_tpu.pallas import edge_kernels as ek
    if implicit:
        text = th.with_implicit(text)
    mesh = None if implicit else shuffled_channel()
    src = make_sims(text, mesh)[1]
    src.enable_output(str(tmp_path))
    if implicit:
        u = th.tt(th.mixed_state(src, ys=MIXED_YS, seed=2))
        src.write_solution(u, src.t0, src.initial_turb_state()[:2])
    else:
        out = src.run(2, quiet=True)
        src.write_solution(out[0], out[1], turb_pair(out))
    rtext = th.with_lines(text, RESTART_SOL="YES", SOLUTION_FLOW_FILENAME=
                          str(tmp_path / "restart_flow.dat"))
    js, ts = make_sims(rtext, mesh)
    assert np.array_equal(th.npy(ts.u0), np.asarray(js.u0))
    assert np.array_equal(ts.turb_restart, np.asarray(js.turb_restart))
    jturb = [np.asarray(x) for x in js.initial_turb_state()]
    tturb = ts.initial_turb_state()
    assert np.array_equal(th.npy(tturb[0]), jturb[0])
    th.assert_fields_close(tturb[1:], jturb[1:], RTOL, ATOL_FRAC,
                           ("mu_t", "grad_k", "sigma_k"))
    assert not np.allclose(jturb[3], jturb[3][0])
    ek.set_edge_kernel_mode(implicit)
    try:
        want = js.run(3, quiet=True)
    finally:
        ek.set_edge_kernel_mode(False)
    got = ts.run(3, quiet=True)
    th.assert_fields_close(got[:3], want[:3], RTOL, ATOL_FRAC,
                           ("u", "t", "hist"))
    th.assert_fields_close(got[3], want[3], RTOL, ATOL_FRAC,
                           ("q", "mu_t", "grad_k", "sigma_k"))


def test_missing_restart_raises(text, tmp_path, capsys):
    """RESTART_SOL= YES without the file: su2_tpu's line, then the
    error."""
    path = str(tmp_path / "none.dat")
    with pytest.raises(FileNotFoundError):
        th.torch_sim(th.with_lines(text, RESTART_SOL="YES",
                                   SOLUTION_FLOW_FILENAME=path))
    assert f"There is no flow restart file!! {path}." \
        in capsys.readouterr().out


# ----------------------------------------------------------------------
# (d) MARKER_MONITORING

@pytest.fixture(scope="module")
def monitored(text, tmp_path_factory):
    """Both packages with MARKER_MONITORING= (lower_wall), the history
    written, after run(3) (chunk 1: forces in every row): (su2_tpu
    Simulation, port, su2_tpu's result, port's, directory)."""
    d = tmp_path_factory.mktemp("monitored")
    js, ts = make_sims(th.with_lines(text, MARKER_MONITORING=WALL))
    for sim, sub in ((js, "jax"), (ts, "port")):
        (d / sub).mkdir()
        sim.enable_output(str(d / sub))
    return js, ts, js.run(3, quiet=True), ts.run(3, quiet=True), d


def test_monitor_forces_match_jax(monitored, tmp_path):
    """monitor_forces on the final state (lower_wall, then both walls:
    every total, split and per-marker coefficient), the history file's
    force columns in every row (its wall clock Time(min) left out) and
    forces_breakdown.dat as su2_tpu's."""
    js, ts, jo, to, d = monitored
    scale = th.force_scale(ts)
    assert_text_close(open(d / "port" / "history.dat").read(),
                      open(d / "jax" / "history.dat").read(),
                      DIGITS["history.dat"],
                      floor={c: scale for c in FORCE_COLUMNS},
                      skip=(TIME_COLUMN,))
    rows = [ln.split(",") for ln in open(d / "port" / "history.dat")
            if ln[0].isdigit()]
    assert len(rows) == 3 and all(float(r[2]) > 0 for r in rows)
    got = ts.write_forces_breakdown(to[0], to[1], turb_pair(to),
                                    path=str(tmp_path / "port.dat"))
    want = js.write_forces_breakdown(jo[0], jo[1], turb_pair(jo),
                                     path=str(tmp_path / "jax.dat"))
    assert_forces_close(got, want, scale)
    assert_text_close(open(tmp_path / "port.dat").read(),
                      open(tmp_path / "jax.dat").read(),
                      DIGITS["forces_breakdown.dat"],
                      floor={c: scale for c in range(8)})
    both = ["lower_wall", "upper_wall"]
    js.cfg.marker_monitoring = ts.cfg.marker_monitoring = both
    try:
        assert_forces_close(ts.monitor_forces(to[0], to[1], turb_pair(to)),
                            js.monitor_forces(jo[0], jo[1], turb_pair(jo)),
                            th.force_scale(ts))
    finally:
        js.cfg.marker_monitoring = ts.cfg.marker_monitoring = ["lower_wall"]


# ----------------------------------------------------------------------
# (e) CONV_CRITERIA= CAUCHY

def test_cauchy_stops_at_jax_iteration(text):
    """CONV_CRITERIA= CAUCHY on the monitored drag (CAUCHY_ELEMS= 2 past
    STARTCONV_ITER= 1, CAUCHY_EPS between the drag's changes) stops
    run(10) at su2_tpu's iteration, inside 6, with its state."""
    ctext = th.with_lines(text, MARKER_MONITORING=WALL,
                          CONV_CRITERIA="CAUCHY", STARTCONV_ITER=1,
                          CAUCHY_ELEMS=2, CAUCHY_EPS=1.8e-7)
    js, ts = make_sims(ctext)
    want = js.run(10, quiet=True)
    got = ts.run(10, quiet=True)
    assert 3 < len(got[2]) == len(want[2]) <= 6
    assert len(ts._cauchy_hist) == len(js._cauchy_hist)
    th.assert_fields_close(got[:3], want[:3], RTOL, ATOL_FRAC,
                           ("u", "t", "hist"))


# ----------------------------------------------------------------------
# (f) WRT_SOL_FREQ

@pytest.mark.parametrize("niter,chunk,freq,after",
                         [(7, 3, 3, [3, 6, 7]), (7, 1, 2, [3, 5, 7]),
                          (8, 4, 4, [4, 8])])
def test_write_schedule_matches_jax(ran, monkeypatch, tmp_path, niter,
                                    chunk, freq, after):
    """run(niter, chunk) with WRT_SOL_FREQ= freq writes the solution after
    the iterations su2_tpu's run writes it after (`after`, counted from
    the run's start: su2_tpu's chunks write where the iterations done
    divide by freq, its iterations run alone where it > 0 does), from
    states within the tolerance of su2_tpu's."""
    js, ts, _, _ = ran
    states = {"jax": [], "port": []}
    for sim, key in ((js, "jax"), (ts, "port")):
        sim.enable_output(str(tmp_path))
        monkeypatch.setattr(sim.cfg, "wrt_sol_freq", freq)
        monkeypatch.setattr(sim, "write_solution",
                            lambda u, t, turb=None, key=key:
                            states[key].append(np.asarray(th.npy(u))))
    js.run(niter, quiet=True, chunk=chunk)
    ts.run(niter, quiet=True, chunk=chunk)
    # the port's own states after 1..niter iterations, one at a time
    carry = (ts.u0, ts.t0) + tuple(ts.initial_turb_state())
    trail = []
    for _ in range(niter):
        carry, _ = ts._multistep(carry, 1)
        trail.append(th.npy(carry[0]))
    done = [next(i + 1 for i, u in enumerate(trail) if np.array_equal(u, s))
            for s in states["port"]]
    assert done == after
    assert len(states["jax"]) == len(after)
    th.assert_fields_close(states["port"], states["jax"], RTOL, ATOL_FRAC,
                           [f"after {i}" for i in after])


# ----------------------------------------------------------------------
# (g) the CLI

def test_cli_writes_jax_files(text, tmp_path, monkeypatch):
    """python -m su2_tpu_torch --cpu case.cfg 2 and su2_tpu.driver.main
    on the same cfg (float64, MARKER_MONITORING) write the same set of
    files."""
    from su2_tpu.driver import main as jmain
    from su2_tpu_torch.geometry.structured import channel_mesh
    from su2_tpu_torch.io.mesh import write_su2_mesh
    cfg_text = th.with_lines(text, MARKER_MONITORING=WALL,
                             MESH_FILENAME=str(tmp_path / "channel.su2"))
    write_su2_mesh(channel_mesh(*th.CHANNEL), str(tmp_path / "channel.su2"))
    (tmp_path / "case.cfg").write_text(cfg_text)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               SU2_TPU_DTYPE="float64")
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    proc = subprocess.run([sys.executable, "-m", "su2_tpu_torch", "--cpu",
                           str(tmp_path / "case.cfg"), "2"],
                          cwd=tmp_path / "port", env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setenv("SU2_TPU_DTYPE", "float64")
    monkeypatch.delenv("SU2_TPU_CHUNK", raising=False)
    assert jmain([str(tmp_path / "case.cfg"), "2"]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert {"history.dat", "restart_flow.dat", "flow.dat",
            "surface_flow.dat", "forces_breakdown.dat"} <= set(names)
