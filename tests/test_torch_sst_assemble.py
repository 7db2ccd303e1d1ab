"""The fused SST assembly of su2_tpu_torch (turbulence/sst_assemble.py, the
fused path of turbulence/sst.py, linalg/stencil_solve.fused_sst_solve_tier)
against su2_tpu's pallas/sst_assemble.py in interpret mode and its fused
sst_step (set_assemble_mode("pallas")), in float64 on the CPU.  The plain
version repeats the reference body's groupings op for op, so the assembly
pins sit near rounding."""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

CFL_RED = 0.8


def _meshes(ni, nj):
    """(JAX MeshArrays, port MeshArrays) of one structured quad grid."""
    from su2_tpu.geometry.dual_grid import build_dual_grid as jgrid
    from su2_tpu.geometry.mesh_data import mesh_arrays as jarrays
    from su2_tpu_torch.geometry.dual_grid import build_dual_grid as tgrid
    from su2_tpu_torch.geometry.mesh_data import mesh_arrays as tarrays
    from su2_tpu_torch.io.mesh import RawMesh
    from test_stencil import _quad_grid
    raw = _quad_grid(ni, nj)
    traw = RawMesh(ndim=raw.ndim, coords=raw.coords,
                   elem_types=raw.elem_types, elem_nodes=raw.elem_nodes,
                   markers=raw.markers, marker_types=raw.marker_types)
    jm, tm = jarrays(jgrid(raw), jnp.float64), tarrays(tgrid(traw))
    assert tuple(jm.stencil_offsets) == tm.stencil_offsets
    return jm, tm


def _inputs(n, d, seed):
    """The assembly's per-node inputs in numpy: every source branch taken
    (pk clipped at both ends, zeta from either side, inactive nodes at
    dist 0, nodes with dt 0) and a wall strip."""
    rng = np.random.default_rng(seed)
    x = dict(
        q=np.abs(rng.normal(1.0, 0.2, (n, 2))) + 0.1,
        rho=np.abs(rng.normal(1.0, 0.1, n)) + 0.5,
        vel=rng.normal(0.0, 1.0, (n, d)),
        gq=rng.normal(0.0, 0.5, (n, 2, d)),
        mu=np.abs(rng.normal(1.8e-5, 2e-6, n)),
        mut=np.abs(rng.normal(1e-4, 1e-5, n)),
        dist=np.abs(rng.normal(0.5, 0.1, n)) + 0.01,
        strain=np.abs(rng.normal(1.0, 0.5, n)),
        diverg=rng.normal(0.0, 3.0, n),
        dt=np.full(n, 1e-4) * rng.uniform(0.5, 2.0, n),
        f1=rng.uniform(0.0, 1.0, n), f2=rng.uniform(0.0, 1.0, n),
        cdkw=np.abs(rng.normal(1e-3, 1e-3, n)) + 1e-20)
    x["dist"][5::13] = 0.0
    x["dt"][4::17] = 0.0
    x["q"][1::3, 1] *= 0.05
    wall = np.zeros(n, bool)
    wall[::7] = True
    return x, wall


ORDER = ("q", "rho", "vel", "gq", "mu", "mut", "dist", "strain", "diverg",
         "dt")


@pytest.mark.parametrize("kernel", ["full_field", "tiled"])
def test_assemble_plain_matches_jax(monkeypatch, kernel):
    """assemble_plain against su2_tpu's sst_assemble: its full-field
    _assemble_call, and _assemble_tiled_call forced with 128-lane tiles
    (four of them on this grid) as tests/test_sst.py forces it; every
    output row within 1e-12 of that row's max, wall rows included."""
    from su2_tpu.pallas import sst_assemble as jsa
    from su2_tpu.turbulence import sst as jsst
    from su2_tpu_torch.turbulence import sst as tsst
    from su2_tpu_torch.turbulence import sst_assemble as tsa
    jm, tm = _meshes(23, 17)
    n, d = tm.npoint, tm.ndim
    assert tsst._CONSTS == jsst._CONSTS
    consts = tsst._CONSTS + (CFL_RED,)
    x, wall = _inputs(n, d, 3)
    if kernel == "tiled":
        maxoff = max(abs(int(o)) for o in jm.stencil_offsets)
        h = -(-maxoff // 128) * 128
        ntiles = -(-n // 128)
        assert ntiles >= 2
        monkeypatch.setattr(jsa, "supported", lambda m: False)
        monkeypatch.setattr(jsa, "tile_plan",
                            lambda m: (128, h, ntiles, ntiles * 128 + 2 * h))
    fl = [x[k] for k in ORDER[:9]]
    want = jsa.sst_assemble(jm, consts, *(jnp.asarray(a) for a in fl),
                            jnp.asarray(x["dt"]), jnp.asarray(wall),
                            *(jnp.asarray(x[k]) for k in ("f1", "f2",
                                                           "cdkw")))
    got = tsa.assemble_plain(tm, consts, *(th.tt(a) for a in fl),
                             th.tt(x["dt"]), torch.as_tensor(wall),
                             *(th.tt(x[k]) for k in ("f1", "f2", "cdkw")))
    for name, g, w in zip(("res", "dd", "sel"), got, want):
        w = np.asarray(w)[:, :n]
        g = th.npy(g)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        scale = np.abs(w).max(1, keepdims=True)
        err = np.abs(g - w)
        assert (err <= 1e-12 * scale).all(), (name, (err / np.maximum(
            scale, 1e-300)).max())
    # the wall rows: zero residual and off-diagonal blocks, a unit
    # diagonal plus Vol/dt
    res, dd, sel = (th.npy(t) for t in got)
    assert (res[:, wall] == 0.0).all() and (sel[:, wall] == 0.0).all()
    vol, dt = th.npy(tm.volume), x["dt"]
    delta = np.where(dt > 1e-16, vol / (CFL_RED * np.where(dt > 1e-16, dt,
                                                           1.0)), 0.0)
    for row in dd:
        np.testing.assert_array_equal(row[wall], 1.0 + delta[wall])


def _bcs_and_state(jm, tm, lay, seed):
    """The scenario of tests/test_sst.py's fused-assembly test: random flow
    and SST fields, a strong wall strip and weak outlet and inlet strips
    (the inlet imposing the freestream on the incoming characteristic);
    the weak markers' ghost states handed over as the flow phase's batch.
    Returns (JAX arguments, port arguments)."""
    from su2_tpu.linalg import blockcsr as jb
    from su2_tpu.ops import gradients as jg
    from su2_tpu_torch.solvers import euler as es
    n, d = tm.npoint, tm.ndim
    rng = np.random.default_rng(seed)
    q = np.abs(rng.normal(1.0, 0.2, (n, 2))) + 0.1
    v = np.abs(rng.normal(1.0, 0.1, (n, lay.nprim))) + 0.5
    v[:, lay.VX:lay.VX + d] = rng.normal(0.0, 1.0, (n, d))
    flow_grad = rng.normal(0.0, 0.3, (n, lay.nprim - 2, d))
    mu = np.full(n, 1.8e-5)
    mu_t = np.abs(rng.normal(1e-4, 1e-5, n))
    strain = np.abs(rng.normal(1.0, 0.2, n))
    dist = np.abs(rng.normal(0.5, 0.1, n)) + 0.01
    rho_old = v[:, lay.PRHO] * (1.0 + 0.01 * rng.standard_normal(n))
    dt = np.full(n, 1e-4)
    gq = np.asarray(jg.pg_fix(jm, jg.weighted_least_squares(
        jm, jnp.asarray(q))))
    gq_prev = gq + rng.normal(0.0, 0.1, gq.shape)
    wall_nodes = np.arange(0, n, 7)
    strips = {"outlet": np.arange(3, n, 11), "inlet": np.arange(5, n, 8)}
    normals = {k: rng.normal(0.0, 1.0, (len(s), d))
               for k, s in strips.items()}
    ghost = {k: v[s] * (1.0 + 0.05 * rng.standard_normal(v[s].shape))
             for k, s in strips.items()}
    kine_inf, omega_inf = 1e-3, 10.0
    colors = jb.greedy_coloring(np.asarray(jm.node_nbrs))
    ncolor = int(colors.max()) + 1

    jbcs = [SimpleNamespace(kind="isothermal_wall",
                            nodes=jnp.asarray(wall_nodes),
                            nn=jnp.asarray((wall_nodes + 1) % n),
                            normal=None)]
    jbcs += [SimpleNamespace(kind=k, nodes=jnp.asarray(s), nn=None,
                             normal=jnp.asarray(normals[k]))
             for k, s in strips.items()]
    jfb = (None, None, None, jnp.asarray(np.concatenate(list(
        ghost.values()))))
    jargs = dict(bcs=tuple(jbcs), q=jnp.asarray(q), v=jnp.asarray(v),
                 flow_grad=jnp.asarray(flow_grad), mu=jnp.asarray(mu),
                 mu_t_node=jnp.asarray(mu_t), strain_mag=jnp.asarray(strain),
                 dist=jnp.asarray(dist), rho_old=jnp.asarray(rho_old),
                 dt=jnp.asarray(dt), kine_inf=kine_inf, omega_inf=omega_inf,
                 gq=jnp.asarray(gq), flow_fb=jfb,
                 gq_prev=jnp.asarray(gq_prev),
                 masks=tuple(jnp.asarray(colors == c)
                             for c in range(ncolor)))

    long = lambda a: torch.as_tensor(a, dtype=torch.long)
    tbcs = [SimpleNamespace(kind="isothermal_wall", nodes=long(wall_nodes),
                            nn=long((wall_nodes + 1) % n), normal=None)]
    tbcs += [SimpleNamespace(kind=k, nodes=long(s), nn=None,
                             normal=th.tt(normals[k]))
             for k, s in strips.items()]
    allnodes = long(np.concatenate(list(strips.values())))
    nb = allnodes.shape[0]
    tfb = es.FluxBCBatch(
        nodes=allnodes, nn=allnodes, normal=th.tt(np.zeros((nb, d))),
        v_ghost=th.tt(np.concatenate(list(ghost.values()))),
        gamma=th.tt(np.zeros(nb)), vel2=th.tt(np.zeros(nb)),
        seg=tuple(len(s) for s in strips.values()))
    targs = dict(bcs=tuple(tbcs), q=th.tt(q), v=th.tt(v), mu=th.tt(mu),
                 mu_t_node=th.tt(mu_t), strain_mag=th.tt(strain),
                 dist=th.tt(dist), rho_old=th.tt(rho_old), dt=th.tt(dt),
                 kine_inf=kine_inf, omega_inf=omega_inf, gq=th.tt(gq),
                 gvel=th.tt(flow_grad[:, 1:1 + d, :]), flow_fb=tfb,
                 gq_prev=th.tt(gq_prev),
                 colors=torch.as_tensor(colors.astype(np.int8)),
                 ncolor=ncolor)
    # the wall and the weak strips share nodes (the wall corners)
    assert set(wall_nodes) & set(strips["outlet"])
    assert set(wall_nodes) & set(strips["inlet"])
    return jargs, targs


def _jax_step(jm, lay, a, fused, **cfg):
    from su2_tpu.turbulence import sst as jsst
    scfg = jsst.SSTConfig(grad_method="WEIGHTED_LEAST_SQUARES",
                          linear_prec="LU_SGS", color_masks=a["masks"], **cfg)
    jsst.set_assemble_mode("pallas" if fused else "xla")
    try:
        return jsst.sst_step(lay, jm, scfg, a["bcs"], a["q"], a["v"],
                             a["flow_grad"], a["mu"], a["mu_t_node"],
                             a["strain_mag"], a["dist"], a["rho_old"],
                             a["dt"], a["kine_inf"], a["omega_inf"],
                             gq=a["gq"], flow_fb=a["flow_fb"],
                             gq_prev=a["gq_prev"])
    finally:
        jsst.set_assemble_mode("xla")


def _torch_step(tm, lay, a, fused, **cfg):
    from su2_tpu_torch.turbulence import sst as tsst
    scfg = tsst.SSTConfig(grad_method="WEIGHTED_LEAST_SQUARES",
                          linear_prec="LU_SGS", colors=a["colors"],
                          ncolor=a["ncolor"], **cfg)
    tsst.set_assemble_mode("fused" if fused else "unfused")
    try:
        return tsst.sst_step(lay, tm, scfg, a["bcs"], a["q"], a["v"],
                             a["mu"], a["mu_t_node"], a["strain_mag"],
                             a["dist"], a["rho_old"], a["dt"], a["kine_inf"],
                             a["omega_inf"], a["gq"], a["gvel"],
                             flow_fb=a["flow_fb"], gq_prev=a["gq_prev"])
    finally:
        tsst.set_assemble_mode("unfused")


def _count_jax_assembly(monkeypatch, calls):
    """Record each call (each trace, under jit) of su2_tpu's fused
    assembly, so a test sees that its reference took the fused path."""
    from su2_tpu.pallas import sst_assemble as jsa
    orig = jsa.sst_assemble
    monkeypatch.setattr(jsa, "sst_assemble",
                        lambda *x: calls.append(1) or orig(*x))


def _assert_step_close(got, want):
    for g, w in ((got[0], want[0]), (got[1], want[1])):
        np.testing.assert_allclose(th.npy(g), np.asarray(w), rtol=1e-9,
                                   atol=1e-12)
    for key in ("mu_t", "sigma_k"):
        np.testing.assert_allclose(th.npy(got[2][key]),
                                   np.asarray(want[2][key]), rtol=1e-9,
                                   atol=1e-12)


# the solve branches of the fused step on this grid in f64: one FGMRES
# cycle in one launch, or (its predicate failed on both sides) the
# full-precision sweep and matvec once per Krylov vector
SOLVES = {"one_launch": False, "per_iteration": True}


@pytest.mark.parametrize("solve", list(SOLVES))
def test_fused_step_matches_jax_fused_step(monkeypatch, solve):
    """The port's fused sst_step against su2_tpu's sst_step in its fused
    mode (the tests/test_sst.py scenario: a strong wall strip, weak
    outlet and inlet strips that share nodes with it): q_new, rms, mu_t
    and sigma_k within rtol 1e-9, atol 1e-12; and against the port's
    unfused step, the same pin.  The launch-free CPU path runs the plain
    assembly and the plain sweep in the tier the reference takes."""
    from su2_tpu.pallas import stencil_solve as jst
    from su2_tpu.state import Layout as JLayout
    from su2_tpu_torch.linalg import stencil_solve as tst
    from su2_tpu_torch.state import Layout
    jm, tm = _meshes(9, 7)
    lay, jlay = Layout(2, 3), JLayout(2, 3)
    jargs, targs = _bcs_and_state(jm, tm, lay, 23)
    cfg = dict(cfl_red=CFL_RED, relax=0.9, linear_iter=10, linear_tol=1e-10)
    if SOLVES[solve]:
        monkeypatch.setattr(jst, "fgmres_supported", lambda *a, **k: False)
        monkeypatch.setattr(tst, "fgmres_supported", lambda *a, **k: False)
    calls, jcalls = [], []
    fused_tier = tst.fused_sst_solve_tier
    monkeypatch.setattr(tst, "fused_sst_solve_tier",
                        lambda *a: calls.append(fused_tier(*a)) or calls[-1])
    _count_jax_assembly(monkeypatch, jcalls)
    want = _jax_step(jm, jlay, jargs, True, **cfg)
    got = _torch_step(tm, lay, targs, True, **cfg)
    assert calls == [(torch.float64, not SOLVES[solve])] and jcalls == [1]
    _assert_step_close(got, want)
    calls.clear()
    fused = (th.npy(got[0]), th.npy(got[1]),
             {k: th.npy(x) for k, x in got[2].items()})
    _assert_step_close(_torch_step(tm, lay, targs, False, **cfg), fused)
    assert calls == []


def test_fused_gate_falls_back_as_the_reference(monkeypatch):
    """In the fused mode the step takes the unfused path where su2_tpu's
    gate fails (JACOBI, or no sweep colors), before any assembly launch:
    it then equals the unfused step bitwise."""
    from su2_tpu_torch.state import Layout
    from su2_tpu_torch.turbulence import sst as tsst
    from su2_tpu_torch.turbulence import sst_assemble as tsa
    jm, tm = _meshes(9, 7)
    lay = Layout(2, 3)
    _, a = _bcs_and_state(jm, tm, lay, 5)
    calls = []
    orig = tsa.sst_assemble
    monkeypatch.setattr(tsa, "sst_assemble",
                        lambda *x: calls.append(1) or orig(*x))
    for prec, colors in (("JACOBI", a["colors"]), ("LU_SGS", None)):
        scfg = tsst.SSTConfig(grad_method="WEIGHTED_LEAST_SQUARES",
                              linear_prec=prec, colors=colors,
                              ncolor=a["ncolor"])
        args = (lay, tm, scfg, a["bcs"], a["q"], a["v"], a["mu"],
                a["mu_t_node"], a["strain_mag"], a["dist"], a["rho_old"],
                a["dt"], a["kine_inf"], a["omega_inf"], a["gq"], a["gvel"])
        kw = dict(flow_fb=a["flow_fb"], gq_prev=a["gq_prev"])
        tsst.set_assemble_mode("fused")
        try:
            got = tsst.sst_step(*args, **kw)
        finally:
            tsst.set_assemble_mode("unfused")
        want = tsst.sst_step(*args, **kw)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    assert calls == []
    with pytest.raises(ValueError):
        tsst.set_assemble_mode("pallas")
    assert tsst.assemble_mode() == "unfused"


def _offset_sets():
    """Stencils of the channel meshes (+-1, +-ny) from the test's to the
    largest smoke size, a wide 2D quad stencil and 3D-like ones."""
    sets = [(-ny, -1, 1, ny) for ny in (9, 48, 189, 377, 1000, 1500, 4000)]
    return sets + [(-8, -7, -6, -1, 1, 6, 7, 8), (-2500, -50, -1, 1, 50, 2500)]


def _reference_fused_tier(mesh, jdt, nc, m):
    """(sweep block dtype name, one launch) of the reference's fused SST
    solve (su2_tpu/turbulence/sst.py:649-702), its predicates in its
    order."""
    from su2_tpu.pallas import stencil_solve as stks
    name = jnp.dtype(jdt).name
    if stks.fgmres_supported(mesh, 2, jdt, nc, m=m):
        return name, True
    if jdt == jnp.float32 and stks.sgs_matvec_mixed_supported(mesh, 2, nc):
        return "bfloat16", False
    if jdt == jnp.float32 and stks.tile_plan(mesh, 2, nc, 2, True):
        return "bfloat16", False
    return name, False


def test_fused_solve_tier_matches_jax():
    """fused_sst_solve_tier against the reference's fused-step branches
    over sizes, stencils, dtypes, color counts and Krylov budgets; where
    it differs from solve_tier (the unfused step's tier) is seen; at the
    smoke sizes' channels (2 colors, FGMRES(10)): one K6 launch at 9,072
    nodes, the mixed per-iteration tier at 142,317 and 565,500 in f32, and
    full precision per iteration in f64 past the gate."""
    from su2_tpu_torch.linalg import stencil_solve as ts
    assert jax.devices()[0].platform == "cpu"
    seen, differs = set(), False
    for n in (153, 9072, 36000, 60000, 142317, 565500, 2_000_000):
        for offsets in _offset_sets():
            mesh = SimpleNamespace(npoint=n, n_shards=1,
                                   stencil_offsets=offsets)
            for jdt, tdt in ((jnp.float32, torch.float32),
                             (jnp.float64, torch.float64)):
                for nc in (2, 3, 5):
                    for m in (5, 10, 20):
                        want = _reference_fused_tier(mesh, jdt, nc, m)
                        sel, one = ts.fused_sst_solve_tier(n, offsets, tdt,
                                                           nc, m)
                        got = (str(sel).split(".")[-1], one)
                        assert got == want, (n, offsets, tdt, nc, m)
                        seen.add(want)
                        differs |= (sel, one) != ts.solve_tier(
                            n, offsets, 2, tdt, nc, m)
    assert seen == {("float32", True), ("float64", True),
                    ("bfloat16", False), ("float32", False),
                    ("float64", False)}
    assert differs
    for n, ny in {9072: 48, 142317: 189, 565500: 377}.items():
        offsets = (-ny, -1, 1, ny)
        assert ts.fused_sst_solve_tier(n, offsets, torch.float32, 2, 10) == \
            ((torch.float32, True) if n == 9072 else (torch.bfloat16, False))
        assert ts.fused_sst_solve_tier(n, offsets, torch.float64, 2, 10) == \
            (torch.float64, n == 9072)


def test_assembly_gates_match_jax():
    """supported and tile_plan (the reference's full-field and windowed
    assembly gates, which decide whether it takes the fused path) equal
    su2_tpu's over sizes, stencils and dimensions; each answer seen."""
    from su2_tpu.pallas import sst_assemble as jsa
    from su2_tpu_torch.turbulence import sst_assemble as tsa
    seen = set()
    for n in (153, 9072, 142317, 216000, 565500, 2_000_000, 40_000_000):
        for offsets in _offset_sets() + [(-40000, -1, 1, 40000)]:
            for d in (2, 3):
                mesh = SimpleNamespace(npoint=n, n_shards=1,
                                       stencil_offsets=offsets,
                                       gg_snormal=True,
                                       coords=np.zeros((1, d)))
                full = jsa.supported(mesh)
                plan = jsa.tile_plan(mesh)
                assert tsa.supported(n, len(offsets), d) == full
                assert tsa.tile_plan(n, offsets, d) == plan
                seen.add((full, plan is not None))
    assert {(True, True), (False, True), (False, False)} <= seen


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    return th.write_case(tmp_path_factory.mktemp("sst_fused"))


def test_three_fused_coupled_iterations_match_jax(text, monkeypatch):
    """The coupled explicit LU_SGS step of the 153-node channel with the
    fused SST assembly on both sides (su2_tpu's fused step runs
    _assemble_call and its one-launch FGMRES in interpret mode; the port's
    the plain assembly and the plain sweep): every output field of 3
    iterations within rtol 1e-9, atol 1e-12 max|field|, as
    test_torch_slice.py holds the unfused step."""
    from su2_tpu.turbulence import sst as jsst
    from su2_tpu_torch.turbulence import sst as tsst
    from su2_tpu_torch.turbulence import sst_assemble as tsa
    from test_torch_slice import _three_steps
    js, ts = th.jax_sim(text), th.torch_sim(text)
    calls, jcalls = [], []
    orig = tsa.sst_assemble
    monkeypatch.setattr(tsa, "sst_assemble",
                        lambda *x: calls.append(1) or orig(*x))
    _count_jax_assembly(monkeypatch, jcalls)
    jsst.set_assemble_mode("pallas")
    tsst.set_assemble_mode("fused")
    try:
        _three_steps(js, ts, jax.jit(js._make_rans_step()))
    finally:
        jsst.set_assemble_mode("xla")
        tsst.set_assemble_mode("unfused")
    # the port's step runs eagerly; su2_tpu's traces its step once
    assert len(calls) == 3 and len(jcalls) == 1
