"""The 3D implicit system of su2_tpu_torch against su2_tpu in float64, and
the port's 3D implicit runs: ns_assemble's implicit system (res, the
diagonal and off-diagonal blocks, the wall mask) on the 80-node box
(box_mesh(5, 4, 4), 6 stencil offsets; RANS with the SST coupling,
laminar, and the 3-species mixture cases.SPECIES_3, v = 8) and on the
180-node scrambled tet box (cases.tet_box_mesh(6, 6, 5): the edge-list
system, RANS and laminar), against su2_tpu's jitted ns_assemble with its
edge kernel mode off (its XLA family assembly on the box, which
tests/test_rans_3d.py:81 pins to its fused kernel's 3D branch); one
linear solve of each system (FGMRES with LU_SGS or JACOBI) against
su2_tpu's make_solver_ops and krylov.fgmres (its XLA ops); the port alone:
3 iterations of each 3D implicit path from the freestream, and the CLI.
Tolerances: the systems |port - su2_tpu| <= 1e-10 |su2_tpu| + 1e-12
max|su2_tpu|, the solves 1e-9 and 1e-12 (the steps' tolerance).  The
states have every species present (th.mixed_state, ROADMAP Queue 3
item 1)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

SYS_RTOL, SYS_ATOL = 1e-10, 1e-12
SOLVE_RTOL, SOLVE_ATOL = 1e-9, 1e-12
BOX = (5, 4, 4)
TET = (6, 6, 5)
# label -> (mesh, laminar, 3 species)
CASES = {"box-rans": ("box", False, False),
         "box-laminar": ("box", True, False),
         "box-3species": ("box", False, True),
         "tet-rans": ("tet", False, False),
         "tet-laminar": ("tet", True, False)}


def _sims(tmp_path_factory, label, prec="LU_SGS"):
    """(su2_tpu, port) Simulations of the implicit case (MUSCL +
    Venkatakrishnan) of CASES[label] with prec."""
    from su2_tpu.config import Config as JConfig
    from su2_tpu.driver import Simulation as JSimulation
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    from su2_tpu_torch.geometry.structured import box_mesh
    mesh, laminar, three = CASES[label]
    d = tmp_path_factory.mktemp(label)
    text = th.cases.write_case(str(d), species=th.cases.SPECIES_3 if three
                               else th.cases.SPECIES)
    text = th.with_implicit(th.cases.with_box_markers(text), prec=prec)
    if laminar:
        text = th.cases.with_laminar(text)
    raw = box_mesh(*BOX) if mesh == "box" else th.cases.tet_box_mesh(*TET)
    return (JSimulation(JConfig(text=text), dtype=jnp.float64,
                        raw_mesh=th.jax_raw(raw)),
            Simulation(Config(text=text), raw_mesh=raw, dtype=torch.float64,
                       device="cpu"))


def _state(ts, laminar, seed=7):
    """A perturbed mixed state, random SST fields (RANS) and a random
    local time step (numpy)."""
    n, nd = ts.mesh.npoint, ts.lay.ndim
    rng = np.random.default_rng(seed)
    s = dict(u=th.mixed_state(ts, seed=seed), t=th.npy(ts.t0),
             dt=rng.uniform(0.5, 1.5, n) * 1e-5)
    if not laminar:
        q = th.npy(ts.initial_turb_state()[0])
        s.update(tke=q[:, 0] * rng.uniform(0.5, 1.5, n),
                 mu_t=rng.uniform(1e-5, 1e-3, n),
                 grad_tke=rng.normal(0.0, 1e-1, (n, nd)),
                 sigma_k=rng.uniform(0.85, 1.0, n),
                 omega_t=q[:, 1] * rng.uniform(0.5, 1.5, n))
    return s


def _jax_system(js, s, laminar):
    from su2_tpu import state as jst
    from su2_tpu.ops import viscous as jvis
    from su2_tpu.pallas import edge_kernels as jek
    from su2_tpu.solvers import ns as jns
    c = {k: jnp.asarray(x) for k, x in s.items()}

    def assemble(c):
        nsd = jst.node_state(js.lib, js.lay, c["u"], c["t"], js.tparams,
                             turb_ke=None if laminar else c["tke"])
        turb = None if laminar else jvis.TurbFlowData(
            tke=c["tke"], mu_t=c["mu_t"], grad_tke=c["grad_tke"],
            sigma_k=c["sigma_k"])
        return jns.ns_assemble(
            js.lib, js.lay, js.mesh, js.params, js.bcs, nsd.v, c["dt"],
            implicit=True, turb=turb,
            omega_turb=None if laminar else c["omega_t"],
            sigma_k_edge=None if laminar
            else c["sigma_k"][js.mesh.edges[:, 0]], nsd=nsd)

    jek.set_edge_kernel_mode(False)
    res, wm, _, _, jac = jax.jit(assemble)(c)
    return res, wm, jac


def _port_system(ts, s, laminar):
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import viscous as vis
    from su2_tpu_torch.solvers import ns
    c = {k: th.tt(x) for k, x in s.items()}
    nsd = st.node_state(ts.lib, ts.lay, c["u"], c["t"], ts.tparams,
                        turb_ke=None if laminar else c["tke"])
    turb = None if laminar else vis.TurbFlowData(
        tke=c["tke"], mu_t=c["mu_t"], grad_tke=c["grad_tke"],
        sigma_k=c["sigma_k"])
    res, wm, _, _, jac, _ = ns.ns_assemble(
        ts.lib, ts.lay, ts.mesh, ts.params, ts.bcs, nsd.v, nsd, turb,
        None if laminar else c["omega_t"], dt=c["dt"])
    return res, wm, jac


def _blocks(mesh, jac, jax_side):
    """The diagonal and off-diagonal blocks of either package's implicit
    system as numpy: on a stencil mesh (diag, sel_t in the stencil lane
    layout (K*v*v, nP)), on the edge list (diag, off_ij, off_ji)."""
    if jax_side:
        from su2_tpu.linalg import blockcsr as jb
        if isinstance(jac, jb.FamilyJacobian):
            sel = np.asarray(jb.family_sel(mesh, jac))    # (K, nP, v, v)
            k, n, v = sel.shape[:3]
            return (np.asarray(jac.diag),
                    sel.transpose(0, 2, 3, 1).reshape(k * v * v, n))
    else:
        from su2_tpu_torch.linalg import blockcsr as tb
        if isinstance(jac, tb.FamilyJacobian):
            return th.npy(jac.diag), th.npy(tb.family_sel(mesh, jac))
    if hasattr(jac, "sel_t"):
        return th.npy(jac.diag), th.npy(jac.sel_t)
    return th.npy(jac.diag), th.npy(jac.off_ij), th.npy(jac.off_ji)


_SYSTEMS = {}


def _systems(tmp_path_factory, label):
    """(js, ts, state, su2_tpu's system, the port's) of CASES[label],
    built once."""
    if label not in _SYSTEMS:
        js, ts = _sims(tmp_path_factory, label)
        laminar = CASES[label][1]
        s = _state(ts, laminar)
        _SYSTEMS[label] = (js, ts, s, _jax_system(js, s, laminar),
                           _port_system(ts, s, laminar))
    return _SYSTEMS[label]


@pytest.mark.parametrize("label", list(CASES))
def test_ns_assemble_3d_matches_jax(tmp_path_factory, label):
    """ns_assemble's 3D implicit system (MUSCL + Venkatakrishnan, with dt):
    the interior (K10's plain version on the box, the edge-list system with
    K11's on the tet box), the boundary flux and viscous Jacobians of the
    inlet, outlet and slip walls, the strong no-slip walls' rows, the
    chemistry source Jacobian, the SST coupling (RANS) and the time
    diagonal: res, the blocks and the wall mask."""
    js, ts, _, (jres, jwm, jjac), (res, wm, jac) = _systems(
        tmp_path_factory, label)
    assert ts.lay.ndim == 3
    np.testing.assert_array_equal(th.npy(wm), np.asarray(jwm))
    assert np.asarray(jwm).any()
    got = (res,) + _blocks(ts.mesh, jac, False)
    want = (jres,) + _blocks(js.mesh, jjac, True)
    names = ("res", "diag", "sel_t") if len(got) == 3 else \
        ("res", "diag", "off_ij", "off_ji")
    th.assert_fields_close(got, [np.asarray(w) for w in want], SYS_RTOL,
                           SYS_ATOL, names)


SOLVES = [("box-rans", "LU_SGS"), ("box-rans", "JACOBI"),
          ("box-laminar", "LU_SGS"), ("box-3species", "LU_SGS"),
          ("tet-rans", "LU_SGS"), ("tet-laminar", "JACOBI")]


@pytest.mark.parametrize("label,prec", SOLVES,
                         ids=[f"{lb}-{p}" for lb, p in SOLVES])
def test_linear_solve_3d_matches_jax(tmp_path_factory, label, prec):
    """One FGMRES solve of the 3D implicit system with the case's Krylov
    budget and tolerance, preconditioned by prec, from the right side
    -res: the port's make_solver_ops and krylov.solve (on the box the
    stencil tier, here the one-launch cycle's plain version; on the tet
    box the gather sweep) against su2_tpu's make_solver_ops (XLA ops,
    allow_pallas False) and krylov.fgmres on its own system."""
    from su2_tpu.linalg import blockcsr as jb, krylov as jk
    from su2_tpu_torch.linalg import blockcsr as tb, krylov as tk
    js, ts, _, (jres, _, jjac), (res, _, jac) = _systems(tmp_path_factory,
                                                         label)
    m, tol = ts.cfg.linear_solver_iter, ts.cfg.linear_solver_error
    masks = tuple(jnp.asarray(th.npy(ts.colors) == c)
                  for c in range(ts.ncolor))

    @jax.jit
    def jsolve(jac, rhs):
        mv, pc, _, _ = jb.make_solver_ops(js.mesh, jac, prec, masks,
                                          allow_pallas=False,
                                          linear_iter=m)
        return jk.fgmres(mv, pc, rhs, max_iter=m, tol=tol)[0]

    want = np.asarray(jsolve(jjac, -jres))
    ops = tb.make_solver_ops(ts.mesh, jac, prec, ts.colors, ts.ncolor,
                             linear_iter=m)
    got = tk.solve("FGMRES", ops, -res, m, tol)
    th.assert_fields_close([got], [want], SOLVE_RTOL, SOLVE_ATOL, ["x"])


RUNS = {"box-LU_SGS": ("box-rans", "LU_SGS"), "box-ILU0": ("box-rans", "ILU0"),
        "box-JACOBI": ("box-rans", "JACOBI"),
        "box-laminar-LU_SGS": ("box-laminar", "LU_SGS"),
        "box-3species-LU_SGS": ("box-3species", "LU_SGS"),
        "tet-LU_SGS": ("tet-rans", "LU_SGS"),
        "tet-laminar-JACOBI": ("tet-laminar", "JACOBI")}


@pytest.mark.parametrize("run", list(RUNS))
def test_port_3d_implicit_runs(tmp_path_factory, run):
    """Simulation.run(3) of each 3D implicit path from the freestream
    (the port alone): a finite state, finite residuals, and the energy
    residual of the third iteration (the largest, log10 ~5.6-6) below the
    first's; the box's RANS runs take the stencil solve (LU_SGS, ILU0 as
    its sweep, JACOBI), the tet box's the gather path."""
    label, prec = RUNS[run]
    _, ts = _sims(tmp_path_factory, label, prec)
    u, t, hist = ts.run(3, quiet=True)[:3]
    assert torch.isfinite(u).all() and torch.isfinite(t).all()
    assert np.isfinite(hist).all() and hist.shape[0] == 3
    e = ts.lay.RHOE
    assert hist[-1][e] < hist[0][e], hist[:, e]


def test_cli_3d_implicit_runs(tmp_path):
    """python -m su2_tpu_torch --cpu with the implicit LU_SGS case on the
    3D box written as .su2: exits 0 and writes 2 finite history rows and
    the restart."""
    import os
    import subprocess
    import sys
    from su2_tpu_torch.geometry.structured import box_mesh
    from su2_tpu_torch.io.mesh import write_su2_mesh
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    write_su2_mesh(box_mesh(*BOX), str(tmp_path / "box.su2"))
    t = th.with_implicit(th.cases.with_box_markers(th.write_case(
        tmp_path / "lib", mesh_file="box.su2")), prec="LU_SGS")
    (tmp_path / "case.cfg").write_text(t)
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "su2_tpu_torch", "--cpu",
                           str(tmp_path / "case.cfg"), "2"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    rows = [ln for ln in (tmp_path / "history.dat").read_text().splitlines()
            if ln and ln[0].isdigit()]
    assert len(rows) == 2 and "nan" not in " ".join(rows).lower()
    assert (tmp_path / "restart_flow.dat").exists()
