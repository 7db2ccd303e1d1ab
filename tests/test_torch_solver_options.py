"""The coupled flow step's remaining options in the port against su2_tpu
on the 153-node synthetic channel in float64: MUSCL with explicit flow
(the stencil channel with the Venkatakrishnan and Barth-Jespersen
limiters and unlimited, and the scrambled triangle channel),
CLIPPING_TEMPRATURE (the plain node-state chain against su2_tpu's
cons2prim, and the coupled step), LINEAR_SOLVER= BCGSTAB (the solver on a
random block system, the sweep-only and matvec-only stencil operators it
calls, the flow solve with JACOBI and LU_SGS, the SST solve inside a
step) and the FGMRES every other LINEAR_SOLVER value runs, and
LINEAR_SOLVER_PREC= LINELET (the lines on the quad and triangle
channels, the preconditioner in its family-major and edge-major forms,
an implicit step).  su2_tpu runs its XLA modes for explicit flow and its
fused implicit edge kernel in interpret mode for implicit flow, as
tests/test_torch_slice.py does.  Unless a test says otherwise:
|port - su2_tpu| <= 1e-12 |su2_tpu| + 1e-12 max|su2_tpu| per field."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

RTOL, ATOL_FRAC = 1e-12, 1e-12
# the implicit flow's residual norms (test_torch_multistep.py)
IMPLICIT_RES_RTOL = 5e-12
MIXED_YS = (0.01, 0.1, 0.59, 0.05, 0.15, 0.02, 0.03, 0.03, 0.02)
NAMES = ("u", "t_guess", "q", "mu_t", "grad_k", "sigma_k", "rms", "rmax",
         "turb_rms", "nonphys", "min_dt")


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    return th.write_case(tmp_path_factory.mktemp("options"))


def coupled_steps(js, ts, niter=3, u=None, implicit=False, rtol=RTOL,
                  res_rtol=IMPLICIT_RES_RTOL):
    """niter coupled iterations of both packages from the same state (the
    freestream, or u): every output within rtol (the implicit residual
    norms within res_rtol)."""
    from su2_tpu.pallas import edge_kernels as ek
    from su2_tpu_torch.convert import state_from_numpy
    j_state = (js.u0, js.t0) + tuple(js.initial_turb_state())
    t_state = state_from_numpy(*(np.asarray(x) for x in j_state))
    if u is not None:
        j_state = (jnp.asarray(u),) + j_state[1:]
        t_state = (th.tt(u),) + t_state[1:]
    ek.set_edge_kernel_mode(implicit)
    try:
        step = jax.jit(js._make_rans_step())
        for _ in range(niter):
            jo = step(*j_state, jnp.asarray(False))
            to = ts._step(*t_state)
            th.assert_fields_close(to[:6] + to[8:], jo[:6] + jo[8:], rtol,
                                   ATOL_FRAC, NAMES[:6] + NAMES[8:])
            th.assert_fields_close(to[6:8], jo[6:8],
                                   res_rtol if implicit else rtol,
                                   ATOL_FRAC, NAMES[6:8])
            j_state, t_state = tuple(jo[:6]), tuple(to[:6])
    finally:
        ek.set_edge_kernel_mode(False)
    return t_state


# ----------------------------------------------------------------------
# MUSCL with explicit flow

MUSCL = {"venkatakrishnan": dict(SPATIAL_ORDER_FLOW="2ND_ORDER_LIMITER",
                                 SLOPE_LIMITER_FLOW="VENKATAKRISHNAN"),
         "barth_jespersen": dict(SPATIAL_ORDER_FLOW="2ND_ORDER_LIMITER",
                                 SLOPE_LIMITER_FLOW="BARTH_JESPERSEN"),
         "unlimited": dict(SPATIAL_ORDER_FLOW="2ND_ORDER")}


@pytest.mark.parametrize("limiter", list(MUSCL))
def test_explicit_muscl_matches_jax(text, limiter):
    """Explicit flow with MUSCL faces (no fused edge pass: the edge-list
    AUSM+-up between the reconstructed states, h from the library at the
    face T, and the edge viscous flux) for 3 coupled iterations; the
    port's step takes its spectral radii from viscous_lambda."""
    t = th.with_lines(text, **MUSCL[limiter])
    ts = th.torch_sim(t)
    assert ts.params.muscl
    coupled_steps(th.jax_sim(t), ts)


def test_explicit_muscl_triangles_matches_jax(text):
    """The same with the Venkatakrishnan limiter on the scrambled triangle
    channel (no static stencil: the limiter, the spectral radii and the
    gradients over the edge list)."""
    js, ts = th.tri_sims(th.with_lines(text, **MUSCL["venkatakrishnan"]))
    assert ts.mesh.stencil_offsets is None
    coupled_steps(js, ts)


def test_explicit_muscl_laminar_run_matches_jax(text):
    """The laminar explicit step (KIND_TURB_MODEL= NONE) with MUSCL and the
    Venkatakrishnan limiter: Simulation.run(3) of both packages from the
    freestream, u, T and the residual history."""
    t = th.cases.with_laminar(th.with_lines(text, **MUSCL["venkatakrishnan"]))
    js, ts = th.jax_sim(t), th.torch_sim(t)
    assert not ts.turbulent and ts.params.muscl
    want = js.run(3, quiet=True)
    got = ts.run(3, quiet=True)
    th.assert_fields_close(got, [np.asarray(x) for x in want], RTOL,
                           ATOL_FRAC, ("u", "t_guess", "hist"))


def test_muscl_face_rows_match_jax(text):
    """muscl_face_rows (the explicit step's face state) against su2_tpu's
    _muscl_rows on the channel's edges, both sides, from a mixed state,
    limited and unlimited; unlimited, the faces of a few nodes given a
    steep temperature gradient fall back to the node state."""
    from su2_tpu.solvers import euler as jes
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import limiters
    from su2_tpu_torch.ops.edge_implicit import muscl_face_rows
    from su2_tpu_torch.solvers import euler as es
    t = th.with_lines(text, **MUSCL["venkatakrishnan"])
    js, ts = th.jax_sim(t), th.torch_sim(t)
    lay, mesh = ts.lay, ts.mesh
    u = th.tt(th.mixed_state(ts, seed=3))
    v = st.node_state(ts.lib, lay, u, ts.t0, ts.tparams).v
    q = es.gradient_vars(lay, v)
    grad = es.compute_gradients(mesh, ts.params, q)
    # a steep gradient at a few nodes sends their faces below T = 0
    grad[:5, 0, :] = -1e9
    lim = limiters.venkatakrishnan(mesh, q, grad, ts.params.limiter_coeff,
                                   ts.params.ref_elem_length)
    i, j = mesh.edges[:, 0], mesh.edges[:, 1]
    ev = (mesh.coords[j] - mesh.coords[i]).T
    g = grad.permute(1, 2, 0)
    jv, jq, jg, jl = (jnp.asarray(th.npy(x)) for x in (v, q, grad, lim))
    for limited in (True, False):
        jprm = js.params if limited else \
            dataclasses.replace(js.params, use_limiter=False)
        kept = False
        for idx, sign in ((i, 1.0), (j, -1.0)):
            got = muscl_face_rows(ts.lib, lay, v.T[:, idx], g[..., idx],
                                  lim.T[:, idx] if limited else None, ev,
                                  sign)
            ji = jnp.asarray(th.npy(idx))
            want = jes._muscl_rows(js.lib, js.lay, jprm, jv[ji], jq[ji],
                                   jg[ji], jl[ji],
                                   sign * 0.5 * jnp.asarray(th.npy(ev.T)))
            th.assert_fields_close([got.T], [np.asarray(want)], RTOL,
                                   ATOL_FRAC, ["v_face"])
            kept |= bool((got.T == v[idx]).all(1).any())
        assert kept != limited


# ----------------------------------------------------------------------
# CLIPPING_TEMPRATURE

@pytest.mark.parametrize("lite", [False, True], ids=["full", "lite"])
def test_node_state_clip_matches_jax(text, lite):
    """node_state_plain / node_state_lite_plain with the clip against
    su2_tpu's cons2prim (and its derived fields) at
    tests/test_node_state.py:66's rtol 5e-12, on a state whose guess is
    10 % off at half the nodes: the clip binds there."""
    from dataclasses import replace
    from su2_tpu import state as jst
    from su2_tpu_torch import state as st
    t = th.with_lines(text, CLIPPING_TEMPRATURE="YES")
    js, ts = th.jax_sim(t), th.torch_sim(t)
    assert ts.tparams.clip_temp and js.tparams.clip_temp
    u = th.mixed_state(ts, seed=7)
    rng = np.random.default_rng(8)
    tg = th.npy(ts.t0) * np.where(rng.random(len(u)) < 0.5, 1.1, 1.0)
    tke = rng.uniform(0.0, 5.0, len(u))
    fn = st.node_state_lite_plain if lite else st.node_state_plain
    got = fn(ts.lib, ts.lay, th.tt(u), th.tt(tg), ts.tparams,
             turb_ke=th.tt(tke))
    jfn = jst.node_state_lite if lite else jst.node_state
    want = jfn(js.lib, js.lay, jnp.asarray(u), jnp.asarray(tg), js.tparams,
               turb_ke=jnp.asarray(tke))
    names = [f for f in got.__dataclass_fields__]
    th.assert_fields_close([getattr(got, f) for f in names],
                           [np.asarray(getattr(want, f)) for f in names],
                           5e-12, 1e-14, names)
    free = fn(ts.lib, ts.lay, th.tt(u), th.tt(tg),
              replace(ts.tparams, clip_temp=False), turb_ke=th.tt(tke))
    bound = (free.v[:, 0] - got.v[:, 0]).abs() > 1.0
    assert 0 < int(bound.sum()) < len(u)


def test_clipping_step_matches_jax(text):
    """3 coupled iterations with CLIPPING_TEMPRATURE= YES (su2_tpu routes
    it to its XLA cons2prim)."""
    t = th.with_lines(text, CLIPPING_TEMPRATURE="YES")
    coupled_steps(th.jax_sim(t), th.torch_sim(t))


# ----------------------------------------------------------------------
# BCGSTAB

def test_bcgstab_matches_jax():
    """krylov.bcgstab on a random diagonally dominant block system (dense
    matvec, block Jacobi), 4 and 30 iterations (the second converges and
    freezes x): x, the relative residual and the count."""
    from su2_tpu.linalg import krylov as jk
    from su2_tpu_torch.linalg import krylov
    rng = np.random.default_rng(4)
    n, v = 30, 3
    a = rng.normal(0.0, 0.3, (n * v, n * v)) + 4.0 * np.eye(n * v)
    dinv = np.linalg.inv(np.stack([a[k * v:(k + 1) * v, k * v:(k + 1) * v]
                                   for k in range(n)]))
    b = rng.normal(0.0, 1e7, (n, v))
    jmv = lambda x: (jnp.asarray(a) @ x.reshape(-1)).reshape(n, v)
    jpc = lambda r: jnp.einsum("nij,nj->ni", jnp.asarray(dinv), r)
    tmv = lambda x: (th.tt(a) @ x.reshape(-1)).reshape(n, v)
    tpc = lambda r: (th.tt(dinv) * r[:, None, :]).sum(-1)
    for m in (4, 30):
        jx, jr, ji = jk.bcgstab(jmv, jpc, jnp.asarray(b), max_iter=m,
                                tol=1e-10)
        tx, tr, ti = krylov.bcgstab(tmv, tpc, th.tt(b), max_iter=m,
                                    tol=1e-10)
        np.testing.assert_allclose(th.npy(tx), np.asarray(jx), rtol=1e-12,
                                   atol=1e-12 * np.abs(np.asarray(jx)).max())
        # the converged residual (m = 30) is at the rounding floor of the
        # updates, where the two packages' sums differ in the last digits
        np.testing.assert_allclose(float(tr), float(jr), rtol=1e-6)
        assert int(ti) == int(ji) == m
    assert float(tr) < 1e-10


@pytest.mark.parametrize("kind", ["JACOBI", "LU_SGS"])
def test_bcgstab_flow_solve_matches_jax(kind):
    """A flow-sized solve (13 x 13 blocks on the quad grid, Krylov budget
    10) with BCGSTAB: the port's operators for it (no one-launch cycle;
    LU_SGS: the sweep-only and matvec-only stencil forms) against
    su2_tpu's make_solver_ops (LU_SGS: its _sgs_call and _matvec_call in
    interpret mode) at rtol 1e-12, and the solutions of both packages'
    bcgstab."""
    from su2_tpu.linalg import blockcsr as jb, krylov as jk
    from su2_tpu_torch.linalg import blockcsr as tb, krylov
    from test_torch_stencil_solve import _quad
    v, m = 13, 10
    s, (ma, jac, _, _, masks, colors) = _quad(v, 31)
    n = s["n"]
    sel_t = s["sel_t"][:, :n]
    jops = jb.make_solver_ops(
        ma, jb.StencilJacobianT(diag=jac.diag, sel_t=jnp.asarray(sel_t)),
        kind, masks, linear_iter=m)
    tmesh = SimpleNamespace(npoint=n, stencil_offsets=s["offsets"])
    tops = tb.make_solver_ops_stencil_t(
        tmesh, th.tt(jac.diag), th.tt(sel_t), kind,
        torch.as_tensor(colors.astype(np.int8)), len(masks), linear_iter=m,
        solver="BCGSTAB")
    assert tops[3] is None
    if kind == "LU_SGS":
        ops = tops[1].__self__
        assert ops.sel_t.dtype == torch.float64 and ops.order is None
    r = np.random.default_rng(32).normal(0, 1, (n, v))
    for jf, tf in zip(jops[:2], tops[:2]):
        np.testing.assert_allclose(th.npy(tf(th.tt(r))),
                                   np.asarray(jf(jnp.asarray(r))),
                                   rtol=1e-12, atol=1e-14)
    jx = jax.jit(lambda b: jk.bcgstab(jops[0], jops[1], b, max_iter=m,
                                      tol=1e-6)[0])(jnp.asarray(r))
    tx = krylov.solve("BCGSTAB", tops, th.tt(r), m, 1e-6)
    np.testing.assert_allclose(th.npy(tx), np.asarray(jx), rtol=1e-9,
                               atol=1e-12 * np.abs(np.asarray(jx)).max())


def test_bcgstab_sst_step_matches_jax(text):
    """3 coupled iterations with LINEAR_SOLVER= BCGSTAB on the explicit
    case: the SST's 2 x 2 system by BCGSTAB over the multicolor sweep
    (su2_tpu: _sgs_call and _matvec_call in interpret mode)."""
    t = th.with_lines(text, LINEAR_SOLVER="BCGSTAB")
    coupled_steps(th.jax_sim(t), th.torch_sim(t))


def test_other_linear_solver_runs_fgmres(text):
    """A LINEAR_SOLVER value other than BCGSTAB (here
    CONJUGATE_GRADIENT) runs FGMRES in su2_tpu's step; the port's 2
    coupled iterations match su2_tpu's with that cfg and equal its own
    FGMRES run bit for bit."""
    t = th.with_lines(text, LINEAR_SOLVER="CONJUGATE_GRADIENT")
    ts = th.torch_sim(t)
    state = coupled_steps(th.jax_sim(t), ts, niter=2)
    fg = th.torch_sim(text)
    ref = (fg.u0, fg.t0) + tuple(fg.initial_turb_state())
    for _ in range(2):
        ref = fg._step(*ref)[:6]
    for a, b in zip(state, ref):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# LINELET

@pytest.mark.parametrize("mesh_kind", ["quad", "triangles"])
def test_build_linelets_matches_jax(text, mesh_kind):
    """The lines of build_linelets array-equal su2_tpu's on the channel
    and on the scrambled triangle channel (both walls seed them)."""
    from su2_tpu.linalg import linelet as jll
    from su2_tpu_torch.linalg import linelet
    if mesh_kind == "quad":
        js, ts = th.jax_sim(text), th.torch_sim(text)
    else:
        js, ts = th.tri_sims(text)
    want = jll.build_linelets(js.mesh, bcs=js.bcs)
    got = linelet.build_linelets(ts.mesh, ts.bcs)
    assert want is not None and want.shape[1] > 2
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("form", ["family", "edges"])
def test_linelet_apply_matches_jax(text, form):
    """make_linelet_apply on random diagonally dominant 13 x 13 blocks
    against su2_tpu's: family-major blocks on the channel (the flow
    system's form), edge-major blocks on the triangle channel, and the
    index maps block_sel_family / block_sel_edges array-equal."""
    from su2_tpu.linalg import blockcsr as jb, linelet as jll
    from su2_tpu_torch.linalg import blockcsr as tb, linelet
    fam = form == "family"
    js, ts = (th.jax_sim(text), th.torch_sim(text)) if fam \
        else th.tri_sims(text)
    lines = linelet.build_linelets(ts.mesh, ts.bcs)
    sel_fn = linelet.block_sel_family if fam else linelet.block_sel_edges
    jsel_fn = jll.block_sel_family if fam else jll.block_sel_edges
    for a, b in zip(sel_fn(ts.mesh, lines), jsel_fn(js.mesh, lines)):
        assert np.array_equal(a, b)
    n, v = ts.mesh.npoint, 13
    slots = len(ts.mesh.fam_offsets) * n if fam else ts.mesh.nedge
    rng = np.random.default_rng(9)
    diag = rng.normal(0, 0.2, (n, v, v)) + 3.0 * np.eye(v)
    oij, oji = (rng.normal(0, 0.2, (slots, v, v)) for _ in range(2))
    jdinv = jb.block_diag_inv(jnp.asarray(diag))
    tdinv = tb.block_diag_inv(th.tt(diag))
    japply = jll.make_linelet_apply(js.mesh, lines, jnp.asarray(diag),
                                    jnp.asarray(oij), jnp.asarray(oji),
                                    jdinv, family=fam)
    lanes = lambda x: th.tt(x.reshape(slots, v * v).T)
    tapply = linelet.make_linelet_apply(
        linelet.line_maps(ts.mesh, lines, family=fam), th.tt(diag),
        lanes(oij), lanes(oji), tdinv)
    r = rng.normal(0.0, 1.0, (n, v))
    want = np.asarray(japply(jnp.asarray(r)))
    np.testing.assert_allclose(th.npy(tapply(th.tt(r))), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_linelet_implicit_step_matches_jax(text):
    """2 coupled iterations of the implicit case (MUSCL +
    Venkatakrishnan) with LINEAR_SOLVER_PREC= LINELET from th.mixed_state:
    the flow's 13 x 13 system preconditioned along the wall-normal lines
    (su2_tpu converts its stencil system to the family form), the SST's
    by the multicolor sweep.  The fields within rtol 1e-10, the residual
    norms within 1e-9: one line runs through 120 of the 153 nodes, and
    the FGMRES solve it preconditions turns the two packages' rounding
    (their applications agree within 1e-14 on this system) into ~1e-11
    in the state and ~1e-10 in the next residual after two iterations,
    where LU_SGS on the same step stays near 1e-12; a third iteration
    takes the near-zero gradients of k past atol 1e-12 max|field|."""
    t = th.with_implicit(text, prec="LINELET")
    js, ts = th.jax_sim(t), th.torch_sim(t)
    assert ts.lines is not None and np.array_equal(ts.lines.lines,
                                                   js.linelets)
    coupled_steps(js, ts, niter=2, u=th.mixed_state(ts, ys=MIXED_YS),
                  implicit=True, rtol=1e-10, res_rtol=1e-9)
