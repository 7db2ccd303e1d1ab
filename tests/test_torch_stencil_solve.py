"""su2_tpu_torch's stencil solve (linalg/stencil_solve.py, the multicolor
SGS routing of linalg/blockcsr.py) against su2_tpu's pallas/stencil_solve.py
kernels in interpret mode, as tests/test_stencil.py and
tests/test_stencil_tiled.py run them.  The port's plain versions repeat the
reference's arithmetic in the same order, so the f64 pins are near
rounding."""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

BAND = {"band2": (2, (-9, -8, -7, -1, 1, 7, 8, 9)),
        "band3": (3, (-5, -1, 1, 5)),
        # the flow's widths (nDim + nSpecies + 2: the 3-species flat plate,
        # the 9-species channel) on a channel-like stencil
        "band7": (7, (-9, -1, 1, 9)),
        "band13": (13, (-9, -1, 1, 9)),
        # widths of the run-time-width instance on the card: the flow at 1
        # species in 2D (4), 5 species in 2D (9) and 3D (10), 16 species in
        # 3D (21)
        "band4": (4, (-9, -1, 1, 9)),
        "band9": (9, (-9, -1, 1, 9)),
        "band10": (10, (-9, -1, 1, 9)),
        "band21": (21, (-9, -1, 1, 9))}
# the run-time-width instance's widths of the plain-versus-su2_tpu checks
RUNTIME_V = (4, 9, 10, 21)


def _quad(v, seed, f32=False):
    """A quad-grid stencil system built as tests/test_stencil.py builds
    its own, with greedy_coloring masks; also returns the JAX objects."""
    from su2_tpu.geometry.dual_grid import build_dual_grid
    from su2_tpu.geometry.mesh_data import mesh_arrays
    from su2_tpu.linalg import blockcsr
    from test_stencil import _quad_grid
    ma = mesh_arrays(build_dual_grid(_quad_grid(6, 7)))
    rng = np.random.default_rng(seed)
    dt = jnp.float32 if f32 else jnp.float64
    jac = blockcsr.BlockJacobian(
        diag=jnp.asarray(rng.normal(0, .2, (ma.npoint, v, v))
                         + 3 * np.eye(v), dt),
        off_ij=jnp.asarray(rng.normal(0, .2, (ma.nedge, v, v)), dt),
        off_ji=jnp.asarray(rng.normal(0, .2, (ma.nedge, v, v)), dt))
    colors = blockcsr.greedy_coloring(np.asarray(ma.node_nbrs))
    masks = [jnp.asarray(colors == c) for c in range(colors.max() + 1)]
    sel = blockcsr.gather_offdiag(ma, jac)                    # (K, n, v, v)
    dinv = blockcsr.block_jacobi_factor(jac)
    n, k = ma.npoint, sel.shape[0]
    npad = -(-n // 128) * 128
    pad = lambda x: np.concatenate(
        [np.asarray(x, np.float64), np.zeros(x.shape[:-1] + (npad - n,))], -1)
    lanes = lambda b: pad(np.asarray(b).transpose(1, 2, 0).reshape(v * v, n))
    sys_ = dict(n=n, v=v, offsets=tuple(int(o) for o in ma.stencil_offsets),
                ncolor=len(masks),
                sel_t=pad(np.asarray(sel).transpose(0, 2, 3, 1)
                          .reshape(k * v * v, n)),
                dinv_t=lanes(dinv), diag_t=lanes(jac.diag),
                masks_t=pad(np.stack([np.asarray(mk, np.float64)
                                      for mk in masks])),
                r_t=pad(rng.normal(0, 1, (v, n))))
    return sys_, (ma, jac, sel, dinv, masks, colors)


def _system(name):
    """A band system of BAND, or "quad" ("quad<v>": at width v) as _quad
    builds it."""
    if name.startswith("quad"):
        return _quad(int(name[4:] or 2), 5)[0]
    v, offsets = BAND[name]
    return th.band_system(1000, v, offsets, 4)


CALLS = ("sgs_matvec", "sgs", "matvec", "sgs_matvec_mixed",
         "tiled_sgs_matvec", "tiled_sgs", "tiled_sgs_matvec_mixed")


# every call on the SST-sized systems and v = 7; at v = 13 (where each
# interpret-mode trace takes ~20 s) the full-field sweep + matvec and
# matvec, and the mixed calls of the flow's tiers (resident and windowed);
# at the run-time instance's widths the sweep + matvec on a quad system
# (4, 9, 10, 21: ~6, 12, 14 and 60 s), on band systems at 9 the matvec
# only (LINELET's form) and the mixed sweep + matvec (the 5-species flow's
# mixed tier)
SGS_CASES = [(system, call) for system in ("band2", "band3", "quad", "band7")
             for call in CALLS] + [
    ("band13", call) for call in ("sgs_matvec", "matvec", "sgs_matvec_mixed",
                                  "tiled_sgs_matvec_mixed")] + [
    (f"quad{v}", "sgs_matvec") for v in RUNTIME_V] + [
    ("band9", "matvec"), ("band9", "sgs_matvec_mixed")]


@pytest.mark.parametrize("system,call", SGS_CASES,
                         ids=[f"{s}-{c}" for s, c in SGS_CASES])
def test_sgs_matvec_plain_matches_jax(system, call):
    """sgs_matvec_plain (sweep + matvec, sweep only, matvec only, mixed
    bf16 sweep blocks) against the reference's full-field calls and its
    tiled calls (T = 256, H = (2 ncolor) max|offset| rounded to 128, as in
    tests/test_stencil_tiled.py): one design is the counterpart of both.
    f64 rtol 1e-12 (same operations in the same order; atol 1e-14 of the
    field's max for exact cancellations); the mixed f32 calls rtol 2e-5,
    atol 1e-6 of the max (f32 rounding of sweeps that differ only in where
    the compiler fuses)."""
    from su2_tpu.pallas import stencil_solve as stks
    from su2_tpu_torch.linalg import stencil_solve as ts
    s = _system(system)
    mixed = call.endswith("mixed")
    jdt, tdt = (jnp.float32, torch.float32) if mixed \
        else (jnp.float64, torch.float64)
    j = {k: jnp.asarray(s[k], jdt)
         for k in ("sel_t", "dinv_t", "diag_t", "masks_t", "r_t")}
    selp = j["sel_t"].astype(jnp.bfloat16) if mixed else j["sel_t"]
    kw = dict(offsets=s["offsets"], v=s["v"], ncolor=s["ncolor"],
              interpret=True)
    if call.startswith("tiled"):
        maxoff = max(abs(o) for o in s["offsets"])
        H = stks._round128(2 * s["ncolor"] * maxoff)
        T = 256
        ntiles = -(-j["r_t"].shape[-1] // T)
        ext = lambda x: stks._extend_lanes(x, H, ntiles * T + 2 * H)
        kw.update(T=T, H=H, ntiles=ntiles)
        if call == "tiled_sgs":
            want = [stks._tiled_sgs_call(ext(selp), ext(j["dinv_t"]),
                                         ext(j["masks_t"]), ext(j["r_t"]),
                                         **kw)]
        elif mixed:
            want = stks._tiled_sgs_matvec_mixed_call(
                ext(selp), ext(j["sel_t"]), ext(j["dinv_t"]),
                ext(j["diag_t"]), ext(j["masks_t"]), ext(j["r_t"]), **kw)
        else:
            want = stks._tiled_sgs_matvec_call(
                ext(j["sel_t"]), ext(j["dinv_t"]), ext(j["diag_t"]),
                ext(j["masks_t"]), ext(j["r_t"]), **kw)
    elif call == "sgs_matvec":
        want = stks._sgs_matvec_call(j["sel_t"], j["dinv_t"], j["diag_t"],
                                     j["masks_t"], j["r_t"], **kw)
    elif call == "sgs":
        want = [stks._sgs_call(j["sel_t"], j["dinv_t"], j["masks_t"],
                               j["r_t"], **kw)]
    elif call == "matvec":
        kw.pop("ncolor")
        want = [stks._matvec_call(j["sel_t"], j["diag_t"], j["r_t"], **kw)]
    else:
        want = stks._sgs_matvec_mixed_call(selp, j["sel_t"], j["dinv_t"],
                                           j["diag_t"], j["masks_t"],
                                           j["r_t"], **kw)
    args, r = th.stencil_args(s, tdt, mixed)
    z, w = ts.sgs_matvec_plain(**args, r=r, sweep=call != "matvec",
                               matvec=not call.endswith("sgs"))
    got = [w] if call == "matvec" else ([z] if call.endswith("sgs")
                                        else [z, w])
    rtol, afrac = (2e-5, 1e-6) if mixed else (1e-12, 1e-14)
    n = s["n"]
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt, np.float64)[:, :n].T
        np.testing.assert_allclose(th.npy(g).astype(np.float64), wnt,
                                   rtol=rtol, atol=afrac * np.abs(wnt).max())


FGMRES_CASES = [  # (m, tol, right side, block width)
    (3, 1e-6, "random", 2), (3, 1e-12, "random", 2), (10, 1e-6, "random", 2),
    (10, 1e-12, "random", 2), (3, 1e-6, "scaled", 2), (3, 1e-6, "zero", 2),
    (3, 1e-6, "random", 7), (3, 1e-6, "scaled", 7), (3, 1e-12, "random", 13)
    ] + [(3, 1e-6, "random", v) for v in RUNTIME_V]
# widths whose reference cycle is its Krylov loop over the (z, A z) kernel
LOOP_V = (21,)


@pytest.mark.parametrize(
    "m,tol,rhs,v", FGMRES_CASES,
    ids=[f"m{m}-{t:g}-{r}" + (f"-v{v}" if v != 2 else "")
         for m, t, r, v in FGMRES_CASES])
def test_fgmres_plain_matches_jax(m, tol, rhs, v):
    """fgmres_plain against the one-launch _fgmres_call (f64, v = 2, and
    the flow's v = 7 and 13, and 4, 9, 10 and 21) at the pins of tests/test_stencil.py:259-262
    (x rtol 1e-9, atol 1e-12; rel rtol 1e-8; equal iterations), a right
    side scaled by 1e18 (the pow2 scaling; atol 1e-3 as there) and b = 0.
    tol 1e-12 runs all 3 iterations at m = 3; at m = 10 and v = 2 it stops
    after 8, with the relative residual at ~2e-13, where the two packages'
    dot summation orders show, hence atol 1e-15 on rel.  At v = 21 the
    reference's cycle is its Krylov loop over its (z, A z) kernel (as
    SU2_TPU_FUSED_FGMRES_OFF runs it: the one-launch cycle's arithmetic),
    whose interpret-mode trace the sweep's check at this width has made
    (the one-launch kernel's own trace takes ~150 s there)."""
    from su2_tpu.pallas import stencil_solve as stks
    from su2_tpu_torch.linalg import stencil_solve as ts
    s, (ma, jac, sel, dinv, masks, _) = _quad(v, 13)
    b = np.random.default_rng(14).normal(0, 1, (s["n"], v))
    b = {"random": b, "scaled": b * 1e18, "zero": 0.0 * b}[rhs]
    ops = stks.StencilSolveOps(ma, sel, dinv, jac.diag, masks)
    if v in LOOP_V:
        from su2_tpu.linalg import krylov as jk
        wx, wrel, wit = jk.fgmres(None, None, jnp.asarray(b), max_iter=m,
                                  tol=tol, precond_matvec=ops.precond_matvec)
    else:
        wx, wrel, wit = ops.fgmres(jnp.asarray(b), m, tol)
    args, _ = th.stencil_args(s, torch.float64)
    x, rel, it = ts.fgmres_plain(**args, b=th.tt(b), m=m, tol=tol)
    atol = 1e-3 if rhs == "scaled" else 1e-12
    np.testing.assert_allclose(th.npy(x), np.asarray(wx), rtol=1e-9,
                               atol=atol)
    np.testing.assert_allclose(float(rel), float(wrel), rtol=1e-8,
                               atol=1e-15)
    assert int(it) == int(wit)
    if tol == 1e-12 and rhs == "random":
        assert int(it) == (min(m, 8) if v == 2 else m)


@pytest.mark.parametrize("v,m", [(3, 3), (3, 10), (7, 3), (13, 3), (9, 3)],
                         ids=["3", "10", "v7-3", "v13-3", "v9-3"])
def test_fgmres_mixed_plain_matches_jax(v, m):
    """fgmres_plain with bf16 sweep blocks and f32 matvec blocks against
    _fgmres_mixed_call (f32, v = 3 and the flow's 7, 13 and 9, the
    5-species flow's one-launch mixed tier) at the pins of
    tests/test_stencil.py:315-317: x within rtol 2e-5, atol 2e-5; equal
    iterations."""
    from su2_tpu.pallas import stencil_solve as stks
    from su2_tpu_torch.linalg import stencil_solve as ts
    s, (ma, jac, sel, dinv, masks, _) = _quad(v, 17, f32=True)
    b = np.random.default_rng(18).normal(0, 1, (s["n"], v))
    ops = stks.StencilSolveOps(ma, sel, dinv, jac.diag, masks,
                               sel_dtype=jnp.bfloat16, m=m)
    assert ops.fgmres_mixed_ok
    wx, _, wit = ops.fgmres_mixed(jnp.asarray(b, jnp.float32), m, 1e-6)
    args, _ = th.stencil_args(s, torch.float32, mixed=True)
    x, _, it = ts.fgmres_plain(**args, b=th.tt(b, torch.float32), m=m,
                               tol=1e-6)
    np.testing.assert_allclose(th.npy(x), np.asarray(wx), rtol=2e-5,
                               atol=2e-5)
    assert int(it) == int(wit)


@pytest.mark.parametrize("mesh", ["channel", "quad"])
def test_greedy_coloring_identical(mesh):
    from su2_tpu.linalg import blockcsr as jb
    from su2_tpu_torch.linalg import blockcsr as tb
    if mesh == "quad":
        nbrs = np.asarray(_quad(2, 0)[1][0].node_nbrs)
    else:
        from su2_tpu_torch.geometry import dual_grid, structured
        nbrs = dual_grid.build_dual_grid(
            structured.channel_mesh(*th.CHANNEL)).node_nbrs
    want = jb.greedy_coloring(nbrs)
    got = tb.greedy_coloring(nbrs)
    assert np.array_equal(got, want) and got.dtype == want.dtype


# every block width of the stencil solve: the SST's 2, 3, and the flow's
# nDim + nSpecies + 2 at 1 to 16 species in 2D and 3D
WIDTHS = tuple(range(2, 22))


def _sizes():
    pts = [1, 127, 128, 129, 153, 4096, 9072, 12288, 12289, 36000, 49152,
           49153, 100000, 142317, 200000, 331000, 419000, 420000, 565000,
           1_000_000, 2_260_000, 3_000_000]
    return pts


@pytest.mark.parametrize("pred", ["supported", "fgmres_supported",
                                  "sgs_matvec_mixed_supported",
                                  "fgmres_mixed_supported"])
def test_tier_predicates_match_jax(pred):
    """The port's pure size predicates equal the reference's over a table
    of sizes, every block width from 2 to 21, dtypes and Krylov budgets
    (the reference gets a mesh stand-in, so nothing is allocated)."""
    from su2_tpu.pallas import stencil_solve as stks
    from su2_tpu_torch.linalg import stencil_solve as ts
    dts = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]
    if pred == "supported":
        dts.append((jnp.bfloat16, torch.bfloat16))
    seen = set()
    for n in _sizes():
        for k in (4, 8):
            mesh = SimpleNamespace(npoint=n, n_shards=1,
                                   stencil_offsets=tuple(range(1, k + 1)))
            for v in WIDTHS:
                for nc in (2, 5):
                    for m in (5, 10):
                        for jd, td in dts:
                            if pred == "supported":
                                w = stks.supported(mesh, v, jd, nc)
                                g = ts.supported(n, k, v, td, nc)
                            elif pred == "fgmres_supported":
                                w = stks.fgmres_supported(mesh, v, jd, nc, m)
                                g = ts.fgmres_supported(n, k, v, td, nc, m)
                            elif pred == "sgs_matvec_mixed_supported":
                                w = stks.sgs_matvec_mixed_supported(mesh, v,
                                                                    nc)
                                g = ts.sgs_matvec_mixed_supported(n, k, v,
                                                                  nc)
                            else:
                                w = stks.fgmres_mixed_supported(mesh, v, nc,
                                                                m)
                                g = ts.fgmres_mixed_supported(n, k, v, nc, m)
                            assert g == w, (pred, n, k, v, nc, m, jd)
                            seen.add(g)
    assert seen == {True, False}


def test_tier_choice_of_the_smoke_sizes():
    """The SST system (K = 4, v = 2, 2 colors, m = 10): one launch at
    9,072 nodes in f32 and f64; the per-iteration mixed tier at 142,317
    nodes in f32; in f64 there, past the full-precision gate, K5 at full
    precision inside the Krylov loop (make_solver_ops_stencil_t)."""
    from su2_tpu_torch.linalg import stencil_solve as ts
    for dt in (torch.float32, torch.float64):
        assert ts.fgmres_supported(9072, 4, 2, dt, 2, 10)
        assert not ts.supported(142317, 4, 2, dt, 2)
    assert ts.supported(142317, 4, 2, torch.bfloat16, 2)
    assert ts.sgs_matvec_mixed_supported(142317, 4, 2, 2)
    assert not ts.fgmres_mixed_supported(142317, 4, 2, 2, 10)


@pytest.mark.parametrize("kind,v", [("LU_SGS", 2), ("ILU0", 2),
                                    ("LU_SGS", 13)],
                         ids=["LU_SGS", "ILU0", "LU_SGS-v13"])
def test_make_solver_ops_stencil_t_matches_jax(kind, v):
    """The four operators of make_solver_ops_stencil_t on the quad grid
    (f64, the one-launch tier) against the reference's: matvec, sweep,
    (z, A z) at rtol 1e-12, the solve at the FGMRES pins.  v = 13 (the
    flow's blocks, with colors) against su2_tpu's make_solver_ops on the
    same StencilJacobianT: the same tier (full-precision sweep blocks, one
    launch) and the same FGMRES solution, at Krylov budget 3."""
    from su2_tpu.linalg import blockcsr as jb
    from su2_tpu_torch.linalg import blockcsr as tb
    s, (ma, jac, sel, dinv, masks, colors) = _quad(v, 21)
    n, k = s["n"], len(s["offsets"])
    m = 10 if v == 2 else 3
    sel_t = s["sel_t"][:, :n]
    if v == 2:
        jops = jb.make_solver_ops_stencil_t(ma, jac.diag, jnp.asarray(sel_t),
                                            kind, masks, linear_iter=m)
    else:
        jops = jb.make_solver_ops(
            ma, jb.StencilJacobianT(diag=jac.diag, sel_t=jnp.asarray(sel_t)),
            kind, masks, linear_iter=m)
    tmesh = SimpleNamespace(npoint=n, stencil_offsets=s["offsets"])
    tops = tb.make_solver_ops_stencil_t(
        tmesh, th.tt(jac.diag), th.tt(sel_t), kind,
        torch.as_tensor(colors.astype(np.int8)), len(masks), linear_iter=m)
    assert all(op is not None for op in tops) and jops[3] is not None
    assert tops[2].__self__.sel_t.dtype == torch.float64
    r = np.random.default_rng(22).normal(0, 1, (n, v))
    for jf, tf in zip(jops[:2], tops[:2]):
        np.testing.assert_allclose(th.npy(tf(th.tt(r))),
                                   np.asarray(jf(jnp.asarray(r))),
                                   rtol=1e-12, atol=1e-14)
    for a, b in zip(tops[2](th.tt(r)), jops[2](jnp.asarray(r))):
        np.testing.assert_allclose(th.npy(a), np.asarray(b), rtol=1e-12,
                                   atol=1e-14)
    tx, trel, tit = tops[3](th.tt(r), m, 1e-6)
    jx, jrel, jit = jops[3](jnp.asarray(r), m, 1e-6)
    np.testing.assert_allclose(th.npy(tx), np.asarray(jx), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(float(trel), float(jrel), rtol=1e-8)
    assert int(tit) == int(jit)
    assert k == 4


def _offset_sets():
    """Stencils of the channel meshes (+-1, +-ny) from the test's to the
    largest smoke size, a wide 2D quad stencil and 3D-like ones."""
    sets = [(-ny, -1, 1, ny) for ny in (9, 48, 189, 377, 1000, 1500, 4000)]
    return sets + [(-8, -7, -6, -1, 1, 6, 7, 8), (-2500, -50, -1, 1, 50, 2500)]


def test_tiled_tier_predicate_matches_jax():
    """tiled_supported equals the reference's tile_plan (bf16 sweep and
    f32 matvec blocks, one shard) is not None over stencils, every width
    from 2 to 21 and color counts, both answers seen."""
    from su2_tpu.pallas import stencil_solve as stks
    from su2_tpu_torch.linalg import stencil_solve as ts
    seen = set()
    for offsets in _offset_sets():
        mesh = SimpleNamespace(npoint=565500, n_shards=1,
                               stencil_offsets=offsets)
        for v in WIDTHS:
            for nc in (2, 5):
                want = stks.tile_plan(mesh, v, nc, 2, True) is not None
                assert ts.tiled_supported(offsets, v, nc) == want, \
                    (offsets, v, nc)
                seen.add(want)
    assert seen == {True, False}


def _reference_tier(mesh, v, jdt, nc, m):
    """(sweep block dtype name, one launch) of the reference's
    make_solver_ops_stencil_t for an SGS-class solve, from its own
    predicates in its own order; "xla" where it sweeps with XLA ops (the
    port: full-precision blocks)."""
    from su2_tpu.pallas import stencil_solve as stks
    name = jnp.dtype(jdt).name
    if stks.supported(mesh, v, jdt, nc):
        return name, stks.fgmres_supported(mesh, v, jdt, nc, m)
    if jdt == jnp.float32 and stks.supported(mesh, v, jnp.bfloat16, nc):
        return "bfloat16", (stks.sgs_matvec_mixed_supported(mesh, v, nc)
                            and stks.fgmres_mixed_supported(mesh, v, nc, m))
    if jdt == jnp.float32 and stks.tile_plan(mesh, v, nc, 2, True):
        return "bfloat16", False
    return "xla", False


def test_solve_tier_matches_jax():
    """solve_tier (the tiers make_solver_ops_stencil_t picks) against the
    reference's choice over sizes, stencils, every width from 2 to 21 (the
    SST's 2, the flow's nDim + nSpecies + 2 at 1 to 16 species), f32 and
    f64, at Krylov budgets 5 and 10; and at the flow's
    v = 13 on the smoke sizes' channels (2 colors, FGMRES(10)): the mixed
    one-launch tier at 9,072 nodes, the mixed per-iteration tier (windowed
    in the reference) at 142,317 and 565,500, full precision per
    iteration in f64."""
    from su2_tpu_torch.linalg import stencil_solve as ts
    seen = set()
    for n in (153, 9072, 36000, 142317, 565500):
        for offsets in _offset_sets():
            mesh = SimpleNamespace(npoint=n, n_shards=1,
                                   stencil_offsets=offsets)
            for v in WIDTHS:
                for jdt, tdt in ((jnp.float32, torch.float32),
                                 (jnp.float64, torch.float64)):
                    for m in (5, 10):
                        want = _reference_tier(mesh, v, jdt, 2, m)
                        sel_dtype, one = ts.solve_tier(n, offsets, v, tdt, 2,
                                                       m)
                        got = str(sel_dtype).split(".")[-1]
                        if want[0] == "xla":
                            want = (got if got == str(tdt).split(".")[-1]
                                    else "xla", want[1])
                        assert (got, one) == want, (n, offsets, v, tdt, m)
                        seen.add(want)
    assert {w[0] for w in seen} == {"float32", "float64", "bfloat16"}
    smoke = {9072: 48, 142317: 189, 565500: 377}
    for n, ny in smoke.items():
        offsets = (-ny, -1, 1, ny)
        assert ts.solve_tier(n, offsets, 13, torch.float32, 2, 10) == \
            (torch.bfloat16, n == 9072)
        assert ts.solve_tier(n, offsets, 13, torch.float64, 2, 10) == \
            (torch.float64, False)
    assert ts.solve_tier(565500, (-4000, -1, 1, 4000), 13, torch.float32, 2,
                         10) == (torch.float32, False)


@pytest.mark.parametrize("kind", ["LU_SGS", "ILU0"])
def test_f64_past_the_gate_matches_jax(monkeypatch, kind):
    """Past the full-precision gate in f64 the reference sweeps with XLA ops
    (multicolor_sgs_apply, no solve kernel); the port keeps the stencil
    operators (K5 at full precision on the card, sgs_matvec_plain here)
    inside the Krylov loop.  matvec at rtol 1e-12; sweep and (z, A z) at
    rtol 1e-11, atol 1e-13 of the max (the two sweeps sum the colors'
    updates in different orders)."""
    from su2_tpu.linalg import blockcsr as jb
    from su2_tpu_torch.linalg import blockcsr as tb, stencil_solve as ts
    s, (ma, jac, sel, dinv, masks, colors) = _quad(2, 23)
    n = s["n"]
    sel_t = s["sel_t"][:, :n]
    jmv, jpc, jpm, jsolve = jb.make_solver_ops_stencil_t(
        ma, jac.diag, jnp.asarray(sel_t), kind, masks, linear_iter=10,
        allow_pallas=False)
    assert jpm is None and jsolve is None
    monkeypatch.setattr(ts, "supported", lambda *a, **kw: False)
    tmesh = SimpleNamespace(npoint=n, stencil_offsets=s["offsets"])
    tmv, tpc, tpm, tsolve = tb.make_solver_ops_stencil_t(
        tmesh, th.tt(jac.diag), th.tt(sel_t), kind,
        torch.as_tensor(colors.astype(np.int8)), len(masks), linear_iter=10)
    assert tsolve is None and isinstance(tpm.__self__, ts.StencilSolveOps)
    assert tpm.__self__.sel_t.dtype == torch.float64
    r = np.random.default_rng(24).normal(0, 1, (n, 2))
    jr = jnp.asarray(r)
    np.testing.assert_allclose(th.npy(tmv(th.tt(r))), np.asarray(jmv(jr)),
                               rtol=1e-12, atol=1e-14)
    jz = jpc(jr)
    z, w = tpm(th.tt(r))
    for got, want in ((tpc(th.tt(r)), jz), (z, jz), (w, jmv(jz))):
        want = np.asarray(want)
        np.testing.assert_allclose(th.npy(got), want, rtol=1e-11,
                                   atol=1e-13 * np.abs(want).max())


def test_sweep_colors_and_refusals():
    """The driver's sweep colors: greedy_coloring as int8 with its count,
    refused past 127 colors; the stencil kernel wrappers refuse CPU
    tensors and block widths outside 2 to 21 (naming the range, before
    any launch); the unported preconditioners name the su2_tpu module that
    has them."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.linalg import blockcsr as tb
    path = np.array([[1, 0], [0, 2], [1, 2]])       # 0 - 1 - 2, self-padded
    colors, ncolor = tb.sweep_colors(path, "cpu")
    assert colors.dtype == torch.int8 and colors.tolist() == [0, 1, 0]
    assert ncolor == 2
    with pytest.raises(ValueError, match="127"):
        tb.sweep_colors(np.tile(np.arange(128), (128, 1)), "cpu")
    s = th.band_system(300, 2, BAND["band2"][1], 4)
    args, r = th.stencil_args(s, torch.float32)
    with pytest.raises(ValueError, match="must be on"):
        kernels.stencil_sgs_matvec(**args, r=r)
    with pytest.raises(ValueError, match="must be on"):
        kernels.stencil_fgmres(**args, b=r, m=5, tol=1e-6)
    # a width past the range of the run-time-width instance, named with
    # the range
    s22 = th.band_system(300, 22, BAND["band3"][1], 4)
    args22, r22 = th.stencil_args(s22, torch.float32)
    for call in (lambda: kernels.stencil_sgs_matvec(**args22, r=r22),
                 lambda: kernels.stencil_fgmres(**args22, b=r22, m=5,
                                                tol=1e-6),
                 lambda: kernels.stencil_fgmres_grid(torch.float32, True, 22,
                                                     300, 10)):
        with pytest.raises(ValueError, match="block width 22;.* 2 to 21"):
            call()
    tmesh = SimpleNamespace(npoint=4, stencil_offsets=(1,))
    for kind, where in tb.UNPORTED_PREC.items():
        with pytest.raises(NotImplementedError, match=where):
            tb.make_solver_ops_stencil_t(tmesh, th.tt(np.ones((4, 2, 2))),
                                         th.tt(np.zeros((4, 4))), kind)
