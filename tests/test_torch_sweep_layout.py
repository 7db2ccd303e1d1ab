"""The color-major lane layout of K5's sweep (linalg/stencil_solve.py
color_order and to_color_major) on the CPU: the layout's invariants, and
the tests' model of K5's sweep over it (torch_helpers.
color_major_sgs_matvec: each pass over its color's lanes only) against
the plain sweep over the natural layout and against su2_tpu's sweep
kernels in interpret mode, on proper colorings with 2, 3 and 4 colors, on
masks that are not a proper coloring, at n not a multiple of a thread
block and with a color that has no node.  The kernel itself is held
against the plain version on the card (test_torch_cuda.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

WIDTHS = (2, 3, 7, 13)
# the pins of test_sgs_matvec_plain_matches_jax (f64) and of the K5 card
# checks (f32 with bf16 sweep blocks): rtol, atol as a fraction of the max
PINS = {"f64": (1e-12, 1e-14), "mixed": (1e-5, 1e-6)}


def _system(coloring, v, n=517, seed=3):
    offsets, nc = th.COLORINGS[coloring]
    return th.band_system(n, v, offsets, nc, seed=seed)


def _color_major(args, r, matvec=True):
    """The model's (z, w) over the layout StencilSolveOps makes on the
    card."""
    from su2_tpu_torch.linalg import stencil_solve as ts
    order = ts.color_order(args["colors"])
    selp, dinv = ts.to_color_major(order, args["selp_t"], args["dinv_t"],
                                   args["selp_t"].dtype)
    return th.color_major_sgs_matvec(
        selp, args["selm_t"], dinv, args["diag_t"], args["colors"], order, r,
        args["offsets"], args["ncolor"], matvec)


def _close(got, want, pins):
    rtol, afrac = pins
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            w = th.npy(w).astype(np.float64)
            np.testing.assert_allclose(th.npy(g).astype(np.float64), w,
                                       rtol=rtol,
                                       atol=afrac * np.abs(w).max())


@pytest.mark.parametrize("ncolor,used", [(2, (0, 1)), (4, (0, 1, 2, 3)),
                                         (3, (0, 2))],
                         ids=["two", "four", "empty-color"])
def test_color_order(ncolor, used):
    """color_order is a permutation that lists the nodes by color, each
    color's nodes in node order; an unused color has an empty run."""
    from su2_tpu_torch.linalg import stencil_solve as ts
    rng = np.random.default_rng(1)
    colors = rng.choice(used, 1001).astype(np.int8)
    order = ts.color_order(torch.as_tensor(colors))
    assert order.dtype == torch.int32
    o = order.numpy()
    assert np.array_equal(np.sort(o), np.arange(1001))
    want = np.concatenate([np.flatnonzero(colors == c)
                           for c in range(ncolor)])
    assert np.array_equal(o, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16],
                         ids=["f64", "bf16"])
def test_color_major_lanes(dtype):
    """to_color_major puts node order[i]'s blocks (cast to the sweep dtype)
    and dinv in lane i, exactly."""
    from su2_tpu_torch.linalg import stencil_solve as ts
    args, _ = th.stencil_args(_system("proper3", 3), torch.float32)
    order = ts.color_order(args["colors"])
    selp, dinv = ts.to_color_major(order, args["selm_t"], args["dinv_t"],
                                dtype)
    idx = order.long()
    assert selp.dtype == dtype
    assert torch.equal(selp, args["selm_t"].to(dtype)[:, idx])
    assert torch.equal(dinv, args["dinv_t"][:, idx])
    inv = torch.empty_like(idx)
    inv[idx] = torch.arange(idx.numel())
    assert torch.equal(selp[:, inv], args["selm_t"].to(dtype))


CASES = [(c, v) for c in th.COLORINGS for v in WIDTHS]


@pytest.mark.parametrize("coloring,v", CASES,
                         ids=[f"{c}-v{v}" for c, v in CASES])
def test_color_major_sweep_matches_plain(coloring, v):
    """The sweep over the color-major layout (each pass over its color's
    lanes only) gives sgs_matvec_plain's z and w, sweep + matvec and sweep
    only, in float64 and with bf16 sweep blocks (the mixed tier) in
    float32, at PINS (the two sum a node's block products in different
    tensor positions, so they round apart in the last bits)."""
    from su2_tpu_torch.linalg import stencil_solve as ts
    s = _system(coloring, v)
    for dtype, mixed in ((torch.float64, False), (torch.float32, True)):
        args, r = th.stencil_args(s, dtype, mixed)
        for matvec in (True, False):
            _close(_color_major(args, r, matvec),
                   ts.sgs_matvec_plain(**args, r=r, matvec=matvec),
                   PINS["mixed" if mixed else "f64"])


def test_color_major_sweep_empty_color():
    """A color with no node: its lane run is empty and its passes change
    nothing; the sweep over the layout gives sgs_matvec_plain's (float64,
    n = 517)."""
    from su2_tpu_torch.linalg import stencil_solve as ts
    s = _system("proper4", 7)
    colors = np.array([(0, 2, 3)[p % 3] for p in range(s["n"])])
    s = th.recolor(s, colors, 4)
    args, r = th.stencil_args(s, torch.float64)
    assert int((args["colors"] == 1).sum()) == 0
    _close(_color_major(args, r), ts.sgs_matvec_plain(**args, r=r),
           PINS["f64"])


JAX_CASES = [(c, v, mixed) for c, v in (("proper2", 2), ("roundrobin4", 2),
                                        ("proper3", 7), ("proper4", 3))
             for mixed in (False, True)]


@pytest.mark.parametrize("coloring,v,mixed", JAX_CASES,
                         ids=[f"{c}-v{v}-{'mixed' if m else 'f64'}"
                              for c, v, m in JAX_CASES])
def test_color_major_sweep_matches_jax(coloring, v, mixed):
    """The sweep + matvec over the color-major layout against
    su2_tpu's _sgs_matvec_call / _sgs_matvec_mixed_call in interpret mode,
    at test_sgs_matvec_plain_matches_jax's pins: f64 rtol 1e-12, atol
    1e-14 of the field's max; mixed rtol 2e-5, atol 1e-6 of the max."""
    from su2_tpu.pallas import stencil_solve as stks
    s = _system(coloring, v)
    jdt, tdt = (jnp.float32, torch.float32) if mixed \
        else (jnp.float64, torch.float64)
    j = {k: jnp.asarray(s[k], jdt)
         for k in ("sel_t", "dinv_t", "diag_t", "masks_t", "r_t")}
    kw = dict(offsets=s["offsets"], v=v, ncolor=s["ncolor"], interpret=True)
    if mixed:
        want = stks._sgs_matvec_mixed_call(
            j["sel_t"].astype(jnp.bfloat16), j["sel_t"], j["dinv_t"],
            j["diag_t"], j["masks_t"], j["r_t"], **kw)
    else:
        want = stks._sgs_matvec_call(j["sel_t"], j["dinv_t"], j["diag_t"],
                                     j["masks_t"], j["r_t"], **kw)
    args, r = th.stencil_args(s, tdt, mixed)
    got = _color_major(args, r)
    rtol, afrac = (2e-5, 1e-6) if mixed else (1e-12, 1e-14)
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt, np.float64)[:, :s["n"]].T
        np.testing.assert_allclose(th.npy(g).astype(np.float64), wnt,
                                   rtol=rtol, atol=afrac * np.abs(wnt).max())


def test_stencil_solve_ops_natural_on_the_cpu():
    """On the CPU (and for a one-launch K6 solve) StencilSolveOps keeps the
    natural layout and no node order: the plain version and K6 read it."""
    from types import SimpleNamespace
    from su2_tpu_torch.linalg import stencil_solve as ts
    args, _ = th.stencil_args(_system("proper2", 2), torch.float32)
    n = args["colors"].shape[0]
    mesh = SimpleNamespace(stencil_offsets=args["offsets"])
    diag = args["diag_t"].T.reshape(n, 2, 2)
    ops = ts.StencilSolveOps(mesh, args["selm_t"], diag, diag,
                             args["colors"], args["ncolor"],
                             sel_dtype=torch.bfloat16)
    assert ops.order is None and not ops.color_major
    assert torch.equal(ops.sel_t, args["selm_t"].to(torch.bfloat16))


K6_CASES = [(c, v, mixed) for c, v in (("proper2", 13), ("roundrobin4", 7))
            for mixed in (False, True)]


@pytest.mark.parametrize("coloring,v,mixed", K6_CASES,
                         ids=[f"{c}-v{v}-{'mixed' if m else 'f64'}"
                              for c, v, m in K6_CASES])
def test_color_major_fgmres_matches_plain(coloring, v, mixed):
    """What K6 computes at v >= 7: one FGMRES(10) cycle (krylov.fgmres)
    whose sweeps run over the color-major layout (the model of
    torch_helpers.color_major_sgs_matvec, bf16 sweep blocks in the mixed
    tier) gives fgmres_plain's iterations, and its x within the K6 card
    pins (f64: rtol 1e-9, atol 1e-12 of max|x|; mixed 2e-5 of max|x|)."""
    from su2_tpu_torch.linalg import krylov, stencil_solve as ts
    dtype = torch.float32 if mixed else torch.float64
    args, r = th.stencil_args(_system(coloring, v), dtype, mixed)
    pm = lambda x: _color_major(args, x)
    x, rel, it = krylov.fgmres(None, None, r, max_iter=10, tol=1e-8,
                               precond_matvec=pm)
    wx, wrel, wit = ts.fgmres_plain(**args, b=r, m=10, tol=1e-8)
    assert int(it) == int(wit)
    x, wx = th.npy(x).astype(np.float64), th.npy(wx).astype(np.float64)
    scale = np.abs(wx).max()
    if mixed:
        assert np.abs(x - wx).max() <= 2e-5 * scale
    else:
        np.testing.assert_allclose(x, wx, rtol=1e-9, atol=1e-12 * scale)
