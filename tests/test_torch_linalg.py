"""su2_tpu_torch linear algebra, SST closures and gradients against su2_tpu
on the 153-node channel and random inputs (float64)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def meshes():
    from su2_tpu.geometry import dual_grid as jd, structured as js
    from su2_tpu.geometry.mesh_data import mesh_arrays as jm
    from su2_tpu_torch.geometry import dual_grid as td, structured as ts
    from su2_tpu_torch.geometry.mesh_data import mesh_arrays as tm
    return (jm(jd.build_dual_grid(js.channel_mesh(*th.CHANNEL)), jnp.float64),
            tm(td.build_dual_grid(ts.channel_mesh(*th.CHANNEL))))


@pytest.mark.parametrize("v", [2, 5])
def test_block_diag_inv_matches(v):
    from su2_tpu.linalg import blockcsr as jb
    from su2_tpu_torch.linalg import blockcsr as tb
    rng = np.random.default_rng(v)
    d = rng.normal(size=(64, v, v)) + 4.0 * np.eye(v)
    np.testing.assert_allclose(th.npy(tb.block_diag_inv(th.tt(d))),
                               np.asarray(jb.block_diag_inv(jnp.asarray(d))),
                               rtol=1e-13, atol=1e-15)


def _stencil_system(jmesh, seed):
    rng = np.random.default_rng(seed)
    n, k = jmesh.npoint, len(jmesh.stencil_offsets)
    diag = rng.normal(size=(n, 2, 2)) * 0.1 + 3.0 * np.eye(2)
    sel = rng.normal(size=(k, 2, 2, n)) * 0.2
    # absent neighbours carry zero blocks, like the SST assembly's
    valid = np.asarray(jmesh.gg_snormal != 0).any(-1)          # (K, nP)
    sel = sel * valid[:, None, None, :]
    return diag, sel.reshape(k * 4, n), rng.normal(size=(n, 2))


def test_stencil_jacobi_ops_and_fgmres_match(meshes):
    """JACOBI matvec / preconditioner of the lane-layout Jacobian and one
    FGMRES(5) cycle, against make_solver_ops_stencil_t + krylov.fgmres."""
    from su2_tpu.linalg import blockcsr as jb, krylov as jk
    from su2_tpu_torch.linalg import blockcsr as tb, krylov as tk
    jmesh, tmesh = meshes
    diag, sel_t, b = _stencil_system(jmesh, 3)
    jmv, jpc, _, _ = jb.make_solver_ops_stencil_t(
        jmesh, jnp.asarray(diag), jnp.asarray(sel_t), "JACOBI")
    tmv, tpc = tb.make_solver_ops_stencil_t(tmesh, th.tt(diag), th.tt(sel_t),
                                            "JACOBI")
    np.testing.assert_allclose(th.npy(tmv(th.tt(b))),
                               np.asarray(jmv(jnp.asarray(b))), rtol=1e-13)
    np.testing.assert_allclose(th.npy(tpc(th.tt(b))),
                               np.asarray(jpc(jnp.asarray(b))), rtol=1e-13)
    jx, jres, jit = jk.fgmres(jmv, jpc, jnp.asarray(b), max_iter=5, tol=1e-6)
    tx, tres, tit = tk.fgmres(tmv, tpc, th.tt(b), max_iter=5, tol=1e-6)
    np.testing.assert_allclose(th.npy(tx), np.asarray(jx), rtol=1e-11,
                               atol=1e-13)
    np.testing.assert_allclose(float(tres), float(jres), rtol=1e-9)
    assert int(tit) == int(jit)
    with pytest.raises(NotImplementedError, match="stencil_solve"):
        tb.make_solver_ops_stencil_t(tmesh, th.tt(diag), th.tt(sel_t),
                                     "LU_SGS")


@pytest.mark.parametrize("method", ["WEIGHTED_LEAST_SQUARES", "GREEN_GAUSS"])
def test_gradients_match(meshes, method):
    from su2_tpu.ops import gradients as jg
    from su2_tpu_torch.ops import gradients as tg
    jmesh, tmesh = meshes
    q = np.random.default_rng(4).normal(size=(jmesh.npoint, 5))
    fn = "weighted_least_squares" if method.startswith("W") else "green_gauss"
    np.testing.assert_allclose(th.npy(getattr(tg, fn)(tmesh, th.tt(q))),
                               np.asarray(getattr(jg, fn)(jmesh,
                                                          jnp.asarray(q))),
                               rtol=1e-12, atol=1e-12)


def test_sst_closures_match():
    """blending, eddy viscosity, strain/vorticity of the SST model."""
    from su2_tpu.turbulence import sst as js
    from su2_tpu_torch.turbulence import sst as ts
    rng = np.random.default_rng(5)
    n = 200
    k, w = rng.uniform(1e-6, 10.0, n), rng.uniform(1.0, 1e6, n)
    gk, gw = rng.normal(size=(n, 2)), rng.normal(size=(n, 2)) * 1e3
    mu, rho, dist = (rng.uniform(1e-5, 5e-5, n), rng.uniform(0.2, 2.0, n),
                     rng.uniform(1e-4, 0.1, n))
    jargs = [jnp.asarray(a) for a in (k, w, gk, gw, mu, rho, dist)]
    targs = [th.tt(a) for a in (k, w, gk, gw, mu, rho, dist)]
    for a, b in zip(ts.blending(*targs), js.blending(*jargs)):
        np.testing.assert_allclose(th.npy(a), np.asarray(b), rtol=1e-13)
    g = rng.normal(size=(n, 2, 2)) * 100.0
    sa, va = ts.strain_and_vorticity_g(th.tt(g))
    sb, vb = js.strain_and_vorticity_g(jnp.asarray(g))
    np.testing.assert_allclose(th.npy(sa), np.asarray(sb), rtol=1e-13)
    np.testing.assert_allclose(th.npy(va), np.asarray(vb), rtol=1e-13)
    f2 = rng.uniform(0.0, 1.0, n)
    np.testing.assert_allclose(
        th.npy(ts.eddy_viscosity(th.tt(rho), th.tt(k), th.tt(w), sa,
                                 th.tt(f2))),
        np.asarray(js.eddy_viscosity(jnp.asarray(rho), jnp.asarray(k),
                                     jnp.asarray(w), sb, jnp.asarray(f2))),
        rtol=1e-13)
