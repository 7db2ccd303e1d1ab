"""Plain version of kernel K7 (su2_tpu_torch/ops/gradients_tiled.py)
against the JAX package's tiled gradient sweep (pallas/gradients_tiled.py
gradient_tiled_rows, interpret mode) with a forced multi-tile plan, WLS and
GG, on a quad grid and on the 153-node channel; the rows' node-major view
against the roll path; and the tier predicate."""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)


def _meshes(name):
    """(JAX MeshArrays, port MeshArrays) of one raw mesh."""
    from su2_tpu.geometry.dual_grid import build_dual_grid as jgrid
    from su2_tpu.geometry.mesh_data import mesh_arrays as jarrays
    from su2_tpu_torch.geometry.dual_grid import build_dual_grid as tgrid
    from su2_tpu_torch.geometry.mesh_data import mesh_arrays as tarrays
    from su2_tpu_torch.io.mesh import RawMesh
    if name == "quad":
        from test_stencil import _quad_grid
        raw = _quad_grid(23, 17)
    else:
        from su2_tpu.geometry.structured import channel_mesh
        raw = channel_mesh(*th.CHANNEL)
    traw = RawMesh(ndim=raw.ndim, coords=raw.coords,
                   elem_types=raw.elem_types, elem_nodes=raw.elem_nodes,
                   markers=raw.markers, marker_types=raw.marker_types)
    return jarrays(jgrid(raw), jnp.float64), tarrays(tgrid(traw))


@pytest.fixture(scope="module", params=["quad", "channel"])
def meshes(request):
    return _meshes(request.param)


def _q(n, ng, seed):
    return np.random.default_rng(seed).standard_normal((n, ng))


@pytest.mark.parametrize("mode", ["WLS", "GG"])
def test_k7_plain_matches_jax_tiled_rows(meshes, mode, monkeypatch):
    """rtol 1e-11, atol 1e-13 of the max: the JAX package's own pin of the
    tiled sweep against the roll path (tests/test_gradients_tiled.py
    :49-50); the arithmetic order is the same, multiply-adds may fuse."""
    from su2_tpu.pallas import gradients_tiled as gt
    from su2_tpu_torch.ops import gradients_tiled as tg
    jm, tm = meshes
    q = _q(tm.npoint, 5, 5)
    # several tiles on this small mesh (T = 128 lanes)
    maxoff = max(abs(int(o)) for o in jm.stencil_offsets)
    h, t = gt._round128(maxoff), 128
    ntiles = -(-gt._round128(jm.npoint) // t)
    assert ntiles >= 2
    monkeypatch.setattr(gt, "tile_plan",
                        lambda m, ng_: (t, h, ntiles, ntiles * t + 2 * h))
    want = np.asarray(gt.gradient_tiled_rows(jm, jnp.asarray(q), mode))
    got = th.npy(tg.gradient_rows_plain(tm, th.tt(q), mode))
    assert got.shape == want.shape == (5 * tm.ndim, tm.npoint)
    np.testing.assert_allclose(got, want, rtol=1e-11,
                               atol=1e-13 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("mode", ["WLS", "GG"])
def test_rows_to_grad_equals_node_major(meshes, mode):
    """The rows' node-major view equals the roll path bitwise (every
    volume of these meshes is positive, so GG's divisor is the same)."""
    from su2_tpu_torch.ops import gradients as tgr, gradients_tiled as tg
    _, tm = meshes
    assert bool((tm.volume > 0).all())
    q = th.tt(_q(tm.npoint, 4, 11))
    rows = tg.gradient_rows(tm, q, mode)
    node = (tgr.weighted_least_squares(tm, q) if mode == "WLS"
            else tgr.green_gauss(tm, q))
    assert torch.equal(tgr.rows_to_grad(rows, 4, tm.ndim), node)


def test_gg_rows_divide_by_one_where_the_volume_is_not_positive(meshes):
    """As the TPU kernel (gradients_tiled.py:101-106): vol <= 0 divides by
    1, so such a node keeps its undivided sum."""
    import dataclasses
    from su2_tpu_torch.ops import gradients_tiled as tg
    _, tm = meshes
    vol = tm.volume.clone()
    vol[3] = 0.0
    vol[5] = -1.0
    q = th.tt(_q(tm.npoint, 3, 2))
    rows = tg.gradient_rows_plain(dataclasses.replace(tm, volume=vol), q,
                                  "GG")
    ones = tg.gradient_rows_plain(
        dataclasses.replace(tm, volume=torch.ones_like(vol)), q, "GG")
    assert torch.equal(rows[:, [3, 5]], ones[:, [3, 5]])
    assert torch.isfinite(rows).all()


def test_tier_predicate():
    """TILED_MIN_NODES = 200,000, the JAX package's boundary
    (ops/gradients.py:50-51, pallas/edge_fused.py:328-330): the two
    smaller smoke sizes stay below it, the 565,500-node size is in it."""
    from su2_tpu_torch.ops import gradients as tgr
    assert tgr.TILED_MIN_NODES == 200_000
    mesh = lambda n: SimpleNamespace(npoint=n, stencil_offsets=(-1, 1))
    for n, want in ((9_072, False), (142_317, False), (199_999, False),
                    (200_000, True), (565_500, True)):
        assert tgr.use_tiled(mesh(n)) is want, n
    assert not tgr.use_tiled(SimpleNamespace(npoint=10 ** 6,
                                             stencil_offsets=None))
    with pytest.raises(ValueError, match="WLS or GG"):
        from su2_tpu_torch.ops import gradients_tiled as tg
        tg.gradient_rows(None, torch.zeros(3, 1), "LSQ")


def test_compute_gradients_in_the_tier_is_the_rows_view(monkeypatch):
    """In the tier every node-major sweep is the rows' view (the JAX
    package routes green_gauss / weighted_least_squares through its tiled
    kernel there)."""
    from su2_tpu_torch.ops import gradients as tgr, gradients_tiled as tg
    from su2_tpu_torch.solvers import euler as es
    _, tm = _meshes("channel")
    q = th.tt(_q(tm.npoint, 6, 3))
    for method, mode in (("WEIGHTED_LEAST_SQUARES", "WLS"),
                         ("GREEN_GAUSS", "GG")):
        prm = SimpleNamespace(grad_method=method)
        monkeypatch.setattr(tgr, "TILED_MIN_NODES", 0)
        got = es.compute_gradients(tm, prm, q)
        rows = tg.gradient_rows_plain(tm, q, mode)
        assert torch.equal(got, tgr.rows_to_grad(rows, 6, tm.ndim))
        assert torch.equal(es.compute_gradient_rows(tm, prm, q), rows)
