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


@pytest.mark.parametrize("mode", ["WLS", "GG"])
def test_k7_plain_on_column_views(meshes, mode):
    """K7 reads q in place, node-major: the plain version on q as a column
    view of wider rows equals it on a contiguous copy bit for bit, and
    the JAX package's tiled sweep (interpret mode) at its pin."""
    from su2_tpu.pallas import gradients_tiled as gt
    from su2_tpu_torch.ops import gradients_tiled as tg
    jm, tm = meshes
    q = th.tt(_q(tm.npoint, 9, 13))[:, 2:7]
    assert not q.is_contiguous()
    got = tg.gradient_rows_plain(tm, q, mode)
    assert torch.equal(got, tg.gradient_rows_plain(tm, q.contiguous(), mode))
    want = np.asarray(gt.gradient_tiled_rows(jm, jnp.asarray(th.npy(q)),
                                             mode))
    np.testing.assert_allclose(th.npy(got), want, rtol=1e-11,
                               atol=1e-13 * max(np.abs(want).max(), 1.0))


# kernels.k7_plan on the smoke sizes' channels (nx x ny nodes, offsets -ny,
# -1, 1, ny), in f32 and f64, and on a mesh whose halo fits no window:
# (nodes, nG, ny, itemsize) -> (form, window, shared bytes, blocks an SM:
# 2 at least two, 1 exactly one)
K7_PLANS = {
    "9072": ((9_072, 13, 48, 4), ("window", 128, 11_664, 2)),
    "142317": ((142_317, 13, 189, 4), ("window", 640, 52_952, 2)),
    "565500-nG13": ((565_500, 13, 377, 4), ("window", 1152, 99_128, 2)),
    "565500-nG15": ((565_500, 15, 377, 4), ("window", 1152, 114_376, 2)),
    "565500-nG13-f64": ((565_500, 13, 377, 8), ("window", 256, 105_056, 2)),
    "565500-nG15-f64": ((565_500, 15, 377, 8),
                        ("window", 1152, 228_736, 1)),
    "3000x3000": ((9_000_000, 13, 3_000, 4), ("streamed", 0, 0, 0)),
    "halo-10000": ((1_000_000, 13, 10_000, 4), ("streamed", 0, 0, 0)),
}


@pytest.mark.parametrize("case", list(K7_PLANS))
def test_k7_plan(case):
    """Windows of whole warps' nodes (K7_GRANULE) that let two blocks
    share an SM (else one), stage at most K + 1 rows a node, and cover the
    nodes in as few waves of blocks over the H100's 132 SMs as the largest
    such window: at 565,500 nodes 1,152 in f32 (491 windows, two waves of
    264 blocks; 1,024 would leave a third wave of 25), in f64 256 at nG =
    13 and 1,152 one block an SM at nG = 15; 640 at 142,317 nodes (one
    wave), 128 at 9,072; the streamed form where the halo of +-ny rows
    fits no window.  Forced forms: 0 streams, a window must be a multiple
    of K7_GRANULE that fits."""
    from su2_tpu_torch import kernels
    (n, ng, ny, item), (form, window, smem, per_sm) = K7_PLANS[case]
    offs = (-ny, -1, 1, ny)
    plan = kernels.k7_plan(n, ng, offs, item)
    assert (plan.form, plan.window, plan.smem) == (form, window, smem)
    if form == "window":
        assert (plan.hlo, plan.hhi) == (ny, ny)
        assert plan.smem == ((window + 2 * ny) * ng + 16 // item) * item
        assert window % kernels.K7_GRANULE == 0
        fit = kernels.SMEM_PER_SM // (plan.smem + kernels.SMEM_RESERVED)
        assert fit >= 2 if per_sm == 2 else fit == 1
    assert kernels.k7_plan(n, ng, offs, item, window=0).form == "streamed"
    if ((128 + 2 * ny) * ng + 16 // item) * item <= kernels.SMEM_PER_BLOCK:
        forced = kernels.k7_plan(n, ng, offs, item, window=128)
        assert (forced.form, forced.window) == ("window", 128)
    else:
        with pytest.raises(ValueError, match="does not fit"):
            kernels.k7_plan(n, ng, offs, item, window=128)
    with pytest.raises(ValueError, match="does not fit"):
        kernels.k7_plan(n, ng, offs, item, window=100)


def test_k7_plan_offsets_are_the_channels():
    """The channel's stencil is the 4 offsets k7_plan's cases assume, and
    both the channel and the 3D box hit K7's compiled (K, d) stencils."""
    from su2_tpu.geometry.structured import box_mesh
    from su2_tpu_torch import kernels
    _, tm = _meshes("channel")
    assert tuple(tm.stencil_offsets) == (-th.CHANNEL[1], -1, 1,
                                         th.CHANNEL[1])
    assert (len(tm.stencil_offsets), tm.ndim) in kernels.K7_STENCILS
    from su2_tpu_torch.geometry.dual_grid import build_dual_grid as tgrid
    from su2_tpu_torch.geometry.mesh_data import mesh_arrays as tarrays
    from su2_tpu_torch.io.mesh import RawMesh
    raw = box_mesh(6, 5, 4)
    box = tarrays(tgrid(RawMesh(ndim=raw.ndim, coords=raw.coords,
                                elem_types=raw.elem_types,
                                elem_nodes=raw.elem_nodes,
                                markers=raw.markers,
                                marker_types=raw.marker_types)))
    assert (len(box.stencil_offsets), box.ndim) in kernels.K7_STENCILS


def test_k7_wrapper_refuses_cpu_tensors():
    """K7 launches on CUDA tensors or raises; it never runs a CPU one."""
    from su2_tpu_torch import kernels
    _, tm = _meshes("channel")
    with pytest.raises(ValueError, match="must be on"):
        kernels.gradient_rows(th.tt(_q(tm.npoint, 3, 1)), tm.wls_coeff,
                              tm.stencil_offsets)
