"""The run-time kernels of K5 and K6 (csrc/stencil_solve.cu: the block
widths 4 to 21 with no compiled instance) as far as the CPU can hold them:
the width classes and constants of kernels.py against the CUDA source,
and K6's plan that sizes its shared memory (kernels.k6_plan: a pure
function of the width, offsets, types, layout, node count and grid).  The kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py's widths phase)."""

import os
import re

import pytest
import torch

from su2_tpu_torch import kernels

SRC = os.path.join(kernels.CSRC, "stencil_solve.cu")
TIERS = {"float64": (torch.float64, False), "float32": (torch.float32, False),
         "mixed": (torch.float32, True)}


def _source():
    with open(SRC) as fh:
        return fh.read()


def _define(src, name):
    return int(re.search(rf"#define {name} (\d+)", src).group(1))


def test_width_classes_and_constants_match_the_source():
    """kernels.STENCIL_RT_CLASSES are SU2K_BY_CLASS's bounds (each width
    runs the first class >= it), and the constants and RtPlan's fields
    that kernels.py mirrors are the source's."""
    src = _source()
    block = src[src.index("#define SU2K_BY_CLASS"):]
    block = block[:block.index("\n\n")]
    tests = tuple(int(x) for x in re.findall(r"\(v\) <= (\d+)", block))
    bounds = tuple(int(x) for x in re.findall(r"constexpr int VB = (\d+)",
                                              block))
    assert bounds == kernels.STENCIL_RT_CLASSES
    assert tests == bounds[:-1]
    assert bounds[-1] == _define(src, "SU2K_VMAX") == kernels.STENCIL_MAX_V
    assert _define(src, "SU2K_MAXK") == kernels.STENCIL_MAX_OFFSETS
    struct = src[src.index("struct RtPlan {"):]
    struct = struct[:struct.index("};")]
    fields = tuple(re.findall(r"int (\w+);", struct))
    assert fields == kernels.RT_PLAN_FIELDS == kernels.RtPlan._fields


@pytest.mark.parametrize("v", range(0, 24))
def test_every_width_maps_to_one_instance(v):
    """2, 3, 7, 8, 13 and 14 run their compiled instances; every other
    width of 4 to 21 the smallest class whose bound is >= v (and so does
    every width of 4 to 21 with runtime=True); the rest raise naming the
    range; K6's rows blocks hold one group at a run-time width."""
    if v in kernels.STENCIL_WIDTHS:
        assert kernels.stencil_instance(v) == ("compiled", v)
        if v >= kernels.K6_ROWS_MIN_V:
            assert kernels.k6_groups(v) == 512 // (32 * v)
    elif 4 <= v <= 21:
        kind, vb = kernels.stencil_instance(v)
        assert kind == "class" and vb >= v
        assert all(c < v for c in kernels.STENCIL_RT_CLASSES if c < vb)
        assert kernels.k6_groups(v) == 1
    else:
        with pytest.raises(ValueError, match="2 to 21"):
            kernels.stencil_instance(v)
    if 4 <= v <= 21:
        kind, vb = kernels.stencil_instance(v, runtime=True)
        assert kind == "class" and vb == min(
            c for c in kernels.STENCIL_RT_CLASSES if c >= v)
        assert kernels.k6_groups(v, runtime=True) == 1
    else:
        with pytest.raises(ValueError, match="4 to 21"):
            kernels.stencil_instance(v, runtime=True)


def _grids(n):
    groups = -(-n // 32)
    return sorted({min(groups, g) for g in (groups, 132, 264, 396, 528)})


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("k", [4, 6, 8])
def test_k6_plan_every_case(tier, k):
    """K6's form at every width of 4 to 21, K = 4, 6, 8 and the smoke's
    sizes (8,000, 9,072 and 20,000 nodes) on co-resident grids of one
    group a block to four blocks an SM (the solve path's layout: the
    mixed tier color-major, full precision natural): the shared memory
    asked for stays within the 227 KB a block may take; the resident form
    (at a class up to 16) holds every group of the block after the scalars
    and staged vectors and keeps ceil(grid / 132) blocks on an SM; the grid query's plan
    (grid None, the streamed form) does not depend on K or the layout; a
    budget of 0 forces the streamed form, the grid query's plan on that
    grid."""
    dtype, bf16 = TIERS[tier]
    es = 8 if dtype == torch.float64 else 4
    for v in range(4, 22):
        query = kernels.k6_plan(v, k, dtype, bf16, bf16, 9072, None)
        for kk in (1, 8):
            for cm in (False, True):
                assert kernels.k6_plan(v, kk, dtype, bf16, cm, 20000,
                                       None) == query
        words = 50 + 5 * 10 + 10 * 10
        assert query.base == query.smem >= es * (
            words + (kernels.STENCIL_MAX_OFFSETS + 2) * 32 * (v | 1))
        assert query.base % 16 == 0 and query.res == 0
        for n in (8000, 9072, 20000):
            for grid in _grids(n):
                p = kernels.k6_plan(v, k, dtype, bf16, bf16, n, grid)
                assert p.grid == grid and p.vb == query.vb
                assert p.base == query.base
                assert p.smem <= kernels.SMEM_PER_BLOCK
                if p.res:
                    assert p.vb <= 16
                    assert p.gpb * grid >= -(-n // 32) > (p.gpb - 1) * grid
                    assert p.smem == p.base + p.gpb * p.grp
                    per_sm = -(-grid // kernels.H100_SMS)
                    assert per_sm * (p.smem + kernels.SMEM_RESERVED) \
                        <= kernels.SMEM_PER_SM
                    assert p.grp == k * v * v * p.slot_s + v * v * p.slot_t
                    assert p.grp % 16 == 0
                else:
                    assert p == query._replace(grid=grid)
                assert kernels.k6_plan(v, k, dtype, bf16, bf16, n, grid,
                                       budget=0) == query._replace(grid=grid)


@pytest.mark.parametrize("v,k,n", [(9, 4, 9072), (10, 6, 8000)])
def test_k6_resident_at_the_five_species_one_launch_tier(v, k, n):
    """The 5-species flow's one-launch K6 (the mixed tier, color-major, one
    group a block: 284 blocks at 9,072 nodes, 250 at 8,000) takes the
    resident form; in f64 (natural layout) at v = 9 it streams; the
    resident sizes: bf16 sweep rows of 80 bytes (a run's 64 bytes in 16-byte
    chunks), f32 dinv rows of 144."""
    grid = -(-n // 32)
    p = kernels.k6_plan(v, k, torch.float32, True, True, n, grid)
    assert p.form == "resident" and p.gpb == 1
    assert (p.slot_s, p.slot_t) == (80, 144)
    for budget in (p.smem - 1, 0):
        assert kernels.k6_plan(v, k, torch.float32, True, True, n, grid,
                               budget=budget).form == "streamed"
    f64 = kernels.k6_plan(v, k, torch.float64, False, False, n, grid)
    assert f64.form == "streamed" if v == 9 else f64.smem <= 232448


def test_plans_pass_as_the_c_struct():
    """RtPlan.c_ints hands the fields in RT_PLAN_FIELDS' order."""
    p = kernels.k6_plan(10, 6, torch.float32, True, True, 8000, 250)
    assert list(p.c_ints()) == [getattr(p, f) for f in
                                kernels.RT_PLAN_FIELDS]
    assert len(p.c_ints()) == len(kernels.RT_PLAN_FIELDS) == 9
