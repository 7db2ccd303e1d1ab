"""Multicolor block-SGS sweep, stencil matvec and one-launch FGMRES on
static-stencil meshes (torch): the counterpart of the JAX package's
pallas/stencil_solve.py.

On a structured-ordered mesh (geometry/stencil.py) the off-diagonal block
product is K shifted reads + elementwise block math.  The symmetric
multicolor block Gauss-Seidel sweep (the reference's LU-SGS,
Common/src/matrix_structure.cpp:479, made color-parallel) and the matvec
that follows it run as one kernel application (K5, csrc/stencil_solve.cu),
and a whole FGMRES(m) cycle as one launch (K6).  On a CPU tensor each
dispatcher runs the plain torch version instead.

Layout: blocks in the stencil lane layout, (K*v*v, N) rows
[m_00, m_01, .., m_{v-1,v-1}] per offset and (v*v, N) for dinv/diag, as
StencilJacobianT carries them; vectors node-major (N, v), as the Krylov
loop carries them, so no per-iteration relayout exists.  A neighbour
p + o_k outside [0, N) multiplies a zero block (missing neighbours are
routed to zero blocks by the assembly): the kernels skip it, the plain
version reads a wrapped lane times zero.  K5's sweep passes run over the
nodes sorted by color (color_order); in the mixed tier its bf16 sweep
blocks and dinv are laid out in that order once per solve (the
color-major lane layout, to_color_major), so a pass reads the contiguous
lanes of its own color only.

Which kernel a solve runs (one launch, per-iteration mixed bf16/f32, ...)
follows the JAX package's tier predicates below, so both packages compute
the same numbers; the TPU's padding, tiling and VMEM windows are not
carried.
"""

from __future__ import annotations

import weakref

import torch

from su2_tpu_torch.kernels import K6_ROWS_MIN_V
from su2_tpu_torch.linalg import krylov

# ---------------------------------------------------------------------------
# Tier predicates.  They mirror the reference's tier choice (the VMEM
# working-set model of the TPU kernels) so that both packages pick the same
# arithmetic: the mixed tier rounds the sweep blocks to bf16, and the
# one-launch cycle and the per-iteration loop differ in rounding.  They are
# not a memory limit of this card.
# ---------------------------------------------------------------------------
_VMEM_LIMIT = 96 * 1024 * 1024
_F32_SEL_BUDGET = 6 * 1024 * 1024
_FGMRES_NPAD_CAP = 49152


def _npad(npoint: int) -> int:
    return -(-int(npoint) // 128) * 128


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _est_stack_bytes(k: int, v: int, npad: int, ncolor: int,
                     sel_itemsize: int, itemsize: int = 4) -> int:
    sel_rows = k * v * v
    f32_rows = 2 * (v * v + ncolor + 6 * v + k * v)
    return npad * (sel_rows * sel_itemsize + f32_rows * itemsize)


def supported(npoint: int, k: int, v: int, dtype,
              ncolor: int | None = None) -> bool:
    """Whether the sweep runs at `dtype` blocks (bf16: the mixed tier)."""
    npad = _npad(npoint)
    itemsize = _itemsize(dtype)
    nc = ncolor if ncolor else k + 1
    if dtype != torch.bfloat16:
        if v <= 3 and npad <= _FGMRES_NPAD_CAP:
            return _est_stack_bytes(k, v, npad, nc, itemsize) <= _VMEM_LIMIT
        return k * v * v * npad * itemsize <= _F32_SEL_BUDGET
    return _est_stack_bytes(k, v, npad, nc, itemsize) <= _VMEM_LIMIT


def _fgmres_cap(m: int) -> int:
    return _FGMRES_NPAD_CAP * 25 // max(m * m, 1)


def fgmres_supported(npoint: int, k: int, v: int, dtype, ncolor: int,
                     m: int = 5) -> bool:
    """Whether a solve at full-precision blocks runs as one K6 launch."""
    if not supported(npoint, k, v, dtype, ncolor) or dtype == torch.bfloat16:
        return False
    npad = _npad(npoint)
    if npad > _fgmres_cap(m):
        return False
    est = _est_stack_bytes(k, v, npad, ncolor, _itemsize(dtype))
    est += npad * (2 * m + 6) * v * 4
    return est <= _VMEM_LIMIT


def sgs_matvec_mixed_supported(npoint: int, k: int, v: int,
                               ncolor: int) -> bool:
    npad = _npad(npoint)
    est = _est_stack_bytes(k, v, npad, ncolor, 2)
    est += k * v * v * npad * 4
    return est <= _VMEM_LIMIT


def fgmres_mixed_supported(npoint: int, k: int, v: int, ncolor: int,
                           m: int = 5) -> bool:
    """Whether a mixed-tier solve runs as one K6 launch."""
    npad = _npad(npoint)
    if npad > _fgmres_cap(m):
        return False
    est = _est_stack_bytes(k, v, npad, ncolor, 2)
    est += k * v * v * npad * 4
    est += npad * (2 * m + 6) * v * 4
    return est <= _VMEM_LIMIT


_TILE_W_CAP = 65536


def tiled_supported(offsets, v: int, ncolor: int) -> bool:
    """Whether the reference's windowed mixed tier has a plan (its
    tile_plan with bf16 sweep and f32 matvec blocks): the halo of the
    2 ncolor - 1 passes must not dominate the window that fits VMEM.
    Without one, the reference sweeps f32 blocks with XLA ops."""
    k = len(offsets)
    halo = _npad(2 * ncolor * max(abs(int(o)) for o in offsets))
    per_lane = (k * v * v * 2 + k * v * v * 4 + 2 * v * v * 4 + ncolor * 4
                + 4 * v * 4 + 2 * (v * v + ncolor + 6 * v + k * v) * 4)
    window = min(_TILE_W_CAP, (_VMEM_LIMIT * 22 // 25 // per_lane)
                 // 128 * 128)
    return window - 2 * halo >= max(8 * 128, halo)


def solve_tier(npoint: int, offsets, v: int, dtype, ncolor: int,
               m: int) -> tuple:
    """(dtype of the sweep blocks, whether the solve is one K6 launch) of
    the reference's tier for an SGS-class solve at Krylov budget m:
    full-precision blocks below its full-precision gate and in float64 at
    any size; in float32 past the gate the mixed tier (bf16 sweep blocks)
    where the reference has one, resident or windowed; else full
    precision (the reference's XLA sweep)."""
    k = len(offsets)
    if supported(npoint, k, v, dtype, ncolor) or dtype != torch.float32:
        return dtype, fgmres_supported(npoint, k, v, dtype, ncolor, m)
    if supported(npoint, k, v, torch.bfloat16, ncolor) \
            or tiled_supported(offsets, v, ncolor):
        return torch.bfloat16, fgmres_mixed_supported(npoint, k, v, ncolor,
                                                      m)
    return dtype, False


def fused_sst_solve_tier(npoint: int, offsets, dtype, ncolor: int,
                         m: int) -> tuple:
    """(dtype of the sweep blocks, whether the solve is one K6 launch) of
    the reference's fused SST step (v = 2), its branches in their order:
    the one-launch cycle at full-precision blocks where that predicate
    holds; in float32 the per-iteration mixed tier where the resident or
    the windowed mixed kernel has a plan; else full-precision blocks per
    iteration.  Unlike solve_tier it never takes the one-launch mixed
    cycle."""
    k = len(offsets)
    if fgmres_supported(npoint, k, 2, dtype, ncolor, m):
        return dtype, True
    if dtype == torch.float32 and (
            sgs_matvec_mixed_supported(npoint, k, 2, ncolor)
            or tiled_supported(offsets, 2, ncolor)):
        return torch.bfloat16, False
    return dtype, False


# ---------------------------------------------------------------------------
# The color-major lane layout of K5's sweep operands
# ---------------------------------------------------------------------------
# color_order's results by colors tensor: id -> (weak reference to the
# tensor, its version counter, the order); an entry leaves with its tensor
_ORDERS: dict = {}


def color_order(colors):
    """(N,) int32: the nodes sorted by color, in node order within a color
    (the lanes of one color are a contiguous run).  Sorted once per colors
    tensor (a run's static colors) and reused while the tensor is alive
    and unchanged."""
    key = id(colors)
    hit = _ORDERS.get(key)
    if hit is not None and hit[0]() is colors and hit[1] == colors._version:
        return hit[2]
    order = torch.argsort(colors, stable=True).to(torch.int32)
    ref = weakref.ref(colors, lambda _, key=key: _ORDERS.pop(key, None))
    _ORDERS[key] = (ref, colors._version, order)
    return order


def to_color_major(order, sel_t, dinv_t, sel_dtype):
    """The sweep blocks (cast to sel_dtype) and dinv in the color-major
    lane layout of order: lane i holds node order[i]'s blocks."""
    idx = order.long()
    return (sel_t.to(sel_dtype).index_select(1, idx),
            dinv_t.index_select(1, idx))


# ---------------------------------------------------------------------------
# Plain versions: the arithmetic of the reference's _offdiag, _bapply,
# _sgs_body (its pass order, the offsets summed in order) and _fgmres_body
# ---------------------------------------------------------------------------
def offdiag_plain(sel_t, x, offsets, v):
    """sum_k M_k x(p + o_k): sel_t (K*v*v, N), x (N, v) -> (N, v).  bf16
    blocks promote to x's dtype in the products."""
    out = None
    for kk, off in enumerate(offsets):
        y = _bapply(sel_t[kk * v * v:(kk + 1) * v * v],
                    torch.roll(x, -int(off), dims=0), v)
        out = y if out is None else out + y
    return out


def _bapply(blocks_t, x, v):
    """Per-node block product sum_b M[a, b] x_b: blocks_t (v*v, N) with
    rows a*v + b, x (N, v) -> (N, v)."""
    return (blocks_t.reshape(v, v, -1) * x.T[None]).sum(1).T


def sgs_matvec_plain(selp_t, selm_t, dinv_t, diag_t, colors, r, offsets,
                     ncolor, sweep=True, matvec=True):
    """(z, w): z = the symmetric multicolor block-SGS sweep of r over the
    sweep blocks selp_t (colors 0..ncolor-1, then ncolor-2..0; each pass
    reads the z of the previous pass), w = D z + sum_k B_k z(p + o_k) over
    the matvec blocks selm_t.  sweep=False: z = r (a matvec of r);
    matvec=False: w is None."""
    v = r.shape[1]
    z = r
    if sweep:
        z = torch.zeros_like(r)
        for c in list(range(ncolor)) + list(range(ncolor - 2, -1, -1)):
            acc = r - offdiag_plain(selp_t, z, offsets, v)
            zn = _bapply(dinv_t, acc, v)
            z = torch.where((colors == c)[:, None], zn, z)
    w = None
    if matvec:
        w = _bapply(diag_t, z, v) + offdiag_plain(selm_t, z, offsets, v)
    return z, w


def fgmres_plain(selp_t, selm_t, dinv_t, diag_t, colors, b, offsets, ncolor,
                 m, tol):
    """One FGMRES(m) cycle preconditioned by the sweep: krylov.fgmres
    driven by the plain (z, A z) — the arithmetic of the reference's
    one-launch _fgmres_body.  Returns (x, rel, iters)."""
    pm = lambda r: sgs_matvec_plain(selp_t, selm_t, dinv_t, diag_t, colors,
                                    r, offsets, ncolor)
    return krylov.fgmres(None, None, b, max_iter=m, tol=tol,
                         precond_matvec=pm)


# ---------------------------------------------------------------------------
# Dispatchers: a CUDA tensor launches the kernel, a CPU tensor runs the
# plain version
# ---------------------------------------------------------------------------
def fgmres(selp_t, selm_t, dinv_t, diag_t, colors, b, offsets, ncolor, m,
           tol, order=None, color_major=False):
    """K6 (order, color_major: kernels.stencil_fgmres) on a CUDA tensor,
    the plain version over the natural layout on a CPU tensor."""
    if b.is_cuda:
        from su2_tpu_torch import kernels
        return kernels.stencil_fgmres(selp_t, selm_t, dinv_t, diag_t, colors,
                                      b, offsets, ncolor, m, tol, order,
                                      color_major)
    if color_major:
        raise ValueError("fgmres: the plain version reads the natural layout")
    return fgmres_plain(selp_t, selm_t, dinv_t, diag_t, colors, b, offsets,
                        ncolor, m, tol)


class StencilSolveOps:
    """Per-solve operators: the blocks are laid out once, then every
    application is one kernel call.

    sel_t: (K*v*v, N) lane-layout off-diagonal blocks; dinv, diag:
    (N, v, v); colors: (N,) int8 color of every node, ncolor of them.
    sel_dtype=bf16 gives the mixed tier: the sweep reads bf16-rounded
    blocks (preconditioner quality only), the matvec the full-precision
    ones.  The blocks the object holds decide the tier: the reference's
    precond_matvec_mixed and fgmres_mixed are precond_matvec and fgmres of
    an object built with sel_dtype=bf16.  one_launch: the solve is one K6
    launch (fgmres).  On the card the sweep runs over the node order
    (color_order, sorted once per colors tensor) wherever the kernel reads
    it: in K5, and in K6 at v >= kernels.K6_ROWS_MIN_V; there, in the mixed
    tier, the sweep blocks and dinv are held in its color-major lane layout
    (the bf16 copy takes the permutation; at full precision the sweep reads
    the matvec's blocks where they lie, so no second copy is kept).  K6 at
    v < K6_ROWS_MIN_V reads the natural layout."""

    def __init__(self, mesh, sel_t, dinv, diag, colors, ncolor: int,
                 sel_dtype=None, one_launch=False):
        n, v = dinv.shape[0], dinv.shape[-1]
        tt = lambda blk: blk.permute(1, 2, 0).reshape(v * v, n)
        self._set(mesh.stencil_offsets, sel_t, tt(dinv), tt(diag), colors,
                  ncolor, sel_dtype, one_launch)

    @classmethod
    def from_lanes(cls, offsets, sel_t, dinv_t, diag_t, colors,
                   ncolor: int, sel_dtype=None, one_launch=False):
        """The operators of blocks already in the lane layout: dinv_t and
        diag_t (v*v, N), as the fused SST assembly emits them."""
        ops = cls.__new__(cls)
        ops._set(offsets, sel_t, dinv_t, diag_t, colors, ncolor, sel_dtype,
                 one_launch)
        return ops

    def _set(self, offsets, sel_t, dinv_t, diag_t, colors, ncolor,
             sel_dtype, one_launch):
        self.offsets = tuple(int(o) for o in offsets)
        self.colors, self.ncolor = colors, int(ncolor)
        # matvec blocks at full precision; sweep blocks rounded in the
        # mixed tier (the reference keeps the f32 blocks only where its
        # per-iteration kernel fits VMEM; the (z, A z) kernel takes any size)
        self.selm_t = sel_t.contiguous()
        self.diag_t = diag_t.contiguous()
        sel_dtype = sel_t.dtype if sel_dtype is None else sel_dtype
        v = int(round(diag_t.shape[0] ** 0.5))
        self.order = None
        if self.selm_t.is_cuda and (not one_launch or v >= K6_ROWS_MIN_V):
            self.order = color_order(colors)
        self.color_major = self.order is not None and sel_dtype != sel_t.dtype
        if self.color_major:
            self.sel_t, self.dinv_t = to_color_major(
                self.order, self.selm_t, dinv_t, sel_dtype)
        else:
            self.sel_t = self.selm_t if sel_dtype == sel_t.dtype \
                else self.selm_t.to(sel_dtype)
            self.dinv_t = dinv_t.contiguous()
        self.v = v

    def _sgs(self, r, sweep=True, matvec=True):
        """K5 on a CUDA tensor (over this object's node order and layout),
        the plain version on a CPU tensor."""
        args = (self.sel_t, self.selm_t, self.dinv_t, self.diag_t,
                self.colors, r, self.offsets, self.ncolor, sweep, matvec)
        if r.is_cuda:
            from su2_tpu_torch import kernels
            return kernels.stencil_sgs_matvec(*args, self.order,
                                              self.color_major)
        return sgs_matvec_plain(*args)

    def precond_matvec(self, r):
        """(z, A z) with z = the symmetric multicolor SGS sweep of r."""
        return self._sgs(r)

    def precond(self, r):
        return self._sgs(r, matvec=False)[0]

    def matvec(self, x):
        return self._sgs(x, sweep=False)[1]

    def fgmres(self, b, max_iter: int, tol: float):
        """A whole FGMRES cycle as one launch, over this object's node
        order and layout; the (x, rel, iters) contract of krylov.fgmres."""
        if self.color_major and self.v < K6_ROWS_MIN_V:
            raise ValueError("StencilSolveOps.fgmres: at v < "
                             f"{K6_ROWS_MIN_V} K6 reads the natural layout; "
                             "these operators were laid out color-major for "
                             "K5 (one_launch=False)")
        return fgmres(self.sel_t, self.selm_t, self.dinv_t, self.diag_t,
                      self.colors, b, self.offsets, self.ncolor,
                      int(max_iter), float(tol), self.order,
                      self.color_major)
