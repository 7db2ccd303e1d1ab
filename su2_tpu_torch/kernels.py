"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

The kernels are compiled at first use with nvcc for sm_90a into one shared
library with a plain C interface (loaded with ctypes), under csrc/build/:
one nvcc per source, all started together, then one link.  A hash of the
sources names the library, so an edited source rebuilds.
Every kernel launches on torch.cuda.current_stream(), allocates nothing
and returns its cudaError_t; each wrapper below checks device, dtype,
shape and contiguity, allocates the outputs, launches, raises on a nonzero
error and adds one to its entry in ``launches``.

  T1 mixture_enthalpy  csrc/thermo.cu       (chemistry/library.py)
  T2 node_state        csrc/node_state.cu   (state.py)
  T3 edge_flux         csrc/edge_flux.cu    (ops/edge_flux.py)
  T4 chem_source       csrc/chem_source.cu  (solvers/euler.py)
  K5 stencil_sgs_matvec csrc/stencil_solve.cu (linalg/stencil_solve.py)
  K6 stencil_fgmres     csrc/stencil_solve.cu (linalg/stencil_solve.py)
  K7 gradient_rows      csrc/gradients_tiled.cu (ops/gradients_tiled.py)
  K8 edge_win           csrc/edge_win.cu     (ops/edge_flux.py)
  K9 inlet_tc           csrc/inlet_tc.cu     (solvers/inlet_tc.py)
  K10 edge_implicit     csrc/edge_implicit.cu (ops/edge_implicit.py)
T3 and K8 share the per-edge device function of csrc/edge_side.cuh; K10
shares its species h/cp lookup and Stefan-Maxwell solve.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("common.cuh", "edge_side.cuh", "thermo.cu", "node_state.cu",
           "edge_flux.cu", "chem_source.cu", "stencil_solve.cu",
           "gradients_tiled.cu", "edge_win.cu", "inlet_tc.cu",
           "edge_implicit.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# per-source flags: K9 keeps the plain version's operations (no fused
# multiply-adds), so its secant stops where the plain version's does
SOURCE_FLAGS = {"inlet_tc.cu": ("-fmad=false",)}

# launches of each kernel since the last reset_launches()
launches = {"mixture_enthalpy": 0, "node_state": 0, "edge_flux": 0,
            "chem_source": 0, "stencil_sgs_matvec": 0, "stencil_fgmres": 0,
            "gradient_rows": 0, "edge_win": 0, "inlet_tc": 0,
            "edge_implicit": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_ARGTYPES = {
    "su2k_mixture_enthalpy": [_I, _I, _I, _I, _D, _D] + [_P] * 7,
    "su2k_node_state": [_I, _I, _I, _I, _I, _I, _D, _D, _D, _D, _I, _D, _I,
                        _D] + [_P] * 15,
    "su2k_edge_flux": [_I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int), _I,
                       _D, _D, _D, _D, _D, _D, _D] + [_P] * 9,
    "su2k_chem_source": [_I, _I, _I, _I, _I, _D, _D] + [_P] * 6
                        + [_D, _D, _P, _P],
    "su2k_stencil_sgs_matvec": [_I, _I, _I, _I, _I,
                                ctypes.POINTER(ctypes.c_int), _I, _I, _I]
                               + [_P] * 10,
    "su2k_stencil_fgmres": [_I, _I, _I, _I, _I,
                            ctypes.POINTER(ctypes.c_int), _I, _I, _D]
                           + [_P] * 10 + [_I, _P],
    "su2k_gradient_rows": [_I, _I, _I, _I, _I, _I,
                           ctypes.POINTER(ctypes.c_int)] + [_P] * 6,
    "su2k_edge_win": [_I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int), _I,
                      _D, _D, _D, _D, _D, _D, _D] + [_P] * 9,
    "su2k_inlet_tc": [_I, _I, _I, _D, _D, _D, _D, _D, _D, _I, _D, _I, _D]
                     + [_P] * 7,
    "su2k_edge_implicit": [_I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int),
                           _I, _D, _D, _D, _D, _D, _D, _I, _I] + [_P] * 9,
}

_loaded = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def library_path() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return os.path.join(BUILD_DIR, f"libsu2k_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> tuple[str, str]:
    """Compile the kernels if the library for these sources is missing.
    Returns (library path, compiler output; empty when nothing was
    built).  verbose adds -Xptxas -v (registers, spills per kernel)."""
    path = library_path()
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{path}.{os.getpid()}.tmp"
    objs, procs = [], []
    for src in (s for s in SOURCES if s.endswith(".cu")):
        obj = f"{tmp}.{src}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src, ()),
             *(("-Xptxas", "-v") if verbose else ()),
             "-c", "-o", obj, os.path.join(CSRC, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode}):\n{out}")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
        os.replace(tmp, path)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return path, "".join(log)


def _lib():
    global _loaded
    if _loaded is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        for name, args in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _loaded = lib
    return _loaded


def _check(name, *tensors):
    dev = tensors[0].device
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 tensors, got {dtype}")
    for x in tensors:
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"{name}: every tensor must be on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {x.dtype} and {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def _cached(lib, key, make):
    """Kernel-side table buffers built once per library object."""
    val = lib.__dict__.get(key)
    if val is None:
        val = make()
        object.__setattr__(lib, key, val)
    return val


# ---------------------------------------------------------------- T1
def mixture_enthalpy(lib, t: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """h(T, Y) for t (N,), ys (N, S) on the card (kernel T1)."""
    t = t.contiguous()
    ys = ys.contiguous()
    _check("mixture_enthalpy", t, ys, lib.h_y, lib.h_y2, lib.mm)
    n, ns = t.shape[0], lib.nspecies
    if t.ndim != 1 or ys.shape != (n, ns):
        raise ValueError(f"mixture_enthalpy: t (N,), ys (N, {ns}); got "
                         f"{tuple(t.shape)}, {tuple(ys.shape)}")
    out = torch.empty_like(t)
    err = _lib().su2k_mixture_enthalpy(
        int(t.dtype == torch.float64), n, ns, lib.nt, lib.t0, lib.dt,
        _ptr(t), _ptr(ys), _ptr(lib.h_y), _ptr(lib.h_y2), _ptr(lib.mm),
        _ptr(out), _stream())
    _raise("mixture_enthalpy", err)
    launches["mixture_enthalpy"] += 1
    return out


# ---------------------------------------------------------------- T2
def _node_tables(lib):
    def make():
        from su2_tpu_torch.chemistry.library import wilke_consts
        tab = torch.cat([lib.h_y, lib.h_y2, lib.cp_y, lib.cp_y2, lib.mu_y,
                         lib.mu_y2, lib.ka_y, lib.ka_y2]).contiguous()
        c_mass, c_den = wilke_consts(lib)
        cst = torch.cat([lib.mm, lib.ri, c_mass.reshape(-1),
                         c_den.reshape(-1)]).contiguous()
        return tab, cst
    return _cached(lib, "_k_node_tables", make)


def node_state(lib, lay, p, u, t_guess, turb_ke=None, lite=False):
    """Kernel T2.  Returns the fields of state.NodeState (full) or
    state.NodeStateLite (lite), node-major."""
    u = u.contiguous()
    t_guess = t_guess.contiguous()
    tke = None if turb_ke is None else turb_ke.contiguous()
    tab, cst = _node_tables(lib)
    _check("node_state", u, t_guess, tab, cst,
           *(() if tke is None else (tke,)))
    n = u.shape[0]
    if u.shape != (n, lay.nvar) or t_guess.shape != (n,) \
            or (tke is not None and tke.shape != (n,)):
        raise ValueError("node_state: u (N, nVar), t_guess (N,), "
                         "turb_ke (N,)")
    kw = dict(dtype=u.dtype, device=u.device)
    u_out = torch.empty_like(u)
    v = torch.empty((n, lay.nprim), **kw)
    nonphys = torch.empty((n,), dtype=torch.bool, device=u.device)
    mu = torch.empty((n,), **kw)
    xs = torch.empty((n, lay.ns), **kw)
    if lite:
        gm1 = torch.empty((n,), **kw)
        dtdu = dpdu = kappa = None
    else:
        gm1 = None
        dtdu = torch.empty_like(u)
        dpdu = torch.empty_like(u)
        kappa = torch.empty((n,), **kw)
    err = _lib().su2k_node_state(
        int(u.dtype == torch.float64), int(lite), n, lay.ndim, lay.ns,
        lib.nt, lib.t0, lib.dt, p.tmin, p.tmax, p.secant_iters,
        p.secant_tol, p.bisect_iters, p.bisect_tol, _ptr(u), _ptr(t_guess),
        _ptr(tke), _ptr(tab), _ptr(cst), _ptr(u_out), _ptr(v),
        _ptr(nonphys), _ptr(dtdu), _ptr(dpdu), _ptr(gm1), _ptr(mu),
        _ptr(kappa), _ptr(xs), _stream())
    _raise("node_state", err)
    launches["node_state"] += 1
    if lite:
        return u_out, v, nonphys, gm1, mu, xs
    return u_out, v, nonphys, dtdu, dpdu, mu, kappa, xs


# ------------------------------------------------------------- T3, K8
def _edge_args(name, lib, lay, sc, consts, f_all, offsets, fam_normal,
               fam_evec):
    """Checked, contiguous operands of T3/K8 and the argument tail of their
    C calls (after n, nd, ns, kh, offsets)."""
    m_infty, pr_lam, pr_turb, le_turb = consts
    f_all = f_all.contiguous()
    fam_normal = fam_normal.contiguous()
    fam_evec = fam_evec.contiguous()
    tab = _cached(lib, "_k_hcp_table", lambda: torch.cat(
        [lib.h_y, lib.h_y2, lib.cp_y, lib.cp_y2]).contiguous())
    cst = _cached(lib, "_k_edge_consts", lambda: torch.cat(
        [lib.mm, sc.sm_den.reshape(-1)]).contiguous())
    _check(name, f_all, fam_normal, fam_evec, tab, cst)
    nrow, n = f_all.shape
    kh = len(offsets)
    from su2_tpu_torch.ops.edge_flux import stack_rows
    if nrow != stack_rows(lay)["total"] \
            or fam_normal.shape != (kh, n, lay.ndim) \
            or fam_evec.shape != (kh, n, lay.ndim):
        raise ValueError(f"{name}: f_all (R, N), fam_normal/fam_evec "
                         "(Kh, N, d)")
    offs = (ctypes.c_int * kh)(*[int(o) for o in offsets])
    head = (int(f_all.dtype == torch.float64), n, lay.ndim, lay.ns, kh, offs)
    tail = (lib.nt, lib.t0, lib.dt, m_infty, pr_lam, pr_turb, le_turb,
            sc.mm_sum, _ptr(f_all), _ptr(fam_normal), _ptr(fam_evec),
            _ptr(tab), _ptr(cst))
    return f_all, head + tail


def edge_flux(lib, lay, sc, consts, f_all, offsets, fam_normal, fam_evec):
    """Kernel T3: per-family interior edge flux (Kh, nVar, N) and spectral
    radii (Kh, N), (Kh, N) from the feature-major stack f_all (R, N)."""
    f_all, args = _edge_args("edge_flux", lib, lay, sc, consts, f_all,
                             offsets, fam_normal, fam_evec)
    n, kh = f_all.shape[1], len(offsets)
    kw = dict(dtype=f_all.dtype, device=f_all.device)
    flux = torch.empty((kh, lay.nvar, n), **kw)
    lc = torch.empty((kh, n), **kw)
    lv = torch.empty((kh, n), **kw)
    err = _lib().su2k_edge_flux(*args, _ptr(flux), _ptr(lc), _ptr(lv),
                                _stream())
    _raise("edge_flux", err)
    launches["edge_flux"] += 1
    return flux, lc, lv


def edge_win(lib, lay, sc, consts, f_all, offsets, fam_normal, fam_evec):
    """Kernel K8: T3's edge terms summed per node in one launch: res
    (nVar, N), lc (N,), lv (N,) (ops/edge_flux.roll_subtract order)."""
    f_all, args = _edge_args("edge_win", lib, lay, sc, consts, f_all,
                             offsets, fam_normal, fam_evec)
    n = f_all.shape[1]
    kw = dict(dtype=f_all.dtype, device=f_all.device)
    res = torch.empty((lay.nvar, n), **kw)
    lc = torch.empty((n,), **kw)
    lv = torch.empty((n,), **kw)
    err = _lib().su2k_edge_win(*args, _ptr(res), _ptr(lc), _ptr(lv),
                               _stream())
    _raise("edge_win", err)
    launches["edge_win"] += 1
    return res, lc, lv


# ---------------------------------------------------------------- T4
def _chem_tables(lib):
    def make():
        arr = torch.stack([lib.arr_a, lib.arr_beta, lib.arr_ta, lib.arr_a_b,
                           lib.arr_beta_b, lib.arr_ta_b, lib.reversible,
                           lib.has_backward], dim=1)             # (R, 8)
        dco = lib.stoich_p - lib.stoich_r                          # (S, R)
        part = ((lib.stoich_r != 0.0) | (lib.stoich_p != 0.0)).to(lib.dtype)
        cst = torch.cat([lib.mm, arr.reshape(-1), lib.exp_f.reshape(-1),
                         lib.exp_b.reshape(-1), dco.reshape(-1),
                         part.reshape(-1)]).contiguous()
        tab = torch.cat([lib.lnkc_y, lib.lnkc_y2, lib.lnkp_y,
                         lib.lnkp_y2]).contiguous()
        return tab, cst
    return _cached(lib, "_k_chem_tables", make)


def chem_source(lib, prm, t, rho, ys, omega_turb=None):
    """Kernel T4: species production omega (N, S) [kg/(m^3 s)]; PaSR when
    omega_turb is given."""
    t, rho, ys = t.contiguous(), rho.contiguous(), ys.contiguous()
    omt = None if omega_turb is None else omega_turb.contiguous()
    tab, cst = _chem_tables(lib)
    _check("chem_source", t, rho, ys, tab, cst,
           *(() if omt is None else (omt,)))
    n, ns = t.shape[0], lib.nspecies
    if rho.shape != (n,) or ys.shape != (n, ns) \
            or (omt is not None and omt.shape != (n,)):
        raise ValueError("chem_source: t, rho, omega_turb (N,), ys (N, S)")
    out = torch.empty_like(ys)
    err = _lib().su2k_chem_source(
        int(t.dtype == torch.float64), n, ns, lib.nreactions, lib.nt,
        lib.t0, lib.dt, _ptr(t), _ptr(rho), _ptr(ys), _ptr(omt), _ptr(tab),
        _ptr(cst), float(prm.c_mu), float(prm.pasr_lb), _ptr(out), _stream())
    _raise("chem_source", err)
    launches["chem_source"] += 1
    return out


# ------------------------------------------------------------------ K5, K6
# Work space of the K6 block partials: two buffers of at most 4,096 blocks
# (the co-resident blocks of any card at 256 threads).
_PART_CAP = 2 * 4096


def _check_stencil(name, selp, selm, dinv, diag, colors, r, offsets, ncolor,
                   sweep=True):
    """Device, dtype, shape and contiguity of the stencil-solve operands."""
    dtype, dev = r.dtype, r.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 vectors, got {dtype}")
    n, v = r.shape
    k = len(offsets)
    if v not in (2, 3):
        raise ValueError(f"{name}: block width 2 or 3, got {v}")
    if not 1 <= k <= 8:
        raise ValueError(f"{name}: 1 to 8 stencil offsets, got {k}")
    sel_bf16 = selp.dtype == torch.bfloat16
    if selp.dtype not in (dtype, torch.bfloat16) or (
            sel_bf16 and dtype != torch.float32):
        raise TypeError(f"{name}: sweep blocks {selp.dtype} with {dtype} "
                        "vectors (bf16 pairs only with float32)")
    want = [(selp, (k * v * v, n)), (selm, (k * v * v, n)),
            (dinv, (v * v, n)), (diag, (v * v, n)), (r, (n, v))]
    if sweep:
        want.append((colors, (n,)))
        if colors.dtype != torch.int8 or not 1 <= ncolor <= 127:
            raise TypeError(f"{name}: int8 colors, 1 to 127 of them")
    for x, shape in want:
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"{name}: every tensor must be on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    for x in (selm, dinv, diag):
        if x.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {x.dtype} and {dtype}")
    return n, v, k, sel_bf16


def stencil_sgs_matvec(selp_t, selm_t, dinv_t, diag_t, colors, r, offsets,
                       ncolor, sweep=True, matvec=True):
    """Kernel K5: (z, w) with z the symmetric multicolor block-SGS sweep of
    r over the sweep blocks selp_t (float or bf16) and w = A z over the
    matvec blocks selm_t.  sweep=False: w = A r (z is r); matvec=False: w
    is None.  Blocks (K*v*v, N) and (v*v, N), colors (N,) int8, r (N, v)."""
    if not (sweep or matvec):
        raise ValueError("stencil_sgs_matvec: nothing to compute")
    n, v, k, sel_bf16 = _check_stencil("stencil_sgs_matvec", selp_t, selm_t,
                                       dinv_t, diag_t, colors, r, offsets,
                                       ncolor, sweep)
    z = torch.empty_like(r) if sweep else r
    zbuf = torch.empty_like(r) if sweep and ncolor > 1 else None
    w = torch.empty_like(r) if matvec else None
    offs = (ctypes.c_int * k)(*[int(o) for o in offsets])
    err = _lib().su2k_stencil_sgs_matvec(
        int(r.dtype == torch.float64), int(sel_bf16), v, n, k, offs,
        int(ncolor), int(sweep), int(matvec), _ptr(selp_t), _ptr(selm_t),
        _ptr(dinv_t), _ptr(diag_t), _ptr(colors) if sweep else None, _ptr(r),
        _ptr(z) if sweep else None, _ptr(w), _ptr(zbuf), _stream())
    _raise("stencil_sgs_matvec", err)
    launches["stencil_sgs_matvec"] += 1
    return z, w


def stencil_fgmres(selp_t, selm_t, dinv_t, diag_t, colors, b, offsets, ncolor,
                   m, tol):
    """Kernel K6: one FGMRES(m) cycle preconditioned by the sweep, in one
    cooperative launch.  Returns (x (N, v), relative residual, iterations
    as int32), the contract of krylov.fgmres without x0."""
    n, v, k, sel_bf16 = _check_stencil("stencil_fgmres", selp_t, selm_t,
                                       dinv_t, diag_t, colors, b, offsets,
                                       ncolor)
    if not 1 <= m <= 64:
        raise ValueError(f"stencil_fgmres: 1 to 64 Krylov vectors, got {m}")
    x = torch.empty_like(b)
    stats = torch.empty((2,), dtype=b.dtype, device=b.device)
    ws = torch.empty(((2 * m + 3) * n * v,), dtype=b.dtype, device=b.device)
    part = torch.empty((_PART_CAP,), dtype=b.dtype, device=b.device)
    offs = (ctypes.c_int * k)(*[int(o) for o in offsets])
    err = _lib().su2k_stencil_fgmres(
        int(b.dtype == torch.float64), int(sel_bf16), v, n, k, offs,
        int(ncolor), int(m), float(tol), _ptr(selp_t), _ptr(selm_t),
        _ptr(dinv_t), _ptr(diag_t), _ptr(colors), _ptr(b), _ptr(x),
        _ptr(stats), _ptr(ws), _ptr(part), _PART_CAP, _stream())
    _raise("stencil_fgmres", err)
    launches["stencil_fgmres"] += 1
    return x, stats[0], stats[1].to(torch.int32)


# ---------------------------------------------------------------- K7
def gradient_rows(q, coef, offsets, bnd=None, vol=None):
    """Kernel K7: the stencil gradient rows (nG*d, N) of q (N, nG): WLS
    with coef the (K, N, d) WLS coefficients, or GG with coef the signed
    dual normals, bnd (N, d) and vol (N,) given."""
    gg = bnd is not None
    qt = q.T.contiguous()                       # (nG, N): coalesced reads
    coef = coef.contiguous()
    extra = (bnd.contiguous(), vol.contiguous()) if gg else ()
    _check("gradient_rows", qt, coef, *extra)
    ng, n = qt.shape
    k = len(offsets)
    d = coef.shape[-1]
    if coef.shape != (k, n, d) or (gg and (extra[0].shape != (n, d)
                                           or extra[1].shape != (n,))):
        raise ValueError("gradient_rows: q (N, nG), coef (K, N, d), "
                         "bnd (N, d), vol (N,)")
    out = torch.empty((ng * d, n), dtype=qt.dtype, device=qt.device)
    offs = (ctypes.c_int * k)(*[int(o) for o in offsets])
    err = _lib().su2k_gradient_rows(
        int(qt.dtype == torch.float64), int(gg), n, ng, d, k, offs, _ptr(qt),
        _ptr(coef), _ptr(extra[0]) if gg else None,
        _ptr(extra[1]) if gg else None, _ptr(out), _stream())
    _raise("gradient_rows", err)
    launches["gradient_rows"] += 1
    return out


# ---------------------------------------------------------------- K9
def inlet_tc(tc, riemann, gamma, alpha):
    """Kernel K9: the TOTAL_CONDITIONS inlet temperature (nV,) of the
    marker constants tc (solvers/inlet_tc.TotalConditions)."""
    riemann, gamma, alpha = (x.contiguous() for x in (riemann, gamma, alpha))
    _check("inlet_tc", riemann, gamma, alpha, tc.y, tc.y2)
    nv = riemann.shape[0]
    if riemann.ndim != 1 or gamma.shape != (nv,) or alpha.shape != (nv,) \
            or tc.y.shape != (tc.nt,) or tc.y2.shape != (tc.nt,):
        raise ValueError("inlet_tc: riemann, gamma, alpha (nV,), table (nT,)")
    out = torch.empty_like(riemann)
    err = _lib().su2k_inlet_tc(
        int(riemann.dtype == torch.float64), nv, tc.nt, tc.t0, tc.dt,
        tc.rgas, tc.htot, tc.ttot, tc.tmin, tc.sec_iters, tc.sec_tol,
        tc.bis_iters, tc.bis_tol, _ptr(riemann), _ptr(gamma), _ptr(alpha),
        _ptr(tc.y), _ptr(tc.y2), _ptr(out), _stream())
    _raise("inlet_tc", err)
    launches["inlet_tc"] += 1
    return out


# ---------------------------------------------------------------- K10
def edge_implicit(lib, lay, sc, consts, f_all, offsets, fam_normal, fam_evec,
                  muscl, use_limiter):
    """Kernel K10: per-family implicit edge flux (Kh, nVar, N) and edge
    Jacobian blocks j_i, j_j (Kh, nVar^2, N) from the stack f_all (R, N) of
    ops/edge_implicit.implicit_rows, in one launch for every family;
    consts = (m_infty, prandtl_turb, lewis_turb).  2D only."""
    m_infty, pr_turb, le_turb = consts
    f_all = f_all.contiguous()
    fam_normal = fam_normal.contiguous()
    fam_evec = fam_evec.contiguous()
    tab = _cached(lib, "_k_hcp_table", lambda: torch.cat(
        [lib.h_y, lib.h_y2, lib.cp_y, lib.cp_y2]).contiguous())
    cst = _cached(lib, "_k_implicit_consts", lambda: torch.cat(
        [lib.mm, sc.sm_den.reshape(-1), lib.ri]).contiguous())
    _check("edge_implicit", f_all, fam_normal, fam_evec, tab, cst)
    nrow, n = f_all.shape
    kh = len(offsets)
    from su2_tpu_torch.ops.edge_implicit import implicit_rows
    if lay.ndim != 2:
        raise ValueError("edge_implicit: 2D only")
    if use_limiter and not muscl:
        raise ValueError("edge_implicit: a limiter needs MUSCL")
    if nrow != implicit_rows(lay)["total"] \
            or fam_normal.shape != (kh, n, lay.ndim) \
            or fam_evec.shape != (kh, n, lay.ndim):
        raise ValueError("edge_implicit: f_all (R, N), fam_normal/fam_evec "
                         "(Kh, N, d)")
    kw = dict(dtype=f_all.dtype, device=f_all.device)
    nv = lay.nvar
    flux = torch.empty((kh, nv, n), **kw)
    j_i = torch.empty((kh, nv * nv, n), **kw)
    j_j = torch.empty((kh, nv * nv, n), **kw)
    offs = (ctypes.c_int * kh)(*[int(o) for o in offsets])
    err = _lib().su2k_edge_implicit(
        int(f_all.dtype == torch.float64), n, lay.ndim, lay.ns, kh, offs,
        lib.nt, lib.t0, lib.dt, float(m_infty), float(pr_turb),
        float(le_turb), sc.mm_sum, int(bool(muscl)), int(bool(use_limiter)),
        _ptr(f_all), _ptr(fam_normal), _ptr(fam_evec), _ptr(tab), _ptr(cst),
        _ptr(flux), _ptr(j_i), _ptr(j_j), _stream())
    _raise("edge_implicit", err)
    launches["edge_implicit"] += 1
    return flux, j_i, j_j
