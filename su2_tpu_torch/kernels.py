"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

The kernels are compiled at first use with nvcc for sm_90a into one shared
library with a plain C interface (loaded with ctypes), under csrc/build/:
one nvcc per source, all started together, then one link.  A hash of the
sources names the library, so an edited source rebuilds.
Every kernel launches on torch.cuda.current_stream(), allocates nothing
and returns its cudaError_t; each wrapper below checks device, dtype,
shape and contiguity (T4 and K12 read strided views in place), allocates
the outputs, launches, raises on a nonzero error and adds one to its
entry in ``launches``.  A replay of a captured CUDA graph
(driver.StepGraph) calls no wrapper: it launches the kernel nodes its
capture recorded and adds those to ``launches``.

  T1 mixture_enthalpy  csrc/thermo.cu       (chemistry/library.py)
  T2 node_state        csrc/node_state.cu   (state.py)
  T3 edge_flux         csrc/edge_flux.cu    (ops/edge_flux.py)
  T4 chem_source       csrc/chem_source.cu  (solvers/euler.py)
  K5 stencil_sgs_matvec csrc/stencil_solve.cu (linalg/stencil_solve.py)
  K6 stencil_fgmres     csrc/stencil_solve.cu (linalg/stencil_solve.py)
  K7 gradient_rows      csrc/gradients_tiled.cu (ops/gradients_tiled.py)
  K8 edge_win           csrc/edge_win.cu     (ops/edge_flux.py)
  K9 inlet_tc           csrc/inlet_tc.cu     (solvers/inlet_tc.py)
  K10 edge_implicit     csrc/edge_implicit.cu, edge_implicit_3d.cu
      (ops/edge_implicit.py; the kernel in edge_implicit.cuh)
  K11 ausm_flux_jac     csrc/ausm_jac.cu      (ops/edge_kernels.py)
  K12 sst_assemble      csrc/sst_assemble.cu  (turbulence/sst_assemble.py)
  K13 edge_list_flux    csrc/edge_list.cu     (ops/edge_flux.py; the
      edge pass, and edge_list_sums, the node sums: edge_list_terms)
T3, K8 and K13 share the per-edge device function of csrc/edge_side.cuh
(compiled for the (dimension, species count) shapes of EDGE_SHAPES, and
one run-time instance for every other shape up to 3D and 16 species; K8's
first pass is T3's slot pass under a kernel name of its own); K10 shares
its species h/cp lookup and Stefan-Maxwell solve (compiled for the species
counts of IMPLICIT_SPECIES in the dimensions of IMPLICIT_DIMS), and K10 and
K11 (AUSM_SPECIES in AUSM_DIMS) its implicit AUSM+-up face (ausm_face,
ausm_jac_entry); K5 and K6 for the block widths of STENCIL_WIDTHS, and
one run-time-width instance for every other width up to STENCIL_MAX_V;
T2 is compiled for the counts
of NODE_STATE_SPECIES, T4 for the (species, reaction) counts of
CHEM_SHAPES, K7 for the (offset count, dimension) stencils of
K7_STENCILS; each has a run-time-count instance for the other counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import NamedTuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("common.cuh", "edge_side.cuh", "thermo.cu", "node_state.cu",
           "edge_flux.cu", "chem_source.cu", "stencil_solve.cu",
           "gradients_tiled.cu", "edge_win.cu", "inlet_tc.cu",
           "edge_implicit.cuh", "edge_implicit.cu", "edge_implicit_3d.cu",
           "ausm_jac.cu", "sst_assemble.cu",
           "edge_list.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# per-source flags: K9 and K12 keep the plain version's operations (no
# fused multiply-adds), so K9's secant stops where the plain version's
# does and K12 rounds where its plain version rounds (it is bytes-bound:
# the contraction would buy nothing)
SOURCE_FLAGS = {"inlet_tc.cu": ("-fmad=false",),
                "sst_assemble.cu": ("-fmad=false",)}

# launches of each kernel since the last reset_launches(): the wrappers'
# and the replays' of captured graphs (driver.StepGraph); K5's sweep-only
# and matvec-only forms (BCGSTAB's preconditioner and matvec, LINELET's
# matvec) are also counted apart, as stencil_sweep_only and
# stencil_matvec_only, and K5's and K6's launches of their run-time-width
# instance as stencil_runtime_sgs_matvec and stencil_runtime_fgmres
launches = {"mixture_enthalpy": 0, "node_state": 0, "edge_flux": 0,
            "chem_source": 0, "stencil_sgs_matvec": 0, "stencil_fgmres": 0,
            "gradient_rows": 0, "edge_win": 0, "inlet_tc": 0,
            "edge_implicit": 0, "ausm_flux_jac": 0, "sst_assemble": 0,
            "edge_list_flux": 0, "edge_list_sum": 0,
            "stencil_sweep_only": 0, "stencil_matvec_only": 0,
            "stencil_runtime_sgs_matvec": 0, "stencil_runtime_fgmres": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_ARGTYPES = {
    "su2k_mixture_enthalpy": [_I, _I, _I, _I, _D, _D] + [_P] * 7,
    "su2k_node_state": [_I, _I, _I, _I, _I, _I, _D, _D, _D, _D, _I, _D, _I,
                        _D, _I] + [_P] * 15,
    "su2k_edge_flux": [_I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int), _I,
                       _D, _D, _D, _D, _D, _D, _D] + [_P] * 9,
    "su2k_chem_source": [_I, _I, _I, _I, _I, _D, _D, _I, ctypes.POINTER(_P),
                         ctypes.POINTER(ctypes.c_longlong),
                         ctypes.POINTER(_I), ctypes.POINTER(_I),
                         ctypes.POINTER(_I), _P, ctypes.POINTER(_D), _D, _D,
                         _P, _P],
    "su2k_stencil_sgs_matvec": [_I, _I, _I, _I, _I,
                                ctypes.POINTER(ctypes.c_int), _I, _I, _I, _I]
                               + [_P] * 11 + [_I],
    "su2k_stencil_fgmres": [_I, _I, _I, _I, _I,
                            ctypes.POINTER(ctypes.c_int), _I, _I, _D]
                           + [_P] * 6 + [_I] + [_P] * 5
                           + [_I, _I, _P, _I, ctypes.POINTER(_I)],
    "su2k_stencil_fgmres_grid": [_I] * 8 + [ctypes.POINTER(_I)],
    "su2k_gradient_rows": [_I, _I, _I, _I, _I, _I,
                           ctypes.POINTER(ctypes.c_int), _I, _I, _I,
                           ctypes.c_longlong] + [_P] * 6,
    "su2k_edge_win": [_I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int), _I,
                      _D, _D, _D, _D, _D, _D, _D] + [_P] * 12,
    "su2k_inlet_tc": [_I, _I, _I, _D, _D, _D, _D, _D, _D, _I, _D, _I, _D]
                     + [_P] * 7,
    "su2k_edge_implicit": [_I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int),
                           _I, _D, _D, _D, _D, _D, _D, _I, _I] + [_P] * 9,
    "su2k_ausm_flux_jac": [_I, _I, _I, _I, _I, _D] + [_P] * 9,
    "su2k_edge_list": [_I] * 6 + [_D] * 7 + [_P] * 8,
    "su2k_edge_list_sum": [_I] * 5 + [_P] * 5,
    "su2k_sst_assemble": [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int),
                          ctypes.POINTER(_D), ctypes.POINTER(_P),
                          ctypes.POINTER(ctypes.c_longlong)] + [_P] * 7,
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


def _check(name, *tensors, contiguous=True):
    dev = tensors[0].device
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 tensors, got {dtype}")
    for x in tensors:
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"{name}: every tensor must be on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {x.dtype} and {dtype}")
        if contiguous and not x.is_contiguous():
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
# The species counts T2 is compiled for (SU2K_NODE_STATE_BY_NS in
# csrc/node_state.cu): the 9-species case and the 3-species flat plate;
# every other count up to MAX_SPECIES runs the run-time instance.
NODE_STATE_SPECIES = (9, 3)


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
    state.NodeStateLite (lite), node-major; p.clip_temp: CLIPPING_TEMPRATURE
    (T within [0.95, 1.05] t_guess before the [tmin, tmax] clip)."""
    _check_species("node_state", lay.ns)
    if not 1 <= lay.ndim <= MAX_DIM:
        raise ValueError(f"node_state: {lay.ndim}D; the kernels take 1D to "
                         f"{MAX_DIM}D")
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
        p.secant_tol, p.bisect_iters, p.bisect_tol, int(p.clip_temp),
        _ptr(u), _ptr(t_guess),
        _ptr(tke), _ptr(tab), _ptr(cst), _ptr(u_out), _ptr(v),
        _ptr(nonphys), _ptr(dtdu), _ptr(dpdu), _ptr(gm1), _ptr(mu),
        _ptr(kappa), _ptr(xs), _stream())
    _raise("node_state", err)
    launches["node_state"] += 1
    if lite:
        return u_out, v, nonphys, gm1, mu, xs
    return u_out, v, nonphys, dtdu, dpdu, mu, kappa, xs


# ------------------------------------------------------------- T3, K8
# The (dimension, species count) shapes the per-edge body of T3, K8 and K13
# is compiled for (SU2K_EDGE_BY_SHAPE in csrc/edge_side.cuh): the 9-species
# combustion chemistry (the port's case, the reference combustor) in 2D and
# 3D (the case on geometry.structured.box_mesh), the 3-species air of the
# flat plate in 2D and of the 3D channel (tests/test_rans_3d.py).  Every
# other shape within MAX_DIM and MAX_SPECIES runs the run-time instance of
# the same body (its work arrays in local memory).
EDGE_SHAPES = ((2, 9), (2, 3), (3, 9), (3, 3))
# SU2K_MAXD and SU2K_MAXS (csrc/common.cuh): the bounds of the run-time
# instances of every kernel whose work arrays are sized by the counts
MAX_DIM = 3
MAX_SPECIES = 16


def _check_species(name, ns):
    if not 1 <= ns <= MAX_SPECIES:
        raise ValueError(f"{name}: {ns} species; the kernels take 1 to "
                         f"{MAX_SPECIES}")


def _check_edge_shape(name, lay):
    """Whether the per-edge body runs a compiled instance at lay's
    (dimension, species count) shape (False: the run-time instance);
    raises past MAX_DIM or MAX_SPECIES."""
    if not 1 <= lay.ndim <= MAX_DIM:
        raise ValueError(f"{name}: {lay.ndim}D with {lay.ns} species; the "
                         f"kernels take 1D to {MAX_DIM}D")
    _check_species(name, lay.ns)
    return (lay.ndim, lay.ns) in EDGE_SHAPES


def _edge_tables(lib, sc):
    """The h/cp spline tables and the constants (mm, Stefan-Maxwell
    denominators) of the per-edge body, built once per library."""
    tab = _cached(lib, "_k_hcp_table", lambda: torch.cat(
        [lib.h_y, lib.h_y2, lib.cp_y, lib.cp_y2]).contiguous())
    cst = _cached(lib, "_k_edge_consts", lambda: torch.cat(
        [lib.mm, sc.sm_den.reshape(-1)]).contiguous())
    return tab, cst


def _edge_args(name, lib, lay, sc, consts, f_all, offsets, fam_normal,
               fam_evec):
    """Checked, contiguous operands of T3/K8 and the argument tail of their
    C calls (after n, nd, ns, kh, offsets)."""
    _check_edge_shape(name, lay)
    m_infty, pr_lam, pr_turb, le_turb = consts
    f_all = f_all.contiguous()
    fam_normal = fam_normal.contiguous()
    fam_evec = fam_evec.contiguous()
    tab, cst = _edge_tables(lib, sc)
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
    """Kernel K8: T3's edge terms summed per node: res (nVar, N), lc (N,),
    lv (N,) (ops/edge_flux.roll_subtract order), from one C call that runs
    T3's slot pass into a scratch and then the node sums."""
    f_all, args = _edge_args("edge_win", lib, lay, sc, consts, f_all,
                             offsets, fam_normal, fam_evec)
    n, kh = f_all.shape[1], len(offsets)
    kw = dict(dtype=f_all.dtype, device=f_all.device)
    res = torch.empty((lay.nvar, n), **kw)
    lc = torch.empty((n,), **kw)
    lv = torch.empty((n,), **kw)
    sflux = torch.empty((kh, lay.nvar, n), **kw)
    slc = torch.empty((kh, n), **kw)
    slv = torch.empty((kh, n), **kw)
    err = _lib().su2k_edge_win(*args, _ptr(sflux), _ptr(slc), _ptr(slv),
                               _ptr(res), _ptr(lc), _ptr(lv), _stream())
    _raise("edge_win", err)
    launches["edge_win"] += 1
    return res, lc, lv


# ---------------------------------------------------------------- K13
def _edge_list_rows(name, lib, lay, sc, consts, f_nodes, edges, edge_normal,
                    coords):
    """K13's edge pass: rows (E, nVar + 2), each edge's flux, lc and lv,
    from the node-major stack f_nodes (N, R), contiguous and 16-byte
    aligned (a fresh allocation is)."""
    m_infty, pr_lam, pr_turb, le_turb = consts
    edge_normal = edge_normal.contiguous()
    coords = coords.contiguous()
    edges = edges.contiguous()
    tab, cst = _edge_tables(lib, sc)
    _check(name, f_nodes, edge_normal, coords, tab, cst)
    from su2_tpu_torch.ops.edge_flux import stack_rows
    n, nrow = f_nodes.shape
    ne = edges.shape[0]
    if nrow != stack_rows(lay)["total"] or f_nodes.data_ptr() % 16 \
            or edges.shape != (ne, 2) or edges.dtype != torch.int64 \
            or edges.device != f_nodes.device \
            or edge_normal.shape != (ne, lay.ndim) \
            or coords.shape != (n, lay.ndim):
        raise ValueError(f"{name}: the stack (N, R) node-major, 16-byte "
                         "aligned, edges (E, 2) int64 on the same device, "
                         "edge_normal (E, d), coords (N, d)")
    rows = torch.empty((ne, lay.nvar + 2), dtype=f_nodes.dtype,
                       device=f_nodes.device)
    err = _lib().su2k_edge_list(
        int(f_nodes.dtype == torch.float64), n, ne, lay.ndim, lay.ns, lib.nt,
        lib.t0, lib.dt, m_infty, pr_lam, pr_turb, le_turb, sc.mm_sum,
        _ptr(f_nodes), _ptr(edges), _ptr(edge_normal), _ptr(coords),
        _ptr(tab), _ptr(cst), _ptr(rows), _stream())
    _raise(name, err)
    launches["edge_list_flux"] += 1
    return rows


def edge_list_flux(lib, lay, sc, consts, f_all, edges, edge_normal, coords):
    """Kernel K13's edge pass: the interior edge terms of every edge (i, j)
    of the list edges (E, 2) int64, from the columns i and j of the stack
    f_all (R, N), the area normals edge_normal (E, d) and coords (N, d).
    f_all is read in place where it is the transposed view of a node-major
    stack (ops/edge_flux.stack_nodes(...).T); a feature-major one is
    copied node-major first.  Returns flux (nVar, E), lc (E,), lv (E,) in
    edge order: views of the pass's edge-major rows (E, nVar + 2)."""
    _check_edge_shape("edge_list_flux", lay)
    f_nodes = f_all.T
    if not f_nodes.is_contiguous() or f_nodes.data_ptr() % 16:
        f_nodes = f_nodes.clone(memory_format=torch.contiguous_format)
    rows = _edge_list_rows("edge_list_flux", lib, lay, sc, consts, f_nodes,
                           edges, edge_normal, coords)
    nv = lay.nvar
    return rows[:, :nv].T, rows[:, nv], rows[:, nv + 1]


def edge_list_sums(mesh, rows):
    """Kernel K13's node sums: the edge rows (E, nVar + 2) summed per node
    of mesh in slot order, the first nVar columns times node_sign_t, the
    last two (lc, lv) times its absolute value, pad slots zero: bit for bit
    mesh.scatter_edges_mixed(rows[:, :nVar], rows[:, nVar:]).  Returns res
    (N, nVar), lc (N,), lv (N,): views of one (N, nVar + 2) tensor."""
    rows = rows.contiguous()
    slots, sign = mesh.node_edges_t, mesh.node_sign_t
    _check("edge_list_sums", rows, sign)
    n, ne, deg = mesh.npoint, mesh.nedge, mesh.max_degree
    cw = rows.shape[1]
    if rows.shape != (ne, cw) or cw < 3 or slots.dtype != torch.int64 \
            or slots.device != rows.device or slots.shape != (deg * n,) \
            or sign.shape != (deg * n,):
        raise ValueError("edge_list_sums: rows (E, nVar + 2) of mesh's "
                         "edges; node_edges_t int64 and node_sign_t "
                         "(max_degree * N,) on the same device")
    out = torch.empty((n, cw), dtype=rows.dtype, device=rows.device)
    err = _lib().su2k_edge_list_sum(
        int(rows.dtype == torch.float64), n, ne, cw - 2, deg, _ptr(rows),
        _ptr(slots), _ptr(sign), _ptr(out), _stream())
    _raise("edge_list_sums", err)
    launches["edge_list_sum"] += 1
    return out[:, :cw - 2], out[:, cw - 2], out[:, cw - 1]


def edge_list_terms(lib, lay, sc, consts, f_nodes, mesh):
    """Kernel K13, the whole call (two launches): the edge pass over mesh's
    edge list from the node-major stack f_nodes (N, R) read in place, then
    the node sums (edge_list_sums).  Returns res (N, nVar), lc (N,), lv
    (N,)."""
    _check_edge_shape("edge_list_terms", lay)
    rows = _edge_list_rows("edge_list_terms", lib, lay, sc, consts, f_nodes,
                           mesh.edges, mesh.edge_normal, mesh.coords)
    return edge_list_sums(mesh, rows)


# ---------------------------------------------------------------- T4
# The (species, reaction) counts T4 is compiled for (SU2K_CHEM_BY_SR in
# csrc/chem_source.cu): the 9-species, 2-reaction case and the case cut to
# 3 species; every other shape up to MAX_SPECIES species and MAX_REACTIONS
# (SU2K_MAXR) reactions runs the run-time instance.
CHEM_SHAPES = ((9, 2), (3, 2))
MAX_REACTIONS = 8
# SU2K_CHEM_SRCS: the row sources T4 stages its inputs from; CHEM_SPAN: the
# widest column span chem_sources gives one source
CHEM_SOURCES = 4
CHEM_SPAN = 32


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


def chem_sources(fields):
    """T4's row sources of the (N,) or (N, w) input views fields (T, rho,
    Y[, omega_t]; 2-D views with unit column stride): a view joins a source
    of the same storage and row stride while the source's columns span at
    most CHEM_SPAN and its row stride.  Returns ([(storage element offset,
    row stride, width)] per source, its storage tensor's index in fields,
    [(source, column)] per field)."""
    srcs, owner, at = [], [], []
    for f, x in enumerate(fields):
        key = (x.untyped_storage().data_ptr(), x.stride(0))
        off, w = x.storage_offset(), x.shape[1] if x.ndim == 2 else 1
        for i, (lo, stride, width) in enumerate(srcs):
            new_lo = min(lo, off)
            new_hi = max(lo + width, off + w)
            if key == owner[i][1] \
                    and new_hi - new_lo <= min(stride, CHEM_SPAN):
                srcs[i] = (new_lo, stride, new_hi - new_lo)
                break
        else:
            srcs.append((off, x.stride(0), w))
            owner.append((f, key))
            i = len(srcs) - 1
        at.append((i, off))
    return (srcs, [o for o, _ in owner],
            [(i, off - srcs[i][0]) for i, off in at])


def chem_source(lib, prm, t, rho, ys, omega_turb=None):
    """Kernel T4: species production omega (N, S) [kg/(m^3 s)]; PaSR when
    omega_turb is given.  t, rho, omega_turb (N,) and ys (N, S) may be
    column views of wider rows (the step passes those of the primitive
    rows and the turbulence state): the kernel stages them in place
    (chem_sources); a view without unit column stride is copied."""
    n, ns, nr = t.shape[0], lib.nspecies, lib.nreactions
    _check_species("chem_source", ns)
    if not 1 <= nr <= MAX_REACTIONS:
        raise ValueError(f"chem_source: {nr} reactions; the kernel takes 1 "
                         f"to {MAX_REACTIONS}")
    fields = [t, rho, ys] + ([] if omega_turb is None else [omega_turb])
    if t.ndim != 1 or rho.shape != (n,) or ys.shape != (n, ns) \
            or (omega_turb is not None and omega_turb.shape != (n,)):
        raise ValueError("chem_source: t, rho, omega_turb (N,), ys (N, S)")
    fields = [x if x.stride(-1) == 1 or x.ndim == 1 and x.stride(0) >= 1
              else x.contiguous() for x in fields]
    tab, cst = _chem_tables(lib)
    _check("chem_source", tab, cst, *fields, contiguous=False)
    host = _cached(lib, "_k_chem_host", lambda: (
        ctypes.c_double * cst.numel())(*cst.double().cpu().tolist()))
    srcs, owner, at = chem_sources(fields)
    k = len(srcs)
    item = t.element_size()
    ptrs = [fields[f].untyped_storage().data_ptr() + lo * item
            for f, (lo, _, _) in zip(owner, srcs)]
    fsrc = [i for i, _ in at] + [-1] * (4 - len(at))
    fcol = [c for _, c in at] + [0] * (4 - len(at))
    out = torch.empty((n, ns), dtype=t.dtype, device=t.device)
    err = _lib().su2k_chem_source(
        int(t.dtype == torch.float64), n, ns, nr, lib.nt, lib.t0, lib.dt, k,
        (_P * k)(*ptrs), (ctypes.c_longlong * k)(*[st for _, st, _ in srcs]),
        (_I * k)(*[w for _, _, w in srcs]), (_I * 4)(*fsrc), (_I * 4)(*fcol),
        _ptr(tab), host, float(prm.c_mu), float(prm.pasr_lb), _ptr(out),
        _stream())
    _raise("chem_source", err)
    launches["chem_source"] += 1
    return out


# ------------------------------------------------------------------ K5, K6
# Work space of the block partials of K6's cooperative grid (v >= 4): two
# buffers of at most 4,096 blocks (more than any card holds at once).
_PART_CAP = 2 * 4096
# The block widths K5 and K6 are compiled for (SU2K_BY_WIDTH in
# csrc/stencil_solve.cu): 2 (the SST's system) and 3, the flow's nDim +
# nSpecies + 2 at 3 and 9 species: 7 and 13 in 2D, 8 and 14 in 3D.  Every
# other width from 4 to STENCIL_MAX_V, the flow's nDim + nSpecies + 2 up
# to MAX_DIM and MAX_SPECIES, runs the run-time kernels (sgs_pass_rt,
# matvec_rt, fgmres_rt), instantiated for the class bounds
# STENCIL_RT_CLASSES (SU2K_BY_CLASS): width v runs the smallest class >= v,
# its block-row loops unrolled to the class under a b < v guard;
# runtime=True in a wrapper forces them at any width of 4 to STENCIL_MAX_V
# (tests and measurements only: the solvers never pass it).
STENCIL_WIDTHS = (2, 3, 7, 8, 13, 14)
STENCIL_MAX_V = MAX_DIM + MAX_SPECIES + 2
STENCIL_RT_CLASSES = (6, 12, 16, 21)
# K6 runs K5's warp-per-block-row mapping over the color-major node list
# in one cooperative grid from this width up (fgmres_rows_kernel at the
# compiled 7, 8, 13, 14, fgmres_rt_kernel at every width from here), a
# thread per node in one thread-block cluster below (fgmres_cluster_kernel,
# compiled for 2 and 3: its per-node register arrays need the width at
# compile time)
K6_ROWS_MIN_V = 4
# the stencil's offsets at most (SU2K_MAXK in csrc/stencil_solve.cu)
STENCIL_MAX_OFFSETS = 8
# RtPlan's fields in csrc/stencil_solve.cu's order
RT_PLAN_FIELDS = ("vb", "res", "gpb", "grp", "slot_s", "slot_t", "base",
                  "smem", "grid")


class RtPlan(NamedTuple):
    """K6's plan at a run-time width (RtPlan in csrc/stencil_solve.cu):
    the width class vb; res 1: the resident form, gpb groups a block of
    grp bytes each (sweep-block rows of slot_s bytes, dinv rows of slot_t)
    after base bytes of scalars and staged vectors; smem bytes of dynamic
    shared memory; the cooperative grid."""
    vb: int
    res: int
    gpb: int
    grp: int
    slot_s: int
    slot_t: int
    base: int
    smem: int
    grid: int

    @property
    def form(self):
        return "resident" if self.res else "streamed"

    def c_ints(self):
        return (ctypes.c_int * len(RT_PLAN_FIELDS))(*self)


def stencil_instance(v, runtime=False):
    """The K5/K6 instance width v runs: ("compiled", v) at STENCIL_WIDTHS
    (unless runtime), else ("class", the class bound of the run-time
    kernels); ValueError past the range."""
    _check_width("stencil_instance", v, runtime)
    if v in STENCIL_WIDTHS and not runtime:
        return "compiled", v
    return "class", next(c for c in STENCIL_RT_CLASSES if c >= v)


def _align16(b):
    return -(-b // 16) * 16


def k6_plan(v, k, dtype, sel_bf16, color_major, n, grid, m=10,
            budget=None):
    """K6's plan at a run-time width v with k offsets on n nodes.  grid
    None: the streamed form, whose shared memory (the scalars and the
    group's staged vectors, sized for STENCIL_MAX_OFFSETS at a row stride
    of v | 1, so the grid does not depend on k) sets the co-resident grid
    (stencil_fgmres_grid).  With the grid: the resident form where the
    block's ceil(groups / grid) groups' sweep rows (k v v rows of the
    sweep blocks and v v of dinv: the 16-byte chunks that cover each run
    in the color-major layout, a copy a lane through the node list in the
    natural one) fit after those in budget bytes (default, and at most,
    the SMEM_PER_BLOCK a block may take) with ceil(grid / H100_SMS) such
    blocks on an SM, at a class up to 16 (the 21 class's kernel holds no
    resident rows); else the streamed form.  A pure function: a smaller
    budget forces the streamed form (tests)."""
    es = 8 if dtype == torch.float64 else 4
    ess = 2 if sel_bf16 else es
    words = 50 + 5 * m + m * m                       # fg_smem_words(m)
    base = _align16(es * (words + (STENCIL_MAX_OFFSETS + 2) * 32 * (v | 1)))
    vb = stencil_instance(v, runtime=True)[1]
    streamed = RtPlan(vb, 0, 0, 0, 0, 0, base, base, 0)
    if grid is None:
        return streamed
    contig = lambda e: (32 * e // 16 + 1) * 16
    gath = lambda e: 32 * max(e, 4)
    slot_s = contig(ess) if color_major else gath(ess)
    slot_t = contig(es) if color_major else gath(es)
    grp = k * v * v * slot_s + v * v * slot_t
    groups = -(-n // 32)
    gpb = -(-groups // grid)
    smem = base + gpb * grp
    cap = SMEM_PER_BLOCK if budget is None else min(budget, SMEM_PER_BLOCK)
    per_sm = -(-grid // H100_SMS)
    if vb <= 16 and smem <= cap \
            and per_sm * (smem + SMEM_RESERVED) <= SMEM_PER_SM:
        return RtPlan(vb, 1, gpb, grp, slot_s, slot_t, base, smem, grid)
    return streamed._replace(grid=grid)


def _check_width(name, v, runtime=False):
    """Refuse a block width no instance of K5/K6 takes, naming the range."""
    lo = K6_ROWS_MIN_V if runtime else min(STENCIL_WIDTHS)
    if not lo <= v <= STENCIL_MAX_V:
        what = ("the run-time kernels take" if runtime
                else f"the kernels are compiled for {STENCIL_WIDTHS} and "
                "take, through the run-time kernels, every width of")
        raise ValueError(f"{name}: block width {v}; {what} {lo} to "
                         f"{STENCIL_MAX_V}")


def _runtime(v, runtime):
    return runtime or v not in STENCIL_WIDTHS


def _check_stencil(name, selp, selm, dinv, diag, colors, r, offsets, ncolor,
                   sweep=True, runtime=False, aligned=False):
    """Device, dtype, shape and contiguity of the stencil-solve operands;
    aligned (K6): its run-time kernel copies the sweep blocks and dinv as
    16-byte chunks, so at a run-time width these must start on a 16-byte
    boundary (every fresh torch allocation does)."""
    dtype, dev = r.dtype, r.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 vectors, got {dtype}")
    n, v = r.shape
    k = len(offsets)
    _check_width(name, v, runtime)
    if not 1 <= k <= STENCIL_MAX_OFFSETS:
        raise ValueError(f"{name}: 1 to {STENCIL_MAX_OFFSETS} stencil "
                         f"offsets, got {k}")
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
    if aligned and _runtime(v, runtime) and any(
            x.data_ptr() % 16 for x in (selp, dinv)):
        raise ValueError(f"{name}: at width {v} the blocks must start on a "
                         "16-byte boundary")
    return n, v, k, sel_bf16


def _node_order(name, colors, order, color_major, n, device):
    """The sweep's node order: order checked, or the colors sorted here
    (stencil_solve.color_order's result) when None and the blocks are in
    the natural layout."""
    if order is None:
        if color_major:
            raise ValueError(f"{name}: color-major blocks need their node "
                             "order")
        return torch.argsort(colors, stable=True).to(torch.int32)
    if order.dtype != torch.int32 or tuple(order.shape) != (n,) \
            or order.device != device or not order.is_contiguous():
        raise ValueError(f"{name}: order must be a contiguous int32 ({n},) "
                         f"tensor on {device}")
    return order


def stencil_sgs_matvec(selp_t, selm_t, dinv_t, diag_t, colors, r, offsets,
                       ncolor, sweep=True, matvec=True, order=None,
                       color_major=False, runtime=False):
    """Kernel K5: (z, w) with z the symmetric multicolor block-SGS sweep of
    r over the sweep blocks selp_t (float or bf16) and w = A z over the
    matvec blocks selm_t.  sweep=False: w = A r (z is r); matvec=False: w
    is None.  Blocks (K*v*v, N) and (v*v, N), colors (N,) int8, r (N, v).
    Each sweep pass runs over order, the nodes sorted by color
    (stencil_solve.color_order; the solve path passes the one
    StencilSolveOps makes once per solve, and a call without it sorts the
    colors here); color_major: selp_t and dinv_t are in the color-major
    lane layout of order (stencil_solve.to_color_major), else in the
    natural one.  runtime: the run-time kernels at any width from
    K6_ROWS_MIN_V (STENCIL_WIDTHS' compiled ones included)."""
    if not (sweep or matvec):
        raise ValueError("stencil_sgs_matvec: nothing to compute")
    n, v, k, sel_bf16 = _check_stencil("stencil_sgs_matvec", selp_t, selm_t,
                                       dinv_t, diag_t, colors, r, offsets,
                                       ncolor, sweep, runtime)
    if sweep:
        order = _node_order("stencil_sgs_matvec", colors, order, color_major,
                            n, r.device)
    z = torch.empty_like(r) if sweep else r
    zbuf = torch.empty_like(r) if sweep and ncolor > 1 else None
    w = torch.empty_like(r) if matvec else None
    offs = (ctypes.c_int * k)(*[int(o) for o in offsets])
    err = _lib().su2k_stencil_sgs_matvec(
        int(r.dtype == torch.float64), int(sel_bf16), v, n, k, offs,
        int(ncolor), int(sweep), int(matvec), int(bool(color_major)),
        _ptr(selp_t), _ptr(selm_t), _ptr(dinv_t), _ptr(diag_t),
        _ptr(colors) if sweep else None, _ptr(order) if sweep else None,
        _ptr(r), _ptr(z) if sweep else None, _ptr(w), _ptr(zbuf), _stream(),
        int(bool(runtime)))
    _raise("stencil_sgs_matvec", err)
    launches["stencil_sgs_matvec"] += 1
    if _runtime(v, runtime):
        launches["stencil_runtime_sgs_matvec"] += 1
    if not (sweep and matvec):
        launches["stencil_sweep_only" if sweep else "stencil_matvec_only"] \
            += 1
    return z, w


def k6_groups(v, runtime=False):
    """32-node groups per block of K6's rows kernel: at a compiled width
    (k5_groups in csrc/stencil_solve.cu) as many as fit 512 threads at v
    warps each; the run-time kernel's blocks hold one."""
    return 1 if _runtime(v, runtime) else 512 // (32 * v)


def k6_launch_plan(dtype, sel_bf16, v, k, n, color_major, m=10,
                   smem_budget=None):
    """K6's plan at a run-time width on the current card: the co-resident
    grid of the streamed form's shared memory (stencil_fgmres_grid), then
    k6_plan's form for that grid."""
    grid = stencil_fgmres_grid(dtype, sel_bf16, v, n, m, runtime=True)
    return k6_plan(v, k, dtype, sel_bf16, color_major, n, grid, m,
                   smem_budget)


def stencil_fgmres(selp_t, selm_t, dinv_t, diag_t, colors, b, offsets, ncolor,
                   m, tol, order=None, color_major=False, cluster=0,
                   runtime=False, smem_budget=None):
    """Kernel K6: one FGMRES(m) cycle preconditioned by the sweep, in one
    launch (a cooperative grid at v >= K6_ROWS_MIN_V, one thread-block
    cluster below).  Returns (x (N, v), relative residual, iterations as
    int32), the contract of krylov.fgmres without x0.  At v >=
    K6_ROWS_MIN_V the sweep passes run over order (the nodes sorted by
    color; sorted here when None) and color_major says that selp_t and
    dinv_t are in its color-major lane layout (stencil_solve.
    to_color_major); below it K6 reads the natural layout only.  cluster
    (below K6_ROWS_MIN_V, 1 to 16) forces the cluster's CTAs; 0, as every
    solver call leaves it, takes 16 where the card fits such a cluster,
    else the portable 8 (16 measured faster at 9,072 nodes; PERF.md §6).
    runtime: as in stencil_sgs_matvec; at a run-time width smem_budget
    caps the resident form's shared memory (k6_plan; tests only: no
    solver passes it)."""
    n, v, k, sel_bf16 = _check_stencil("stencil_fgmres", selp_t, selm_t,
                                       dinv_t, diag_t, colors, b, offsets,
                                       ncolor, runtime=runtime, aligned=True)
    if not 1 <= m <= 64:
        raise ValueError(f"stencil_fgmres: 1 to 64 Krylov vectors, got {m}")
    if v < K6_ROWS_MIN_V:
        if color_major:
            raise ValueError(f"stencil_fgmres: at v = {v} K6 reads the "
                             "natural layout, not the color-major one")
        order = None
    else:
        order = _node_order("stencil_fgmres", colors, order, color_major, n,
                            b.device)
    plan = k6_launch_plan(b.dtype, sel_bf16, v, k, n, color_major, m,
                          smem_budget) if _runtime(v, runtime) else None
    x = torch.empty_like(b)
    stats = torch.empty((2,), dtype=b.dtype, device=b.device)
    ws = torch.empty(((2 * m + 3) * n * v,), dtype=b.dtype, device=b.device)
    part = torch.empty((_PART_CAP,), dtype=b.dtype, device=b.device) \
        if v >= K6_ROWS_MIN_V else None
    offs = (ctypes.c_int * k)(*[int(o) for o in offsets])
    err = _lib().su2k_stencil_fgmres(
        int(b.dtype == torch.float64), int(sel_bf16), v, n, k, offs,
        int(ncolor), int(m), float(tol), _ptr(selp_t), _ptr(selm_t),
        _ptr(dinv_t), _ptr(diag_t), _ptr(colors), _ptr(order),
        int(bool(color_major)), _ptr(b), _ptr(x), _ptr(stats), _ptr(ws),
        _ptr(part), _PART_CAP, int(cluster), _stream(), int(bool(runtime)),
        None if plan is None else plan.c_ints())
    _raise("stencil_fgmres", err)
    launches["stencil_fgmres"] += 1
    if plan is not None:
        launches["stencil_runtime_fgmres"] += 1
    return x, stats[0], stats[1].to(torch.int32)


def stencil_fgmres_grid(dtype, sel_bf16, v, n, m, cluster=0, runtime=False):
    """The blocks of K6's launch for these arguments on the current card (a
    host query; launches nothing): at v < K6_ROWS_MIN_V the cluster size C,
    CTAs of 1024 threads (stencil_fgmres's cluster, with 0 16 where such
    a cluster fits, else 8); at v >= K6_ROWS_MIN_V the co-resident blocks
    of the cooperative grid, of 32 v k6_groups(v) threads and at most one
    per 32 k6_groups(v) nodes (runtime: of the run-time kernel, at its
    streamed form's shared memory, which k6_plan's forms keep
    co-resident)."""
    _check_width("stencil_fgmres_grid", v, runtime)
    plan = k6_plan(v, STENCIL_MAX_OFFSETS, dtype, sel_bf16, False, n, None,
                   m) if _runtime(v, runtime) else None
    blocks = _lib().su2k_stencil_fgmres_grid(
        int(dtype == torch.float64), int(bool(sel_bf16)), int(v), int(n),
        int(m), _PART_CAP, int(cluster), int(bool(runtime)),
        None if plan is None else plan.c_ints())
    if blocks <= 0:
        _raise("stencil_fgmres_grid", -blocks)
    return blocks


# ---------------------------------------------------------------- K7
# The (offset count, dimension) stencils K7 is compiled for (SU2K_K7_BY_KD
# in csrc/gradients_tiled.cu): the 2D quad channel's 4 offsets and the 3D
# hex box's 6; every other count up to K7_MAX_OFFSETS runs the run-time-K
# instance.  The window form's nodes per thread and largest window
# (SU2K_K7_NPT, SU2K_K7_MAXW): a window is a whole number of warps' nodes.
K7_STENCILS = ((4, 2), (6, 3))
K7_MAX_OFFSETS = 16
K7_NODES_PER_THREAD = 4
K7_MAX_WINDOW = 2048
K7_GRANULE = 32 * K7_NODES_PER_THREAD
# the H100 (sm_90): shared memory of an SM and the most one block may take,
# the 1 KB the runtime reserves per block, and the SM count
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK = 232_448
SMEM_RESERVED = 1_024
H100_SMS = 132


class K7Plan(NamedTuple):
    """K7's form: "window" (T nodes per block, hlo / hhi rows staged before
    / after them, smem bytes of shared memory per block) or "streamed"
    (the other fields 0)."""
    form: str
    window: int
    hlo: int
    hhi: int
    smem: int


def k7_plan(n, ng, offsets, itemsize, window=None):
    """K7's form for q (n, ng) of itemsize-byte values and these stencil
    offsets.  The window form stages the rows q[s - hlo, s + T + hhi) of a
    block's T nodes (hlo, hhi: the largest backward and forward offset)
    plus a 16-byte pad, T a multiple of K7_GRANULE up to K7_MAX_WINDOW:
    where two blocks fit an SM (else one) with windows that stage at most
    K + 1 rows a node (the streamed form's taps and the node's own), T is
    the smallest that covers the nodes in as few waves of blocks over the
    card's H100_SMS SMs as the largest such window does.  Else the streamed form.  window
    forces a form (as no solver does): 0 the streamed one, T > 0 a window
    of T nodes (ValueError where it is no such T or does not fit)."""
    hlo = max(0, -min(offsets))
    hhi = max(0, max(offsets))
    streamed = K7Plan("streamed", 0, 0, 0, 0)
    smem = lambda t: ((t + hlo + hhi) * ng + 16 // itemsize) * itemsize
    if window == 0:
        return streamed
    if window is not None:
        if window < 1 or window % K7_GRANULE or window > K7_MAX_WINDOW \
                or smem(window) > SMEM_PER_BLOCK or hlo >= n or hhi >= n:
            raise ValueError(f"k7_plan: a window of {window} nodes does not "
                             f"fit ({smem(window)} bytes, offsets {hlo} / "
                             f"{hhi}, {n} nodes; a multiple of {K7_GRANULE} "
                             f"up to {K7_MAX_WINDOW})")
        return K7Plan("window", window, hlo, hhi, smem(window))
    if hlo >= n or hhi >= n:
        return streamed
    g = K7_GRANULE
    tmin = max(g, -(-(hlo + hhi) // (len(offsets) * g)) * g)
    for ctas in (2, 1):
        budget = min(SMEM_PER_SM // ctas - SMEM_RESERVED, SMEM_PER_BLOCK)
        tmax = min(K7_MAX_WINDOW,
                   ((budget // itemsize - 16 // itemsize) // ng - hlo - hhi)
                   // g * g)
        if tmax < tmin:
            continue
        slots = ctas * H100_SMS
        waves = -(-n // (slots * tmax))
        t = -(-n // (waves * slots * g)) * g
        t = min(max(t, tmin), tmax)
        return K7Plan("window", t, hlo, hhi, smem(t))
    return streamed


def gradient_rows(q, coef, offsets, bnd=None, vol=None, window=None):
    """Kernel K7: the stencil gradient rows (nG*d, N) of q (N, nG): WLS
    with coef the (K, N, d) WLS coefficients, or GG with coef the signed
    dual normals, bnd (N, d) and vol (N,) given.  The form is k7_plan's;
    window forces one (k7_plan's keyword: tests and measurements only)."""
    gg = bnd is not None
    q = q.contiguous()
    coef = coef.contiguous()
    extra = (bnd.contiguous(), vol.contiguous()) if gg else ()
    _check("gradient_rows", q, coef, *extra)
    n, ng = q.shape
    k = len(offsets)
    d = coef.shape[-1]
    if coef.shape != (k, n, d) or (gg and (extra[0].shape != (n, d)
                                           or extra[1].shape != (n,))):
        raise ValueError("gradient_rows: q (N, nG), coef (K, N, d), "
                         "bnd (N, d), vol (N,)")
    if not 1 <= k <= K7_MAX_OFFSETS:
        raise ValueError(f"gradient_rows: {k} offsets; the kernel takes 1 "
                         f"to {K7_MAX_OFFSETS}")
    plan = k7_plan(n, ng, offsets, q.element_size(), window)
    out = torch.empty((ng * d, n), dtype=q.dtype, device=q.device)
    offs = (ctypes.c_int * k)(*[int(o) for o in offsets])
    err = _lib().su2k_gradient_rows(
        int(q.dtype == torch.float64), int(gg), n, ng, d, k, offs,
        plan.window, plan.hlo, plan.hhi, plan.smem, _ptr(q), _ptr(coef),
        _ptr(extra[0]) if gg else None, _ptr(extra[1]) if gg else None,
        _ptr(out), _stream())
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
# The dimensions and species counts K10 is compiled for
# (SU2K_IMPLICIT_BY_NS in csrc/edge_implicit.cuh; the 2D instances built
# from edge_implicit.cu, the 3D ones from edge_implicit_3d.cu): the
# 9-species case and the 3-species flat plate, in 2D and 3D; every other
# count up to MAX_SPECIES runs the run-time instance of its dimension.
IMPLICIT_DIMS = (2, 3)
IMPLICIT_SPECIES = (9, 3)


def edge_implicit(lib, lay, sc, consts, f_all, offsets, fam_normal, fam_evec,
                  muscl, use_limiter):
    """Kernel K10: per-family implicit edge flux (Kh, nVar, N) and edge
    Jacobian blocks j_i, j_j (Kh, nVar^2, N) from the stack f_all (R, N) of
    ops/edge_implicit.implicit_rows, in one launch for every family;
    consts = (m_infty, prandtl_turb, lewis_turb).  2D and 3D."""
    if lay.ndim not in IMPLICIT_DIMS:
        raise ValueError(f"edge_implicit: {lay.ndim}D; the kernel takes "
                         f"{IMPLICIT_DIMS}")
    _check_species("edge_implicit", lay.ns)
    if use_limiter and not muscl:
        raise ValueError("edge_implicit: a limiter needs MUSCL")
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


# ---------------------------------------------------------------- K11
# The dimensions and species counts K11 is compiled for (SU2K_AUSM_BY_NS
# in csrc/ausm_jac.cu): the case's 9, nVar = 13 in 2D and 14 in 3D; every
# other count up to MAX_SPECIES runs the run-time instance of its
# dimension.
AUSM_DIMS = (2, 3)
AUSM_SPECIES = (9,)


def ausm_flux_jac(lay, v_i, v_j, normal, m_infty, s_i, s_j,
                  edge_major=False):
    """Kernel K11: the AUSM+-up flux and both Jacobians per edge, 2D or 3D.
    Feature-major (edge_major False): v_* (nPrim, E), normal (d, E), s_*
    (nVar, E) -> flux (nVar, E), jac_i, jac_j (nVar, nVar, E).
    Edge-major: the transposes, (E, nPrim) ... -> (E, nVar),
    (E, nVar, nVar).  A zero normal gives exact zeros."""
    if lay.ndim not in AUSM_DIMS:
        raise ValueError(f"ausm_flux_jac: {lay.ndim}D; the kernel takes "
                         f"{AUSM_DIMS}")
    _check_species("ausm_flux_jac", lay.ns)
    ins = [x.contiguous() for x in (v_i, v_j, normal, s_i, s_j)]
    _check("ausm_flux_jac", *ins)
    ne = ins[0].shape[0 if edge_major else 1]
    widths = (lay.nprim, lay.nprim, lay.ndim, lay.nvar, lay.nvar)
    for x, w in zip(ins, widths):
        if tuple(x.shape) != ((ne, w) if edge_major else (w, ne)):
            raise ValueError("ausm_flux_jac: v_* (nPrim, E), normal (d, E), "
                             "s_* (nVar, E), or their transposes with "
                             "edge_major")
    nv = lay.nvar
    kw = dict(dtype=ins[0].dtype, device=ins[0].device)
    if edge_major:
        flux = torch.empty((ne, nv), **kw)
        ji = torch.empty((ne, nv, nv), **kw)
    else:
        flux = torch.empty((nv, ne), **kw)
        ji = torch.empty((nv, nv, ne), **kw)
    jj = torch.empty_like(ji)
    err = _lib().su2k_ausm_flux_jac(
        int(kw["dtype"] == torch.float64), int(bool(edge_major)), ne,
        lay.ndim, lay.ns, float(m_infty), *(_ptr(x) for x in ins),
        _ptr(flux), _ptr(ji), _ptr(jj), _stream())
    _raise("ausm_flux_jac", err)
    launches["ausm_flux_jac"] += 1
    return flux, ji, jj


# ---------------------------------------------------------------- K12
# The per-node fields of K12, in the order of csrc/sst_assemble.cu's
# SstField, with the shape of one node's values.
SST_FIELDS = (("q", (2,)), ("rho", ()), ("vel", ("d",)), ("gq", (2, "d")),
              ("mu", ()), ("mut", ()), ("dist", ()), ("strain", ()),
              ("diverg", ()), ("vol", ()), ("dt", ()), ("f1", ()),
              ("f2", ()), ("cdkw", ()), ("coords", ("d",)))


def sst_assemble(consts, offsets, fields, wall, snormal, pvec):
    """Kernel K12: the fused SST system (res (2, N), dd (2, N), sel
    (4K, N)) from the per-node fields (a dict by the names of SST_FIELDS,
    (N, ...) tensors read through their strides where they lie: columns
    of the primitive rows, a slice of a gradient set, rows of the
    feature-major gradient), the (N,) bool wall mask, the stencil normals
    snormal (K, N, d) and pvec (K, N); consts = the 10 SST constants and
    CFL_red."""
    snormal, pvec = snormal.contiguous(), pvec.contiguous()
    _check("sst_assemble", snormal, pvec)
    k, n, d = snormal.shape
    dtype, dev = snormal.dtype, snormal.device
    if tuple(pvec.shape) != (k, n) or k != len(offsets):
        raise ValueError("sst_assemble: snormal (K, N, d), pvec (K, N)")
    ptrs, strides = [], []
    for name, inner in SST_FIELDS:
        x = fields[name]
        shape = (n,) + tuple(d if s == "d" else s for s in inner)
        if x.dtype != dtype or x.device != dev:
            raise ValueError(f"sst_assemble: {name} must be {dtype} on {dev}")
        if x.shape != shape:
            raise ValueError(f"sst_assemble: {name} has shape "
                             f"{tuple(x.shape)}, expected {shape}")
        ptrs.append(x.data_ptr())
        strides += list(x.stride()) + [0] * (3 - x.ndim)
    if wall.dtype != torch.bool or wall.shape != (n,) \
            or not wall.is_contiguous() or wall.device != dev:
        raise ValueError(f"sst_assemble: wall is a contiguous (N,) bool mask "
                         f"on {dev}")
    if len(consts) != 11:
        raise ValueError("sst_assemble: 11 constants")
    res = torch.empty((2, n), dtype=dtype, device=dev)
    dd = torch.empty((2, n), dtype=dtype, device=dev)
    sel = torch.empty((4 * k, n), dtype=dtype, device=dev)
    err = _lib().su2k_sst_assemble(
        int(dtype == torch.float64), n, d, k,
        (ctypes.c_int * k)(*offsets), (_D * 11)(*consts),
        (_P * len(ptrs))(*ptrs), (ctypes.c_longlong * len(strides))(*strides),
        _ptr(wall), _ptr(snormal), _ptr(pvec), _ptr(res), _ptr(dd), _ptr(sel),
        _stream())
    _raise("sst_assemble", err)
    launches["sst_assemble"] += 1
    return res, dd, sel
