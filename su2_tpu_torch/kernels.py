"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

The kernels are compiled at first use with nvcc for sm_90a into one shared
library with a plain C interface (loaded with ctypes), under csrc/build/.
A hash of the sources names the library, so an edited source rebuilds.
Every kernel launches on torch.cuda.current_stream(), allocates nothing
and returns its cudaError_t; each wrapper below checks device, dtype,
shape and contiguity, allocates the outputs, launches, raises on a nonzero
error and adds one to its entry in ``launches``.

  T1 mixture_enthalpy  csrc/thermo.cu       (chemistry/library.py)
  T2 node_state        csrc/node_state.cu   (state.py)
  T3 edge_flux         csrc/edge_flux.cu    (ops/edge_flux.py)
  T4 chem_source       csrc/chem_source.cu  (solvers/euler.py)
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
SOURCES = ("common.cuh", "thermo.cu", "node_state.cu", "edge_flux.cu",
           "chem_source.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# launches of each kernel since the last reset_launches()
launches = {"mixture_enthalpy": 0, "node_state": 0, "edge_flux": 0,
            "chem_source": 0}

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
    return os.path.join(BUILD_DIR, f"libsu2k_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> tuple[str, str]:
    """Compile the kernels if the library for these sources is missing.
    Returns (library path, compiler output; empty when nothing was
    built).  verbose adds -Xptxas -v (registers, spills per kernel)."""
    path = library_path()
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp] + [os.path.join(CSRC, s) for s in SOURCES
                         if s.endswith(".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path, proc.stdout + proc.stderr


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


# ---------------------------------------------------------------- T3
def edge_flux(lib, lay, sc, consts, f_all, offsets, fam_normal, fam_evec):
    """Kernel T3: per-family interior edge flux (Kh, nVar, N) and spectral
    radii (Kh, N), (Kh, N) from the feature-major stack f_all (R, N)."""
    m_infty, pr_lam, pr_turb, le_turb = consts
    f_all = f_all.contiguous()
    fam_normal = fam_normal.contiguous()
    fam_evec = fam_evec.contiguous()
    tab = _cached(lib, "_k_hcp_table", lambda: torch.cat(
        [lib.h_y, lib.h_y2, lib.cp_y, lib.cp_y2]).contiguous())
    cst = _cached(lib, "_k_edge_consts", lambda: torch.cat(
        [lib.mm, sc.sm_den.reshape(-1)]).contiguous())
    _check("edge_flux", f_all, fam_normal, fam_evec, tab, cst)
    nrow, n = f_all.shape
    kh = len(offsets)
    from su2_tpu_torch.ops.edge_flux import stack_rows
    if nrow != stack_rows(lay)["total"] \
            or fam_normal.shape != (kh, n, lay.ndim) \
            or fam_evec.shape != (kh, n, lay.ndim):
        raise ValueError("edge_flux: f_all (R, N), fam_normal/fam_evec "
                         "(Kh, N, d)")
    kw = dict(dtype=f_all.dtype, device=f_all.device)
    flux = torch.empty((kh, lay.nvar, n), **kw)
    lc = torch.empty((kh, n), **kw)
    lv = torch.empty((kh, n), **kw)
    offs = (ctypes.c_int * kh)(*[int(o) for o in offsets])
    err = _lib().su2k_edge_flux(
        int(f_all.dtype == torch.float64), n, lay.ndim, lay.ns, kh, offs,
        lib.nt, lib.t0, lib.dt, m_infty, pr_lam, pr_turb, le_turb,
        sc.mm_sum, _ptr(f_all), _ptr(fam_normal), _ptr(fam_evec), _ptr(tab),
        _ptr(cst), _ptr(flux), _ptr(lc), _ptr(lv), _stream())
    _raise("edge_flux", err)
    launches["edge_flux"] += 1
    return flux, lc, lv


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
