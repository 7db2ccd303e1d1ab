"""Batched chemistry/thermo/transport library (ReactingModelLibrary).

Torch port of the JAX package's chemistry library: every function takes
T (N,), rho (N,), Ys (N, S) and returns batched tensors.  All quantities are
dimensional (SI) like the reference library; molar masses stay in g/mol so
concentrations are c_s = 1e3*rho*Y_s/M_s [mol/m^3]
(reacting_model_library.cpp:701-705).

``mixture_enthalpy`` is the hot call of the temperature solve and of the
boundary states: on a CUDA tensor it launches the hand-written kernel
(kernels.mixture_enthalpy, csrc/thermo.cu); on a CPU tensor it runs the
plain version below.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from su2_tpu_torch.chemistry.spline import spline_eval, spline_second_derivatives
from su2_tpu_torch.io.tables import (R_UNGAS, R_UNGAS_ATM, LibraryFiles,
                                     read_manifest)

# clipping constants from the reference
_Y_FLOOR = 1.0e-30          # vanishing-species clip (SetMassFractions, :73)
_Y_RATE_GUARD = 1.0e-15     # negative-exponent rate guard (:885)
_Y_JAC_GUARD = 1.0e-10      # Jacobian denominator guard (:133)
_KEQ_COMPLETE = 1.0e10      # "complete reaction" Kp threshold (:848)

_TABLE_FIELDS = ("mm", "ri", "diff_vol", "h_form",
                 "cp_y", "cp_y2", "h_y", "h_y2", "s_y", "s_y2",
                 "mu_y", "mu_y2", "ka_y", "ka_y2",
                 "stoich_r", "stoich_p", "exp_f", "exp_b", "reversible",
                 "arr_a", "arr_beta", "arr_ta", "has_backward",
                 "arr_a_b", "arr_beta_b", "arr_ta_b",
                 "lnkc_y", "lnkc_y2", "lnkp_y", "lnkp_y2")


@dataclass(frozen=True)
class ChemLib:
    """Static chemistry data as tensors (same fields as the JAX ChemLib)."""
    mm: torch.Tensor            # (S,) molar masses [g/mol]
    ri: torch.Tensor            # (S,) specific gas constants [J/(kg K)]
    diff_vol: torch.Tensor      # (S,) Fuller diffusion volumes
    h_form: torch.Tensor        # (S,) formation enthalpies (as shipped)
    cp_y: torch.Tensor          # (S, n) spline tables on the shared T grid
    cp_y2: torch.Tensor
    h_y: torch.Tensor
    h_y2: torch.Tensor
    s_y: torch.Tensor
    s_y2: torch.Tensor
    mu_y: torch.Tensor
    mu_y2: torch.Tensor
    ka_y: torch.Tensor
    ka_y2: torch.Tensor
    stoich_r: torch.Tensor      # (S, R)
    stoich_p: torch.Tensor      # (S, R)
    exp_f: torch.Tensor         # (R, S)
    exp_b: torch.Tensor         # (R, S)
    reversible: torch.Tensor    # (R,) float mask
    arr_a: torch.Tensor         # (R,)
    arr_beta: torch.Tensor
    arr_ta: torch.Tensor
    has_backward: torch.Tensor  # (R,) float mask
    arr_a_b: torch.Tensor
    arr_beta_b: torch.Tensor
    arr_ta_b: torch.Tensor
    lnkc_y: torch.Tensor        # (R, n) ln Kc / ln Kp tables
    lnkc_y2: torch.Tensor
    lnkp_y: torch.Tensor
    lnkp_y2: torch.Tensor
    t0: float = 0.0
    dt: float = 0.0
    nt: int = 0
    nspecies: int = 0
    nreactions: int = 0
    species: tuple = ()

    def to(self, device=None, dtype=None) -> "ChemLib":
        """Copy of the library with every table on `device` in `dtype`."""
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device=device, dtype=dtype)
            for k in _TABLE_FIELDS})

    @property
    def dtype(self):
        return self.mm.dtype

    @property
    def device(self):
        return self.mm.device


def load_library(manifest_path: str, lib_path: str | None = None,
                 dtype=torch.float64, device="cpu") -> ChemLib:
    files = read_manifest(manifest_path, lib_path)
    return build_library(files, dtype, device)


def build_library(files: LibraryFiles, dtype=torch.float64,
                  device="cpu") -> ChemLib:
    """ChemLib from parsed library files (host precompute in float64, same
    arithmetic as the JAX package's build_library)."""
    mix = files.mixture
    ns = mix.nspecies

    t = files.thermo[0].temps
    for tab in files.thermo + files.transport:
        assert tab.temps.shape == t.shape and np.allclose(tab.temps, t), \
            "species tables must share one equispaced temperature grid"
    h_step = t[1] - t[0]
    assert np.allclose(np.diff(t), h_step)

    def stack(tabs, col):
        return np.stack([tab.cols[col] for tab in tabs])  # (S, n)

    cp = stack(files.thermo, "cp")
    hh = stack(files.thermo, "h")
    ss = stack(files.thermo, "s")
    mu = stack(files.transport, "mu")
    ka = stack(files.transport, "kappa")

    def spl(yy):
        return spline_second_derivatives(t, yy)

    chem = files.chemistry
    if chem is None:
        nr = 0
        z_sr = np.zeros((ns, 0))
        z_rs = np.zeros((0, ns))
        z_r = np.zeros((0,))
        kin = dict(stoich_r=z_sr, stoich_p=z_sr.copy(), exp_f=z_rs,
                   exp_b=z_rs.copy(), reversible=z_r, arr_a=z_r, arr_beta=z_r,
                   arr_ta=z_r, has_backward=z_r, arr_a_b=z_r, arr_beta_b=z_r,
                   arr_ta_b=z_r)
    else:
        nr = chem.nreactions
        kin = dict(stoich_r=chem.stoich_r, stoich_p=chem.stoich_p,
                   exp_f=chem.exp_f, exp_b=chem.exp_b,
                   reversible=chem.reversible.astype(np.float64),
                   arr_a=chem.arr_a, arr_beta=chem.arr_beta,
                   arr_ta=chem.arr_ta,
                   has_backward=chem.has_backward.astype(np.float64),
                   arr_a_b=chem.arr_a_b, arr_beta_b=chem.arr_beta_b,
                   arr_ta_b=chem.arr_ta_b)

    # ln Kc / ln Kp tables (exact at the knots), splined on the same grid
    dcoeff = kin["stoich_p"] - kin["stoich_r"]                     # (S, R)
    g = hh - t[None, :] * ss                                       # (S, n)
    dg = np.einsum("sn,sr->rn", g, dcoeff)
    dnu = dcoeff.sum(0)                                            # (R,)
    lnkp = -dg / (R_UNGAS * t[None, :])
    lnkc = lnkp - dnu[:, None] * np.log(R_UNGAS_ATM * t[None, :])

    def a(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(
            device=device, dtype=dtype)

    return ChemLib(
        mm=a(mix.molar_masses), ri=a(R_UNGAS / mix.molar_masses),
        diff_vol=a(mix.diff_volumes), h_form=a(mix.formation_enthalpies),
        cp_y=a(cp), cp_y2=a(spl(cp)), h_y=a(hh), h_y2=a(spl(hh)),
        s_y=a(ss), s_y2=a(spl(ss)), mu_y=a(mu), mu_y2=a(spl(mu)),
        ka_y=a(ka), ka_y2=a(spl(ka)),
        **{k: a(v) for k, v in kin.items()},
        lnkc_y=a(lnkc), lnkc_y2=a(spl(lnkc)),
        lnkp_y=a(lnkp), lnkp_y2=a(spl(lnkp)),
        t0=float(t[0]), dt=float(h_step), nt=int(t.shape[0]),
        nspecies=ns, nreactions=nr, species=tuple(mix.species),
    )


# --------------------------------------------------------------------------
# thermo (per-species splines are molar [J/kmol...]; /M gives specific)
# --------------------------------------------------------------------------

def clip_mass_fractions(ys: torch.Tensor) -> torch.Tensor:
    """Vanishing-species clip (SetMassFractions, :70-75)."""
    return torch.where(ys < 0.0, _Y_FLOOR, ys)


def species_cp(lib: ChemLib, t: torch.Tensor) -> torch.Tensor:
    """(..., S) specific heats [J/(kg K)]."""
    return spline_eval(lib.t0, lib.dt, lib.nt, lib.cp_y, lib.cp_y2, t) / lib.mm


def species_enthalpy(lib: ChemLib, t: torch.Tensor) -> torch.Tensor:
    """(..., S) static enthalpies [J/kg] (SetPartialEnthalpy, :503)."""
    return spline_eval(lib.t0, lib.dt, lib.nt, lib.h_y, lib.h_y2, t) / lib.mm


def species_energy(lib: ChemLib, t: torch.Tensor) -> torch.Tensor:
    """(..., S) internal energies e_s = h_s - R_s T (SetPartialEnergy)."""
    return species_enthalpy(lib, t) - lib.ri * t[..., None]


def mixture_rgas(lib: ChemLib, ys: torch.Tensor) -> torch.Tensor:
    return (clip_mass_fractions(ys) * lib.ri).sum(-1)


def mixture_cp(lib: ChemLib, t: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    return (clip_mass_fractions(ys) * species_cp(lib, t)).sum(-1)


def mixture_enthalpy_plain(lib: ChemLib, t: torch.Tensor,
                           ys: torch.Tensor) -> torch.Tensor:
    """h(T, Y) = sum_s Y_s h_s(T) [J/kg], plain torch (kernel T1's reference)."""
    return (clip_mass_fractions(ys) * species_enthalpy(lib, t)).sum(-1)


def mixture_enthalpy(lib: ChemLib, t: torch.Tensor,
                     ys: torch.Tensor) -> torch.Tensor:
    """Mixture enthalpy; CUDA tensors go through kernel T1."""
    if t.is_cuda:
        from su2_tpu_torch import kernels
        return kernels.mixture_enthalpy(lib, t, ys)
    return mixture_enthalpy_plain(lib, t, ys)


def frozen_gamma_sound(lib: ChemLib, t: torch.Tensor, ys: torch.Tensor):
    """gamma and frozen sound speed a = sqrt(gamma R T) (:387-394)."""
    cp = mixture_cp(lib, t, ys)
    rg = mixture_rgas(lib, ys)
    gamma = cp / (cp - rg)
    return gamma, torch.sqrt(gamma * rg * t)


def molar_from_mass(lib: ChemLib, ys: torch.Tensor) -> torch.Tensor:
    """X_i = (Y_i/M_i) * sum(Y)/sum(Y_j/M_j) (SetMolarFromMass, :84-93)."""
    ysc = clip_mass_fractions(ys)
    xs = ysc / lib.mm
    return xs * (ysc.sum(-1, keepdim=True) / xs.sum(-1, keepdim=True))


# --------------------------------------------------------------------------
# transport: Wilke mixture rules, Fuller binary diffusion, Stefan-Maxwell
# --------------------------------------------------------------------------

def species_viscosity(lib: ChemLib, t: torch.Tensor) -> torch.Tensor:
    return spline_eval(lib.t0, lib.dt, lib.nt, lib.mu_y, lib.mu_y2, t)


def species_conductivity(lib: ChemLib, t: torch.Tensor) -> torch.Tensor:
    return spline_eval(lib.t0, lib.dt, lib.nt, lib.ka_y, lib.ka_y2, t)


def wilke_consts(lib: ChemLib):
    """Static (S, S) Wilke pair factors: c_mass[i, j] = (M_j/M_i)^(1/4),
    c_den[i, j] = 1/sqrt(8 (1 + M_i/M_j))."""
    mm = lib.mm
    c_mass = (mm[None, :] / mm[:, None]) ** 0.25
    c_den = 1.0 / torch.sqrt(8.0 * (1.0 + mm[:, None] / mm[None, :]))
    return c_mass, c_den


def _wilke_phi_term(lib: ChemLib, mu_s: torch.Tensor) -> torch.Tensor:
    """(.., i, j) pair term (1+sqrt(mu_i/mu_j)(M_j/M_i)^(1/4))^2 /
    sqrt(8(1+M_i/M_j))."""
    c_mass, c_den = wilke_consts(lib)
    r = torch.sqrt(mu_s)
    ratio = r[..., :, None] / r[..., None, :]
    num = 1.0 + ratio * c_mass
    return num * num * c_den


def mixture_viscosity(lib: ChemLib, t: torch.Tensor,
                      ys: torch.Tensor) -> torch.Tensor:
    """Wilke rule (ComputeEta, :634-663)."""
    mu_s = species_viscosity(lib, t)
    yom = clip_mass_fractions(ys) / lib.mm
    phi = (_wilke_phi_term(lib, mu_s) * yom[..., None, :]).sum(-1)
    return (mu_s * yom / phi).sum(-1)


def mixture_conductivity(lib: ChemLib, t: torch.Tensor,
                         ys: torch.Tensor) -> torch.Tensor:
    """Wasilewska-style rule with the 1.065 off-diagonal factor
    (ComputeLambda, :670-696)."""
    mu_s = species_viscosity(lib, t)
    ka_s = species_conductivity(lib, t)
    yom = clip_mass_fractions(ys) / lib.mm
    pair = _wilke_phi_term(lib, mu_s)
    eye = torch.eye(lib.nspecies, dtype=pair.dtype, device=pair.device)
    off = 1.065 * pair * (1.0 - eye)
    phi = (off * yom[..., None, :]).sum(-1) + yom
    return (ka_s * yom / phi).sum(-1)


def fuller_den(lib: ChemLib) -> torch.Tensor:
    """(S, S) Fuller denominator Mij (v_i^(1/3) + v_j^(1/3))^2."""
    mm = lib.mm
    mij = torch.sqrt(mm[:, None] * mm[None, :] / (mm[:, None] + mm[None, :]))
    cbr = torch.pow(lib.diff_vol, 1.0 / 3.0)
    return mij * (cbr[:, None] + cbr[None, :]) ** 2


def binary_diffusion(lib: ChemLib, t: torch.Tensor,
                     p: torch.Tensor) -> torch.Tensor:
    """Fuller D_ij = 1e-3 T^1.75/(P Mij (v_i^(1/3)+v_j^(1/3))^2)
    (GetDij_SM, :751-766).  Returns (..., S, S)."""
    return 1.0e-3 * t[..., None, None] ** 1.75 \
        / (p[..., None, None] * fuller_den(lib))


def stefan_maxwell_gamma(lib: ChemLib, rho, xs, ys, dij) -> torch.Tensor:
    """Gamma matrix of the Stefan-Maxwell system (GetGamma, :771-798)."""
    sigma = ys.sum(-1)
    mtot = 1.0 / (ys / lib.mm).sum(-1)
    pref = (sigma * mtot / rho)[..., None, None]
    eye = torch.eye(lib.nspecies, dtype=xs.dtype, device=xs.device)
    off = -pref * xs[..., :, None] / (lib.mm[None, :] * dij)
    sum_terms = ((1.0 / dij) * (1.0 - eye) * xs[..., None, :]).sum(-1)
    diag = pref[..., 0] * sum_terms / lib.mm
    return off * (1.0 - eye) + eye * diag[..., :, None]


# --------------------------------------------------------------------------
# kinetics
# --------------------------------------------------------------------------

def concentrations(lib: ChemLib, rho, ys) -> torch.Tensor:
    """c_s = 1e3 rho Y_s / M_s [mol/m^3] (SetConcentration, :701-705)."""
    return 1.0e3 * rho[..., None] * clip_mass_fractions(ys) / lib.mm


def equilibrium_constants(lib: ChemLib, t: torch.Tensor):
    """(Kc, Kp) per reaction from the ln-K tables (ComputeKeq, :803-829)."""
    ln_kc = spline_eval(lib.t0, lib.dt, lib.nt, lib.lnkc_y, lib.lnkc_y2, t)
    ln_kp = spline_eval(lib.t0, lib.dt, lib.nt, lib.lnkp_y, lib.lnkp_y2, t)
    return torch.exp(ln_kc), torch.exp(ln_kp)


def rate_constants(lib: ChemLib, t: torch.Tensor):
    """(kf, kb, Kc) per reaction (ComputeRateConstants, :835-866)."""
    tt = t[..., None]
    kf = lib.arr_a * tt ** lib.arr_beta * torch.exp(-lib.arr_ta / tt)
    kc_gibbs, kp = equilibrium_constants(lib, t)
    kb_gibbs = torch.where(
        (lib.reversible > 0.5) & (kp <= _KEQ_COMPLETE), kf / kc_gibbs, 0.0)
    kb_arr = lib.arr_a_b * tt ** lib.arr_beta_b * torch.exp(-lib.arr_ta_b / tt)
    use_b = lib.has_backward > 0.5
    kb = torch.where(use_b, kb_arr, kb_gibbs)
    kc = torch.where(use_b, kf / torch.where(kb_arr != 0.0, kb_arr, 1.0),
                     kc_gibbs)
    return kf, kb, kc


def _conc_power_product(cs, exps, ys) -> torch.Tensor:
    """prod_s c_s^exp[r,s] with the negative-exponent vanishing-species
    guard (SetReactionRates, :880-916).  cs: (..., S); exps: (R, S)."""
    c = cs[..., None, :]
    powed = torch.where(exps == 0.0, 1.0, c ** exps)
    prod = torch.prod(powed, dim=-1)
    neg_guard = ((exps < 0.0) & (ys[..., None, :] < _Y_RATE_GUARD)).any(-1)
    return torch.where(neg_guard, 0.0, prod)


def reaction_rates(lib: ChemLib, t, rho, ys):
    """(Rf, Rb, Kc) forward/backward rates (SetReactionRates, :872-920)."""
    ysc = clip_mass_fractions(ys)
    cs = concentrations(lib, rho, ysc)
    kf, kb, kc = rate_constants(lib, t)
    rf = kf * _conc_power_product(cs, lib.exp_f, ysc)
    rb = kb * _conc_power_product(cs, lib.exp_b, ysc)
    return rf, rb, kc


def omega_tensor(lib: ChemLib, rf, rb) -> torch.Tensor:
    """omega_{i,r} = 1e-3 M_i (nu''-nu')_{i,r} (Rf - Rb)_r (SetSourceTerm,
    :99-114).  Returns (..., S, R)."""
    dcoeff = lib.stoich_p - lib.stoich_r
    return 1.0e-3 * lib.mm[:, None] * dcoeff * (rf - rb)[..., None, :]


def dfr_drho(lib: ChemLib, rf, rb, rho, ys) -> torch.Tensor:
    """Df_r/Drho_j tensor (Set_DfrDrhos, :122-136).  Returns (..., S, R)."""
    num = rf[..., None, :] * lib.exp_f.T - rb[..., None, :] * lib.exp_b.T
    den = (rho[..., None] * ys)[..., None]
    guard = (ys > _Y_JAC_GUARD)[..., None]
    return torch.where(guard, num / torch.where(guard, den, 1.0), 0.0)


def pasr_constants(lib: ChemLib, dfr, omega_turb, c_mu: float,
                   pasr_lb: float) -> torch.Tensor:
    """PaSR constant k_r per reaction (AssemblePaSRConstant, :161-190 and
    GetTimeCombustion_r, :208-227).  Returns (..., R)."""
    participates = (lib.stoich_r != 0.0) | (lib.stoich_p != 0.0)   # (S, R)
    mag = torch.abs(dfr * lib.mm[:, None]) * participates
    highest = mag.amax(dim=-2)                                     # (..., R)
    tau_mix = 1.0 / (c_mu * omega_turb)[..., None]
    k = 1.0 / (1.0 + tau_mix * highest)
    return torch.where(highest <= 0.0, 1.0, torch.clamp(k, min=pasr_lb))


def mass_production(lib: ChemLib, omega_ir, pasr_k=None) -> torch.Tensor:
    """omega_i = sum_r [k_r] omega_{i,r} (GetMassProductionTerm).  (..., S)."""
    if pasr_k is None:
        return omega_ir.sum(-1)
    return (omega_ir * pasr_k[..., None, :]).sum(-1)


def backfor_contributions(lib: ChemLib, t, rf, rb, kc):
    """d(rates)/dT composite terms (Set_BackFor_Contr, :233-289), each
    (..., R): for_contr = Rf (beta + Ta/T)/T; back_contr = Rb (beta + Ta/T)/T
    - Rb dKc/dT / Kc (Gibbs Kc) or Rb (beta_b + Ta_b/T)/T (explicit
    backward rate).  dKc/dT by the reference's relative step eps = 1e-6."""
    eps = 1.0e-6
    tp = t + eps * t
    kc_gibbs_p, _ = equilibrium_constants(lib, tp)
    tpc = tp[..., None]
    kf_p = lib.arr_a * tpc ** lib.arr_beta * torch.exp(-lib.arr_ta / tpc)
    kb_p = lib.arr_a_b * tpc ** lib.arr_beta_b \
        * torch.exp(-lib.arr_ta_b / tpc)
    use_b = lib.has_backward > 0.5
    dtp = (tp - t)[..., None]
    # Gibbs case: Kc_pert = Kc (derivative 0) when Rb == 0, which also
    # avoids inf - inf for complete reactions whose Kc overflows
    kc_deriv_gibbs = torch.where(rb > 0.0, (kc_gibbs_p - kc) / dtp, 0.0)
    kc_deriv_arr = (kf_p / torch.where(kb_p != 0.0, kb_p, 1.0) - kc) / dtp
    kc_deriv = torch.where(use_b, kc_deriv_arr, kc_deriv_gibbs)
    tt = t[..., None]
    tmp = (lib.arr_beta + lib.arr_ta / tt) / tt
    for_contr = rf * tmp
    back_gibbs = rb * (tmp - kc_deriv / torch.where(kc != 0.0, kc, 1.0))
    back_arr = rb * (lib.arr_beta_b + lib.arr_ta_b / tt) / tt
    return torch.where(use_b, back_arr, back_gibbs), for_contr


def source_jacobian(lib: ChemLib, t, rho, ys, rf, rb, kc, pasr_k=None):
    """Chemistry source Jacobian [dT column | species block], (..., S, S+1):
    GetTurbSourceJacobian (:295-319) with the PaSR constants pasr_k,
    GetSourceJacobian (:325-350, k_r = 1) without."""
    back, forw = backfor_contributions(lib, t, rf, rb, kc)
    if pasr_k is None:
        pasr_k = torch.ones_like(rf)
    fixed = 1.0e-3 * lib.mm[:, None] * (lib.stoich_p - lib.stoich_r)
    d_t = ((forw - back) * pasr_k)[..., None, :] * fixed          # (..., S, R)
    d_t = d_t.sum(-1)
    dfr = dfr_drho(lib, rf, rb, rho, ys)                          # (..., S=j, R)
    # species block [i, j] = sum_r fixed[i, r] k_r dfr[j, r]
    d_y = ((fixed * pasr_k[..., None, :])[..., :, None, :]
           * dfr[..., None, :, :]).sum(-1)
    return torch.cat([d_t[..., :, None], d_y], dim=-1)
