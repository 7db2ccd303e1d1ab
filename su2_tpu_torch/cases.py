"""Synthetic 9-species / 2-reaction REACTIVE_RANS channel case (NumPy only).

``write_case(directory)`` writes the chemistry library of the case — the
manifest, the mixture, the chemistry and one transport and one thermo
table per species — in the file grammar of io/tables.py, and returns the
cfg text.  The JAX package loads the same files through CONFIG_LIB_FILE.

The data are deterministic and physically plausible, not a fit to any
mechanism:
  * cp(T)/R = a + (b - a) x^2/(1 + x^2), x = T/theta, per species; h and s
    are its exact integrals from 298.15 K, offset by the published
    formation enthalpy and standard entropy;
  * Sutherland mu(T) and an Eucken conductivity kappa = mu (cp + 5/4 R_s);
  * Fuller diffusion volumes and the published molar masses.
Reactions (SI units, concentrations in mol/m^3):
  1. C4H6 + 3.5 O2 => 4 CO + 3 H2O, irreversible, exponents 1.15 / 1.65
     (a fuel order below 1, as in Westbrook-Dryer global steps, makes the
     rate non-Lipschitz at Y_fuel = 0: rounding-level traces of fuel then
     switch on finite rates, and two correct implementations drift apart
     by 1e-5 K within three iterations);
  2. CO + 0.5 O2 <=> CO2, reversible; Keq from the tables or, with
     ``backward_rate=True``, an explicit backward Arrhenius rate.
The streams: pure C4H6 at 600 K and 12 m/s enters a channel filled with
O2 at 1200 K, 12 m/s and 101325 Pa, between two isothermal 600 K walls.
At the 6 m/s of the JAX package's tiny cfg, M_inf = 0.009 and the AUSM+-up
pressure-diffusion term (~1/f_a, f_a ~ 2 M_inf) makes the explicit flow
unstable at CFL 0.1 from about iteration 25 in both packages; cooling the
streams enough to raise M_inf would stop the reaction, so the velocity is
doubled instead.
"""

from __future__ import annotations

import os

import numpy as np

SPECIES = ("C4H6", "H2O", "O2", "CO", "CO2", "H2", "O", "OH", "H")

# name: (M [g/mol], h_f [kJ/mol], s0 [J/(mol K)], Fuller volume,
#        cp/R low, cp/R high, theta [K], mu_ref [Pa s] at 273.15 K,
#        Sutherland S [K])
_DATA = {
    "C4H6": (54.0904, 110.16, 278.74, 77.46, 8.0, 20.0, 900.0, 7.0e-6, 400.0),
    "H2O": (18.01528, -241.826, 188.83, 13.1, 4.0, 7.0, 1500.0, 9.0e-6, 600.0),
    "O2": (31.9988, 0.0, 205.15, 16.3, 3.5, 4.6, 1200.0, 1.92e-5, 127.0),
    "CO": (28.0101, -110.53, 197.66, 18.0, 3.5, 4.4, 1300.0, 1.66e-5, 118.0),
    "CO2": (44.0095, -393.52, 213.79, 26.9, 4.3, 7.5, 900.0, 1.37e-5, 222.0),
    "H2": (2.01588, 0.0, 130.68, 6.12, 3.45, 4.3, 2000.0, 8.4e-6, 97.0),
    "O": (15.9994, 249.18, 161.06, 5.48, 2.55, 2.5, 1000.0, 1.9e-5, 150.0),
    "OH": (17.0073, 37.3, 183.74, 7.79, 3.5, 4.4, 2000.0, 1.9e-5, 150.0),
    "H": (1.00794, 217.999, 114.72, 2.31, 2.5, 2.5, 1000.0, 7.0e-6, 100.0),
}

R_UNGAS = 6.02214129e23 * 1.3806488e-23 * 1.0e3    # J/(kmol K), io/tables
T_REF = 298.15
T_GRID = np.arange(200.0, 6000.0 + 1e-9, 20.0)

# (A, beta, Ta [K]) per reaction, SI; backward rate of reaction 2
_ARR_1 = (2.0e6, 0.0, 15000.0)
_ARR_2 = (1.0e7, 0.0, 20000.0)
_ARR_2B = (5.0e13, 0.0, 52000.0)


def _cp_over_r(t, a, b, theta):
    x = t / theta
    return a + (b - a) * x * x / (1.0 + x * x)


def _h_integral(t, a, b, theta):
    """int cp/R dT from T_REF to t."""
    def prim(tt):
        x = tt / theta
        return a * tt + (b - a) * theta * (x - np.arctan(x))
    return prim(t) - prim(T_REF)


def _s_integral(t, a, b, theta):
    """int cp/(R T) dT from T_REF to t."""
    def prim(tt):
        x = tt / theta
        return a * np.log(tt) + 0.5 * (b - a) * np.log1p(x * x)
    return prim(t) - prim(T_REF)


def _row(values) -> str:
    """Floats written round-trip exact."""
    return " ".join(repr(float(x)) for x in values)


def _write(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\nSTOP\n")


def write_library(directory: str, backward_rate: bool = False) -> str:
    """Write the library files into `directory`; returns the manifest path."""
    os.makedirs(directory, exist_ok=True)
    names = ["mixture.txt", "chemistry.txt"]
    mix = [f"{len(SPECIES)}"]
    for sp in SPECIES:
        mm, hf, _, dv = _DATA[sp][:4]
        mix.append(f"{sp} {_row((mm, hf, dv))}")
    _write(os.path.join(directory, "mixture.txt"), mix)

    chem = ["2", "SI",
            "C4H6_1.15 + 3.5O2_1.65 => 4CO + 3H2O",
            _row(_ARR_1),
            "CO + 0.5O2 <=> CO2_1",
            _row(_ARR_2)]
    if backward_rate:
        chem.append("Available Backward Rate reaction 2: "
                    + _row(_ARR_2B))
    _write(os.path.join(directory, "chemistry.txt"), chem)

    t = T_GRID
    for sp in SPECIES:
        mm, hf, s0, _, a, b, theta, mu_ref, s_mu = _DATA[sp]
        cp = R_UNGAS * _cp_over_r(t, a, b, theta)
        h = hf * 1.0e6 + R_UNGAS * _h_integral(t, a, b, theta)
        s = s0 * 1.0e3 + R_UNGAS * _s_integral(t, a, b, theta)
        mu = mu_ref * (t / 273.15) ** 1.5 * (273.15 + s_mu) / (t + s_mu)
        kappa = mu * (cp / mm + 1.25 * R_UNGAS / mm)
        trans = [sp] + ["  " + _row(r) for r in zip(t, mu, kappa)]
        thermo = [sp] + ["  " + _row(r) for r in zip(t, cp, h, s)]
        tn, hn = f"transport_{sp}.txt", f"thermo_{sp}.txt"
        _write(os.path.join(directory, tn), trans)
        _write(os.path.join(directory, hn), thermo)
        names += [tn, hn]
    manifest = os.path.join(directory, "manifest.txt")
    with open(manifest, "w") as f:
        f.write("\n".join(names) + "\n")
    return manifest


def cfg_text(manifest: str, mesh_file: str | None = None) -> str:
    """cfg of the case: REACTIVE_NAVIER_STOKES + SST + PaSR, AUSM first
    order, explicit flow, implicit SST by FGMRES + LU_SGS (the multicolor
    block-SGS sweep; JACOBI is the test variant that bypasses it)."""
    fuel = ", ".join(["1.0"] + ["0.0"] * (len(SPECIES) - 1))
    ox = ", ".join(["0.0", "0.0", "1.0"] + ["0.0"] * (len(SPECIES) - 3))
    mesh = f"MESH_FILENAME= {mesh_file}\n" if mesh_file else ""
    return f"""
CONFIG_LIB_FILE = {manifest}
{mesh}SPECIES_ORDER = ({", ".join(SPECIES)})
FREESTREAM_MASS_FRAC = ({ox})
PHYSICAL_PROBLEM= REACTIVE_NAVIER_STOKES
KIND_TURB_MODEL= SST
MACH_NUMBER= 0.02
FREESTREAM_TEMPERATURE= 1200.0
FREESTREAM_VELOCITY= (12.0, 0.0, 0.0)
FREESTREAM_PRESSURE= 101325.0
INLET_TYPE = TEMPERATURE_IMPOSE
MARKER_INLET= ( inlet, 600.0, 12.0, 1.0, 0.0, 0.0 )
INLET_MASS_FRAC = (inlet, {fuel})
MARKER_OUTLET= ( outlet, 101325.0)
MARKER_ISOTHERMAL = (upper_wall, 600.0, lower_wall, 600.0)
NUM_METHOD_GRAD= WEIGHTED_LEAST_SQUARES
CFL_NUMBER= 0.1
CONV_NUM_METHOD_FLOW= AUSM
SPATIAL_ORDER_FLOW= 1ST_ORDER
TIME_DISCRE_FLOW= EULER_EXPLICIT
TIME_DISCRE_TURB= EULER_IMPLICIT
LINEAR_SOLVER= FGMRES
LINEAR_SOLVER_PREC= LU_SGS
PASR_LB = 0.2
"""


def write_case(directory: str, backward_rate: bool = False,
               mesh_file: str | None = None) -> str:
    """Write the library into `directory` and return the cfg text."""
    return cfg_text(write_library(directory, backward_rate), mesh_file)


def with_total_conditions(text: str) -> str:
    """The cfg text with a TOTAL_CONDITIONS inlet (SU2's default
    INLET_TYPE): T_tot 600 K and P_tot 101404 Pa, about 0.5 rho v^2 of the
    12 m/s fuel stream (rho ~1.10 kg/m^3) above the outlet's 101325 Pa."""
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("INLET_TYPE", "MARKER_INLET"))]
    return "\n".join(lines + [
        "INLET_TYPE= TOTAL_CONDITIONS",
        "MARKER_INLET= ( inlet, 600.0, 101404.0, 1.0, 0.0, 0.0 )"]) + "\n"


# CFL of the implicit-flow variant (with_implicit_flow): the 9,072-node
# channel runs 20 iterations at CFL 1 in the port and in su2_tpu with the
# port's form of the effective diffusion (tests/test_torch_pure_streams.py)
IMPLICIT_CFL = 1.0


def with_implicit_flow(text: str, muscl: bool = True,
                       limiter: str | None = "VENKATAKRISHNAN",
                       cfl: float = IMPLICIT_CFL) -> str:
    """The cfg text with implicit flow: TIME_DISCRE_FLOW= EULER_IMPLICIT,
    the flow and SST systems solved by FGMRES with LINEAR_SOLVER_PREC=
    JACOBI, CFL_ADAPT= NO and CFL_NUMBER= cfl; SPATIAL_ORDER_FLOW=
    2ND_ORDER_LIMITER with SLOPE_LIMITER_FLOW= limiter (VENKATAKRISHNAN or
    BARTH_JESPERSEN), 2ND_ORDER with limiter None, 1ST_ORDER with
    muscl False."""
    keys = ("TIME_DISCRE_FLOW", "SPATIAL_ORDER_FLOW", "SLOPE_LIMITER_FLOW",
            "LINEAR_SOLVER_PREC", "CFL_NUMBER", "CFL_ADAPT")
    lines = [ln for ln in text.splitlines() if not ln.startswith(keys)]
    order = ("1ST_ORDER" if not muscl else
             "2ND_ORDER" if limiter is None else "2ND_ORDER_LIMITER")
    lines += ["TIME_DISCRE_FLOW= EULER_IMPLICIT",
              f"SPATIAL_ORDER_FLOW= {order}",
              "LINEAR_SOLVER_PREC= JACOBI",
              f"CFL_NUMBER= {cfl}",
              "CFL_ADAPT= NO"]
    if muscl and limiter is not None:
        lines.append(f"SLOPE_LIMITER_FLOW= {limiter}")
    return "\n".join(lines) + "\n"
