"""SU2-compatible configuration system.

Parses the same ``.cfg`` text format as the reference's ``CConfig`` option
registry (reference: Common/src/config_structure.cpp:545-723 for the
fork-specific options) so the shipped ``Test_Cases`` run unmodified.

Instead of ~500 imperative ``addXOption`` calls + virtual dispatch, options
are declared in a typed registry table and materialized onto a plain Python
object; numerics modules read plain attributes (hashable / static under jit).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Any, Callable


# --------------------------------------------------------------------------
# Option kinds
# --------------------------------------------------------------------------

def _parse_bool(s: str) -> bool:
    s = s.strip().upper()
    if s in ("YES", "TRUE", "1"):
        return True
    if s in ("NO", "FALSE", "0"):
        return False
    raise ValueError(f"invalid boolean value {s!r}")


def _strip_parens(s: str) -> str:
    s = s.strip()
    if s.startswith("(") and s.endswith(")"):
        s = s[1:-1]
    return s


def _split_list(s: str) -> list[str]:
    s = _strip_parens(s)
    toks = [t for t in re.split(r"[,\s]+", s) if t]
    return toks


def _parse_double_list(s: str) -> list[float]:
    return [float(t) for t in _split_list(s)]


def _parse_string_list(s: str) -> list[str]:
    return _split_list(s)


def _parse_marker_inlet(s: str) -> dict[str, tuple[float, float, tuple[float, ...]]]:
    """MARKER_INLET = (name, Ttot, Ptot, nx, ny, nz, name2, ...).

    2D cfgs still list three flow-direction components.
    Returns {marker: (val1, val2, flow_dir)} where for TEMPERATURE_IMPOSE
    inlets val1 = static T, val2 = velocity magnitude (reference semantics).
    """
    toks = _split_list(s)
    if toks == ["NONE"] or not toks:
        return {}
    out: dict[str, tuple[float, float, tuple[float, ...]]] = {}
    i = 0
    while i < len(toks):
        name = toks[i]
        vals = [float(t) for t in toks[i + 1:i + 6]]
        out[name] = (vals[0], vals[1], tuple(vals[2:5]))
        i += 6
    return out


def _parse_marker_periodic(s: str) -> dict:
    """MARKER_PERIODIC = ( marker, donor, rcx, rcy, rcz, rax, ray, raz,
    tx, ty, tz, ... ) (config_structure.cpp periodic option)."""
    toks = _split_list(s)
    if toks == ["NONE"] or not toks:
        return {}
    out = {}
    i = 0
    deg2rad = 3.141592653589793 / 180.0
    while i < len(toks):
        name, donor = toks[i], toks[i + 1]
        vals = [float(t) for t in toks[i + 2:i + 11]]
        # rotation angles are given in degrees and stored in radians
        # (COptionPeriodic, option_structure.hpp:3050-3052)
        out[name] = (donor, tuple(vals[0:3]),
                     tuple(a * deg2rad for a in vals[3:6]),
                     tuple(vals[6:9]))
        i += 11
    return out


def _parse_dv_param(s: str) -> list[list]:
    """DV_PARAM = ( 1, 0.5 ); ( 1, 0.7 ) — per-DV parameter groups.
    FFD variables carry a leading string tag: ( MAIN_BOX, 2, 0, 0.0, 1.0 )."""
    groups = s.split(";")
    out = []
    for g in groups:
        toks = _split_list(g)
        if not toks or toks == ["NONE"]:
            continue
        row = []
        for t in toks:
            try:
                row.append(float(t))
            except ValueError:
                row.append(t)
        out.append(row)
    return out


def _parse_ffd_definition(s: str) -> list[tuple[str, list[float]]]:
    """FFD_DEFINITION = (BOX_TAG, x1,y1,z1, ..., x8,y8,z8); (...)
    (addFFDDefOption, config_structure.cpp:1788).  2D boxes list 8 coords
    (4 corners), 3D 24."""
    out = []
    for g in s.split(";"):
        toks = _split_list(g)
        if not toks or toks == ["NONE"]:
            continue
        out.append((toks[0], [float(t) for t in toks[1:]]))
    return out


def _parse_ffd_degree(s: str) -> list[list[int]]:
    """FFD_DEGREE = (di, dj, dk); (...) per box."""
    out = []
    for g in s.split(";"):
        toks = _split_list(g)
        if not toks or toks == ["NONE"]:
            continue
        out.append([int(float(t)) for t in toks])
    return out


def _parse_marker_pairs(s: str) -> dict[str, float]:
    """MARKER_OUTLET / MARKER_ISOTHERMAL / MARKER_HEATFLUX style: (name, val, ...)."""
    toks = _split_list(s)
    if toks == ["NONE"] or not toks:
        return {}
    out: dict[str, float] = {}
    for i in range(0, len(toks), 2):
        out[toks[i]] = float(toks[i + 1])
    return out


def _parse_marker_exhaust(s: str) -> dict[str, tuple[float, float]]:
    """MARKER_ENGINE_EXHAUST = (name, Tt, Pt, ...) — the reference's
    addExhaustOption (config_structure.cpp:949)."""
    toks = _split_list(s)
    if toks == ["NONE"] or not toks:
        return {}
    out: dict[str, tuple[float, float]] = {}
    for i in range(0, len(toks), 3):
        out[toks[i]] = (float(toks[i + 1]), float(toks[i + 2]))
    return out


def _parse_marker_names(s: str) -> list[str]:
    toks = _split_list(s)
    if toks == ["NONE"]:
        return []
    return toks


def _parse_inlet_mass_frac(s: str) -> dict[str, list[float]]:
    """INLET_MASS_FRAC = (marker, y1, ..., yNs; marker2, y1, ...).

    Reference: per-marker species list option (config_structure.cpp:558),
    groups separated by ';'.
    """
    s = _strip_parens(s)
    out: dict[str, list[float]] = {}
    for group in s.split(";"):
        toks = [t for t in re.split(r"[,\s]+", group) if t]
        if not toks:
            continue
        out[toks[0]] = [float(t) for t in toks[1:]]
    return out


def _parse_marker_riemann(s: str) -> dict:
    """MARKER_RIEMANN = (name, KIND, var1, var2, fx, fy, fz, ...) —
    groups of 7 (Riemann_Map kinds, option_structure.hpp: e.g.
    TOTAL_CONDITIONS_PT, STATIC_SUPERSONIC_INFLOW_PT/PD, STATIC_PRESSURE,
    DENSITY_VELOCITY).  Returns {marker: (kind, v1, v2, dir)}."""
    toks = _split_list(s)
    if toks == ["NONE"] or not toks:
        return {}
    out: dict = {}
    i = 0
    while i < len(toks):
        name = toks[i]
        kind = toks[i + 1].upper()
        vals = [float(t) for t in toks[i + 2:i + 7]]
        out[name] = (kind, vals[0], vals[1], tuple(vals[2:5]))
        i += 7
    return out


def _parse_marker_supersonic_inlet(s: str) -> dict[str, tuple[float, float, tuple[float, ...]]]:
    """MARKER_SUPERSONIC_INLET = (name, T, P, vx, vy, vz, ...)."""
    toks = _split_list(s)
    if toks == ["NONE"] or not toks:
        return {}
    out: dict[str, tuple[float, float, tuple[float, ...]]] = {}
    i = 0
    while i < len(toks):
        name = toks[i]
        vals = [float(t) for t in toks[i + 1:i + 6]]
        out[name] = (vals[0], vals[1], tuple(vals[2:5]))
        i += 6
    return out


@dataclass
class _Opt:
    parse: Callable[[str], Any]
    default: Any


def _d(x: float) -> _Opt:
    return _Opt(float, x)


def _i(x: int) -> _Opt:
    return _Opt(lambda s: int(float(s)), x)


def _b(x: bool) -> _Opt:
    return _Opt(_parse_bool, x)


def _s(x: str) -> _Opt:
    return _Opt(lambda v: v.strip(), x)


def _enum(x: str) -> _Opt:
    return _Opt(lambda v: v.strip().upper(), x)


# --------------------------------------------------------------------------
# Option registry — defaults follow the reference CConfig
# (Common/src/config_structure.cpp) unless noted.
# --------------------------------------------------------------------------

_REGISTRY: dict[str, _Opt] = {
    # --- fork-specific: chemistry library (config_structure.cpp:545-609) ---
    "CONFIG_LIB_FILE": _s(""),
    "LIBRARY_PATH": _s(""),
    "FREESTREAM_MASS_FRAC": _Opt(_parse_double_list, []),
    "SPECIES_ORDER": _Opt(_parse_string_list, []),
    "INLET_MASS_FRAC": _Opt(_parse_inlet_mass_frac, {}),
    "IGNITION": _b(False),
    "IGNITION_TEMPERATURE": _d(1700.0),
    "IGNITION_ITER": _i(0),
    "FUEL_INDEX": _i(0),
    "OXIDIZER_INDEX": _i(0),
    "C_MU": _d(0.09),
    "LEWIS_TURB": _d(1.2),
    "PASR_LB": _d(1.0),
    # --- fuel regression BC (config_structure.cpp:569-588, :921-923) ---
    "FUEL_DENSITY": _d(960.0),
    "FUEL_SPECIFIC_HEAT": _d(2860.0),
    "FUEL_ENTHALPY": _d(1100000.0),
    "FUEL_CONDUCTIVITY": _d(0.217),
    "FUEL_TEMPERATURE": _d(300.0),
    "FUEL_DATA_FILE": _s(""),
    "MARKER_ENGINE_INFLOW": _Opt(_parse_marker_pairs, {}),
    # standard-solver nacelle BCs (BC_Engine_Inflow/_Exhaust,
    # solver_direct_mean.cpp:12726/:12944; options :921-970)
    "MARKER_ENGINE_EXHAUST": _Opt(_parse_marker_exhaust, {}),
    "ENGINE_INFLOW_TYPE": _enum("FAN_FACE_MACH"),
    "DAMP_ENGINE_INFLOW": _d(0.95),
    "DAMP_ENGINE_EXHAUST": _d(0.95),
    "INFLOW_MASS_FRAC": _Opt(_parse_inlet_mass_frac, {}),
    "INFLOW_VELOCITY_DIR": _Opt(_parse_double_list, [1.0, 0.0, 0.0]),
    "TEMPERATURE_MIN": _d(200.0),
    "TEMPERATURE_MAX": _d(6000.0),
    "CLIPPING_TEMPRATURE": _b(False),  # reference's spelling
    # --- debug print flags (config_structure.cpp:713-723) ---
    "DEBUG_PRIM_VAR": _b(False),
    "DEBUG_TURB_VAR": _b(False),
    "DEBUG_TIME": _b(False),
    "DEBUG_VISCOUS_FLOW": _b(False),
    "DEBUG_VISCOUS_BOUND": _b(False),
    "DEBUG_SOURCE": _b(False),
    # --- problem definition ---
    "PHYSICAL_PROBLEM": _enum("EULER"),
    "KIND_TURB_MODEL": _enum("NONE"),
    "KIND_TRANS_MODEL": _enum("NONE"),
    "MATH_PROBLEM": _enum("DIRECT"),
    "RESTART_SOL": _b(False),
    "SYSTEM_MEASUREMENTS": _enum("SI"),
    "REGIME_TYPE": _enum("COMPRESSIBLE"),
    # AXISYMMETRIC / GRAVITY_FORCE point sources
    # (config_structure.cpp:631-632, :663; CSourceAxisymmetric_Flow +
    # CSourceGravity in solvers/euler.py)
    "AXISYMMETRIC": _b(False),
    "GRAVITY_FORCE": _b(False),
    # --- freestream ---
    "MACH_NUMBER": _d(0.0),
    "AOA": _d(0.0),
    "SIDESLIP_ANGLE": _d(0.0),
    "FREESTREAM_TEMPERATURE": _d(288.15),
    "FREESTREAM_PRESSURE": _d(101325.0),
    "FREESTREAM_DENSITY": _d(-1.0),
    "ARTCOMP_FACTOR": _d(1.0),
    "VISCOSITY_CONSTANT": _d(0.0),
    "FREESTREAM_VELOCITY": _Opt(_parse_double_list, [1.0, 0.0, 0.0]),
    "FREESTREAM_VISCOSITY": _d(-1.0),
    "FREESTREAM_TURBULENCEINTENSITY": _d(0.05),
    "FREESTREAM_TURB2LAMVISCRATIO": _d(10.0),
    "FREESTREAM_NU_FACTOR": _d(3.0),
    "REYNOLDS_NUMBER": _d(0.0),
    "REYNOLDS_LENGTH": _d(1.0),
    "GAS_CONSTANT": _d(287.058),
    "GAMMA_VALUE": _d(1.4),
    "PRANDTL_LAM": _d(0.72),
    "PRANDTL_TURB": _d(0.90),
    "REF_DIMENSIONALIZATION": _enum("DIMENSIONAL"),
    "FREESTREAM_OPTION": _enum("TEMPERATURE_FS"),
    "INIT_OPTION": _enum("REYNOLDS"),
    # --- reference values ---
    "REF_ORIGIN_MOMENT_X": _d(0.25),
    "REF_ORIGIN_MOMENT_Y": _d(0.0),
    "REF_ORIGIN_MOMENT_Z": _d(0.0),
    "REF_LENGTH": _d(1.0),
    "REF_AREA": _d(1.0),
    "REF_ELEM_LENGTH": _d(0.1),
    # --- boundary markers ---
    "MARKER_EULER": _Opt(_parse_marker_names, []),
    "MARKER_FAR": _Opt(_parse_marker_names, []),
    "MARKER_SYM": _Opt(_parse_marker_names, []),
    "MARKER_ISOTHERMAL": _Opt(_parse_marker_pairs, {}),
    "MARKER_HEATFLUX": _Opt(_parse_marker_pairs, {}),
    "MARKER_INLET": _Opt(_parse_marker_inlet, {}),
    "MARKER_OUTLET": _Opt(_parse_marker_pairs, {}),
    "MARKER_SUPERSONIC_INLET": _Opt(_parse_marker_supersonic_inlet, {}),
    "MARKER_SUPERSONIC_OUTLET": _Opt(_parse_marker_names, []),
    "MARKER_RIEMANN": _Opt(_parse_marker_riemann, {}),
    "MARKER_PERIODIC": _Opt(_parse_marker_periodic, {}),
    "MARKER_PLOTTING": _Opt(_parse_marker_names, []),
    "MARKER_MONITORING": _Opt(_parse_marker_names, []),
    "INLET_TYPE": _enum("TOTAL_CONDITIONS"),
    # --- numerics ---
    "NUM_METHOD_GRAD": _enum("GREEN_GAUSS"),
    "CFL_NUMBER": _d(1.25),
    "CFL_ADAPT": _b(False),
    "CFL_ADAPT_PARAM": _Opt(_parse_double_list, [1.5, 0.5, 1.25, 50.0]),
    "MAX_DELTA_TIME": _d(1e6),
    "UNST_CFL_NUMBER": _d(0.0),
    "EXT_ITER": _i(999999),
    "RELAXATION_FACTOR_FLOW": _d(1.0),
    "RELAXATION_FACTOR_TURB": _d(1.0),
    # --- linear solver ---
    "LINEAR_SOLVER": _enum("FGMRES"),
    "LINEAR_SOLVER_PREC": _enum("LU_SGS"),
    "LINEAR_SOLVER_ERROR": _d(1e-6),
    "LINEAR_SOLVER_ITER": _i(10),
    # --- multigrid (parsed; MG cycles beyond level 0 are not used by the
    #     shipped cases: both cfgs set MGLEVEL= 0) ---
    "MGLEVEL": _i(0),
    "MGCYCLE": _enum("V_CYCLE"),
    "MG_PRE_SMOOTH": _Opt(_parse_double_list, [1, 2, 3, 3]),
    "MG_POST_SMOOTH": _Opt(_parse_double_list, [0, 0, 0, 0]),
    "MG_CORRECTION_SMOOTH": _Opt(_parse_double_list, [0, 0, 0, 0]),
    "MG_DAMP_RESTRICTION": _d(0.75),
    "MG_DAMP_PROLONGATION": _d(0.75),
    # --- flow numerics ---
    "CONV_NUM_METHOD_FLOW": _enum("ROE"),
    "SPATIAL_ORDER_FLOW": _enum("2ND_ORDER"),
    "SLOPE_LIMITER_FLOW": _enum("VENKATAKRISHNAN"),
    "LIMITER_COEFF": _d(0.5),
    "LIMITER_ITER": _i(999999),
    "AD_COEFF_FLOW": _Opt(_parse_double_list, [0.15, 0.5, 0.02]),
    # --- fluid models (fluid_model_*.cpp) ---
    "FLUID_MODEL": _enum("IDEAL_GAS"),
    "CRITICAL_TEMPERATURE": _d(131.0),
    "CRITICAL_PRESSURE": _d(3588550.0),
    "CRITICAL_DENSITY": _d(263.0),
    "ACENTRIC_FACTOR": _d(0.035),
    # --- transport models for the standard solvers (transport_model.cpp) ---
    "VISCOSITY_MODEL": _enum("SUTHERLAND"),
    "MU_CONSTANT": _d(1.716e-5),
    "MU_REF": _d(1.716e-5),
    "MU_T_REF": _d(273.15),
    "SUTHERLAND_CONSTANT": _d(110.4),
    "CONDUCTIVITY_MODEL": _enum("CONSTANT_PRANDTL"),
    "KT_CONSTANT": _d(0.0257),
    "TIME_DISCRE_FLOW": _enum("RUNGE-KUTTA_EXPLICIT"),
    "RK_ALPHA_COEFF": _Opt(_parse_double_list, [0.66667, 0.66667, 1.0]),
    "ENTROPY_FIX_COEFF": _d(0.001),
    # --- turbulence numerics ---
    "CONV_NUM_METHOD_TURB": _enum("SCALAR_UPWIND"),
    "SPATIAL_ORDER_TURB": _enum("1ST_ORDER"),
    "SLOPE_LIMITER_TURB": _enum("VENKATAKRISHNAN"),
    "TIME_DISCRE_TURB": _enum("EULER_IMPLICIT"),
    "CFL_REDUCTION_TURB": _d(1.0),
    # --- unsteady ---
    "UNSTEADY_SIMULATION": _enum("NO"),
    "UNST_TIMESTEP": _d(0.0),
    "UNST_TIME": _d(1.0),
    "UNST_INT_ITER": _i(100),
    "UNST_RESTART_ITER": _i(0),
    # --- convergence ---
    "CONV_CRITERIA": _enum("RESIDUAL"),
    "RESIDUAL_REDUCTION": _d(3.0),
    "RESIDUAL_MINVAL": _d(-8.0),
    "RESIDUAL_FUNC_FLOW": _enum("RHO"),
    "STARTCONV_ITER": _i(5),
    "CAUCHY_ELEMS": _i(100),
    "CAUCHY_EPS": _d(1e-10),
    "CAUCHY_FUNC_FLOW": _enum("DRAG"),
    # --- design variables / deformation (SU2_DEF, SU2_DOT) ---
    "DV_KIND": _Opt(_parse_string_list, ["HICKS_HENNE"]),
    "DV_MARKER": _Opt(_parse_marker_names, []),
    "DV_PARAM": _Opt(_parse_dv_param, [[1.0, 0.5]]),
    "DV_VALUE": _Opt(_parse_double_list, [0.0]),
    "FFD_DEFINITION": _Opt(_parse_ffd_definition, []),
    "FFD_DEGREE": _Opt(_parse_ffd_degree, []),
    "FFD_SCALE": _d(1.0),
    "FFD_ITERATIONS": _i(500),
    "FFD_TOLERANCE": _d(1e-10),
    "DEFORM_LINEAR_ITER": _i(500),
    "KIND_ADAPT": _enum("FULL"),
    "NEW_ELEMS": _d(15.0),     # % of elements to adapt (GRAD_FLOW)
    "DEFORM_STIFFNESS_TYPE": _enum("INVERSE_VOLUME"),
    "DEFORM_METHOD": _enum("ELASTICITY"),  # ELASTICITY | SPRING (ours)
    "DEFORM_NONLINEAR_ITER": _i(1),
    "OBJECTIVE_FUNCTION": _enum("DRAG"),
    # --- I/O ---
    "MESH_FILENAME": _s("mesh.su2"),
    "MESH_FORMAT": _enum("SU2"),
    "MESH_OUT_FILENAME": _s("mesh_out.su2"),
    "SOLUTION_FLOW_FILENAME": _s("solution_flow.dat"),
    "SOLUTION_ADJ_FILENAME": _s("solution_adj.dat"),
    "OUTPUT_FORMAT": _enum("TECPLOT"),
    "CONV_FILENAME": _s("history"),
    "RESTART_FLOW_FILENAME": _s("restart_flow.dat"),
    "RESTART_ADJ_FILENAME": _s("restart_adj.dat"),
    "VOLUME_FLOW_FILENAME": _s("flow"),
    "VOLUME_ADJ_FILENAME": _s("adjoint"),
    "GRAD_OBJFUNC_FILENAME": _s("of_grad.dat"),
    "SURFACE_FLOW_FILENAME": _s("surface_flow"),
    "BREAKDOWN_FILENAME": _s("forces_breakdown.dat"),
    "SURFACE_ADJ_FILENAME": _s("surface_adjoint"),
    "WRT_SOL_FREQ": _i(1000),
    "WRT_SOL_FREQ_DUALTIME": _i(1),
    "WRT_CON_FREQ": _i(1),
    "WRT_CON_FREQ_DUALTIME": _i(10),
    "LOW_MEMORY_OUTPUT": _b(False),
    "WRT_BINARY_RESTART": _b(False),
    "READ_BINARY_RESTART": _b(False),
    "GRID_MOVEMENT": _b(False),
    # --- wind gust, Field Velocity Method (config_structure.cpp:1495-1509)
    "WIND_GUST": _b(False),
    "GUST_TYPE": _enum("NONE"),
    "GUST_WAVELENGTH": _d(0.0),
    "GUST_PERIODS": _d(1.0),
    "GUST_AMPL": _d(0.0),
    "GUST_BEGIN_TIME": _d(0.0),
    "GUST_BEGIN_LOC": _d(0.0),
    "GUST_DIR": _enum("Y_DIR"),
    # --- aeroelastic typical-section model (config_structure.cpp:1466-82) ---
    "FLUTTER_SPEED_INDEX": _d(0.6),
    "PLUNGE_NATURAL_FREQUENCY": _d(100.0),
    "PITCH_NATURAL_FREQUENCY": _d(100.0),
    "AIRFOIL_MASS_RATIO": _d(60.0),
    "CG_LOCATION": _d(1.8),
    "RADIUS_GYRATION_SQUARED": _d(3.48),
    "AEROELASTIC_ITER": _i(3),
    # --- rigid mesh motion / rotating frame (su2_tpu/motion.py) ---
    "GRID_MOVEMENT_KIND": _enum("NO_MOVEMENT"),
    "MACH_MOTION": _d(0.0),
    "MOTION_ORIGIN_X": _d(0.0),
    "MOTION_ORIGIN_Y": _d(0.0),
    "MOTION_ORIGIN_Z": _d(0.0),
    "ROTATION_RATE_X": _d(0.0),
    "ROTATION_RATE_Y": _d(0.0),
    "ROTATION_RATE_Z": _d(0.0),
    "PITCHING_OMEGA_X": _d(0.0),
    "PITCHING_OMEGA_Y": _d(0.0),
    "PITCHING_OMEGA_Z": _d(0.0),
    "PITCHING_AMPL_X": _d(0.0),
    "PITCHING_AMPL_Y": _d(0.0),
    "PITCHING_AMPL_Z": _d(0.0),
    "PITCHING_PHASE_X": _d(0.0),
    "PITCHING_PHASE_Y": _d(0.0),
    "PITCHING_PHASE_Z": _d(0.0),
    "TRANSLATION_RATE_X": _d(0.0),
    "TRANSLATION_RATE_Y": _d(0.0),
    "TRANSLATION_RATE_Z": _d(0.0),
}


# Post-v5 SU2 option renames users commonly carry over from modern SU2
# configs; v5.0.0 (the reference fork's base) uses the right-hand names.
# These raise a "did you mean" error instead of a silent default
# (round-2 postmortem: VENKAT_LIMITER_COEFF silently fell back to K=0.5).
_POST_V5_ALIASES = {
    "VENKAT_LIMITER_COEFF": "LIMITER_COEFF",
    "SOLVER": "PHYSICAL_PROBLEM",
    "ITER": "EXT_ITER",
    "INNER_ITER": "EXT_ITER",
    "TIME_ITER": "UNST_INT_ITER",
    "MUSCL_FLOW": "SPATIAL_ORDER_FLOW (e.g. 2ND_ORDER_LIMITER)",
    "MUSCL_TURB": "SPATIAL_ORDER_TURB",
    "CONV_RESIDUAL_MINVAL": "RESIDUAL_MINVAL",
    "CONV_STARTITER": "STARTCONV_ITER",
    "TIME_DOMAIN": "UNSTEADY_SIMULATION",
    "TIME_STEP": "UNST_TIMESTEP",
    "MAX_TIME": "UNST_TIME",
}


class Config:
    """Parsed configuration (CConfig-equivalent).

    Attributes are lower-cased option names, e.g. ``cfg.mach_number``,
    ``cfg.marker_inlet``. Unknown options are collected in ``cfg.extra``
    (parsed as raw strings) and warned about, mirroring CConfig behavior.
    """

    def __init__(self, path: str | None = None, text: str | None = None,
                 overrides: dict[str, str] | None = None):
        self.cfg_path = path
        self.base_dir = os.path.dirname(os.path.abspath(path)) if path else os.getcwd()
        self.extra: dict[str, str] = {}
        self._set_options: set[str] = set()
        for name, opt in _REGISTRY.items():
            setattr(self, name.lower(), opt.default)
        if path is not None:
            with open(path) as f:
                text = f.read()
        if text is not None:
            self._parse(text)
        if overrides:
            for k, v in overrides.items():
                self.set_option(k, v)
        self._postprocess()

    # -- parsing ----------------------------------------------------------
    def _parse(self, text: str) -> None:
        # Options can span physical lines only within parentheses; the
        # reference reads one option per line, so we do too.
        for raw in text.splitlines():
            line = raw.split("%", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = line.split("=", 1)
            self.set_option(key.strip(), val.strip())

    def set_option(self, key: str, val: str) -> None:
        key = key.strip().upper()
        opt = _REGISTRY.get(key)
        if opt is None:
            # registry hardening (full SU2 v5 option surface, see
            # config_options.py): feature-bearing reference options we do
            # not implement FAIL LOUDLY when enabled instead of being
            # silently ignored; output/design-tooling options and unknown
            # keys warn
            from su2_tpu_torch import config_options as co

            self.extra[key] = val
            alias = _POST_V5_ALIASES.get(key)
            if alias is not None:
                raise ValueError(
                    f"config option '{key}' is a post-v5 SU2 name; this "
                    f"framework matches the v5.0.0 option surface — did you "
                    f"mean '{alias}'?")
            kind = co.classify(key)
            if kind == "unsupported" and not co.value_is_disabled(val):
                raise ValueError(
                    f"SU2 option '{key}= {val}' is recognized (reference "
                    "option registry, config_structure.cpp) but the "
                    "feature is not supported by su2_tpu")
            import warnings
            if kind == "unknown":
                import difflib
                close = difflib.get_close_matches(key, _REGISTRY, 1, 0.75)
                hint = f" (did you mean '{close[0]}'?)" if close else ""
                warnings.warn(f"unknown config option '{key}'{hint}")
            else:
                warnings.warn(f"ignoring config option '{key}'")
            return
        self._set_options.add(key)
        setattr(self, key.lower(), opt.parse(val))

    # -- derived/validated quantities (CConfig::SetPostprocessing) ---------
    def _postprocess(self) -> None:
        p = self.physical_problem
        # Solver-kind promotion: REACTIVE_NAVIER_STOKES + turb model
        # -> REACTIVE_RANS (reference: config_structure.cpp:2872-2874).
        if p == "REACTIVE_NAVIER_STOKES" and self.kind_turb_model != "NONE":
            self.solver_kind = "REACTIVE_RANS"
        elif p == "NAVIER_STOKES" and self.kind_turb_model != "NONE":
            self.solver_kind = "RANS"
        else:
            self.solver_kind = p
        self.nspecies = len(self.species_order)
        self.viscous = self.solver_kind in (
            "NAVIER_STOKES", "RANS", "REACTIVE_NAVIER_STOKES", "REACTIVE_RANS")
        self.reactive = self.solver_kind in (
            "REACTIVE_EULER", "REACTIVE_NAVIER_STOKES", "REACTIVE_RANS")
        self.turbulent = self.solver_kind in ("RANS", "REACTIVE_RANS")
        self.implicit_flow = self.time_discre_flow == "EULER_IMPLICIT"
        self.implicit_turb = self.time_discre_turb == "EULER_IMPLICIT"
        self.muscl_flow = self.spatial_order_flow in ("2ND_ORDER", "2ND_ORDER_LIMITER")
        self.limiter_flow = self.spatial_order_flow == "2ND_ORDER_LIMITER"
        self.us_system = self.system_measurements == "US"
        # SU2 derives the freestream velocity from MACH_NUMBER when
        # FREESTREAM_VELOCITY is not given (SetPostprocessing /
        # SetNondimensionalization: V = M a_inf (cos a cos b, sin b,
        # sin a cos b)); the shipped reactive cases always set it explicitly
        if ("FREESTREAM_VELOCITY" not in self._set_options
                and self.mach_number > 0.0 and not self.reactive):
            import math
            a_inf = math.sqrt(self.gamma_value * self.gas_constant
                              * self.freestream_temperature)
            al = math.radians(self.aoa)
            be = math.radians(self.sideslip_angle)
            v = self.mach_number * a_inf
            self.freestream_velocity = [v * math.cos(al) * math.cos(be),
                                        v * math.sin(be),
                                        v * math.sin(al) * math.cos(be)]
        self.was_set = lambda name: name.upper() in self._set_options
        self.steady = self.unsteady_simulation in ("NO", "STEADY")

    # -- path helpers -------------------------------------------------------
    def resolve(self, filename: str) -> str:
        """Resolve a relative filename (mesh, chemistry manifest, restart...).

        The reference resolves against the working directory; for convenience
        we fall back to the cfg file's directory when the file only exists
        there (lets the shipped read-only Test_Cases run from anywhere).
        """
        if os.path.isabs(filename):
            return filename
        cwd_path = os.path.join(os.getcwd(), filename)
        if os.path.exists(cwd_path):
            return cwd_path
        cfg_path = os.path.join(self.base_dir, filename)
        if os.path.exists(cfg_path):
            return cfg_path
        return cwd_path

    def __repr__(self) -> str:  # pragma: no cover
        return f"Config({self.cfg_path!r}, solver_kind={self.solver_kind})"
