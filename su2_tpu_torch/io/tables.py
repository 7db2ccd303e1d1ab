"""Chemistry/thermo/transport file readers.

Parses the reference's second configuration layer (the chemistry manifest
named by ``CONFIG_LIB_FILE`` plus mixture / chemistry / per-species transport
and thermo tables) with the exact file grammar of
ReactingModelLibrary::Setup and its readers
(reference: Common/src/Framework/reacting_model_library.cpp:925-1586) and the
reaction-string grammar of Utility::Parse_Terms
(Common/src/Tools/utility.cpp).

Everything here is host-side NumPy; :mod:`su2_tpu_torch.chemistry.library` turns the
result into static device arrays.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np

# Physical constants (physical_chemical_library.hpp:571-579)
NA = 6.02214129e23
KB = 1.3806488e-23
R_UNGAS = NA * KB * 1.0e3          # J/(kmol K)
R_UNGAS_SCAL = 1.9858775           # cal/(mol K)
R_UNGAS_ATM = 1.0e-3 * 0.082057338  # m^3 atm/(mol K)


def _data_lines(path: str) -> list[str]:
    """Lines up to STOP, skipping empties and lines starting with punctuation
    (comment style used by the reference readers)."""
    out = []
    with open(path) as f:
        for raw in f.read().splitlines():
            line = raw.rstrip()
            if line == "STOP":
                break
            if not line.strip():
                continue
            # reference skips lines whose first char is punctuation
            # (std::ispunct) — data rows start with spaces and pass
            c = line[0]
            if not c.isalnum() and not c.isspace():
                continue
            out.append(line)
    return out


@dataclass
class MixtureData:
    species: list[str]
    molar_masses: np.ndarray          # (Ns,) g/mol (kept in g/mol like the ref)
    formation_enthalpies: np.ndarray  # (Ns,) kJ (as shipped)
    diff_volumes: np.ndarray          # (Ns,)

    @property
    def nspecies(self) -> int:
        return len(self.species)


def read_mixture(path: str) -> MixtureData:
    lines = _data_lines(path)
    ns = int(lines[0].split()[0])
    species, mm, fe, dv = [], [], [], []
    for ln in lines[1:1 + ns]:
        toks = ln.split()
        species.append(toks[0])
        mm.append(float(toks[1]))
        fe.append(float(toks[2]))
        dv.append(float(toks[3]))
    assert len(species) == ns
    return MixtureData(species, np.array(mm), np.array(fe), np.array(dv))


@dataclass
class ChemistryData:
    nreactions: int
    cgs_units: bool
    stoich_r: np.ndarray       # (Ns, Nr) reactant stoichiometric coefficients
    stoich_p: np.ndarray       # (Ns, Nr) product stoichiometric coefficients
    exp_f: np.ndarray          # (Nr, Ns) forward concentration exponents
    exp_b: np.ndarray          # (Nr, Ns) backward concentration exponents
    reversible: np.ndarray     # (Nr,) bool
    arr_a: np.ndarray          # (Nr,) pre-exponential (SI after conversion)
    arr_beta: np.ndarray       # (Nr,)
    arr_ta: np.ndarray         # (Nr,) activation temperature [K]
    has_backward: np.ndarray   # (Nr,) bool: explicit backward Arrhenius data
    arr_a_b: np.ndarray        # (Nr,)
    arr_beta_b: np.ndarray     # (Nr,)
    arr_ta_b: np.ndarray       # (Nr,)


_TERM_RE = re.compile(r"^\s*([0-9][0-9.]*)?\s*([A-Za-z][A-Za-z0-9]*)(?:_(-?[0-9.]+))?\s*$")


def _parse_side(side: str, ireac: int, is_reac: bool, is_rev: bool,
                species_idx: dict[str, int],
                stoich: np.ndarray, exp_f: np.ndarray, exp_b: np.ndarray) -> None:
    """One side of a reaction string (Utility::Parse_Terms semantics)."""
    for term in side.split("+"):
        term = term.strip()
        if not term:
            continue
        m = _TERM_RE.match(term)
        if m is None:
            raise ValueError(f"cannot parse reaction term {term!r}")
        coeff = float(m.group(1)) if m.group(1) else 1.0
        symbol = m.group(2)
        if symbol not in species_idx:
            raise ValueError(f"species {symbol!r} not in the mixture list")
        s = species_idx[symbol]
        stoich[s, ireac] += coeff
        if m.group(3) is not None:
            expc = float(m.group(3))
            if is_reac:
                exp_f[ireac, s] += expc
            elif is_rev:
                exp_b[ireac, s] += expc
        elif is_reac:
            exp_f[ireac, s] += stoich[s, ireac]


def read_chemistry(path: str, species: list[str]) -> ChemistryData:
    lines = _data_lines(path)
    species_idx = {sp: i for i, sp in enumerate(species)}
    ns = len(species)

    nr = int(lines[0].split()[0])
    units = lines[1].split()[0].upper()
    if units not in ("CGS", "SI"):
        raise ValueError(f"unknown unit system {units!r}")
    cgs = units == "CGS"

    stoich_r = np.zeros((ns, nr))
    stoich_p = np.zeros((ns, nr))
    exp_f = np.zeros((nr, ns))
    exp_b = np.zeros((nr, ns))
    reversible = np.zeros(nr, dtype=bool)
    arr_a = np.zeros(nr)
    arr_beta = np.zeros(nr)
    arr_ta = np.zeros(nr)
    has_backward = np.zeros(nr, dtype=bool)
    arr_a_b = np.zeros(nr)
    arr_beta_b = np.zeros(nr)
    arr_ta_b = np.zeros(nr)

    ireac = -1
    for ln in lines[2:]:
        if "Available Backward Rate reaction" in ln:
            rest = ln.split("Available Backward Rate reaction", 1)[1]
            rest = rest.replace(":", " ")
            toks = rest.split()
            r = int(toks[0]) - 1
            if not reversible[r]:
                raise ValueError("backward rate given for an irreversible reaction")
            has_backward[r] = True
            arr_a_b[r] = float(toks[1])
            arr_beta_b[r] = float(toks[2])
            ta = float(toks[3])
            arr_ta_b[r] = ta / R_UNGAS_SCAL if cgs else ta
            continue
        if "Extra Forward terms reaction" in ln or "Extra Backward terms reaction" in ln:
            which = exp_f if "Forward" in ln else exp_b
            tag = ("Extra Forward terms reaction" if "Forward" in ln
                   else "Extra Backward terms reaction")
            rest = ln.split(tag, 1)[1].replace(":", " ")
            toks = rest.split()
            r = int(toks[0]) - 1
            for term in toks[1:]:
                sym, expc = term.split("_")
                which[r, species_idx[sym]] = float(expc)
            continue
        if ">" in ln:
            # reaction line
            ireac += 1
            is_rev = "<" in ln
            reversible[ireac] = is_rev
            if is_rev:
                lhs, rhs = ln.split("<=>")
            else:
                lhs, rhs = ln.split("=>")
            _parse_side(lhs, ireac, True, is_rev, species_idx, stoich_r, exp_f, exp_b)
            _parse_side(rhs, ireac, False, is_rev, species_idx, stoich_p, exp_f, exp_b)
        else:
            # Arrhenius coefficient line for the reaction just read
            toks = ln.split()
            arr_a[ireac] = float(toks[0])
            arr_beta[ireac] = float(toks[1])
            ta = float(toks[2])
            arr_ta[ireac] = ta / R_UNGAS_SCAL if cgs else ta

    if ireac + 1 != nr:
        raise ValueError(f"read {ireac + 1} reactions, expected {nr}")

    # auto product exponents for reversible reactions without explicit
    # backward data (reacting_model_library.cpp:1113-1119)
    for r in range(nr):
        if reversible[r] and not has_backward[r]:
            exp_b[r] = exp_f[r] + stoich_p[:, r] - stoich_r[:, r]

    # CGS -> SI conversion of the pre-exponential factors
    # (reacting_model_library.cpp:1123-1133)
    if cgs:
        for r in range(nr):
            arr_a[r] *= 10.0 ** (6.0 * (1.0 - exp_f[r].sum()))
            if has_backward[r]:
                arr_a_b[r] *= 10.0 ** (6.0 * (1.0 - exp_b[r].sum()))

    return ChemistryData(nr, cgs, stoich_r, stoich_p, exp_f, exp_b, reversible,
                         arr_a, arr_beta, arr_ta, has_backward,
                         arr_a_b, arr_beta_b, arr_ta_b)


@dataclass
class SpeciesTable:
    name: str
    temps: np.ndarray
    cols: dict[str, np.ndarray] = field(default_factory=dict)


def read_transport(path: str) -> SpeciesTable:
    lines = _data_lines(path)
    name = lines[0].strip()
    data = np.array([[float(t) for t in ln.split()] for ln in lines[1:]])
    return SpeciesTable(name, data[:, 0], {"mu": data[:, 1], "kappa": data[:, 2]})


def read_thermo(path: str) -> SpeciesTable:
    lines = _data_lines(path)
    name = lines[0].strip()
    data = np.array([[float(t) for t in ln.split()] for ln in lines[1:]])
    return SpeciesTable(name, data[:, 0],
                        {"cp": data[:, 1], "h": data[:, 2], "s": data[:, 3]})


@dataclass
class LibraryFiles:
    mixture: MixtureData
    chemistry: ChemistryData | None
    transport: list[SpeciesTable]
    thermo: list[SpeciesTable]


def read_manifest(manifest_path: str, lib_path: str | None = None) -> LibraryFiles:
    """CONFIG_LIB_FILE manifest: mixture, optional chemistry, then per-species
    (transport, thermo) file pairs (ReactingModelLibrary::Setup,
    reacting_model_library.cpp:1520-1586)."""
    base = lib_path or os.path.dirname(os.path.abspath(manifest_path))
    with open(manifest_path) as f:
        names = [ln.strip() for ln in f.read().splitlines()
                 if ln.strip() and ln.strip()[0].isalnum()]
    mixture = read_mixture(os.path.join(base, names[0]))
    ns = mixture.nspecies
    nfile = len(names)
    if nfile == 2 * ns + 2:
        chemistry = read_chemistry(os.path.join(base, names[1]), mixture.species)
        rest = names[2:]
    elif nfile == 2 * ns + 1:
        chemistry = None
        rest = names[1:]
    else:
        raise ValueError(f"manifest lists {nfile} files, expected {2*ns+1} or {2*ns+2}")
    transport, thermo = [], []
    for i in range(ns):
        transport.append(read_transport(os.path.join(base, rest[2 * i])))
        thermo.append(read_thermo(os.path.join(base, rest[2 * i + 1])))
        # The reference assigns table files to species BY POSITION in the
        # manifest without checking names ("I can't check the content",
        # reacting_model_library.cpp:1573-1580) — and the shipped combustion
        # manifest actually swaps H and H2.  We follow the positional
        # assignment for reference parity but warn on the mismatch.
        for tab, kind in ((transport[-1], "transport"), (thermo[-1], "thermo")):
            if tab.name != mixture.species[i]:
                import warnings
                warnings.warn(
                    f"{kind} table {tab.name!r} assigned to species "
                    f"{mixture.species[i]!r} (positional manifest order, "
                    f"matching reference behavior)")
    return LibraryFiles(mixture, chemistry, transport, thermo)


def read_fuel_data(path: str) -> dict:
    """Fuel regression-rate data file (ReadDataFuel,
    reacting_model_library.cpp:1457-1506): lines 'A1   = v', 'A2   = v',
    'EA1  = v', 'EA2  = v', 'Tbar = v'; 'STOP' terminates."""
    keys = {"A1": None, "A2": None, "EA1": None, "EA2": None, "Tbar": None}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.strip() == "STOP":
                break
            if not line.strip() or not line[0].isalnum():
                continue
            for k in keys:
                if line.startswith(f"{k} ") or line.startswith(f"{k}="):
                    keys[k] = float(line.split("=", 1)[1])
    missing = [k for k, v in keys.items() if v is None]
    if missing:
        raise ValueError(f"fuel data file {path} missing {missing}")
    return keys
