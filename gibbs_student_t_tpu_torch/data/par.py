"""Pulsar ephemeris (.par) reader/writer.

Covers the par grammar actually exercised by the reference data
(reference J1713+0747.par:1-23): ``NAME value [fitflag [error]]`` lines with
string, integer, and high-precision float values, including the DD binary
block. Values that carry phase-critical precision (F0, F1, PEPOCH, epochs)
are kept as ``np.longdouble`` — float64 MJD arithmetic loses ~1 us of timing
precision over a 5-yr span, which is the same order as the TOA errors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

# Parameters whose values are free-form strings.
_STRING_PARAMS = {
    "PSRJ", "PSRB", "PSR", "NAME", "BINARY", "CLK", "EPHEM", "UNITS",
    "TIMEEPH", "T2CMETHOD", "CORRECT_TROPOSPHERE", "PLANET_SHAPIRO",
    "DILATEFREQ", "NE_SW", "SOLARN0", "EPHVER",
}

# Sky-position parameters in sexagesimal "HH:MM:SS.s..." / "DD:MM:SS.s" form.
_ANGLE_PARAMS = {"RAJ", "DECJ"}


@dataclasses.dataclass
class ParParam:
    """One par-file line: value, optional fit flag and 1-sigma uncertainty."""

    name: str
    value: object          # str for string/angle params, np.longdouble otherwise
    fit: int = 0
    error: Optional[np.longdouble] = None

    def as_float(self) -> float:
        return float(self.value)


def parse_angle(text: str, hours: bool) -> float:
    """Sexagesimal string -> radians. ``hours=True`` for RAJ (HH:MM:SS)."""
    sign = -1.0 if text.strip().startswith("-") else 1.0
    parts = [abs(float(p)) for p in text.strip().lstrip("+-").split(":")]
    while len(parts) < 3:
        parts.append(0.0)
    deg = parts[0] + parts[1] / 60.0 + parts[2] / 3600.0
    if hours:
        deg *= 15.0
    return sign * np.deg2rad(deg)


class Par:
    """Parsed par file: ordered mapping of parameter name -> ParParam."""

    def __init__(self, params: Dict[str, ParParam]):
        self.params = params

    def __contains__(self, name: str) -> bool:
        return name in self.params

    def __getitem__(self, name: str) -> ParParam:
        return self.params[name]

    def get(self, name: str, default=None):
        p = self.params.get(name)
        return p.value if p is not None else default

    def getfloat(self, name: str, default: float = 0.0) -> np.longdouble:
        p = self.params.get(name)
        if p is None:
            return np.longdouble(default)
        return np.longdouble(p.value)

    @property
    def name(self) -> str:
        for key in ("PSRJ", "PSRB", "PSR", "NAME"):
            if key in self.params:
                return str(self.params[key].value)
        return "PSR"

    def fit_params(self):
        """Names of parameters marked for fitting (fit flag == 1)."""
        return [p.name for p in self.params.values() if p.fit == 1]


def _parse_value(name: str, token: str):
    if name in _STRING_PARAMS or name in _ANGLE_PARAMS:
        return token
    # tempo2 allows 'D' exponents in old par files
    return np.longdouble(token.replace("D", "e").replace("d", "e"))


def read_par(path: str) -> Par:
    params: Dict[str, ParParam] = {}
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#") or line.startswith("C "):
                continue
            tokens = line.split()
            name = tokens[0].upper()
            if len(tokens) == 1:
                params[name] = ParParam(name, "")
                continue
            value = _parse_value(name, tokens[1])
            fit = 0
            error = None
            # "NAME value fit error" — fit flag is a bare 0/1
            if len(tokens) >= 3 and tokens[2] in ("0", "1"):
                fit = int(tokens[2])
                if len(tokens) >= 4:
                    try:
                        error = np.longdouble(tokens[3])
                    except ValueError:
                        error = None
            params[name] = ParParam(name, value, fit, error)
    return Par(params)


def format_longdouble(x: np.longdouble) -> str:
    """Full-precision decimal rendering of a longdouble (dragon4)."""
    fx = float(x)
    if x == 0:
        return "0"
    if 1e-4 <= abs(fx) < 1e17:
        return np.format_float_positional(np.longdouble(x), unique=True, trim="-")
    return np.format_float_scientific(np.longdouble(x), unique=True, trim="-")


def write_par(par: Par, path: str) -> None:
    lines = []
    for p in par.params.values():
        value = p.value if isinstance(p.value, str) else format_longdouble(p.value)
        if p.fit:
            err = "" if p.error is None else f" {float(p.error):.10g}"
            lines.append(f"{p.name:<15}{value} 1{err}")
        elif value != "":
            lines.append(f"{p.name:<15}{value}")
        else:
            lines.append(p.name)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
