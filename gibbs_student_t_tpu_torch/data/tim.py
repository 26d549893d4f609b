"""TOA (.tim) reader/writer for tempo2 ``FORMAT 1`` files.

The grammar covered is what the reference data and libstempo's writer emit
(reference J1713+0747.tim:1-132): a ``FORMAT 1`` header, then one TOA per
line — ``name freq(MHz) MJD error(us) site [-flag value ...]`` — with
``C``/``#``-prefixed lines treated as commented-out (deleted) TOAs, matching
how tempo2 persists ``psr.deleted`` (reference simulate_data.py:36).

MJDs are parsed as ``np.longdouble``: 1 ns of timing precision at MJD 54000
requires ~1e-14 days, beyond float64's ~1e-11-day resolution there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class TimFile:
    """Columnar TOA table. ``mjds`` are longdouble days; errors are in us."""

    names: List[str]
    freqs: np.ndarray          # float64, MHz
    mjds: np.ndarray           # longdouble, days
    errors: np.ndarray         # float64, microseconds
    sites: List[str]
    flags: Dict[str, np.ndarray]   # flag name -> per-TOA string array ('' if absent)
    deleted: np.ndarray        # bool, True for commented-out TOAs

    @property
    def n(self) -> int:
        return len(self.mjds)


def read_tim(path: str, include_deleted: bool = False) -> TimFile:
    """Parse a tim file with the Python tokenizer (MJDs kept as long
    double)."""
    return _read_tim_python(path, include_deleted)


def _read_tim_python(path: str, include_deleted: bool = False) -> TimFile:
    names, freqs, mjds, errors, sites, deleted = [], [], [], [], [], []
    flag_rows: List[Dict[str, str]] = []
    with open(path) as fh:
        for raw in fh:
            line = raw.rstrip("\n")
            stripped = line.strip()
            if not stripped:
                continue
            upper = stripped.upper()
            if upper.startswith("FORMAT") or upper.startswith("MODE"):
                continue
            if upper.startswith("INCLUDE"):
                raise NotImplementedError("INCLUDE directives are not supported")
            is_deleted = False
            if stripped.startswith("C ") or stripped.startswith("#"):
                is_deleted = True
                stripped = stripped.lstrip("C#").strip()
                if not stripped:
                    continue
            tokens = stripped.split()
            if len(tokens) < 5:
                continue
            try:
                freq = float(tokens[1])
                mjd = np.longdouble(tokens[2])
                err = float(tokens[3])
            except ValueError:
                continue  # stray comment line
            if is_deleted and not include_deleted:
                continue
            names.append(tokens[0])
            freqs.append(freq)
            mjds.append(mjd)
            errors.append(err)
            sites.append(tokens[4])
            deleted.append(is_deleted)
            row: Dict[str, str] = {}
            ii = 5
            while ii < len(tokens):
                if tokens[ii].startswith("-") and ii + 1 < len(tokens):
                    row[tokens[ii].lstrip("-")] = tokens[ii + 1]
                    ii += 2
                else:
                    ii += 1
            flag_rows.append(row)

    flag_names = sorted({k for row in flag_rows for k in row})
    flags = {
        k: np.array([row.get(k, "") for row in flag_rows], dtype=object)
        for k in flag_names
    }
    return TimFile(
        names=names,
        freqs=np.asarray(freqs, dtype=np.float64),
        mjds=np.asarray(mjds, dtype=np.longdouble),
        errors=np.asarray(errors, dtype=np.float64),
        sites=sites,
        flags=flags,
        deleted=np.asarray(deleted, dtype=bool),
    )


def write_tim(tim: TimFile, path: str) -> None:
    lines = ["FORMAT 1"]
    for ii in range(tim.n):
        mjd_str = np.format_float_positional(
            tim.mjds[ii], precision=None, unique=True, trim="-"
        )
        body = (
            f"{tim.names[ii]} {tim.freqs[ii]:.8f} {mjd_str} "
            f"{tim.errors[ii]:.8f} {tim.sites[ii]}"
        )
        for name, values in tim.flags.items():
            if values[ii] != "":
                body += f" -{name} {values[ii]}"
        if tim.deleted[ii]:
            body = "C " + body
        lines.append(body)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
