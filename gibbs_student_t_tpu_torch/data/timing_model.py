"""Linearized timing model: phase prediction, binary delays, design matrix.

Replaces the tempo2 (C++) fit machinery that the reference reaches through
``enterprise.pulsar.Pulsar``/``libstempo`` (reference run_sims.py:47,51;
simulate_data.py:12-18). Only the linearized path is needed: the sampler
never refits — it consumes the design matrix ``Mmat`` through an
SVD-orthonormalized basis (reference run_sims.py:22-25), so what must be
reproduced is the *span* of the timing columns, not tempo2's exact
derivatives (SURVEY.md §7 "hard parts").

The phase model is the isolated-pulsar Taylor expansion
``phi(t) = F0*(t - PEPOCH) + F1/2*(t - PEPOCH)^2`` evaluated in longdouble
at the binary *emission* time: for binary pulsars (the reference's
J1713+0747 is a DD binary, reference J1713+0747.par:13-19) the DD orbital
delays — elliptical Roemer, Einstein ``gamma sin E``, and the Shapiro
``-2 r ln Lambda`` term — are removed first via the inverse timing formula
(fixed-point iteration on the emission time). Astrometric fit parameters
contribute heuristic annual/semi-annual design columns but no phase-model
terms; binary fit parameters contribute *analytic derivative* columns of
the implemented delay.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from gibbs_student_t_tpu_torch.data.par import Par

SECS_PER_DAY = np.longdouble(86400.0)
DAYS_PER_YEAR = np.longdouble(365.25)
# GM_sun / c^3: the Shapiro-range unit r = T_SUN * M2 (M2 in solar masses)
T_SUN = np.longdouble(4.925490947e-6)


# Binary flavors sharing the DD delay algebra at the precision in scope
# (BT differs from DD only in terms that vanish for the pars handled here).
_DD_FAMILY = {"DD", "DDH", "DDK", "DDGR", "BT"}
# Small-eccentricity Laplace-Lagrange parameterization (Lange et al. 2001):
# TASC epoch of ascending node, EPS1 = e sin(omega), EPS2 = e cos(omega).
_ELL1_FAMILY = {"ELL1"}


def _binary_flavor(par: Par) -> str:
    return str(par.get("BINARY", "")).upper()


def has_binary(par: Par) -> bool:
    if "BINARY" not in par or "PB" not in par:
        return False
    flavor = _binary_flavor(par)
    if flavor not in _DD_FAMILY | _ELL1_FAMILY:
        # Fail loudly: evaluating the DD formulas on an unknown flavor's
        # par (different epoch parameters) would silently compute the
        # orbital phase wrong and leave an unremoved ~A1-sized sinusoid.
        raise ValueError(
            f"unsupported binary model {flavor!r}: implemented are the DD "
            f"family {sorted(_DD_FAMILY)} and {sorted(_ELL1_FAMILY)}")
    return True


def _kepler(M: np.ndarray, ecc: np.longdouble, iters: int = 5) -> np.ndarray:
    """Solve E - e sin E = M by Newton iteration (longdouble).

    Converges quadratically; at the eccentricities in scope (7.5e-5 for
    J1713, reference J1713+0747.par:18) two iterations already reach
    longdouble roundoff — five covers e up to ~0.8.
    """
    E = M + ecc * np.sin(M)
    for _ in range(iters):
        E = E - (E - ecc * np.sin(E) - M) / (1.0 - ecc * np.cos(E))
    return E


def _orbit_geometry(par: Par, t: np.ndarray):
    """Orbital quantities at times ``t`` (longdouble MJD): eccentric anomaly
    sin/cos, periastron-longitude sin/cos, and the scalar elements."""
    pb = par.getfloat("PB")
    t0 = par.getfloat("T0")
    ecc = par.getfloat("ECC")
    orbits = (t - t0) / pb
    pbdot = par.getfloat("PBDOT")
    if pbdot != 0:
        orbits = orbits - 0.5 * pbdot * orbits * orbits
    M = 2.0 * np.pi * (orbits - np.floor(orbits))
    E = _kepler(M, ecc)
    omega = np.deg2rad(par.getfloat("OM")
                       + par.getfloat("OMDOT") * (t - t0) / DAYS_PER_YEAR)
    x = par.getfloat("A1") + par.getfloat("XDOT") * (t - t0) * SECS_PER_DAY
    return {
        "sinE": np.sin(E), "cosE": np.cos(E),
        "sinw": np.sin(omega), "cosw": np.cos(omega),
        "ecc": ecc, "q": np.sqrt(1.0 - ecc * ecc), "x": x,
        "pb": pb, "t0": t0, "t": t,
        "m2": par.getfloat("M2"), "sini": par.getfloat("SINI"),
        "gamma": par.getfloat("GAMMA"),
    }


def _ell1_geometry(par: Par, t: np.ndarray):
    """ELL1 orbital quantities at times ``t``: orbital phase from the
    ascending-node epoch TASC plus the Laplace-Lagrange eccentricity
    components (Lange et al. 2001 parameterization, tempo2 ELL1model)."""
    pb = par.getfloat("PB")
    tasc = par.getfloat("TASC")
    orbits = (t - tasc) / pb
    pbdot = par.getfloat("PBDOT")
    if pbdot != 0:
        orbits = orbits - 0.5 * pbdot * orbits * orbits
    phi = 2.0 * np.pi * (orbits - np.floor(orbits))
    dt_sec = (t - tasc) * SECS_PER_DAY
    return {
        "phi": phi, "sinp": np.sin(phi), "cosp": np.cos(phi),
        "sin2p": np.sin(2.0 * phi), "cos2p": np.cos(2.0 * phi),
        # EPS1DOT/EPS2DOT carry tempo2's 1/s units
        "eta": par.getfloat("EPS1") + par.getfloat("EPS1DOT") * dt_sec,
        "kap": par.getfloat("EPS2") + par.getfloat("EPS2DOT") * dt_sec,
        "x": par.getfloat("A1")
             + par.getfloat("XDOT") * (t - tasc) * SECS_PER_DAY,
        "pb": pb, "tasc": tasc, "t": t,
        "m2": par.getfloat("M2"), "sini": par.getfloat("SINI"),
    }


def _delay_at(par: Par, t: np.ndarray) -> np.ndarray:
    """Orbital delay (seconds, longdouble) evaluated at times ``t``.

    DD family: Roemer ``x beta``, Einstein ``gamma sin E``, Shapiro
    ``-2 r ln(1 - e cos E - s beta)`` (Damour-Deruelle timing formula —
    what tempo2 applies for BINARY DD, the model the reference's dataset
    was generated with). ELL1: the first-order-in-eccentricity form
    ``x [sin phi + (kappa/2) sin 2phi - (eta/2) cos 2phi]`` with Shapiro
    ``-2 r ln(1 - s sin phi)`` (Lange et al. 2001; tempo2 ELL1model).
    """
    if _binary_flavor(par) in _ELL1_FAMILY:
        g = _ell1_geometry(par, t)
        # first order in eccentricity, including the -(3/2) x eta constant
        # of the expansion (expand the DD Roemer in e: beta = sin(phi)
        # - (3/2) eta + (kappa/2) sin(2 phi) - (eta/2) cos(2 phi))
        delay = g["x"] * (g["sinp"] + 0.5 * g["kap"] * g["sin2p"]
                          - 0.5 * g["eta"] * g["cos2p"]
                          - 1.5 * g["eta"])
        if g["m2"] != 0 and g["sini"] != 0:
            lam = 1.0 - g["sini"] * g["sinp"]
            delay = delay - 2.0 * T_SUN * g["m2"] * np.log(lam)
        return delay
    g = _orbit_geometry(par, t)
    beta = (g["sinw"] * (g["cosE"] - g["ecc"])
            + g["q"] * g["cosw"] * g["sinE"])
    delay = g["x"] * beta + g["gamma"] * g["sinE"]
    if g["m2"] != 0 and g["sini"] != 0:
        lam = 1.0 - g["ecc"] * g["cosE"] - g["sini"] * beta
        delay = delay - 2.0 * T_SUN * g["m2"] * np.log(lam)
    return delay


def binary_delay(par: Par, mjds: np.ndarray) -> np.ndarray:
    """Total binary delay (seconds, longdouble) at each arrival MJD.

    The timing formula gives the delay as a function of *emission* time;
    inverting t_em = t_arr - Delta(t_em) by fixed-point iteration
    (contraction rate ~ x * 2pi/PB ~ 3e-5 for J1713: three rounds reach
    sub-ns) mirrors tempo2's inverse evaluation."""
    if not has_binary(par):
        return np.zeros(len(np.atleast_1d(mjds)), dtype=np.longdouble)
    t_arr = np.asarray(mjds, dtype=np.longdouble)
    delay = np.zeros_like(t_arr)
    for _ in range(3):
        delay = _delay_at(par, t_arr - delay / SECS_PER_DAY)
    return delay


def phase(par: Par, mjds: np.ndarray) -> np.ndarray:
    """Pulse phase (cycles, longdouble) at each TOA MJD, evaluated at the
    binary emission time (arrival minus DD delay)."""
    t = np.asarray(mjds, dtype=np.longdouble)
    if has_binary(par):
        t = t - binary_delay(par, t) / SECS_PER_DAY
    dt = (t - par.getfloat("PEPOCH")) * SECS_PER_DAY
    f0 = par.getfloat("F0")
    f1 = par.getfloat("F1")
    f2 = par.getfloat("F2")
    return dt * (f0 + dt * (f1 / 2 + dt * f2 / 6))


def prefit_residuals(par: Par, mjds: np.ndarray) -> np.ndarray:
    """Timing residuals (seconds, float64) from nearest-integer phase wrap.

    Valid while residuals are well inside +-P/2 of a pulse period — true for
    all datasets in scope (us-scale residuals vs ms-scale periods).
    """
    ph = phase(par, mjds)
    frac = ph - np.rint(ph)
    f0 = par.getfloat("F0")
    return np.asarray(frac / f0, dtype=np.float64)


def design_matrix(par: Par, mjds: np.ndarray) -> Tuple[np.ndarray, List[str]]:
    """Design matrix ``M`` (n x m_tm, float64) and its column labels.

    One column per fitted parameter plus the phase offset, mirroring the
    column count of the tempo2 ``Mmat`` the reference consumes
    (reference run_sims.py:22-25; SURVEY.md §2.2). Columns are unit-RMS
    normalized — the downstream SVD basis is scale-invariant.
    """
    mjds = np.asarray(mjds, dtype=np.longdouble)
    pepoch = par.getfloat("PEPOCH", float(mjds.mean()))
    dt = np.asarray((mjds - pepoch) * SECS_PER_DAY, dtype=np.float64)  # seconds
    t_yr = np.asarray(
        (mjds - pepoch) / DAYS_PER_YEAR, dtype=np.float64
    )  # years since PEPOCH
    annual = 2 * np.pi * t_yr

    fit = set(par.fit_params())
    cols: List[np.ndarray] = [np.ones_like(dt)]
    labels: List[str] = ["OFFSET"]

    def add(label: str, col: np.ndarray):
        cols.append(col)
        labels.append(label)

    if "F0" in fit or "F0" in par:
        add("F0", dt)
    if "F1" in fit or "F1" in par:
        add("F1", dt * dt)
    if "F2" in fit:
        add("F2", dt ** 3)
    # Astrometry: sky position -> annual sinusoids; proper motion -> their
    # secular drift; parallax -> semi-annual term.
    if "RAJ" in fit:
        add("RAJ", np.sin(annual))
    if "DECJ" in fit:
        add("DECJ", np.cos(annual))
    if "PMRA" in fit:
        add("PMRA", t_yr * np.sin(annual))
    if "PMDEC" in fit:
        add("PMDEC", t_yr * np.cos(annual))
    if "PX" in fit:
        add("PX", np.cos(2 * annual))
    # Binary block: analytic derivatives d(delay)/d(param) of the DD delay
    # implemented above (evaluated at arrival times — the emission-time
    # correction is second order in the derivative). The residual response
    # to a small parameter change is -d(delay); sign and scale wash out in
    # the unit-RMS normalization and the downstream SVD.
    if has_binary(par) and _binary_flavor(par) in _ELL1_FAMILY:
        g = _ell1_geometry(par, mjds)
        sinp, cosp = g["sinp"], g["cosp"]
        sin2p, cos2p = g["sin2p"], g["cos2p"]
        x, eta, kap = g["x"], g["eta"], g["kap"]
        # d(phase)/d(param) chain through phi for TASC/PB
        dR_dphi = x * (cosp + kap * cos2p + eta * sin2p)
        two_pi = 2.0 * np.pi
        binary_cols = {
            "A1": sinp + 0.5 * kap * sin2p - 0.5 * eta * cos2p - 1.5 * eta,
            "TASC": dR_dphi * (-two_pi / g["pb"]),
            "PB": dR_dphi * (-two_pi * (g["t"] - g["tasc"])
                             / g["pb"] ** 2),
            "EPS1": x * (-0.5 * cos2p - 1.5),
            "EPS2": 0.5 * x * sin2p,
        }
        lam = 1.0 - g["sini"] * sinp
        m2_eff = g["m2"] if g["m2"] != 0 else np.longdouble(1.0)
        binary_cols["SINI"] = 2.0 * T_SUN * m2_eff * sinp / lam
        binary_cols["M2"] = -2.0 * T_SUN * np.log(lam)
        for name, col in binary_cols.items():
            if name in fit:
                add(name, np.asarray(col, dtype=np.float64))
    elif has_binary(par):
        g = _orbit_geometry(par, mjds)
        sinE, cosE = g["sinE"], g["cosE"]
        sinw, cosw = g["sinw"], g["cosw"]
        ecc, q, x = g["ecc"], g["q"], g["x"]
        beta = sinw * (cosE - ecc) + q * cosw * sinE
        dbeta_dE = -sinw * sinE + q * cosw * cosE
        dE_dM = 1.0 / (1.0 - ecc * cosE)
        two_pi = 2.0 * np.pi
        binary_cols = {
            "A1": beta,
            "T0": x * dbeta_dE * dE_dM * (-two_pi / g["pb"]),
            "PB": x * dbeta_dE * dE_dM
                  * (-two_pi * (g["t"] - g["t0"]) / g["pb"] ** 2),
            "OM": x * (cosw * (cosE - ecc) - q * sinw * sinE),
            "ECC": x * (-sinw - (ecc / q) * cosw * sinE
                        + dbeta_dE * sinE * dE_dM),
            "GAMMA": sinE,
        }
        # Shapiro columns exist whenever the parameter is fit-flagged, even
        # from a zero starting value (a normal tempo2 workflow): lam > 0
        # always, and a zero current M2 would make dDelta/dSINI identically
        # zero, so the SINI column falls back to the derivative *direction*
        # for any nonzero companion mass (normalization rescales anyway).
        lam = 1.0 - ecc * cosE - g["sini"] * beta
        m2_eff = g["m2"] if g["m2"] != 0 else np.longdouble(1.0)
        binary_cols["SINI"] = 2.0 * T_SUN * m2_eff * beta / lam
        binary_cols["M2"] = -2.0 * T_SUN * np.log(lam)
        for name, col in binary_cols.items():
            if name in fit:
                add(name, np.asarray(col, dtype=np.float64))

    M = np.column_stack(cols)
    norms = np.sqrt(np.mean(M ** 2, axis=0))
    norms[norms == 0] = 1.0
    return M / norms, labels
