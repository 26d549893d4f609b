"""Simulation: fake pulsars with injected red noise and outliers.

First-party NumPy replacement for ``libstempo.toasim`` (tempo2 C++) used by
the reference simulator (reference simulate_data.py:10-39): ``fakepulsar``
(ideal integer-phase TOAs at given epochs), ``add_rednoise`` (Fourier-basis
power-law injection, reference simulate_data.py:21), Bernoulli outlier
contamination, and par/tim persistence with ground truth.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from gibbs_student_t_tpu_torch.data.par import Par, read_par, write_par
from gibbs_student_t_tpu_torch.data.tim import TimFile, read_tim, write_tim
from gibbs_student_t_tpu_torch.data.timing_model import SECS_PER_DAY, phase

FYR = 1.0 / (365.25 * 86400.0)  # 1/yr in Hz


class FakePulsar:
    """Ideal-TOA pulsar at given epochs, mutable like ``libstempo``'s:
    ``stoas`` (longdouble MJD) can be perturbed in place, ``deleted`` flags
    persist as commented TOA lines (reference simulate_data.py:26,36)."""

    def __init__(self, par: Par, epoch_mjds: np.ndarray, errors_us: np.ndarray,
                 freqs=1440.0, site="AXIS"):
        self.par = par
        self.name = par.name
        n = len(epoch_mjds)
        self.stoas = self._idealize(np.asarray(epoch_mjds, dtype=np.longdouble))
        self.errors_us = np.asarray(errors_us, dtype=np.float64)
        self.freqs = np.broadcast_to(np.asarray(freqs, dtype=np.float64), (n,)).copy()
        self.site = site
        self.deleted = np.zeros(n, dtype=bool)

    def _idealize(self, mjds: np.ndarray) -> np.ndarray:
        """Shift each epoch to the nearest exact integer-phase arrival time
        (Newton steps on the longdouble phase model). Convergence per step
        is the binary-delay rate ~x*2pi/PB (~3e-5 for the datasets in
        scope); four steps put the residual non-integer phase below
        femtoseconds even for a DD binary."""
        f0 = self.par.getfloat("F0")
        for _ in range(4):
            ph = phase(self.par, mjds)
            frac = ph - np.rint(ph)
            mjds = mjds - frac / f0 / SECS_PER_DAY
        return mjds

    @property
    def n(self) -> int:
        return len(self.stoas)

    def add_rednoise(self, A: float, gamma: float, components: int = 30,
                     rng: Optional[np.random.Generator] = None,
                     return_waveform: bool = False):
        """Inject a power-law red-noise realization on the standard PTA
        Fourier basis: f_k = k/T_span, sin+cos coefficients drawn with
        variance = powerlaw PSD * df (reference simulate_data.py:21)."""
        rng = rng or np.random.default_rng()
        toas = np.asarray(self.stoas * SECS_PER_DAY, dtype=np.float64)
        tspan = toas.max() - toas.min()
        k = np.arange(1, components + 1)
        f = k / tspan
        # Same spectral convention as the sampler's prior (models/priors.py).
        var = (A ** 2 / (12 * np.pi ** 2) * FYR ** (gamma - 3)
               * f ** (-gamma) / tspan)
        a = rng.standard_normal(components) * np.sqrt(var)
        b = rng.standard_normal(components) * np.sqrt(var)
        arg = 2 * np.pi * f[None, :] * (toas - toas.min())[:, None]
        wave = np.sin(arg) @ a + np.cos(arg) @ b
        self.stoas = self.stoas + np.asarray(wave, dtype=np.longdouble) / SECS_PER_DAY
        if return_waveform:
            return wave

    def to_tim(self) -> TimFile:
        return TimFile(
            names=[self.name] * self.n,
            freqs=self.freqs.copy(),
            mjds=self.stoas.copy(),
            errors=self.errors_us.copy(),
            sites=[self.site] * self.n,
            flags={},
            deleted=self.deleted.copy(),
        )

    def savepar(self, path: str) -> None:
        write_par(self.par, path)

    def savetim(self, path: str) -> None:
        write_tim(self.to_tim(), path)


def simulate_data(
    parfile: str,
    timfile: str,
    theta: float = 0.05,
    idx: int = 0,
    sigma_out: float = 1e-6,
    outdir: str = "simulated_data",
    rng: Optional[np.random.Generator] = None,
    keep: Optional[int] = None,
):
    """End-to-end simulated dataset, mirroring the reference pipeline
    (reference simulate_data.py:10-39):

    - epochs taken from the real tim file;
    - log-normal error bars ``10**(-7 + 0.2*xi)`` seconds;
    - 30-component power-law red noise (A=1e-14, gamma=4.33);
    - Bernoulli(theta) outlier mask ``z``; white noise sigma is the TOA error
      for inliers and ``sigma_out`` for outliers;
    - writes ``{outdir}/outlier/{theta}/{idx}/`` with ground truth
      ``outliers.txt`` and a twin ``no_outlier`` tree with outlier TOAs
      flagged deleted.

    Returns the (outlier_dir, no_outlier_dir) paths.
    """
    rng = rng or np.random.default_rng()
    par = read_par(parfile)
    tim = read_tim(timfile)

    # ``keep`` subsets the real epochs (first-N) — ensembles use it to
    # simulate heterogeneous per-pulsar TOA counts from one base tim
    mjds = tim.mjds if keep is None else tim.mjds[:keep]
    err_us = 10 ** (-7 + rng.standard_normal(len(mjds)) * 0.2) * 1e6
    psr = FakePulsar(par, mjds, err_us)
    psr.add_rednoise(1e-14, 4.33, components=30, rng=rng)

    z = rng.random(psr.n) < theta
    sigma = np.where(z, sigma_out, err_us * 1e-6)  # seconds
    psr.stoas = psr.stoas + np.asarray(
        sigma * rng.standard_normal(psr.n), dtype=np.longdouble
    ) / SECS_PER_DAY

    out1 = os.path.join(outdir, "outlier", str(theta), str(idx))
    os.makedirs(out1, exist_ok=True)
    np.savetxt(os.path.join(out1, "outliers.txt"), np.flatnonzero(z), fmt="%d")
    psr.savepar(os.path.join(out1, f"{psr.name}.par"))
    psr.savetim(os.path.join(out1, f"{psr.name}.tim"))

    out2 = os.path.join(outdir, "no_outlier", str(theta), str(idx))
    os.makedirs(out2, exist_ok=True)
    psr.deleted[z] = True
    psr.savepar(os.path.join(out2, f"{psr.name}.par"))
    psr.savetim(os.path.join(out2, f"{psr.name}.tim"))
    return out1, out2
