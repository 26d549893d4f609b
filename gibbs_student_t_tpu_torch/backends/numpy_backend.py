"""NumPy oracle backend: single-chain blocked MH-within-Gibbs on the host.

A cleaned, Python-3, explicitly-seeded equivalent of the reference sampler
(reference gibbs.py:8-385) running against :class:`ModelArrays` instead of
an enterprise PTA. This is the correctness oracle for the TPU kernel's KS
gates (SURVEY.md §4) and the ``--backend=cpu`` side of the plugin seam.

Deliberate deviations from the reference, all behavior-preserving or
bug-fixing (SURVEY.md §2.1 notes):

- the basis-coefficient draw always runs after the hyper block; the
  reference gates it on a buggy broadcast compare (gibbs.py:373) whose
  *intent* was "redraw iff the MH block moved" — always-redrawing is the
  plain Gibbs kernel and is what the guard reduces to in practice;
- ``b`` is drawn via Cholesky instead of SVD — identical conditional
  distribution N(Sigma^-1 d, Sigma^-1) (gibbs.py:169-180), without the
  TPU-hostile SVD;
- Python-2 latent bugs (``map`` consumed as list, gibbs.py:226,248) fixed;
- acceptance rates are counted (the reference tracks none, SURVEY.md §5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.linalg as sl
from scipy.special import gammaln

from gibbs_student_t_tpu_torch.backends.base import ChainResult, SamplerBackend
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.models.pta import ModelArrays, lnprior, ndiag, phiinv_logdet


class NumpyGibbs(SamplerBackend):
    def __init__(self, ma: ModelArrays, config: GibbsConfig):
        super().__init__(ma, config)
        if ma.row_mask is not None and not np.all(ma.row_mask):
            raise ValueError(
                "NumpyGibbs does not support padded models; pass the "
                "unpadded per-pulsar ModelArrays (padding exists only "
                "for stacking ensembles on device)")
        cfg = config
        n = ma.n
        self._z = (np.ones(n) if cfg.z_init_ones else np.zeros(n))
        self._alpha = (np.ones(n) if cfg.vary_alpha
                       else np.full(n, cfg.alpha))
        self._theta = cfg.outlier_mean
        self._pout = np.zeros(n)
        self._b = np.zeros(ma.m)
        self.tdf = cfg.tdf
        # per-sweep cache of TNT = T^T N^-1 T and d = T^T N^-1 y
        # (reference gibbs.py:38-39,302-304)
        self._TNT = None
        self._d = None
        # pspin in scaled time units so the vvh17 uniform-in-phase density
        # theta/pspin matches the scaled Gaussian densities
        self._pspin = (cfg.pspin * ma.time_scale
                       if cfg.pspin is not None else None)

    # -- likelihoods --------------------------------------------------------

    def _nvec(self, x: np.ndarray) -> np.ndarray:
        return self._alpha ** self._z * ndiag(self.ma, x)

    def get_lnlikelihood_white(self, x: np.ndarray) -> float:
        """Conditional-on-b Gaussian likelihood (reference gibbs.py:262-284)."""
        nvec = self._nvec(x)
        yred = self.ma.y - self.ma.T @ self._b
        return float(-0.5 * (np.sum(np.log(nvec)) + np.sum(yred ** 2 / nvec)))

    def _update_cache(self, nvec: np.ndarray) -> None:
        if self._TNT is None:
            T = self.ma.T
            self._TNT = T.T @ (T / nvec[:, None])
            self._d = T.T @ (self.ma.y / nvec)

    def get_lnlikelihood(self, x: np.ndarray) -> float:
        """b-marginalized likelihood (reference gibbs.py:288-329)."""
        nvec = self._nvec(x)
        self._update_cache(nvec)
        phiinv, logdet_phi = phiinv_logdet(self.ma, x)
        loglike = -0.5 * (np.sum(np.log(nvec))
                          + np.sum(self.ma.y ** 2 / nvec))
        Sigma = self._TNT + np.diag(phiinv)
        try:
            cf = sl.cho_factor(Sigma)
            expval = sl.cho_solve(cf, self._d)
        except np.linalg.LinAlgError:
            return -np.inf
        logdet_sigma = np.sum(2 * np.log(np.diag(cf[0])))
        return float(loglike + 0.5 * (self._d @ expval - logdet_sigma
                                      - logdet_phi))

    def get_lnprior(self, x: np.ndarray) -> float:
        return float(lnprior(self.ma, x))

    def get_lnlikelihood_df(self, df: float) -> float:
        """Discrete-df conditional (reference gibbs.py:331-335)."""
        n = self.ma.n
        a = self._alpha
        return float(-(df / 2) * np.sum(np.log(a) + 1 / a)
                     + n * (df / 2) * np.log(df / 2)
                     - n * gammaln(df / 2))

    # -- conditional updates ------------------------------------------------

    def _mh_block(self, x: np.ndarray, ind: np.ndarray, nsteps: int,
                  loglike_fn, rng: np.random.Generator):
        """Random-walk MH on one coordinate block
        (reference gibbs.py:80-143)."""
        mh = self.config.mh
        accepted = 0
        if len(ind) == 0:
            return x, 0.0
        lnlike0 = loglike_fn(x)
        lnprior0 = self.get_lnprior(x)
        xnew = x.copy()
        sigma = mh.sigma_per_param * len(ind)
        for _ in range(nsteps):
            q = xnew.copy()
            scale = rng.choice(mh.scale_sizes, p=mh.scale_probs)
            par = rng.choice(ind)
            q[par] += rng.standard_normal() * sigma * scale
            lnlike1 = loglike_fn(q)
            lnprior1 = self.get_lnprior(q)
            if (lnlike1 + lnprior1) - (lnlike0 + lnprior0) > np.log(rng.random()):
                xnew = q
                lnlike0, lnprior0 = lnlike1, lnprior1
                accepted += 1
        return xnew, accepted / nsteps

    def update_white_params(self, x, rng):
        return self._mh_block(x, self.ma.white_indices,
                              self.config.mh.n_white_steps,
                              self.get_lnlikelihood_white, rng)

    def update_hyper_params(self, x, rng):
        return self._mh_block(x, self.ma.hyper_indices,
                              self.config.mh.n_hyper_steps,
                              self.get_lnlikelihood, rng)

    def update_b(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Conditional coefficient draw b ~ N(Sigma^-1 d, Sigma^-1)
        (reference gibbs.py:145-182), via Cholesky: mean = Sigma^-1 d,
        fluctuation = L^-T xi."""
        nvec = self._nvec(x)
        self._update_cache(nvec)
        phiinv, _ = phiinv_logdet(self.ma, x)
        Sigma = self._TNT + np.diag(phiinv)
        try:
            L = sl.cholesky(Sigma, lower=True)
        except np.linalg.LinAlgError:
            L = sl.cholesky(Sigma + 1e-6 * np.eye(self.ma.m)
                            * np.diag(Sigma).max(), lower=True)
        mean = sl.cho_solve((L, True), self._d)
        xi = rng.standard_normal(self.ma.m)
        fluct = sl.solve_triangular(L, xi, lower=True, trans="T")
        return mean + fluct

    def update_theta(self, rng: np.random.Generator) -> float:
        """Beta draw of the outlier fraction (reference gibbs.py:185-198)."""
        cfg = self.config
        if not cfg.is_outlier_model:
            return self._theta
        n = self.ma.n
        if cfg.theta_prior == "beta":
            mk, k1mm = n * cfg.outlier_mean, n * (1 - cfg.outlier_mean)
        else:
            mk, k1mm = 1.0, 1.0
        return float(rng.beta(np.sum(self._z) + mk,
                              n - np.sum(self._z) + k1mm))

    def update_z(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Bernoulli outlier indicators (reference gibbs.py:201-226)."""
        cfg = self.config
        if not cfg.is_outlier_model:
            return self._z
        nvec0 = ndiag(self.ma, x)
        mean = self.ma.T @ self._b
        resid = self.ma.y - mean
        p_in = _norm_pdf(resid, np.sqrt(nvec0))
        if cfg.model == "vvh17":
            top = np.full(self.ma.n, self._theta / self._pspin)
        else:
            p_out = _norm_pdf(resid, np.sqrt(self._alpha * nvec0))
            top = self._theta * p_out
        bot = top + (1 - self._theta) * p_in
        with np.errstate(invalid="ignore"):  # 0/0 -> NaN -> 1 below
            q = top / bot
        q[np.isnan(q)] = 1.0
        self._pout = q
        return (rng.random(self.ma.n) < np.minimum(q, 1.0)).astype(np.float64)

    def update_alpha(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Per-TOA inverse-gamma auxiliary scales (reference gibbs.py:229-242)."""
        cfg = self.config
        if np.sum(self._z) >= 1 and cfg.vary_alpha:
            nvec0 = ndiag(self.ma, x)
            resid = self.ma.y - self.ma.T @ self._b
            top = (resid ** 2 * self._z / nvec0 + self.tdf) / 2
            bot = rng.gamma((self._z + self.tdf) / 2)
            return top / bot
        return self._alpha

    def update_df(self, rng: np.random.Generator) -> float:
        """Discrete dof draw on the grid 1..df_max (reference gibbs.py:244-259)."""
        cfg = self.config
        if not cfg.vary_df:
            return self.tdf
        grid = np.arange(1, cfg.df_max + 1)
        logp = np.array([self.get_lnlikelihood_df(df) for df in grid])
        p = np.exp(logp - logp.max())
        p /= p.sum()
        return float(rng.choice(grid, p=p))

    # -- driver -------------------------------------------------------------

    def sample(self, x0: np.ndarray, niter: int, seed: int = 0,
               rng: Optional[np.random.Generator] = None,
               progress: bool = False) -> ChainResult:
        """The sweep driver (reference gibbs.py:342-385)."""
        rng = rng or np.random.default_rng(seed)
        ma = self.ma
        chain = np.zeros((niter, len(x0)))
        bchain = np.zeros((niter, ma.m))
        zchain = np.zeros((niter, ma.n))
        alphachain = np.zeros((niter, ma.n))
        poutchain = np.zeros((niter, ma.n))
        thetachain = np.zeros(niter)
        dfchain = np.zeros(niter)
        acc_white = np.zeros(niter)
        acc_hyper = np.zeros(niter)

        xnew = np.asarray(x0, dtype=np.float64).copy()
        import time

        tstart = time.time()
        for ii in range(niter):
            chain[ii] = xnew
            bchain[ii] = self._b
            zchain[ii] = self._z
            thetachain[ii] = self._theta
            alphachain[ii] = self._alpha
            dfchain[ii] = self.tdf
            poutchain[ii] = self._pout

            self._TNT = None
            self._d = None

            xnew, acc_white[ii] = self.update_white_params(xnew, rng)
            xnew, acc_hyper[ii] = self.update_hyper_params(xnew, rng)
            self._b = self.update_b(xnew, rng)
            self._theta = self.update_theta(rng)
            self._z = self.update_z(xnew, rng)
            self._alpha = self.update_alpha(xnew, rng)
            self.tdf = self.update_df(rng)

            if progress and ii % 100 == 0 and ii > 0:
                print(f"\rFinished {ii / niter * 100:g} percent in "
                      f"{time.time() - tstart:g} seconds.", end="", flush=True)
        if progress:
            print()

        return ChainResult(
            chain=chain, bchain=bchain, zchain=zchain,
            thetachain=thetachain, alphachain=alphachain,
            poutchain=poutchain, dfchain=dfchain,
            stats={"acc_white": acc_white, "acc_hyper": acc_hyper},
        )


def _norm_pdf(x: np.ndarray, sigma: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * (x / sigma) ** 2) / (np.sqrt(2 * np.pi) * sigma)
