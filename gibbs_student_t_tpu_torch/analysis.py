"""Posterior analysis: the notebook's validation surface as a library.

The reference performs all of its result analysis interactively in
``gibbs_likelihood.ipynb`` (reference cells 10-27; SURVEY.md §2.1 C18):
posterior histograms, outlier-probability maps over MJD, ``z``/``alpha``
per-TOA maps, df posterior bars, waveform reconstructions from ``T b``
draws, and the theta posterior against its analytic Beta density. This
module provides those as functions over :class:`ChainResult` — numeric
summaries first-class, matplotlib optional — so they work identically for
single-chain runs ``(niter, ...)`` and many-chain runs
``(niter, nchains, ...)``. A copy of ``gibbs_student_t_tpu/analysis.py``
over this package's ``ChainResult`` and ``ModelArrays``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np

from gibbs_student_t_tpu_torch.backends.base import ChainResult
from gibbs_student_t_tpu_torch.models.pta import ModelArrays
from gibbs_student_t_tpu_torch.parallel.diagnostics import (
    effective_sample_size,
    gelman_rubin,
)


def _flat(a: np.ndarray, trailing: int) -> np.ndarray:
    """Merge sweep and chain axes: (niter[, nchains], ...) -> (draws, ...)."""
    a = np.asarray(a)
    return a.reshape(-1, *a.shape[a.ndim - trailing:]) if trailing else \
        a.reshape(-1)


@dataclasses.dataclass
class PosteriorSummary:
    names: Sequence[str]
    mean: np.ndarray
    std: np.ndarray
    q05: np.ndarray
    q50: np.ndarray
    q95: np.ndarray
    ess: np.ndarray
    rhat: Optional[np.ndarray]    # None for single-chain runs

    def table(self) -> str:
        hdr = f"{'parameter':<28}{'mean':>10}{'std':>10}{'5%':>10}" \
              f"{'50%':>10}{'95%':>10}{'ESS':>8}"
        rows = [hdr]
        if self.rhat is not None:
            rows[0] += f"{'R-hat':>8}"
        for i, nm in enumerate(self.names):
            row = (f"{nm:<28}{self.mean[i]:>10.4g}{self.std[i]:>10.4g}"
                   f"{self.q05[i]:>10.4g}{self.q50[i]:>10.4g}"
                   f"{self.q95[i]:>10.4g}{self.ess[i]:>8.0f}")
            if self.rhat is not None:
                row += f"{self.rhat[i]:>8.3f}"
            rows.append(row)
        return "\n".join(rows)


def summarize(res: ChainResult, names: Sequence[str]) -> PosteriorSummary:
    """Posterior summary of the sampled parameter vectors (the notebook's
    histogram panels, reference cells 12-14, as numbers)."""
    chain = np.asarray(res.chain)
    multi = chain.ndim == 3
    flat = _flat(chain, 1)
    qs = np.quantile(flat, [0.05, 0.5, 0.95], axis=0)
    p = chain.shape[-1]
    ess = np.array([
        effective_sample_size(chain[..., i] if multi else chain[:, i])
        for i in range(p)
    ])
    rhat = None
    if multi and chain.shape[1] > 1:
        rhat = np.array([gelman_rubin(chain[..., i]) for i in range(p)])
    return PosteriorSummary(
        names=list(names), mean=flat.mean(axis=0), std=flat.std(axis=0),
        q05=qs[0], q50=qs[1], q95=qs[2], ess=ess, rhat=rhat,
    )


def outlier_probabilities(res: ChainResult) -> np.ndarray:
    """Median posterior outlier probability per TOA (the notebook's
    outlier-map statistic, reference cells 17-18, 21)."""
    pout = np.asarray(res.poutchain)
    return np.median(_flat(pout, 1), axis=0)


def identify_outliers(res: ChainResult, threshold: float = 0.9) -> np.ndarray:
    """Indices flagged as outliers: median pout > threshold (the notebook
    uses 0.9, reference cell 18)."""
    return np.where(outlier_probabilities(res) > threshold)[0]


def outlier_confusion(res: ChainResult, z_true: np.ndarray,
                      threshold: float = 0.9) -> Dict[str, int]:
    """Recovery vs. simulation ground truth (``outliers.txt``,
    reference simulate_data.py:31) — the simulation-based-calibration check
    of SURVEY.md §4."""
    found = np.zeros(len(z_true), dtype=bool)
    found[identify_outliers(res, threshold)] = True
    truth = np.asarray(z_true, dtype=bool)
    return {
        "true_positive": int(np.sum(found & truth)),
        "false_positive": int(np.sum(found & ~truth)),
        "false_negative": int(np.sum(~found & truth)),
        "true_negative": int(np.sum(~found & ~truth)),
    }


def reconstruct_waveform(res: ChainResult, ma: ModelArrays,
                         ndraws: int = 200, seed: int = 0):
    """Posterior draws of the signal realization ``T b`` in seconds
    (the notebook's waveform overlay, reference cell 20).

    Returns ``(draws, median, lo90, hi90)``; ``draws`` is
    ``(ndraws, n)``.
    """
    b = _flat(np.asarray(res.bchain), 1)
    rng = np.random.default_rng(seed)
    take = rng.choice(len(b), size=min(ndraws, len(b)), replace=False)
    draws = (b[take] @ ma.T.T) / ma.time_scale
    lo, med, hi = np.quantile(draws, [0.05, 0.5, 0.95], axis=0)
    return draws, med, lo, hi


def theta_posterior_check(res: ChainResult, n: int, outlier_mean: float,
                          nbins: int = 30):
    """Histogram of the theta chain against the analytic conjugate Beta
    density (the notebook's cell-24 overlay). Returns
    ``(centers, hist_density, prior_density)`` where the prior is
    ``Beta(n*m, n*(1-m))`` (reference gibbs.py:190-194)."""
    theta = _flat(np.asarray(res.thetachain), 0)
    hist, edges = np.histogram(theta, bins=nbins, density=True)
    centers = 0.5 * (edges[1:] + edges[:-1])
    a, b = n * outlier_mean, n * (1.0 - outlier_mean)
    lognorm = math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
    prior = np.exp(lognorm + (a - 1) * np.log(centers)
                   + (b - 1) * np.log1p(-centers))
    return centers, hist, prior


def df_posterior(res: ChainResult, df_max: int = 30) -> np.ndarray:
    """Posterior pmf over the dof grid 1..df_max (the notebook's df bars,
    reference cell 24)."""
    df = _flat(np.asarray(res.dfchain), 0).astype(int)
    counts = np.bincount(df, minlength=df_max + 1)[1:df_max + 1]
    return counts / max(counts.sum(), 1)


def acceptance_report(res: ChainResult) -> Dict[str, float]:
    """Mean MH acceptance per block — untracked in the reference
    (SURVEY.md §5)."""
    return {k: float(np.mean(v)) for k, v in res.stats.items()
            if k.startswith("acc_")}


# ---------------------------------------------------------------------------
# plotting (optional matplotlib)
# ---------------------------------------------------------------------------

def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_posteriors(res: ChainResult, names: Sequence[str], path: str,
                    truths: Optional[Dict[str, float]] = None) -> None:
    """Posterior histogram grid (reference cells 12-14)."""
    plt = _plt()
    chain = _flat(np.asarray(res.chain), 1)
    p = chain.shape[1]
    ncol = min(4, p)
    nrow = -(-p // ncol)
    fig, axes = plt.subplots(nrow, ncol, figsize=(3.2 * ncol, 2.6 * nrow),
                             squeeze=False)
    for i, nm in enumerate(names):
        ax = axes[i // ncol][i % ncol]
        ax.hist(chain[:, i], bins=40, density=True, histtype="step")
        if truths and nm in truths:
            ax.axvline(truths[nm], color="k", ls="--", lw=1)
        ax.set_title(nm, fontsize=8)
    for j in range(p, nrow * ncol):
        axes[j // ncol][j % ncol].axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_outlier_map(res: ChainResult, mjds: np.ndarray, path: str,
                     z_true: Optional[np.ndarray] = None,
                     threshold: float = 0.9) -> None:
    """Outlier probability vs. MJD (reference cells 17-18, 21)."""
    plt = _plt()
    pout = outlier_probabilities(res)
    fig, ax = plt.subplots(figsize=(7, 3))
    ax.scatter(mjds, pout, s=12, label="median P(outlier)")
    if z_true is not None:
        idx = np.asarray(z_true, dtype=bool)
        ax.scatter(np.asarray(mjds)[idx], pout[idx], s=40, marker="x",
                   color="r", label="injected outliers")
    ax.axhline(threshold, color="gray", ls=":", lw=1)
    ax.set_xlabel("MJD")
    ax.set_ylabel("P(outlier)")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_waveform(res: ChainResult, ma: ModelArrays, mjds: np.ndarray,
                  path: str) -> None:
    """Reconstructed signal realization with 90% band over the residuals
    (reference cell 20)."""
    plt = _plt()
    _, med, lo, hi = reconstruct_waveform(res, ma)
    fig, ax = plt.subplots(figsize=(7, 3))
    ax.errorbar(mjds, ma.y / ma.time_scale,
                yerr=np.sqrt(ma.sigma2) / ma.time_scale,
                fmt=".", ms=3, alpha=0.5, label="residuals")
    ax.plot(mjds, med, color="C1", label="posterior median T b")
    ax.fill_between(mjds, lo, hi, color="C1", alpha=0.3, label="90% band")
    ax.set_xlabel("MJD")
    ax.set_ylabel("residual (s)")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_corner(res: ChainResult, names: Sequence[str], path: str,
                truths: Optional[Dict[str, float]] = None,
                bins: int = 30) -> None:
    """Pairwise posterior ("corner") grid: marginal histograms on the
    diagonal, 2-D density below it — the role the external ``corner``
    package plays in the reference notebook (gibbs_likelihood.ipynb
    cells 12-14), first-party here so validation needs no extra deps."""
    plt = _plt()
    chain = _flat(np.asarray(res.chain), 1)
    idx = list(range(len(names)))
    p = len(idx)
    fig, axes = plt.subplots(p, p, figsize=(2.2 * p, 2.2 * p),
                             squeeze=False)
    for r in range(p):
        for c in range(p):
            ax = axes[r][c]
            if c > r:
                ax.axis("off")
                continue
            if c == r:
                ax.hist(chain[:, idx[r]], bins=bins, density=True,
                        histtype="step")
                if truths and names[r] in truths:
                    ax.axvline(truths[names[r]], color="k", ls="--", lw=1)
            else:
                ax.hist2d(chain[:, idx[c]], chain[:, idx[r]], bins=bins,
                          cmap="Blues")
                if truths and names[c] in truths:
                    ax.axvline(truths[names[c]], color="k", ls="--", lw=1)
                if truths and names[r] in truths:
                    ax.axhline(truths[names[r]], color="k", ls="--", lw=1)
            if r == p - 1:
                ax.set_xlabel(names[c], fontsize=8)
            else:
                ax.set_xticklabels([])
            if c == 0 and r > 0:
                ax.set_ylabel(names[r], fontsize=8)
            else:
                ax.set_yticklabels([])
            ax.tick_params(labelsize=6)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_df_posterior(res: ChainResult, path: str, df_max: int = 30) -> None:
    """Dof posterior bars (reference cell 24)."""
    plt = _plt()
    pmf = df_posterior(res, df_max)
    fig, ax = plt.subplots(figsize=(5, 3))
    ax.bar(np.arange(1, df_max + 1), pmf)
    ax.set_xlabel("Student-t dof")
    ax.set_ylabel("posterior pmf")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
