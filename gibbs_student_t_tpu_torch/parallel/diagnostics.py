"""Convergence diagnostics: ESS and Gelman-Rubin R-hat, on the host.

A numpy copy of ``gibbs_student_t_tpu/parallel/diagnostics.py``, with the
same functions, names and signatures. The reference tracks no
diagnostics at all — not even MH acceptance (SURVEY.md §5). With a chain
axis on the device, cross-chain statistics are where the
``effective-samples/sec`` metric comes from. The JAX module's
``rhat_collective`` (R-hat over a chain axis sharded across devices) has
no counterpart here until the chain axis spans several GPUs.
"""

from __future__ import annotations

import numpy as np

#: the ``row_class`` value of a scan-end row (``parallel/recycle.py`` tags
#: the rebuilt partial-scan rows between them)
ROW_SCAN_END = 0


def autocorr_time_batch(x: np.ndarray, c: float = 5.0) -> np.ndarray:
    """Integrated autocorrelation times of ``(niter, k)`` chains (Sokal
    windowing), one batched FFT over all ``k`` columns.

    The convergence-stopping loop calls this every ``check_every``
    sweeps on up to nchains x nparams columns; the per-column Python
    loop it replaces paid one small rfft/irfft pair per column
    (~17k FFT calls per check at 1024 chains x 17 params)."""
    x = np.asarray(x, dtype=np.float64)
    n, k = x.shape
    # Column blocks bound the peak footprint: the FFT intermediates are
    # O(n x block) float64/complex128, and an unblocked call at the
    # scale this exists for (1024 chains x 17 params x long windows)
    # would spike several GB on the 1-core host. ~70 FFT calls instead
    # of ~17k still amortizes away the per-call overhead.
    block = max(1, min(k, (1 << 22) // max(n, 1)))  # ~32 MB per buffer
    out = np.empty(k)
    for j0 in range(0, k, block):
        xb = x[:, j0:j0 + block]
        kb = xb.shape[1]
        scale = np.abs(xb).max(axis=0)
        xb = xb - xb.mean(axis=0)
        # FFT autocorrelation, all columns of the block at once
        f = np.fft.rfft(xb, n=2 * n, axis=0)
        acf = np.fft.irfft(f * np.conj(f), axis=0)[:n]
        a0 = acf[0].copy()
        # Constant column: tau := 1. The check is a RELATIVE threshold,
        # not a0 == 0 — centering a constant column leaves
        # O(n*eps*scale) summation residue (whose acf is perfectly
        # correlated noise that would report tau ~ n), and whether it
        # cancels exactly depends on the mean's summation order over
        # the strided axis.
        dead = a0 <= n * (64 * np.finfo(np.float64).eps * scale) ** 2
        acf /= np.where(dead, 1.0, a0)
        tau = 2.0 * np.cumsum(acf, axis=0) - 1.0
        window = np.arange(n)[:, None] >= c * tau
        has = window.any(axis=0)
        idx = np.where(has, np.argmax(window, axis=0), n - 1)
        taus = np.maximum(tau[idx, np.arange(kb)], 1.0)
        out[j0:j0 + block] = np.where(dead, 1.0, taus)
    return out


def autocorr_time(x: np.ndarray, c: float = 5.0) -> float:
    """Integrated autocorrelation time of a 1-D chain (Sokal windowing)."""
    x = np.asarray(x, dtype=np.float64)
    return float(autocorr_time_batch(x[:, None], c)[0])


def ess_per_param(window: np.ndarray,
                  row_class: np.ndarray | None = None) -> np.ndarray:
    """(p,) total effective sample size per parameter over a
    (rows, nchains, p) window: chains pooled, each discounted by its
    autocorrelation time, all nchains*p columns in one batched FFT.

    ``row_class`` (:data:`ROW_SCAN_END` and parallel/recycle.py) marks
    recycled partial-scan rows in an interleaved window; they are
    DROPPED here before the autocorrelation pass. Each coordinate updates once per scan, so a
    recycled row duplicates its per-param value from an adjacent
    scan-end row — keeping duplicates would double the row count AND
    the measured τ, an estimator no-op paid for with a 2× FFT
    (recycling buys cross-block moments, never per-param ESS; see
    recycle.py's module docs, pinned in tests/test_torch_recycle.py)."""
    window = np.asarray(window, dtype=np.float64)
    if row_class is not None:
        window = window[np.asarray(row_class) == ROW_SCAN_END]
    rows, nchains, p = window.shape
    taus = autocorr_time_batch(window.reshape(rows, nchains * p))
    return (rows / taus).reshape(nchains, p).sum(axis=0)


def effective_sample_size(chains: np.ndarray) -> float:
    """ESS of ``(niter,)`` or ``(niter, nchains)`` samples: pooled over
    independent chains, each discounted by its autocorrelation time."""
    chains = np.atleast_2d(np.asarray(chains, dtype=np.float64).T).T
    taus = autocorr_time_batch(chains)
    return float((chains.shape[0] / taus).sum())


def gelman_rubin_per_param(chains: np.ndarray) -> np.ndarray:
    """(p,) potential scale reduction R-hat over ``(niter, nchains, p)``
    samples — one vectorized pass over the parameter axis. The scalar
    :func:`gelman_rubin` is this with ``p == 1`` (pinned equal in
    tests/test_obs.py), so the per-parameter loop ``obs/health.py`` and
    the serving convergence monitor used to pay is a single reduction."""
    chains = np.asarray(chains, dtype=np.float64)
    n = chains.shape[0]
    means = chains.mean(axis=0)                       # (m, p)
    W = chains.var(axis=0, ddof=1).mean(axis=0)       # (p,)
    B = n * means.var(axis=0, ddof=1)                 # (p,)
    var_plus = (n - 1) / n * W + B / n
    return np.sqrt(var_plus / W)


def gelman_rubin(chains: np.ndarray) -> float:
    """Potential scale reduction R-hat over ``(niter, nchains)`` samples."""
    chains = np.asarray(chains, dtype=np.float64)
    return float(gelman_rubin_per_param(chains[:, :, None])[0])


def split_rhat_per_param(window: np.ndarray,
                         row_class: np.ndarray | None = None
                         ) -> np.ndarray:
    """(p,) split-R-hat over a ``(rows, nchains, p)`` window: every
    chain halved (within-chain drift shows up as cross-half spread),
    all parameters in one batched :func:`gelman_rubin_per_param`.
    ``row_class`` drops recycled partial-scan rows first (the
    :func:`ess_per_param` duplicate argument — per-param spread gains
    nothing from rows whose per-param values repeat their
    neighbours')."""
    window = np.asarray(window, dtype=np.float64)
    if row_class is not None:
        window = window[np.asarray(row_class) == ROW_SCAN_END]
    n = window.shape[0] // 2
    split = np.concatenate([window[:n], window[n:2 * n]], axis=1)
    return gelman_rubin_per_param(split)


def split_rhat(chains: np.ndarray) -> float:
    """Rank-normalization-free split-R-hat: halves each chain to detect
    within-chain drift."""
    chains = np.asarray(chains, dtype=np.float64)
    return float(split_rhat_per_param(chains[:, :, None])[0])
