"""Geweke "getting it right" test of the port's sampler (``TorchGibbs``'s
sweep, its draws included).

The joint-distribution check of ``tests/test_geweke.py``, on the port:
alternate (a) re-simulating the data from the generative model given the
current state with (b) one full sweep given the new data. If every
conditional update targets the right distribution the chain's invariant
joint is prior(params) x p(y | params), so each parameter's marginal must
be its prior. The model is that file's proper-prior one (``_proper_ma``:
no timing model, whose flat prior cannot be simulated from; mixture/beta
with a varying df and ``outlier_mean=0.2``), carried into the port by
``convert.model_arrays_from_fields``.

The JAX kernel test runs one chain and passes y into ``_sweep`` each step.
Here the independent chains are the pulsars of one ``EnsembleGibbs`` (one
chain each; every pulsar the same model), so one sweep advances all of
them and each pulsar's y is rewritten each step (the ensemble reads y only
through its ``(P, 1, n)`` tensor). Every chain starts from an exact draw of
the joint, so the chains are stationary from the first step; the gates
pool them, with the integrated autocorrelation time measured on the
chains' averaged autocovariance:

- each parameter's prior-mean z (tau-deflated ESS) below 4.5 and its KS
  p on tau-thinned draws above 1e-3; theta's KS against its Beta prior;
  df's chi-square against the uniform grid;
- the negative control, a sampler whose b draw is doubled (as
  ``BrokenGibbs`` in tests/test_geweke.py), must push log10_A's z above 6.

The sweep's draws are D1's plain version here (``ops/rng.py``); the card's
draw kernel is held bit for bit against that plain version (chip_smoke
phase 14), so this test speaks for the card's draws too.
"""

import numpy as np
import torch
from scipy import stats

from gibbs_student_t_tpu_torch.backends.torch_backend import ChainState
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.convert import model_arrays_from_fields
from gibbs_student_t_tpu_torch.models.pta import ndiag, phiinv_logdet
from gibbs_student_t_tpu_torch.parallel import EnsembleGibbs
from test_geweke import EQUAD, GAMMA, LOG10A, _proper_ma
from test_torch_host import _fields

torch.set_num_threads(1)

CFG = GibbsConfig(model="mixture", vary_df=True, theta_prior="beta",
                  outlier_mean=0.2)
BOUNDS = {"equad": EQUAD, "log10_A": LOG10A, "gamma": GAMMA}


class _BrokenEnsemble(EnsembleGibbs):
    """The b draw doubled (conditional mean 2x, covariance 4x): a gross
    error the gates must see."""

    def _sweep(self, state, draws, sweep=None, block_gates=None):
        st = super()._sweep(state, draws, sweep, block_gates)
        return st._replace(b=2.0 * st.b)


def _port_ma():
    return model_arrays_from_fields(_fields(_proper_ma()))


def _prior_state(ma, P, rng):
    """``(P, 1)`` chains drawn from the generative prior: x, df, theta, z,
    alpha (inverse gamma at df) and b ~ N(0, phi(x))."""
    n, m, cfg = ma.n, ma.m, CFG
    x = np.stack([ma.x_init(rng) for _ in range(P)])
    df = rng.integers(1, cfg.df_max + 1, size=P).astype(float)
    theta = rng.beta(n * cfg.outlier_mean, n * (1 - cfg.outlier_mean),
                     size=P)
    z = (rng.random((P, n)) < theta[:, None]).astype(float)
    alpha = (df[:, None] / 2) / rng.gamma(df[:, None] / 2, size=(P, n))
    b = np.stack([rng.standard_normal(m) / np.sqrt(phiinv_logdet(ma, xp)[0])
                  for xp in x])
    f32 = torch.float32

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=f32)[:, None]

    return ChainState(
        x=t(x), b=t(b), z=t(z), alpha=t(alpha), theta=t(theta), df=t(df),
        pout=torch.zeros((P, 1, n), dtype=f32),
        acc_white=torch.zeros((P, 1), dtype=f32),
        acc_hyper=torch.zeros((P, 1), dtype=f32),
        mh_log_scale=torch.zeros((P, 1, 2), dtype=f32),
        mh_cov_chol=torch.zeros((P, 1, 0), dtype=f32))


def _resimulate(ma, st, rng):
    """y ~ p(y | state) for every chain: T b + heteroscedastic white noise,
    in float64 on the host, as ``(P, 1, n)`` float32."""
    x = st.x[:, 0].double().numpy()
    az = (st.alpha[:, 0].double() ** st.z[:, 0].double()).numpy()
    nvec = az * np.stack([ndiag(ma, xp) for xp in x])
    y = (st.b[:, 0].double().numpy() @ ma.T.T
         + np.sqrt(nvec) * rng.standard_normal(nvec.shape))
    return torch.as_tensor(y, dtype=torch.float32)[:, None]


def _run(cls, P, sweeps, seed):
    """``(xs (sweeps, P, p), thetas (sweeps, P), dfs (sweeps, P))`` of the
    successive-conditional chains."""
    ma = _port_ma()
    ens = cls([ma] * P, CFG, nchains=1, device="cpu")
    rng = np.random.default_rng(seed)
    st = _prior_state(ma, P, rng)
    keys = ens._chain_keys(seed)
    xs = np.zeros((sweeps, P, ma.nparam))
    thetas, dfs = np.zeros((sweeps, P)), np.zeros((sweeps, P))
    for k in range(sweeps):
        ens._y.copy_(_resimulate(ma, st, rng))
        st = ens._sweep(st, ens._draw(keys, torch.tensor(k), st), sweep=k)
        xs[k] = st.x[:, 0].double().numpy()
        thetas[k] = st.theta[:, 0].double().numpy()
        dfs[k] = st.df[:, 0].double().numpy()
    return ma, xs, thetas, dfs


def _tau(s, max_lag=200):
    """Integrated autocorrelation time of ``s (T, P)`` (P independent
    chains of one stationary law), Geyer's initial positive sequence on
    the chains' averaged autocovariance about the pooled mean."""
    T = s.shape[0]
    sc = s - s.mean()
    f = np.fft.rfft(sc, n=2 * T, axis=0)
    acov = np.fft.irfft(f * np.conj(f), axis=0)[:T].mean(axis=1) / T
    ac = acov / acov[0]
    tau, lag = 1.0, 1
    while lag + 1 < min(max_lag, T - 1):
        pair = ac[lag] + ac[lag + 1]
        if pair < 0:
            break
        tau += 2 * pair
        lag += 2
    return tau


def _prior_z(s, lo, hi):
    """``(z, tau)``: the prior-mean z-score of uniform(lo, hi) draws
    ``s (T, P)`` with the tau-deflated effective sample size."""
    tau = _tau(s)
    sem = (hi - lo) / np.sqrt(12) / np.sqrt(s.size / tau)
    return (s.mean() - (lo + hi) / 2) / sem, tau


def _thinned(s, tau):
    return s[::max(1, int(np.ceil(2 * tau)))].ravel()


def test_geweke_marginals_match_priors():
    ma, xs, thetas, dfs = _run(EnsembleGibbs, P=64, sweeps=400,
                               seed=20261018)
    n = ma.n
    for i, name in enumerate(ma.param_names):
        lo, hi = next(v for k, v in BOUNDS.items() if k in name)
        z, tau = _prior_z(xs[:, :, i], lo, hi)
        p = stats.kstest(_thinned(xs[:, :, i], tau), "uniform",
                         args=(lo, hi - lo)).pvalue
        print(f"{name}: z={z:.2f} tau={tau:.1f} KS p={p:.3g}")
        assert abs(z) < 4.5, f"{name}: prior-mean z={z:.2f} (tau={tau:.0f})"
        assert p > 1e-3, f"{name}: prior-marginal KS p={p:.2e}"
    tau = _tau(thetas)
    p = stats.kstest(_thinned(thetas, tau), "beta",
                     args=(n * CFG.outlier_mean,
                           n * (1 - CFG.outlier_mean))).pvalue
    print(f"theta: tau={tau:.1f} KS p={p:.3g}")
    assert p > 1e-3, f"theta: prior-marginal KS p={p:.2e} (tau={tau:.0f})"
    tau = _tau(dfs)
    obs, _ = np.histogram(_thinned(dfs, tau),
                          bins=np.linspace(0.5, CFG.df_max + 0.5, 6))
    p = stats.chisquare(obs).pvalue
    print(f"df: tau={tau:.1f} chi2 p={p:.3g} counts={obs.tolist()}")
    assert p > 1e-3, f"df: prior-uniformity chi2 p={p:.2e} (tau={tau:.0f})"


def test_geweke_detects_a_doubled_b_draw():
    ma, xs, _, _ = _run(_BrokenEnsemble, P=32, sweeps=200, seed=5)
    i = next(i for i, nm in enumerate(ma.param_names) if "log10_A" in nm)
    z, tau = _prior_z(xs[:, :, i], *LOG10A)
    print(f"broken b draw: log10_A z={z:.2f} tau={tau:.1f}")
    assert abs(z) > 6.0, (
        f"broken kernel not detected: log10_A prior-mean z={z:.2f} "
        f"(tau={tau:.0f}): the Geweke gates lack power")
