"""The port's host-side diagnostics, health verdicts and posterior
analysis, against the JAX package's modules (CPU, numpy only).

- ``parallel/diagnostics.py``: every function on the same windows
  (random walks, a constant column, a recycled-row mask) equal to the JAX
  module's, as one parametrised test;
- ``obs/health.py``: ``chain_health`` and ``format_health`` on the same
  telemetry stats and windows (ok / stuck / dead / diverged chains, every
  chain diverged, a zero-row window, missing optional keys, no telemetry)
  equal to JAX's;
- ``analysis.py``: every numeric function on the same ``ChainResult``
  equal to JAX's, and the plots write their files.

These mirror tests/test_obs.py (health, batched R-hat) and
tests/test_analysis.py.
"""

import dataclasses

import numpy as np
import pytest

from gibbs_student_t_tpu import analysis as janalysis
from gibbs_student_t_tpu.backends.base import ChainResult as JaxChainResult
from gibbs_student_t_tpu.obs import health as jhealth
from gibbs_student_t_tpu.parallel import diagnostics as jdiag
from gibbs_student_t_tpu_torch import analysis
from gibbs_student_t_tpu_torch.backends.base import ChainResult
from gibbs_student_t_tpu_torch.convert import model_arrays_from_fields
from gibbs_student_t_tpu_torch.obs import health
from gibbs_student_t_tpu_torch.parallel import diagnostics as diag
from test_torch_host import _fields


def _window(rows=64, nchains=6, p=3, seed=0):
    """(rows, nchains, p) AR(1) random walks with chain offsets, one
    constant column (chain 1, the last parameter) and float32-rounded
    values in the first parameter."""
    rng = np.random.default_rng(seed)
    w = np.zeros((rows, nchains, p))
    for t in range(1, rows):
        w[t] = 0.8 * w[t - 1] + rng.standard_normal((nchains, p))
    w += rng.normal(0, 0.3, (1, nchains, p))
    w[:, 1, -1] = 1.234
    w[:, :, 0] = w[:, :, 0].astype(np.float32)
    return w


ROW_CLASS = np.tile([0, 1, 2, 0], 16)

DIAG_CASES = {
    "autocorr_time_batch": lambda m, w: m.autocorr_time_batch(
        w.reshape(w.shape[0], -1)),
    "autocorr_time_batch_c3": lambda m, w: m.autocorr_time_batch(
        w.reshape(w.shape[0], -1), c=3.0),
    "autocorr_time": lambda m, w: m.autocorr_time(w[:, 0, 0]),
    "autocorr_time_constant": lambda m, w: m.autocorr_time(w[:, 1, -1]),
    "ess_per_param": lambda m, w: m.ess_per_param(w),
    "ess_per_param_row_class": lambda m, w: m.ess_per_param(
        w, row_class=ROW_CLASS),
    "effective_sample_size_1d": lambda m, w: m.effective_sample_size(
        w[:, 0, 0]),
    "effective_sample_size_2d": lambda m, w: m.effective_sample_size(
        w[..., 0]),
    "gelman_rubin_per_param": lambda m, w: m.gelman_rubin_per_param(w),
    "gelman_rubin": lambda m, w: m.gelman_rubin(w[..., 0]),
    "split_rhat_per_param": lambda m, w: m.split_rhat_per_param(w),
    "split_rhat_per_param_row_class": lambda m, w: m.split_rhat_per_param(
        w, row_class=ROW_CLASS),
    "split_rhat": lambda m, w: m.split_rhat(w[..., 1]),
}


@pytest.mark.parametrize("case", sorted(DIAG_CASES))
def test_diagnostics_match_jax(case):
    w = _window()
    got = DIAG_CASES[case](diag, w)
    want = DIAG_CASES[case](jdiag, w)
    assert type(got) is type(want)
    np.testing.assert_array_equal(got, want)


def test_diagnostics_names_and_row_class_constant():
    from gibbs_student_t_tpu.parallel.recycle import ROW_SCAN_END

    assert diag.ROW_SCAN_END == ROW_SCAN_END
    public = {n for n in dir(jdiag) if not n.startswith("_")
              and callable(getattr(jdiag, n)) and n not in ("jax", "jnp")}
    assert public - {n for n in dir(diag)} == {"rhat_collective"}


def _stats(acc_w, acc_h, nonf=None, div=None):
    acc_w = np.asarray(acc_w, np.float32)
    return {"tele_sweeps": np.asarray(20),
            "tele_accept_white": acc_w,
            "tele_accept_hyper": np.asarray(acc_h, np.float32),
            "tele_nonfinite": (np.zeros(acc_w.shape, int) if nonf is None
                               else np.asarray(nonf)),
            "tele_diverged": (np.zeros(acc_w.shape, bool) if div is None
                              else np.asarray(div, bool)),
            "tele_logpost": np.linspace(-3, -1, acc_w.size,
                                        dtype=np.float32).reshape(
                                            acc_w.shape)}


def _health_cases():
    w = _window(rows=32, nchains=4, p=2, seed=1)
    w[:, 2, :] = 1.234                       # dead
    return {
        "ok_stuck_dead": (_stats([0.5, 0.0, 0.5, 0.4],
                                 [0.4, 0.0, 0.4, 0.3]), w),
        "diverged": (_stats([0.5, 0.5, 0.5, 0.4], [0.4, 0.4, 0.4, 0.3],
                            nonf=[0, 3, 0, 0], div=[0, 1, 0, 1]), w),
        "all_diverged": (_stats([0.5] * 4, [0.4] * 4,
                                div=[1, 1, 1, 1]), w),
        "zero_rows": (_stats([0.5] * 4, [0.4] * 4), w[:0]),
        "no_window": (_stats([0.5, 0.005], [0.3, 0.001]), None),
        "ensemble_shape": (_stats([[0.5, 0.0], [0.3, 0.4]],
                                  [[0.4, 0.0], [0.3, 0.2]]), None),
        "missing_optional": ({"tele_diverged": np.zeros(3, bool)}, None),
    }


@pytest.mark.parametrize("case", sorted(_health_cases()))
def test_health_matches_jax(case):
    stats, window = _health_cases()[case]
    got = health.chain_health(stats, window=window)
    want = jhealth.chain_health(stats, window=window)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert health.format_health(got) == jhealth.format_health(want)


def test_health_errors_match_jax():
    for mod in (health, jhealth):
        with pytest.raises(ValueError, match="telemetry"):
            mod.chain_health({})
        with pytest.raises(ValueError, match="window"):
            mod.chain_health(_stats([0.5, 0.5], [0.4, 0.4]),
                             window=np.zeros((8, 3, 2)))


def _fake_result(cls, niter=300, nchains=4, n=20, m=6, p=3, seed=0):
    rng = np.random.default_rng(seed)
    pout = np.zeros((niter, nchains, n))
    pout[..., :3] = 0.97          # three hot TOAs
    pout[..., 3:] = 0.05
    return cls(
        chain=rng.standard_normal((niter, nchains, p)) + [1.0, -2.0, 0.5],
        bchain=rng.standard_normal((niter, nchains, m)),
        zchain=(pout > 0.5).astype(float),
        thetachain=rng.beta(2.0, 18.0, (niter, nchains)),
        alphachain=np.ones((niter, nchains, n)),
        poutchain=pout,
        dfchain=rng.integers(1, 10, (niter, nchains)).astype(float),
        stats={"acc_white": np.full((niter, nchains), 0.3),
               "acc_hyper": np.full((niter, nchains), 0.2)})


ANALYSIS_CASES = {
    "summarize": lambda a, r, ma: dataclasses.astuple(
        a.summarize(r, ["a", "b", "c"])) + (
            a.summarize(r, ["a", "b", "c"]).table(),),
    "summarize_single_chain": lambda a, r, ma: dataclasses.astuple(
        a.summarize(type(r)(**{
            f.name: (getattr(r, f.name)[:, 0] if f.name != "stats"
                     else {}) for f in dataclasses.fields(r)}),
            ["a", "b", "c"])),
    "outlier_probabilities": lambda a, r, ma: a.outlier_probabilities(r),
    "identify_outliers": lambda a, r, ma: a.identify_outliers(r, 0.5),
    "outlier_confusion": lambda a, r, ma: tuple(a.outlier_confusion(
        r, np.r_[np.ones(4), np.zeros(16)]).items()),
    "reconstruct_waveform": lambda a, r, ma: a.reconstruct_waveform(
        r, ma, ndraws=50, seed=3),
    "theta_posterior_check": lambda a, r, ma: a.theta_posterior_check(
        r, 20, 0.1, nbins=12),
    "df_posterior": lambda a, r, ma: a.df_posterior(r, df_max=12),
    "acceptance_report": lambda a, r, ma: tuple(
        a.acceptance_report(r).items()),
}


@pytest.fixture(scope="module")
def waveform_models():
    from gibbs_student_t_tpu.data.demo import make_demo_model_arrays

    jma = make_demo_model_arrays(n=20, components=1, seed=4)
    return jma, model_arrays_from_fields(_fields(jma))


@pytest.mark.parametrize("case", sorted(ANALYSIS_CASES))
def test_analysis_matches_jax(case, waveform_models):
    jma, ma = waveform_models
    m = jma.m
    got = ANALYSIS_CASES[case](analysis, _fake_result(ChainResult, m=m), ma)
    want = ANALYSIS_CASES[case](janalysis, _fake_result(JaxChainResult, m=m),
                                jma)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, str) or a is None:
            assert a == b
        else:
            np.testing.assert_array_equal(np.asarray(a, dtype=object),
                                          np.asarray(b, dtype=object))


def test_plots_write_files(tmp_path, waveform_models):
    pytest.importorskip("matplotlib")
    _, ma = waveform_models
    res = _fake_result(ChainResult, m=ma.m)
    mjds = np.linspace(53000, 54000, 20)
    paths = {k: str(tmp_path / f"{k}.png") for k in
             ("post", "outl", "wave", "corner", "df")}
    analysis.plot_posteriors(res, ["a", "b", "c"], paths["post"],
                             truths={"a": 1.0})
    analysis.plot_outlier_map(res, mjds, paths["outl"],
                              z_true=np.r_[np.ones(3), np.zeros(17)])
    analysis.plot_waveform(res, ma, mjds, paths["wave"])
    analysis.plot_corner(res, ["a", "b", "c"], paths["corner"],
                         truths={"b": -2.0})
    analysis.plot_df_posterior(res, paths["df"], df_max=12)
    for p in paths.values():
        assert (tmp_path / p).stat().st_size > 1000
