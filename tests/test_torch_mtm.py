"""The port's multiple-try Metropolis (MTM) against the JAX package (CPU).

- white block: ``white_mtm`` (on the CPU its plain version,
  ``white_mtm_loop``) against ``pallas_white.white_mtm_loop_xla`` on the
  flagship demo model, 32 chains, S = 20 steps, K = 4 tries, one-hot and
  dense jumps, and against the Pallas kernel ``white_mtm_fused`` in
  interpret mode at 8 chains. Per-chain accept counts are equal and x
  agrees to 1e-5 relative, on draws whose decisions sit clear of ties (a
  float64 replay moves any Gumbel selection within 1e-3 of its runner-up,
  and any accept within 1e-3 of its threshold, away on the side already
  taken);
- a step whose candidates all lie outside the prior rejects, and so does
  a chain whose every weight is -inf (a NaN delta), on both sides;
- the sampler: ``TorchGibbs`` and ``JaxGibbs`` with ``with_mtm(4)`` on both
  blocks, demo model with 5 Fourier components, 64 chains, 200 sweeps
  (population-covariance adaptation for the first 60, discarded as
  burn-in): posterior means of the 3 parameters and theta within 4
  Monte-Carlo standard errors, two-sample KS on chain-thinned draws
  p > 0.01.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from gibbs_student_t_tpu.backends.jax_backend import JaxGibbs
from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu.ops import pallas_white as jwhite
from gibbs_student_t_tpu.parallel.diagnostics import ess_per_param
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.convert import model_arrays_from_fields
from gibbs_student_t_tpu_torch.ops import white_mh as twhite
from gibbs_student_t_tpu_torch.testing import separate_mtm_ties
from test_torch_host import _fields
from test_torch_kernels import acc_counts, jumps, near_posterior
from test_torch_sweep import _thin_for_ks

torch.set_num_threads(1)

S, K = 20, 4


def _operands(ma, rng, C, dense, steps=S):
    """Flagship white-block operands and MTM draws for ``C`` chains, with
    the float64 replay's ties separated."""
    wc = twhite.build_white_consts(model_arrays_from_fields(_fields(ma)))
    x, az = near_posterior(rng, ma)
    x, az = x[:C], az[:C]
    b = (rng.normal(size=(C, ma.m)) * 0.05).astype(np.float32)
    yred = ma.y.astype(np.float32)[None] - b @ ma.T.astype(np.float32).T
    y2 = (yred * yred).astype(np.float32)
    dx = jumps(rng, ma.white_indices, steps * K, 3, dense, 0.05)[:C].reshape(
        C, steps, K, 3)
    dxr = jumps(rng, ma.white_indices, steps * (K - 1), 3, dense,
                0.05)[:C].reshape(C, steps, K - 1, 3)
    tt = torch.from_numpy
    gumb = tt(rng.gumbel(size=(C, steps, K)).astype(np.float32))
    logu = tt(np.log(rng.random((C, steps))).astype(np.float32))
    gumb, logu = separate_mtm_ties(_weight64(az, y2, wc), tt(x), tt(dx),
                                   tt(dxr), gumb, logu)
    return (x, az, y2, dx, dxr, gumb.numpy(), logu.numpy()), wc


def _weight64(az, y2, wc):
    az64, y264 = torch.from_numpy(az).double(), torch.from_numpy(y2).double()
    rows64 = torch.from_numpy(wc.rows).double()
    specs64 = torch.from_numpy(wc.specs).double()

    def weight(q):
        ll, lp = twhite.white_ll_lp(q, az64[:, None], y264[:, None], rows64,
                                    wc.var, specs64)
        return ll + lp

    return weight


def _port(args, wc):
    tt = torch.from_numpy
    return twhite.white_mtm(*(tt(np.ascontiguousarray(a)) for a in args),
                            tt(wc.rows), tt(wc.specs), wc.var)


@pytest.mark.parametrize("dense", [False, True])
def test_white_mtm_vs_jax(demo_ma, dense):
    args, wc = _operands(demo_ma, np.random.default_rng(11 + dense), 32,
                         dense)
    xt, acct = _port(args, wc)
    xj, accj = jwhite.white_mtm_loop_xla(*(jnp.asarray(a) for a in args),
                                         wc.rows, wc.specs, wc.var)
    nt = acc_counts(acct, S)
    np.testing.assert_array_equal(nt, acc_counts(accj, S))
    assert 0 < nt.sum() < 32 * S
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5)
    assert twhite.white_mtm.launches == 0


def test_white_mtm_vs_pallas_interpret(demo_ma):
    steps = 5
    args, wc = _operands(demo_ma, np.random.default_rng(13), 8, True,
                         steps=steps)
    xt, acct = _port(args, wc)
    xk, acck = jwhite.white_mtm_fused(
        *(jnp.asarray(a)[None] for a in args), jnp.asarray(wc.rows)[None],
        jnp.asarray(wc.specs)[None], wc.var, chain_tile=8, interpret=True)
    nt = acc_counts(acct, steps)
    np.testing.assert_array_equal(nt, acc_counts(acck[0], steps))
    assert 0 < nt.sum() < 8 * steps
    np.testing.assert_allclose(xt.numpy(), np.asarray(xk[0]), rtol=1e-5)


def test_dead_weights_reject(demo_ma):
    """Zero jumps except at step 2 of chains 0-3, whose candidates all lie
    outside the prior there (all K weights -inf: num = -inf, never an
    accept); every other step proposes the current point K times, a delta
    of 0 up to roundoff, and accepts (logu = -1). Chain 4 starts outside the
    prior (every weight of every step -inf: a NaN delta, never an
    accept)."""
    rng = np.random.default_rng(17)
    (x, az, y2, dx, dxr, gumb, logu), wc = _operands(demo_ma, rng, 8, True)
    dx[:] = 0.0
    dxr[:] = 0.0
    logu[:] = -1.0
    dx[:4, 2, :, 0] = 100.0
    x[4, 0] = 100.0
    args = (x, az, y2, dx, dxr, gumb, logu)
    xt, acct = _port(args, wc)
    xj, accj = jwhite.white_mtm_loop_xla(*(jnp.asarray(a) for a in args),
                                         wc.rows, wc.specs, wc.var)
    nt = acc_counts(acct, S)
    np.testing.assert_array_equal(nt, acc_counts(accj, S))
    np.testing.assert_array_equal(nt, [S - 1] * 4 + [0] + [S] * 3)
    np.testing.assert_array_equal(xt.numpy(), x)
    np.testing.assert_array_equal(np.asarray(xj), x)


def test_mtm_sampler_agrees_in_law_with_jax():
    niter, burn, nch = 200, 60, 64
    ma = jax_demo_model_arrays(components=5)
    jcfg = JaxConfig(model="mixture", vary_df=True, theta_prior="beta"
                     ).with_adapt(burn, adapt_cov=True).with_mtm(K)
    tcfg = GibbsConfig(model="mixture", vary_df=True, theta_prior="beta"
                       ).with_adapt(burn, adapt_cov=True).with_mtm(K)
    rj = JaxGibbs(ma, jcfg, nchains=nch, record="full",
                  telemetry=False).sample(niter=niter, seed=5)
    rt = TorchGibbs(model_arrays_from_fields(_fields(ma)), tcfg,
                    nchains=nch, device="cpu").sample(niter=niter, seed=6)
    assert np.isfinite(rt.chain).all() and np.isfinite(rt.bchain).all()
    for blk in ("white", "hyper"):
        acc = rt.stats[f"acc_{blk}"][burn:]
        assert 0.1 < acc.mean() < 0.9, (blk, acc.mean())
    cols = [(rj.chain[burn:, :, k], rt.chain[burn:, :, k], name)
            for k, name in enumerate(ma.param_names)]
    cols.append((rj.thetachain[burn:], rt.thetachain[burn:], "theta"))
    for a, b_, name in cols:
        ess_a = float(ess_per_param(a[..., None])[0])
        ess_b = float(ess_per_param(b_[..., None])[0])
        se = np.sqrt(a.var() / ess_a + b_.var() / ess_b)
        diff = abs(a.mean() - b_.mean())
        assert diff < 4.0 * se, (name, a.mean(), b_.mean(), se)
        ks = stats.ks_2samp(_thin_for_ks(a, ess_a), _thin_for_ks(b_, ess_b))
        assert ks.pvalue > 0.01, (name, ks)
