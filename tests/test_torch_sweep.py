"""The port's sampler, ``TorchGibbs``, against the JAX package (CPU).

- deterministic: one full sweep of ``TorchGibbs._sweep(state, draws)`` on
  the flagship model with 32 chains against the JAX stage functions
  composed with the same draws (``white_mh_loop_xla`` -> ``tnt_products``
  -> ``schur_eliminate`` -> ``hyper_mh_loop_xla`` -> ``robust_precond_draw``
  + block assembly): x, b and the accept rates agree at 1e-4; theta, z,
  alpha and df are checked against a float64 evaluation of their
  conditionals at the JAX side's x and b, given the same fed gamma /
  uniform / Gumbel draws. Every MH decision, z draw and df argmax of the
  fixture sits clear of a tie (float64 replays move the draws away on the
  side already taken);
- in law: ``TorchGibbs(device="cpu")`` and ``JaxGibbs`` on the demo model
  with 5 Fourier components, 64 chains, 300 sweeps (adaptation with
  population covariance for the first 100, discarded as burn-in):
  posterior means of the 3 parameters and of theta agree within 4
  Monte-Carlo standard errors (pooled ESS), and a two-sample KS test on
  chain-thinned draws gives p > 0.01.
- the other three models (gaussian, t, vvh17): the same deterministic
  sweep with the same fed draws and tolerances, from a state of the
  model's structure (gaussian: z = 0, alpha = 1; t: z = 1; vvh17: the
  uniform outlier density theta / pspin), and a few sampled sweeps that
  keep each model's structure with every value finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from scipy.special import gammaln

from gibbs_student_t_tpu.backends.jax_backend import JaxGibbs
from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu.models.pta import ndiag, phiinv_logdet
from gibbs_student_t_tpu.ops import linalg as jlin
from gibbs_student_t_tpu.ops import pallas_hyper as jhyper
from gibbs_student_t_tpu.ops import pallas_white as jwhite
from gibbs_student_t_tpu.ops.tnt import tnt_products as jtnt
from gibbs_student_t_tpu.parallel.diagnostics import ess_per_param
from gibbs_student_t_tpu_torch.backends.torch_backend import (
    ChainState,
    SweepDraws,
    TorchGibbs,
)
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.convert import model_arrays_from_fields
from gibbs_student_t_tpu_torch.ops import hyper_mh as thyper
from gibbs_student_t_tpu_torch.ops import rng
from gibbs_student_t_tpu_torch.ops import white_mh as twhite
from test_torch_host import _fields
from test_torch_kernels import jumps, separate_ties

# The suite runs in parallel workers and these tensors are small: one
# PyTorch CPU thread per worker costs nothing here and leaves the other
# cores to the other workers.
torch.set_num_threads(1)

C = 32


def _norm_pdf(x, var):
    return np.exp(-0.5 * x * x / var) / np.sqrt(2.0 * np.pi * var)


def test_one_sweep_matches_jax_stages(demo_ma):
    _one_sweep_vs_jax_stages(demo_ma, "mixture")


@pytest.mark.parametrize("model", ["gaussian", "t", "vvh17"])
def test_one_sweep_matches_jax_stages_other_models(demo_ma, model):
    _one_sweep_vs_jax_stages(demo_ma, model)


def _one_sweep_vs_jax_stages(ma, model):
    pspin = 0.005 if model == "vvh17" else None
    cfg = GibbsConfig(model=model, vary_df=True, theta_prior="beta",
                      pspin=pspin)
    sampler = TorchGibbs(model_arrays_from_fields(_fields(ma)), cfg,
                         nchains=C, device="cpu")
    rng = np.random.default_rng(77)
    n, m, p = ma.n, ma.m, ma.nparam
    f32 = np.float32
    x = (np.array([-7.5, 4.0, -14.0])
         + rng.normal(0, [0.4, 0.5, 0.3], (C, 3))).astype(f32)
    b = (rng.normal(size=(C, m)) * 0.05).astype(f32)
    z = (rng.random((C, n)) < 0.05).astype(f32)
    alpha = rng.gamma(2.0, 3.0, (C, n)).astype(f32)
    if model == "gaussian":               # no outliers, no auxiliary scales
        z, alpha = np.zeros_like(z), np.ones_like(alpha)
    elif model == "t":                    # every TOA carries a scale
        z = np.ones_like(z)
    df = rng.integers(1, 31, C).astype(f32)
    theta = np.full(C, 0.05, f32)
    T = ma.T.astype(f32)
    y = ma.y.astype(f32)
    tt = torch.from_numpy

    # --- draws ---------------------------------------------------------
    dx_w = jumps(rng, ma.white_indices, 20, p, False, 0.05)[:C]
    dx_h = jumps(rng, ma.hyper_indices, 10, p, True, 0.1)[:C]
    logu_w = np.log(rng.random((C, 20))).astype(f32)
    logu_h = np.log(rng.random((C, 10))).astype(f32)
    xi = rng.normal(size=(C, m)).astype(f32)
    g_theta = rng.gamma(2.0, 1.0, (C, 2)).astype(f32)
    u_z = rng.random((C, n)).astype(f32)
    g_alpha = rng.gamma(2.0, 1.0, (C, 2, n)).astype(f32)
    gumbel = (-np.log(-np.log(rng.random((C, cfg.df_max))))).astype(f32)

    # --- the JAX composition -------------------------------------------
    az = (alpha ** z).astype(f32)
    yred = y[None] - b @ T.T
    y2 = (yred * yred).astype(f32)
    wj = jwhite.build_white_consts(ma)
    logu_w = separate_ties(
        lambda q: twhite.white_ll_lp(q, tt(az).double(), tt(y2).double(),
                                     tt(wj.rows).double(), wj.var,
                                     tt(wj.specs).double()),
        tt(x), tt(dx_w), tt(logu_w)).numpy()
    x1, accw = jwhite.white_mh_loop_xla(x, az, y2, dx_w, logu_w, wj.rows,
                                        wj.specs, wj.var)
    nvec = jnp.asarray(az) * jax.vmap(lambda xx: ndiag(ma, xx, jnp))(
        x1).astype(jnp.float32)
    TNT, d, const = jax.vmap(lambda nv: jtnt(T, y, nv, None))(nvec)
    s_i, v_i = sampler._schur
    ns = len(s_i)
    phiinv1 = jax.vmap(lambda xx: phiinv_logdet(ma, xx, jnp)[0])(x1)
    A = TNT[:, s_i][:, :, s_i] + jax.vmap(jnp.diag)(
        phiinv1[:, s_i].astype(jnp.float32))
    S0, rt, quad_s, logdetA, (La, isd_a, U_B, u_s) = jax.vmap(
        lambda a, bm, c, rs, rv: jlin.schur_eliminate(
            a, bm, c, rs, rv, cfg.jitter, return_factor=True))(
        A, TNT[:, s_i][:, :, v_i], TNT[:, v_i][:, :, v_i], d[:, s_i],
        d[:, v_i])
    hj = jhyper.build_hyper_consts(ma, v_i)
    base = const + 0.5 * (quad_s - logdetA) - 0.5 * hj.logdet_phi_static
    dS0 = jnp.diagonal(S0, axis1=-2, axis2=-1) + hj.phiinv_static
    hops = [tt(np.array(a, f32)) for a in (S0, dS0, rt, base)]
    logu_h = separate_ties(
        lambda q: thyper.hyper_ll_lp(
            q, *(t.double() for t in hops),
            *(tt(a).double() for a in (hj.K, hj.phi_sel, hj.specs)),
            hj.hyp_idx, cfg.jitter),
        tt(np.array(x1)), tt(dx_h), tt(logu_h)).numpy()
    x2, acch = jhyper.hyper_mh_loop_xla(x1, S0, dS0, rt, base, dx_h, logu_h,
                                        hj.K, hj.phi_sel, hj.specs,
                                        hj.hyp_idx, cfg.jitter)
    phiinv2 = jax.vmap(lambda xx: phiinv_logdet(ma, xx, jnp)[0])(
        x2).astype(jnp.float32)
    Sv = S0 + jax.vmap(jnp.diag)(phiinv2[:, v_i])
    jits = (cfg.jitter, 1e-4, 1e-2, 1e-1)
    y_v, isd_v, _ = jax.vmap(lambda s, r, e: jlin.robust_precond_draw(
        s, r, e, jitters=jits))(Sv, rt, xi[:, ns:])
    wty = jnp.einsum("bij,bj->bi", U_B, isd_v * y_v,
                     precision=jax.lax.Precision.HIGHEST)
    y_s = jax.vmap(jlin.backward_solve)(La, u_s + xi[:, :ns] - wty)
    bj = np.zeros((C, m), f32)
    bj[:, s_i] = np.asarray(y_s * isd_a)
    bj[:, v_i] = np.asarray(y_v * isd_v)

    # --- theta / z / alpha / df conditionals in float64 at (x2, bj) ------
    x2n = np.asarray(x2, np.float64)
    resid = y.astype(np.float64)[None] - bj.astype(np.float64) @ T.T
    nvec0 = np.stack([ndiag(ma, xx, np) for xx in x2n])
    if cfg.is_outlier_model:
        th = g_theta[:, 0] / (g_theta[:, 0] + g_theta[:, 1])
        if model == "vvh17":
            top = np.broadcast_to(
                (th / (pspin * float(ma.time_scale)))[:, None], resid.shape)
        else:
            top = th[:, None] * _norm_pdf(resid, alpha * nvec0)
        q = top / (top + (1.0 - th[:, None]) * _norm_pdf(resid, nvec0))
        q = np.where(np.isnan(q), 1.0, q)
        near = np.abs(u_z - q) < 1e-3        # keep z draws clear of ties
        u_z = np.where(near, np.where(u_z < q, q - 1e-2, q + 1e-2),
                       u_z).astype(f32)
        zn = (u_z < q).astype(np.float64)
    else:                                 # theta, z and pout stay
        th, q, zn = theta, np.zeros((C, n)), z.astype(np.float64)
    g = np.where(zn > 0.5, g_alpha[:, 1], g_alpha[:, 0])
    an = (resid ** 2 * zn / nvec0 + df[:, None]) / 2.0 / g
    an = np.where(zn.sum(-1, keepdims=True) >= 1.0, an, alpha)
    grid = np.arange(1, cfg.df_max + 1, dtype=np.float64)
    s = (np.log(an) + 1.0 / an).sum(-1)
    logp = (-(grid / 2.0) * s[:, None] + n * (grid / 2.0) * np.log(grid / 2.0)
            - n * gammaln(grid / 2.0))
    score = np.sort(logp + gumbel, axis=-1)
    best = np.argmax(logp + gumbel, axis=-1)
    # keep the df argmax clear of a tie
    gumbel[np.arange(C), best] += (score[:, -1] - score[:, -2] < 0.1) * 1.0
    dfn = grid[np.argmax(logp + gumbel, axis=-1)]

    # --- the port's sweep --------------------------------------------------
    state = ChainState(
        x=tt(x), b=tt(b), z=tt(z), alpha=tt(alpha), theta=tt(theta),
        df=tt(df), pout=torch.zeros(C, n), acc_white=torch.zeros(C),
        acc_hyper=torch.zeros(C), mh_log_scale=torch.zeros(C, 2),
        mh_cov_chol=torch.zeros(C, 0))
    draws = SweepDraws(*(tt(np.ascontiguousarray(a)) for a in (
        dx_w, logu_w, dx_h, logu_h, xi, g_theta, u_z, g_alpha, gumbel)))
    out = sampler._sweep(state, draws)

    np.testing.assert_array_equal(out.acc_white.numpy(), np.asarray(accw))
    np.testing.assert_array_equal(out.acc_hyper.numpy(), np.asarray(acch))
    assert 0 < float(np.asarray(acch).mean()) < 1
    np.testing.assert_allclose(out.x.numpy(), np.asarray(x2), rtol=1e-4)
    np.testing.assert_allclose(out.b.numpy(), bj, rtol=1e-4,
                               atol=1e-4 * np.abs(bj).max())
    np.testing.assert_allclose(out.theta.numpy(), th, rtol=1e-6)
    np.testing.assert_array_equal(out.z.numpy(), zn)
    if cfg.is_outlier_model:              # both outcomes of the z draw occur
        assert 0.0 < zn.mean() < 1.0, zn.mean()
    np.testing.assert_allclose(out.pout.numpy(), q, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out.alpha.numpy(), an, rtol=1e-3)
    np.testing.assert_array_equal(out.df.numpy(), dfn)


def test_draws_are_state_shaped():
    ma = model_arrays_from_fields(_fields(jax_demo_model_arrays(
        components=5)))
    cfg = GibbsConfig(model="mixture").with_adapt(10, adapt_cov=True)
    s = TorchGibbs(ma, cfg, nchains=8, device="cpu")
    st = s._prop_cov_update(s.init_state(seed=1))
    keys, sweep = rng.chain_keys(0, range(8)), torch.tensor(0)
    dr = s._draw(keys, sweep, st)
    assert dr.dx_w.shape == (8, 20, 3) and dr.dx_h.shape == (8, 10, 3)
    # population-covariance jumps stay inside each block's coordinates
    assert not dr.dx_w[..., list(ma.hyper_indices)].any()
    assert not dr.dx_h[..., list(ma.white_indices)].any()
    assert dr.g_alpha.shape == (8, 2, ma.n) and (dr.g_alpha > 0).all()
    # the same keys and sweep give the same draws
    for a, b_ in zip(dr, s._draw(keys.clone(), sweep.clone(), st)):
        assert torch.equal(a, b_)



@pytest.mark.parametrize("model", ["gaussian", "t", "vvh17"])
def test_other_models_keep_their_structure(model):
    """The other three likelihood models are config switches over the same
    conditionals: a few sweeps keep each one's structure (gaussian: no
    outliers, alpha and theta untouched; t: z = 1 everywhere, alpha
    drawn; vvh17: outlier probabilities in [0, 1], z binary) with every
    recorded value finite."""
    ma = model_arrays_from_fields(_fields(jax_demo_model_arrays(
        components=5)))
    cfg = GibbsConfig(model=model, vary_df=True,
                      pspin=0.005 if model == "vvh17" else None)
    res = TorchGibbs(ma, cfg, nchains=8, device="cpu").sample(niter=20,
                                                              seed=3)
    for arr in (res.chain, res.bchain, res.alphachain, res.thetachain,
                res.dfchain, res.poutchain):
        assert np.isfinite(arr).all()
    if model == "gaussian":
        assert not res.zchain.any()
        assert (res.alphachain == 1.0).all()
        assert (res.thetachain == cfg.outlier_mean).all()
    elif model == "t":
        assert (res.zchain == 1.0).all()
        assert (res.alphachain[1:] != 1.0).any()
    else:
        assert ((res.poutchain >= 0.0) & (res.poutchain <= 1.0)).all()
        assert np.isin(res.zchain, (0.0, 1.0)).all()
        assert res.zchain[1:].any()
        assert (res.thetachain[1:] != res.thetachain[0]).any()

def _thin_for_ks(chain, ess):
    """Every chain's draws thinned to about one per autocorrelation time,
    pooled, so the KS test sees roughly independent samples."""
    rows = chain.shape[0]
    step = max(1, int(np.ceil(rows * chain.shape[1] / max(ess, 1.0))))
    return chain[::-1][::step].reshape(-1)


def test_sampler_agrees_in_law_with_jax():
    niter, burn, nch = 300, 100, 64
    ma = jax_demo_model_arrays(components=5)
    jcfg = JaxConfig(model="mixture", vary_df=True,
                     theta_prior="beta").with_adapt(burn, adapt_cov=True)
    tcfg = GibbsConfig(model="mixture", vary_df=True,
                       theta_prior="beta").with_adapt(burn, adapt_cov=True)
    rj = JaxGibbs(ma, jcfg, nchains=nch, record="full",
                  telemetry=False).sample(niter=niter, seed=5)
    rt = TorchGibbs(model_arrays_from_fields(_fields(ma)), tcfg,
                    nchains=nch, device="cpu").sample(niter=niter, seed=6)
    assert np.isfinite(rt.chain).all() and np.isfinite(rt.bchain).all()
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
