"""One float64 sweep of the port against the JAX package's float64
stages, and float64 runs (CPU; JAX in x64 mode, restored after each test).

- one sweep of ``TorchGibbs(dtype=torch.float64)`` and of
  ``EnsembleGibbs(dtype=torch.float64)`` (4 pulsars x 8 chains) against
  the JAX package's float64 stages (the MH loops on the port's float64
  constants, which are JAX's before their float32 rounding) fed the same
  draws: accept counts, z and df equal, x and theta to rtol 1e-10, b,
  alpha and pout to rtol 1e-9 (b's atol and the others' at the same
  fraction of the field's largest value);
- float64 runs return float64 chains, ``record="compact8"`` bit for bit
  ``"full"`` (no wire cast narrows a float64 run, as in JAX), and a JAX
  float64 state crosses as float64.

Draws are kept clear of ties by float64 replays: MH draws at least 1e-8
of their decision, z draws 1e-5, df maxima 0.1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy.special import gammaln

from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu.models.pta import ndiag, phiinv_logdet
from gibbs_student_t_tpu.ops import linalg as jlin
from gibbs_student_t_tpu.ops import pallas_hyper as jhyper
from gibbs_student_t_tpu.ops import pallas_white as jwhite
from gibbs_student_t_tpu.ops.tnt import tnt_products as jtnt
from gibbs_student_t_tpu_torch.backends.torch_backend import (
    ChainState,
    SweepDraws,
    TorchGibbs,
)
from gibbs_student_t_tpu_torch.convert import chain_state_from_arrays
from gibbs_student_t_tpu_torch.ops import hyper_mh as thyper
from gibbs_student_t_tpu_torch.ops import white_mh as twhite
from gibbs_student_t_tpu_torch.parallel import EnsembleGibbs
from test_torch_float64 import F64, _cfg, _port, _separate, tt
from test_torch_float64 import x64  # noqa: F401  (the fixture)
from test_torch_kernels import acc_counts, jumps

torch.set_num_threads(1)


# --- one sweep against the JAX package's float64 stages ---------------------

def _state_and_draws(rng_, ma, cfg, C, hyper_scale=0.1):
    """A float64 state near the posterior and one sweep's raw draws (the
    hyper block's dense jumps of ``hyper_scale``)."""
    n, m, p = ma.n, ma.m, ma.nparam
    st = dict(
        x=np.array([-7.5, 4.0, -14.0]) + rng_.normal(0, [0.4, 0.5, 0.3],
                                                     (C, 3)),
        b=rng_.normal(size=(C, m)) * 0.05,
        z=(rng_.random((C, n)) < 0.05).astype(F64),
        alpha=rng_.gamma(2.0, 3.0, (C, n)),
        df=rng_.integers(1, 31, C).astype(F64), theta=np.full(C, 0.05))
    dr = dict(
        dx_w=jumps(rng_, ma.white_indices, 20, p, False, 0.05,
                   C=C).astype(F64),
        logu_w=np.log(rng_.random((C, 20))),
        dx_h=jumps(rng_, ma.hyper_indices, 10, p, True, hyper_scale,
                   C=C).astype(F64),
        logu_h=np.log(rng_.random((C, 10))), xi=rng_.normal(size=(C, m)),
        g_theta=rng_.gamma(2.0, 1.0, (C, 2)), u_z=rng_.random((C, n)),
        g_alpha=rng_.gamma(2.0, 1.0, (C, 2, n)),
        gumbel_df=-np.log(-np.log(rng_.random((C, cfg.df_max)))))
    return st, dr


def _jax_stages(jma, ma, cfg, schur, st, dr):
    """The JAX package's float64 stages of one mixture sweep from ``st``
    with the draws ``dr`` (the float64 MH loops on the port's float64
    constants, which are JAX's before their float32 rounding): the draws
    with every decision kept clear of a tie, and the sweep's expected
    fields."""
    dr = dict(dr)
    s_i, v_i = schur
    ns = len(s_i)
    T, y = ma.T, ma.y
    x, b, z, alpha = st["x"], st["b"], st["z"], st["alpha"]
    C, m = b.shape
    az = alpha ** z
    yred = y[None] - b @ T.T
    y2 = yred * yred
    wc = twhite.build_white_consts(ma, None, dtype=F64)
    dr["logu_w"] = _separate(
        lambda q: twhite.white_ll_lp(q, tt(az), tt(y2), tt(wc.rows), wc.var,
                                     tt(wc.specs)),
        x, dr["dx_w"], dr["logu_w"])
    x1, accw = jwhite.white_mh_loop_xla(x, az, y2, dr["dx_w"], dr["logu_w"],
                                        wc.rows, wc.specs, wc.var)
    nvec = jnp.asarray(az) * jax.vmap(lambda xx: ndiag(jma, xx, jnp))(x1)
    TNT, d, const = jax.vmap(lambda nv: jtnt(T, y, nv, None))(nvec)
    phiinv1 = jax.vmap(lambda xx: phiinv_logdet(jma, xx, jnp)[0])(x1)
    A = TNT[:, s_i][:, :, s_i] + jax.vmap(jnp.diag)(phiinv1[:, s_i])
    S0, rt, quad_s, logdetA, (La, isd_a, U_B, u_s) = jax.vmap(
        lambda a, bm, c, rs, rv: jlin.schur_eliminate(
            a, bm, c, rs, rv, cfg.jitter, return_factor=True))(
        A, TNT[:, s_i][:, :, v_i], TNT[:, v_i][:, :, v_i], d[:, s_i],
        d[:, v_i])
    hc = thyper.build_hyper_consts(ma, v_i, dtype=F64)
    base = const + 0.5 * (quad_s - logdetA) - 0.5 * hc.logdet_phi_static
    dS0 = jnp.diagonal(S0, axis1=-2, axis2=-1) + hc.phiinv_static
    hops = [np.array(a) for a in (S0, dS0, rt, base)]
    dr["logu_h"] = _separate(
        lambda q: thyper.hyper_ll_lp(
            q, *(tt(a) for a in hops),
            *(tt(a) for a in (hc.K, hc.phi_sel, hc.specs)), hc.hyp_idx,
            cfg.jitter),
        np.asarray(x1), dr["dx_h"], dr["logu_h"])
    x2, acch = jhyper.hyper_mh_loop_xla(x1, S0, dS0, rt, base, dr["dx_h"],
                                        dr["logu_h"], hc.K, hc.phi_sel,
                                        hc.specs, hc.hyp_idx, cfg.jitter)
    phiinv2 = jax.vmap(lambda xx: phiinv_logdet(jma, xx, jnp)[0])(x2)
    Sv = S0 + jax.vmap(jnp.diag)(phiinv2[:, v_i])
    y_v, isd_v, _ = jax.vmap(lambda s, r, e: jlin.robust_precond_draw(
        s, r, e, jitters=(cfg.jitter, 1e-4, 1e-2, 1e-1)))(
        Sv, rt, dr["xi"][:, ns:])
    wty = jnp.einsum("bij,bj->bi", U_B, isd_v * y_v,
                     precision=jax.lax.Precision.HIGHEST)
    y_s = jax.vmap(jlin.backward_solve)(La, u_s + dr["xi"][:, :ns] - wty)
    bj = np.zeros((C, m))
    bj[:, s_i] = np.asarray(y_s * isd_a)
    bj[:, v_i] = np.asarray(y_v * isd_v)
    # theta / z / alpha / df, the reference's conditionals in numpy
    x2n = np.asarray(x2)
    resid = y[None] - bj @ T.T
    nvec0 = np.stack([ndiag(jma, xx, np) for xx in x2n])
    g = dr["g_theta"]
    th = g[:, 0] / (g[:, 0] + g[:, 1])

    def norm_pdf(r, var):
        return np.exp(-0.5 * r * r / var) / np.sqrt(2.0 * np.pi * var)

    top = th[:, None] * norm_pdf(resid, alpha * nvec0)
    q = top / (top + (1.0 - th[:, None]) * norm_pdf(resid, nvec0))
    q = np.where(np.isnan(q), 1.0, q)
    u_z = dr["u_z"]
    near = np.abs(u_z - q) < 1e-5
    dr["u_z"] = np.where(near, np.where(u_z < q, q - 1e-4, q + 1e-4), u_z)
    zn = (dr["u_z"] < q).astype(F64)
    ga = np.where(zn > 0.5, dr["g_alpha"][:, 1], dr["g_alpha"][:, 0])
    an = (resid ** 2 * zn / nvec0 + st["df"][:, None]) / 2.0 / ga
    an = np.where(zn.sum(-1, keepdims=True) >= 1.0, an, alpha)
    grid = np.arange(1, cfg.df_max + 1, dtype=F64)
    n = ma.n
    s = (np.log(an) + 1.0 / an).sum(-1)
    logp = (-(grid / 2.0) * s[:, None] + n * (grid / 2.0) * np.log(grid / 2.0)
            - n * gammaln(grid / 2.0))
    gum = dr["gumbel_df"].copy()
    score = np.sort(logp + gum, axis=-1)
    best = np.argmax(logp + gum, axis=-1)
    gum[np.arange(C), best] += (score[:, -1] - score[:, -2] < 0.1) * 1.0
    dr["gumbel_df"] = gum
    want = dict(x=np.asarray(x2), b=bj, theta=th, z=zn, alpha=an, pout=q,
                df=grid[np.argmax(logp + gum, axis=-1)],
                acc_white=np.asarray(accw), acc_hyper=np.asarray(acch))
    return dr, want


def _port_state(st, C, n):
    return ChainState(
        **{k: tt(np.ascontiguousarray(v)) for k, v in st.items()},
        pout=torch.zeros(C, n, dtype=torch.float64),
        acc_white=torch.zeros(C, dtype=torch.float64),
        acc_hyper=torch.zeros(C, dtype=torch.float64),
        mh_log_scale=torch.zeros(C, 2, dtype=torch.float64),
        mh_cov_chol=torch.zeros(C, 0, dtype=torch.float64))


def _port_draws(dr):
    return SweepDraws(*(tt(np.ascontiguousarray(dr[f]))
                        for f in SweepDraws._fields[:9]))


def _assert_sweep(out, want):
    """The port's sweep against the JAX stages' fields."""
    for f in ("acc_white", "acc_hyper"):
        np.testing.assert_array_equal(
            acc_counts(getattr(out, f), 20 if f == "acc_white" else 10),
            acc_counts(want[f], 20 if f == "acc_white" else 10), err_msg=f)
    for f in ("z", "df"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), want[f],
                                      err_msg=f)
    for f, tol in (("x", 1e-10), ("theta", 1e-10), ("b", 1e-9),
                   ("alpha", 1e-9), ("pout", 1e-9)):
        got = getattr(out, f)
        assert got.dtype == torch.float64, f
        np.testing.assert_allclose(got.numpy(), want[f], rtol=tol,
                                   atol=tol * np.abs(want[f]).max(),
                                   err_msg=f)


def _mixed(wants):
    """Both outcomes of the hyper block's steps and of the z draw occur."""
    acc = np.concatenate([w["acc_hyper"].ravel() for w in wants])
    z = np.concatenate([w["z"].ravel() for w in wants])
    assert 0 < acc.mean() < 1 and 0 < z.mean() < 1


def test_one_sweep_matches_jax_stages_in_float64(demo_ma, x64):
    C = 16
    cfg = _cfg()
    ma = _port(demo_ma)
    smp = TorchGibbs(ma, cfg, nchains=C, device="cpu", dtype=torch.float64)
    st, dr = _state_and_draws(np.random.default_rng(77), ma, cfg, C)
    dr, want = _jax_stages(demo_ma, ma, cfg, smp._schur, st, dr)
    out = smp._sweep(_port_state(st, C, ma.n), _port_draws(dr))
    _assert_sweep(out, want)
    _mixed([want])


def test_one_ensemble_sweep_matches_jax_stages_in_float64(x64):
    P, C = 4, 8
    cfg = _cfg()
    jmas = [jax_demo_model_arrays(n=40, components=5, seed=100 + i)
            for i in range(P)]
    mas = [_port(jma) for jma in jmas]
    e = EnsembleGibbs(mas, cfg, nchains=C, device="cpu", dtype=torch.float64)
    assert e.dtype == torch.float64 and e._schur is not None
    rng_ = np.random.default_rng(5)
    # the small pulsars' hyper posterior is wide: longer jumps, so that
    # some steps reject
    per = [_state_and_draws(rng_, ma, cfg, C, hyper_scale=1.0)
           for ma in mas]
    per = [(st,) + _jax_stages(jma, ma, cfg, e._schur, st, dr)
           for jma, ma, (st, dr) in zip(jmas, mas, per)]
    st = ChainState(*(torch.stack(f) for f in zip(
        *(_port_state(s, C, mas[0].n) for s, _, _ in per))))
    dr = SweepDraws(*(torch.stack(f) for f in zip(
        *(_port_draws(d)[:9] for _, d, _ in per))))
    out = e._sweep(st, dr)
    for p, (_, _, want) in enumerate(per):
        _assert_sweep(ChainState(*(f[p] for f in out)), want)
    _mixed([want for _, _, want in per])


# --- runs, records and draws --------------------------------------------------

def test_float64_runs_return_float64_and_compact8_is_full():
    jma = jax_demo_model_arrays(components=5)
    ma = _port(jma)
    cfg = _cfg().with_adapt(10, adapt_cov=True)
    runs = {rec: TorchGibbs(ma, cfg, nchains=8, device="cpu", chunk_size=10,
                            record=rec, dtype=torch.float64).sample(
                                niter=20, seed=4)
            for rec in ("full", "compact8")}
    for f in dataclasses.fields(runs["full"]):
        if f.name == "stats":
            continue
        a, b = getattr(runs["full"], f.name), getattr(runs["compact8"],
                                                      f.name)
        assert a.dtype == np.float64, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert np.isfinite(runs["full"].chain).all()
    # and the ensemble's
    res = EnsembleGibbs([ma, _port(jax_demo_model_arrays(
        n=120, components=5, seed=7))], cfg, nchains=4, device="cpu",
        chunk_size=10, dtype=torch.float64).sample(10, seed=2)
    assert res.chain.dtype == np.float64 and res.bchain.dtype == np.float64
    assert np.isfinite(res.chain).all()
    # a state crosses in the dtype asked for, float32 unless told
    arrs = {f: np.zeros((2, 3)) for f in ("x", "b", "z", "alpha", "pout")}
    arrs.update({f: np.zeros(2) for f in ("theta", "df", "acc_white",
                                          "acc_hyper")})
    assert chain_state_from_arrays(arrs, device="cpu").x.dtype == \
        torch.float32
    assert chain_state_from_arrays(arrs, device="cpu",
                                   dtype=torch.float64).b.dtype == \
        torch.float64
