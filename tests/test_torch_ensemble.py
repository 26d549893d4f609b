"""The port's multi-pulsar ensemble and its per-sweep keying, against the
JAX package (CPU).

- resumed runs: ``sample(2N)`` equals ``sample(N)`` then ``sample(N,
  state=last_state, start_sweep=N)`` bitwise, for ``TorchGibbs`` and for
  ``EnsembleGibbs``, every recorded field and ``last_state``; the sweep
  key is one-to-one in ``(seed, sweep)`` (the pair (0, 1000003) and
  (1, 0) give different draws);
- stacking: ``pad_model_arrays`` / ``stack_model_arrays`` equal the JAX
  package's field by field, bitwise (row masks and phi blocks included),
  and both raise ``ValueError`` on a different basis size or parameter
  structure;
- grouped blocks: the plain grouped white MH, white MTM and hyper MH
  blocks (G = 3 pulsars' constants) against the JAX per-group XLA loops
  (``white_mh_loop_xla``, ``white_mtm_loop_xla``, ``hyper_mh_loop_xla``):
  x at rtol 1e-5 / atol 1e-6 (white) and 1e-4 / 1e-5 (hyper), accept
  rates equal, on draws kept clear of every tie by a float64 replay;
- one ensemble sweep: with fed draws, pulsar p's slice of the ensemble's
  sweep equals the port's solo ``TorchGibbs`` sweep on JAX's padded pulsar
  p (x and b at rtol 1e-5 / atol 1e-6; accept counts, z and df equal),
  which test_torch_sweep.py holds against the JAX stages; the population
  covariance is estimated per pulsar;
- in law: ``EnsembleGibbs(device="cpu")`` against the JAX package's
  grouped ``EnsembleGibbs(unroll=False)``, 2 pulsars of 5 components, 64
  chains each, 300 sweeps (adapting for the first 100, discarded): per
  pulsar, posterior means of the 3 parameters and of theta within 4
  Monte-Carlo standard errors and KS p > 0.01;
- the sampled result: ``(niter, P, C, ...)`` shapes, ``select_pulsar``
  trimming to ``n_toa``, padded rows pinned (z = 0, alpha = 1, pout = 0),
  every value finite;
- the sampling surface (as tests/test_parallel.py holds the JAX
  ensemble's): compact and compact8 against full (exact fields bitwise,
  b/alpha within half a bfloat16 step, pout within 1/510 or half a
  float16 step, padded rows pinned), ``record_thin`` rows bitwise the
  unthinned run's, telemetry on and off bitwise with ``(P, C)``
  aggregates and each pulsar's log-posterior its solo sampler's,
  ``diverged_mask`` over ``(P, C)`` equal to JAX's with reinit leaving
  healthy populations bitwise, and ``sample_until`` with ``(P, p)`` R-hat
  whose rows are a plain ``sample``'s.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from scipy.special import gammaln

from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu.ops import pallas_hyper as jhyper
from gibbs_student_t_tpu.ops import pallas_white as jwhite
from gibbs_student_t_tpu.parallel import ensemble as jens
from gibbs_student_t_tpu.parallel.diagnostics import ess_per_param
from gibbs_student_t_tpu_torch.backends import torch_backend as tb
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.convert import (
    chain_state_from_arrays,
    model_arrays_from_fields,
)
from gibbs_student_t_tpu_torch.ops import hyper_mh as thyper
from gibbs_student_t_tpu_torch.ops import rng
from gibbs_student_t_tpu_torch.ops import white_mh as twhite
from gibbs_student_t_tpu_torch.parallel import ensemble as tens
from gibbs_student_t_tpu_torch.parallel import EnsembleGibbs
from test_torch_host import _fields
from test_torch_kernels import (
    acc_counts,
    hyper_operands,
    jumps,
    near_posterior,
    separate_mtm_ties,
    separate_ties,
)
from test_torch_sweep import _thin_for_ks

# The suite runs in parallel workers and these tensors are small: one
# PyTorch CPU thread per worker costs nothing here and leaves the other
# cores to the other workers.
torch.set_num_threads(1)

NS = (30, 26, 22)


def _cfg(adapt=0, cov=True):
    cfg = GibbsConfig(model="mixture", vary_df=True, theta_prior="beta")
    return cfg.with_adapt(adapt, adapt_cov=cov) if adapt else cfg


def _jax_pulsars(ns=NS, components=5, seed0=100):
    return [jax_demo_model_arrays(n=n, components=components, seed=seed0 + i)
            for i, n in enumerate(ns)]


def _port(ma):
    return model_arrays_from_fields(_fields(ma))


def _keyed(smp, seed, sweep):
    """``(keys, sweep)`` of ``smp``'s chains in the run ``seed`` at sweep
    ``sweep``: the first two arguments of ``_draw``."""
    return smp._chain_keys(seed), torch.tensor(sweep)


def _assert_results_equal(a, b):
    for f in dataclasses.fields(a):
        if f.name != "stats":
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name), err_msg=f.name)
    for k in ("acc_white", "acc_hyper"):
        np.testing.assert_array_equal(a.stats[k], b.stats[k], err_msg=k)


def _cat(r1, r2):
    return dataclasses.replace(r1, **{
        f.name: np.concatenate([getattr(r1, f.name), getattr(r2, f.name)])
        for f in dataclasses.fields(r1) if f.name != "stats"},
        stats={k: np.concatenate([r1.stats[k], r2.stats[k]])
               for k in ("acc_white", "acc_hyper")})


# --- resumed runs (the per-sweep keying) ------------------------------------

def test_resumed_solo_run_equals_unbroken_run():
    ma = _port(jax_demo_model_arrays(components=5))
    s = TorchGibbs(ma, _cfg(150), nchains=8, device="cpu")
    whole = s.sample(niter=200, seed=4)
    last = s.last_state
    first = s.sample(niter=100, seed=4)
    rest = s.sample(niter=100, seed=4, state=s.last_state, start_sweep=100)
    _assert_results_equal(whole, _cat(first, rest))
    for a, b in zip(last, s.last_state):
        assert torch.equal(a, b)

    # the keying does not collide: (0, 1000003) and (1, 0) differ
    st = s.init_state(seed=2)
    d1 = s._draw(*_keyed(s, 0, 1000003), st)
    d2 = s._draw(*_keyed(s, 1, 0), st)
    assert not torch.equal(d1.dx_w, d2.dx_w)
    assert not torch.equal(d1.xi, d2.xi)
    s.sample(niter=1, seed=0, state=st, start_sweep=1000003)
    b1 = s.last_state.b
    s.sample(niter=1, seed=1, state=st, start_sweep=0)
    assert not torch.equal(b1, s.last_state.b)


def test_sweep_key_is_one_to_one():
    """The per-chain key (ops/rng.chain_key, which took the place of the
    per-sweep generator seed): one-to-one in (seed, chain), two 32-bit
    words, each of which differs too here; out-of-range seeds, chains
    and sweep indices are refused."""
    pairs = [(s, i) for s in (0, 1, 2, 7, 1000003, 2 ** 32 - 1)
             for i in (0, 1, 2, 100, 1000003, 2 ** 32 - 1)]
    keys = [rng.chain_key(s, i) for s, i in pairs]
    assert len(set(keys)) == len(pairs)
    assert all(0 <= w < 2 ** 32 for k in keys for w in k)
    assert len({k[0] for k in keys}) == len({k[1] for k in keys}) == len(
        pairs)
    for bad in ((-1, 0), (0, -1), (2 ** 32, 0), (0, 2 ** 32)):
        with pytest.raises(ValueError):
            rng.chain_key(*bad)
    s = TorchGibbs(_port(jax_demo_model_arrays(components=5)), _cfg(),
                   nchains=2, device="cpu")
    with pytest.raises(ValueError, match="sweep index"):
        s.sample(niter=2, seed=0, start_sweep=2 ** 32 - 1)


def test_resumed_ensemble_run_equals_unbroken_run():
    mas = [_port(ma) for ma in _jax_pulsars()]
    e = EnsembleGibbs(mas, _cfg(30), nchains=8, device="cpu", chunk_size=10)
    whole = e.sample(40, seed=3)
    last = e.last_state
    first = e.sample(20, seed=3)
    rest = e.sample(20, seed=3, state=e.last_state, start_sweep=20)
    _assert_results_equal(whole, _cat(first, rest))
    for a, b in zip(last, e.last_state):
        assert torch.equal(a, b)


# --- stacking ------------------------------------------------------------

def _assert_model_equal(a, b, what):
    """A port model against a JAX one (stacked or not), field by field."""
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if k == "phi_blocks":
            assert len(fa[k]) == len(fb[k]), what
            for i, (ba, bb) in enumerate(zip(fa[k], fb[k])):
                assert ba.keys() == bb.keys(), (what, i)
                for f in ba:
                    np.testing.assert_array_equal(
                        np.asarray(ba[f]), np.asarray(bb[f]),
                        err_msg=f"{what} block {i} {f}")
                    assert np.asarray(ba[f]).dtype == np.asarray(bb[f]).dtype
        elif fb[k] is None:
            assert fa[k] is None, (what, k)
        elif isinstance(fb[k], np.ndarray):
            assert np.asarray(fa[k]).dtype == fb[k].dtype, (what, k)
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{what} {k}")
        else:
            assert fa[k] == fb[k], (what, k)


def test_stacking_matches_jax():
    jmas = _jax_pulsars()
    tmas = [_port(ma) for ma in jmas]
    for a, b in zip(tens.pad_model_arrays(tmas), jens.pad_model_arrays(jmas)):
        _assert_model_equal(a, b, "padded")
    for a, b in zip(tens.localized_padded(tmas),
                    jens.localized_padded(jmas)):
        _assert_model_equal(a, b, "localized")
    st, sj = tens.stack_model_arrays(tmas), jens.stack_model_arrays(jmas)
    _assert_model_equal(st, sj, "stacked")
    assert st.y.shape == (3, 30) and st.row_mask.sum(-1).tolist() == list(NS)
    # a stacked model and its padded pulsars cross from JAX as plain data
    _assert_model_equal(_port(sj), sj, "converted")


def test_stacking_rejects_other_structure():
    jmas = _jax_pulsars((30, 26))
    tmas = [_port(ma) for ma in jmas]
    # another basis size (more Fourier components)
    jm = jax_demo_model_arrays(n=24, components=6, seed=9)
    for mod, mas in ((jens, jmas + [jm]), (tens, tmas + [_port(jm)])):
        with pytest.raises(ValueError):
            mod.stack_model_arrays(mas)
    # another parameter structure (a renamed parameter)
    names = list(jmas[1].param_names)
    names[0] = names[0] + "_x"
    jr = dataclasses.replace(jmas[1], param_names=tuple(names))
    for mod, mas in ((jens, [jmas[0], jr]), (tens, [tmas[0], _port(jr)])):
        with pytest.raises(ValueError):
            mod.stack_model_arrays(mas)
        with pytest.raises(ValueError):
            mod.pad_model_arrays(mas)
    with pytest.raises(ValueError):
        EnsembleGibbs([tmas[0], _port(jr)], _cfg(), nchains=2, device="cpu")


def test_ensemble_needs_cuda_unless_asked_for_cpu():
    mas = [_port(ma) for ma in _jax_pulsars((24, 22))]
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError):
        EnsembleGibbs(mas, _cfg(), nchains=2)


# --- grouped blocks against the JAX per-group loops -----------------------

G = 3


def _group_models(ns=(24, 22, 20), components=4, seed0=20, pad=True):
    """G pulsars with different constants: different TOA counts (padded
    to the largest for the white block, whose TOA axis they share) and
    TOA errors scaled by 1, 1.25 and 1.5."""
    jmas = [jax_demo_model_arrays(n=n, components=components, seed=seed0 + g)
            for g, n in enumerate(ns)]
    jmas = [dataclasses.replace(ma, sigma2=ma.sigma2 * (1.0 + 0.25 * g))
            for g, ma in enumerate(jmas)]
    if pad:
        jmas = jens.pad_model_arrays(jmas)
    return jmas, [_port(ma) for ma in jmas]


def test_grouped_white_mh_vs_jax():
    jmas, tmas = _group_models()
    C, S = 6, 20
    rng = np.random.default_rng(31)
    tt = torch.from_numpy
    per = []
    for jm, tm in zip(jmas, tmas):
        wj = jwhite.build_white_consts(jm, row_mask=jm.row_mask)
        wt = twhite.build_white_consts(tm, tm.row_mask)
        np.testing.assert_array_equal(wt.rows, wj.rows)
        x, az = near_posterior(rng, tm, C)
        b = (rng.normal(size=(C, tm.m)) * 0.05).astype(np.float32)
        yred = tm.y.astype(np.float32)[None] - b @ tm.T.astype(np.float32).T
        y2 = (yred * yred).astype(np.float32)
        dx = jumps(rng, tm.white_indices, S, 3, True, 0.05, C=C)
        logu = separate_ties(
            lambda q: twhite.white_ll_lp(
                q, tt(az).double(), tt(y2).double(), tt(wj.rows).double(),
                wj.var, tt(wj.specs).double()),
            tt(x), tt(dx), torch.log(tt(rng.random((C, S)).astype(
                np.float32)))).numpy()
        per.append((x, az, y2, dx, logu, wj))
    var = per[0][5].var
    assert all(p[5].var == var for p in per)
    grouped = [tt(np.stack([p[i] for p in per])) for i in range(5)]
    rows = tt(np.stack([p[5].rows for p in per]))
    specs = tt(np.stack([p[5].specs for p in per]))
    assert not torch.equal(rows[0], rows[1])
    xg, ag = twhite.white_mh(*grouped, rows, specs, var)
    assert xg.shape == (G, C, 3) and ag.shape == (G, C)
    for g, (x, az, y2, dx, logu, wj) in enumerate(per):
        x0, a0 = jwhite.white_mh_loop_xla(x, az, y2, dx, logu, wj.rows,
                                          wj.specs, wj.var)
        np.testing.assert_allclose(xg[g].numpy(), np.asarray(x0), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(acc_counts(ag[g], S),
                                      acc_counts(np.asarray(a0), S))
    assert 0 < float(ag.mean()) < 1


def test_grouped_white_mtm_vs_jax():
    jmas, tmas = _group_models(seed0=60)
    C, S, K = 6, 20, 4
    rng = np.random.default_rng(71)
    tt = torch.from_numpy
    per = []
    for jm, tm in zip(jmas, tmas):
        wj = jwhite.build_white_consts(jm, row_mask=jm.row_mask)
        x, az = near_posterior(rng, tm, C)
        b = (rng.normal(size=(C, tm.m)) * 0.05).astype(np.float32)
        yred = tm.y.astype(np.float32)[None] - b @ tm.T.astype(np.float32).T
        y2 = (yred * yred).astype(np.float32)
        dx = jumps(rng, tm.white_indices, S * K, 3, True, 0.05, C=C).reshape(
            C, S, K, 3)
        dxr = jumps(rng, tm.white_indices, S * (K - 1), 3, True, 0.05,
                    C=C).reshape(C, S, K - 1, 3)
        gumb = -torch.log(-torch.log(tt(rng.random((C, S, K)).astype(
            np.float32))))
        logu = torch.log(tt(rng.random((C, S)).astype(np.float32)))
        a64, y64 = tt(az).double(), tt(y2).double()
        r64, s64 = tt(wj.rows).double(), tt(wj.specs).double()

        def weight64(q, a64=a64, y64=y64, r64=r64, s64=s64, var=wj.var):
            ll, lp = twhite.white_ll_lp(q, a64[:, None], y64[:, None], r64,
                                        var, s64)
            return ll + lp

        gumb, logu = separate_mtm_ties(weight64, tt(x), tt(dx), tt(dxr),
                                       gumb, logu)
        per.append((x, az, y2, dx, dxr, gumb.numpy(), logu.numpy(), wj))
    var = per[0][7].var
    grouped = [tt(np.stack([p[i] for p in per])) for i in range(7)]
    rows = tt(np.stack([p[7].rows for p in per]))
    specs = tt(np.stack([p[7].specs for p in per]))
    xg, ag = twhite.white_mtm(*grouped, rows, specs, var)
    assert xg.shape == (G, C, 3)
    for g, p in enumerate(per):
        x0, a0 = jwhite.white_mtm_loop_xla(*p[:7], p[7].rows, p[7].specs,
                                           p[7].var)
        np.testing.assert_allclose(xg[g].numpy(), np.asarray(x0), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(acc_counts(ag[g], S),
                                      acc_counts(np.asarray(a0), S))
    assert 0 < float(ag.mean()) < 1


def test_grouped_hyper_mh_vs_jax():
    jmas, tmas = _group_models((30, 28, 26), seed0=40, pad=False)
    C, S = 5, 10
    rng = np.random.default_rng(51)
    tt = torch.from_numpy
    per = []
    for jm, tm in zip(jmas, tmas):
        ops, hc = hyper_operands(tm, rng, C)
        hj = jhyper.build_hyper_consts(jm, np.flatnonzero(
            ~tb.static_phi_columns(tm)))
        np.testing.assert_array_equal(hc.K, hj.K)
        consts = [tt(a) for a in (hc.K, hc.phi_sel, hc.specs)]
        dx = jumps(rng, tm.hyper_indices, S, 3, True, 0.1, C=C)
        logu = separate_ties(
            lambda q: thyper.hyper_ll_lp(
                q, *(t.double() for t in ops[1:]),
                *(t.double() for t in consts), hc.hyp_idx, 1e-6),
            ops[0], tt(dx), torch.log(tt(rng.random((C, S)).astype(
                np.float32))))
        per.append(([t.numpy() for t in ops] + [dx, logu.numpy()], hj))
    hyp_idx = per[0][1].hyp_idx
    grouped = [tt(np.stack([p[0][i] for p in per])) for i in range(7)]
    K, sel, specs = (tt(np.stack([getattr(p[1], f) for p in per]))
                     for f in ("K", "phi_sel", "specs"))
    assert not torch.equal(K[0], K[1])
    xg, ag = thyper.hyper_mh(*grouped, K, sel, specs, hyp_idx, 1e-6)
    assert xg.shape == (G, C, 3)
    for g, (ops, hj) in enumerate(per):
        x0, a0 = jhyper.hyper_mh_loop_xla(*ops, hj.K, hj.phi_sel, hj.specs,
                                          hj.hyp_idx, 1e-6)
        np.testing.assert_allclose(xg[g].numpy(), np.asarray(x0), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(acc_counts(ag[g], S),
                                      acc_counts(np.asarray(a0), S))
        assert acc_counts(ag[g], S)[0] == 0    # the indefinite chain
    assert 0 < float(ag.mean()) < 1


# --- one ensemble sweep against the solo sampler --------------------------

def _capture(monkeypatch, name, run):
    """The operands of the last call of the backend's ``name`` in
    ``run()``."""
    got = {}
    fn = getattr(tb, name)

    def rec(*args, **kw):
        got["args"] = args
        return fn(*args, **kw)

    monkeypatch.setattr(tb, name, rec)
    try:
        run()
    finally:
        monkeypatch.setattr(tb, name, fn)
    return got["args"]


def _separated_draws(monkeypatch, solo, st, dr, sweep):
    """``dr`` with every MH decision, z draw and df argmax of the solo
    sweep moved clear of a tie (float64 replays on the solo sweep's own
    operands, as test_torch_sweep.py does on the JAX side's)."""
    def run():
        solo._sweep(st, dr, sweep=sweep)

    x, az, y2, dx, lu, rows, specs, var = _capture(monkeypatch, "white_mh",
                                                   run)
    a64 = [t.double() for t in (az, y2, rows, specs)]
    dr = dr._replace(logu_w=separate_ties(
        lambda q: twhite.white_ll_lp(q, *a64[:3], var, a64[3]), x, dx, lu))
    a = _capture(monkeypatch, "hyper_mh", run)
    a64 = [t.double() for t in a[1:5] + a[7:10]]
    dr = dr._replace(logu_h=separate_ties(
        lambda q: thyper.hyper_ll_lp(q, *a64, a[10], a[11]), a[0], a[5],
        a[6]))
    q = solo._sweep(st, dr, sweep=sweep).pout
    near = (dr.u_z - q).abs() < 1e-3
    dr = dr._replace(u_z=torch.where(
        near, torch.where(dr.u_z < q, q - 1e-2, q + 1e-2), dr.u_z))
    alpha = solo._sweep(st, dr, sweep=sweep).alpha.double()
    grid = solo._df_grid.double()
    mask = solo._mask
    s = torch.where(mask, torch.log(alpha) + 1.0 / alpha, 0.0).sum(-1)
    n = float(solo._n_real)
    logp = (-(grid / 2.0) * s[:, None]
            + n * (grid / 2.0) * torch.log(grid / 2.0)
            - n * torch.from_numpy(gammaln(grid.numpy() / 2.0)))
    score = logp + dr.gumbel_df.double()
    top2 = torch.topk(score, 2, dim=-1).values
    best = torch.argmax(score, dim=-1)
    bump = torch.zeros_like(dr.gumbel_df)
    bump[torch.arange(len(best)), best] = (
        (top2[:, 0] - top2[:, 1]) < 0.1).float()
    return dr._replace(gumbel_df=dr.gumbel_df + bump)


def test_one_ensemble_sweep_matches_solo_sweeps(monkeypatch):
    C = 8
    jmas = _jax_pulsars()
    cfg = _cfg(50)
    e = EnsembleGibbs([_port(ma) for ma in jmas], cfg, nchains=C,
                      device="cpu")
    solos = [TorchGibbs(_port(ma), cfg, nchains=C, device="cpu",
                        tnt_block_size=None)
             for ma in jens.localized_padded(jmas)]
    assert [s._n_real for s in solos] == list(NS)
    # a state a few sweeps in, with outliers and adapted proposals
    st = e._prop_cov_update(e.init_state(seed=5))
    for i in range(3):
        st = e._sweep(st, e._draw(*_keyed(e, 5, i), st), sweep=i)
    st = e._prop_cov_update(st)
    # the proposal factors are each pulsar's own population's
    for p, s in enumerate(solos):
        sp = type(st)(*(f[p] for f in st))
        torch.testing.assert_close(s._prop_cov_update(sp).mh_cov_chol,
                                   st.mh_cov_chol[p], rtol=1e-6, atol=0.0)
    draws = []
    for p, s in enumerate(solos):
        sp = type(st)(*(f[p] for f in st))
        dr = s._draw(*_keyed(s, 9, p), sp)
        draws.append(_separated_draws(monkeypatch, s, sp, dr, 3))
    dr_e = type(draws[0])(*(torch.stack(f) for f in zip(*draws)))
    out = e._sweep(st, dr_e, sweep=3)
    nw, nh = cfg.mh.n_white_steps, cfg.mh.n_hyper_steps
    for p, s in enumerate(solos):
        sp = type(st)(*(f[p] for f in st))
        ref = s._sweep(sp, draws[p], sweep=3)
        np.testing.assert_array_equal(acc_counts(out.acc_white[p], nw),
                                      acc_counts(ref.acc_white, nw))
        np.testing.assert_array_equal(acc_counts(out.acc_hyper[p], nh),
                                      acc_counts(ref.acc_hyper, nh))
        for f in ("x", "b"):
            torch.testing.assert_close(getattr(out, f)[p], getattr(ref, f),
                                       rtol=1e-5, atol=1e-6)
        assert torch.equal(out.z[p], ref.z)
        assert torch.equal(out.df[p], ref.df)
        torch.testing.assert_close(out.alpha[p], ref.alpha, rtol=1e-4,
                                   atol=0.0)
    assert 0 < float(out.acc_hyper.mean()) < 1
    assert 0 < float(out.z.mean()) < 1


def test_ensemble_state_crosses_from_jax():
    jmas = _jax_pulsars((24, 22))
    je = jens.EnsembleGibbs(jmas, JaxConfig(model="mixture"), nchains=4,
                            record="full", unroll=False, telemetry=False)
    js = {k: np.asarray(v) for k, v in je.init_state(seed=1)._asdict().items()}
    st = chain_state_from_arrays(js, device="cpu")
    assert st.x.shape == (2, 4, 3) and st.z.shape == (2, 4, 24)
    assert st.mh_log_scale.shape == (2, 4, 2)
    np.testing.assert_array_equal(st.alpha.numpy(), js["alpha"])
    e = EnsembleGibbs([_port(ma) for ma in jmas], GibbsConfig(
        model="mixture"), nchains=4, device="cpu")
    out = e._sweep(st, e._draw(*_keyed(e, 0, 0), st))
    assert torch.isfinite(out.x).all() and torch.isfinite(out.b).all()


# --- in law against the JAX ensemble ---------------------------------------

def test_ensemble_agrees_in_law_with_jax():
    niter, burn, nch = 300, 100, 64
    jmas = _jax_pulsars((130, 120), components=5)
    jcfg = JaxConfig(model="mixture", vary_df=True,
                     theta_prior="beta").with_adapt(burn, adapt_cov=True)
    rj = jens.EnsembleGibbs(jmas, jcfg, nchains=nch, record="full",
                            unroll=False, telemetry=False).sample(
        niter=niter, seed=5)
    rt = EnsembleGibbs([_port(ma) for ma in jmas], _cfg(burn), nchains=nch,
                       device="cpu").sample(niter=niter, seed=6)
    assert rt.chain.shape == rj.chain.shape == (niter, 2, nch, 3)
    assert np.isfinite(rt.chain).all() and np.isfinite(rt.bchain).all()
    names = tens._localize_names(_port(jmas[0])).param_names
    for p in range(2):
        a_p, b_p = rj.select_pulsar(p), rt.select_pulsar(p)
        cols = [(a_p.chain[burn:, :, k], b_p.chain[burn:, :, k], name)
                for k, name in enumerate(names)]
        cols.append((a_p.thetachain[burn:], b_p.thetachain[burn:], "theta"))
        for a, b_, name in cols:
            ess_a = float(ess_per_param(a[..., None])[0])
            ess_b = float(ess_per_param(b_[..., None])[0])
            se = np.sqrt(a.var() / ess_a + b_.var() / ess_b)
            diff = abs(a.mean() - b_.mean())
            assert diff < 4.0 * se, (p, name, a.mean(), b_.mean(), se)
            ks = stats.ks_2samp(_thin_for_ks(a, ess_a),
                                _thin_for_ks(b_, ess_b))
            assert ks.pvalue > 0.01, (p, name, ks)


# --- the sampled result ------------------------------------------------------

@pytest.mark.parametrize("record", ["full", "light"])
def test_sampled_result(record):
    mas = [_port(ma) for ma in _jax_pulsars()]
    e = EnsembleGibbs(mas, _cfg(10), nchains=4, device="cpu", chunk_size=6,
                      record=record)
    r = e.sample(15, seed=2)
    P, C, n = 3, 4, max(NS)
    assert r.chain.shape == (15, P, C, 3)
    assert r.thetachain.shape == r.dfchain.shape == (15, P, C)
    assert r.stats["acc_white"].shape == (15, P, C)
    np.testing.assert_array_equal(r.stats["n_toa"], NS)
    for arr in (r.chain, r.thetachain, r.dfchain, r.bchain, r.zchain,
                r.alphachain, r.poutchain):
        assert np.isfinite(arr).all()
    st = e.last_state
    assert st.x.shape == (P, C, 3) and st.z.shape == (P, C, n)
    for f in st:
        assert torch.isfinite(f).all()
    pad = ~e._mask[:, 0]                                  # (P, n)
    for p in range(P):
        assert not st.z[p][:, pad[p]].any()
        assert (st.alpha[p][:, pad[p]] == 1.0).all()
        assert (st.pout[p][:, pad[p]] == 0.0).all()
    if record == "light":
        assert r.bchain.size == r.zchain.size == 0
        return
    assert r.bchain.shape == (15, P, C, mas[0].m)
    assert r.zchain.shape == r.alphachain.shape == (15, P, C, n)
    for p, n_p in enumerate(NS):
        rp = r.select_pulsar(p)
        assert rp.chain.shape == (15, C, 3)
        assert rp.zchain.shape == rp.alphachain.shape == (15, C, n_p)
        assert int(rp.stats["n_toa"]) == n_p
        assert (r.zchain[:, p, :, n_p:] == 0).all()
        assert (r.alphachain[:, p, :, n_p:] == 1).all()


# --- the sampling surface: record tiers, thinning, recovery, telemetry -------

def _ens(record="full", **kw):
    kw.setdefault("chunk_size", 5)
    return EnsembleGibbs([_port(ma) for ma in _jax_pulsars()], _cfg(),
                         nchains=4, device="cpu", record=record, **kw)


def test_ensemble_compact_tiers_against_full():
    runs = {mode: _ens(mode).sample(10, seed=5)
            for mode in ("full", "compact", "compact8")}
    f = runs["full"]
    assert f.zchain.shape == (10, 3, 4, max(NS))
    for mode in ("compact", "compact8"):
        c = runs[mode]
        assert str(c.stats["record_mode"]) == mode
        for name in ("chain", "thetachain", "dfchain", "zchain"):
            np.testing.assert_array_equal(getattr(c, name),
                                          getattr(f, name), err_msg=name)
        for k in ("acc_white", "acc_hyper", "n_toa"):
            np.testing.assert_array_equal(c.stats[k], f.stats[k])
        for name in ("bchain", "alphachain"):
            a, w = getattr(c, name), getattr(f, name)
            assert (np.abs(a - w) <= np.abs(w) * 2.0 ** -8).all(), name
        tol = (0.5 / 255 + 1e-7 if mode == "compact8"
               else np.abs(f.poutchain) * 2.0 ** -11 + 2.0 ** -25)
        assert (np.abs(c.poutchain - f.poutchain) <= tol).all()
        # padded rows come back pinned through the packed z and the casts
        for p, n_p in enumerate(NS):
            assert (c.zchain[:, p, :, n_p:] == 0).all()
            assert (c.alphachain[:, p, :, n_p:] == 1).all()
            assert c.select_pulsar(p).zchain.shape == (10, 4, n_p)


def test_ensemble_record_thin_and_telemetry():
    full = _ens("full", chunk_size=6).sample(12, seed=3)
    e = _ens("full", chunk_size=6, record_thin=3)
    thin = e.sample(12, seed=3)
    for name in ("chain", "bchain", "zchain", "alphachain", "poutchain",
                 "thetachain", "dfchain"):
        np.testing.assert_array_equal(getattr(thin, name),
                                      getattr(full, name)[::3], err_msg=name)
    assert int(thin.stats["record_thin"]) == 3
    with pytest.raises(ValueError, match="record_thin"):
        _ens(chunk_size=5, record_thin=3)
    with pytest.raises(ValueError, match="record_thin"):
        e.sample(10, seed=3)
    # telemetry: (P, C) aggregates, chains bitwise with it off
    off = _ens("full", chunk_size=6, telemetry=False).sample(12, seed=3)
    for f in dataclasses.fields(off):
        if f.name != "stats":
            np.testing.assert_array_equal(getattr(full, f.name),
                                          getattr(off, f.name))
    assert int(full.stats["tele_sweeps"]) == 12
    for k in ("tele_accept_white", "tele_logpost", "tele_diverged"):
        assert full.stats[k].shape == (3, 4), k
    assert np.isfinite(full.stats["tele_logpost"]).all()
    # the log-posterior per (pulsar, chain) is each pulsar's own: the
    # solo sampler of the pulsar's padded model on its slice of the state
    st = e.last_state
    lp = e._logpost_chain(st)
    for p, solo in enumerate(e._pulsar_backends):
        np.testing.assert_allclose(
            lp[p].numpy(),
            solo._logpost_chain(_pulsar_state(st, p)).numpy(), rtol=1e-5)
    with pytest.raises(NotImplementedError):
        e.lnlikelihood(st.x[0, 0].numpy())


def _pulsar_state(st, p):
    """Pulsar ``p``'s slice of an ensemble state."""
    return type(st)(*(t[p] for t in st))


def test_ensemble_diverged_mask_matches_jax_and_reinit():
    jmas = _jax_pulsars()
    je = jens.EnsembleGibbs(jmas, JaxConfig(model="mixture", vary_df=True,
                                            theta_prior="beta"),
                            nchains=4, record="full", unroll=False,
                            telemetry=False)
    jst = je.init_state(seed=0)
    arrays = {f: np.array(getattr(jst, f)) for f in jst._fields}
    arrays["x"][0, 1, 0] = np.nan
    arrays["b"][1, 2, 3] = np.inf
    arrays["alpha"][2, 3, 1] = 0.0
    arrays["df"][2, 0] = np.nan
    e = _ens()
    state = chain_state_from_arrays(arrays, device="cpu")
    ours = e.diverged_mask(state)
    theirs = np.asarray(je.diverged_mask(jst._replace(
        **{f: jnp.asarray(v) for f, v in arrays.items()})))
    assert ours.shape == (3, 4)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.sum() == 4
    # the same injections into a port state: exactly those populations
    # are re-drawn, every other one stays bitwise, the scales survive
    good = e.init_state(seed=0)
    broken = good._replace(**{f: getattr(good, f).clone()
                              for f in ("x", "b", "alpha", "df")})
    broken.x[0, 1, 0] = float("nan")
    broken.b[1, 2, 3] = float("inf")
    broken.alpha[2, 3, 1] = 0.0
    broken.df[2, 0] = float("nan")
    np.testing.assert_array_equal(e.diverged_mask(broken), ours)
    fixed, n_bad = e._reinit_diverged(broken, seed=9)
    assert n_bad == 4 and not e.diverged_mask(fixed).any()
    fresh = e.init_state(seed=9)
    for f, a, g, fr in zip(good._fields, fixed, broken, fresh):
        for p in range(3):
            for c in range(4):
                want = fr if ours[p, c] and f != "mh_log_scale" else g
                assert torch.equal(a[p, c], want[p, c]), (f, p, c)
    x = good.x.clone()
    x[1, 3] = float("nan")
    res = e.sample(10, seed=1, state=good._replace(x=x),
                   reinit_diverged=True)
    assert int(res.stats["n_reinits"]) == 1
    assert not e.diverged_mask(e.last_state).any()


def test_ensemble_sample_until():
    e = _ens("compact8", chunk_size=8)
    res = e.sample_until(rhat_target=1.5, max_sweeps=48, check_every=16,
                         seed=2)
    total = res.chain.shape[0]
    assert total % 16 == 0 and 32 <= total <= 48
    assert res.stats["rhat"].shape == (3, 3)
    assert res.stats["rhat_history"].shape == (total // 16, 3, 3)
    np.testing.assert_array_equal(res.stats["n_toa"], NS)
    assert int(res.stats["tele_sweeps"]) == total
    assert res.stats["tele_logpost"].shape == (3, 4)
    plain = _ens("compact8", chunk_size=8).sample(total, seed=2)
    for f in dataclasses.fields(plain):
        if f.name != "stats":
            np.testing.assert_array_equal(getattr(res, f.name),
                                          getattr(plain, f.name))
    res2 = e.sample_until(rhat_target=10.0, max_sweeps=32, check_every=16,
                          seed=2, min_ess=1e9)
    assert not bool(res2.stats["converged"])
    assert res2.stats["ess"].shape == (3, 3)
    with pytest.raises(ValueError, match="check_every"):
        e.sample_until(check_every=4, max_sweeps=32)
