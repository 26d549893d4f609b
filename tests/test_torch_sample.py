"""The sampling surface of the port's ``TorchGibbs``, against the JAX
package's ``JaxGibbs`` (CPU).

- record transport: ``_pack_bits`` and ``record_tuple`` (the compact and
  compact8 wire casts) bitwise equal to the JAX functions at n = 1, 7, 8,
  9 and 130, pout on exact uint8 half-steps included; ``_materialize``
  equal to JAX's; compact and compact8 runs against a full run (x, theta,
  df, z and the acceptance rates exact; b and alpha within half a
  bfloat16 step, pout within 1/510 or half a float16 step);
- thinning: row k of a ``record_thin=3`` run is bitwise row 3k of the
  unthinned run, a resumed thinned run stitches, and the validation
  errors are JAX's;
- telemetry: chains bitwise equal with it on and off, the accept sums
  equal to the records' (shifted by one row, as the JAX test reads them),
  every log-posterior finite; ``combine_tele_stats`` equal to JAX's;
- recovery: ``diverged_mask`` equal to JAX's on a converted state with
  NaN, inf and alpha <= 0 injected; ``_reinit_diverged`` leaves healthy
  chains bitwise and keeps the jump scales; ``sample(reinit_diverged=True)``
  counts and heals an injected dead chain;
- ``lnlikelihood`` and the telemetry's log-posterior against
  ``JaxGibbs.lnlikelihood`` and ``_logpost_chain`` at rtol 1e-5;
- ``sample_until``: converging, its rows bitwise a plain ``sample`` of the
  same length, ``min_ess`` gating the stop, and JAX's validation errors.

The card tests of this surface (the factor's block form at the
log-posterior's shapes, the wire casts on the card) are in
tests/test_torch_kernels.py, which runs where JAX is not installed.

These mirror tests/test_jax_backend.py (record tiers, thinning,
sample_until), tests/test_recovery.py and tests/test_obs.py (telemetry).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.backends import jax_backend as jb
from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu.obs.telemetry import (
    combine_tele_stats as jax_combine_tele_stats,
)
from gibbs_student_t_tpu_torch.backends import torch_backend as tb
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.convert import (
    chain_state_from_arrays,
    model_arrays_from_fields,
)
from gibbs_student_t_tpu_torch.obs.telemetry import combine_tele_stats
from test_torch_host import _fields
from test_torch_kernels import bits as _bits
from test_torch_kernels import wire_state as _wire_state

# The suite runs in parallel workers and these tensors are small: one
# PyTorch CPU thread per worker costs nothing here and leaves the other
# cores to the other workers.
torch.set_num_threads(1)

C = 8


@pytest.fixture(scope="module")
def small():
    """A 40-TOA, 5-component demo pulsar: the JAX model and the port's."""
    jma = jax_demo_model_arrays(n=40, components=5, seed=3)
    return jma, model_arrays_from_fields(_fields(jma))


def _cfg():
    return GibbsConfig(model="mixture", vary_df=True, theta_prior="beta")


def _jcfg():
    return JaxConfig(model="mixture", vary_df=True, theta_prior="beta")


def _sampler(ma, **kw):
    kw.setdefault("chunk_size", 5)
    return TorchGibbs(ma, _cfg(), nchains=C, device="cpu", **kw)


# --- record transport --------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 8, 9, 130])
def test_pack_bits_and_record_tuple_match_jax(n):
    rng = np.random.default_rng(n)
    st = _wire_state(rng, n)
    packed = tb._pack_bits(torch.from_numpy(st["z"]))
    jpacked = np.asarray(jb._pack_bits(jnp.asarray(st["z"])))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), jpacked)
    np.testing.assert_array_equal(tb._unpack_bits(packed.numpy(), n), st["z"])
    fields = tb._RECORD_FIELDS
    for casts, jcasts in ((tb._COMPACT_CASTS, jb._COMPACT_CASTS),
                          (tb._COMPACT8_CASTS, jb._COMPACT8_CASTS)):
        ours = tb.record_tuple(
            dataclasses.make_dataclass("S", fields)(
                **{f: torch.from_numpy(st[f]) for f in fields}),
            fields, casts)
        theirs = jb.record_tuple(
            dataclasses.make_dataclass("S", fields)(
                **{f: jnp.asarray(st[f]) for f in fields}),
            fields, jcasts)
        for f, a, j in zip(fields, ours, theirs):
            j = np.asarray(j)
            assert tuple(a.shape) == j.shape, f
            assert a.element_size() == j.dtype.itemsize, f
            np.testing.assert_array_equal(_bits(a), _bits(j), err_msg=f)


@pytest.mark.parametrize("mode", ["compact", "compact8"])
def test_materialize_matches_jax(demo_ma, mode):
    ma = model_arrays_from_fields(_fields(demo_ma))
    ours = TorchGibbs(ma, _cfg(), nchains=4, device="cpu", record=mode)
    theirs = jb.JaxGibbs(demo_ma, _jcfg(), nchains=4, record=mode,
                         telemetry=False)
    st = _wire_state(np.random.default_rng(5), ma.n)
    fields = tb._RECORD_FIELDS
    recs = tb.record_tuple(
        dataclasses.make_dataclass("S", fields)(
            **{f: torch.from_numpy(st[f]) for f in fields}),
        fields, ours._record_casts)
    jrecs = jb.record_tuple(
        dataclasses.make_dataclass("S", fields)(
            **{f: jnp.asarray(st[f]) for f in fields}),
        fields, theirs._record_casts)
    got = ours._materialize(list(recs))
    want = theirs._materialize(jax.device_get(jrecs))
    for f, a, w in zip(fields, got, want):
        assert a.dtype == np.float32, f
        np.testing.assert_array_equal(a, np.asarray(w, np.float32),
                                      err_msg=f)


def test_compact_tiers_against_full(small):
    _, ma = small
    runs = {mode: _sampler(ma, record=mode).sample(niter=10, seed=11)
            for mode in ("full", "compact", "compact8")}
    f = runs["full"]
    for mode in ("compact", "compact8"):
        c = runs[mode]
        assert str(c.stats["record_mode"]) == mode
        for name in ("chain", "thetachain", "dfchain", "zchain", "bchain",
                     "alphachain", "poutchain"):
            assert getattr(c, name).dtype == np.float32, name
        for name in ("chain", "thetachain", "dfchain", "zchain"):
            np.testing.assert_array_equal(getattr(c, name),
                                          getattr(f, name), err_msg=name)
        for k in ("acc_white", "acc_hyper"):
            np.testing.assert_array_equal(c.stats[k], f.stats[k])
        for name in ("bchain", "alphachain"):
            a, w = getattr(c, name), getattr(f, name)
            assert (np.abs(a - w) <= np.abs(w) * 2.0 ** -8).all(), name
        tol = (0.5 / 255 + 1e-7 if mode == "compact8"
               else np.abs(f.poutchain) * 2.0 ** -11 + 2.0 ** -25)
        assert (np.abs(c.poutchain - f.poutchain) <= tol).all()
    assert str(f.stats["record_mode"]) == "full"


# --- thinning ----------------------------------------------------------------

def test_record_thin_rows_match_unthinned(small):
    _, ma = small
    full = _sampler(ma, chunk_size=6, record="full").sample(niter=12, seed=3)
    s = _sampler(ma, chunk_size=6, record_thin=3, record="full")
    thin = s.sample(niter=12, seed=3)
    assert thin.chain.shape[0] == 4
    for name in ("chain", "bchain", "zchain", "alphachain", "poutchain",
                 "thetachain", "dfchain"):
        np.testing.assert_array_equal(getattr(thin, name),
                                      getattr(full, name)[::3], err_msg=name)
    for k in ("acc_white", "acc_hyper"):
        np.testing.assert_array_equal(thin.stats[k], full.stats[k][::3])
    assert int(thin.stats["record_thin"]) == 3
    assert "record_thin" not in full.stats
    # every sweep still ran: the final states agree
    s_full = _sampler(ma, chunk_size=6, record="full")
    s_full.sample(niter=12, seed=3)
    for a, b in zip(s.last_state, s_full.last_state):
        assert torch.equal(a, b)
    # resume lands on recorded-sweep boundaries and stitches exactly
    s2 = _sampler(ma, chunk_size=6, record_thin=3, record="full")
    first = s2.sample(niter=6, seed=3)
    second = s2.sample(niter=6, seed=3, state=s2.last_state, start_sweep=6)
    np.testing.assert_array_equal(
        np.concatenate([first.chain, second.chain]), thin.chain)
    # invalid shapes are rejected up front, with JAX's messages
    with pytest.raises(ValueError, match="record_thin"):
        _sampler(ma, chunk_size=5, record_thin=3)
    with pytest.raises(ValueError, match="record_thin"):
        s.sample(niter=10, seed=3)
    with pytest.raises(ValueError, match="recorded sweep"):
        s.sample(niter=6, seed=3, start_sweep=4)
    with pytest.raises(ValueError, match="record must be"):
        _sampler(ma, record="compact16")


# --- telemetry ---------------------------------------------------------------

def test_telemetry_leaves_chains_bitwise_and_sums_accepts(small):
    _, ma = small
    s_on = _sampler(ma, record="full")
    on = s_on.sample(niter=10, seed=2)
    off = _sampler(ma, record="full", telemetry=False).sample(niter=10,
                                                              seed=2)
    assert not any(k.startswith("tele_") for k in off.stats)
    for f in dataclasses.fields(on):
        if f.name != "stats":
            np.testing.assert_array_equal(getattr(on, f.name),
                                          getattr(off, f.name))
    assert int(on.stats["tele_sweeps"]) == 10
    # telemetry sums the POST-sweep acceptance of every sweep; records
    # hold the PRE-sweep state, so the check shifts by one row and adds
    # the final state
    for blk in ("white", "hyper"):
        rec = on.stats[f"acc_{blk}"]
        last = getattr(s_on.last_state, f"acc_{blk}").numpy()
        np.testing.assert_allclose(on.stats[f"tele_accept_{blk}"] * 10,
                                   rec[1:].sum(0) + last, rtol=1e-5)
    assert on.stats["tele_logpost"].shape == (C,)
    assert np.isfinite(on.stats["tele_logpost"]).all()
    assert not on.stats["tele_diverged"].any()
    assert (on.stats["tele_nonfinite"] == 0).all()
    # a poisoned chain is flagged every sweep, its log-posterior -inf
    st = s_on.init_state(seed=0)
    x = st.x.clone()
    x[2] = float("nan")
    bad = s_on.sample(niter=5, seed=0, state=st._replace(x=x))
    assert bad.stats["tele_diverged"][2]
    assert bad.stats["tele_nonfinite"][2] == 5
    assert bad.stats["tele_logpost"][2] == -np.inf
    assert not np.delete(bad.stats["tele_diverged"], 2).any()


def test_combine_tele_stats_matches_jax():
    rng = np.random.default_rng(0)

    def seg(sweeps):
        return {"tele_sweeps": np.asarray(sweeps),
                "tele_accept_white": rng.random(6).astype(np.float32),
                "tele_accept_hyper": rng.random(6).astype(np.float32),
                "tele_nonfinite": rng.integers(0, 3, 6),
                "tele_diverged": rng.random(6) < 0.3,
                "tele_logpost": rng.normal(size=6).astype(np.float32)}

    segs = [seg(s) for s in (10, 30, 7)] + [{"acc_white": np.zeros(3)}]
    ours, theirs = combine_tele_stats(segs), jax_combine_tele_stats(segs)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert combine_tele_stats([]) == jax_combine_tele_stats([]) == {}


# --- recovery ----------------------------------------------------------------

def test_diverged_mask_matches_jax(small):
    jma, ma = small
    jg = jb.JaxGibbs(jma, _jcfg(), nchains=C, telemetry=False)
    jst = jg.init_state(seed=0)
    arrays = {f: np.array(getattr(jst, f)) for f in jst._fields}
    arrays["x"][1, 0] = np.nan
    arrays["b"][2, 5] = np.inf
    arrays["alpha"][3, 2] = -1.0
    arrays["alpha"][4, 0] = 0.0
    arrays["theta"][5] = -np.inf
    arrays["df"][6] = np.nan
    arrays["z"][7, 3] = np.nan          # z is not part of the predicate
    ours = _sampler(ma).diverged_mask(chain_state_from_arrays(arrays,
                                                              device="cpu"))
    theirs = jg.diverged_mask(jst._replace(
        **{f: jnp.asarray(v) for f, v in arrays.items()}))
    assert ours.dtype == bool
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    np.testing.assert_array_equal(ours, [False] + [True] * 6 + [False])


def test_reinit_leaves_healthy_chains_bitwise(small):
    _, ma = small
    s = _sampler(ma)
    st = s.init_state(seed=0)
    x, alpha = st.x.clone(), st.alpha.clone()
    x[2] = float("inf")
    alpha[5, 3] = 0.0
    broken = st._replace(x=x, alpha=alpha,
                         mh_log_scale=st.mh_log_scale + 0.7)
    fixed, n_bad = s._reinit_diverged(broken, seed=123)
    assert n_bad == 2
    fresh = s.init_state(seed=123)
    for f, a, b, fr in zip(st._fields, fixed, broken, fresh):
        for i in range(C):
            if f == "mh_log_scale":
                assert torch.equal(a[i], b[i]), f
            elif i in (2, 5):
                assert torch.equal(a[i], fr[i]), f
            else:
                assert torch.equal(a[i], b[i]), f
    assert not s.diverged_mask(fixed).any()
    # sample(reinit_diverged=True) counts and heals an injected dead chain
    x = st.x.clone()
    x[0] = float("nan")
    res = s.sample(niter=10, seed=0, state=st._replace(x=x),
                   reinit_diverged=True)
    assert int(res.stats["n_reinits"]) == 1
    assert not s.diverged_mask(s.last_state).any()
    assert np.isfinite(res.chain[-1]).all()
    assert "n_reinits" not in s.sample(niter=5, seed=0).stats


# --- lnlikelihood and the log-posterior --------------------------------------

def test_lnlikelihood_and_logpost_match_jax(small):
    jma, ma = small
    jg = jb.JaxGibbs(jma, _jcfg(), nchains=C, telemetry=False)
    s = _sampler(ma)
    s.sample(niter=5, seed=1)
    st = s.last_state
    rng = np.random.default_rng(4)
    for c in range(3):
        x = st.x[c].numpy()
        z = (rng.random(ma.n) < 0.2).astype(np.float32)
        alpha = rng.gamma(2.0, 2.0, ma.n).astype(np.float32)
        for args in ((x,), (x, z, alpha)):
            np.testing.assert_allclose(s.lnlikelihood(*args),
                                       jg.lnlikelihood(*args), rtol=1e-5)
    assert s.lnlikelihood(np.array([np.nan, 0.0, 0.0])) == -np.inf
    arrays = {f: getattr(st, f).numpy() for f in st._fields}
    jst = jg.init_state(seed=0)._replace(
        **{f: jnp.asarray(arrays[f]) for f in ("x", "b", "z", "alpha",
                                                "theta", "df", "pout")})
    want = np.asarray(jax.vmap(jg._logpost_chain)(jst))
    got = s._logpost_chain(st).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


# --- sample_until ------------------------------------------------------------

def test_sample_until_converges_and_matches_plain_run(small):
    _, ma = small
    s = _sampler(ma, chunk_size=8, record="full")
    res = s.sample_until(rhat_target=1.5, max_sweeps=64, check_every=16,
                         seed=4)
    total = res.chain.shape[0]
    assert total % 16 == 0 and 32 <= total <= 64
    assert res.stats["rhat"].shape == (ma.nparam,)
    assert res.stats["rhat_history"].shape == (total // 16, ma.nparam)
    if res.stats["converged"]:
        assert (res.stats["rhat"] < 1.5).all()
    else:
        assert total == 64
    assert int(res.stats["tele_sweeps"]) == total
    plain = _sampler(ma, chunk_size=8, record="full").sample(niter=total,
                                                             seed=4)
    for f in dataclasses.fields(plain):
        if f.name != "stats":
            np.testing.assert_array_equal(getattr(res, f.name),
                                          getattr(plain, f.name))
    np.testing.assert_array_equal(res.stats["acc_white"],
                                  plain.stats["acc_white"])
    burned = res.burn(8)
    np.testing.assert_array_equal(burned.stats["rhat_history"],
                                  res.stats["rhat_history"])


def test_sample_until_min_ess_and_validation(small, tmp_path):
    _, ma = small
    s = _sampler(ma, chunk_size=8)
    res = s.sample_until(rhat_target=10.0, max_sweeps=32, check_every=16,
                         seed=4, min_ess=1e9, reinit_diverged=True)
    assert res.chain.shape[0] == 32
    assert not bool(res.stats["converged"])
    assert res.stats["ess"].shape == (ma.nparam,)
    assert res.stats["ess_history"].shape == (2, ma.nparam)
    assert int(res.stats["n_reinits"]) == 0
    res2 = s.sample_until(rhat_target=10.0, max_sweeps=64, check_every=16,
                          seed=4, min_ess=2.0)
    assert bool(res2.stats["converged"]) and res2.chain.shape[0] == 32
    assert (res2.stats["ess"] >= 2.0).all()
    with pytest.raises(ValueError, match="check_every"):
        s.sample_until(check_every=7, max_sweeps=32)
    with pytest.raises(ValueError, match="max_sweeps"):
        s.sample_until(check_every=16, max_sweeps=0)
    thin = _sampler(ma, chunk_size=8, record_thin=2)
    with pytest.raises(ValueError, match="check_every"):
        thin.sample_until(check_every=14, max_sweeps=32)
    with pytest.raises(ValueError, match="max_sweeps"):
        thin.sample_until(check_every=16, max_sweeps=33)
    # spool_dir passes through: the spooled segments give the same rows
    res3 = s.sample_until(rhat_target=10.0, max_sweeps=64, check_every=16,
                          seed=4, min_ess=2.0,
                          spool_dir=str(tmp_path / "spool"))
    assert np.array_equal(res3.chain, res2.chain)
