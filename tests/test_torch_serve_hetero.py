"""Heterogeneous serving pools (CPU, plain versions): tenants with fewer TOAs
than the pool, padded with masked rows, against the port's solo sampler
and the JAX package's heterogeneous pool.

- admission: a homogeneous pool (the default) rejects a tenant of another
  TOA count with the JAX message, which names ``heterogeneous=True`` (the
  port's mirror of tests/test_serve.py's
  ``test_heterogeneous_pool_requires_flag``); a heterogeneous pool rejects
  a tenant with more TOAs than its template;
- records: in a 130-TOA heterogeneous pool, a 100-TOA tenant in memory and
  a 120-TOA tenant spooled and streamed to ``on_chunk`` get z, alpha and
  pout cut to their own TOAs, ``stats["n_toa"]`` their own count (the
  spool's meta too), under ``record="full"`` and ``"compact8"``; their
  padded rows stay pinned in the pool (z 0, alpha 1), the draws' theta
  shapes read each lane's own TOA count, and every chain is finite;
- recovery: an abandoned ``compact8`` heterogeneous server (no close, the
  in-process stand-in for a kill) is rebuilt by ``recover`` from its
  manifest with its tier and its flag, and finishes its spooled 100-TOA
  tenant bitwise the uninterrupted run;
- in law: tenants of 100, 120 and 130 TOAs, 32 chains each, served
  together in a 96-lane heterogeneous pool for 300 sweeps (quantum 25,
  adapting for the first 100, which are discarded), each against
  ``TorchGibbs`` on its unpadded model (64 chains) and against the same
  tenant in the JAX package's ``SlotPool(heterogeneous=True)`` (32
  chains): posterior means of the 3 parameters and of theta within 4
  Monte-Carlo standard errors, KS p > 0.01, the method of
  test_torch_sweep.py::test_sampler_agrees_in_law_with_jax.
"""

import threading

import numpy as np
import pytest
import torch
from scipy import stats

from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu.parallel.diagnostics import ess_per_param
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.convert import model_arrays_from_fields
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.serve import ChainServer, TenantRequest
from gibbs_student_t_tpu_torch.serve.manifest import read_manifest
from gibbs_student_t_tpu_torch.utils.spool import load_spool
from test_torch_host import _fields
from test_torch_sweep import _thin_for_ks

torch.set_num_threads(1)

RUN_TIMEOUT_S = 300.0


def _drive(srv, close=True):
    """``srv.run()`` on a thread of its own, failing when it does not end
    in time."""
    box = []

    def target():
        try:
            srv.run()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box.append(e)

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(RUN_TIMEOUT_S)
    try:
        if th.is_alive():
            srv._stop.set()
            th.join(10.0)
            pytest.fail(f"the server's run did not end in {RUN_TIMEOUT_S} s")
        if box:
            raise box[0]
    finally:
        if close:
            srv.close()


@pytest.fixture(scope="module")
def models():
    """The 130-TOA template and tenants of 100 and 120 TOAs."""
    return {n: make_demo_model_arrays(n=n, components=5, seed=40 + n % 7)
            for n in (130, 120, 100)}


def _hetero(models, record, **kw):
    return ChainServer(models[130], GibbsConfig(model="mixture"),
                       nlanes=48, quantum=5, record=record, device="cpu",
                       heterogeneous=True, **kw)


# --- admission ---------------------------------------------------------------

def test_pool_admission_by_toa_count(models):
    cfg = GibbsConfig(model="mixture")
    homo = ChainServer(models[130], cfg, nlanes=32, quantum=5,
                       device="cpu")
    h = homo.submit(TenantRequest(ma=models[100], niter=5, nchains=16))
    _drive(homo)
    assert h.status == "rejected" and "heterogeneous" in h.error
    het = ChainServer(models[120], cfg, nlanes=32, quantum=5, device="cpu",
                      heterogeneous=True)
    assert het.pool.heterogeneous and het.pool.n_pool == 120
    big = het.submit(TenantRequest(ma=models[130], niter=5, nchains=16))
    ok = het.submit(TenantRequest(ma=models[100], niter=5, nchains=16))
    _drive(het)
    assert big.status == "rejected" and "exceeds the pool" in big.error
    assert ok.result(timeout=0).zchain.shape == (5, 16, 100)


# --- records -----------------------------------------------------------------

@pytest.mark.parametrize("record", ["full", "compact8"])
def test_records_cut_to_tenant_toas(models, record, tmp_path):
    srv = _hetero(models, record)
    chunks = []
    sdir = str(tmp_path / "s120")
    h100 = srv.submit(TenantRequest(ma=models[100], niter=10, nchains=16,
                                    seed=1))
    h120 = srv.submit(TenantRequest(
        ma=models[120], niter=10, nchains=20, seed=2, spool_dir=sdir,
        on_chunk=lambda h, s, r: chunks.append(r)))
    pinned = []

    def frozen_pads():
        # the 100-TOA tenant's lanes (its first group): suffix rows pinned
        st = srv.pool.state
        z, alpha = st.z[0], st.alpha[0]
        pinned.append(bool((z[:, 100:] == 0).all()
                           and (alpha[:, 100:] == 1).all()))

    srv.step()
    frozen_pads()
    # the draws' theta shapes read each lane's own TOA count and prior
    nstat = srv.pool.drawer._nstat.reshape(3, 16)
    assert (nstat[0] == 100).all() and (nstat[1:] == 120).all()
    _drive(srv)
    assert pinned == [True]
    for h, n, c in ((h100, 100, 16), (h120, 120, 20)):
        res = h.result(timeout=0)
        assert res.stats["n_toa"].tolist() == [n]
        for f in ("zchain", "alphachain", "poutchain"):
            assert getattr(res, f).shape == (10, c, n), f
        assert res.chain.shape == (10, c, 3)
        assert str(res.stats["record_mode"]) == record
        for f in ("chain", "bchain", "zchain", "alphachain", "poutchain",
                  "thetachain", "dfchain"):
            assert np.isfinite(getattr(res, f)).all(), f
    assert len(chunks) == 2
    for r in chunks:
        assert r["z"].shape == (5, 20, 120) and r["z"].dtype == np.float32
    spooled = load_spool(sdir)
    assert spooled.zchain.shape == (10, 20, 120)
    np.testing.assert_array_equal(
        spooled.zchain, np.concatenate([r["z"] for r in chunks]))


# --- recovery ----------------------------------------------------------------

def test_recover_restores_tier_and_flag(models, tmp_path):
    def request(spool):
        return TenantRequest(ma=models[100], niter=20, nchains=16, seed=3,
                             name="S", spool_dir=spool)

    ref_srv = _hetero(models, "compact8")
    ref = ref_srv.submit(request(str(tmp_path / "ref")))
    _drive(ref_srv)
    man = str(tmp_path / "manifest")
    srv = _hetero(models, "compact8", manifest_dir=man)
    srv.submit(request(str(tmp_path / "S")))
    for _ in range(2):
        srv.step()
    del srv
    (head,) = [r for r in read_manifest(man) if r["kind"] == "server"]
    assert head["record"] == "compact8" and head["heterogeneous"] is True
    srv2, handles = ChainServer.recover(man, device="cpu")
    assert srv2.pool.record == "compact8" and srv2.pool.heterogeneous
    assert handles["S"].request.start_sweep == 10
    _drive(srv2)
    got, want = handles["S"].result(timeout=0), ref.result(timeout=0)
    for f in ("chain", "bchain", "zchain", "thetachain", "alphachain",
              "poutchain", "dfchain"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.stats["n_toa"].tolist() == [100]


# --- in law ------------------------------------------------------------------

NITER, BURN, QUANTUM, CHAINS = 300, 100, 25, 32
LAW_NS = (100, 120, 130)


def _law_configs():
    kw = dict(model="mixture", vary_df=True, theta_prior="beta")
    return JaxConfig(**kw).with_adapt(BURN), GibbsConfig(**kw).with_adapt(BURN)


@pytest.fixture(scope="module")
def law_runs():
    """Each tenant's (x, theta) rows after burn-in: from the port's
    heterogeneous pool, from its solo sampler and from the JAX pool."""
    import jax.numpy as jnp

    from gibbs_student_t_tpu.backends.jax_backend import JaxGibbs
    from gibbs_student_t_tpu.parallel.ensemble import (
        _localize_names as jax_localize,
    )
    from gibbs_student_t_tpu.parallel.ensemble import (
        pad_model_arrays as jax_pad,
    )
    from gibbs_student_t_tpu.serve.pool import SlotPool as JaxPool
    from gibbs_student_t_tpu.serve.pool import TenantSlot as JaxSlot

    jcfg, tcfg = _law_configs()
    jmas = {n: jax_demo_model_arrays(n=n, components=5, seed=60 + n % 7)
            for n in LAW_NS}
    tmas = {n: model_arrays_from_fields(_fields(m)) for n, m in jmas.items()}
    out = {n: {} for n in LAW_NS}
    # the port's pool
    srv = ChainServer(tmas[130], tcfg, nlanes=3 * CHAINS, quantum=QUANTUM,
                      record="light", device="cpu", heterogeneous=True,
                      pipeline=False)
    hs = {n: srv.submit(TenantRequest(ma=tmas[n], niter=NITER,
                                      nchains=CHAINS, seed=10 + i))
          for i, n in enumerate(LAW_NS)}
    _drive(srv)
    for n, h in hs.items():
        r = h.result(timeout=0)
        assert np.isfinite(r.chain).all() and r.stats["n_toa"][0] == n
        out[n]["pool"] = (r.chain[BURN:], r.thetachain[BURN:])
    # the solo sampler on each unpadded model
    for i, n in enumerate(LAW_NS):
        r = TorchGibbs(tmas[n], tcfg, nchains=2 * CHAINS, device="cpu",
                       record="light").sample(niter=NITER, seed=20 + i)
        out[n]["solo"] = (r.chain[BURN:], r.thetachain[BURN:])
    # the JAX package's heterogeneous pool, admitted as its server admits
    jpool = JaxPool(jmas[130], jcfg, nlanes=3 * CHAINS, quantum=QUANTUM,
                    record="light", heterogeneous=True, telemetry=False)
    slots = []
    for i, n in enumerate(LAW_NS):
        (ma_p,) = jax_pad([jax_localize(jmas[n])], n_to=jpool.n_pool)
        tb = JaxGibbs(ma_p, jcfg, nchains=CHAINS, dtype=jnp.float32,
                      chunk_size=QUANTUM, tnt_block_size=None,
                      use_pallas=False, telemetry=False)
        slot = JaxSlot(i, np.arange(i * CHAINS, (i + 1) * CHAINS), CHAINS,
                       NITER, 0, n, 30 + i)
        jpool.write_tenant(slot, ma_p, tb, tb.init_state(seed=30 + i))
        slots.append((n, slot))
    rows = {n: [] for n in LAW_NS}
    for _ in range(NITER // QUANTUM):
        recs, _ = jpool.run_quantum()
        host = jpool.materialize(recs)
        for n, slot in slots:
            r = jpool.tenant_records(host, slot)
            rows[n].append((r["x"], r["theta"]))
    for n in LAW_NS:
        x = np.concatenate([a for a, _ in rows[n]])
        th = np.concatenate([b for _, b in rows[n]])
        out[n]["jax"] = (x[BURN:], th[BURN:])
    return out


@pytest.mark.parametrize("reference", ["solo", "jax"])
@pytest.mark.parametrize("n", LAW_NS)
def test_hetero_tenant_agrees_in_law(law_runs, n, reference):
    (xp, tp), (xr, tr) = law_runs[n]["pool"], law_runs[n][reference]
    cols = [(xr[..., k], xp[..., k], f"x{k}") for k in range(xp.shape[-1])]
    cols.append((tr, tp, "theta"))
    for a, b_, name in cols:
        ess_a = float(ess_per_param(a[..., None])[0])
        ess_b = float(ess_per_param(b_[..., None])[0])
        se = np.sqrt(a.var() / ess_a + b_.var() / ess_b)
        diff = abs(a.mean() - b_.mean())
        assert diff < 4.0 * se, (n, reference, name, a.mean(), b_.mean(), se)
        ks = stats.ks_2samp(_thin_for_ks(a, ess_a), _thin_for_ks(b_, ess_b))
        assert ks.pvalue > 0.01, (n, reference, name, ks)
