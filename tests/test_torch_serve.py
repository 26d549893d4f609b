"""The port's slot pool and serial chain server (CPU, plain versions),
against the port's solo sampler and the JAX package.

- the solo-tenant pin (the JAX package's tests/test_serve.py pins its
  pool to ``JaxGibbs.sample`` the same way): a 16-chain tenant served for
  10 sweeps in a 32-lane pool (quantum 5, ``record="full"``) beside an
  unrelated tenant, in the first group and in the second, equals
  ``TorchGibbs.sample`` at the same seed: x, z, theta, df and the accept
  rates bitwise, b, alpha and pout within 2e-2 x max(1, max |solo|);
- the same bitwise, every field, for a 20-chain tenant (two groups, four
  pad lanes) under Robbins-Monro adaptation, whose lanes sit at other
  sweeps than its neighbour's; and for a tenant resumed from
  ``tenant_state`` at ``start_sweep`` against the unbroken solo run;
- bookkeeping: four tenants share one pool whose model, constant, draw,
  lane-key and flag tensors are never reallocated; ``busy_chain_sweeps`` is the sum
  of chains x sweeps; every group returns to the free list; pad lanes and
  free groups end a quantum bitwise as they began it, and pad lanes
  start as copies of chain 0;
- validation: ``niter`` not a multiple of the quantum, more chains than
  lanes, a full queue under ``backpressure="reject"`` (``QueueFull``),
  request fields whose machinery is not ported (``TypeError``), and
  models the pool cannot serve (other basis, other TOA count: rejected
  through the handle);
  population-covariance adaptation and MTM are refused; without CUDA the
  pool and the server raise unless asked for the CPU;
- in law: a pool tenant (48 chains beside a 16-chain neighbour, 300
  sweeps, adapting for the first 100 and discarding them) against
  ``JaxGibbs.sample`` (64 chains) on the 5-component demo model:
  posterior means of the 3 parameters and of theta within 4 Monte-Carlo
  standard errors, KS p > 0.01, the method of
  test_torch_sweep.py::test_sampler_agrees_in_law_with_jax.
"""

import numpy as np
import pytest
import torch
from scipy import stats

from gibbs_student_t_tpu.backends.jax_backend import JaxGibbs
from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu.parallel.diagnostics import ess_per_param
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.convert import model_arrays_from_fields
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.parallel.ensemble import (
    GROUPED_ATTRS,
    _model_leaves,
)
from gibbs_student_t_tpu_torch.serve import (
    ChainServer,
    QueueFull,
    SlotPool,
    TenantRequest,
    TenantSlot,
)
from test_torch_host import _fields
from test_torch_sweep import _thin_for_ks

# The suite runs in parallel workers and these tensors are small: one
# PyTorch CPU thread per worker costs nothing here and leaves the other
# cores to the other workers.
torch.set_num_threads(1)

EXACT_FIELDS = ("chain", "zchain", "thetachain", "dfchain")
ROUNDOFF_FIELDS = ("bchain", "alphachain", "poutchain")
ALL_FIELDS = EXACT_FIELDS + ROUNDOFF_FIELDS


@pytest.fixture(scope="module")
def demo():
    return make_demo_model_arrays(), GibbsConfig(model="mixture")


def _solo(ma, cfg, niter, nchains, seed, chunk, **kw):
    # record="full": the pool records every field in float32, so the solo
    # run it is held against must too
    smp = TorchGibbs(ma, cfg, nchains=nchains, device="cpu",
                     chunk_size=chunk, tnt_block_size=None, record="full")
    return smp.sample(niter=niter, seed=seed, **kw), smp


def _assert_parity(rs, rv, exact=EXACT_FIELDS, roundoff=ROUNDOFF_FIELDS):
    for f in exact:
        np.testing.assert_array_equal(getattr(rv, f), getattr(rs, f),
                                      err_msg=f)
    for k in ("acc_white", "acc_hyper"):
        np.testing.assert_array_equal(rv.stats[k], rs.stats[k], err_msg=k)
    for f in roundoff:
        a = np.asarray(getattr(rs, f), np.float64)
        b = np.asarray(getattr(rv, f), np.float64)
        assert a.shape == b.shape, f
        scale = max(1.0, float(np.abs(a).max()))
        assert np.abs(a - b).max() <= 2e-2 * scale, f


# --- the solo-tenant pins ----------------------------------------------------

@pytest.mark.parametrize("position", ["first", "second"])
def test_solo_tenant_equals_torch_gibbs(demo, position):
    ma, cfg = demo
    other = make_demo_model_arrays(seed=7)
    srv = ChainServer(ma, cfg, nlanes=32, quantum=5, record="full",
                      device="cpu")
    if position == "second":
        h2 = srv.submit(TenantRequest(ma=other, niter=5, nchains=16,
                                      seed=13))
    h = srv.submit(TenantRequest(ma=ma, niter=10, nchains=16, seed=0))
    if position == "first":
        h2 = srv.submit(TenantRequest(ma=other, niter=5, nchains=16,
                                      seed=13))
    srv.run()
    rs, _ = _solo(ma, cfg, 10, 16, 0, chunk=5)
    rv = h.result()
    assert rv.chain.shape == (10, 16, 3)
    _assert_parity(rs, rv)
    assert h2.result().chain.shape == (5, 16, 3)
    assert h.sweeps_done == 10 and h.done() and h2.done()


def test_padded_adapting_tenant_equals_torch_gibbs(demo):
    """20 chains (two groups, four pad lanes) in the pool's last two
    groups, Robbins-Monro adaptation on; its neighbour started a quantum
    earlier, so their lanes adapt at other sweep indices."""
    ma, _ = demo
    cfg = GibbsConfig(model="mixture").with_adapt(7)
    srv = ChainServer(ma, cfg, nlanes=48, quantum=5,
                      record="full", device="cpu")
    h2 = srv.submit(TenantRequest(ma=make_demo_model_arrays(seed=7),
                                  niter=15, nchains=16, seed=13))
    srv.step()
    h = srv.submit(TenantRequest(ma=ma, niter=10, nchains=20, seed=3))
    srv.run()
    rs, _ = _solo(ma, cfg, 10, 20, 3, chunk=5)
    _assert_parity(rs, h.result(), exact=ALL_FIELDS, roundoff=())
    assert h2.result().chain.shape == (15, 16, 3)


def test_resumed_tenant_equals_unbroken_run(demo):
    """Five sweeps, then the tenant's state carried into another group at
    ``start_sweep=5``: the ten sweeps of the unbroken solo run."""
    ma, cfg = demo
    pool = SlotPool(ma, cfg, nlanes=48, quantum=5, record="full", device="cpu")
    smp = TorchGibbs(ma, cfg, nchains=16, device="cpu", tnt_block_size=None)
    first = TenantSlot(0, np.arange(16), 16, 5, 0, 4)
    pool.write_tenant(first, smp, smp.init_state(seed=4))
    rec1 = pool.tenant_records(pool.materialize(pool.run_quantum()[0]),
                               first)
    state = pool.tenant_state(first)
    pool.evict(first)
    second = TenantSlot(1, np.arange(32, 48), 16, 5, 5, 4)
    pool.write_tenant(second, smp, state)
    rec2 = pool.tenant_records(pool.materialize(pool.run_quantum()[0]),
                               second)
    rv = pool.result({f: np.concatenate([rec1[f], rec2[f]])
                      for f in rec1})
    rs, solo = _solo(ma, cfg, 10, 16, 4, chunk=5)
    _assert_parity(rs, rv)
    for f in ("x", "z", "theta", "df"):
        assert torch.equal(getattr(pool.tenant_state(second), f),
                           getattr(solo.last_state, f)), f


# --- bookkeeping -------------------------------------------------------------

def _buffers(pool):
    """The data pointers of every tensor the pool allocates once."""
    smp = pool.sampler
    tensors = [t for name in GROUPED_ATTRS
               for t, _ in _model_leaves(getattr(smp, name),
                                         getattr(smp, name))]
    tensors += [smp.gid, pool._active, pool._raw, pool._lane_keys,
                pool._lane_sweep]
    return [t.data_ptr() for t in tensors]


def test_tenants_share_one_pool(demo):
    ma, cfg = demo
    srv = ChainServer(ma, cfg, nlanes=32, quantum=5, record="light",
                      device="cpu")
    ptrs = _buffers(srv.pool)
    jobs = [(5, 16), (10, 16), (5, 16), (10, 12), (5, 8)]
    handles = [srv.submit(TenantRequest(
        ma=make_demo_model_arrays(seed=20 + i), niter=n, nchains=c, seed=i))
        for i, (n, c) in enumerate(jobs)]
    while srv.step():
        assert _buffers(srv.pool) == ptrs
    for h, (n, c) in zip(handles, jobs):
        res = h.result()
        assert res.chain.shape == (n, c, 3) and res.bchain.size == 0
        assert np.isfinite(res.chain).all()
    s = srv.summary()
    assert s["busy_chain_sweeps"] == sum(n * c for n, c in jobs)
    # five tenants through two groups in four quanta: two resident at once
    assert 0.0 < s["occupancy"] <= 1.0 and s["quanta"] == 4
    assert srv._free_groups == [0, 1]
    assert not srv.pool._active_np.any()
    assert (srv.pool._gid_np == -1).all()


def test_inactive_lanes_are_frozen(demo):
    ma, cfg = demo
    pool = SlotPool(ma, cfg, nlanes=48, quantum=5, record="full", device="cpu")
    smp = TorchGibbs(ma, cfg, nchains=20, device="cpu", tnt_block_size=None)
    slot = TenantSlot(0, np.arange(32), 20, 5, 0, 1)
    state = smp.init_state(seed=1)
    pool.write_tenant(slot, smp, state)
    flat = [f.reshape(48, *f.shape[2:]) for f in pool.state]
    for f, s in zip(flat, state):
        assert torch.equal(f[:20], s)
        assert torch.equal(f[20:32], s[:1].expand(12, *s.shape[1:]))
    before = [f.clone() for f in flat]
    pool.run_quantum()
    after = [f.reshape(48, *f.shape[2:]) for f in pool.state]
    for a, b in zip(after, before):
        assert torch.equal(a[20:], b[20:])
    assert not torch.equal(after[0][:20], before[0][:20])


# --- validation --------------------------------------------------------------

def test_validation(demo):
    ma, cfg = demo
    srv = ChainServer(ma, cfg, nlanes=32, quantum=5, max_queue=2,
                      backpressure="reject", record="full", device="cpu")
    with pytest.raises(ValueError, match="multiple of the pool quantum"):
        srv.submit(TenantRequest(ma=ma, niter=7, nchains=16))
    with pytest.raises(ValueError, match="lane groups"):
        srv.submit(TenantRequest(ma=ma, niter=5, nchains=33))
    assert TenantRequest(ma=ma, niter=5, trace_id="t").trace_id == "t"
    with pytest.raises(ValueError, match="warm_start must be"):
        srv.submit(TenantRequest(ma=ma, niter=5, warm_start=object()))
    srv.submit(TenantRequest(ma=ma, niter=5, nchains=16, seed=0))
    srv.submit(TenantRequest(ma=ma, niter=5, nchains=16, seed=1))
    with pytest.raises(QueueFull):
        srv.submit(TenantRequest(ma=ma, niter=5, nchains=16, seed=2))
    # block: a full queue is served until the next job fits in
    blk = ChainServer(ma, cfg, nlanes=32, quantum=5, max_queue=1,
                      record="full", device="cpu")
    first = blk.submit(TenantRequest(ma=ma, niter=5, nchains=32, seed=0))
    second = blk.submit(TenantRequest(ma=ma, niter=5, nchains=16, seed=1))
    assert first.done() and blk.quanta == 1 and not second.done()
    blk.run()
    assert second.result().chain.shape == (5, 16, 3)
    # models the pool cannot serve are rejected through their handle
    srv.run()
    bad = [srv.submit(TenantRequest(ma=make_demo_model_arrays(
        components=10), niter=5)),
        srv.submit(TenantRequest(ma=make_demo_model_arrays(n=120),
                                 niter=5))]
    srv.run()
    for h in bad:
        assert h.status == "rejected"
        with pytest.raises(RuntimeError, match="rejected"):
            h.result()
    assert srv._free_groups == [0, 1]


def test_pool_refusals(demo):
    ma, cfg = demo
    with pytest.raises(ValueError, match="adapt_cov"):
        SlotPool(ma, cfg.with_adapt(10, adapt_cov=True), nlanes=32,
                 device="cpu")
    with pytest.raises(ValueError, match="multiple-try"):
        SlotPool(ma, cfg.with_mtm(4), nlanes=32, device="cpu")
    with pytest.raises(ValueError, match="multiple of"):
        SlotPool(ma, cfg, nlanes=40, device="cpu")
    if not torch.cuda.is_available():
        for make in (SlotPool, ChainServer):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(ma, cfg, nlanes=32)


# --- in law against the JAX package ------------------------------------------

def test_pool_tenant_agrees_in_law_with_jax():
    niter, burn, nch = 300, 100, 64
    ma = jax_demo_model_arrays(components=5)
    jcfg = JaxConfig(model="mixture", vary_df=True,
                     theta_prior="beta").with_adapt(burn)
    tcfg = GibbsConfig(model="mixture", vary_df=True,
                       theta_prior="beta").with_adapt(burn)
    rj = JaxGibbs(ma, jcfg, nchains=nch, record="full",
                  telemetry=False).sample(niter=niter, seed=5)
    tma = model_arrays_from_fields(_fields(ma))
    srv = ChainServer(tma, tcfg, nlanes=64, quantum=25, record="light",
                      device="cpu")
    h = srv.submit(TenantRequest(ma=tma, niter=niter, nchains=48, seed=6))
    srv.submit(TenantRequest(
        ma=model_arrays_from_fields(_fields(jax_demo_model_arrays(
            components=5, seed=3))), niter=100, nchains=16, seed=1))
    srv.run()
    rt = h.result()
    assert np.isfinite(rt.chain).all()
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
