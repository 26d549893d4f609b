"""The serving pool's record tiers (CPU, plain versions), against the port's
solo sampler and the JAX pool.

- the tier against the solo sampler: a 20-chain tenant (two groups, four
  pad lanes) under Robbins-Monro adaptation, served beside a 16-chain
  neighbour in a 48-lane pool (quantum 5) under ``record="full"``,
  ``"compact"``, ``"compact8"`` and ``"light"``, on the serial and the
  pipelined executor, equals ``TorchGibbs(record=...).sample`` at the same
  seed, bitwise, every recorded field and the accept rates (the setting of
  tests/test_torch_serve.py's padded adapting tenant, whose full records
  are bitwise the solo sampler's); ``stats["record_mode"]`` names the
  tier;
- the drain's pieces on one quantum of a 32-lane pool, every tier, a
  homogeneous pool and a heterogeneous one holding a 100-TOA tenant:
  ``wire_host`` keeps the tier's dtypes (z bit-packed, b and alpha
  bfloat16, pout float16 or uint8); ``tenant_wire`` and the device gather
  ``tenant_wire_device`` give the same slice; ``materialize_tenant`` of
  that slice equals the JAX pool's ``materialize_tenant`` on the same
  arrays (as numpy, lanes first) bit for bit, per-TOA fields cut to the
  tenant's TOAs, and equals ``tenant_quantum_records`` and the tenant's
  rows of ``materialize``;
- the defaults and refusals: ``SlotPool`` and ``ChainServer`` default to
  ``"compact8"`` (as the JAX ones), an unknown tier is refused; a server's
  manifest journals the tier.
"""

import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu.serve.pool import SlotPool as JaxPool
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.convert import model_arrays_from_fields
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.parallel.ensemble import pad_model_arrays
from gibbs_student_t_tpu_torch.serve import (
    ChainServer,
    SlotPool,
    TenantRequest,
    TenantSlot,
)
from gibbs_student_t_tpu_torch.serve.manifest import read_manifest
from test_torch_host import _fields

torch.set_num_threads(1)

TIERS = ("full", "compact", "compact8", "light")
RUN_TIMEOUT_S = 300.0
FIELDS = ("chain", "bchain", "zchain", "thetachain", "alphachain",
          "poutchain", "dfchain")


def _drive(srv):
    """``srv.run()`` on a thread of its own, failing when it does not end
    in time; the server is closed afterwards."""
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
        srv.close()


@pytest.fixture(scope="module")
def demo():
    return (make_demo_model_arrays(),
            GibbsConfig(model="mixture").with_adapt(7))


# --- the tier against the solo sampler ---------------------------------------

@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["serial", "pipelined"])
@pytest.mark.parametrize("record", TIERS)
def test_tier_tenant_equals_solo_sampler(demo, record, pipeline):
    ma, cfg = demo
    srv = ChainServer(ma, cfg, nlanes=48, quantum=5, record=record,
                      device="cpu", pipeline=pipeline)
    assert srv.pool.record == record
    h2 = srv.submit(TenantRequest(ma=make_demo_model_arrays(seed=7),
                                  niter=15, nchains=16, seed=13))
    h = srv.submit(TenantRequest(ma=ma, niter=10, nchains=20, seed=3))
    _drive(srv)
    rv = h.result(timeout=0)
    rs = TorchGibbs(ma, cfg, nchains=20, device="cpu", chunk_size=5,
                    tnt_block_size=None, record=record).sample(niter=10,
                                                               seed=3)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(rv, f), getattr(rs, f),
                                      err_msg=f)
        assert getattr(rv, f).dtype == getattr(rs, f).dtype, f
    for k in ("acc_white", "acc_hyper", "record_mode"):
        np.testing.assert_array_equal(rv.stats[k], rs.stats[k], err_msg=k)
    assert str(rv.stats["record_mode"]) == record
    assert rv.stats["n_toa"].tolist() == [ma.n]
    assert h2.result(timeout=0).chain.shape == (15, 16, 3)


# --- the drain's pieces against the JAX pool ---------------------------------

def _as_numpy(t):
    """A host wire tensor as the JAX pool holds it: numpy, bfloat16 as
    ``ml_dtypes.bfloat16``."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.fixture(scope="module")
def jax_models():
    """The pool's template and a 100-TOA tenant, each as the JAX package's
    model and as the port's (the same numbers)."""
    jt = jax_demo_model_arrays(components=5)
    js = jax_demo_model_arrays(n=100, components=5, seed=9)
    return {k: (j, model_arrays_from_fields(_fields(j)))
            for k, j in (("template", jt), ("small", js))}


@pytest.mark.parametrize("hetero", [False, True],
                         ids=["homogeneous", "heterogeneous"])
@pytest.mark.parametrize("record", TIERS)
def test_materialize_tenant_matches_jax_pool(jax_models, record, hetero):
    cfg = GibbsConfig(model="mixture")
    (jt, tt), (_, ts) = jax_models["template"], jax_models["small"]
    pool = SlotPool(tt, cfg, nlanes=32, quantum=5, record=record,
                    device="cpu", heterogeneous=hetero)
    jpool = JaxPool(jt, JaxConfig(model="mixture"), nlanes=32, quantum=5,
                    record=record, heterogeneous=hetero)
    ma = pad_model_arrays([ts], n_to=tt.n)[0] if hetero else tt
    n_real = ts.n if hetero else tt.n
    smp = TorchGibbs(ma, cfg, nchains=12, device="cpu", tnt_block_size=None)
    # lanes 16..27 of the second group (four pad lanes after them)
    slot = TenantSlot(0, np.arange(16, 32), 12, 5, 0, 4, n_real=n_real)
    pool.write_tenant(slot, smp, smp.init_state(seed=4))
    recs, _ = pool.run_quantum()
    wire = pool.wire_host(recs)
    assert list(wire) == list(pool.fields)
    n_bytes = -(-tt.n // 8)
    if record in ("compact", "compact8"):
        assert wire["z"].dtype == torch.uint8
        assert wire["z"].shape == (5, 32, n_bytes)
        assert wire["b"].dtype == wire["alpha"].dtype == torch.bfloat16
        assert wire["pout"].dtype == (torch.uint8 if record == "compact8"
                                      else torch.float16)
    else:
        assert all(a.dtype == torch.float32 for a in wire.values())
    assert pool.wire_bytes == sum(a.numel() * a.element_size()
                                  for a in wire.values())
    cols = pool.tenant_wire(wire, slot)
    dev = pool.tenant_wire_device(recs, slot)
    for f in pool.fields:
        assert torch.equal(cols[f], dev[f]), f
        assert cols[f].shape[:2] == (5, 12), f
    got = pool.materialize_tenant(cols, n_real)
    want = jpool.materialize_tenant(
        {f: np.swapaxes(_as_numpy(cols[f]), 0, 1) for f in pool.fields},
        n_real)
    per_q = pool.tenant_quantum_records(wire, slot)
    from_all = pool.tenant_records(pool.materialize(recs), slot)
    for f in pool.fields:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert got[f].dtype == np.float32, f
        np.testing.assert_array_equal(per_q[f], got[f], err_msg=f)
        np.testing.assert_array_equal(from_all[f], got[f], err_msg=f)
        if f in ("z", "alpha", "pout"):
            assert got[f].shape == (5, 12, n_real), f


# --- defaults and refusals ---------------------------------------------------

def test_default_tier_and_refusal(tmp_path):
    ma = make_demo_model_arrays(components=5)
    cfg = GibbsConfig(model="mixture")
    assert SlotPool(ma, cfg, nlanes=16, device="cpu").record == "compact8"
    man = str(tmp_path / "manifest")
    srv = ChainServer(ma, cfg, nlanes=16, quantum=5, device="cpu",
                      manifest_dir=man)
    try:
        assert srv.pool.record == "compact8"
        (head,) = [r for r in read_manifest(man) if r["kind"] == "server"]
        assert head["record"] == "compact8"
        assert head["heterogeneous"] is False
    finally:
        srv.close()
    for make in (SlotPool, ChainServer):
        with pytest.raises(ValueError, match="record must be"):
            make(ma, cfg, nlanes=16, record="narrow", device="cpu")
