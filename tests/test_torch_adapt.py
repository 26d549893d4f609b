"""The port's adaptive block scans and flow warm starts on the CPU, held
against the JAX package's (the 5-component demo model, 32 lanes, quantum
5).

- ``serve/adapt.py`` against the JAX module on the same inputs: the block
  constants (and the sweep's copies), ``AdaptScanSpec``'s checks,
  ``resolve_adapt_scan`` under each ``GST_ADAPT_SCAN`` value,
  ``param_blocks`` on the demo model, ``selection_probs`` and
  ``draw_gates`` bitwise; the four ``GST_*`` gates' validation;
- the sweep's block gates: all ones bitwise the ungated sweep on both b
  paths (Schur and plain), with Robbins-Monro adapting; each single-block
  gate leaves exactly the fields JAX's leaves carried (b tied to hyper, a
  gated MH block's acceptance 0 and its Robbins-Monro term frozen);
- the pool's gates: all ones bitwise a pool built with
  ``GST_ADAPT_SCAN=0``, with the same kernel-entry calls a sweep; a
  thinned tenant's gated fields its carried values, its neighbour bitwise
  its run in an ungated pool;
- the flow fit (``serve/warm.FlowWarmStartFit``, torch autograd on the
  CPU): journaled fits of either package replayed bitwise by the other;
  its trained NLL at or below the identity's and within 0.25 nats a row of
  the JAX fit's on the same rows; ``GST_WARM_FLOW`` forcing and the
  failure fallback to the mixture, as JAX's;
- one shared pipelined server: two monitored adaptive tenants thin, a
  monitored-only and a plain tenant do not; submit's checks; the plain
  tenant bitwise on a server with all three gates off; a wave of batched
  pilots; a flow warm start served on the pool, and degraded to the
  mixture by ``GST_WARM_FLOW=0``.

Every run is driven on a thread of its own with a time limit, so a hang
fails instead of stalling the suite.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.backends import jax_backend as jax_jb
from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
from gibbs_student_t_tpu.config import MHConfig as JaxMH
from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu.serve import adapt as jax_adapt
from gibbs_student_t_tpu.serve import monitor as jax_monitor
from gibbs_student_t_tpu.serve import server as jax_server
from gibbs_student_t_tpu.serve import warm as jax_warm
from gibbs_student_t_tpu_torch.backends import torch_backend as port_tb
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig, MHConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.models.parameter import KIND_UNIFORM
from gibbs_student_t_tpu_torch.serve import (
    AdaptScanSpec,
    ChainServer,
    MonitorSpec,
    SlotPool,
    TenantRequest,
    TenantSlot,
    WarmStartSpec,
)
from gibbs_student_t_tpu_torch.serve import adapt as port_adapt
from gibbs_student_t_tpu_torch.serve import monitor as port_monitor
from gibbs_student_t_tpu_torch.serve import pool as port_pool
from gibbs_student_t_tpu_torch.serve import server as port_server
from gibbs_student_t_tpu_torch.serve import warm as port_warm

pytestmark = pytest.mark.adapt

torch.set_num_threads(1)

FIELDS = ("chain", "bchain", "zchain", "thetachain", "alphachain",
          "poutchain", "dfchain")
RUN_TIMEOUT_S = 180.0
Q = 5
C = 16
#: the flow fit's trained NLL (nats a row, standardized data) may exceed
#: the JAX fit's by this much: the two trainings start from other random
#: first layers and take 300 steps
NLL_TOL = 0.25


def _drive(srv):
    """``srv.run()`` on a thread of its own; fails when it does not end in
    time, and re-raises what it raised."""
    box = []

    def target():
        try:
            srv.run()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box.append(e)

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(RUN_TIMEOUT_S)
    if th.is_alive():
        srv._stop.set()
        th.join(10.0)
        pytest.fail(f"the server's run did not end in {RUN_TIMEOUT_S} s")
    if box:
        raise box[0]


def _bitwise(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for k in ("acc_white", "acc_hyper"):
        np.testing.assert_array_equal(got.stats[k], want.stats[k], err_msg=k)


def _verdict(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.fixture(scope="module")
def demo():
    return make_demo_model_arrays(components=5), GibbsConfig(model="mixture")


# --- serve/adapt.py against the JAX module -----------------------------------

def test_block_constants_match_jax():
    for name in ("BLOCK_NAMES", "NBLOCKS", "BLOCK_WHITE", "BLOCK_HYPER"):
        assert getattr(port_adapt, name) == getattr(jax_adapt, name), name
        assert getattr(port_tb, name) == getattr(jax_jb, name), name
    for name in ("BLOCK_B", "BLOCK_THETA", "BLOCK_Z", "BLOCK_ALPHA",
                 "BLOCK_DF"):
        assert getattr(port_tb, name) == getattr(jax_jb, name), name
    assert port_adapt.THINNABLE == jax_adapt.THINNABLE
    # one definition: the adaptive scan's and the monitor's are the sweep's
    assert port_adapt.BLOCK_NAMES is port_tb.BLOCK_NAMES
    assert not hasattr(port_monitor, "BLOCK_NAMES")


def test_adapt_spec_checks_match_jax():
    cases = [{}, dict(ess_target=100.0, floor=1.0), dict(floor=0.0),
             dict(floor=1.5), dict(ess_target=-1.0), dict(ess_target=0.0)]
    for kw in cases:
        got = _verdict(lambda: vars(port_adapt.AdaptScanSpec(**kw)))
        want = _verdict(lambda: vars(jax_adapt.AdaptScanSpec(**kw)))
        assert got == want, kw


def test_resolve_adapt_scan_matches_jax():
    def view(mod, mon_mod):
        out = []
        spec = mod.AdaptScanSpec(floor=0.5)
        for env in ("auto", "1", "0"):
            for req in (spec, None, {"floor": 0.5}):
                for mon in (mon_mod.MonitorSpec(ess_target=10.0), None,
                            mon_mod.MonitorSpec()):
                    v = _verdict(mod.resolve_adapt_scan, req, mon, env=env)
                    if v[0] == "ok" and v[1] is not None:
                        v = ("spec", vars(v[1]), v[1] is spec)
                    out.append(v)
        return out

    assert view(port_adapt, port_monitor) == view(jax_adapt, jax_monitor)


def test_param_blocks_on_demo_match_jax():
    ma = make_demo_model_arrays(components=5)
    jma = jax_demo_model_arrays(components=5)
    pidx = list(range(len(ma.param_names)))
    got = port_adapt.param_blocks(pidx, ma.white_indices, ma.hyper_indices)
    want = jax_adapt.param_blocks(pidx, np.asarray(jma.white_indices),
                                  np.asarray(jma.hyper_indices))
    np.testing.assert_array_equal(got, want)
    assert set(got) >= {0, 1}


@pytest.mark.parametrize("block_ess,target,floor", [
    ({}, 100.0, 0.1), ({0: 50.0, 1: 99.0}, 100.0, 0.1),
    ({0: 400.0, 1: 120.0}, 100.0, 0.1), ({0: 1e9}, 100.0, 0.2),
    ({3: 1e9, 6: 1e9}, 100.0, 0.1), ({0: float("nan"), 1: 1e4}, 7.0, 0.3),
])
def test_selection_probs_match_jax(block_ess, target, floor):
    got = port_adapt.selection_probs(block_ess, target, floor)
    want = jax_adapt.selection_probs(block_ess, target, floor)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_draw_gates_match_jax():
    rng = np.random.default_rng(5)
    for i in range(200):
        probs = np.where(rng.random(7) < 0.5, 1.0, rng.random(7))
        seed, tid, sweep = (int(v) for v in rng.integers(0, 2**33, 3))
        got = port_adapt.draw_gates(probs, seed, tid, sweep)
        want = jax_adapt.draw_gates(probs, seed, tid, sweep)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.float32


GATES = {
    "GST_ADAPT_SCAN": (port_adapt.adapt_scan_env, jax_adapt.adapt_scan_env),
    "GST_WARM_START": (port_warm.warm_start_env, jax_warm.warm_start_env),
    "GST_WARM_FLOW": (port_warm.warm_flow_env, jax_warm.warm_flow_env),
    "GST_RECYCLE": (port_server.serve_recycle_env,
                    jax_server.serve_recycle_env),
}


@pytest.mark.parametrize("var", sorted(GATES))
def test_env_gates_match_jax(var, monkeypatch):
    """Strict ``auto|1|0``: the same value for each, and a typo raises a
    ``ValueError`` naming the variable, in both packages."""
    port_fn, jax_fn = GATES[var]
    monkeypatch.delenv(var, raising=False)
    assert port_fn() == jax_fn() == "auto"
    for v in ("auto", "1", "0"):
        monkeypatch.setenv(var, v)
        assert port_fn() == jax_fn() == v
    for bad in ("yes", "2"):
        monkeypatch.setenv(var, bad)
        for fn in (port_fn, jax_fn):
            with pytest.raises(ValueError, match=var):
                fn()


# --- the sweep's block gates -------------------------------------------------

def _gate_cfg(mod_cfg, mod_mh):
    return mod_cfg(model="mixture", mh=mod_mh(adapt_until=50))


def _status(before, gated, ungated, white, hyper):
    """Each field's fate under a gate: ``carried`` (its value before the
    sweep, where the ungated sweep moved it), ``zero`` (an acceptance the
    gate zeroed), else ``new``. x and the Robbins-Monro scales split into
    their white and hyper parts."""
    def parts(st):
        out = {f: np.asarray(getattr(st, f), np.float64)
               for f in ("b", "theta", "z", "pout", "alpha", "df",
                         "acc_white", "acc_hyper")}
        x = np.asarray(st.x, np.float64)
        ls = np.asarray(st.mh_log_scale, np.float64)
        out.update({"x_white": x[:, white], "x_hyper": x[:, hyper],
                    "scale_white": ls[:, 0], "scale_hyper": ls[:, 1]})
        return out

    b, g, u = parts(before), parts(gated), parts(ungated)
    status = {}
    for f in b:
        assert not np.array_equal(u[f], b[f]), f"{f} did not move ungated"
        if np.array_equal(g[f], b[f]):
            status[f] = "carried"
        elif f.startswith("acc") and not g[f].any() and u[f].any():
            status[f] = "zero"
        else:
            status[f] = "new"
    return status


@pytest.fixture(scope="module")
def port_gate_runs():
    """The port's sweep from one state (a sweep in, so acceptances and
    scales have moved), ungated, with all-ones gates, and with each block
    gated alone, on both b paths."""
    ma = make_demo_model_arrays(components=5)
    out = {}
    for branch in ("schur", "plain"):
        with pytest.MonkeyPatch.context() as mp:
            if branch == "plain":
                # no phi-static column: the full-factor b draw
                mp.setattr(port_tb, "static_phi_columns",
                           lambda mm: np.zeros(mm.m, bool))
            smp = TorchGibbs(ma, _gate_cfg(GibbsConfig, MHConfig),
                             nchains=C, device="cpu", tnt_block_size=None)
        assert (smp._schur is None) == (branch == "plain")
        keys = smp._chain_keys(3)
        st = smp._sweep(smp.init_state(seed=3),
                        smp._draw(keys, torch.tensor(0),
                                  smp.init_state(seed=3)), sweep=0)
        draws = smp._draw(keys, torch.tensor(1), st)
        runs = {"none": smp._sweep(st, draws, sweep=1),
                "ones": smp._sweep(st, draws, sweep=1,
                                   block_gates=torch.ones(C, 7))}
        for k in range(7):
            g = torch.ones(C, 7)
            g[:, k] = 0.0
            runs[k] = smp._sweep(st, draws, sweep=1, block_gates=g)
        out[branch] = (st, runs)
    return out, ma


@pytest.fixture(scope="module")
def jax_gate_runs():
    """The JAX sweep, the same gates, from its own state a sweep in."""
    jma = jax_demo_model_arrays(components=5)
    jb = jax_jb.JaxGibbs(jma, _gate_cfg(JaxConfig, JaxMH), nchains=C,
                         tnt_block_size=None, use_pallas=False,
                         telemetry=False)
    sweep = jax.jit(jax.vmap(
        lambda s, k, g: jb._sweep(s, k, sweep=1, block_gates=g),
        in_axes=(0, 0, None)))
    plain = jax.jit(jax.vmap(lambda s, k: jb._sweep(s, k, sweep=0)))
    keys = jax.random.split(jax.random.PRNGKey(3), 2 * C)
    st = plain(jb.init_state(seed=3), keys[:C])
    runs = {"none": jax.jit(jax.vmap(
        lambda s, k: jb._sweep(s, k, sweep=1)))(st, keys[C:])}
    for k in range(7):
        g = np.ones(7, np.float32)
        g[k] = 0.0
        runs[k] = sweep(st, keys[C:], jnp.asarray(g))
    return st, runs, jma


@pytest.mark.parametrize("branch", ["schur", "plain"])
def test_all_ones_gates_bitwise_ungated(port_gate_runs, branch):
    (runs_by_branch, _) = port_gate_runs
    _, runs = runs_by_branch[branch]
    for a, b in zip(runs["ones"], runs["none"]):
        assert torch.equal(a, b)


EXPECTED_CARRIED = {
    0: {"x_white", "scale_white"}, 1: {"x_hyper", "b", "scale_hyper"},
    2: {"b"}, 3: {"theta"}, 4: {"z", "pout"}, 5: {"alpha"}, 6: {"df"}}
EXPECTED_ZERO = {0: {"acc_white"}, 1: {"acc_hyper"}}


@pytest.mark.parametrize("block", range(7),
                         ids=list(port_tb.BLOCK_NAMES))
def test_single_block_gate_matches_jax(port_gate_runs, jax_gate_runs,
                                       block):
    """Gate one block: the fields it leaves carried (and the acceptance it
    zeroes) are JAX's, on both b paths: b follows hyper's gate, a gated MH
    block's Robbins-Monro scale is frozen."""
    runs_by_branch, ma = port_gate_runs
    jst, jruns, jma = jax_gate_runs
    want = _status(jst, jruns[block], jruns["none"],
                   np.asarray(jma.white_indices),
                   np.asarray(jma.hyper_indices))
    for branch in ("schur", "plain"):
        st, runs = runs_by_branch[branch]
        got = _status(st, runs[block], runs["none"], ma.white_indices,
                      ma.hyper_indices)
        assert got == want, branch
    assert {f for f, s in want.items() if s == "carried"} \
        == EXPECTED_CARRIED[block]
    assert {f for f, s in want.items() if s == "zero"} \
        == EXPECTED_ZERO.get(block, set())


# --- the pool's gates ------------------------------------------------------------

_ENTRIES = (("serve.pool", port_pool, ("white_mh_lanes", "hyper_mh_lanes",
                                       "tnt_lanes")),
            ("backends.torch_backend", port_tb, ("sweep_draws",)))


def _pool_run(demo, monkeypatch, gates=None, adaptive=True, quanta=2):
    """A 48-lane CPU pool with two tenants (seeds 4 and 5, groups 0 and
    2); ``gates`` set on the first tenant's lanes before each quantum.
    Returns its records per tenant, its final states and the calls of each
    kernel entry."""
    ma, cfg = demo
    if not adaptive:
        monkeypatch.setenv("GST_ADAPT_SCAN", "0")
    pool = SlotPool(ma, cfg, nlanes=48, quantum=Q, record="full", device="cpu")
    monkeypatch.delenv("GST_ADAPT_SCAN", raising=False)
    assert pool.adaptive is adaptive
    smp = TorchGibbs(ma, cfg, nchains=16, device="cpu", tnt_block_size=None)
    slots = [TenantSlot(0, np.arange(16), 16, Q * quanta, 0, 4),
             TenantSlot(1, np.arange(32, 48), 16, Q * quanta, 0, 5)]
    for s in slots:
        pool.write_tenant(s, smp, smp.init_state(seed=s.seed))
    calls = {}
    for _, mod, names in _ENTRIES:
        for name in names:
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **kw)

            monkeypatch.setattr(mod, name, counted)
    recs = {0: [], 1: []}
    ungated = []
    for _ in range(quanta):
        if gates is not None:
            pool.set_block_gates(slots[0].lanes, gates)
        host = pool.materialize(pool.run_quantum()[0])
        ungated.append(pool.block_gates() is None)
        for s in slots:
            recs[s.tenant_id].append(pool.tenant_records(host, s))
    monkeypatch.undo()
    cols = {tid: {f: np.concatenate([r[f] for r in rs]) for f in rs[0]}
            for tid, rs in recs.items()}
    return cols, [pool.tenant_state(s) for s in slots], calls, ungated


def test_pool_ones_gates_bitwise_gates_off(demo, monkeypatch):
    """Armed gates, all ones: the tenants bitwise a pool built with
    ``GST_ADAPT_SCAN=0``, the sweep ungated, the same entry calls."""
    on = _pool_run(demo, monkeypatch, gates=np.ones(7, np.float32))
    off = _pool_run(demo, monkeypatch, adaptive=False)
    for tid in (0, 1):
        for f in on[0][tid]:
            np.testing.assert_array_equal(on[0][tid][f], off[0][tid][f],
                                          err_msg=f)
    for a, b in zip(on[1], off[1]):
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    assert on[2] == off[2] and on[2]["sweep_draws"] == 2 * Q
    assert all(on[3]) and all(off[3])


def test_pool_thinned_tenant_carries_gated_fields(demo, monkeypatch):
    """White, hyper (so b) and z gated on the first tenant: its x, b, z
    and pout stay its initial ones through both quanta while theta, alpha
    and df move; its neighbour is bitwise its run in an ungated pool."""
    gates = np.ones(7, np.float32)
    gates[[0, 1, 4]] = 0.0
    cols, states, calls, ungated = _pool_run(demo, monkeypatch, gates=gates)
    ref = _pool_run(demo, monkeypatch)
    t0 = cols[0]
    for f in ("x", "b", "z", "pout"):
        assert (t0[f] == t0[f][:1]).all(), f
    for f in ("theta", "alpha", "df"):
        assert not (t0[f] == t0[f][:1]).all(), f
    assert not t0["acc_white"][1:].any() and not t0["acc_hyper"][1:].any()
    assert torch.equal(states[0].x, torch.as_tensor(t0["x"][0]))
    for f in cols[1]:
        np.testing.assert_array_equal(cols[1][f], ref[0][1][f], err_msg=f)
    assert not any(ungated)
    assert calls == ref[2]          # a gated block still launches


# --- the flow fit --------------------------------------------------------------

def _pilot_rows(rows=40, chains=8, p=5, seed=0):
    """Bimodal pilot rows (the JAX test's) and uniform [-10, 10] priors."""
    rng = np.random.default_rng(seed)
    modes = np.where(rng.random((chains, 1)) < 0.5, -2.0, 2.0)
    data = modes[None] + 0.3 * rng.standard_normal((rows, chains, p))
    specs = np.zeros((p, 3))
    specs[:, 0] = KIND_UNIFORM
    specs[:, 1], specs[:, 2] = -10.0, 10.0
    return data, specs


def _nll(fit, post):
    """The flow's NLL a row on its standardized data, float64 numpy: the
    inverse of ``_forward_np`` with its log-determinant."""
    data = np.asarray(post, np.float64).reshape(-1, post.shape[-1])
    x = (data - fit.means[0]) / fit.stds[0]
    p = x.shape[1]
    ld = np.zeros(x.shape[0])
    for lyr in reversed(fit.flow["layers"]):
        m = np.asarray(lyr["mask"])
        hid = np.tanh((x * m) @ np.asarray(lyr["W1"]) + np.asarray(lyr["b1"]))
        st = hid @ np.asarray(lyr["W2"]) + np.asarray(lyr["b2"])
        s = np.tanh(st[:, :p]) * (1.0 - m)
        t = st[:, p:] * (1.0 - m)
        x = m * x + (1.0 - m) * ((x - t) * np.exp(-s))
        ld -= s.sum(axis=1)
    return float(np.mean(0.5 * np.sum(x * x, axis=1) - ld))


@pytest.fixture(scope="module")
def flow_fits():
    data, specs = _pilot_rows()
    spec_kw = dict(pilot_sweeps=40, kind="flow")
    port = port_warm.fit_from_rows(data, port_warm.WarmStartSpec(**spec_kw),
                                   specs, pilot_ms=5.0)
    jfit = jax_warm.fit_from_rows(data, jax_warm.WarmStartSpec(**spec_kw),
                                  specs, pilot_ms=5.0)
    return data, specs, port, jfit


def test_flow_fit_journal_replays_across_packages(flow_fits):
    """A flow fit journaled by either package (JSON on the wire) replays
    through the other's base ``from_json`` to the same x0, bit for bit."""
    _, specs, port, jfit = flow_fits
    assert isinstance(port, port_warm.FlowWarmStartFit)
    assert np.isfinite(port.meta["nll"]) and port.meta["steps"] == 300
    for src, dst_mod in ((port, jax_warm), (jfit, port_warm)):
        d = json.loads(json.dumps(src.to_json()))
        back = dst_mod.WarmStartFit.from_json(d)
        assert type(back).__name__ == "FlowWarmStartFit"
        for seed in (1234, 5, 2**32 + 7):
            np.testing.assert_array_equal(back.draw_x0(16, seed, specs),
                                          src.draw_x0(16, seed, specs))
        via = dst_mod.resolve_warm_start(d, env="auto")
        np.testing.assert_array_equal(via.draw_x0(8, 3, specs),
                                      src.draw_x0(8, 3, specs))
    x = port.draw_x0(16, 1234, specs)
    assert np.all(x >= -10.0) and np.all(x <= 10.0)
    assert not np.array_equal(port.draw_x0(8, 5, specs),
                              port.draw_x0(8, 6, specs))
    with pytest.raises(ValueError, match="flow"):
        port_warm.FlowWarmStartFit.from_json(
            {"kind": "flow", "means": [[0.0]], "stds": [[1.0]],
             "weights": [1.0]})


def test_flow_fit_nll_vs_identity_and_jax(flow_fits):
    data, _, port, jfit = flow_fits
    post = data[int(0.5 * data.shape[0]):]
    ident = port_warm.FlowWarmStartFit.from_json(
        json.loads(json.dumps(port.to_json())))
    for lyr in ident.flow["layers"]:
        lyr["W2"] = np.zeros_like(np.asarray(lyr["W2"])).tolist()
        lyr["b2"] = np.zeros_like(np.asarray(lyr["b2"])).tolist()
    nll_port, nll_jax, nll_id = (_nll(f, post) for f in (port, jfit, ident))
    assert nll_port <= nll_id
    print(f"flow NLL a row: port {nll_port:.4f}, JAX {nll_jax:.4f}, "
          f"identity {nll_id:.4f}")
    assert nll_port <= nll_jax + NLL_TOL, (nll_port, nll_jax, nll_id)
    # the journaled standardization is the same arithmetic in both
    np.testing.assert_allclose(port.means, jfit.means, rtol=1e-12)
    np.testing.assert_allclose(port.stds, jfit.stds, rtol=1e-12)


def test_flow_env_forces_degrades_and_fails_like_jax(monkeypatch):
    data, specs = _pilot_rows()
    for mod in (port_warm, jax_warm):
        assert [mod.resolve_fit_kind(k, env=e)
                for k in ("gmm", "flow") for e in ("auto", "1", "0")] \
            == ["gmm", "flow", "gmm", "flow", "flow", "gmm"]
    monkeypatch.setenv("GST_WARM_FLOW", "1")
    fit = port_warm.fit_from_rows(
        data, port_warm.WarmStartSpec(pilot_sweeps=40), specs)
    assert isinstance(fit, port_warm.FlowWarmStartFit)
    monkeypatch.setenv("GST_WARM_FLOW", "0")
    got = port_warm.fit_from_rows(
        data, port_warm.WarmStartSpec(pilot_sweeps=40, kind="flow"), specs)
    want = jax_warm.fit_from_rows(
        data, jax_warm.WarmStartSpec(pilot_sweeps=40, kind="flow"), specs)
    assert type(got) is port_warm.WarmStartFit and got.kind == "gmm"
    assert got.meta == want.meta == {"flow_degraded": "GST_WARM_FLOW=0"}
    monkeypatch.delenv("GST_WARM_FLOW")
    # too few rows to train: the mixture, warm, with the reason
    small, specs = _pilot_rows(rows=3, chains=1)
    spec = port_warm.WarmStartSpec(pilot_sweeps=8, burn_frac=0.0,
                                   kind="flow")
    with pytest.warns(RuntimeWarning, match="flow warm-start"):
        fit = port_warm.fit_from_rows(small, spec, specs)
    assert type(fit) is port_warm.WarmStartFit
    assert "flow_degraded" in fit.meta


# --- the shared server -----------------------------------------------------------

PARITY = dict(niter=15, nchains=16, seed=3, name="parity")


def _server(demo, **kw):
    ma, cfg = demo
    return ChainServer(ma, cfg, nlanes=32, quantum=Q, record="full",
                       device="cpu", spans=False, flight=False,
                       watchdog=False, **kw)


@pytest.fixture(scope="module")
def pool_adapt(demo):
    """ONE pipelined server: two monitored adaptive tenants (an ESS target
    small enough to thin), a monitored-only tenant and a plain one."""
    ma, _ = demo
    srv = _server(demo)
    assert srv.pool.adaptive
    mon = MonitorSpec(ess_target=4.0, min_rows=8)
    hs = {
        "a0": srv.submit(TenantRequest(
            ma=ma, niter=60, nchains=16, seed=0, name="a0", monitor=mon,
            adapt_scan=AdaptScanSpec(floor=0.25))),
        "a1": srv.submit(TenantRequest(
            ma=ma, niter=40, nchains=16, seed=1, name="a1", monitor=mon,
            adapt_scan=AdaptScanSpec(floor=0.25))),
        "mon_only": srv.submit(TenantRequest(
            ma=ma, niter=20, nchains=16, seed=2, name="mon_only",
            monitor=mon)),
        "parity": srv.submit(TenantRequest(ma=ma, **PARITY)),
    }
    _drive(srv)
    out = {"server": srv, "handles": hs,
           "results": {k: h.result(timeout=0) for k, h in hs.items()},
           "summary": srv.summary()}
    yield out
    srv.close()


def test_adaptive_thinning_end_to_end(pool_adapt):
    s = pool_adapt["summary"]["adapt"]
    assert s["enabled"] is True and s["updates"] > 0
    assert s["tenants_thinned"] >= 1
    hs = pool_adapt["handles"]
    thinned = [h for h in (hs["a0"], hs["a1"]) if h.adapt is not None]
    assert thinned, "no adaptive tenant ever thinned"
    for h in thinned:
        a = h.progress()["adapt"]
        assert len(a["gates"]) == 7 and set(a["gates"]) <= {0, 1}
        assert a["updates"] >= 1
        assert set(a["probs"]) <= {"white", "hyper"}
        for p in a["probs"].values():
            assert 0.25 <= p < 1.0
        # the gates are the (seed, tenant, sweep) draw of those probs
        probs = np.ones(7)
        for name, p in a["probs"].items():
            probs[port_adapt.BLOCK_NAMES.index(name)] = p
        drawn = port_adapt.draw_gates(probs, h.request.seed, h.tenant_id,
                                      a["sweep"])
        assert a["gates"] == [int(g) for g in drawn]
        res = pool_adapt["results"]["a0" if h is hs["a0"] else "a1"]
        assert np.isfinite(res.chain).all()
    for name in ("mon_only", "parity"):
        assert hs[name].adapt is None
    for name in ("a0", "a1", "mon_only"):
        blocks = hs[name].progress()["blocks"]
        assert {"white", "hyper"} <= set(blocks)


def test_adapt_scan_submit_checks(pool_adapt, demo):
    ma, _ = demo
    srv = pool_adapt["server"]
    with pytest.raises(ValueError, match="needs a monitor"):
        srv.submit(TenantRequest(ma=ma, niter=10, nchains=16, seed=9,
                                 adapt_scan=AdaptScanSpec()))
    with pytest.raises(ValueError, match="needs an ESS target"):
        srv.submit(TenantRequest(ma=ma, niter=10, nchains=16, seed=9,
                                 monitor=MonitorSpec(),
                                 adapt_scan=AdaptScanSpec()))
    with pytest.raises(ValueError, match="AdaptScanSpec"):
        srv.submit(TenantRequest(ma=ma, niter=10, nchains=16, seed=9,
                                 monitor=MonitorSpec(ess_target=4.0),
                                 adapt_scan={"floor": 0.5}))


def test_gates_off_bitwise(pool_adapt, demo, monkeypatch):
    """``GST_ADAPT_SCAN=0``, ``GST_WARM_START=0`` and ``GST_RECYCLE=0``:
    the plain tenant bitwise its run on the default server beside thinning
    tenants, with no new key in its records, stats or the summary's
    switches."""
    ma, _ = demo
    for var in ("GST_ADAPT_SCAN", "GST_WARM_START", "GST_RECYCLE"):
        monkeypatch.setenv(var, "0")
    srv = _server(demo)
    chunks = []
    try:
        assert srv.pool.adaptive is False and srv.recycle is False
        h = srv.submit(TenantRequest(
            ma=ma, on_chunk=lambda hh, s, r: chunks.append(sorted(r)),
            **PARITY))
        _drive(srv)
        res = h.result(timeout=0)
        summ = srv.summary()
    finally:
        srv.close()
    _bitwise(res, pool_adapt["results"]["parity"])
    assert all("row_class" not in keys for keys in chunks) and chunks
    assert not {"recycle", "warm"} & set(res.stats)
    assert h.recycled_rows == 0 and h.warm is None and h.adapt is None
    assert summ["adapt"]["enabled"] is False
    assert summ["recycle"] == {"enabled": False, "recycled_lane_rows": 0}
    assert sorted(res.stats) == sorted(
        k for k in pool_adapt["results"]["parity"].stats if k != "recycle")


def test_pilot_batching_rides_one_wave(pool_adapt, demo):
    """Three queued warm tenants: at least one wave; riders served from
    the wave's cache, their pilot walls not billed again; the cache
    empty afterwards."""
    ma, _ = demo
    srv = pool_adapt["server"]
    before = srv.summary()["warm"]
    spec = WarmStartSpec(pilot_sweeps=10, pilot_chains=8)
    hs = [srv.submit(TenantRequest(ma=ma, niter=10, nchains=16,
                                   seed=20 + i, name=f"w{i}",
                                   warm_start=spec)) for i in range(3)]
    _drive(srv)
    for h in hs:
        h.result(timeout=0)
        assert h.warm is not None and h.warm["kind"] == "gmm"
    after = srv.summary()["warm"]
    assert after["warm_starts"] - before["warm_starts"] == 3
    assert after["pilot_batches"] > before["pilot_batches"]
    n_batched = sum(1 for h in hs if h.warm["batched"])
    assert after["pilot_batched_fits"] - before["pilot_batched_fits"] \
        == n_batched >= 1
    solo_ms = sum(h.warm["pilot_ms"] for h in hs if not h.warm["batched"])
    assert after["pilot_ms_total"] - before["pilot_ms_total"] \
        == pytest.approx(solo_ms, abs=0.5)
    assert srv._pilot_fits == {}
    # the pilots stayed out of the SLO series
    assert len(srv._admission_ms) == len(pool_adapt["handles"]) + 3


def test_flow_warm_start_on_pool_and_degraded(pool_adapt, demo,
                                              monkeypatch):
    ma, _ = demo
    srv = pool_adapt["server"]
    spec = WarmStartSpec(pilot_sweeps=10, pilot_chains=8, kind="flow")
    h = srv.submit(TenantRequest(ma=ma, niter=10, nchains=16, seed=30,
                                 name="fw", warm_start=spec))
    _drive(srv)
    h.result(timeout=0)
    assert h.warm["kind"] == "flow" and "flow_degraded" not in h.warm
    assert srv.summary()["warm"]["flow_fits"] >= 1
    before = srv.summary()["warm"]["flow_degraded"]
    monkeypatch.setenv("GST_WARM_FLOW", "0")
    h2 = srv.submit(TenantRequest(ma=ma, niter=10, nchains=16, seed=31,
                                  name="fw0", warm_start=spec))
    _drive(srv)
    h2.result(timeout=0)
    assert h2.warm["kind"] == "gmm"
    assert h2.warm["flow_degraded"] == "GST_WARM_FLOW=0"
    assert srv.summary()["warm"]["flow_degraded"] == before + 1
