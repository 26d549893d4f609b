"""The port's meshes (``parallel/mesh.py``, ``parallel/multihost.py``), the
ensemble over a mesh (``EnsembleGibbs(mesh=)``) and the kernels' device
guard (``ops/_cuda.py``), on the CPU, against the JAX package.

- ``make_mesh`` and the one-process ``make_hybrid_mesh`` give the JAX
  package's ``axis_names``, ``devices.shape`` and ``shape`` on the same
  axes (the 8 virtual devices of tests/conftest.py serve JAX, lists of
  CPU devices the port); both raise ``ValueError`` matching "devices"
  on a wrong device count; ``make_mesh()`` raises without CUDA;
  ``initialize_distributed()`` is False with nothing configured, as
  JAX's, and several processes without a coordinator raise;
  ``local_shard`` gives JAX's slices over a grid of ``(n, size, index)``;
- the ensemble at 4 small pulsars x 8 chains, 10 sweeps with
  population-covariance adaptation: ``{"pulsar": 2, "chain": 4}`` and
  ``{"chain": 8}`` meshes equal ``mesh=None`` at rtol 2e-4 / atol 1e-5
  (the JAX package's ``test_ensemble_sharded_matches_unsharded`` gate),
  every recorded field and the last state, except b, alpha and pout,
  within 1e-3 of their largest magnitude (:data:`SCALED`); the
  covariance factors equal on each pulsar's chains; a 1 x 1 mesh equals it bit
  for bit, ``tele_*`` stats and last state included; uneven shards, a
  mesh with ``device=`` and an axis other than pulsar and chain raise;
  ``spool_dir``, ``sample_until`` and ``reinit_diverged`` on a
  one-process mesh give the unsharded run's results;
- the device guard: ``_cuda.launch`` calls its entry inside
  ``torch.cuda.device(<device>)`` with that device's stream, and every
  wrapper's CUDA branch (forced here on CPU tensors through
  ``_cuda.use_kernel``) launches once through ``_cuda.launch`` with its
  tensors' device; the stage timers record their events under the
  guard. One card cannot show a launch on the wrong device, and the CPU
  build cannot enter ``torch.cuda.device``: both are stubbed.
"""

import contextlib

import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.parallel import make_mesh as jax_make_mesh
from gibbs_student_t_tpu.parallel import multihost as jmh
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.ops import _cuda, chol, rng, timers
from gibbs_student_t_tpu_torch.ops import hyper_mh as thyper
from gibbs_student_t_tpu_torch.ops import tnt as ttnt
from gibbs_student_t_tpu_torch.ops import white_mh as twhite
from gibbs_student_t_tpu_torch.parallel import (
    EnsembleGibbs,
    initialize_distributed,
    local_shard,
    make_hybrid_mesh,
    make_mesh,
)

# The suite runs in parallel workers and these tensors are small: one
# PyTorch CPU thread per worker costs nothing here and leaves the other
# cores to the other workers.
torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL, ATOL = 2e-4, 1e-5
NP, NC, SWEEPS = 4, 8, 10
FIELDS = ("chain", "bchain", "zchain", "thetachain", "alphachain",
          "poutchain", "dfchain")


# --- meshes ---------------------------------------------------------------

@pytest.mark.parametrize("axes", [{"pulsar": 2, "chain": 4}, {"chain": 8},
                                  {"pulsar": 8}, {"pulsar": 4, "chain": 2}])
def test_make_mesh_matches_jax(axes):
    jm = jax_make_mesh(axes)
    tm = make_mesh(axes, [CPU] * 8)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.devices.shape == jm.devices.shape
    assert tm.shape == dict(jm.shape)
    assert tm.ranks.shape == tm.devices.shape and not tm.ranks.any()
    assert all(d == CPU for d in tm.devices.flat)


def test_mesh_device_count_errors_match_jax():
    with pytest.raises(ValueError, match="devices"):
        jax_make_mesh({"pulsar": 3})
    with pytest.raises(ValueError, match="devices"):
        make_mesh({"pulsar": 3}, [CPU] * 8)
    with pytest.raises(ValueError, match="devices"):
        jmh.make_hybrid_mesh({"chain": 3}, {"pulsar": 2})
    with pytest.raises(ValueError, match="devices"):
        make_hybrid_mesh({"chain": 3}, {"pulsar": 2}, devices=[CPU] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh({"chain": 1})
        with pytest.raises(RuntimeError, match="CUDA"):
            make_hybrid_mesh({"chain": 1})


@pytest.mark.parametrize("ici,dcn", [({"chain": 4}, {"pulsar": 2}),
                                     ({"chain": 8}, None),
                                     ({"pulsar": 2}, {"chain": 4})])
def test_single_process_hybrid_mesh_matches_jax(ici, dcn):
    jm = jmh.make_hybrid_mesh(ici, dcn)
    tm = make_hybrid_mesh(ici, dcn, devices=[CPU] * 8)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.devices.shape == jm.devices.shape
    assert tm.groups == {}


def test_initialize_distributed_needs_something_to_coordinate(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert jmh.initialize_distributed() is False
    assert initialize_distributed() is False
    assert initialize_distributed(num_processes=1) is False
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(num_processes=2, process_id=0)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        initialize_distributed(backend="gloo")
    assert not torch.distributed.is_initialized()


def test_local_shard_matches_jax():
    for n in (0, 1, 5, 7, 10, 16, 33):
        for size in (1, 2, 3, 4, 8):
            for index in range(size):
                assert local_shard(n, size, index) == jmh.local_shard(
                    n, size, index), (n, size, index)
            assert local_shard(n, size) == jmh.local_shard(n, size)
    got = sorted(sum((list(range(*local_shard(7, 3, i).indices(7)))
                      for i in range(3)), []))
    assert got == list(range(7))


# --- the ensemble over a mesh ----------------------------------------------

def _mas():
    return [make_demo_model_arrays(n=30 - 2 * i, components=5, seed=100 + i)
            for i in range(NP)]


def _cfg():
    return GibbsConfig(model="mixture", vary_df=True,
                       theta_prior="beta").with_adapt(5, adapt_cov=True)


def _mesh(axes):
    return make_mesh(axes, [CPU] * int(np.prod(list(axes.values()))))


def _ens(mesh=None, record="full", **kw):
    dev = {} if mesh is not None else {"device": "cpu"}
    return EnsembleGibbs(_mas(), _cfg(), nchains=NC, chunk_size=5,
                         record=record, mesh=mesh, **dev, **kw)


#: fields that carry the float32 rounding of the TOA reduction over
#: another chain count (the dense product folds a block's chains into the
#: rows of one matmul), amplified by the b draw's conditioning: b, and
#: alpha and pout through the residual. They are held to 1e-3 of their
#: largest magnitude; everything else to the JAX package's gate
SCALED = {"bchain", "alphachain", "poutchain", "b", "alpha", "pout"}


def _close(x, y, name):
    x, y = np.asarray(x), np.asarray(y)
    assert x.shape == y.shape, name
    if name in SCALED:
        nan = np.isnan(y)
        np.testing.assert_array_equal(np.isnan(x), nan, err_msg=name)
        assert (np.abs(x - y)[~nan].max(initial=0.0)
                <= 1e-3 * np.abs(y[~nan]).max(initial=0.0)), name
    else:
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL, err_msg=name)


def _assert_close(a, b, exact=False):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if exact:
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            _close(x, y, f)
    for k in ("acc_white", "acc_hyper"):
        np.testing.assert_allclose(a.stats[k], b.stats[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _assert_states_close(a, b, exact=False):
    for f, x, y in zip(a._fields, a, b):
        if exact:
            assert torch.equal(x, y), f
        else:
            _close(x.numpy(), y.numpy(), f)


@pytest.fixture(scope="module")
def unsharded():
    e = _ens()
    res = e.sample(SWEEPS, seed=1)
    return res, e.last_state


@pytest.mark.parametrize("axes", [{"pulsar": 2, "chain": 4}, {"chain": 8}])
def test_mesh_ensemble_matches_unsharded(axes, unsharded):
    ref, ref_state = unsharded
    e = _ens(_mesh(axes))
    assert len(e._blocks) == int(np.prod(list(axes.values())))
    res = e.sample(SWEEPS, seed=1)
    assert res.chain.shape == (SWEEPS, NP, NC, 3)
    assert np.isfinite(res.chain).all()
    _assert_close(res, ref)
    np.testing.assert_array_equal(res.stats["n_toa"], ref.stats["n_toa"])
    _assert_states_close(e.last_state, ref_state)
    # the covariance factors are each pulsar's own, the same on its chains
    L = e.last_state.mh_cov_chol
    assert torch.equal(L, L[:, :1].expand_as(L))


def test_one_by_one_mesh_is_the_unsharded_run():
    plain = _ens(record="compact8")
    meshed = _ens(_mesh({"pulsar": 1, "chain": 1}), record="compact8")
    a, b = plain.sample(SWEEPS, seed=2), meshed.sample(SWEEPS, seed=2)
    _assert_close(a, b, exact=True)
    assert a.stats.keys() == b.stats.keys()
    for k in a.stats:
        np.testing.assert_array_equal(a.stats[k], b.stats[k], err_msg=k)
    _assert_states_close(plain.last_state, meshed.last_state, exact=True)
    _assert_states_close(plain.init_state(4), meshed.init_state(4),
                         exact=True)


def test_mesh_shapes_are_checked():
    with pytest.raises(ValueError, match="evenly"):
        _ens(_mesh({"pulsar": 3}))
    with pytest.raises(ValueError, match="evenly"):
        _ens(_mesh({"pulsar": 1, "chain": 3}))
    with pytest.raises(ValueError, match="not both"):
        EnsembleGibbs(_mas(), _cfg(), nchains=NC, device="cpu",
                      mesh=_mesh({"chain": 2}))
    with pytest.raises(ValueError, match="'pulsar' and 'chain'"):
        _ens(_mesh({"pulsar": 2, "x": 2}))
    # a missing axis counts as size 1, as JAX's mesh.shape.get(axis, 1)
    e = _ens(_mesh({"chain": 2}))
    assert [(b.i, b.j) for b in e._blocks] == [(0, 0), (0, 1)]
    assert not e.spans_processes


def test_mesh_spool_until_and_reinit_match_unsharded(tmp_path):
    mesh = _mesh({"pulsar": 2, "chain": 2})
    plain, meshed = _ens(), _ens(mesh)
    a = plain.sample(SWEEPS, seed=3, spool_dir=str(tmp_path / "a"))
    b = meshed.sample(SWEEPS, seed=3, spool_dir=str(tmp_path / "b"))
    _assert_close(a, b)
    np.testing.assert_array_equal(a.stats["n_toa"], b.stats["n_toa"])
    # the spooled rows are the in-memory rows of the same mesh run
    _assert_close(_ens(mesh).sample(SWEEPS, seed=3), b, exact=True)

    ua = plain.sample_until(rhat_target=1.5, max_sweeps=32,
                            check_every=16, seed=4)
    ub = meshed.sample_until(rhat_target=1.5, max_sweeps=32,
                             check_every=16, seed=4)
    assert ua.chain.shape == ub.chain.shape
    _assert_close(ua, ub)
    np.testing.assert_allclose(ua.stats["rhat"], ub.stats["rhat"],
                               rtol=1e-3)
    assert ub.stats["rhat"].shape == (NP, 3)

    # a dead chain in each of two blocks: the same re-draws
    st_a, st_b = plain.init_state(5), meshed.init_state(5)
    for st in (st_a, st_b):
        st.x[0, 1] = float("nan")
        st.alpha[3, 6] = 0.0
    ra = plain.sample(SWEEPS, seed=5, state=st_a, reinit_diverged=True)
    rb = meshed.sample(SWEEPS, seed=5, state=st_b, reinit_diverged=True)
    assert int(ra.stats["n_reinits"]) == int(rb.stats["n_reinits"]) == 2
    _assert_close(ra, rb)
    assert not meshed.diverged_mask(meshed.last_state).any()


# --- the device guard -------------------------------------------------------

def test_launch_runs_its_entry_under_the_device_guard(monkeypatch):
    seen = []

    @contextlib.contextmanager
    def device(dev):
        seen.append(("enter", dev))
        yield
        seen.append(("exit", dev))

    class Lib:
        @staticmethod
        def gst_probe(*args):
            seen.append(("call", args))
            return 0

        @staticmethod
        def gst_broken(*args):
            return 700

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(_cuda, "lib", lambda: Lib)
    monkeypatch.setattr(_cuda, "stream", lambda dev: f"stream of {dev}")
    dev1 = torch.device("cuda", 1)
    _cuda.launch("probe", dev1, 11, 12)
    assert seen == [("enter", dev1),
                    ("call", (11, 12, "stream of cuda:1")),
                    ("exit", dev1)]
    with pytest.raises(RuntimeError, match="guarded: CUDA launch failed"):
        _cuda.launch("broken", dev1, what="guarded")


def _wrapper_calls():
    """Each kernel wrapper as ``(entry, call)`` on valid CPU operands."""
    ma = make_demo_model_arrays(components=5)
    wc = twhite.build_white_consts(ma)
    p, n, m, C, S, K, G, L = ma.nparam, ma.n, 6, 4, 2, 3, 2, 16
    z, o = torch.zeros, torch.ones
    rows, specs = torch.from_numpy(wc.rows), torch.from_numpy(wc.specs)

    def eye(b):
        return torch.eye(m).expand(b, m, m)

    def per_lane(t, b):
        return t[None].expand(b, *t.shape)

    gid = torch.zeros(L, dtype=torch.int32)
    table = rng.DrawTable([rng.DrawField("u_z", rng.UNIFORM, (5,)),
                           rng.DrawField("g_theta", rng.GAMMA, (2,), col=0,
                                         per=1)])
    return {
        "chol_fused": ("chol_fused",
                       lambda: chol.chol_fused(eye(C), z(C, m))),
        "chol_fused_lanes": ("chol_fused", lambda: chol.chol_fused_lanes(
            eye(L), z(L, m), gid)),
        "tri_solve_T": ("tri_solve_T",
                        lambda: chol.tri_solve_T(eye(C), z(C, m))),
        "tri_solve_T_lanes": ("tri_solve_T", lambda: chol.tri_solve_T_lanes(
            eye(L), z(L, m), gid)),
        "white_mh": ("white_mh", lambda: twhite.white_mh(
            z(C, p), o(C, n), z(C, n), z(C, S, p), z(C, S), rows, specs,
            wc.var)),
        "white_mh_grouped": ("white_mh", lambda: twhite.white_mh(
            z(G, C, p), o(G, C, n), z(G, C, n), z(G, C, S, p), z(G, C, S),
            per_lane(rows, G), per_lane(specs, G), wc.var)),
        "white_mh_lanes": ("white_mh", lambda: twhite.white_mh_lanes(
            z(L, p), o(L, n), z(L, n), z(L, S, p), z(L, S),
            per_lane(rows, L), per_lane(specs, L), gid, wc.var)),
        "white_mtm": ("white_mtm", lambda: twhite.white_mtm(
            z(C, p), o(C, n), z(C, n), z(C, S, K, p), z(C, S, K - 1, p),
            z(C, S, K), z(C, S), rows, specs, wc.var)),
        "hyper_mh": ("hyper_mh", lambda: thyper.hyper_mh(
            z(C, p), eye(C), o(C, m), z(C, m), z(C), z(C, S, p), z(C, S),
            z(2, m), z(m), z(3, p), (1,), 1e-6)),
        "hyper_mh_lanes": ("hyper_mh", lambda: thyper.hyper_mh_lanes(
            z(L, p), eye(L), o(L, m), z(L, m), z(L), z(L, S, p), z(L, S),
            z(L, 2, m), z(L, m), z(L, 3, p), gid, (1,), 1e-6)),
        "tnt_batched": ("tnt_batched", lambda: ttnt.tnt_batched(
            z(16, m), z(16), o(C, 16), 8)),
        "tnt_lanes": ("tnt_lanes", lambda: ttnt.tnt_lanes(
            z(L, 16, m), z(L, 16), o(L, 16), gid)),
        "sweep_draws": ("sweep_draws", lambda: rng.sweep_draws(
            rng.chain_keys(1, np.arange(C)), torch.tensor(0),
            o(C, 2), table, elems=(8, 8))),
    }


WRAPPERS = sorted(_wrapper_calls())


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_each_wrapper_launches_through_the_guard(wrapper, monkeypatch):
    launched = []

    class Lib:
        @staticmethod
        def gst_tnt_workspace(*args):
            return 0

    # the forced launches count on the wrappers' counters: restored after
    counters = [(fn, attr) for fn in (
        chol.chol_fused, chol.chol_fused_lanes, chol.tri_solve_T,
        chol.tri_solve_T_lanes, twhite.white_mh, twhite.white_mtm,
        thyper.hyper_mh, thyper.hyper_mh_lanes, ttnt.tnt_batched,
        ttnt.tnt_lanes, rng.sweep_draws)
        for attr in ("launches", "launches_grouped", "launches_lanes")
        if hasattr(fn, attr)]
    for fn, attr in counters:
        monkeypatch.setattr(fn, attr, 0)
    monkeypatch.setattr(_cuda, "use_kernel", lambda t, what: True)
    monkeypatch.setattr(_cuda, "lib", lambda: Lib)
    monkeypatch.setattr(_cuda, "launch",
                        lambda entry, device, *args, what="":
                        launched.append((entry, device)))
    monkeypatch.setattr(rng, "draw_geometry", lambda: (128, 256, 65535))
    entry, call = _wrapper_calls()[wrapper]
    call()
    assert launched == [(entry, CPU)]
    assert sum(getattr(fn, attr) for fn, attr in counters) == 1


def test_stage_timer_events_are_recorded_under_the_guard(monkeypatch):
    seen, inside = [], []

    @contextlib.contextmanager
    def guard(dev):
        inside.append(dev)
        yield
        inside.pop()

    class Event:
        def record(self, stream):
            seen.append((tuple(inside), stream))

    monkeypatch.setattr(_cuda, "guard", guard)
    monkeypatch.setattr(timers, "_event", lambda dev: Event())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: f"stream of {dev}")
    dev1 = torch.device("cuda", 1)
    timers.timers_enable(True)
    try:
        with timers.stage("tnt", dev1):
            pass
    finally:
        timers.timers_enable(False)
        timers.timers_reset()
    assert seen == [((dev1,), "stream of cuda:1")] * 2


def test_port_parallel_names_are_the_jax_packages():
    import gibbs_student_t_tpu.parallel as jpar
    import gibbs_student_t_tpu_torch.parallel as tpar

    assert set(jpar.__all__) <= set(tpar.__all__)
    for name in jpar.__all__:
        assert callable(getattr(tpar, name)), name
