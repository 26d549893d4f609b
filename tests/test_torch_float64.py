"""The port's float64 path (``dtype=torch.float64``) against the JAX
package in float64 (CPU; JAX in x64 mode, restored after each test).

- ``TorchGibbs.lnlikelihood`` against ``JaxGibbs(dtype=jnp.float64)`` and
  the port's NumPy oracle at rtol 1e-10;
- each kernel's plain version in float64 against the JAX function: the
  factor and back-solve against ``jnp.linalg.cholesky`` and the triangular
  solves (rtol 1e-10), the white and hyper blocks against
  ``white_mh_loop_xla`` / ``hyper_mh_loop_xla`` (x to rtol 1e-10 and every
  chain's accept count equal, on draws kept clear of ties), the hyper
  block also past the float64 kernel's bound (v = 160: the closure path);
- D1's float64 draws rounded to float32 are its float32 draws bit for
  bit; the CUDA refusal rule (``float64_refusals``) and the wrappers'
  own; other dtypes raise; the launch forms' shared memory in float64;
  ``EnsembleGibbs.chain_keys`` against the JAX method's shape and
  pulsar-major layout (the key words differ by design: Philox, not
  threefry).

The sweeps and the runs are tests/test_torch_float64_sweep.py.

MH draws are kept clear of ties by float64 replays: at least 1e-5 of their
decision before ``separate_ties`` rounds ``logu`` to float32 (so at least
1e-8 after).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.backends.jax_backend import JaxGibbs
from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu.ops import pallas_hyper as jhyper
from gibbs_student_t_tpu.ops import pallas_white as jwhite
from gibbs_student_t_tpu.parallel import ensemble as jens
from gibbs_student_t_tpu_torch.backends import NumpyGibbs
from gibbs_student_t_tpu_torch.backends import torch_backend as tb
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.convert import model_arrays_from_fields
from gibbs_student_t_tpu_torch.ops import _cuda, chol, rng
from gibbs_student_t_tpu_torch.ops import hyper_mh as thyper
from gibbs_student_t_tpu_torch.ops import tnt as ttnt
from gibbs_student_t_tpu_torch.ops import white_mh as twhite
from gibbs_student_t_tpu_torch.parallel import EnsembleGibbs
from gibbs_student_t_tpu_torch.serve.pool import SlotPool
from gibbs_student_t_tpu_torch.testing import separate_ties
from test_torch_host import _fields
from test_torch_kernels import acc_counts, jumps, spd

torch.set_num_threads(1)

F64 = np.float64
tt = torch.from_numpy


@pytest.fixture
def x64():
    """JAX in float64 for one test, restored after it (the suite's
    workers run other files after this one)."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _port(jma):
    return model_arrays_from_fields(_fields(jma))


def _cfg(model="mixture", **kw):
    return GibbsConfig(model=model, vary_df=True, theta_prior="beta", **kw)


# --- the likelihood ----------------------------------------------------------

def test_lnlikelihood_matches_jax_and_the_oracle_in_float64(demo_ma, x64):
    cfg = _cfg(jitter=0.0)
    jcfg = JaxConfig(model="mixture", vary_df=True, theta_prior="beta",
                     jitter=0.0)
    ma = _port(demo_ma)
    ours = TorchGibbs(ma, cfg, nchains=1, device="cpu", dtype=torch.float64)
    theirs = JaxGibbs(demo_ma, jcfg, nchains=1, dtype=jnp.float64)
    oracle = NumpyGibbs(ma, cfg)
    rng_ = np.random.default_rng(0)
    for _ in range(4):
        x = ma.x_init(rng_)
        z = (rng_.random(ma.n) < 0.1).astype(F64)
        alpha = 10.0 ** rng_.uniform(0, 2, ma.n)
        oracle._z, oracle._alpha = z, alpha
        oracle._TNT = oracle._d = None
        ll = ours.lnlikelihood(x, z, alpha)
        np.testing.assert_allclose(ll, theirs.lnlikelihood(x, z, alpha),
                                   rtol=1e-10)
        np.testing.assert_allclose(ll, oracle.get_lnlikelihood(x),
                                   rtol=1e-10)


# --- the kernels' plain versions -----------------------------------------------

@pytest.mark.parametrize("m", [14, 60, 95, 160])
def test_factor_and_back_solve_match_jax_in_float64(m, x64):
    rng_ = np.random.default_rng(m)
    S = spd(rng_, 6, m).astype(F64)
    S = 0.5 * (S + np.swapaxes(S, 1, 2))
    r = rng_.normal(size=(6, m))
    L, logdet, u = chol.chol_fused_plain(tt(S), tt(r))
    Lj = jnp.linalg.cholesky(S)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(
        logdet.numpy(), 2.0 * np.log(np.diagonal(np.asarray(Lj), axis1=1,
                                                 axis2=2)).sum(-1),
        rtol=1e-10)
    uj = jax.scipy.linalg.solve_triangular(Lj, r[..., None], lower=True)
    np.testing.assert_allclose(u.numpy(), np.asarray(uj)[..., 0], rtol=1e-10,
                               atol=1e-12)
    x = chol.tri_solve_T_plain(L, tt(r))
    xj = jax.scipy.linalg.solve_triangular(jnp.swapaxes(Lj, -1, -2),
                                           r[..., None], lower=False)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj)[..., 0], rtol=1e-10,
                               atol=1e-12)
    # the wrappers run the plain versions on the CPU, in float64
    out = chol.chol_fused(tt(S), tt(r))
    assert all(t.dtype == torch.float64 for t in out)
    assert torch.equal(chol.tri_solve_T(L, tt(r)), x)


def _white_operands(rng_, jma, ma, C, S=20):
    wc = twhite.build_white_consts(ma, None, dtype=F64)
    # the float64 constants are JAX's float32 ones before their rounding
    wj = jwhite.build_white_consts(jma)
    np.testing.assert_array_equal(wc.rows.astype(np.float32), wj.rows)
    assert wc.var == wj.var
    x = np.array([-7.5, 4.0, -14.0]) + rng_.normal(0, [0.4, 0.5, 0.3],
                                                   (C, 3))
    z = (rng_.random((C, ma.n)) < 0.05).astype(F64)
    az = rng_.gamma(2.0, 3.0, (C, ma.n)) ** z
    b = rng_.normal(size=(C, ma.m)) * 0.05
    yred = ma.y[None] - b @ ma.T.T
    y2 = yred * yred
    dx = jumps(rng_, ma.white_indices, S, ma.nparam, False, 0.05,
               C=C).astype(F64)
    logu = _separate(
        lambda q: twhite.white_ll_lp(q, tt(az), tt(y2), tt(wc.rows), wc.var,
                                     tt(wc.specs)),
        x, dx, np.log(rng_.random((C, S))))
    return x, az, y2, dx, logu, wc


def _separate(ll_lp64, x, dx, logu):
    """``logu`` with every decision at least 1e-5 clear of its float64
    delta (then rounded to float32 by separate_ties: at least 1e-8), as
    float64."""
    return separate_ties(ll_lp64, tt(np.array(x, F64)), tt(dx), tt(logu),
                         margin=1e-5, push=1e-4).double().numpy()


def test_white_block_matches_jax_in_float64(demo_ma, x64):
    ma = _port(demo_ma)
    rng_ = np.random.default_rng(3)
    x, az, y2, dx, logu, wc = _white_operands(rng_, demo_ma, ma, 16)
    xo, acc = twhite.white_mh(*(tt(a) for a in (x, az, y2, dx, logu)),
                              tt(wc.rows), tt(wc.specs), wc.var)
    assert xo.dtype == torch.float64
    xj, accj = jwhite.white_mh_loop_xla(x, az, y2, dx, logu, wc.rows,
                                        wc.specs, wc.var)
    np.testing.assert_allclose(xo.numpy(), np.asarray(xj), rtol=1e-10)
    np.testing.assert_array_equal(acc_counts(acc, 20),
                                  acc_counts(np.asarray(accj), 20))
    assert 0 < float(acc.mean()) < 1


def _hyper_operands(rng_, ma, cols, C, S=10):
    """The hyper block's operands on the columns ``cols`` of a Sigma built
    from ``ma`` at random noise weights, and its float64 constants."""
    hc = thyper.build_hyper_consts(ma, cols, dtype=F64)
    nvec = ma.sigma2[None] * rng_.uniform(0.5, 2.0, (C, ma.n))
    T = ma.T
    TNT = np.einsum("ni,cn,nj->cij", T, 1.0 / nvec, T)[:, cols][:, :, cols]
    d = ((ma.y[None] / nvec) @ T)[:, cols]
    dS0 = np.diagonal(TNT, axis1=1, axis2=2) + hc.phiinv_static
    base = rng_.normal(size=C)
    x = np.array([-7.5, 4.0, -14.0]) + rng_.normal(0, [0.3, 0.3, 0.3],
                                                   (C, 3))
    dx = rng_.normal(size=(C, S, 3)) * 0.1
    dx[..., list(set(range(3)) - set(ma.hyper_indices))] = 0.0
    ops = (TNT, dS0, d, base)
    logu = _separate(
        lambda q: thyper.hyper_ll_lp(q, *(tt(a) for a in ops),
                                     tt(hc.K), tt(hc.phi_sel), tt(hc.specs),
                                     hc.hyp_idx, 1e-6),
        x, dx, np.log(rng_.random((C, S))))
    return x, ops, dx, logu, hc


@pytest.mark.parametrize("components", [30, 80])
def test_hyper_block_matches_jax_in_float64(components, x64):
    """v = 60 takes the float64 kernel's shapes; v = 160 (phase 3b's
    model) is past its bound, where the sampler takes the closure path:
    the plain loop with the factor as its factorization."""
    jma = jax_demo_model_arrays(components=components)
    ma = _port(jma)
    smp = TorchGibbs(ma, _cfg(), nchains=4, device="cpu", dtype=torch.float64)
    cols = smp._schur[1]
    v = len(cols)
    assert smp._hyper["fused"] == (v <= thyper.MAX_HYPER_V_F64)
    assert TorchGibbs(ma, _cfg(), nchains=4, device="cpu")._hyper["fused"]
    hj = jhyper.build_hyper_consts(jma, cols)
    rng_ = np.random.default_rng(components)
    x, (S0, dS0, rt, base), dx, logu, hc = _hyper_operands(rng_, ma, cols, 6)
    np.testing.assert_array_equal(hc.K.astype(np.float32), hj.K)
    args = [tt(a) for a in (x, S0, dS0, rt, base, dx, logu, hc.K, hc.phi_sel,
                            hc.specs)]
    if smp._hyper["fused"]:
        xo, acc = thyper.hyper_mh(*args, hc.hyp_idx, 1e-6)
    else:
        xo, acc = thyper.hyper_mh_loop(*args, hc.hyp_idx, 1e-6,
                                       factor=chol.chol_fused)
    assert xo.dtype == torch.float64
    xj, accj = jhyper.hyper_mh_loop_xla(x, S0, dS0, rt, base, dx, logu, hc.K,
                                        hc.phi_sel, hc.specs, hc.hyp_idx,
                                        1e-6)
    np.testing.assert_allclose(xo.numpy(), np.asarray(xj), rtol=1e-10)
    np.testing.assert_array_equal(acc_counts(acc, 10),
                                  acc_counts(np.asarray(accj), 10))
    assert 0 < float(acc.mean()) < 1


# --- draws ---------------------------------------------------------------

def test_float64_draws_round_to_the_float32_draws():
    """D1's float64 draws are the same Philox numbers not rounded: each,
    rounded to float32, is the float32 draw bit for bit, boosted gamma
    shapes (below 1) and bad shapes (NaN) included."""
    ma = _port(jax_demo_model_arrays(components=5))
    smp = TorchGibbs(ma, _cfg(), nchains=12, device="cpu")
    keys = rng.chain_keys(9, range(12))
    shapes = torch.tensor(np.random.default_rng(1).uniform(
        0.2, 40.0, (12, 4)), dtype=torch.float32)
    shapes[3, 2] = 0.5
    shapes[5, 3] = float("nan")
    for sweep in (torch.tensor(0), torch.arange(12) + 3):
        d32 = rng.sweep_draws(keys, sweep, shapes, smp._table)
        d64 = rng.sweep_draws(keys, sweep, shapes.double(), smp._table)
        assert d64.dtype == torch.float64
        both = ~torch.isnan(d32)
        assert torch.equal(d64.float()[both], d32[both])
        assert torch.equal(torch.isnan(d64), torch.isnan(d32))
        # the float64 values are not all float32 numbers
        assert not torch.equal(d64, d32.double())


# --- the CUDA refusal rule and the dtype argument ----------------------------

def test_float64_refusal_rule():
    cfg = _cfg()
    assert tb.float64_refusals(cfg, 130) == []
    assert tb.float64_refusals(cfg, 1024) == []
    assert tb.float64_refusals(cfg, 130, white=False) == []
    got = tb.float64_refusals(cfg, 102_400, tnt_block_size=4096)
    assert [g[:2] for g in got] == ["B5", "B3"]
    assert tb.float64_refusals(cfg, 1025, white=False) == []
    assert [g[:2] for g in tb.float64_refusals(cfg.with_mtm(4), 130)] == \
        ["B6"]
    # MTM on the hyper block alone factors through B1, which has its form
    assert tb.float64_refusals(cfg.with_mtm(4, blocks=("hyper",)), 130) == []
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    tb.check_dtype(torch.float64, cuda, [])
    tb.check_dtype(torch.float64, cpu, got)
    tb.check_dtype(torch.float32, cuda, got)
    with pytest.raises(NotImplementedError, match="A-11b.*B5.*B3"):
        tb.check_dtype(torch.float64, cuda, got)
    # on the CPU every path runs float64 through the plain versions
    ma = _port(jax_demo_model_arrays(components=5))
    for kw in ({"tnt_block_size": 64}, {}):
        c = cfg.with_mtm(4) if not kw else cfg
        res = TorchGibbs(ma, c, nchains=4, device="cpu", chunk_size=5,
                         dtype=torch.float64, record="light",
                         **kw).sample(niter=5, seed=1)
        assert res.chain.dtype == np.float64 and np.isfinite(res.chain).all()
    # the pool's float64 form is not ported yet: it runs float32 only
    for d in (torch.float64, torch.float16):
        with pytest.raises(NotImplementedError, match="A-11b"):
            SlotPool(ma, GibbsConfig(model="mixture"), nlanes=32,
                     device="cpu", dtype=d)


def test_wrappers_without_a_float64_kernel_raise_on_cuda(monkeypatch):
    """The wrappers' own refusal, with the CUDA branch forced on CPU
    tensors (as tests/test_torch_mesh.py forces it): float64 operands of
    a kernel with no float64 form raise before any launch."""
    monkeypatch.setattr(_cuda, "use_kernel", lambda t, what: True)

    def no_launch(*a, **k):
        raise AssertionError("launched")

    monkeypatch.setattr(_cuda, "launch", no_launch)
    d = torch.float64
    C, n, p, S, K = 16, 1100, 3, 2, 2
    x, az, y2 = (torch.ones(C, p, dtype=d), torch.ones(C, n, dtype=d),
                 torch.ones(C, n, dtype=d))
    rows, specs = torch.ones(3, n, dtype=d), torch.zeros(3, p, dtype=d)
    dx, logu = torch.zeros(C, S, p, dtype=d), torch.zeros(C, S, dtype=d)
    var = ((0, 0, 2),)
    with pytest.raises(NotImplementedError, match="cluster form"):
        twhite.white_mh(x, az, y2, dx, logu, rows, specs, var)
    with pytest.raises(NotImplementedError, match="B6"):
        twhite.white_mtm(x, az, y2, torch.zeros(C, S, K, p, dtype=d),
                         torch.zeros(C, S, K - 1, p, dtype=d),
                         torch.zeros(C, S, K, dtype=d), logu, rows, specs,
                         var)
    gid = torch.zeros(C, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="lanes"):
        twhite.white_mh_lanes(x, az, y2, dx, logu, rows.expand(C, 3, n),
                              specs.expand(C, 3, p), gid, var)
    with pytest.raises(NotImplementedError, match="lanes"):
        chol.chol_fused_lanes(torch.eye(4, dtype=d).expand(C, 4, 4),
                              torch.zeros(C, 4, dtype=d), gid)
    with pytest.raises(NotImplementedError, match="lanes"):
        chol.tri_solve_T_lanes(torch.eye(4, dtype=d).expand(C, 4, 4),
                               torch.zeros(C, 4, dtype=d), gid)
    T = torch.ones(64, 5, dtype=d)
    with pytest.raises(NotImplementedError, match="B5"):
        ttnt.tnt_batched(T, torch.ones(64, dtype=d),
                         torch.ones(C, 64, dtype=d), 64)
    with pytest.raises(NotImplementedError, match="B5-L"):
        ttnt.tnt_lanes(T.expand(C, 64, 5), torch.ones(C, 64, dtype=d),
                       torch.ones(C, 64, dtype=d), gid)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int32])
def test_other_dtypes_raise(dtype):
    ma = _port(jax_demo_model_arrays(components=5))
    with pytest.raises(ValueError, match="float32 or torch.float64"):
        TorchGibbs(ma, _cfg(), nchains=2, device="cpu", dtype=dtype)
    with pytest.raises(ValueError, match="float32 or torch.float64"):
        EnsembleGibbs([ma, ma], _cfg(), nchains=2, device="cpu", dtype=dtype)


def test_float64_launch_forms_fit_shared_memory():
    """A float64 matrix or chain takes twice the shared memory: the warp
    forms cap their count a block by it, at the shapes the paths give."""
    f64 = torch.float64
    assert chol.launch_form(4096, 60, f64) == chol.launch_form(4096, 60)
    assert 4 * chol.warp_bytes(95, f64) <= chol.SMEM_OPTIN
    assert 8 * chol.warp_bytes(95, f64) > chol.SMEM_OPTIN
    chol.check_per_block("chol_fused", 6, 95,
                         warp_bytes_each=chol.warp_bytes(95, f64))
    with pytest.raises(ValueError, match="shared memory"):
        chol.check_per_block("chol_fused", 8, 95,
                             warp_bytes_each=chol.warp_bytes(95, f64))
    form, per = thyper.launch_form(1024, 60, f64, p=3, nk=2)
    assert form == "warp" and per == 6
    assert per * thyper.warp_bytes(60, 3, 2, f64) <= chol.SMEM_OPTIN
    assert thyper.launch_form(1024, 60, p=3, nk=2) == ("warp", 8)
    assert thyper.launch_form(64, 112, f64) == ("block", 1)
    with pytest.raises(ValueError):
        thyper.launch_form(64, 113, f64)
    # the block form's buffers at the bound, 16 hyper indices, 64 parameters
    v, nk, p = thyper.MAX_HYPER_V_F64, 16, 64
    assert 8 * (2 * v * v + v + (10 + nk) * v + 5 * p) <= chol.SMEM_OPTIN


def test_float64_entries_are_their_float32_sources_instantiated():
    """Every float64 C entry is defined in the source file of its float32
    entry (the kernels are templates on the scalar type, not copies), and
    the constants the wrappers share with the kernels come from the
    header."""
    import glob
    import os
    import re

    srcs = {os.path.basename(f): open(f).read()
            for f in glob.glob(os.path.join(_cuda.CSRC, "*.cu"))}
    assert not [f for f in srcs if f.endswith("_f64.cu")]

    def home(entry):
        (found,) = [f for f, text in srcs.items()
                    if re.search(rf"^int {entry}\(", text, re.M)]
        return found

    f64 = [e for e in _cuda._SIGNATURES if e.endswith("_f64")]
    assert sorted(f64) == ["gst_chol_fused_f64", "gst_hyper_mh_f64",
                           "gst_sweep_draws_f64", "gst_tri_solve_T_f64",
                           "gst_white_mh_f64"]
    for entry in f64:
        assert home(entry) == home(entry[:-4]), entry
    assert twhite.WHITE_CROSSOVER == _cuda.header_int("GST_WHITE_CROSSOVER")
    assert chol.SMEM_OPTIN == _cuda.header_int("GST_SMEM_OPTIN") == 232448
    with pytest.raises(KeyError):
        _cuda.header_int("GST_NO_SUCH_CONSTANT")
    # the tool that holds the float32 entries' PTX imports no JAX
    import ast

    tool = os.path.join(os.path.dirname(os.path.dirname(_cuda.CSRC)),
                        "tools", "torch_ptx_compare.py")
    mods = set()
    for node in ast.walk(ast.parse(open(tool).read())):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert "gibbs_student_t_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "gibbs_student_t_tpu"}


# --- EnsembleGibbs.chain_keys (A-12) -------------------------------------------

def test_chain_keys_shape_and_layout_match_jax():
    P, C, seed = 3, 5, 17
    jmas = [jax_demo_model_arrays(n=30, components=4, seed=10 + i)
            for i in range(P)]
    je = jens.EnsembleGibbs(jmas, JaxConfig(model="mixture"), nchains=C,
                            unroll=False, telemetry=False)
    e = EnsembleGibbs([_port(ma) for ma in jmas], GibbsConfig(
        model="mixture"), nchains=C, device="cpu")
    theirs = np.asarray(je.chain_keys(seed))
    ours = e.chain_keys(seed)
    assert tuple(ours.shape) == theirs.shape == (P, C, 2)
    assert ours.dtype == torch.int64
    # pulsar-major on both sides: pulsar p's chain c is key p * C + c
    flat = np.asarray(jax.random.split(jax.random.PRNGKey(seed), P * C))
    np.testing.assert_array_equal(theirs.reshape(P * C, 2), flat)
    want = np.array([rng.chain_key(seed, k) for k in range(P * C)])
    np.testing.assert_array_equal(ours.reshape(P * C, 2).numpy(), want)
    assert torch.equal(ours, e._chain_keys(seed))
