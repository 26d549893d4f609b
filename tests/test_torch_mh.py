"""The port's fused MH blocks (plain versions, CPU) against the JAX
package's XLA loops, on operands from the flagship demo model.

- white block: ``white_mh`` vs ``pallas_white.white_mh_loop_xla`` with the
  same ``dx``/``logu``, one-hot and dense jumps;
- hyper block: ``hyper_mh`` vs ``pallas_hyper.hyper_mh_loop_xla`` on the
  Schur split of the flagship model (v = 60) and of the same pulsar with
  7 Fourier components (v = 14), 64 chains, with a chain whose block is
  not positive definite (every proposal must reject on both sides);
- ``hyper_mh.launch_form``: which form each (C, v) takes; its warp form
  stays at v <= 64 (``HYPER_WARP_MAX_V``) while the factor's reaches 95.

Per-chain accept counts are equal and x agrees to 1e-5 relative, on
fixtures whose decisions all sit more than 1e-3 from a tie
(|delta - logu| > 1e-3, checked by a float64 replay that moves any closer
logu away on the side of its decision). Both packages build the kernels'
constant tables identically (bitwise).

The float64 replay itself (``testing.separate_ties``) is checked with a
float32 evaluation beside it that is off by a known amount and not finite
in part of the space: the float64 decisions are unchanged, the float32
ones agree with them wherever its delta is finite, and every other draw
is forced to an infinity.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu.models.pta import (
    ndiag,
    phiinv_logdet,
    static_phi_columns,
)
from gibbs_student_t_tpu.ops import linalg as jlin
from gibbs_student_t_tpu.ops import pallas_hyper as jhyper
from gibbs_student_t_tpu.ops import pallas_white as jwhite
from gibbs_student_t_tpu.ops.tnt import tnt_products as jtnt
from gibbs_student_t_tpu_torch.convert import model_arrays_from_fields
from gibbs_student_t_tpu_torch.ops import chol
from gibbs_student_t_tpu_torch.ops import hyper_mh as thyper
from gibbs_student_t_tpu_torch.ops import white_mh as twhite
from test_torch_host import _fields
from test_torch_kernels import (
    C,
    acc_counts,
    jumps,
    near_posterior,
    separate_ties,
)

# The suite runs in parallel workers and these tensors are small: one
# PyTorch CPU thread per worker costs nothing here and leaves the other
# cores to the other workers.
torch.set_num_threads(1)


@pytest.mark.parametrize("dense", [False, True])
def test_white_block_vs_jax(demo_ma, dense):
    ma = demo_ma
    rng = np.random.default_rng(21 + dense)
    wj = jwhite.build_white_consts(ma)
    wt = twhite.build_white_consts(model_arrays_from_fields(_fields(ma)))
    np.testing.assert_array_equal(wt.rows, wj.rows)
    np.testing.assert_array_equal(wt.specs, wj.specs)
    assert wt.var == wj.var
    x, az = near_posterior(rng, ma)
    b = (rng.normal(size=(C, ma.m)) * 0.05).astype(np.float32)
    yred = (ma.y.astype(np.float32)[None]
            - b @ ma.T.astype(np.float32).T).astype(np.float32)
    y2 = yred * yred
    S = 20
    dx = jumps(rng, ma.white_indices, S, 3, dense, 0.05)
    logu = np.log(rng.random((C, S))).astype(np.float32)
    tt = torch.from_numpy
    rows64, specs64 = tt(wt.rows).double(), tt(wt.specs).double()
    logu = separate_ties(
        lambda q: twhite.white_ll_lp(q, tt(az).double(), tt(y2).double(),
                                     rows64, wt.var, specs64),
        tt(x), tt(dx), tt(logu)).numpy()
    xt, acct = twhite.white_mh(tt(x), tt(az), tt(y2), tt(dx), tt(logu),
                               tt(wt.rows), tt(wt.specs), wt.var)
    xj, accj = jwhite.white_mh_loop_xla(
        jnp.asarray(x), jnp.asarray(az), jnp.asarray(y2), jnp.asarray(dx),
        jnp.asarray(logu), wj.rows, wj.specs, wj.var)
    np.testing.assert_array_equal(acc_counts(acct, S), acc_counts(accj, S))
    assert 0 < acc_counts(acct, S).sum() < C * S
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5)
    assert twhite.white_mh.launches == 0


def _hyper_operands(ma):
    """The hyper block's operands on a model's Schur split (static-phi
    columns eliminated, the red-noise columns left), built by the JAX
    package (tnt_products, schur_eliminate)."""
    rng = np.random.default_rng(31)
    x, az = near_posterior(rng, ma)
    T = jnp.asarray(ma.T, jnp.float32)
    y = jnp.asarray(ma.y, jnp.float32)
    nvec = jnp.asarray(az) * jax.vmap(lambda xx: ndiag(ma, xx, jnp))(
        jnp.asarray(x)).astype(jnp.float32)
    TNT, d, const = jax.vmap(lambda nv: jtnt(T, y, nv, None))(nvec)
    smask = static_phi_columns(ma)
    s_i, v_i = np.flatnonzero(smask), np.flatnonzero(~smask)
    phiinv = jax.vmap(lambda xx: phiinv_logdet(ma, xx, jnp)[0])(
        jnp.asarray(x)).astype(jnp.float32)
    A = TNT[:, s_i][:, :, s_i] + jax.vmap(jnp.diag)(phiinv[:, s_i])
    S0, rt, quad_s, logdetA = jax.vmap(
        lambda a, bm, c, rs, rv: jlin.schur_eliminate(a, bm, c, rs, rv,
                                                      1e-6))(
        A, TNT[:, s_i][:, :, v_i], TNT[:, v_i][:, :, v_i], d[:, s_i],
        d[:, v_i])
    hj = jhyper.build_hyper_consts(ma, v_i)
    base = const + 0.5 * (quad_s - logdetA) - 0.5 * hj.logdet_phi_static
    dS0 = jnp.diagonal(S0, axis1=-2, axis2=-1) + hj.phiinv_static
    S0 = np.array(S0)
    dS0 = np.array(dS0)
    # chain 0: an off-diagonal pair far beyond its diagonal makes every
    # proposal's equilibrated matrix indefinite (a negative second pivot)
    S0[0, 0, 1] = S0[0, 1, 0] = 1e15 * np.sqrt(dS0[0, 0] * dS0[0, 1])
    return dict(x=x, S0=S0, dS0=dS0, rt=np.array(rt),
                base=np.array(base, np.float32), hj=hj, ma=ma, v_i=v_i)


@pytest.fixture(scope="module")
def hyper_operands(demo_ma):
    """Operands by Fourier components: 30 is the flagship model (v = 60),
    7 the same pulsar with v = 14; built on first use."""
    cache = {}

    def get(components):
        if components not in cache:
            cache[components] = _hyper_operands(
                demo_ma if components == 30
                else jax_demo_model_arrays(components=components))
        return cache[components]
    return get


@pytest.mark.parametrize("dense, components", [
    pytest.param(False, 30, id="False"), pytest.param(True, 30, id="True"),
    pytest.param(False, 7, id="v14-False"),
    pytest.param(True, 7, id="v14-True")])
def test_hyper_block_vs_jax(hyper_operands, dense, components):
    o = hyper_operands(components)
    ma, hj = o["ma"], o["hj"]
    assert o["S0"].shape == (C, 2 * components, 2 * components)
    ht = thyper.build_hyper_consts(model_arrays_from_fields(_fields(ma)),
                                   o["v_i"])
    for f in ("K", "phi_sel", "phiinv_static", "specs"):
        np.testing.assert_array_equal(getattr(ht, f), getattr(hj, f))
    assert ht.hyp_idx == hj.hyp_idx
    assert ht.logdet_phi_static == hj.logdet_phi_static
    rng = np.random.default_rng(41 + dense)
    S = 10
    dx = jumps(rng, ma.hyper_indices, S, 3, dense, 0.1)
    logu = np.log(rng.random((C, S))).astype(np.float32)
    tt = torch.from_numpy
    ops = [tt(o[k]) for k in ("x", "S0", "dS0", "rt", "base")]
    consts = (tt(ht.K), tt(ht.phi_sel), tt(ht.specs))
    logu = separate_ties(
        lambda q: thyper.hyper_ll_lp(
            q, *(t.double() for t in ops[1:]),
            *(t.double() for t in consts), ht.hyp_idx, 1e-6),
        ops[0], tt(dx), tt(logu)).numpy()
    xt, acct = thyper.hyper_mh(*ops, tt(dx), tt(logu), *consts, ht.hyp_idx,
                               1e-6)
    xj, accj = jhyper.hyper_mh_loop_xla(
        *(jnp.asarray(o[k]) for k in ("x", "S0", "dS0", "rt", "base")),
        jnp.asarray(dx), jnp.asarray(logu), hj.K, hj.phi_sel, hj.specs,
        hj.hyp_idx, 1e-6)
    nt, nj = acc_counts(acct, S), acc_counts(accj, S)
    np.testing.assert_array_equal(nt, nj)
    assert nt[0] == 0                               # non-PD chain rejects
    np.testing.assert_array_equal(xt.numpy()[0], o["x"][0])
    assert 0 < nt.sum() < C * S
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5)
    assert thyper.hyper_mh.launches == 0


@pytest.mark.parametrize("nchains, v, want", [
    (1024, 60, ("warp", 8)), (64, 60, ("warp", 1)), (1027, 60, ("warp", 8)),
    (300, 14, ("warp", 3)), (5000, 64, ("warp", 8)), (1, 1, ("warp", 1)),
    (1024, 66, ("block", 1)), (64, 160, ("block", 1))])
def test_hyper_launch_form(nchains, v, want):
    assert thyper.launch_form(nchains, v) == want


def test_hyper_launch_form_covers_every_size():
    for v in range(1, thyper.MAX_HYPER_V + 1):
        form, per_block = thyper.launch_form(1024, v)
        assert form == ("warp" if v <= 64 else "block")
        assert 1 <= per_block <= thyper.MAX_PER_BLOCK
    for v in (0, thyper.MAX_HYPER_V + 1):
        with pytest.raises(ValueError):
            thyper.launch_form(1024, v)


@pytest.mark.parametrize("nchains", [64, 1024])
def test_hyper_launch_form_keeps_its_own_bound(nchains):
    # the hyper kernel's forms for every v do not follow the factor's
    # warp bound: a warp a chain to v = 64, chains dealt over the card's
    # SMs; a block a chain above
    assert thyper.HYPER_WARP_MAX_V == 64 < chol.WARP_MAX_DIM
    per_warp = min(thyper.MAX_PER_BLOCK, -(-nchains // chol.SM_COUNT))
    for v in range(1, thyper.MAX_HYPER_V + 1):
        want = ("warp", per_warp) if v <= 64 else ("block", 1)
        assert thyper.launch_form(nchains, v) == want, v
    # the measurement override refuses the warp form past v = 64
    thyper.check_per_block("hyper_mh", 8, 64, thyper.HYPER_WARP_MAX_V)
    with pytest.raises(ValueError):
        thyper.check_per_block("hyper_mh", 1, 65, thyper.HYPER_WARP_MAX_V)


def test_mh_wrappers_reject_other_devices():
    x = torch.zeros(2, 3, device="meta")
    with pytest.raises(RuntimeError):
        twhite.white_mh(x, torch.zeros(2, 4, device="meta"),
                        torch.zeros(2, 4, device="meta"),
                        torch.zeros(2, 5, 3, device="meta"),
                        torch.zeros(2, 5, device="meta"),
                        torch.zeros(2, 4, device="meta"),
                        torch.zeros(3, 3, device="meta"), ())


def test_separate_ties_moves_float32_decisions_out_of_reach():
    rng = np.random.default_rng(5)
    Cs, S = 256, 8
    x = torch.from_numpy(rng.normal(size=(Cs, 2)))
    dx = torch.from_numpy(rng.normal(size=(Cs, S, 2)))
    logu = torch.from_numpy(np.log(rng.random((Cs, S)))).float()

    def ll64(q):
        q = q.double()
        return -0.5 * (q * q).sum(-1), torch.zeros_like(q[:, 0])

    def ll32(q):
        """ll64 off by 0.3 q0, and -inf where q1 > 1.5"""
        ll, lp = ll64(q)
        ll = torch.where(q[:, 1] > 1.5, -math.inf, ll + 0.3 * q[:, 0])
        return ll.float(), lp.float()

    info = {}
    lu = separate_ties(ll64, x, dx, logu, others=(ll32,), info=info)
    assert info["forced"] > 0 and info["max_err"] > 0.3
    plain = separate_ties(ll64, x, dx, logu)
    assert (lu != logu).sum() > (plain != logu).sum()
    w64, w32 = ll64(x)[0], ll32(x.float())[0].double()
    for i in range(S):
        q = x + dx[:, i]
        d64 = ll64(q)[0] - w64
        d32 = ll32(q.float())[0].double() - w32
        acc = d64 > logu[:, i].double()
        assert torch.equal(d64 > lu[:, i].double(), acc)
        fin = torch.isfinite(d32)
        assert torch.equal((d32 > lu[:, i].double())[fin], acc[fin])
        assert torch.isinf(lu[:, i][~fin]).all()
        x = torch.where(acc[:, None], q, x)
        w64 = torch.where(acc, ll64(q)[0], w64)
        w32 = torch.where(acc, ll32(q.float())[0].double(), w32)
