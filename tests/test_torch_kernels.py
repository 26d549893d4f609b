"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device (and ``nvcc``, which builds the
kernels at first use), is marked ``torch`` and skips on a host without
CUDA. The file imports neither ``jax`` nor the JAX package and uses no
conftest fixture, so it runs where only PyTorch is installed::

    python -m pytest --noconftest -m torch tests/test_torch_kernels.py -q

It covers what ``chip_smoke.py`` does not reach at the flagship shapes:
the factor in each of its launch forms (a warp per matrix with one, two
and three rows a lane at m = 14/15, 60 and 64 to 95, 16-byte and 4-byte
copies, a ragged last block; a block per matrix at m = 96 and at the
bound m = 160, shared memory past the 48 KB default), failed pivots that
must stay inside their own matrix (also where a lane's third row fails,
at m = 74 and 95, in every matrices-per-block count), the hyper kernel
at v = 14, 60, 64 and its
bound v = 160, with 64 chains and with 1,027 (a ragged last block), and the
closure path (the plain hyper loop with the factor kernel), which the
sampler takes above that bound; the white kernel past shared memory
(n = 20,000 and 102,400, operands read from device memory), the white
MTM kernel with dead weights, and the Gram kernel with padded rows, at
1, 2, 5, 7, 64 and 100 chains (the last two chain tiles of 64, one
ragged), m = 3, 12, 74, 174 and 720 (past 710 the kernel takes its
8-TOA tile), and TOA counts that leave its last TOA tile and its last
TOA split short. Then the serving slot pool's lanes entries: the Gram
kernel's lanes form (one basis per 16-lane group) at 1 to 64 groups,
n = 1 to 2,000 and m = 3 to 174, with padded bases and flat operands,
each group the same floats in every tiles-per-block launch as alone; the
white and hyper lanes blocks, each group bit for bit its single-model
launch; the factor and back-solve lanes entries, bit for bit the plain
entries. The back-solve alone at m = 1 to 160, at batches ragged against
its four systems a block, with failed factors in a block of good ones.
The factor at (1024, 74) and (1, 74), the shapes the sampler's chunk-end
log-posterior and ``lnlikelihood`` launch, in the warp form they take and
in the block form kept for measurements; the
record wire casts (``record_tuple``) on the card, bit for bit the CPU's
after the pinned-memory copy. The per-chain draw kernel (D1,
``rng.sweep_draws``) against its plain version on every field kind, with
one sweep index and with one a chain, at one chain, 1,027 chains (ragged
tiles), a field of one value and 3,000 gammas a column, the shapes that
reject most mixed with others in one tile, bad and edge shapes (NaN only
for the bad ones, the good chains as when drawn alone) and 102,400 values
a column: against the CPU uniforms bit for bit, the float64
transcendentals' float32 results equal but for at most 1e-4 of them, one
ulp apart; against the plain version on the card bit for bit at every
tile length; and a flagship sampler's draws on the card equal to the
CPU's.

Tolerances: kernel and plain version both compute in float32, in other
summation orders. Factors, solves and logdets agree to rtol 1e-4 / atol
1e-5 at condition number 30, the tolerance the CPU tests hold the plain
versions to against the JAX package. The MH blocks take identical
decisions on draws kept clear of every tie (a float64 replay of the plain
version moves any closer draw away, on the side of its decision; 1e-3 at
130 TOAs, 0.1 at 1e4-1e5 TOAs, where a float32 log-likelihood summed over
the TOAs is itself uncertain by ~0.03) and agree on x to 1e-5 relative.
The Gram kernel's TNT and d agree with a float64 evaluation to 1e-4 of
the same sums taken over absolute values (M = |T|^T w |T|): a float32 sum
over 1e4 TOAs cannot meet a plain relative bound on entries that cancel.

The jump, state and tie helpers below are shared with the CPU tests that
hold the plain MH blocks against the JAX package (test_torch_mh.py,
test_torch_sweep.py), the wire-state helpers with test_torch_sample.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gibbs_student_t_tpu_torch.backends import torch_backend as tb
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.models.pta import (
    ndiag,
    phiinv_logdet,
    static_phi_columns,
)
from gibbs_student_t_tpu_torch.ops import chol, linalg, rng
from gibbs_student_t_tpu_torch.ops import hyper_mh as thyper
from gibbs_student_t_tpu_torch.ops import white_mh as twhite
from gibbs_student_t_tpu_torch.ops import tnt as ttnt
from gibbs_student_t_tpu_torch.ops.lanes import LANES_GROUP
from gibbs_student_t_tpu_torch.ops.tnt import pad_rows, tnt_products
from gibbs_student_t_tpu_torch.testing import separate_mtm_ties, separate_ties

C = 64


def spd(rng, B, m, cond=1e3):
    """Batch of SPD float32 matrices with unit diagonal (the equilibrated
    form every factorization of the sweep sees) and eigenvalues spread
    over ``cond``."""
    Q, _ = np.linalg.qr(rng.normal(size=(B, m, m)))
    ev = np.exp(rng.uniform(0, np.log(cond), size=(B, m)))
    S = np.einsum("bij,bj,bkj->bik", Q, ev, Q)
    isd = 1.0 / np.sqrt(np.diagonal(S, axis1=1, axis2=2))
    S = S * isd[:, :, None] * isd[:, None, :]
    return (0.5 * (S + np.swapaxes(S, 1, 2))).astype(np.float32)


def jumps(rng, ind, S, p, dense, scale, C=C):
    if dense:
        return (rng.normal(size=(C, S, p)) * scale).astype(np.float32)
    dx = np.zeros((C, S, p), np.float32)
    pick = rng.choice(ind, size=(C, S))
    vals = rng.normal(size=(C, S)) * scale * rng.choice(
        [0.1, 0.5, 1.0, 3.0, 10.0], size=(C, S))
    np.put_along_axis(dx, pick[..., None], vals[..., None].astype(np.float32),
                      axis=2)
    return dx


def near_posterior(rng, ma, C=C):
    x = np.array([-7.5, 4.0, -14.0]) + rng.normal(0, [0.4, 0.5, 0.3],
                                                  (C, 3))
    z = (rng.random((C, ma.n)) < 0.05).astype(np.float32)
    alpha = rng.gamma(2.0, 3.0, (C, ma.n)).astype(np.float32)
    return x.astype(np.float32), (alpha ** z).astype(np.float32)


def acc_counts(acc, S):
    """Per-chain accept counts from accept rates (count / S)."""
    return np.round(np.asarray(acc, np.float64) * S).astype(int)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.torch
@pytest.mark.parametrize("m", [14, 15, 60, 64, 65, 160, 74, 95, 96])
def test_chol_kernels_on_card(m):
    """Every launch form of the factor, at a batch whose last block is
    ragged where several matrices share a block."""
    dev = _cuda()
    rng = np.random.default_rng(1 + m)
    B = 1061 if m <= chol.WARP_MAX_DIM else 259
    form, per_block = chol.launch_form(B, m)
    assert ((form == "warp") == (m <= chol.WARP_MAX_DIM)
            and B % max(per_block, 2) == 1)
    S = spd(rng, B, m, cond=30.0)
    S[3] = -S[3]                          # failed first pivot
    S = torch.from_numpy(S).to(dev)
    r = torch.from_numpy(rng.normal(size=(B, m)).astype(np.float32)).to(dev)
    n_f, n_b = chol.chol_fused.launches, chol.tri_solve_T.launches
    L, ld, u = chol.chol_fused(S, r)
    x = chol.tri_solve_T(L, r)
    torch.cuda.synchronize()
    assert (chol.chol_fused.launches, chol.tri_solve_T.launches) == (
        n_f + 1, n_b + 1)
    Lp, ldp, up = chol.chol_fused_plain(S, r)
    xp = chol.tri_solve_T_plain(Lp, r)
    assert torch.isnan(ld[3]) and torch.isnan(ldp[3])
    good = torch.arange(B, device=dev) != 3
    for a, b in ((L, Lp), (ld, ldp), (u, up), (x, xp)):
        torch.testing.assert_close(a[good], b[good], rtol=1e-4, atol=1e-5)
    assert not torch.triu(L[good], 1).any()


@pytest.mark.torch
@pytest.mark.parametrize("per_block", [1, 4, 8, 0])
def test_chol_non_pd_stays_in_its_matrix_on_card(per_block):
    """Matrices that fail (a negative first pivot, a negative pivot deeper
    in, a zero pivot) among good ones that share their block: NaN logdet
    for the failed ones alone, and the others equal to the plain version's
    and to what they give in a batch without failures."""
    dev = _cuda()
    rng = np.random.default_rng(17)
    m, B = 60, 37
    S = spd(rng, B, m, cond=30.0)
    clean = torch.from_numpy(S.copy()).to(dev)
    S[3] = -S[3]
    S[5, 40, 40] = -1.0
    S[5, 40, :40] = S[5, :40, 40] = 0.0
    S[12, 59, 59] = 0.0
    S[12, 59, :59] = S[12, :59, 59] = 0.0
    bad = [3, 5, 12]
    S = torch.from_numpy(S).to(dev)
    r = torch.from_numpy(rng.normal(size=(B, m)).astype(np.float32)).to(dev)
    L, ld, u = chol.chol_fused(S, r, per_block=per_block)
    Lc, ldc, uc = chol.chol_fused(clean, r, per_block=per_block)
    Lp, ldp, up = chol.chol_fused_plain(S, r)
    torch.cuda.synchronize()
    good = torch.ones(B, dtype=torch.bool, device=dev)
    good[bad] = False
    assert not torch.isfinite(ld[~good]).any()
    assert not torch.isfinite(ldp[~good]).any()
    assert torch.isnan(ld[[3, 5]]).all()
    for a, b, c in ((L, Lp, Lc), (ld, ldp, ldc), (u, up, uc)):
        assert torch.isfinite(a[good]).all()
        torch.testing.assert_close(a[good], b[good], rtol=1e-4, atol=1e-5)
        assert torch.equal(a[good], c[good])


@pytest.mark.torch
@pytest.mark.parametrize("dense", [False, True])
def test_white_mh_kernel_on_card(dense):
    dev = _cuda()
    ma = make_demo_model_arrays()
    rng = np.random.default_rng(51 + dense)
    wc = twhite.build_white_consts(ma)
    x, az = near_posterior(rng, ma)
    b = (rng.normal(size=(C, ma.m)) * 0.05).astype(np.float32)
    yred = ma.y.astype(np.float32)[None] - b @ ma.T.astype(np.float32).T
    y2 = (yred * yred).astype(np.float32)
    S = 20
    dx = jumps(rng, ma.white_indices, S, 3, dense, 0.05)
    tt = torch.from_numpy
    logu = separate_ties(
        lambda q: twhite.white_ll_lp(q, tt(az).double(), tt(y2).double(),
                                     tt(wc.rows).double(), wc.var,
                                     tt(wc.specs).double()),
        tt(x), tt(dx), torch.log(tt(rng.random((C, S)).astype(np.float32))))
    ops = [t.to(dev) for t in (tt(x), tt(az), tt(y2), tt(dx), logu,
                               tt(wc.rows), tt(wc.specs))]
    xk, ak = twhite.white_mh(*ops, wc.var)
    xp, ap = twhite.white_mh_loop(*ops, wc.var)
    nk = acc_counts(ak.cpu(), S)
    np.testing.assert_array_equal(nk, acc_counts(ap.cpu(), S))
    assert 0 < nk.sum() < C * S
    torch.testing.assert_close(xk, xp, rtol=1e-5, atol=0.0)


def hyper_operands(ma, rng, C=C):
    """The hyper block's operands on a model's Schur split, built with the
    port's own pieces: float64 model functions, float32 products and
    elimination. Chain 0's block is made indefinite for every proposal
    (an off-diagonal pair far beyond its diagonal)."""
    x, az = near_posterior(rng, ma, C)
    x64 = x.astype(np.float64)
    nvec = az * np.stack([ndiag(ma, xx) for xx in x64]).astype(np.float32)
    phiinv = np.stack([phiinv_logdet(ma, xx)[0] for xx in x64])
    tt = torch.from_numpy
    TNT, d, const = tnt_products(tt(ma.T.astype(np.float32)),
                                 tt(ma.y.astype(np.float32)), tt(nvec))
    smask = static_phi_columns(ma)
    s_i, v_i = np.flatnonzero(smask), np.flatnonzero(~smask)
    A = (TNT[:, s_i][:, :, s_i]
         + torch.diag_embed(tt(phiinv[:, s_i].astype(np.float32))))
    S0, rt, quad_s, logdetA = linalg.schur_eliminate(
        A, TNT[:, s_i][:, :, v_i], TNT[:, v_i][:, :, v_i], d[:, s_i],
        d[:, v_i], 1e-6)
    hc = thyper.build_hyper_consts(ma, v_i)
    base = const + 0.5 * (quad_s - logdetA) - 0.5 * hc.logdet_phi_static
    dS0 = torch.diagonal(S0, dim1=-2, dim2=-1) + tt(hc.phiinv_static)
    S0[0, 0, 1] = S0[0, 1, 0] = 1e15 * torch.sqrt(dS0[0, 0] * dS0[0, 1])
    return (tt(x), S0, dS0, rt, base), hc


@pytest.mark.torch
@pytest.mark.parametrize("path", ["fused", "closure"])
@pytest.mark.parametrize("components", [30, 80])
def test_hyper_mh_kernel_on_card(components, path):
    """v = 60 (the flagship) and v = 160 (the kernel's bound); ``closure``
    is the plain loop factoring through the chol kernel, the sampler's
    path above the bound."""
    dev = _cuda()
    ma = make_demo_model_arrays(components=components)
    rng = np.random.default_rng(61 + components)
    ops, hc = hyper_operands(ma, rng)
    assert ops[1].shape[-1] == 2 * components
    S = 10
    tt = torch.from_numpy
    dx = tt(jumps(rng, ma.hyper_indices, S, 3, True, 0.1))
    consts = [tt(a) for a in (hc.K, hc.phi_sel, hc.specs)]
    logu = separate_ties(
        lambda q: thyper.hyper_ll_lp(
            q, *(t.double() for t in ops[1:]),
            *(t.double() for t in consts), hc.hyp_idx, 1e-6),
        ops[0], dx, torch.log(tt(rng.random((C, S)).astype(np.float32))))
    args = [t.to(dev) for t in (*ops, dx, logu, *consts)]
    if path == "fused":
        xk, ak = thyper.hyper_mh(*args, hc.hyp_idx, 1e-6)
    else:
        n_f = chol.chol_fused.launches
        xk, ak = thyper.hyper_mh_loop(*args, hc.hyp_idx, 1e-6,
                                      factor=chol.chol_fused)
        assert chol.chol_fused.launches == n_f + S + 1
    xp, ap = thyper.hyper_mh_loop(*args, hc.hyp_idx, 1e-6)
    nk = acc_counts(ak.cpu(), S)
    np.testing.assert_array_equal(nk, acc_counts(ap.cpu(), S))
    assert nk[0] == 0                     # the indefinite chain rejects
    assert 0 < nk.sum() < C * S
    torch.testing.assert_close(xk, xp, rtol=1e-5, atol=0.0)


@pytest.mark.torch
@pytest.mark.parametrize("components, nchains", [(30, 1027), (7, 64),
                                                 (32, 64), (32, 1027)])
def test_hyper_mh_kernel_forms_on_card(components, nchains):
    """The warp form beside the flagship's: a ragged last block (1,027
    chains, 8 a block), one row a lane (v = 14) and three (v = 64, where
    the right-hand-side row is a lane's third), and every chains-per-block
    count giving the same decisions."""
    dev = _cuda()
    ma = make_demo_model_arrays(components=components)
    rng = np.random.default_rng(67 + components + nchains)
    ops, hc = hyper_operands(ma, rng, nchains)
    v = ops[1].shape[-1]
    assert v == 2 * components
    assert thyper.launch_form(nchains, v) == (
        "warp", 8 if nchains > 1000 else 1)
    S = 10
    tt = torch.from_numpy
    dx = tt(jumps(rng, ma.hyper_indices, S, 3, True, 0.1, nchains))
    consts = [tt(a) for a in (hc.K, hc.phi_sel, hc.specs)]
    logu = separate_ties(
        lambda q: thyper.hyper_ll_lp(
            q, *(t.double() for t in ops[1:]),
            *(t.double() for t in consts), hc.hyp_idx, 1e-6),
        ops[0], dx,
        torch.log(tt(rng.random((nchains, S)).astype(np.float32))))
    args = [t.to(dev) for t in (*ops, dx, logu, *consts)]
    n0 = thyper.hyper_mh.launches
    xk, ak = thyper.hyper_mh(*args, hc.hyp_idx, 1e-6)
    assert thyper.hyper_mh.launches == n0 + 1
    xp, ap = thyper.hyper_mh_loop(*args, hc.hyp_idx, 1e-6)
    nk = acc_counts(ak.cpu(), S)
    np.testing.assert_array_equal(nk, acc_counts(ap.cpu(), S))
    assert nk[0] == 0                     # the indefinite chain rejects
    assert 0 < nk.sum() < nchains * S
    torch.testing.assert_close(xk, xp, rtol=1e-5, atol=0.0)
    for per_block in (1, 3, 8):
        xv, av = thyper.hyper_mh(*args, hc.hyp_idx, 1e-6,
                                 per_block=per_block)
        assert torch.equal(xv, xk) and torch.equal(av, ak)


def white_operands(rng, n, C=C):
    """White-block operands at ``n`` TOAs tiled from the flagship model's
    (constant rows, az and yred^2 of a near-posterior state), the last 37
    TOAs masked as padding. Returns ``(x, az, y2, rows, wc)``."""
    ma = make_demo_model_arrays()
    wc = twhite.build_white_consts(ma)
    x, az = near_posterior(rng, ma, C)
    b = (rng.normal(size=(C, ma.m)) * 0.05).astype(np.float32)
    yred = ma.y.astype(np.float32)[None] - b @ ma.T.astype(np.float32).T
    reps = -(-n // ma.n)
    rows = np.tile(wc.rows, (1, reps))[:, :n].copy()
    rows[1, n - 37:] = 0.0
    az = np.tile(az, (1, reps))[:, :n]
    y2 = (np.tile(yred, (1, reps))[:, :n] ** 2
          * rng.uniform(0.5, 1.5, (C, n))).astype(np.float32)
    return x, az, y2, rows, wc


@pytest.mark.torch
@pytest.mark.parametrize("n", [20000, 102400])
def test_white_mh_kernel_past_shared_memory_on_card(n):
    """The white block at sizes whose per-chain rows do not fit in one
    block's shared memory: a chain spans a thread-block cluster, each
    block holding its slice of the TOAs."""
    dev = _cuda()
    rng = np.random.default_rng(71 + n)
    x, az, y2, rows, wc = white_operands(rng, n)
    form = twhite.white_form(n, 3)
    assert form.form == "cluster" and form.cluster > 1 and form.on_chip
    S = 20
    dx = jumps(rng, [wc.var[0][1]], S, 3, False, 0.05)
    tt = torch.from_numpy
    logu = separate_ties(
        lambda q: twhite.white_ll_lp(q, tt(az).double(), tt(y2).double(),
                                     tt(rows).double(), wc.var,
                                     tt(wc.specs).double()),
        tt(x), tt(dx), torch.log(tt(rng.random((C, S)).astype(np.float32))),
        margin=0.1, push=0.2)
    ops = [t.to(dev) for t in (tt(x), tt(az), tt(y2), tt(dx), logu,
                               tt(rows), tt(wc.specs))]
    n0 = twhite.white_mh.launches
    xk, ak = twhite.white_mh(*ops, wc.var)
    xp, ap = twhite.white_mh_loop(*ops, wc.var)
    assert twhite.white_mh.launches == n0 + 1
    nk = acc_counts(ak.cpu(), S)
    np.testing.assert_array_equal(nk, acc_counts(ap.cpu(), S))
    assert 0 < nk.sum() < C * S
    torch.testing.assert_close(xk, xp, rtol=1e-5, atol=0.0)


@pytest.mark.torch
@pytest.mark.parametrize("dense", [False, True])
def test_white_mtm_kernel_on_card(dense):
    """K = 4 tries at the flagship shape. Chain 1 starts outside the prior
    (every weight of every step -inf on both sides: a NaN delta, never an
    accept); chains 2-5 propose only dead candidates at step 3."""
    dev = _cuda()
    ma = make_demo_model_arrays()
    rng = np.random.default_rng(81 + dense)
    wc = twhite.build_white_consts(ma)
    x, az = near_posterior(rng, ma)
    x[1, 0] = 50.0
    b = (rng.normal(size=(C, ma.m)) * 0.05).astype(np.float32)
    yred = ma.y.astype(np.float32)[None] - b @ ma.T.astype(np.float32).T
    y2 = (yred * yred).astype(np.float32)
    S, K = 20, 4
    dx = jumps(rng, ma.white_indices, S * K, 3, dense, 0.05).reshape(
        C, S, K, 3)
    dx[2:6, 3, :, 0] = 100.0
    dxr = jumps(rng, ma.white_indices, S * (K - 1), 3, dense, 0.05).reshape(
        C, S, K - 1, 3)
    tt = torch.from_numpy
    gumb = -torch.log(-torch.log(tt(rng.random((C, S, K)).astype(
        np.float32))))
    logu = torch.log(tt(rng.random((C, S)).astype(np.float32)))
    az64, y264 = tt(az).double(), tt(y2).double()
    rows64, specs64 = tt(wc.rows).double(), tt(wc.specs).double()

    def weight64(q):
        ll, lp = twhite.white_ll_lp(q, az64[:, None], y264[:, None], rows64,
                                    wc.var, specs64)
        return ll + lp

    gumb, logu = separate_mtm_ties(weight64, tt(x), tt(dx), tt(dxr), gumb,
                                   logu)
    ops = [t.to(dev) for t in (tt(x), tt(az), tt(y2), tt(dx), tt(dxr), gumb,
                               logu, tt(wc.rows), tt(wc.specs))]
    n0 = twhite.white_mtm.launches
    xk, ak = twhite.white_mtm(*ops, wc.var)
    xp, ap = twhite.white_mtm_loop(*ops, wc.var)
    assert twhite.white_mtm.launches == n0 + 1
    nk = acc_counts(ak.cpu(), S)
    np.testing.assert_array_equal(nk, acc_counts(ap.cpu(), S))
    assert nk[1] == 0 and float(xk[1, 0]) == 50.0
    assert 0 < nk.sum() < C * S
    torch.testing.assert_close(xk, xp, rtol=1e-5, atol=0.0)


def white_case(rng, dev, n, C=C, S=20, K=None, nparam=3, edit=None):
    """A white block's (or, with ``K``, a white MTM block's) operands at
    ``n`` TOAs (:func:`white_operands`) on the card, every draw kept clear
    of its float64 decision (1e-3 at 130 TOAs, 0.1 above, where a float32
    sum over the TOAs is itself uncertain by ~0.03). ``nparam`` pads the
    parameter vector with uniform-prior parameters the block never moves;
    ``edit(x, dx, rows, y2)`` changes the numpy operands in place before
    the draws are separated. Returns ``(ops, var)``, ``ops`` in the
    wrapper's order."""
    x, az, y2, rows, wc = white_operands(rng, n, C)
    specs = wc.specs
    if nparam > 3:
        x = np.concatenate([x, np.zeros((C, nparam - 3), np.float32)], 1)
        extra = np.tile(np.array([[0.0], [-1.0], [1.0]], np.float32),
                        (1, nparam - 3))
        specs = np.concatenate([specs, extra], 1)
    p = x.shape[1]
    wi = [v[1] for v in wc.var]
    if K is None:
        dx = jumps(rng, wi, S, p, False, 0.05, C=C)
    else:
        live = (np.arange(p) < 3).astype(np.float32)
        dx = jumps(rng, wi, S * K, p, True, 0.05, C=C).reshape(
            C, S, K, p) * live
        dxr = jumps(rng, wi, S * (K - 1), p, True, 0.05, C=C).reshape(
            C, S, K - 1, p) * live
    if edit is not None:
        edit(x, dx, rows, y2)
    margin = 1e-3 if n <= 130 else 0.1
    tt = torch.from_numpy
    x_, az_, y2_, rows_, specs_ = (tt(np.ascontiguousarray(a)).to(dev)
                                   for a in (x, az, y2, rows, specs))
    a64 = [t.double() for t in (az_, y2_, rows_, specs_)]
    if K is None:
        dx = tt(dx).to(dev)
        logu = separate_ties(
            lambda q: twhite.white_ll_lp(q, *a64[:3], wc.var, a64[3]), x_,
            dx, torch.log(tt(rng.random((C, S)).astype(np.float32))).to(dev),
            margin=margin, push=2 * margin)
        return [x_, az_, y2_, dx, logu, rows_, specs_], wc.var
    dx, dxr = tt(dx).to(dev), tt(dxr).to(dev)
    gumb = -torch.log(-torch.log(tt(rng.random((C, S, K)).astype(
        np.float32)))).to(dev)
    logu = torch.log(tt(rng.random((C, S)).astype(np.float32))).to(dev)

    def weight64(q):
        ll, lp = twhite.white_ll_lp(q, a64[0][:, None], a64[1][:, None],
                                    a64[2], wc.var, a64[3])
        return ll + lp

    gumb, logu = separate_mtm_ties(weight64, x_, dx, dxr, gumb, logu,
                                   margin=margin, push=2 * margin)
    return [x_, az_, y2_, dx, dxr, gumb, logu, rows_, specs_], wc.var


def check_white(ops, var, mtm, S=20, active=True):
    """One launch of the white MH (or MTM) kernel against its plain
    version and its float64 plain version: equal accept counts on every
    chain, x within 1e-5 relative; returns the kernel's accept counts."""
    fn = twhite.white_mtm if mtm else twhite.white_mh
    plain = twhite.white_mtm_loop if mtm else twhite.white_mh_loop
    n0 = fn.launches
    xk, ak = fn(*ops, var)
    assert fn.launches == n0 + 1
    xp, ap = plain(*ops, var)
    x64, a64 = plain(*(t.double() for t in ops), var)
    nk = acc_counts(ak.cpu(), S)
    np.testing.assert_array_equal(nk, acc_counts(ap.cpu(), S))
    np.testing.assert_array_equal(nk, acc_counts(a64.cpu(), S))
    if active:
        assert 0 < nk.sum() < nk.size * S
    torch.testing.assert_close(xk, xp, rtol=1e-5, atol=0.0, equal_nan=True)
    return nk


def white_constant(n, name):
    """``n`` as given, or, as ``"<name>"`` or ``"<name> + 1"``, the white
    kernels' constant ``name`` of :class:`white_mh.WhiteForm` (plus one),
    read from the built kernels."""
    if isinstance(n, int):
        return n
    base = getattr(twhite.white_form(130, 3), name)
    return base + 1 if n.endswith("+ 1") else base


@pytest.mark.torch
@pytest.mark.parametrize("mtm", [False, True])
@pytest.mark.parametrize("n", [130, "crossover", "crossover + 1", 20000,
                               50001, 102400])
def test_white_kernels_across_forms_on_card(n, mtm):
    """The white MH and white MTM (K = 4) kernels on either side of the
    crossover between the warp form (a warp a chain) and the cluster form
    (a thread-block cluster a chain), at the flagship's 130 TOAs, at the
    stress path's 102,400 and at 50,001 (no multiple of a cluster's blocks
    x 32, a ragged last slice), against the plain and float64 versions."""
    dev = _cuda()
    n = white_constant(n, "crossover")
    form = twhite.white_form(n, 3)
    want = "warp" if n <= form.crossover else "cluster"
    assert form.form == want and form.on_chip
    rng = np.random.default_rng(91 + n + mtm)
    ops, var = white_case(rng, dev, n, K=4 if mtm else None)
    check_white(ops, var, mtm)


@pytest.mark.torch
@pytest.mark.parametrize("mtm", [False, True])
def test_white_cluster_from_device_memory_on_card(mtm):
    """Past the TOAs eight blocks can stage (two blocks an SM), the
    cluster form reads each block's slice from device memory: the same
    kernel, the same decisions."""
    dev = _cuda()
    n = 120_000
    form = twhite.white_form(n, 3)
    assert form.form == "cluster" and form.cluster == 8
    assert not form.on_chip
    rng = np.random.default_rng(95 + mtm)
    ops, var = white_case(rng, dev, n, C=16, K=4 if mtm else None)
    check_white(ops, var, mtm)


@pytest.mark.torch
@pytest.mark.parametrize("n", [130, 20000])
@pytest.mark.parametrize("K", [2, 4, "tries_pass + 1"])
def test_white_mtm_tries_on_card(K, n):
    """The white MTM kernel at K = 2, 4 and one try past a pass (the
    candidates then take two passes) in both forms."""
    dev = _cuda()
    K = white_constant(K, "tries_pass")
    rng = np.random.default_rng(97 + K + n)
    ops, var = white_case(rng, dev, n, K=K)
    check_white(ops, var, True)


@pytest.mark.torch
@pytest.mark.parametrize("mtm", [False, True])
@pytest.mark.parametrize("n", [130, 20000])
def test_white_kernels_edge_cases_on_card(n, mtm):
    """In both forms: a NaN proposal (chain 0, step 2: never accepted), a
    chain outside its prior (chain 1: every weight -inf, never an accept),
    an all -inf MTM step (chains 2-5, step 3: every candidate outside the
    prior; the step keeps x), and fully masked TOAs (every row masked and
    y^2 = 0: ll = 0 exactly, decisions from the prior alone)."""
    dev = _cuda()
    rng = np.random.default_rng(99 + n + mtm)

    def edges(x, dx, rows, y2):
        dx[0, 2] = np.nan
        x[1, 0] = 50.0
        if mtm:
            dx[2:6, 3, :, 0] = 100.0

    ops, var = white_case(rng, dev, n, K=4 if mtm else None, edit=edges)
    nk = check_white(ops, var, mtm)
    assert nk[1] == 0
    xk, _ = (twhite.white_mtm if mtm else twhite.white_mh)(*ops, var)
    assert torch.isfinite(xk).all() and torch.equal(xk[1], ops[0][1])

    def masked(x, dx, rows, y2):
        rows[1] = 0.0
        y2[:] = 0.0

    ops, var = white_case(rng, dev, n, K=4 if mtm else None, edit=masked)
    check_white(ops, var, mtm, active=False)


@pytest.mark.torch
@pytest.mark.parametrize("mtm", [False, True])
def test_white_grouped_cluster_on_card(mtm):
    """The grouped cluster form: 3 groups of 5 chains at 20,000 TOAs, each
    group its own constant rows, against the grouped plain version; each
    group alone through the single-model launch gives the same values bit
    for bit."""
    dev = _cuda()
    rng = np.random.default_rng(103 + mtm)
    G_, C_, n = 3, 5, 20000
    per = [white_case(rng, dev, n, C=C_, K=4 if mtm else None,
                      edit=lambda x, dx, rows, y2, g=g: rows[0].__imul__(
                          1.0 + 0.25 * g))
           for g in range(G_)]
    var = per[0][1]
    k = 7 if mtm else 5
    ops = [torch.stack([o[0][i] for o in per]) for i in range(k + 2)]
    fn = twhite.white_mtm if mtm else twhite.white_mh
    plain = twhite.white_mtm_loop if mtm else twhite.white_mh_loop
    g0 = fn.launches_grouped
    xk, ak = fn(*ops, var)
    assert fn.launches_grouped == g0 + 1
    xp, ap = plain(*ops, var)
    np.testing.assert_array_equal(acc_counts(ak.cpu(), 20),
                                  acc_counts(ap.cpu(), 20))
    torch.testing.assert_close(xk, xp, rtol=1e-5, atol=1e-6)
    for g in range(G_):
        xs, as_ = fn(*(t[g] for t in ops), var)
        assert torch.equal(xs, xk[g]) and torch.equal(as_, ak[g])


@pytest.mark.torch
def test_white_quotient_on_card():
    """The white kernels' quotient, written out so a chunk's quotients
    interleave, equals `/` bit for bit wherever the kernels take it (both
    operands in [2^-60, 2^61), y2 may be 0), on random exponents and
    mantissas across that window and at its edges."""
    dev = _cuda()
    from gibbs_student_t_tpu_torch.ops import _cuda as cu

    rng = np.random.default_rng(109)
    n = 1 << 24
    d = np.ldexp(rng.uniform(1.0, 2.0, n), rng.integers(-60, 61, n))
    y = np.ldexp(rng.uniform(1.0, 2.0, n), rng.integers(-60, 61, n))
    y[rng.random(n) < 1 / 16] = 0.0
    edge = np.array([2.0 ** -60, 2.0 ** 61 * (1 - 2.0 ** -24), 1.0,
                     1.0 + 2.0 ** -23])
    d[:4], y[4:8] = edge, edge
    dt = torch.from_numpy(d.astype(np.float32)).to(dev)
    yt = torch.from_numpy(y.astype(np.float32)).to(dev)
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    cu.check(cu.lib().gst_white_check(cu.ptr(dt), cu.ptr(yt), cu.ptr(out),
                                      n, cu.stream(dev)), "white_check")
    q_mine, q_ref = out[0].cpu().numpy(), out[1].cpu().numpy()
    np.testing.assert_array_equal(q_mine.view(np.uint32),
                                  q_ref.view(np.uint32))


@pytest.mark.torch
def test_white_refused_launch_raises_on_card():
    """A cluster launch the card refuses (12,000 parameters: the block's
    slot, 6 p + 32 floats, exceeds a block's shared memory) raises instead
    of returning unwritten outputs."""
    dev = _cuda()
    rng = np.random.default_rng(107)
    ops, var = white_case(rng, dev, 20000, C=4, S=2, nparam=12000)
    with pytest.raises(RuntimeError, match="white_mh"):
        twhite.white_mh(*ops, var)


@pytest.mark.torch
def test_white_cluster_form_holds_many_parameters_on_card():
    """The cluster form's warps share one slot a block (x, the prior table
    and a pass's coefficients: 6 p + 32 floats), so the stress shape's
    slices stay staged far past its p = 3; at 40 parameters both kernels
    run in that form against their plain versions."""
    dev = _cuda()
    for nparam in (3, 40, 400):
        form = twhite.white_form(102400, nparam)
        assert form.form == "cluster" and form.cluster == 8 and form.on_chip
    rng = np.random.default_rng(111)
    for mtm in (False, True):
        ops, var = white_case(rng, dev, 102400, C=8, K=4 if mtm else None,
                              nparam=40)
        check_white(ops, var, mtm)


@pytest.mark.torch
@pytest.mark.parametrize("C_, n_real, block, m", [
    (5, 1000, 256, 12),
    (64, 20000, 4096, 74),
    (1, 1000, 256, 12),      # one chain
    (100, 5000, 1024, 74),   # two chain tiles, the second ragged
    (7, 980, 30, 3),         # m = 3; n = 990, a short last TOA tile
    (64, 8000, 4096, 174),   # 80 Fourier components: m = 174
    (64, 3050, 100, 74),     # 97 TOA tiles: the last split short or empty
    (2, 200, 64, 720),       # m past 710: the 8-TOA tile
])
def test_tnt_kernel_on_card(C_, n_real, block, m):
    """The Gram kernel on a padded TOA axis against the blocked plain
    version and a float64 evaluation of the unpadded sums."""
    dev = _cuda()
    rng = np.random.default_rng(91 + m)
    T = rng.normal(size=(n_real, m)).astype(np.float32)
    y = rng.normal(size=n_real).astype(np.float32)
    nvec = np.exp(rng.normal(0.0, 1.0, (C_, n_real))).astype(np.float32)
    Tp, yp, n_pad = pad_rows(T, y, block)
    assert n_pad > 0
    nvp = np.concatenate([nvec, np.ones((C_, n_pad), np.float32)], 1)
    ops = [torch.from_numpy(a).to(dev) for a in (Tp, yp, nvp)]
    n0 = ttnt.tnt_batched.launches
    TNT, d, const = ttnt.tnt_batched(*ops, block)
    assert ttnt.tnt_batched.launches == n0 + 1
    TNTp, dp, constp = tnt_products(*ops, block)
    T64, y64, nv64 = (torch.from_numpy(a).double() for a in (T, y, nvec))
    TNT64, d64, const64 = tnt_products(T64, y64, nv64)
    M, Md, _ = tnt_products(T64.abs(), y64.abs(), nv64)
    for a in (TNT, TNTp):
        assert (a.cpu().double() - TNT64).abs().le(1e-4 * M).all()
    for a in (d, dp):
        assert (a.cpu().double() - d64).abs().le(1e-4 * Md).all()
    torch.testing.assert_close(const.cpu().double(), const64, rtol=1e-6,
                               atol=0.0)
    assert torch.equal(TNT, TNT.transpose(-1, -2))


def group_models(ns, components=30, seed0=100):
    """Pulsars with different constants for the grouped kernels: TOA
    counts ``ns`` padded to the largest with masked rows, TOA errors
    scaled by 1, 1.25, 1.5, ..."""
    import dataclasses

    from gibbs_student_t_tpu_torch.parallel.ensemble import pad_model_arrays

    mas = [make_demo_model_arrays(n=n, components=components, seed=seed0 + g)
           for g, n in enumerate(ns)]
    return pad_model_arrays([
        dataclasses.replace(ma, sigma2=ma.sigma2 * (1.0 + 0.25 * g))
        for g, ma in enumerate(mas)])


def grouped_white_operands(rng, mas, C, S, K=None):
    """The white block's (or, with ``K``, the white MTM block's) grouped
    operands, ``(G, C, ...)``, with the float64 tie separation done per
    group. Returns ``(ops, rows, specs, var)``."""
    tt = torch.from_numpy
    per = []
    for ma in mas:
        wc = twhite.build_white_consts(ma, ma.row_mask)
        x, az = near_posterior(rng, ma, C)
        b = (rng.normal(size=(C, ma.m)) * 0.05).astype(np.float32)
        yred = ma.y.astype(np.float32)[None] - b @ ma.T.astype(np.float32).T
        y2 = (yred * yred).astype(np.float32)
        lu = torch.log(tt(rng.random((C, S)).astype(np.float32)))
        a64 = [tt(a).double() for a in (az, y2, wc.rows, wc.specs)]
        if K is None:
            dx = tt(jumps(rng, ma.white_indices, S, 3, True, 0.05, C=C))
            lu = separate_ties(
                lambda q, a64=a64, wc=wc: twhite.white_ll_lp(
                    q, *a64[:3], wc.var, a64[3]), tt(x), dx, lu)
            per.append((tt(x), tt(az), tt(y2), dx, lu, wc))
            continue
        dx = tt(jumps(rng, ma.white_indices, S * K, 3, True, 0.05,
                      C=C).reshape(C, S, K, 3))
        dxr = tt(jumps(rng, ma.white_indices, S * (K - 1), 3, True, 0.05,
                       C=C).reshape(C, S, K - 1, 3))
        gumb = -torch.log(-torch.log(tt(rng.random((C, S, K)).astype(
            np.float32))))

        def weight64(q, a64=a64, wc=wc):
            ll, lp = twhite.white_ll_lp(q, a64[0][:, None], a64[1][:, None],
                                        a64[2], wc.var, a64[3])
            return ll + lp

        gumb, lu = separate_mtm_ties(weight64, tt(x), dx, dxr, gumb, lu)
        per.append((tt(x), tt(az), tt(y2), dx, dxr, gumb, lu, wc))
    ops = [torch.stack(f) for f in list(zip(*per))[:-1]]
    wcs = [p[-1] for p in per]
    assert all(wc.var == wcs[0].var for wc in wcs)
    return (ops, tt(np.stack([wc.rows for wc in wcs])),
            tt(np.stack([wc.specs for wc in wcs])), wcs[0].var)


@pytest.mark.torch
@pytest.mark.parametrize("mtm", [False, True])
@pytest.mark.parametrize("G_, C_", [(3, 5), (2, 16), (4, 64), (1, 64)])
def test_grouped_white_kernels_on_card(mtm, G_, C_):
    """The grouped white MH and white MTM kernels (G pulsars' constants,
    an odd number of chains per group among them) against their grouped
    plain versions; a one-group launch gives the single-model launch's
    values bit for bit."""
    dev = _cuda()
    rng = np.random.default_rng(101 + G_ + mtm)
    mas = group_models([130 - 10 * (g % 3) for g in range(G_)])
    S = 20
    ops, rows, specs, var = grouped_white_operands(
        rng, mas, C_, S, K=4 if mtm else None)
    if G_ > 1:
        assert not torch.equal(rows[0], rows[1])
    *ops, rows, specs = [t.to(dev) for t in (*ops, rows, specs)]
    fn = twhite.white_mtm if mtm else twhite.white_mh
    plain = twhite.white_mtm_loop if mtm else twhite.white_mh_loop
    n0, g0 = fn.launches, fn.launches_grouped
    xk, ak = fn(*ops, rows, specs, var)
    assert (fn.launches, fn.launches_grouped) == (n0, g0 + 1)
    assert xk.shape == (G_, C_, 3) and ak.shape == (G_, C_)
    xp, ap = plain(*ops, rows, specs, var)
    nk = acc_counts(ak.cpu(), S)
    np.testing.assert_array_equal(nk, acc_counts(ap.cpu(), S))
    assert 0 < nk.sum() < G_ * C_ * S
    torch.testing.assert_close(xk, xp, rtol=1e-5, atol=1e-6)
    # each group's chains alone, through the single-model launch
    for g in range(G_):
        xs, as_ = fn(*(t[g] for t in ops), rows[g], specs[g], var)
        assert torch.equal(xs, xk[g]) and torch.equal(as_, ak[g])
    assert fn.launches == n0 + G_


@pytest.mark.torch
@pytest.mark.parametrize("components", [30, 7, 80])
@pytest.mark.parametrize("per_block", [None, 1, 3, 8, 0])
def test_grouped_hyper_kernel_on_card(components, per_block):
    """The grouped hyper kernel with G = 3 pulsars' constants and 5 chains
    a group, so that with several warps a block (per_block 3 or 8) warps of
    two groups share a block, against the grouped plain version
    (v = 60 and 14 in the warp form, v = 160 in the block form). Each
    group's chains through the single-model launch give the same values
    bit for bit."""
    dev = _cuda()
    v = 2 * components
    if per_block not in (None, 0) and v > thyper.HYPER_WARP_MAX_V:
        pytest.skip("the hyper kernel's warp form takes v <= 64")
    rng = np.random.default_rng(111 + components)
    mas = [make_demo_model_arrays(n=n, components=components, seed=40 + g)
           for g, n in enumerate((130, 120, 110))]
    G_, C_, S = 3, 5, 10
    tt = torch.from_numpy
    per = []
    for ma in mas:
        ops, hc = hyper_operands(ma, rng, C_)
        consts = [tt(a) for a in (hc.K, hc.phi_sel, hc.specs)]
        dx = tt(jumps(rng, ma.hyper_indices, S, 3, True, 0.1, C=C_))
        logu = separate_ties(
            lambda q, ops=ops, consts=consts, hc=hc: thyper.hyper_ll_lp(
                q, *(t.double() for t in ops[1:]),
                *(t.double() for t in consts), hc.hyp_idx, 1e-6),
            ops[0], dx, torch.log(tt(rng.random((C_, S)).astype(
                np.float32))))
        per.append((*ops, dx, logu, *consts))
    hyp_idx = hc.hyp_idx
    args = [torch.stack(f).to(dev) for f in zip(*per)]
    assert args[1].shape == (G_, C_, v, v)
    assert not torch.equal(args[7][0], args[7][1])
    g0, n0 = thyper.hyper_mh.launches_grouped, thyper.hyper_mh.launches
    xk, ak = thyper.hyper_mh(*args, hyp_idx, 1e-6, per_block=per_block)
    assert thyper.hyper_mh.launches_grouped == g0 + 1
    xp, ap = thyper.hyper_mh_loop(*args, hyp_idx, 1e-6)
    nk = acc_counts(ak.cpu(), S)
    np.testing.assert_array_equal(nk, acc_counts(ap.cpu(), S))
    assert (nk[:, 0] == 0).all()          # each group's indefinite chain
    assert 0 < nk.sum() < G_ * C_ * S
    torch.testing.assert_close(xk, xp, rtol=1e-5, atol=1e-6)
    for g in range(G_):
        xs, as_ = thyper.hyper_mh(*(t[g] for t in args), hyp_idx, 1e-6,
                                  per_block=per_block)
        assert torch.equal(xs, xk[g]) and torch.equal(as_, ak[g])
    assert thyper.hyper_mh.launches == n0 + G_


# --- the serving lanes entries --------------------------------------------

def _gid_tiles(G_):
    return torch.arange(G_, dtype=torch.int32).repeat_interleave(
        LANES_GROUP)


@pytest.mark.torch
@pytest.mark.parametrize("G_, n, nT, m, flat", [
    (64, 130, 160, 74, False), (3, 90, 96, 10, False),
    (5, 2000, 2016, 174, False), (2, 33, 33, 3, True),
    (1, 130, 160, 74, False), (3, 1, 4, 17, False), (2, 31, 31, 15, True),
    (3, 32, 36, 16, False), (3, 32, 32, 31, False), (2, 33, 35, 32, True)])
def test_tnt_lanes_kernel_on_card(G_, n, nT, m, flat):
    """The Gram kernel's lanes form (one basis per 16-lane group, one
    launch for every group) against its plain version and a float64
    evaluation of each group's sums (1e-4 of the sums over absolute
    values, as the single-basis kernel), with the pool's padded bases
    (nT > n rows, the rows past n unread), with flat per-lane operands
    whose TOA count is not a multiple of 4, at one group, at n = 1, 31,
    32 and 33 TOAs, at m = 15 and 16 and at 31 and 32 (the Gram of
    [T | y] just filling and just crossing its 16 x 16 tiles), and with
    TOAs past shared memory (n = 2000 at m = 174: chunks of TOAs, the
    last one short). The constant is held to 1e-6 of the sum of its
    terms' sizes, |log nvec| + y^2 / nvec, and, past one TOA, to 1e-6 of
    itself: over a single TOA its two terms can cancel, so that no float32
    evaluation, the plain one included, meets a bound relative to the
    result."""
    dev = _cuda()
    rng = np.random.default_rng(131 + m)
    B = G_ * LANES_GROUP
    Tg = np.zeros((G_, nT, m), np.float32)
    Tg[:, :n] = rng.normal(size=(G_, n, m))
    yg = np.zeros((G_, nT), np.float32)
    yg[:, :n] = rng.normal(size=(G_, n))
    nvec = np.exp(rng.normal(0.0, 1.0, (B, n))).astype(np.float32)
    tt = torch.from_numpy
    if flat:
        ops = (tt(np.repeat(Tg, LANES_GROUP, 0)),
               tt(np.repeat(yg, LANES_GROUP, 0)), tt(nvec))
    else:
        ops = (tt(Tg)[:, None].expand(G_, LANES_GROUP, nT, m),
               tt(yg)[:, None].expand(G_, LANES_GROUP, nT),
               tt(nvec).reshape(G_, LANES_GROUP, n))
    gid = _gid_tiles(G_)
    n0 = ttnt.tnt_lanes.launches
    out = ttnt.tnt_lanes(*(t.to(dev) for t in ops), gid.to(dev))
    assert ttnt.tnt_lanes.launches == n0 + 1
    outp = ttnt.tnt_lanes(*ops, gid)
    T64, y64 = tt(Tg[:, :n]).double(), tt(yg[:, :n]).double()
    nv64 = tt(nvec).double().reshape(G_, LANES_GROUP, n)
    TNT64, d64, const64 = tnt_products(T64, y64[:, None], nv64)
    M, Md, _ = tnt_products(T64.abs(), y64.abs()[:, None], nv64)
    Mc = 0.5 * (nv64.log().abs() + y64[:, None] ** 2 / nv64).sum(-1)
    lead = 1 if flat else 2
    for o in (out, outp):
        TNT, d, const = (t.cpu().double().reshape(G_, LANES_GROUP,
                                                  *t.shape[lead:])
                         for t in o)
        assert (TNT - TNT64).abs().le(1e-4 * M).all()
        assert (d - d64).abs().le(1e-4 * Md).all()
        assert (const - const64).abs().le(1e-6 * Mc).all()
        if n > 1:
            torch.testing.assert_close(const, const64, rtol=1e-6, atol=0.0)
    assert torch.equal(out[0], out[0].transpose(-1, -2))


@pytest.mark.torch
@pytest.mark.parametrize("m, groups", [(74, (4, 32, 64)), (16, (4, 600))])
def test_tnt_lanes_forms_on_card(m, groups):
    """The lanes kernel at group counts that take each tiles-per-block
    launch (``lanes_form``): every group gives the same floats as when it
    is launched alone, so a tile's sums do not depend on the block it
    shares."""
    dev = _cuda()
    rng = np.random.default_rng(171 + m)
    n = 130
    assert len({ttnt.lanes_form(G_, m) for G_ in groups}) == len(groups)
    for G_ in groups:
        tt = torch.from_numpy
        T = tt(rng.normal(size=(G_, 1, n, m)).astype(np.float32)).to(dev)
        y = tt(rng.normal(size=(G_, 1, n)).astype(np.float32)).to(dev)
        nvec = tt(np.exp(rng.normal(0.0, 1.0, (G_, LANES_GROUP, n))).astype(
            np.float32)).to(dev)
        gid = _gid_tiles(G_).to(dev)
        out = ttnt.tnt_lanes(T.expand(-1, LANES_GROUP, -1, -1),
                             y.expand(-1, LANES_GROUP, -1), nvec, gid)
        for g in sorted({0, G_ // 2, G_ - 1}):
            alone = ttnt.tnt_lanes(
                T[g:g + 1].expand(-1, LANES_GROUP, -1, -1),
                y[g:g + 1].expand(-1, LANES_GROUP, -1), nvec[g:g + 1],
                gid[:LANES_GROUP])
            assert all(torch.equal(a[g:g + 1], b)
                       for a, b in zip(out, alone))


@pytest.mark.torch
@pytest.mark.parametrize("m", [1, 14, 31, 32, 33, 60, 64, 65, 160])
def test_tri_solve_T_kernel_on_card(m):
    """The back-solve at batches ragged against its four systems a block
    (and one of fewer systems than a block) against its plain version
    (rtol 1e-4 / atol 1e-5, as the factor): one register slot a lane at
    m <= 32, five at m = 160, 16-byte and 4-byte staging (m a multiple of
    4 or not). A NaN factor and one with a zero pivot share a block with
    good ones: their x is not finite, the others' x equals what they give
    alone."""
    dev = _cuda()
    rng = np.random.default_rng(181 + m)
    for B in (8 * 37 + 5 if m <= 64 else 37, 3):
        S = spd(rng, B, m, cond=30.0)
        r = torch.from_numpy(rng.normal(size=(B, m)).astype(
            np.float32)).to(dev)
        L = torch.from_numpy(np.linalg.cholesky(S.astype(np.float64)).astype(
            np.float32)).to(dev)
        bad = [1, 2]
        Lb = L.clone()
        Lb[1, m // 2, 0] = float("nan")
        Lb[2, m - 1, m - 1] = 0.0
        good = torch.ones(B, dtype=torch.bool, device=dev)
        good[bad] = False
        xp = chol.tri_solve_T_plain(L, r)
        n0 = chol.tri_solve_T.launches
        x = chol.tri_solve_T(Lb, r)
        assert chol.tri_solve_T.launches == n0 + 1
        torch.testing.assert_close(x[good], xp[good], rtol=1e-4, atol=1e-5)
        assert not torch.isfinite(x[bad]).all(-1).any()
        x_clean = chol.tri_solve_T(L, r)
        assert torch.equal(x[good], x_clean[good])
        for b in (0, B - 1):
            alone = chol.tri_solve_T(L[b:b + 1], r[b:b + 1])
            assert torch.equal(alone[0], x_clean[b])


@pytest.mark.torch
def test_white_mh_lanes_on_card():
    """The white block's lanes form: 4 groups of 16 lanes, each group's
    own model, against the grouped plain version; it is the grouped
    launch at 16 chains a group, so each group's lanes alone through the
    single-model launch give the same values bit for bit."""
    dev = _cuda()
    rng = np.random.default_rng(141)
    G_, S = 4, 20
    mas = group_models([130 - 10 * (g % 3) for g in range(G_)])
    ops, rows, specs, var = grouped_white_operands(rng, mas, LANES_GROUP, S)
    *ops, rows, specs = [t.to(dev) for t in (*ops, rows, specs)]
    flat = [t.reshape(-1, *t.shape[2:]) for t in ops]
    lanes_c = [t.repeat_interleave(LANES_GROUP, 0) for t in (rows, specs)]
    n0 = twhite.white_mh.launches_lanes
    xk, ak = twhite.white_mh_lanes(*flat, *lanes_c, _gid_tiles(G_).to(dev),
                                   var)
    assert twhite.white_mh.launches_lanes == n0 + 1
    xp, ap = twhite.white_mh_loop(*ops, rows, specs, var)
    nk = acc_counts(ak.cpu(), S)
    np.testing.assert_array_equal(nk, acc_counts(ap.reshape(-1).cpu(), S))
    assert 0 < nk.sum() < G_ * LANES_GROUP * S
    torch.testing.assert_close(xk, xp.reshape(xk.shape), rtol=1e-5,
                               atol=1e-6)
    xk, ak = xk.reshape(G_, LANES_GROUP, -1), ak.reshape(G_, LANES_GROUP)
    for g in range(G_):
        xs, as_ = twhite.white_mh(*(t[g] for t in ops), rows[g], specs[g],
                                  var)
        assert torch.equal(xs, xk[g]) and torch.equal(as_, ak[g])


@pytest.mark.torch
@pytest.mark.parametrize("components", [30, 7])
def test_hyper_mh_lanes_on_card(components):
    """The hyper block's lanes form: 3 groups of 16 lanes, each group's
    own model (v = 60 and 14), against the grouped plain version, and bit
    for bit each group's lanes through the single-model launch."""
    dev = _cuda()
    rng = np.random.default_rng(151 + components)
    mas = [make_demo_model_arrays(components=components, seed=60 + g)
           for g in range(3)]
    S = 10
    tt = torch.from_numpy
    per = []
    for ma in mas:
        ops, hc = hyper_operands(ma, rng, LANES_GROUP)
        consts = [tt(a) for a in (hc.K, hc.phi_sel, hc.specs)]
        dx = tt(jumps(rng, ma.hyper_indices, S, 3, True, 0.1,
                      C=LANES_GROUP))
        logu = separate_ties(
            lambda q, ops=ops, consts=consts, hc=hc: thyper.hyper_ll_lp(
                q, *(t.double() for t in ops[1:]),
                *(t.double() for t in consts), hc.hyp_idx, 1e-6),
            ops[0], dx, torch.log(tt(rng.random((LANES_GROUP, S)).astype(
                np.float32))))
        per.append((*ops, dx, logu, *consts))
    hyp_idx = hc.hyp_idx
    args = [torch.stack(f).to(dev) for f in zip(*per)]
    lanes = ([t.reshape(-1, *t.shape[2:]) for t in args[:7]]
             + [t.repeat_interleave(LANES_GROUP, 0) for t in args[7:]])
    n0 = thyper.hyper_mh.launches_lanes
    xk, ak = thyper.hyper_mh_lanes(*lanes, _gid_tiles(3).to(dev), hyp_idx,
                                   1e-6)
    assert thyper.hyper_mh.launches_lanes == n0 + 1
    xp, ap = thyper.hyper_mh_loop(*args, hyp_idx, 1e-6)
    nk = acc_counts(ak.cpu(), S).reshape(3, LANES_GROUP)
    np.testing.assert_array_equal(nk, acc_counts(ap.cpu(), S))
    assert (nk[:, 0] == 0).all()          # each group's indefinite chain
    assert 0 < nk.sum() < 3 * LANES_GROUP * S
    torch.testing.assert_close(xk, xp.reshape(xk.shape), rtol=1e-5,
                               atol=1e-6)
    xk, ak = xk.reshape(3, LANES_GROUP, -1), ak.reshape(3, LANES_GROUP)
    for g in range(3):
        xs, as_ = thyper.hyper_mh(*(t[g] for t in args), hyp_idx, 1e-6)
        assert torch.equal(xs, xk[g]) and torch.equal(as_, ak[g])


@pytest.mark.torch
@pytest.mark.parametrize("m", [14, 60])
def test_chol_lanes_on_card(m):
    """``chol_fused_lanes`` / ``tri_solve_T_lanes`` are the factor and
    back-solve kernels behind the gid contract: bit for bit the plain
    entries' launches, each counted on its own wrapper."""
    dev = _cuda()
    rng = np.random.default_rng(161 + m)
    B = 1024
    S = torch.from_numpy(spd(rng, B, m, cond=30.0)).to(dev)
    r = torch.from_numpy(rng.normal(size=(B, m)).astype(np.float32)).to(dev)
    gid = _gid_tiles(B // LANES_GROUP).to(dev)
    counts = (chol.chol_fused.launches, chol.tri_solve_T.launches,
              chol.chol_fused_lanes.launches, chol.tri_solve_T_lanes.launches)
    L, ld, u = chol.chol_fused_lanes(S, r, gid)
    x = chol.tri_solve_T_lanes(L, u, gid)
    assert (chol.chol_fused.launches, chol.tri_solve_T.launches,
            chol.chol_fused_lanes.launches,
            chol.tri_solve_T_lanes.launches) == (
        counts[0], counts[1], counts[2] + 1, counts[3] + 1)
    Lr, ldr, ur = chol.chol_fused(S, r)
    xr = chol.tri_solve_T(Lr, ur)
    for a, b in ((L, Lr), (ld, ldr), (u, ur), (x, xr)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="admission group"):
        chol.chol_fused_lanes(S[:24], r[:24], gid[:24])


# --- the sampling surface: the log-posterior's factor, the wire casts ---

def bits(a):
    """The raw bits of a host array or CPU tensor, for bitwise equality
    (bfloat16 has no numpy dtype, so tensors go through int16)."""
    if torch.is_tensor(a):
        if a.dtype in (torch.bfloat16, torch.float16):
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if str(a.dtype) in ("bfloat16", "float16") else a


def wire_state(rng, n):
    """A (3, 4)-batch record state of ``n`` TOAs: z 0/1, pout with exact
    uint8 half-steps (float32 v with v * 255 = k + 1/2), b and alpha
    spanning many decades, float16 and bfloat16 ties included."""
    shape = (3, 4, n)
    z = (rng.random(shape) < 0.4).astype(np.float32)
    cand = []
    for k in range(255):
        v = np.float32((k + 0.5) / 255.0)
        for u in (np.nextafter(v, np.float32(0)), v,
                  np.nextafter(v, np.float32(1))):
            if np.float32(u) * np.float32(255.0) == np.float32(k + 0.5):
                cand.append(u)
    cand = np.asarray(cand, np.float32)
    assert cand.size > 50          # the half-steps are really there
    pout = rng.random(shape).astype(np.float32)
    take = rng.random(shape) < 0.5
    pout[take] = rng.choice(cand, size=int(take.sum()))
    pout.flat[:2] = (0.0, 1.0)
    b = (rng.normal(size=shape) * 10.0 ** rng.uniform(-6, 3, shape)).astype(
        np.float32)
    # bfloat16 ties: 8 significant bits, then exactly half a step
    b.flat[:3] = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8)],
                          np.float32)
    alpha = (10.0 ** rng.uniform(-3, 6, shape)).astype(np.float32)
    return dict(x=rng.normal(size=(3, 4, 3)).astype(np.float32), b=b, z=z,
                theta=rng.random((3, 4)).astype(np.float32), alpha=alpha,
                df=rng.integers(1, 31, (3, 4)).astype(np.float32), pout=pout,
                acc_white=rng.random((3, 4)).astype(np.float32),
                acc_hyper=rng.random((3, 4)).astype(np.float32))


@pytest.mark.torch
@pytest.mark.parametrize("B", [1024, 1])
def test_chol_block_form_at_74_on_card(B):
    """The log-posterior's and ``lnlikelihood``'s factor shapes: the warp
    form they launch and the block form (``per_block=0``), each against
    the plain version."""
    dev = _cuda()
    assert chol.launch_form(B, 74)[0] == "warp"
    rng = np.random.default_rng(B)
    S = torch.from_numpy(spd(rng, B, 74, cond=30.0)).to(dev)
    r = torch.from_numpy(rng.normal(size=(B, 74)).astype(np.float32)).to(dev)
    plain = chol.chol_fused_plain(S, r)
    for per_block in (None, 0):
        n0 = chol.chol_fused.launches
        out = chol.chol_fused(S, r, per_block=per_block)
        torch.cuda.synchronize()
        assert chol.chol_fused.launches == n0 + 1
        for a, b in zip(out, plain):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        assert not torch.triu(out[0], 1).any()


@pytest.mark.torch
@pytest.mark.parametrize("m", [74, 95])
@pytest.mark.parametrize("per_block", [1, 2, 4, 8])
def test_chol_third_row_failures_on_card(m, per_block):
    """Three rows a lane: matrices that fail in a lane's third row (a
    negative pivot past column 64, a zero last pivot) or at the first
    pivot, among good ones sharing their block: a non-finite logdet for
    the failed ones alone (NaN for the negative pivots), the others equal
    to the plain version and bit for bit what they give without the
    failures."""
    dev = _cuda()
    rng = np.random.default_rng(7 * m + per_block)
    B = 37
    S = spd(rng, B, m, cond=30.0)
    clean = torch.from_numpy(S.copy()).to(dev)
    S[2] = -S[2]
    S[9, 70, 70] = -1.0
    S[9, 70, :70] = S[9, :70, 70] = 0.0
    S[20, m - 1, m - 1] = 0.0
    S[20, m - 1, :m - 1] = S[20, :m - 1, m - 1] = 0.0
    bad = [2, 9, 20]
    S = torch.from_numpy(S).to(dev)
    r = torch.from_numpy(rng.normal(size=(B, m)).astype(np.float32)).to(dev)
    out = chol.chol_fused(S, r, per_block=per_block)
    out_c = chol.chol_fused(clean, r, per_block=per_block)
    out_p = chol.chol_fused_plain(S, r)
    torch.cuda.synchronize()
    good = torch.ones(B, dtype=torch.bool, device=dev)
    good[bad] = False
    assert not torch.isfinite(out[1][~good]).any()
    assert not torch.isfinite(out_p[1][~good]).any()
    assert torch.isnan(out[1][[2, 9]]).all()
    for a, b, c in zip(out, out_p, out_c):
        assert torch.isfinite(a[good]).all()
        torch.testing.assert_close(a[good], b[good], rtol=1e-4, atol=1e-5)
        assert torch.equal(a[good], c[good])


@pytest.mark.torch
def test_record_casts_on_card_equal_cpu():
    dev = _cuda()
    st = wire_state(np.random.default_rng(9), 130)
    fields = tb._RECORD_FIELDS
    S = dataclasses.make_dataclass("S", fields)
    for casts in (tb._COMPACT_CASTS, tb._COMPACT8_CASTS):
        cpu = tb.record_tuple(S(**{f: torch.from_numpy(st[f])
                                   for f in fields}), fields, casts)
        card = tb.record_tuple(S(**{f: torch.from_numpy(st[f]).to(dev)
                                    for f in fields}), fields, casts)
        host = tb._HostCopy(card, torch.cuda.Stream(dev)).wait()
        for f, a, b in zip(fields, host, cpu):
            assert a.dtype == b.dtype and a.is_pinned(), f
            np.testing.assert_array_equal(bits(a), bits(b), err_msg=f)


def _f32_ulps(a, b):
    """Per-element distance in float32 ulps (same-sign finite values)."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    return (ia - ib).abs()


def _draw_case(case):
    """``(table, shapes (B, 4), expect_nan (B, 4))`` of a D1 card case:
    the shapes are the sampler's columns (theta's a and b, alpha's df / 2
    and (df + 1) / 2), ``expect_nan`` the shapes that must give NaN."""
    rs = np.random.default_rng(3)
    n, B = {"flagship": (130, 1027), "one_chain": (130, 1),
            "ragged": (3000, 37), "mixed_shapes": (130, 301),
            "edge_shapes": (130, 96), "stress_width": (102_400, 3)}[case]
    fields = [
        rng.DrawField("white_scale", rng.UNIFORM, (20,)),
        rng.DrawField("white_pick", rng.UNIFORM, (20,)),
        rng.DrawField("white_jump", rng.NORMAL, (20, 3)),
        rng.DrawField("white_logu", rng.LOG_UNIFORM, (20,)),
        rng.DrawField("white_gumbel", rng.GUMBEL, (20, 4)),
        rng.DrawField("g_theta", rng.GAMMA, (2,), col=0, per=1),
        rng.DrawField("g_alpha", rng.GAMMA, (2, n), col=2, per=n)]
    if case == "ragged":
        # a field of one value a chain; 3,000 gammas a column, no multiple
        # of any tile
        fields.insert(0, rng.DrawField("hyper_logu", rng.LOG_UNIFORM, (1,)))
    tab = rng.DrawTable(fields)
    df = rs.integers(1, 31, B).astype(np.float32)
    sh = np.stack([rs.uniform(0.3, 60, B), rs.uniform(0.3, 60, B), df / 2,
                   (df + 1) / 2], -1).astype(np.float32)
    if case == "mixed_shapes":
        # the shapes that reject most (a = 1; a = 0.5 boosted) beside
        # a >= 1, chain by chain, so every alpha tile mixes them
        sh[:, 2:] = np.array([0.5, 1.0, 1.5, 7.5, 15.5],
                             np.float32)[np.arange(2 * B).reshape(B, 2) % 5]
    if case == "edge_shapes":
        # whole tiles (8 chains of 130 values) of a = 1 and of a = 0.5,
        # then chains of bad and edge shapes among good ones
        sh[:16, 2:] = 1.0
        sh[16:32, 2:] = 0.5
        odd = np.array([0.0, np.nan, np.inf, -1.0, 1e-30, 3e38, 1e20, 1e30],
                       np.float32)
        sh[32::2, 0] = odd[np.arange(len(sh[32::2])) % 8]
        sh[33::2, 2] = odd[np.arange(len(sh[33::2])) % 8]
        sh[40::4, 3] = odd[np.arange(len(sh[40::4])) % 8]
    bad = ~((sh > 0) & np.isfinite(sh))
    return tab, torch.from_numpy(sh), torch.from_numpy(bad)


def _nan_equal(a, b):
    """Bit for bit, NaN where the other is NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(a[~na], b[~nb]))


@pytest.mark.torch
@pytest.mark.parametrize("case", ["flagship", "one_chain", "ragged",
                                  "mixed_shapes", "edge_shapes",
                                  "stress_width"])
@pytest.mark.parametrize("per_chain_sweep", [False, True])
def test_sweep_draws_kernel_on_card(per_chain_sweep, case):
    """D1 against its plain version: on the CPU (uniforms bit for bit,
    other values one float32 ulp apart on at most 1e-4 of them) and on
    the card (every value bit for bit: both take the card's libm), the
    same at every tile length, NaN exactly for the bad shapes, and each
    good chain's values as when it is drawn alone."""
    dev = _cuda()
    tab, shapes, bad = _draw_case(case)
    B = shapes.shape[0]
    keys = rng.chain_keys(17, range(B))
    rs = np.random.default_rng(5)
    sweep = (torch.from_numpy(rs.integers(0, 1000, B)) if per_chain_sweep
             else torch.tensor(41))
    cpu = tab.views(rng.sweep_draws(keys, sweep, shapes, tab), (B,))
    kd, sd, shd = keys.to(dev), sweep.to(dev), shapes.to(dev)
    n0 = rng.sweep_draws.launches
    out = rng.sweep_draws(kd, sd, shd, tab)
    torch.cuda.synchronize()
    assert rng.sweep_draws.launches == n0 + 1
    card = tab.views(out, (B,))
    plain = rng.sweep_draws_plain(kd, sd, shd, tab)
    assert _nan_equal(out, plain)
    for elems in ((1, 1), (3, 2), (32, 32)):
        assert _nan_equal(rng.sweep_draws(kd, sd, shd, tab, elems=elems),
                          out), elems
    # NaN exactly where a gamma's shape is bad
    expect = {"g_theta": bad[:, :2], "g_alpha": bad[:, 2:, None]}
    for f in tab.fields:
        a, b = card[f.name].cpu(), cpu[f.name]
        nan = expect.get(f.name, torch.zeros((), dtype=torch.bool))
        assert torch.equal(torch.isnan(a), nan.expand(a.shape)), f.name
        assert torch.equal(torch.isnan(b), torch.isnan(a)), f.name
        a, b = a[~torch.isnan(a)], b[~torch.isnan(b)]
        if f.kind == rng.UNIFORM:
            assert torch.equal(a, b), f.name
            continue
        ulps = _f32_ulps(a, b)
        assert int(ulps.max()) <= 1, f.name
        assert float((ulps > 0).double().mean()) <= 1e-4, f.name
    if case == "edge_shapes":
        # the good chains drawn alone: their values bit for bit
        good = torch.nonzero(~bad.any(-1)).reshape(-1)
        alone = tab.views(rng.sweep_draws(
            kd[good], sd[good] if per_chain_sweep else sd, shd[good], tab),
            (len(good),))
        for f in tab.fields:
            assert _nan_equal(card[f.name][good.to(dev)],
                              alone[f.name]), f.name
        # a boosted 1e-30 gives 0 (its boost underflows), 3e38 a finite
        # value
        g = card["g_alpha"].cpu()
        assert (g[shapes[:, 2:] == 1e-30] == 0).all()
        assert torch.isfinite(g[shapes[:, 2:] == 3e38]).all()


@pytest.mark.torch
def test_sampler_draws_on_card_equal_cpu():
    dev = _cuda()
    ma = make_demo_model_arrays()
    cfg = GibbsConfig(model="mixture", vary_df=True,
                      theta_prior="beta").with_adapt(10, adapt_cov=True)
    gpu = tb.TorchGibbs(ma, cfg, nchains=256, device=dev)
    cpu = tb.TorchGibbs(ma, cfg, nchains=256, device="cpu")
    st = cpu._prop_cov_update(cpu.init_state(seed=2))
    d_c = cpu._draw(cpu._chain_keys(2), torch.tensor(5), st)
    d_g = gpu._draw(gpu._chain_keys(2), torch.tensor(5, device=dev),
                    type(st)(*(t.to(dev) for t in st)))
    # the raw draws agree to a float32 ulp (the test above); the jumps go
    # through the card's and the CPU's 3-term products L @ xi
    for f, a, b in zip(d_c._fields, d_g, d_c):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6,
                                   msg=f)
