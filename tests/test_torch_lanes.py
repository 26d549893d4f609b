"""The port's serving lanes entries (CPU, plain versions) against their
JAX counterparts, on a two-group tile-uniform batch of 32 lanes.

The JAX side is taken as tests/test_pallas_lanes.py takes it: the native
CPU arms off (``GST_NCHOL``, ``GST_NWHITE``, ``GST_NHYPER``,
``GST_FUSE_STAGES`` = 0) and the Pallas arm forced in interpret mode
(``GST_PALLAS_*=interpret``):

- ``tnt_lanes`` against ``linalg.tnt_gram_lanes`` (its Pallas arm,
  ``pallas_tnt.tnt_lanes_pallas``, which pads the TOA axis itself), with
  the lanes flat and, as the pool passes them, tiled with one basis per
  group stored padded past the reduced TOAs;
- ``white_mh_lanes`` against ``pallas_white.make_white_block_lanes``
  under the serve vmap, each group with its own model's constants;
- ``hyper_mh_lanes`` against the Pallas core of
  ``linalg._fused_hyper_lanes_dispatcher``: ``pallas_hyper.hyper_mh_fused``
  at 16 chains a group on the constants of each tile's first lane;
- ``chol_fused_lanes`` and ``tri_solve_T_lanes`` against
  ``pallas_chol.chol_fused_lanes`` and ``tri_solve_T_lanes``;
- a broken ``gid`` contract (a gid of the wrong shape, a lane batch that
  is not a whole number of 16-lane groups) raises ``ValueError`` in every
  port entry and in the JAX chol entries, which check it.

Tolerances as in tests/test_pallas_lanes.py: rtol 2e-4 / atol 1e-4 on
float32 payloads, accept counts exact, on draws kept clear of every tie
(|delta - logu| > 1e-3, a float64 replay of the port's plain block).
Besides, the plain version of ``tnt_lanes`` (the ensemble's per-basis
dense product) equals the solo sampler's product of each group bit for
bit at the flagship shape, which the serving pin
(tests/test_torch_serve.py) rests on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.ops import pallas_chol as jchol
from gibbs_student_t_tpu.ops import pallas_hyper as jhyper
from gibbs_student_t_tpu.ops import pallas_tnt as jpt
from gibbs_student_t_tpu.ops import pallas_white as jwhite
from gibbs_student_t_tpu.ops.linalg import tnt_gram_lanes
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.ops import chol
from gibbs_student_t_tpu_torch.ops import hyper_mh as thyper
from gibbs_student_t_tpu_torch.ops import tnt as ttnt
from gibbs_student_t_tpu_torch.ops import white_mh as twhite
from gibbs_student_t_tpu_torch.ops.lanes import LANES_GROUP
from gibbs_student_t_tpu_torch.testing import separate_ties
from test_torch_kernels import acc_counts, hyper_operands, jumps, spd

# The suite runs in parallel workers and these tensors are small: one
# PyTorch CPU thread per worker costs nothing here and leaves the other
# cores to the other workers.
torch.set_num_threads(1)

B, G = 32, 2
RTOL, ATOL = 2e-4, 1e-4
tt = torch.from_numpy


@pytest.fixture
def native_off(monkeypatch):
    for k in ("GST_NCHOL", "GST_NWHITE", "GST_NHYPER", "GST_FUSE_STAGES"):
        monkeypatch.setenv(k, "0")
    return monkeypatch


def _gid(b=B):
    return np.repeat(np.arange(b // LANES_GROUP),
                     LANES_GROUP).astype(np.int32)


def _lanes(per_group):
    """A per-group array repeated over each group's 16 lanes."""
    return np.repeat(per_group, LANES_GROUP, axis=0)


def _tiled(per_group):
    """A per-group tensor as the pool passes it: a (G, 16, ...) view."""
    return per_group[:, None].expand(per_group.shape[0], LANES_GROUP,
                                     *per_group.shape[1:])


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def test_tnt_lanes_vs_jax(native_off):
    n, m, nT = 90, 10, 96
    rng = np.random.default_rng(0)
    Tg = rng.standard_normal((G, n, m)).astype(np.float32)
    yg = rng.standard_normal((G, n)).astype(np.float32)
    nvec = (10.0 ** rng.uniform(-1.5, 1.5, (B, n))).astype(np.float32)
    hits = []
    real = jpt.tnt_lanes_pallas

    def spy(*a, **kw):
        hits.append(kw.get("interpret"))
        return real(*a, **kw)

    native_off.setattr(jpt, "tnt_lanes_pallas", spy)
    native_off.setenv("GST_PALLAS_TNT", "interpret")
    ref = tnt_gram_lanes(jnp.asarray(_lanes(Tg)), jnp.asarray(_lanes(yg)),
                         jnp.asarray(nvec), jnp.asarray(_gid()))
    assert hits == [True]
    gid = tt(_gid())
    out = ttnt.tnt_lanes(tt(_lanes(Tg)), tt(_lanes(yg)), tt(nvec), gid)
    # the pool's layout: tiles, one basis per group padded to nT rows
    Tp = torch.zeros((G, nT, m))
    Tp[:, :n] = tt(Tg)
    yp = torch.zeros((G, nT))
    yp[:, :n] = tt(yg)
    out_t = ttnt.tnt_lanes(_tiled(Tp), _tiled(yp),
                           tt(nvec).reshape(G, LANES_GROUP, n), gid)
    for a, b, c in zip(out, out_t, ref):
        assert a.shape == c.shape
        assert b.shape == (G, LANES_GROUP, *c.shape[1:])
        _close(a, c)
        assert torch.equal(a, b.reshape(a.shape))
    assert ttnt.tnt_lanes.launches == 0


def test_tnt_lanes_plain_is_the_solo_product():
    """Each group's slice of the plain lanes reduction is the solo
    sampler's dense product on that group's basis, bit for bit."""
    mas = [make_demo_model_arrays(seed=s) for s in (0, 5)]
    rng = np.random.default_rng(1)
    n, m = mas[0].n, mas[0].m
    T = torch.stack([tt(ma.T.astype(np.float32)) for ma in mas])
    y = torch.stack([tt(ma.y.astype(np.float32)) for ma in mas])
    nvec = tt((10.0 ** rng.uniform(-1, 1, (B, n))).astype(np.float32))
    out = ttnt.tnt_lanes(_tiled(T), _tiled(y),
                         nvec.reshape(G, LANES_GROUP, n), tt(_gid()))
    assert out[0].shape == (G, LANES_GROUP, m, m)
    for g in range(G):
        solo = ttnt.tnt_products(
            T[g], y[g], nvec[g * LANES_GROUP:(g + 1) * LANES_GROUP])
        for a, b in zip(out, solo):
            assert torch.equal(a[g], b)


def test_white_mh_lanes_vs_jax(native_off):
    mas = [make_demo_model_arrays(seed=s) for s in (0, 5)]
    wcs = [twhite.build_white_consts(ma) for ma in mas]
    assert wcs[0].var == wcs[1].var
    var = wcs[0].var
    rng = np.random.default_rng(2)
    S, p, n = 20, mas[0].nparam, mas[0].n
    x = np.stack([mas[i // LANES_GROUP].x_init(rng)
                  for i in range(B)]).astype(np.float32)
    az = rng.uniform(0.5, 2.0, (B, n)).astype(np.float32)
    y2 = rng.uniform(0.0, 3.0, (B, n)).astype(np.float32)
    dx = jumps(rng, mas[0].white_indices, S, p, False, 0.05, C=B)
    rows = _lanes(np.stack([w.rows for w in wcs]))
    specs = _lanes(np.stack([w.specs for w in wcs]))
    logu = separate_ties(
        lambda q: twhite.white_ll_lp(q, tt(az).double(), tt(y2).double(),
                                     tt(rows).double(), var,
                                     tt(specs).double()),
        tt(x), tt(dx), torch.log(tt(rng.random((B, S)).astype(np.float32))))
    hits = []
    real = jwhite.white_mh_fused

    def spy(*a, **kw):
        hits.append(kw.get("interpret"))
        return real(*a, **kw)

    native_off.setattr(jwhite, "white_mh_fused", spy)
    native_off.setenv("GST_PALLAS_WHITE", "interpret")
    block = jwhite.make_white_block_lanes(var)
    xj, aj = jax.vmap(block)(*(jnp.asarray(a) for a in (
        x, az, y2, dx, logu.numpy(), rows, specs, _gid())))
    assert hits == [True]
    ops = [tt(a) for a in (x, az, y2, dx)] + [logu]
    gid = tt(_gid())
    xt, at = twhite.white_mh_lanes(*ops, tt(rows), tt(specs), gid, var)
    # the pool's layout: tiles, the constants a broadcast of each group's
    xk, ak = twhite.white_mh_lanes(
        *(t.reshape(G, LANES_GROUP, *t.shape[1:]) for t in ops),
        _tiled(tt(np.stack([w.rows for w in wcs]))),
        _tiled(tt(np.stack([w.specs for w in wcs]))), gid, var)
    nt = acc_counts(at, S)
    np.testing.assert_array_equal(nt, acc_counts(aj, S))
    assert 0 < nt.sum() < B * S
    _close(xt, xj)
    assert torch.equal(xk.reshape(xt.shape), xt)
    assert torch.equal(ak.reshape(at.shape), at)
    assert twhite.white_mh.launches_lanes == 0


def test_hyper_mh_lanes_vs_jax():
    mas = [make_demo_model_arrays(components=7, seed=s) for s in (0, 5)]
    rng = np.random.default_rng(3)
    parts = [hyper_operands(ma, rng, C=LANES_GROUP) for ma in mas]
    hcs = [hc for _, hc in parts]
    assert hcs[0].hyp_idx == hcs[1].hyp_idx
    ops = [torch.cat(ts) for ts in zip(*(o for o, _ in parts))]
    v = ops[1].shape[-1]
    assert v == 14
    S, p = 10, mas[0].nparam
    dx = tt(jumps(rng, mas[0].hyper_indices, S, p, True, 0.1, C=B))
    consts = [tt(_lanes(np.stack([getattr(hc, f) for hc in hcs])))
              for f in ("K", "phi_sel", "specs")]
    hyp_idx = hcs[0].hyp_idx
    logu = separate_ties(
        lambda q: thyper.hyper_ll_lp(
            q, *(t.double() for t in ops[1:]),
            *(t.double() for t in consts), hyp_idx, 1e-6),
        ops[0], dx, torch.log(tt(rng.random((B, S)).astype(np.float32))))
    xt, at = thyper.hyper_mh_lanes(*ops, dx, logu, *consts, tt(_gid()),
                                   hyp_idx, 1e-6)

    def tiles(t):
        return jnp.asarray(t.numpy().reshape(G, LANES_GROUP, *t.shape[1:]))

    xj, aj = jhyper.hyper_mh_fused(
        *(tiles(t) for t in (*ops, dx, logu)),
        *(jnp.asarray(c.numpy()[::LANES_GROUP]) for c in consts),
        hyp_idx, 1e-6, interpret=True)
    nt = acc_counts(at, S)
    np.testing.assert_array_equal(nt, acc_counts(np.asarray(aj).reshape(B),
                                                 S))
    assert nt[0] == nt[LANES_GROUP] == 0        # indefinite chains reject
    assert 0 < nt.sum() < B * S
    _close(xt, np.asarray(xj).reshape(B, p))
    assert thyper.hyper_mh.launches_lanes == 0


def test_chol_lanes_vs_jax(native_off):
    rng = np.random.default_rng(4)
    m = 12
    S = spd(rng, B, m, cond=30.0)
    rhs = rng.standard_normal((B, m)).astype(np.float32)
    native_off.setenv("GST_PALLAS_CHOL", "interpret")
    gj = jnp.asarray(_gid())
    Lj, ldj, uj = jchol.chol_fused_lanes(jnp.asarray(S), jnp.asarray(rhs),
                                         gj)
    bj = jchol.tri_solve_T_lanes(Lj, uj, gj)
    gid = tt(_gid())
    L, ld, u = chol.chol_fused_lanes(tt(S), tt(rhs), gid)
    b = chol.tri_solve_T_lanes(L, u, gid)
    for a, c in ((L, Lj), (ld, ldj), (u, uj), (b, bj)):
        _close(a, c)
    assert chol.chol_fused_lanes.launches == 0
    assert chol.tri_solve_T_lanes.launches == 0


def _port_entries():
    """Each port lanes entry as ``call(lanes, gid)`` on valid operands of
    ``lanes`` lanes."""
    ma = make_demo_model_arrays(components=5)
    wc = twhite.build_white_consts(ma)
    p, n, m = ma.nparam, 24, 6
    z = torch.zeros

    def per_lane(t, b):
        return tt(t)[None].expand(b, *t.shape)

    return {
        "chol_fused_lanes": lambda b, g: chol.chol_fused_lanes(
            torch.eye(m).expand(b, m, m), z(b, m), g),
        "tri_solve_T_lanes": lambda b, g: chol.tri_solve_T_lanes(
            torch.eye(m).expand(b, m, m), z(b, m), g),
        "tnt_lanes": lambda b, g: ttnt.tnt_lanes(
            z(b, n, m), z(b, n), torch.ones(b, n), g),
        "white_mh_lanes": lambda b, g: twhite.white_mh_lanes(
            z(b, p), torch.ones(b, ma.n), z(b, ma.n), z(b, 2, p), z(b, 2),
            per_lane(wc.rows, b), per_lane(wc.specs, b), g, wc.var),
        "hyper_mh_lanes": lambda b, g: thyper.hyper_mh_lanes(
            z(b, p), torch.eye(m).expand(b, m, m), torch.ones(b, m),
            z(b, m), z(b), z(b, 2, p), z(b, 2), z(b, 2, m), z(b, m),
            z(b, 3, p), g, (1,), 1e-6),
    }


@pytest.mark.parametrize("entry", ["chol_fused_lanes", "tri_solve_T_lanes",
                                   "tnt_lanes", "white_mh_lanes",
                                   "hyper_mh_lanes"])
def test_gid_contract_raises(entry):
    call = _port_entries()[entry]
    call(B, tt(_gid()))
    with pytest.raises(ValueError, match="gid must be"):
        call(B, torch.zeros((B, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="admission group"):
        call(24, torch.zeros(24, dtype=torch.int32))
    if entry.startswith(("chol", "tri")):
        fn = getattr(jchol, entry)
        S = jnp.broadcast_to(jnp.eye(8, dtype=jnp.float32) * 2.0, (B, 8, 8))
        r = jnp.ones((B, 8), jnp.float32)
        with pytest.raises(ValueError, match="gid must be"):
            fn(S, r, jnp.zeros((B, 2), jnp.int32))
        with pytest.raises(ValueError, match="admission group"):
            fn(S[:24], r[:24], jnp.zeros(24, jnp.int32))
