"""The port's counter-based draws (``gibbs_student_t_tpu_torch/ops/rng.py``)
on the CPU, against the JAX package and in law.

- the ported Philox pieces against ``gibbs_student_t_tpu.ops.rng`` on
  numpy-seeded keys and counters: ``philox_4x32``'s four words,
  ``uniform_of_bits`` and ``philox_uniform_pool`` bit for bit, over shapes
  and tags; ``gamma_halfint_v2`` bit for bit in the uniforms it consumes
  and to 1e-6 relative in value (XLA's CPU ``logf`` rounds otherwise
  than PyTorch's on ~14 % of float32 inputs, measured on 1e6 uniforms, so
  a value summed from float32 logs cannot match bitwise);
- in law: the Marsaglia-Tsang gamma (``gamma_mt``) at shapes 0.5, 1, 1.5,
  15.5 and 65 (20,000 draws each), the Box-Muller normals, the Gumbel
  noise and the uniforms, each by a KS test at significance 1e-3 (seeded,
  so each reading is fixed);
- per-chain keying: a chain's raw draws (``sweep_draws_plain``) are the
  same in a batch of 16, alone, and with the batch permuted; a sweep index
  given once equals the same index given per chain; different sweeps,
  tags and chains differ;
- the mirror of the JAX package's ``test_vmap_consistency``: chain 3 of a
  16-chain ``TorchGibbs`` (adapt_cov off) draws exactly what a 1-chain
  sampler keyed as chain 3 draws, and one sweep from the same state gives
  the same state to float32 roundoff; the ensemble keys pulsar p's chain
  c as chain ``p * C + c``;
- a serving-pool tenant admitted behind a neighbour of 16 or of 32 chains
  equals ``TorchGibbs.sample`` at the same seed, every field bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from gibbs_student_t_tpu.ops import rng as jrng
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.ops import rng
from gibbs_student_t_tpu_torch.parallel import EnsembleGibbs
from gibbs_student_t_tpu_torch.serve import ChainServer, TenantRequest

torch.set_num_threads(1)

TAGS = [int(jrng.TAG_GAMMA), int(jrng.TAG_BETA_A), int(jrng.TAG_BETA_B),
        0x73770023]
SHAPES = [(1,), (37,), (4, 9)]
KS_ALPHA = 1e-3


def _words(rs, shape):
    return rs.integers(0, 2 ** 32, size=shape, dtype=np.uint64)


# --- the JAX package's pieces, bit for bit -----------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tag", TAGS)
def test_philox_bitwise_jax(shape, tag):
    rs = np.random.default_rng(len(shape) * 7 + tag % 97)
    k = _words(rs, (2,))
    c0, c1, c3 = (_words(rs, shape) for _ in range(3))
    wj = jrng.philox_4x32(np.uint32(k[0]), np.uint32(k[1]),
                          c0.astype(np.uint32), c1.astype(np.uint32),
                          np.full(shape, tag, np.uint32),
                          c3.astype(np.uint32))
    wt = rng.philox_4x32(int(k[0]), int(k[1]),
                         *(torch.from_numpy(c.astype(np.int64))
                           for c in (c0, c1)), tag,
                         torch.from_numpy(c3.astype(np.int64)))
    for a, b in zip(wj, wt):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())


@pytest.mark.parametrize("shape", SHAPES + [(1000,)])
def test_uniform_of_bits_bitwise_jax(shape):
    rs = np.random.default_rng(sum(shape))
    bits = _words(rs, shape)
    bits.reshape(-1)[0] = 0                  # the ends of the grid
    bits.reshape(-1)[-1] = 2 ** 32 - 1
    uj = np.asarray(jrng.uniform_of_bits(bits.astype(np.uint32),
                                         np.float32))
    ut = rng.uniform_of_bits(torch.from_numpy(bits.astype(np.int64)))
    assert ut.dtype == torch.float32
    np.testing.assert_array_equal(uj, ut.numpy())
    assert (ut > 0).all() and (ut < 1).all()


@pytest.mark.parametrize("rows,width", [(1, 1), (7, 13), (30, 4), (5, 37)])
@pytest.mark.parametrize("tag", TAGS)
def test_philox_uniform_pool_bitwise_jax(rows, width, tag):
    k = _words(np.random.default_rng(rows * width), (2,))
    uj = np.asarray(jrng.philox_uniform_pool(
        jnp.asarray(k.astype(np.uint32)), rows, width, np.uint32(tag),
        np.float32))
    ut = rng.philox_uniform_pool(torch.from_numpy(k.astype(np.int64)),
                                 rows, width, tag)
    assert ut.shape == (rows, width)
    np.testing.assert_array_equal(uj, ut.numpy())


@pytest.mark.parametrize("n,jmax", [(1, 4), (50, 20), (64, 33)])
def test_gamma_halfint_v2_matches_jax(n, jmax):
    rs = np.random.default_rng(n + jmax)
    k = _words(rs, (2,))
    counts = rs.integers(0, 2 * jmax + 6, size=n).astype(np.float32)
    gj = np.asarray(jrng.gamma_halfint_v2(jnp.asarray(k.astype(np.uint32)),
                                          jnp.asarray(counts), jmax))
    gt = rng.gamma_halfint_v2(torch.from_numpy(k.astype(np.int64)),
                              torch.from_numpy(counts), jmax).numpy()
    # the uniforms it consumes are bitwise (test above); the values to
    # 1e-6 relative: each is a sum of up to jmax / 4 + 1 float32 logs,
    # each of which the two CPU libraries may round a float32 ulp apart
    # (the module docstring)
    np.testing.assert_allclose(gt, gj, rtol=1e-6, atol=0.0)
    assert (gt[counts == 0] == 0).all() and (gt[counts > 0] > 0).all()


# --- the sweep's primitives in law -------------------------------------------

def _keys_sweep(B, seed=5, sweep=9):
    return rng.chain_keys(seed, range(B)), torch.full((B,), sweep)


@pytest.mark.parametrize("a", [0.5, 1.0, 1.5, 15.5, 65.0])
def test_gamma_mt_in_law(a):
    keys, sweep = _keys_sweep(4)
    g = rng.gamma_mt(keys, sweep, rng.SWEEP_TAGS["g_alpha"],
                     torch.full((4, 5000), a))
    assert g.dtype == torch.float32 and torch.isfinite(g).all()
    assert (g > 0).all()
    p = stats.kstest(g.numpy().ravel(), stats.gamma(a).cdf).pvalue
    assert p > KS_ALPHA, (a, p)


def test_gamma_mt_refuses_bad_shapes():
    keys, sweep = _keys_sweep(1)
    g = rng.gamma_mt(keys, sweep, 7, torch.tensor(
        [[0.0, -1.0, float("nan"), float("inf"), 2.0]]))
    assert torch.isnan(g[0, :4]).all() and g[0, 4] > 0


def test_normals_gumbel_uniforms_in_law():
    keys, sweep = _keys_sweep(4)
    n = 5000
    for draw, law in ((rng.normals, stats.norm.cdf),
                      (rng.gumbel, stats.gumbel_r.cdf),
                      (rng.uniforms, stats.uniform.cdf)):
        v = draw(keys, sweep, 11, n)
        assert v.shape == (4, n) and v.dtype == torch.float32
        assert stats.kstest(v.numpy().ravel(), law).pvalue > KS_ALPHA, draw
    u = rng.uniforms(keys, sweep, 11, n)
    assert torch.equal(rng.log_uniforms(keys, sweep, 11, n),
                       torch.log(u.double()).float())


# --- per-chain keying --------------------------------------------------------

def _table(n=9):
    return rng.DrawTable([
        rng.DrawField("white_scale", rng.UNIFORM, (5,)),
        rng.DrawField("white_jump", rng.NORMAL, (5, 3)),
        rng.DrawField("white_logu", rng.LOG_UNIFORM, (5,)),
        rng.DrawField("white_gumbel", rng.GUMBEL, (2, 4)),
        rng.DrawField("g_theta", rng.GAMMA, (2,), col=0, per=1),
        rng.DrawField("g_alpha", rng.GAMMA, (2, n), col=2, per=n)])


def _shapes(B, seed=0):
    rs = np.random.default_rng(seed)
    df = rs.integers(1, 31, B).astype(np.float32)
    return torch.from_numpy(np.stack([rs.uniform(0.5, 40, B),
                                      rs.uniform(0.5, 40, B), df / 2,
                                      (df + 1) / 2], -1).astype(np.float32))


def test_chain_draws_depend_only_on_seed_chain_sweep():
    tab = _table()
    keys = rng.chain_keys(7, range(16))
    sh = _shapes(16)
    sweep = torch.tensor(12)
    full = tab.views(rng.sweep_draws_plain(keys, sweep, sh, tab), (16,))
    alone = tab.views(rng.sweep_draws_plain(keys[3:4], sweep, sh[3:4], tab),
                      (1,))
    perm = torch.from_numpy(np.random.default_rng(1).permutation(16))
    shuf = tab.views(rng.sweep_draws_plain(keys[perm], sweep, sh[perm], tab),
                     (16,))
    per_chain = tab.views(rng.sweep_draws_plain(
        keys, torch.full((16,), 12), sh, tab), (16,))
    where = int(torch.nonzero(perm == 3)[0, 0])
    for f in full:
        assert torch.equal(full[f][3], alone[f][0]), f
        assert torch.equal(full[f][3], shuf[f][where]), f
        assert torch.equal(full[f], per_chain[f]), f
        assert torch.isfinite(full[f]).all(), f
    other = tab.views(rng.sweep_draws_plain(keys, torch.tensor(13), sh, tab),
                      (16,))
    for f in full:
        assert not torch.equal(full[f], other[f]), f
        assert not torch.equal(full[f][0], full[f][1]), f
    # the alpha gammas of TOA j do not depend on the TOA padding
    wide = _table(n=12)
    padded = wide.views(rng.sweep_draws_plain(keys, sweep, sh, wide), (16,))
    assert torch.equal(padded["g_alpha"][:, :, :9], full["g_alpha"])
    assert torch.equal(padded["white_jump"], full["white_jump"])


def test_sweep_draws_refuses_bad_operands():
    tab = _table()
    keys, sh = rng.chain_keys(0, range(4)), _shapes(4)
    with pytest.raises(ValueError, match="keys"):
        rng.sweep_draws(keys.int(), torch.tensor(0), sh, tab)
    with pytest.raises(ValueError, match="sweep"):
        rng.sweep_draws(keys, torch.zeros(3, dtype=torch.int64), sh, tab)
    with pytest.raises(ValueError, match="shapes"):
        rng.sweep_draws(keys, torch.tensor(0), sh.half(), tab)
    with pytest.raises(RuntimeError, match="no kernel"):
        rng.sweep_draws(keys.to("meta"), torch.tensor(0, device="meta"),
                        sh.to("meta"), tab)


@pytest.fixture(scope="module")
def demo():
    return make_demo_model_arrays(components=5)


def test_chain_subset_draws_and_sweeps_like_its_batch(demo):
    """The port's mirror of tests/test_jax_backend.py::
    test_vmap_consistency."""
    cfg = GibbsConfig(model="mixture", vary_df=True, theta_prior="beta")
    s16 = TorchGibbs(demo, cfg, nchains=16, device="cpu")
    s1 = TorchGibbs(demo, cfg, nchains=1, device="cpu")
    k = 3
    st = s16.init_state(seed=11)
    keys = s16._chain_keys(11)
    assert torch.equal(keys[k:k + 1], rng.chain_keys(11, [k]))
    for i in range(3):                  # a state a few sweeps in
        st = s16._sweep(st, s16._draw(keys, torch.tensor(i), st), sweep=i)
    sub = type(st)(*(t[k:k + 1] for t in st))
    d16 = s16._draw(keys, torch.tensor(3), st)
    d1 = s1._draw(rng.chain_keys(11, [k]), torch.tensor(3), sub)
    for f, a, b in zip(d16._fields, d16, d1):
        assert torch.equal(a[k:k + 1], b), f
    o16 = s16._sweep(st, d16, sweep=3)
    o1 = s1._sweep(sub, d1, sweep=3)
    # float32 roundoff: the batched factorizations and products of 16
    # chains and of one round differently; b, a draw with components near
    # zero, is held to 1e-4 of its largest component
    for f in ("x", "b", "alpha", "theta", "pout"):
        a = getattr(o1, f)
        torch.testing.assert_close(getattr(o16, f)[k:k + 1], a, rtol=1e-4,
                                   atol=1e-4 * float(a.abs().max()))
    for f in ("z", "df", "acc_white", "acc_hyper"):
        assert torch.equal(getattr(o16, f)[k:k + 1], getattr(o1, f)), f


def test_ensemble_keys_are_pulsar_major(demo):
    e = EnsembleGibbs([demo, make_demo_model_arrays(components=5, seed=9)],
                      GibbsConfig(model="mixture"), nchains=4, device="cpu")
    keys = e._chain_keys(6)
    assert keys.shape == (2, 4, 2)
    for p in range(2):
        for c in range(4):
            assert tuple(keys[p, c].tolist()) == rng.chain_key(6, p * 4 + c)


@pytest.mark.parametrize("neighbour", [16, 32])
def test_pool_tenant_behind_a_neighbour_equals_torch_gibbs(demo, neighbour):
    cfg = GibbsConfig(model="mixture")
    srv = ChainServer(demo, cfg, nlanes=64, quantum=5, record="full",
                      device="cpu")
    srv.submit(TenantRequest(ma=make_demo_model_arrays(components=5,
                                                       seed=8),
                             niter=10, nchains=neighbour, seed=21))
    h = srv.submit(TenantRequest(ma=demo, niter=10, nchains=16, seed=2))
    srv.run()
    rv = h.result()
    smp = TorchGibbs(demo, cfg, nchains=16, device="cpu", chunk_size=5,
                     tnt_block_size=None, record="full")
    rs = smp.sample(niter=10, seed=2)
    for f in ("chain", "zchain", "thetachain", "dfchain", "bchain",
              "alphachain", "poutchain"):
        np.testing.assert_array_equal(getattr(rv, f), getattr(rs, f),
                                      err_msg=f)
    for k in ("acc_white", "acc_hyper"):
        np.testing.assert_array_equal(rv.stats[k], rs.stats[k], err_msg=k)


# --- D1's launch geometry: segments, tiles and the magic division ------------

def _path_table(path):
    """The draw table of a chip path's sampler: the flagship (covariance
    proposals), full MTM (K = 4 on both blocks), the stress path's
    coordinate picks at its 102,400 padded TOAs, the serving pool's
    ``mixture`` config. The tables are ``TorchGibbs._draw_table`` of the
    demo model's sampler with only the TOA count changed, so they match
    X."""
    import types

    from gibbs_student_t_tpu_torch.backends import torch_backend as tb

    base = GibbsConfig(model="mixture", vary_df=True, theta_prior="beta")
    cfg = {"flagship": base.with_adapt(100, adapt_cov=True),
           "mtm": base.with_adapt(100, adapt_cov=True).with_mtm(4),
           "stress": base, "pool": GibbsConfig(model="mixture")}[path]
    smp = TorchGibbs(make_demo_model_arrays(components=30), cfg, nchains=1,
                     device="cpu")
    ns = types.SimpleNamespace(config=smp.config, _mtm=smp._mtm,
                               _ma=smp._ma,
                               _n=102_400 if path == "stress" else smp._n)
    return tb.TorchGibbs._draw_table(ns)


def _div(p, n):
    magic, shift = rng.div_magic(n)
    return (np.asarray(p, np.uint64) * np.uint64(magic)) >> np.uint64(shift)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 20, 30, 60, 74, 130, 131, 256,
                               1000, 2049, 102_400, 204_800, 3 ** 19,
                               2 ** 30, 2 ** 31 - 1])
def test_div_magic_divides_every_tile_index(n):
    # every index a tile can reach (p < n + the longest tile) where that is
    # few, else both ends of that range, 2**31 - 1 and a million random p
    rs = np.random.default_rng(n % 1000)
    top = min(n + rng.DRAW_MAX_TILE, 2 ** 31)
    if top <= 1 << 22:
        p = np.arange(top, dtype=np.uint64)
    else:
        p = np.concatenate([np.arange(1 << 16), np.arange(top - (1 << 16),
                                                          top),
                            [2 ** 31 - 1],
                            rs.integers(0, 2 ** 31, 1 << 20)]).astype(
                                np.uint64)
    magic, _ = rng.div_magic(n)
    assert 0 < magic < 2 ** 32
    np.testing.assert_array_equal(_div(p, n), p // np.uint64(n))


@pytest.mark.parametrize("B", [1, 7, 1024])
@pytest.mark.parametrize("path", ["flagship", "stress", "mtm", "pool"])
def test_tiles_cover_every_value_once(path, B):
    """Every (field, chain, element) of the table lies in exactly one tile,
    at the default geometry and two others; a tile spans at most the
    kernel's chains and values. Where the table is small enough, the
    kernel's index arithmetic is replayed on every value: tile value j
    lands where the plain version writes chain b's element e, at the
    counters (e, tag + shape column) of the layout."""
    tab = _path_table(path)
    assert tab.width == {"flagship": 646, "mtm": 1486, "stress": 307_426,
                         "pool": 616}[path]
    # the segments split each field into its shape columns, in order
    for f, o in zip(tab.fields, tab.offsets):
        segs = [s for s in tab.segments if s[4] == o]
        cols = f.count // f.per if f.kind == rng.GAMMA else 1
        assert [s[5] for s in segs] == [c * (f.count // cols)
                                        for c in range(cols)]
        assert all(s[0] == f.kind and s[3] == f.count
                   and s[1] == rng.SWEEP_TAGS[f.name] + c
                   and s[6] == f.col + c for c, s in enumerate(segs))
    default = (rng.DRAW_THREADS, rng.DRAW_MAX_CHAINS,
               rng.draw_elems(B * tab.gammas, rng.DRAW_THREADS, 132))
    for threads, max_chains, elems in (default, (128, 256, (1, 1)),
                                       (256, 64, (32, 32))):
        tiles, longest = tab.tiles(B, threads, max_chains, elems)
        assert tiles.dtype == np.int32 and tiles.shape[1] == 4
        seg, b0, e0, ln = (tiles[:, i].astype(np.int64) for i in range(4))
        n = np.array([s[2] for s in tab.segments])[seg]
        gamma = np.array([s[0] == rng.GAMMA for s in tab.segments])[seg]
        L = threads * np.where(gamma, elems[1], elems[0])
        assert (ln >= 1).all() and (ln <= L).all()
        assert longest == int(ln.max())
        assert ((e0 >= 0) & (e0 < n) & (b0 >= 0) & (b0 < B)).all()
        assert ((e0 + ln - 1) // n + 1 <= max_chains).all()
        # exact cover: each segment's tiles are consecutive runs of its
        # B * n values, in order, from 0 to the end
        start = b0 * n + e0
        for s, row in enumerate(tab.segments):
            mine = seg == s
            st, l_ = start[mine], ln[mine]
            assert st[0] == 0 and (st[1:] == st[:-1] + l_[:-1]).all()
            assert st[-1] + l_[-1] == B * row[2]
        if B * tab.width > 1 << 21:
            continue
        # the kernel's arithmetic on every value of every tile
        rep = np.repeat(np.arange(len(tiles)), ln)
        j = np.arange(len(rep)) - np.repeat(np.cumsum(ln) - ln, ln)
        p = e0[rep] + j
        rows = np.array(tab.segments, np.int64)[seg[rep]]
        magic, shift = rows[:, 7].astype(np.uint64), rows[:, 8].astype(
            np.uint64)
        lc = ((p.astype(np.uint64) * magic) >> shift).astype(np.int64)
        e = p - lc * rows[:, 2]
        chain = b0[rep] + lc
        at = B * rows[:, 4] + rows[:, 5] + chain * rows[:, 3] + e
        assert ((e >= 0) & (e < rows[:, 2]) & (chain < B)).all()
        np.testing.assert_array_equal(np.sort(at), np.arange(B * tab.width))
        # the plain layout at each of those places: field f's (B, count)
        # block, a gamma field's element k in column k // per
        for f, o in zip(tab.fields, tab.offsets):
            mine = (at >= B * o) & (at < B * (o + f.count))
            k = at[mine] - B * o
            per = f.per if f.kind == rng.GAMMA else f.count
            np.testing.assert_array_equal(chain[mine], k // f.count)
            np.testing.assert_array_equal(e[mine], k % f.count % per)
            np.testing.assert_array_equal(
                rows[mine, 1], rng.SWEEP_TAGS[f.name] + k % f.count // per)


def test_tiles_refuse_an_index_past_31_bits():
    tab = rng.DrawTable([rng.DrawField("u_z", rng.UNIFORM, (2 ** 31 - 100,))])
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tab.tiles(1, rng.DRAW_THREADS, rng.DRAW_MAX_CHAINS, (8, 4))


@pytest.mark.parametrize("path, B, want", [
    ("flagship", 1024, 4), ("pool", 1024, 4), ("stress", 64, 16),
    ("flagship", 8192, 16), ("flagship", 1, 1), ("flagship", 64, 1)])
def test_draw_elems_leaves_two_gamma_tiles_an_sm(path, B, want):
    tab = _path_table(path)
    other, gamma = rng.draw_elems(B * tab.gammas, rng.DRAW_THREADS, 132)
    assert (other, gamma) == (8, want)
    tiles, _ = tab.tiles(B, rng.DRAW_THREADS, rng.DRAW_MAX_CHAINS,
                         (other, gamma))
    segs = np.array([s[0] == rng.GAMMA for s in tab.segments])
    assert gamma == 1 or int(segs[tiles[:, 0]].sum()) >= 2 * 132
    # gammas / (threads x gamma) lies in [2, 4) tiles an SM unless clamped
    per_sm = B * tab.gammas / (rng.DRAW_THREADS * gamma * 132)
    assert gamma == 1 or per_sm >= 2
    assert gamma == 16 or per_sm < 4
