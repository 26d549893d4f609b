"""The port's TOA-blocked TNT reduction and the sampler's stress-path
options, against the JAX package (CPU).

- ``ops.tnt.tnt_batched`` (on the CPU its plain version, the blocked
  ``tnt_products``) against the Pallas TNT kernel
  ``pallas_tnt.tnt_batched_pallas`` in interpret mode and its XLA oracle
  ``tnt_batched_xla``, at 3 chains, n = 256, m = 12, blocks of 128, inputs
  from a numpy seed: TNT and d within 1e-5 of the same sums taken over
  absolute values (M = |T|^T w |T|; float32 sums in other orders),
  the constant to 1e-6 relative;
- the padded-rows contract: rows with T = 0, y = 0 and nvec = 1 change
  TNT, d and the constant by no more than float32 reassociation (1e-6 of
  M), and the port pads exactly as the JAX package;
- the lanes kernel's tile table: ``lanes_tiles(m)`` covers each pair of
  the lower triangle of the Gram of ``[T | y]`` exactly once, its store
  rule writes every TNT and d entry exactly once, and gives
  ``tnt_products``' values from the plain Gram; ``lanes_form``;
- the Gram kernel's pair map: ``pair_index(m)`` covers each ``(i, j)``,
  ``i >= j``, of the ``(m + 1) x (m + 1)`` Gram of ``[T | y]`` exactly
  once, in the order ``q = i (i + 1) / 2 + j``, padded with ``(m, m)``
  only; the plain Gram gathered through the table and unpacked the way
  the kernel's finishing pass unpacks it gives ``tnt_products``' TNT (its
  lower triangle, mirrored) and d bit for bit;
- ``TorchGibbs(tnt_block_size=128)`` on the demo model (130 TOAs padded to
  256): one sweep equals the dense sweep fed the same state and draws, at
  1e-4 relative on x and b with equal accept counts, and
  ``record="light"`` records the light fields only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.ops import pallas_tnt as jtnt
from gibbs_student_t_tpu.ops.tnt import pad_rows as jpad_rows
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.ops import rng
from gibbs_student_t_tpu_torch.ops import tnt as ttnt

torch.set_num_threads(1)


def _inputs(seed, C=3, n=256, m=12):
    rng = np.random.default_rng(seed)
    T = rng.normal(size=(n, m)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    nvec = np.exp(rng.normal(0.0, 1.0, (C, n))).astype(np.float32)
    return T, y, nvec


def _scale(T, y, nvec):
    """(M, Md): TNT and d summed over absolute values, float64."""
    M, Md, _ = ttnt.tnt_products(*(torch.from_numpy(np.abs(a)).double()
                                   for a in (T, y, nvec)))
    return M.numpy(), Md.numpy()


def test_tnt_batched_vs_pallas_and_xla():
    T, y, nvec = _inputs(5)
    tt = torch.from_numpy
    TNT, d, const = ttnt.tnt_batched(tt(T), tt(y), tt(nvec), 128)
    assert ttnt.tnt_batched.launches == 0
    M, Md = _scale(T, y, nvec)
    refs = [jtnt.tnt_batched_pallas(jnp.asarray(T), jnp.asarray(y),
                                    jnp.asarray(nvec), block_size=128,
                                    interpret=True),
            jtnt.tnt_batched_xla(jnp.asarray(T), jnp.asarray(y),
                                 jnp.asarray(nvec), 128)]
    for rT, rd, rc in refs:
        assert (np.abs(TNT.numpy() - np.asarray(rT)) <= 1e-5 * M).all()
        assert (np.abs(d.numpy() - np.asarray(rd)) <= 1e-5 * Md).all()
        np.testing.assert_allclose(const.numpy(), np.asarray(rc), rtol=1e-6)


def test_padded_rows_add_nothing():
    T, y, nvec = _inputs(6, n=200)
    Tp, yp, n_pad = ttnt.pad_rows(T, y, 128)
    Tj, yj, nj = jpad_rows(T, y, 128)
    assert n_pad == nj == 56
    np.testing.assert_array_equal(Tp, Tj)
    np.testing.assert_array_equal(yp, yj)
    nvp = np.concatenate([nvec, np.ones((3, n_pad), np.float32)], 1)
    tt = torch.from_numpy
    padded = ttnt.tnt_batched(tt(Tp), tt(yp), tt(nvp), 128)
    dense = ttnt.tnt_products(tt(T), tt(y), tt(nvec))
    M, Md = _scale(T, y, nvec)
    assert (np.abs(padded[0].numpy() - dense[0].numpy()) <= 1e-6 * M).all()
    assert (np.abs(padded[1].numpy() - dense[1].numpy()) <= 1e-6 * Md).all()
    np.testing.assert_allclose(padded[2].numpy(), dense[2].numpy(),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        ttnt.tnt_batched(tt(T), tt(y), tt(nvec), 128)


@pytest.mark.parametrize("m", [1, 3, 12, 74])
def test_pair_index_covers_lower_triangle(m):
    pairs = ttnt.pair_index(m)
    Q = (m + 1) * (m + 2) // 2
    assert pairs.dtype == np.int32 and pairs.shape[0] == 2
    assert pairs.shape[1] % ttnt.PAIR_TILE == 0
    assert pairs.shape[1] - Q < ttnt.PAIR_TILE
    i, j = pairs[:, :Q].astype(np.int64)
    assert (i >= j).all() and (j >= 0).all() and (i <= m).all()
    assert len(set(zip(i.tolist(), j.tolist()))) == Q
    np.testing.assert_array_equal(i * (i + 1) // 2 + j, np.arange(Q))
    assert (pairs[:, Q:] == m).all()


def _unpack(G, pairs, m):
    """(TNT, d) from per-chain pair sums ``G (C, Qpad)``, as the kernel's
    finishing pass writes them: pair (i, j) to TNT[i, j] and TNT[j, i] for
    i < m, to d[j] for i = m; the (m, m) pair and the padding dropped."""
    C = G.shape[0]
    TNT = np.full((C, m, m), np.nan, np.float32)
    d = np.full((C, m), np.nan, np.float32)
    for q in range((m + 1) * (m + 2) // 2 - 1):
        i, j = pairs[:, q]
        if i < m:
            TNT[:, i, j] = TNT[:, j, i] = G[:, q]
        else:
            d[:, j] = G[:, q]
    return TNT, d


def _lanes_writes(m):
    """Where the lanes kernel writes each sum of each tile of
    ``lanes_tiles(m)``: ``{("tnt", i, j) | ("d", j) | ("const",): [(i, j)
    pairs of the Gram]}``, by its store rule: (i, j), i, j < m, to
    TNT[i, j] and, off the diagonal tiles, TNT[j, i]; (m, j) to d[j];
    every other (i, j) of the 16 x 16 tile ((m, m), the padding, and the
    upper half of a diagonal tile's row m) nowhere."""
    tiles = ttnt.lanes_tiles(m)
    out = {}
    for I0, J0 in tiles.T.tolist():
        for i in range(I0, I0 + ttnt.LANES_TILE):
            for j in range(J0, J0 + ttnt.LANES_TILE):
                if i < m and j < m:
                    out.setdefault(("tnt", i, j), []).append((i, j))
                    if I0 != J0:
                        out.setdefault(("tnt", j, i), []).append((i, j))
                elif i == m and j < m:
                    out.setdefault(("d", j), []).append((i, j))
    return out


@pytest.mark.parametrize("m", [1, 3, 14, 15, 16, 31, 32, 74, 174])
def test_lanes_tiles_cover_lower_triangle(m):
    """The lanes kernel's tile table covers each pair (i, j), i >= j, of
    the (m + 1) x (m + 1) Gram exactly once, and its store rule writes
    every TNT entry and every d entry exactly once."""
    tiles = ttnt.lanes_tiles(m)
    R = -(-(m + 1) // ttnt.LANES_TILE)
    assert tiles.dtype == np.int32 and tiles.shape == (2, R * (R + 1) // 2)
    I0, J0 = tiles.astype(np.int64)
    assert (I0 >= J0).all() and (tiles % ttnt.LANES_TILE == 0).all()
    assert I0[-1] == J0[-1] and I0[-1] <= m < I0[-1] + ttnt.LANES_TILE
    owner = {}
    for k, (a, b) in enumerate(zip(I0.tolist(), J0.tolist())):
        for i in range(a, min(a + ttnt.LANES_TILE, m + 1)):
            for j in range(b, min(b + ttnt.LANES_TILE, i + 1)):
                owner.setdefault((i, j), []).append(k)
    assert sorted(owner) == sorted(zip(*np.tril_indices(m + 1)))
    assert all(len(v) == 1 for v in owner.values())
    writes = _lanes_writes(m)
    want = ([("tnt", i, j) for i in range(m) for j in range(m)]
            + [("d", j) for j in range(m)])
    assert sorted(writes) == sorted(want)
    assert all(len(v) == 1 for v in writes.values())
    # a TNT entry's sum is its own pair's or its mirror's: the same float
    assert all({tuple(sorted(p, reverse=True)) for p in v} == {
        (max(k[1:]), min(k[1:]))} for k, v in writes.items()
        if k[0] == "tnt")


@pytest.mark.parametrize("G, m, want", [
    (64, 74, 4), (32, 74, 2), (4, 74, 1), (32, 174, 4), (1, 3, 1),
    (600, 3, 1), (600, 16, 2)])
def test_lanes_form(G, m, want):
    """Tiles a block: the most (at most the group's tiles) that leaves
    every SM a block."""
    assert ttnt.lanes_form(G, m) == want
    ntiles = ttnt.lanes_tiles(m).shape[1]
    pb = ttnt.lanes_form(G, m)
    assert 1 <= pb <= min(ttnt.LANES_MAX_PER_BLOCK, ntiles)
    if pb > 1:
        assert G * -(-ntiles // pb) >= ttnt.SM_COUNT


@pytest.mark.parametrize("m", [3, 16])
def test_lanes_writes_reproduce_tnt_products(m):
    """The plain Gram of [T | y] written through the lanes kernel's store
    rule gives ``tnt_products``' TNT (its lower triangle, mirrored, so
    exactly symmetric) and d."""
    T, y, nvec = _inputs(9, C=2, n=64, m=m)
    tt = torch.from_numpy
    TNT, d, _ = (a.numpy() for a in ttnt.tnt_products(
        tt(T), tt(y), tt(nvec)))
    X = np.concatenate([T, y[:, None]], 1)
    G_full = np.einsum("ti,ct,tj->cij", X, 1.0 / nvec, X).astype(np.float32)
    G_full[:, :m, :m] = np.tril(TNT) + np.swapaxes(np.tril(TNT, -1), 1, 2)
    G_full[:, m, :m] = d
    out_t = np.full((2, m, m), np.nan, np.float32)
    out_d = np.full((2, m), np.nan, np.float32)
    for key, pairs in _lanes_writes(m).items():
        (i, j), = pairs
        v = G_full[:, max(i, j), min(i, j)]
        if key[0] == "tnt":
            out_t[:, key[1], key[2]] = v
        else:
            out_d[:, key[1]] = v
    low = np.tril(np.ones((m, m), bool))
    np.testing.assert_array_equal(out_t[:, low], TNT[:, low])
    np.testing.assert_array_equal(out_t, np.swapaxes(out_t, 1, 2))
    np.testing.assert_array_equal(out_d, d)


@pytest.mark.parametrize("m", [3, 12])
def test_pair_unpack_reproduces_tnt_products(m):
    T, y, nvec = _inputs(8, C=4, n=256, m=m)
    TNT, d, _ = (a.numpy() for a in ttnt.tnt_products(
        torch.from_numpy(T), torch.from_numpy(y), torch.from_numpy(nvec),
        128))
    # the plain Gram of [T | y]: TNT in its top-left block, d in row m
    G_full = np.zeros((4, m + 1, m + 1), np.float32)
    G_full[:, :m, :m] = TNT
    G_full[:, m, :m] = d
    pairs = ttnt.pair_index(m)
    G = G_full[:, pairs[0], pairs[1]]
    TNT_u, d_u = _unpack(G, pairs, m)
    low = np.tril(np.ones((m, m), bool))
    np.testing.assert_array_equal(TNT_u[:, low], TNT[:, low])
    np.testing.assert_array_equal(TNT_u, np.swapaxes(TNT_u, 1, 2))
    np.testing.assert_array_equal(d_u, d)
    M, _ = _scale(T, y, nvec)
    assert (np.abs(TNT_u - TNT) <= 1e-6 * M).all()


def _pad(t, n, value):
    """The per-TOA state of the dense sampler padded to ``n`` TOAs."""
    return torch.cat([t, torch.full(t.shape[:-1] + (n - t.shape[-1],),
                                    value)], -1)


def test_blocked_sweep_matches_dense():
    ma = make_demo_model_arrays()
    cfg = GibbsConfig(model="mixture", vary_df=True,
                      theta_prior="beta").with_adapt(10, adapt_cov=True)
    C = 16
    dense = TorchGibbs(ma, cfg, nchains=C, device="cpu", tnt_block_size=None)
    blocked = TorchGibbs(ma, cfg, nchains=C, device="cpu", tnt_block_size=128)
    assert blocked._n == 256 and dense._n == ma.n == 130
    keys = rng.chain_keys(4, range(C))
    st = dense._prop_cov_update(dense.init_state(seed=4))
    for i in range(3):
        st = dense._sweep(st, dense._draw(keys, torch.tensor(i), st),
                          sweep=i)
    n = ma.n
    st_b = st._replace(z=_pad(st.z, 256, 0.0), alpha=_pad(st.alpha, 256, 1.0),
                       pout=_pad(st.pout, 256, 0.0))
    dr = blocked._draw(keys, torch.tensor(3), st_b)
    dr_d = dr._replace(u_z=dr.u_z[:, :n], g_alpha=dr.g_alpha[..., :n])
    out_d = dense._sweep(st, dr_d, sweep=3)
    out_b = blocked._sweep(st_b, dr, sweep=3)
    for f in ("acc_white", "acc_hyper", "theta", "df"):
        torch.testing.assert_close(getattr(out_b, f), getattr(out_d, f),
                                   rtol=1e-4, atol=0.0)
    assert 0 < float(out_d.acc_hyper.mean()) < 1
    for f in ("x", "b"):
        torch.testing.assert_close(getattr(out_b, f), getattr(out_d, f),
                                   rtol=1e-4,
                                   atol=1e-4 * float(getattr(out_d, f).abs()
                                                     .max()))
    assert torch.equal(out_b.z[:, :n], out_d.z)
    assert not out_b.z[:, n:].any() and (out_b.alpha[:, n:] == 1.0).all()
    torch.testing.assert_close(out_b.alpha[:, :n], out_d.alpha, rtol=1e-4,
                               atol=0.0)


def test_record_light():
    ma = make_demo_model_arrays(components=5)
    cfg = GibbsConfig(model="mixture", vary_df=True)
    with pytest.raises(ValueError, match="record"):
        TorchGibbs(ma, cfg, nchains=4, device="cpu", record="compact16")
    s = TorchGibbs(ma, cfg, nchains=4, device="cpu", record="light",
                   tnt_block_size=64)
    res = s.sample(niter=5, seed=2)
    assert res.chain.shape == (5, 4, ma.nparam)
    assert res.thetachain.shape == res.dfchain.shape == (5, 4)
    assert res.stats["acc_white"].shape == (5, 4)
    for f in ("bchain", "zchain", "alphachain", "poutchain"):
        assert getattr(res, f).size == 0, f
    assert str(res.stats["record_mode"]) == "light"
    assert np.isfinite(res.chain).all()
    full = TorchGibbs(ma, cfg, nchains=4, device="cpu", tnt_block_size=64,
                      record="full")
    res_f = full.sample(niter=5, seed=2)
    # the same run, recorded in full: the light fields are equal, and the
    # per-TOA chains are trimmed back to the real TOAs
    np.testing.assert_array_equal(res_f.chain, res.chain)
    assert res_f.zchain.shape == (5, 4, ma.n)
