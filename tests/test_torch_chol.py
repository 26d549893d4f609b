"""The port's factor / back-solve kernels (plain versions, CPU) and the
preconditioned linear algebra around them, against the JAX package.

- ``chol_fused`` / ``tri_solve_T`` against ``jnp.linalg.cholesky`` +
  ``solve_triangular`` at m in {14, 15, 60, 64, 65, 74, 95} (the sizes the
  kernel's launch forms tell apart, and the log-posterior's 74), batch
  64: rtol 1e-4 / atol 1e-5 on L, u and x, 1e-4 on logdet (float32, same
  inputs); a non-PD input gives a NaN logdet on both sides;
- ``launch_form``: which form each (B, m) takes, every m up to the bound
  takes one; the hyper kernel keeps its own forms (test_torch_mh.py);
- ``schur_eliminate(return_factor=True)``, ``robust_precond_draw`` and
  ``precond_quad_logdet`` against the JAX functions at 1e-4, on Sigma
  matrices built from the flagship demo model.

Wrappers count launches only where they launch a CUDA kernel, so CPU calls
leave the counters alone. The kernels themselves are held against these
plain versions on the card (test_torch_kernels.py, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.linalg import solve_triangular

from gibbs_student_t_tpu.models.pta import ndiag, phiinv_logdet
from gibbs_student_t_tpu.ops import linalg as jlin
from gibbs_student_t_tpu.ops.tnt import tnt_products as jtnt
from gibbs_student_t_tpu_torch.ops import chol, linalg
from gibbs_student_t_tpu_torch.ops.tnt import tnt_products
from test_torch_kernels import spd

# The suite runs in parallel workers and these tensors are small: one
# PyTorch CPU thread per worker costs nothing here and leaves the other
# cores to the other workers.
torch.set_num_threads(1)


@pytest.mark.parametrize("m", [14, 60, 15, 64, 65, 74, 95])
def test_chol_and_backsolve_vs_jax(m):
    # condition number 30: the stated tolerances sit above float32
    # roundoff times the conditioning (cond 1e3 already moves u and x by
    # ~1e-4 relative on BOTH sides, a property of the inputs, not of
    # either implementation)
    rng = np.random.default_rng(100 + m)
    S = spd(rng, 64, m, cond=30.0)
    r = rng.normal(size=(64, m)).astype(np.float32)
    L, ld, u = chol.chol_fused(torch.from_numpy(S), torch.from_numpy(r))
    x = chol.tri_solve_T(L, torch.from_numpy(r))
    Lj = jnp.linalg.cholesky(jnp.asarray(S))
    ldj = 2.0 * jnp.sum(jnp.log(jnp.diagonal(Lj, axis1=-2, axis2=-1)), -1)
    uj = solve_triangular(Lj, jnp.asarray(r)[..., None], lower=True)[..., 0]
    xj = solve_triangular(Lj, jnp.asarray(r)[..., None], lower=True,
                          trans="T")[..., 0]
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-4,
                               atol=1e-5)
    # zeros above the diagonal, as the kernel writes them
    assert not np.triu(L.numpy(), 1).any()
    assert chol.chol_fused.launches == 0 and chol.tri_solve_T.launches == 0


def test_chol_non_pd_gives_nan_both_sides():
    rng = np.random.default_rng(7)
    S = spd(rng, 8, 14)
    S[3] = -S[3]                         # negative first pivot
    S[5, 6, 6] = -1.0                    # non-PD deeper in
    S[5, 6, :6] = 0.0
    S[5, :6, 6] = 0.0
    r = np.ones((8, 14), np.float32)
    _, ld, _ = chol.chol_fused(torch.from_numpy(S), torch.from_numpy(r))
    Lj = jnp.linalg.cholesky(jnp.asarray(S))
    ldj = 2.0 * jnp.sum(jnp.log(jnp.diagonal(Lj, axis1=-2, axis2=-1)), -1)
    bad = [3, 5]
    assert np.isnan(ld.numpy()[bad]).all()
    assert np.isnan(np.asarray(ldj)[bad]).all()
    good = [i for i in range(8) if i not in bad]
    np.testing.assert_allclose(ld.numpy()[good], np.asarray(ldj)[good],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B, m, want", [
    (4 * 1024, 60, ("warp", 4)), (3 * 1024, 60, ("warp", 4)),
    (1024, 14, ("warp", 2)), (4 * 64, 60, ("warp", 1)),
    (64, 14, ("warp", 1)), (1061, 64, ("warp", 4)), (1, 1, ("warp", 1)),
    (1061, 65, ("warp", 4)), (7, 160, ("block", 1)),
    (1024, 74, ("warp", 2)), (1, 74, ("warp", 1)), (1061, 95, ("warp", 4)),
    (259, 96, ("block", 1))])
def test_chol_launch_form(B, m, want):
    assert chol.launch_form(B, m) == want


def test_chol_launch_form_covers_every_size():
    assert chol.WARP_MAX_DIM == 95       # rows 0..m, three a lane
    forms = {m: chol.launch_form(4096, m)
             for m in range(1, chol.MAX_CHOL_DIM + 1)}
    assert all(f == ("warp", 4) for m, f in forms.items()
               if m <= chol.WARP_MAX_DIM)
    assert all(f == ("block", 1) for m, f in forms.items()
               if m > chol.WARP_MAX_DIM)
    for m in (0, chol.MAX_CHOL_DIM + 1):
        with pytest.raises(ValueError):
            chol.launch_form(4096, m)


@pytest.mark.parametrize("m", [74, 95])
def test_chol_per_block_reaches_the_warp_bound(m):
    # the measurement override takes every warp-form launch up to the
    # factor's bound, and none past it
    for pb in range(chol.MAX_PER_BLOCK + 1):
        chol.check_per_block("chol_fused", pb, m)
    with pytest.raises(ValueError):
        chol.check_per_block("chol_fused", 1, chol.WARP_MAX_DIM + 1)
    rng = np.random.default_rng(m)
    S = torch.from_numpy(spd(rng, 3, m, cond=30.0))
    r = torch.from_numpy(rng.normal(size=(3, m)).astype(np.float32))
    out = chol.chol_fused(S, r, per_block=2)
    for a, b in zip(out, chol.chol_fused_plain(S, r)):
        assert torch.equal(a, b)


def test_leading_dims_flatten():
    rng = np.random.default_rng(11)
    S = spd(rng, 12, 10).reshape(3, 4, 10, 10)
    r = rng.normal(size=(3, 4, 10)).astype(np.float32)
    L, ld, u = chol.chol_fused(torch.from_numpy(S), torch.from_numpy(r))
    assert L.shape == (3, 4, 10, 10) and ld.shape == (3, 4)
    L2, ld2, u2 = chol.chol_fused(torch.from_numpy(S[1, 2]),
                                  torch.from_numpy(r[1, 2]))
    np.testing.assert_array_equal(ld.numpy()[1, 2], ld2.numpy())
    np.testing.assert_array_equal(u.numpy()[1, 2], u2.numpy())


def test_wrappers_reject_bad_operands():
    S = torch.eye(4).expand(2, 4, 4).contiguous()
    # float32 or float64, one dtype a call
    with pytest.raises(ValueError):
        chol.chol_fused(S.double(), torch.zeros(2, 4))
    with pytest.raises(ValueError):
        chol.chol_fused(S.half(), torch.zeros(2, 4, dtype=torch.float16))
    with pytest.raises(ValueError):
        chol.chol_fused(S, torch.zeros(2, 3))
    with pytest.raises(RuntimeError):
        chol.chol_fused(S.to("meta"), torch.zeros(2, 4, device="meta"))
    for per_block in (-1, chol.MAX_PER_BLOCK + 1):
        with pytest.raises(ValueError):
            chol.chol_fused(S, torch.zeros(2, 4), per_block=per_block)
    with pytest.raises(ValueError):      # the warp form stops at m = 95
        chol.chol_fused(torch.eye(96)[None], torch.zeros(1, 96), per_block=4)


@pytest.fixture(scope="module")
def flagship_sigma(demo_ma):
    """Per-chain (TNT, d, Sigma pieces) of the flagship demo model at 32
    random points near the posterior: the matrices the sweep factors."""
    rng = np.random.default_rng(5)
    C = 32
    ma = demo_ma
    x = np.stack([np.array([-7.5, 4.0, -14.0]) + rng.normal(0, 0.3, 3)
                  for _ in range(C)]).astype(np.float32)
    z = (rng.random((C, ma.n)) < 0.05).astype(np.float32)
    alpha = rng.gamma(2.0, 3.0, (C, ma.n)).astype(np.float32)
    T = jnp.asarray(ma.T, jnp.float32)
    y = jnp.asarray(ma.y, jnp.float32)
    nvec = jnp.asarray(alpha ** z) * jax.vmap(
        lambda xx: ndiag(ma, xx, jnp))(jnp.asarray(x)).astype(jnp.float32)
    TNT, d, const = jax.vmap(lambda nv: jtnt(T, y, nv, None))(nvec)
    phiinv = jax.vmap(lambda xx: phiinv_logdet(ma, xx, jnp)[0])(
        jnp.asarray(x)).astype(jnp.float32)
    TNT_t, d_t, const_t = tnt_products(torch.from_numpy(np.array(T)),
                                       torch.from_numpy(np.array(y)),
                                       torch.from_numpy(np.array(nvec)))
    return dict(TNT=np.array(TNT), d=np.array(d), const=np.array(const),
                phiinv=np.array(phiinv), TNT_t=TNT_t.numpy(),
                d_t=d_t.numpy(), const_t=const_t.numpy(), m=ma.m)


def test_tnt_products_vs_jax(flagship_sigma):
    f = flagship_sigma
    np.testing.assert_allclose(f["TNT_t"], f["TNT"], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(f["d_t"], f["d"], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(f["const_t"], f["const"], rtol=1e-6)


def test_schur_and_draw_vs_jax(flagship_sigma):
    f = flagship_sigma
    s_i, v_i = np.arange(60, 74), np.arange(60)
    TNT, d, phiinv = f["TNT"], f["d"], f["phiinv"]
    A = TNT[:, s_i][:, :, s_i] + np.einsum("bi,ij->bij", phiinv[:, s_i],
                                           np.eye(len(s_i), dtype=np.float32))
    Bm = TNT[:, s_i][:, :, v_i]
    Cv = TNT[:, v_i][:, :, v_i]
    jitter = 1e-6
    out_j = jax.vmap(lambda a, b, c, rs, rv: jlin.schur_eliminate(
        a, b, c, rs, rv, jitter, return_factor=True))(
        A, Bm, Cv, d[:, s_i], d[:, v_i])
    tt = torch.from_numpy
    out_t = linalg.schur_eliminate(tt(A), tt(Bm), tt(Cv), tt(d[:, s_i]),
                                   tt(d[:, v_i]), jitter, return_factor=True)
    names = ("S0", "rt", "quad_s", "logdetA")
    for nm, a, b in zip(names, out_t[:4], out_j[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(b)).max(),
                                   err_msg=nm)
    for nm, a, b in zip(("La", "isd_a", "U_B", "u_s"), out_t[4], out_j[4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(b)).max(),
                                   err_msg=nm)

    # the b-draw's v-block robust draw, same xi on both sides
    rng = np.random.default_rng(9)
    S0, rt = np.array(out_j[0]), np.array(out_j[1])
    Sv = S0 + np.einsum("bi,ij->bij", phiinv[:, v_i],
                        np.eye(60, dtype=np.float32))
    xi = rng.normal(size=(32, 60)).astype(np.float32)
    jits = (jitter, 1e-4, 1e-2, 1e-1)
    yj, isdj, ldj = jax.vmap(lambda s, r, e: jlin.robust_precond_draw(
        s, r, e, jitters=jits))(Sv, rt, xi)
    yt, isdt, ldt = linalg.robust_precond_draw(tt(Sv), tt(rt), tt(xi),
                                               jitters=jits)
    for nm, a, b in (("y", yt, yj), ("isd", isdt, isdj), ("logdet", ldt, ldj)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=nm)

    # the marginalized-likelihood payload on the full Sigma
    Sigma = TNT + np.einsum("bi,ij->bij", phiinv,
                            np.eye(f["m"], dtype=np.float32))
    qj, lj = jax.vmap(lambda s, r: jlin.precond_quad_logdet(s, r, jitter))(
        Sigma, d)
    qt, lt = linalg.precond_quad_logdet(tt(Sigma), tt(d), jitter)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4)


def test_robust_escalates_past_non_pd():
    rng = np.random.default_rng(2)
    S = spd(rng, 6, 8, cond=10.0)
    # unit-diagonal, indefinite by -0.005: the 1e-2 jitter level factors
    S[2] = np.eye(8, dtype=np.float32)
    S[2, 0, 1] = S[2, 1, 0] = 1.005
    r = rng.normal(size=(6, 8)).astype(np.float32)
    xi = rng.normal(size=(6, 8)).astype(np.float32)
    jits = (1e-6, 1e-4, 1e-2, 1e-1)
    yt, _, ldt = linalg.robust_precond_draw(torch.from_numpy(S),
                                            torch.from_numpy(r),
                                            torch.from_numpy(xi), jits)
    yj, _, ldj = jax.vmap(lambda s, rr, e: jlin.robust_precond_draw(
        s, rr, e, jitters=jits))(S, r, xi)
    assert np.isfinite(yt.numpy()).all() and np.isfinite(ldt.numpy()).all()
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=1e-4,
                               atol=1e-4)
