"""Diagonally-preconditioned Cholesky algebra of the sweep.

Counterpart of the part of ``gibbs_student_t_tpu/ops/linalg.py`` the solo
sampler runs. ``Sigma = T^T N^-1 T + diag(phiinv)`` mixes scales across
many decades, so every factorization works on the equilibrated matrix
``S' = D^-1/2 Sigma D^-1/2`` (unit diagonal, float32-friendly):

    Sigma          = D^1/2 S' D^1/2,        L' L'^T = S'
    Sigma^-1 d     = D^-1/2 S'^-1 (D^-1/2 d)
    logdet Sigma   = logdet S' + sum log D

A non-PD matrix makes the factorization produce NaN, which the callers
turn into an MH rejection (hyper block) or a jitter escalation (the
b-draw). Factorizations go to the ``chol_fused`` kernel wrapper and
vector back-substitutions to ``tri_solve_T`` (ops/chol.py); the
multi-right-hand-side solves of the Schur elimination have no kernel in
the JAX package either and use ``torch.linalg.solve_triangular``.
All operands carry a leading batch (chain) axis.
"""

from __future__ import annotations

import torch

from gibbs_student_t_tpu_torch.ops.chol import chol_fused, tri_solve_T


def _equilibrate(Sigma, jitter: float):
    """``(S', inv_sqrt_d, sum log D)`` with ``jitter`` on S's unit diag."""
    d = torch.diagonal(Sigma, dim1=-2, dim2=-1)
    inv_sqrt_d = 1.0 / torch.sqrt(d)
    S = Sigma * inv_sqrt_d[..., :, None] * inv_sqrt_d[..., None, :]
    if jitter:
        S = S + jitter * torch.eye(S.shape[-1], dtype=S.dtype,
                                   device=S.device)
    return S, inv_sqrt_d, torch.log(d).sum(-1)


def precond_cholesky(Sigma, jitter: float = 0.0):
    """``(L, inv_sqrt_d, logdet Sigma)``: ``L`` factors the equilibrated
    matrix plus ``jitter`` on its unit diagonal."""
    S, inv_sqrt_d, logd = _equilibrate(Sigma, jitter)
    L, logdet_S, _ = chol_fused(S, torch.zeros_like(inv_sqrt_d))
    return L, inv_sqrt_d, logdet_S + logd


def precond_quad_logdet(Sigma, rhs, jitter: float = 0.0):
    """``(rhs^T Sigma^-1 rhs, logdet Sigma)`` in one factorization."""
    S, inv_sqrt_d, logd = _equilibrate(Sigma, jitter)
    _, logdet_S, u = chol_fused(S, rhs * inv_sqrt_d)
    return (u * u).sum(-1), logdet_S + logd


def robust_precond_cholesky(Sigma, jitters=(1e-6, 1e-4, 1e-2), rhs=None):
    """Escalating-jitter factorization for draws that cannot reject.

    Every jitter level is factored in ONE batched call (stacked on a new
    leading axis) and the first finite candidate is selected branchlessly
    (all-finite ``L`` and ``logdet``). Returns ``(L, inv_sqrt_d, logdet)``
    and, with ``rhs``, ``u = L^-1 (D^-1/2 rhs)`` of the selected factor."""
    S, inv_sqrt_d, logd = _equilibrate(Sigma, 0.0)
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    Ss = torch.stack([S + j * eye for j in jitters], dim=0)
    r = (torch.zeros_like(inv_sqrt_d) if rhs is None
         else rhs * inv_sqrt_d)
    Ls, logdets, us = chol_fused(Ss, r.expand(Ss.shape[:-1]))
    L, logdet_S, u = Ls[0], logdets[0], us[0]
    for k in range(1, len(jitters)):
        ok = torch.isfinite(L).all(-1).all(-1) & torch.isfinite(logdet_S)
        L = torch.where(ok[..., None, None], L, Ls[k])
        logdet_S = torch.where(ok, logdet_S, logdets[k])
        u = torch.where(ok[..., None], u, us[k])
    out = (L, inv_sqrt_d, logdet_S + logd)
    return out + (u,) if rhs is not None else out


def backward_solve(L, rhs):
    """``L^T x = rhs`` (vector right-hand side)."""
    return tri_solve_T(L, rhs)


def robust_precond_draw(Sigma, rhs, xi, jitters=(1e-6, 1e-4, 1e-2, 1e-1)):
    """``(y, inv_sqrt_d, logdet)`` with ``y = L^-T (u + xi)`` for the
    escalating-jitter factor: the b-draw is then ``y * inv_sqrt_d``."""
    L, inv_sqrt_d, logdet, u = robust_precond_cholesky(
        Sigma, jitters=jitters, rhs=rhs)
    return backward_solve(L, u + xi), inv_sqrt_d, logdet


def schur_eliminate(Sigma_ss, Sigma_sv, Sigma_vv, rhs_s, rhs_v,
                    jitter: float = 0.0, return_factor: bool = False):
    """Pre-eliminate the fixed block of ``Sigma = [[A, B], [B^T, C + D]]``.

    Returns ``(S0, rt, quad_s, logdetA)`` with ``S0 = C - B^T A^-1 B`` and
    ``rt = rhs_v - B^T A^-1 rhs_s``, so that for any diagonal ``D``
    ``rhs^T Sigma^-1 rhs = quad_s + rt^T (S0 + D)^-1 rt`` and
    ``logdet Sigma = logdetA + logdet(S0 + D)``. A non-PD ``A`` (NaN)
    poisons every evaluation that shares it. With ``return_factor``,
    appends ``(La, isd_a, U_B, u_s)``: the A-block's preconditioned factor,
    ``U_B = La^-1 D_a^-1/2 B`` and ``u_s = La^-1 D_a^-1/2 rhs_s`` — what
    the b-draw's block-assembled factorization reuses."""
    La, isd_a, logdetA = precond_cholesky(Sigma_ss, jitter)
    rhsM = torch.cat([Sigma_sv, rhs_s[..., :, None]], dim=-1)
    u = torch.linalg.solve_triangular(La, rhsM * isd_a[..., :, None],
                                      upper=False)
    w = torch.linalg.solve_triangular(La.transpose(-1, -2), u,
                                      upper=True) * isd_a[..., :, None]
    Ainv_rs = w[..., :, -1]
    quad_s = (rhs_s * Ainv_rs).sum(-1)
    mT = Sigma_sv.transpose(-1, -2)
    S0 = Sigma_vv - torch.matmul(mT, w[..., :, :-1])
    rt = rhs_v - torch.matmul(mT, Ainv_rs[..., None])[..., 0]
    out = (S0, rt, quad_s, logdetA)
    if return_factor:
        out = out + ((La, isd_a, u[..., :, :-1], u[..., :, -1]),)
    return out
