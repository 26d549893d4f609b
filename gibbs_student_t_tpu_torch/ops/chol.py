"""Batched small Cholesky with fused forward solve, and the backward solve.

Counterpart of ``gibbs_student_t_tpu/ops/pallas_chol.py``. Two kernels
(``csrc/chol.cu``):

- ``chol_fused(S, rhs) -> (L, logdet, u)``: ``L L^T = S``, ``u = L^-1 rhs``,
  ``logdet = log det S``, for ``S (..., m, m)``. Replaces
  ``pallas_chol.py::_chol_kernel``. Bound on the H100 by bytes (S in, L
  out); one thread block per matrix keeps the recurrence in shared memory
  and touches device memory once each way.
- ``tri_solve_T(L, rhs) -> x`` with ``L^T x = rhs``. Replaces
  ``pallas_chol.py::_backsolve_kernel``. Bound by bytes (L in); one warp
  per system, warp-shuffle column dots.

Each wrapper runs its plain PyTorch version (the same recurrence, batched)
when the tensors lie on the CPU, launches its kernel when they lie on a
CUDA device, and raises otherwise; it counts its launches in
``<wrapper>.launches``. A non-PD pivot gives NaN on every path (rsqrt of
a negative), which callers turn into a rejection or a jitter escalation.
"""

from __future__ import annotations

import torch

#: largest m the factor kernel takes: its shared memory (4 m^2 bytes plus
#: vectors) stays within the 227 KB a Hopper block may use up to m ~ 230;
#: 160 is the JAX package's own bound (MAX_PALLAS_DIM).
MAX_CHOL_DIM = 160


def _check(name, mats, vecs, m):
    for t in (mats, vecs):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 only, got {t.dtype}")
    if mats.shape[-1] != m or mats.shape[-2] != m:
        raise ValueError(f"{name}: need (..., m, m) matrices, got "
                         f"{tuple(mats.shape)}")
    if vecs.shape != mats.shape[:-1]:
        raise ValueError(f"{name}: rhs {tuple(vecs.shape)} does not match "
                         f"matrices {tuple(mats.shape)}")
    if mats.device != vecs.device:
        raise ValueError(f"{name}: operands on {mats.device} and "
                         f"{vecs.device}")


def chol_fused_plain(S, rhs):
    """The factor kernel's recurrence in PyTorch: right-looking, per
    column the pivot's rsqrt scales the column, the forward-solve entry
    rides along, and a rank-1 update refreshes the trailing block."""
    batch, m = S.shape[:-2], S.shape[-1]
    A = S.reshape(-1, m, m).clone()
    r = rhs.reshape(-1, m)
    B = A.shape[0]
    L = torch.zeros_like(A)
    u = torch.empty((B, m), dtype=S.dtype, device=S.device)
    racc = torch.zeros((B, m), dtype=S.dtype, device=S.device)
    ld = torch.zeros((B,), dtype=S.dtype, device=S.device)
    for j in range(m):
        piv = A[:, j, j]
        inv = torch.rsqrt(piv)
        ld = ld + torch.log(piv)
        col = A[:, j:, j] * inv[:, None]
        uj = (r[:, j] - racc[:, j]) * inv
        u[:, j] = uj
        racc[:, j:] += col * uj[:, None]
        L[:, j:, j] = col
        A[:, j + 1:, j + 1:] -= col[:, 1:, None] * col[:, None, 1:]
    return (L.reshape(S.shape), ld.reshape(batch),
            u.reshape(rhs.shape))


def chol_fused(S, rhs):
    """``(L, logdet, u)`` for ``S (..., m, m)``, ``rhs (..., m)``, float32;
    leading dims are flattened onto the kernel's batch (one launch)."""
    m = S.shape[-1]
    _check("chol_fused", S, rhs, m)
    if S.device.type == "cpu":
        return chol_fused_plain(S, rhs)
    if S.device.type != "cuda":
        raise RuntimeError(f"chol_fused: no kernel for device {S.device}")
    if m > MAX_CHOL_DIM:
        raise ValueError(f"chol_fused: m = {m} exceeds MAX_CHOL_DIM "
                         f"({MAX_CHOL_DIM})")
    from gibbs_student_t_tpu_torch.ops import _cuda

    Sc = S.reshape(-1, m, m).contiguous()
    rc = rhs.reshape(-1, m).contiguous()
    B = Sc.shape[0]
    L = torch.empty_like(Sc)
    u = torch.empty_like(rc)
    ld = torch.empty((B,), dtype=S.dtype, device=S.device)
    if B:
        _cuda.check(_cuda.lib().gst_chol_fused(
            _cuda.ptr(Sc), _cuda.ptr(rc), _cuda.ptr(L), _cuda.ptr(u),
            _cuda.ptr(ld), B, m, _cuda.stream(S.device)), "chol_fused")
        chol_fused.launches += 1
    return L.reshape(S.shape), ld.reshape(S.shape[:-2]), u.reshape(rhs.shape)


chol_fused.launches = 0


def tri_solve_T_plain(L, rhs):
    """Descending substitution ``L^T x = rhs`` in PyTorch, the backward
    kernel's recurrence."""
    m = L.shape[-1]
    Lf = L.reshape(-1, m, m)
    r = rhs.reshape(-1, m)
    x = torch.zeros_like(r)
    for j in range(m - 1, -1, -1):
        dot = (Lf[:, j + 1:, j] * x[:, j + 1:]).sum(-1)
        x[:, j] = (r[:, j] - dot) / Lf[:, j, j]
    return x.reshape(rhs.shape)


def tri_solve_T(L, rhs):
    """``x`` with ``L^T x = rhs`` for lower-triangular ``L (..., m, m)``
    (as from :func:`chol_fused`), float32."""
    m = L.shape[-1]
    _check("tri_solve_T", L, rhs, m)
    if L.device.type == "cpu":
        return tri_solve_T_plain(L, rhs)
    if L.device.type != "cuda":
        raise RuntimeError(f"tri_solve_T: no kernel for device {L.device}")
    if m > MAX_CHOL_DIM:
        raise ValueError(f"tri_solve_T: m = {m} exceeds MAX_CHOL_DIM "
                         f"({MAX_CHOL_DIM})")
    from gibbs_student_t_tpu_torch.ops import _cuda

    Lc = L.reshape(-1, m, m).contiguous()
    rc = rhs.reshape(-1, m).contiguous()
    B = Lc.shape[0]
    x = torch.empty_like(rc)
    if B:
        _cuda.check(_cuda.lib().gst_tri_solve_T(
            _cuda.ptr(Lc), _cuda.ptr(rc), _cuda.ptr(x), B, m,
            _cuda.stream(L.device)), "tri_solve_T")
        tri_solve_T.launches += 1
    return x.reshape(rhs.shape)


tri_solve_T.launches = 0
