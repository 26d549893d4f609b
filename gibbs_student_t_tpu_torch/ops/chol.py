"""Batched small Cholesky with fused forward solve, and the backward solve.

Counterpart of ``gibbs_student_t_tpu/ops/pallas_chol.py``. Two kernels
(``csrc/chol.cu``):

- ``chol_fused(S, rhs) -> (L, logdet, u)``: ``L L^T = S``, ``u = L^-1 rhs``,
  ``logdet = log det S``, for ``S (..., m, m)``. Replaces
  ``pallas_chol.py::_chol_kernel``. Bound on the H100 by bytes (S in, L
  out): under 3 flops per byte at m = 60. The first kernel (one 128-thread
  block per matrix) was bound by neither bytes nor flops but by the
  issue slots of its trailing update's index arithmetic and by two block
  barriers per column, and lost to the library factorization. Now a
  matrix of ``m <= WARP_MAX_DIM`` belongs to one warp (a lane owns one,
  two or three of its rows), several matrices share a block, the matrix
  sits in shared memory as its packed lower triangle, and the recurrence
  (``csrc/gst_common.cuh gst_chol_fwd_warp``) synchronises by
  ``__syncwarp`` and shuffles only; larger matrices keep a block each
  with a warp per row of the update and one barrier per column.
  :func:`launch_form` says which form a shape takes.
- ``tri_solve_T(L, rhs) -> x`` with ``L^T x = rhs``. Replaces
  ``pallas_chol.py::_backsolve_kernel``. Bound by bytes (L in). A warp
  per system, four systems a block, L staged as its lower triangle by
  asynchronous copies that are all in flight at once, and the
  substitution in its column form: the right-hand side stays in
  registers, and each step forms x_j = r_j / L_jj without a divide,
  hands it to the warp by one shuffle and does one FMA a lane.

``chol_fused_lanes`` and ``tri_solve_T_lanes`` are the serving slot
pool's entries to the same two kernels (replacing ``pallas_chol.py::
chol_fused_lanes`` and ``::tri_solve_T_lanes``): they check the lanes'
``gid`` contract (``ops/lanes.py``) and launch the kernel once for every
lane.

Each wrapper runs its plain PyTorch version (the same recurrence, batched)
when the tensors lie on the CPU, launches its kernel when they lie on a
CUDA device, and raises otherwise; it counts its launches in
``<wrapper>.launches``. A non-PD pivot gives NaN on every path (rsqrt of
a negative) for its own matrix only, which callers turn into a rejection
or a jitter escalation. Each call notes its kernel, implementation, launch
form and shape for the run's records (obs/introspect.py ``note_kernel``;
one set lookup after the first call of a shape).
"""

from __future__ import annotations

import math

import torch

from gibbs_student_t_tpu_torch.obs.introspect import note_kernel
from gibbs_student_t_tpu_torch.ops.lanes import check_lanes_gid

#: largest m the factor kernel takes: its shared memory (4 m^2 bytes plus
#: vectors) stays within the 227 KB a Hopper block may use up to m ~ 230;
#: 160 is the JAX package's own bound (MAX_PALLAS_DIM).
MAX_CHOL_DIM = 160
#: largest m the factor's warp form takes: rows 0..m (the right-hand side
#: is row m) over a warp's lanes, at most three a lane (csrc/chol.cu
#: checks the same bound, GST_WARP3_MAX_M)
WARP_MAX_DIM = 95
#: most matrices (warps) of the warp form in one block
MAX_PER_BLOCK = 8
#: SMs of an H100, the card the launch forms are sized for
SM_COUNT = 132


def check_per_block(name, per_block, size, warp_max=WARP_MAX_DIM):
    """Raise unless ``per_block`` is a launch the kernels take for
    matrices of ``size``: None (the wrapper decides), 0 (the block form)
    or 1..MAX_PER_BLOCK warps of the warp form (size <= ``warp_max``, the
    kernel's own bound: the factor's WARP_MAX_DIM by default)."""
    if per_block is None or per_block == 0:
        return
    if not 1 <= per_block <= MAX_PER_BLOCK:
        raise ValueError(f"{name}: per_block = {per_block} outside "
                         f"0..{MAX_PER_BLOCK}")
    if size > warp_max:
        raise ValueError(f"{name}: size {size} exceeds the warp form's "
                         f"{warp_max}; use per_block = 0")


def launch_form(B, m):
    """``(form, per_block)`` of the factor kernel's launch for ``B``
    matrices of size ``m``: ``("warp", n)`` puts one matrix on each of
    ``n`` warps of a block (m <= WARP_MAX_DIM), ``("block", 1)`` gives a
    matrix a 256-thread block (m <= MAX_CHOL_DIM). Small batches take
    fewer matrices per block, so that they still spread over the SMs.

    The rule holds for three rows a lane too. At (1024, 74), the
    log-posterior's factor, it gives 2; on an NVIDIA H100 80GB HBM3 at
    700 W (chip_smoke.py phase 12a) 1, 2, 4 and 8 matrices a block took
    0.04970, 0.04965, 0.04943 and 0.04986 ms, the block form 0.2303 ms:
    every count holds the batch in one wave of at most 8 warps an SM,
    and none is 1 % faster than 2."""
    if not 1 <= m <= MAX_CHOL_DIM:
        raise ValueError(f"chol_fused: m = {m} outside 1..{MAX_CHOL_DIM}")
    if m > WARP_MAX_DIM:
        return "block", 1
    for per_block in (4, 2):
        if B >= 2 * SM_COUNT * per_block:
            return "warp", per_block
    return "warp", 1


def form_meta(m, per_block):
    """The launch form's fields of a factor launch with ``per_block``
    (0: the block form) at size ``m``, for the run's records: the warp
    form's rows a lane (``csrc/chol.cu launch_warp_rows``: 1 below 32, 2
    below 64, else 3)."""
    if per_block == 0:
        return {"form": "block", "per_block": 0}
    return {"form": "warp", "per_block": per_block,
            "rows_per_lane": 1 if m < 32 else 2 if m < 64 else 3}


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


def chol_fused(S, rhs, per_block=None):
    """``(L, logdet, u)`` for ``S (..., m, m)``, ``rhs (..., m)``, float32;
    leading dims are flattened onto the kernel's batch (one launch).
    ``per_block`` overrides :func:`launch_form`'s matrices per block (0:
    the block form), for measurements."""
    out, launched = _chol_fused("chol_fused", S, rhs, per_block)
    chol_fused.launches += launched
    return out


chol_fused.launches = 0


def _chol_fused(name, S, rhs, per_block=None):
    """``((L, logdet, u), launches)`` of one factor call: the plain version
    on the CPU, one launch of the factor kernel on a CUDA device."""
    m = S.shape[-1]
    _check(name, S, rhs, m)
    check_per_block(name, per_block, m)
    from gibbs_student_t_tpu_torch.ops import _cuda

    if not _cuda.use_kernel(S, name):
        note_kernel(name, "plain", (math.prod(S.shape[:-2]), m))
        return chol_fused_plain(S, rhs), 0
    if m > MAX_CHOL_DIM:
        raise ValueError(f"{name}: m = {m} exceeds MAX_CHOL_DIM "
                         f"({MAX_CHOL_DIM})")
    Sc = S.reshape(-1, m, m).contiguous()
    rc = rhs.reshape(-1, m).contiguous()
    B = Sc.shape[0]
    L = torch.empty_like(Sc)
    u = torch.empty_like(rc)
    ld = torch.empty((B,), dtype=S.dtype, device=S.device)
    if B:
        if per_block is None:
            form, per_block = launch_form(B, m)
            per_block = per_block if form == "warp" else 0
        note_kernel(name, "cuda", (B, m),
                    lambda: form_meta(m, per_block))
        _cuda.launch("chol_fused", S.device, _cuda.ptr(Sc), _cuda.ptr(rc),
                     _cuda.ptr(L), _cuda.ptr(u), _cuda.ptr(ld), B, m,
                     per_block, what=name)
    return ((L.reshape(S.shape), ld.reshape(S.shape[:-2]),
             u.reshape(rhs.shape)), int(B > 0))


def chol_fused_lanes(S, rhs, gid):
    """Serve-lanes entry of :func:`chol_fused` (the JAX package's
    ``pallas_chol.py::chol_fused_lanes``): ``S (B, m, m)`` / ``rhs (B, m)``
    per-lane operands under the slot pool's tile-uniform ``gid`` contract
    (``ops/lanes.py``). The factor is per-lane already (matrices ride the
    lane batch), so the entry checks the contract and makes one launch of
    the factor kernel, counted on ``chol_fused_lanes.launches``."""
    check_lanes_gid(S, gid, "chol_fused_lanes")
    out, launched = _chol_fused("chol_fused_lanes", S, rhs)
    chol_fused_lanes.launches += launched
    return out


chol_fused_lanes.launches = 0


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
    (as from :func:`chol_fused`; the entries above the diagonal are not
    read), float32."""
    x, launched = _tri_solve_T("tri_solve_T", L, rhs)
    tri_solve_T.launches += launched
    return x


tri_solve_T.launches = 0


def _tri_solve_T(name, L, rhs):
    """``(x, launches)`` of one back-solve call: the plain version on the
    CPU, one launch of the back-solve kernel on a CUDA device."""
    m = L.shape[-1]
    _check(name, L, rhs, m)
    from gibbs_student_t_tpu_torch.ops import _cuda

    if not _cuda.use_kernel(L, name):
        note_kernel(name, "plain", (math.prod(L.shape[:-2]), m))
        return tri_solve_T_plain(L, rhs), 0
    if m > MAX_CHOL_DIM:
        raise ValueError(f"{name}: m = {m} exceeds MAX_CHOL_DIM "
                         f"({MAX_CHOL_DIM})")
    Lc = L.reshape(-1, m, m).contiguous()
    rc = rhs.reshape(-1, m).contiguous()
    B = Lc.shape[0]
    x = torch.empty_like(rc)
    if B:
        note_kernel(name, "cuda", (B, m))
        _cuda.launch("tri_solve_T", L.device, _cuda.ptr(Lc), _cuda.ptr(rc),
                     _cuda.ptr(x), B, m, what=name)
    return x.reshape(rhs.shape), int(B > 0)


def tri_solve_T_lanes(L, rhs, gid):
    """Serve-lanes entry of :func:`tri_solve_T` (the JAX package's
    ``pallas_chol.py::tri_solve_T_lanes``; see :func:`chol_fused_lanes`
    for the ``gid`` contract), counted on ``tri_solve_T_lanes.launches``."""
    check_lanes_gid(L, gid, "tri_solve_T_lanes")
    x, launched = _tri_solve_T("tri_solve_T_lanes", L, rhs)
    tri_solve_T_lanes.launches += launched
    return x


tri_solve_T_lanes.launches = 0
