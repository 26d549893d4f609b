"""The whole white-noise MH block: kernel wrapper and plain version.

Counterpart of ``gibbs_student_t_tpu/ops/pallas_white.py``. The
reference's white-noise update is S = 20 sequential Metropolis steps
(reference gibbs.py:114-143), each evaluating the conditional-on-b
likelihood ``-1/2 (sum log N + sum (y-Tb)^2/N)`` with
``N = alpha^z * Nvec0(efac, equad)``. ``white_mh`` runs the whole block
for every chain in one launch of ``csrc/white_mh.cu`` (replacing
``pallas_white.py::_white_kernel``): its bound on the H100 (operations,
narrowly over bytes) is under a microsecond, and its time goes to the
sequential steps, so it stages the per-chain inputs in shared memory once
and runs all steps there, one block per chain. The draws (``dx``, ``logu``) are
inputs, so kernel and plain version consume the same random numbers.

Constant folding follows the JAX package: selection groups pinned to
constants fold into a baseline variance row ``nv0``; each varying group
keeps its basis row and an in-kernel coefficient,
``nv(q) = nv0 + sum_g c_g(q) row_g`` with ``c = q^2`` (efac) or
``exp(2 ln10 q)`` (equad). Row 1 of the constant rows is the real-TOA
mask: a masked TOA gets ``nv = 1`` and adds nothing to ``ll``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

LN10 = float(np.log(10.0))
_LOG_2PI = float(np.log(2.0 * np.pi))

#: most varying white-noise groups the kernel takes (its by-value table)
MAX_WHITE_VAR = 8


class WhiteConsts(NamedTuple):
    """Constants of one model's white-noise likelihood.

    ``rows``: (R, n) — row 0 the folded baseline variance ``nv0``, row 1
    the real-TOA mask, rows 2+ the varying groups' basis rows. ``var``:
    ``(kind, x_index, row_slot)`` triples, kind 0 = efac, 1 = equad.
    ``specs``: (3, p) prior table rows (kind, a, b)."""

    rows: np.ndarray
    var: Tuple[Tuple[int, int, int], ...]
    specs: np.ndarray


def build_white_consts(ma, row_mask=None) -> WhiteConsts:
    """Fold a ``ModelArrays``'s white-noise structure into kernel form,
    mirroring ``models.pta.ndiag`` (constant groups fold into ``nv0`` in
    float64, then the rows are cast to float32)."""
    n = ma.y.shape[0]
    sigma2 = np.asarray(ma.sigma2, np.float64)
    nv0 = np.zeros(n, np.float64)
    var_rows = []
    var = []
    for g, idx in enumerate(ma.efac_idx):
        A = np.asarray(ma.efac_masks[g], np.float64) * sigma2
        if idx < 0:
            nv0 += float(ma.efac_const[g]) ** 2 * A
        else:
            var.append((0, int(idx), 2 + len(var_rows)))
            var_rows.append(A)
    s2 = float(ma.time_scale) ** 2
    for h, idx in enumerate(ma.equad_idx):
        B = np.asarray(ma.equad_masks[h], np.float64) * s2
        if idx < 0:
            nv0 += 10.0 ** (2.0 * float(ma.equad_const[h])) * B
        else:
            var.append((1, int(idx), 2 + len(var_rows)))
            var_rows.append(B)
    rmask = (np.ones(n) if row_mask is None
             else np.asarray(row_mask, np.float64))
    rows = np.stack([nv0, rmask] + var_rows).astype(np.float32)
    specs = np.asarray(ma.prior_specs, np.float32)[:, :3].T.copy()
    kinds = set(np.unique(specs[0].astype(int)))
    if not kinds <= {0, 1, 2}:
        raise ValueError(f"unsupported prior kinds for fused MH: {kinds}")
    return WhiteConsts(rows=rows, var=tuple(var), specs=specs)


def _lnprior_cols(q, kind, a, b):
    """Per-parameter log-prior, the ``lnprior_specs`` formula on
    broadcastable (..., p) tensors: kind 0 uniform, 1 normal, 2
    log-uniform amplitude; -inf out of bounds."""
    ninf = torch.full_like(q, -math.inf)
    inb = (q >= a) & (q <= b)
    u = kind == 0
    out = torch.where(u & inb, -torch.log(torch.where(u, b - a, 1.0)), ninf)
    nrm = kind == 1
    z = (q - a) / torch.where(nrm, b, 1.0)
    out = torch.where(nrm, -0.5 * z * z - torch.log(torch.where(nrm, b, 1.0))
                      - 0.5 * _LOG_2PI, out)
    lexp = kind == 2
    den = torch.where(lexp, 10.0 ** b - 10.0 ** a, 1.0)
    out = torch.where(lexp & inb, q * LN10 + torch.log(LN10 / den), out)
    return out


def lnprior_sum(q, specs):
    """Sum of the log-priors of ``q (..., p)`` over the ``(3, p)`` table."""
    return _lnprior_cols(q, specs[0], specs[1], specs[2]).sum(-1)


def white_ll_lp(q, az, yred2, rows, var, specs):
    """(ll, lp) of proposals ``q (C, p)``: the white conditional
    likelihood (reference gibbs.py:262-284) and the full prior."""
    nd = rows[0]
    for vkind, idx, slot in var:
        val = q[..., idx:idx + 1]
        c = val * val if vkind == 0 else torch.exp(2.0 * LN10 * val)
        nd = nd + c * rows[slot]
    rmask = rows[1]
    nv = rmask * (az * nd) + (1.0 - rmask)
    ll = -0.5 * (torch.log(nv) + yred2 / nv).sum(-1)
    return ll, lnprior_sum(q, specs)


def mh_loop(ll_lp, x, dx, logu):
    """Branchless random-walk Metropolis over precomputed draws, the loop
    every MH kernel runs: ``ll_lp(q) -> (ll, lp)`` per chain, ``x (C, p)``,
    ``dx (C, S, p)``, ``logu (C, S)``; step i proposes ``x + dx[:, i]`` and
    accepts where ``(ll1 + lp1) - (ll0 + lp0) > logu[:, i]`` (NaN never
    accepts). Returns ``(x_new, acc_rate (C,))``."""
    ll0, lp0 = ll_lp(x)
    acc = torch.zeros_like(ll0)
    S = dx.shape[-2]
    for i in range(S):
        q = x + dx[..., i, :]
        ll1, lp1 = ll_lp(q)
        accept = (ll1 + lp1) - (ll0 + lp0) > logu[..., i]
        x = torch.where(accept[..., None], q, x)
        ll0 = torch.where(accept, ll1, ll0)
        lp0 = torch.where(accept, lp1, lp0)
        acc = acc + accept.to(acc.dtype)
    return x, acc / S


def white_mh_loop(x, az, yred2, dx, logu, rows, specs, var):
    """The white MH block in plain PyTorch over precomputed draws:
    ``x (C, p)``, ``az/yred2 (C, n)``, ``dx (C, S, p)``, ``logu (C, S)``.
    Returns ``(x_new, acc_rate (C,))``."""
    return mh_loop(lambda q: white_ll_lp(q, az, yred2, rows, var, specs),
                   x, dx, logu)


def white_mh(x, az, yred2, dx, logu, rows, specs, var):
    """``(x_new, acc_rate)`` for the whole white MH block, one launch on a
    CUDA device, the plain loop on the CPU. Shapes as in
    :func:`white_mh_loop`; ``rows (R, n)``/``specs (3, p)`` float32 tensors
    on the same device, ``var`` the static ``WhiteConsts.var`` triples."""
    for t in (x, az, yred2, dx, logu, rows, specs):
        if t.dtype != torch.float32:
            raise ValueError(f"white_mh: float32 only, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("white_mh: operands on different devices")
    C, p = x.shape
    n = az.shape[-1]
    S = dx.shape[-2]
    if (az.shape != (C, n) or yred2.shape != (C, n)
            or dx.shape != (C, S, p) or logu.shape != (C, S)
            or rows.shape[-1] != n or specs.shape != (3, p)):
        raise ValueError("white_mh: inconsistent operand shapes")
    if x.device.type == "cpu":
        return white_mh_loop(x, az, yred2, dx, logu, rows, specs, var)
    if x.device.type != "cuda":
        raise RuntimeError(f"white_mh: no kernel for device {x.device}")
    if len(var) > MAX_WHITE_VAR:
        raise ValueError(f"white_mh: {len(var)} varying groups exceed "
                         f"MAX_WHITE_VAR ({MAX_WHITE_VAR})")
    from gibbs_student_t_tpu_torch.ops import _cuda

    lib = _cuda.lib()
    R = rows.shape[0]
    if lib.gst_white_smem(n, p, R) > _cuda.MAX_SMEM:
        raise ValueError(f"white_mh: n = {n} TOAs exceed the kernel's "
                         "shared-memory staging")
    xc, azc, y2c, dxc, luc, rc, sc = (
        t.contiguous() for t in (x, az, yred2, dx, logu, rows, specs))
    xo = torch.empty_like(xc)
    acc = torch.empty((C,), dtype=x.dtype, device=x.device)
    vt = _cuda.host_ints([k for trip in var for k in trip])
    if C:
        _cuda.check(lib.gst_white_mh(
            _cuda.ptr(xc), _cuda.ptr(azc), _cuda.ptr(y2c), _cuda.ptr(dxc),
            _cuda.ptr(luc), _cuda.ptr(rc), _cuda.ptr(sc),
            _cuda.addr(vt), len(var), _cuda.ptr(xo), _cuda.ptr(acc),
            C, n, p, S, R, _cuda.stream(x.device)), "white_mh")
        white_mh.launches += 1
    return xo, acc


white_mh.launches = 0
