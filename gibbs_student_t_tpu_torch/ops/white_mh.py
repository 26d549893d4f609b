"""The whole white-noise MH block, single-try and multiple-try: kernel
wrappers and plain versions.

Counterpart of ``gibbs_student_t_tpu/ops/pallas_white.py``. The
reference's white-noise update is S = 20 sequential Metropolis steps
(reference gibbs.py:114-143), each evaluating the conditional-on-b
likelihood ``-1/2 (sum log N + sum (y-Tb)^2/N)`` with
``N = alpha^z * Nvec0(efac, equad)``. ``white_mh`` runs the whole block
for every chain in one launch of ``csrc/white_mh.cu`` (replacing
``pallas_white.py::_white_kernel``), and ``white_mtm`` the block under
multiple-try Metropolis (replacing ``_white_mtm_kernel``). Their time goes
to the chain's sequential likelihood evaluations (at least ~46 issued
instructions a TOA and point, most of them the accurate ``logf`` and the
IEEE quotient), each a pass over the TOAs that serves up to four points
at once. Two launch forms (:func:`white_form`): a warp per chain with its
TOAs in registers or the warp's shared memory (every 130-TOA path), and
past ``n = 1024`` a thread-block cluster per chain, each block holding a
slice of the TOAs (the 1e5-TOA stress path). The draws are inputs, so
kernels and plain versions consume the same random numbers.

Each takes one model's constants (``rows (R, n)``, ``specs (3, p)``) or,
in grouped form, G models' (``rows (G, R, n)``, ``specs (G, 3, p)``)
with the chains as ``(G, C, ...)``: the multi-pulsar ensemble's
per-pulsar constants (replacing ``white_mh_fused`` / ``white_mtm_fused``
at G > 1). A grouped launch is the same kernel over the G x C chains,
each reading its group's constants, and counts on the wrapper's
``launches_grouped``; the plain versions take the group axis as a batch
axis.

``white_mh_lanes`` is the serving slot pool's entry: per-lane operands
and constants under the lanes' ``gid`` contract (``ops/lanes.py``), one
grouped launch with 16 lanes a group (replacing the Pallas arm of
``pallas_white.py::make_white_block_lanes``), counted on
``white_mh.launches_lanes``.

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

from gibbs_student_t_tpu_torch.ops.lanes import (
    check_lanes_gid,
    flat_lanes,
    lane_tiles,
    lead_dims,
)

LN10 = float(np.log(10.0))
_LOG_2PI = float(np.log(2.0 * np.pi))

#: most varying white-noise groups the kernel takes (its by-value table)
MAX_WHITE_VAR = 8


class WhiteForm(NamedTuple):
    """How the white kernels launch at a shape (``csrc/white_mh.cu``).

    ``form``: ``"warp"`` (a warp per chain) or ``"cluster"`` (a cluster of
    ``cluster`` blocks per chain); ``on_chip``: the chain's operands are
    held in registers or shared memory (False: the cluster form reads its
    slices from device memory); ``toas``: TOAs a lane keeps in registers
    (warp form; 0 for the warp's shared slice) or a block's slice (cluster
    form). The kernels' constants, the same at every shape:
    ``crossover``, the largest n of the warp form (``GST_WHITE_CROSSOVER``;
    above it a chain spans a thread-block cluster), and ``tries_pass``, the
    most points one likelihood pass evaluates (``GST_WHITE_NP``: the MTM
    kernel takes K tries in passes of this many)."""

    form: str
    cluster: int
    on_chip: bool
    toas: int
    crossover: int
    tries_pass: int


def white_form(n: int, p: int) -> WhiteForm:
    """The launch form of ``white_mh``/``white_mtm`` at ``n`` TOAs and
    ``p`` parameters on the current CUDA device (builds the kernels)."""
    from gibbs_student_t_tpu_torch.ops import _cuda

    out = _cuda.host_ints([0] * 6)
    _cuda.check(_cuda.lib().gst_white_form(int(n), int(p), _cuda.addr(out)),
                "white_form")
    return WhiteForm("cluster" if out[0] else "warp", out[1], bool(out[2]),
                     *out[3:])


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
    """Sum of the log-priors of ``q (..., p)`` over the ``(..., 3, p)``
    table."""
    return _lnprior_cols(q, specs[..., 0, :], specs[..., 1, :],
                         specs[..., 2, :]).sum(-1)


def group_axes(table, base_ndim: int, extra: int):
    """A constant table as an operand of plain arithmetic over the chain
    axis and ``extra - 1`` more: a single model's ``base_ndim``-dim table
    as it is, a grouped ``(G, ...)`` one as ``(G, 1, ..., 1, ...)``."""
    if table.dim() == base_ndim:
        return table
    return table.reshape(table.shape[:1] + (1,) * extra + table.shape[1:])


def white_ll_lp(q, az, yred2, rows, var, specs):
    """(ll, lp) of proposals ``q (C, p)``: the white conditional
    likelihood (reference gibbs.py:262-284) and the full prior; ``rows``
    and ``specs`` broadcast against ``q``'s leading axes."""
    nd = rows[..., 0, :]
    for vkind, idx, slot in var:
        val = q[..., idx:idx + 1]
        c = val * val if vkind == 0 else torch.exp(2.0 * LN10 * val)
        nd = nd + c * rows[..., slot, :]
    rmask = rows[..., 1, :]
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


def mtm_loop(weight_fn, x, dx, dxr, gumb, logu):
    """Multiple-try Metropolis (MTM(II), weight = posterior density) over
    precomputed draws, the loop the white MTM kernel runs and the hyper
    block's MTM path: ``weight_fn(q (C, J, p)) -> (C, J)`` log weights,
    ``x (C, p)``, ``dx (C, S, K, p)`` candidate jumps, ``dxr
    (C, S, K-1, p)`` reference jumps, ``gumb (C, S, K)`` Gumbel noise,
    ``logu (C, S)``. Per step the K candidates ``x + dx`` are weighted, one
    is selected by Gumbel-max (the first maximum wins), K-1 references
    around it are weighted together with the current point, and the step
    accepts where ``logsumexp(candidates) - logsumexp(references) > logu``;
    a NaN delta (every weight -inf on both sides) never accepts. Returns
    ``(x_new, acc_rate (C,))``."""
    wx = weight_fn(x[..., None, :])[..., 0]
    acc = torch.zeros_like(wx)
    S = dx.shape[-3]
    for i in range(S):
        cands = x[..., None, :] + dx[..., i, :, :]           # (C, K, p)
        lw = weight_fn(cands)
        j = torch.argmax(lw + gumb[..., i, :], dim=-1, keepdim=True)
        y = torch.gather(cands, -2, j[..., None].expand(
            *j.shape, x.shape[-1]))[..., 0, :]
        lwy = torch.gather(lw, -1, j)[..., 0]
        refs = y[..., None, :] + dxr[..., i, :, :]           # (C, K-1, p)
        lwr = torch.cat([weight_fn(refs), wx[..., None]], dim=-1)
        delta = torch.logsumexp(lw, -1) - torch.logsumexp(lwr, -1)
        accept = delta > logu[..., i]
        x = torch.where(accept[..., None], y, x)
        wx = torch.where(accept, lwy, wx)
        acc = acc + accept.to(acc.dtype)
    return x, acc / S


def white_mh_loop(x, az, yred2, dx, logu, rows, specs, var):
    """The white MH block in plain PyTorch over precomputed draws:
    ``x (C, p)``, ``az/yred2 (C, n)``, ``dx (C, S, p)``, ``logu (C, S)``;
    grouped, ``(G, C, ...)`` with ``rows (G, R, n)``, ``specs (G, 3, p)``.
    Returns ``(x_new, acc_rate (C,))``."""
    rows, specs = group_axes(rows, 2, 1), group_axes(specs, 2, 1)
    return mh_loop(lambda q: white_ll_lp(q, az, yred2, rows, var, specs),
                   x, dx, logu)


def white_mh(x, az, yred2, dx, logu, rows, specs, var):
    """``(x_new, acc_rate)`` for the whole white MH block, one launch on a
    CUDA device, the plain loop on the CPU. Shapes as in
    :func:`white_mh_loop`; ``rows (R, n)``/``specs (3, p)`` float32 tensors
    on the same device (``(G, R, n)``/``(G, 3, p)`` grouped), ``var`` the
    static ``WhiteConsts.var`` triples."""
    B = _check_white("white_mh", x, az, yred2, (dx, logu), rows, specs)
    p, n, S = x.shape[-1], az.shape[-1], dx.shape[-2]
    if dx.shape != (*B, S, p) or logu.shape != (*B, S):
        raise ValueError("white_mh: inconsistent draw shapes")
    if x.device.type == "cpu":
        return white_mh_loop(x, az, yred2, dx, logu, rows, specs, var)
    _check_kernel("white_mh", x, var)
    xo = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    acc = torch.empty(B, dtype=x.dtype, device=x.device)
    if x.numel():
        _launch("gst_white_mh", (x, az, yred2, dx, logu), rows, specs, var,
                xo, acc, B, (n, p, S))
        if len(B) == 2:
            white_mh.launches_grouped += 1
        else:
            white_mh.launches += 1
    return xo, acc


white_mh.launches = 0
white_mh.launches_grouped = 0
white_mh.launches_lanes = 0


def _white_lanes_operands(x, az, yred2, dx, logu, rows, specs, gid):
    """The lanes entry's operands as the grouped block takes them: the
    per-lane ones as ``(B/16, 16, ...)`` tiles, the constants of each
    tile's first lane ``(B/16, ...)``."""
    lead = lead_dims(x, 1, "white_mh_lanes")
    check_lanes_gid(flat_lanes(x, lead), gid, "white_mh_lanes")
    ops = [lane_tiles(t, lead) for t in (x, az, yred2, dx, logu)]
    rows_g, specs_g = (lane_tiles(t, lead)[:, 0] for t in (rows, specs))
    return ops, rows_g, specs_g


def white_mh_lanes_plain(x, az, yred2, dx, logu, rows, specs, gid, var):
    """The plain version of :func:`white_mh_lanes`: the grouped plain loop
    on the tiles, one row of constants per tile (any float dtype)."""
    ops, rows_g, specs_g = _white_lanes_operands(
        x, az, yred2, dx, logu, rows, specs, gid)
    xo, acc = white_mh_loop(*ops, rows_g, specs_g, var)
    return xo.reshape(x.shape), acc.reshape(x.shape[:-1])


def white_mh_lanes(x, az, yred2, dx, logu, rows, specs, gid, var):
    """The serving slot pool's white MH block (the Pallas arm of the JAX
    package's ``pallas_white.py::make_white_block_lanes``): per-lane
    operands, ``x (B, p)``, ``az/yred2 (B, n)``, ``dx (B, S, p)``, ``logu
    (B, S)``, and per-lane constants ``rows (B, R, n)``, ``specs (B, 3,
    p)``, each with its lanes flat or as ``(B/16, 16, ...)`` tiles, under
    the tile-uniform ``gid (B,)`` contract (``ops/lanes.py``). One row of
    constants per 16-lane tile is read (the JAX entry's ``[::16]``), and
    the block is one grouped launch of the white kernel with the 16 lanes
    of a tile as one group's chains, counted on
    ``white_mh.launches_lanes``; on the CPU, :func:`white_mh_lanes_plain`.
    Returns ``(x_new, acc_rate)`` in ``x``'s layout."""
    ops, rows_g, specs_g = _white_lanes_operands(
        x, az, yred2, dx, logu, rows, specs, gid)
    B = _check_white("white_mh_lanes", *ops[:3], ops[3:], rows_g, specs_g)
    S, p = dx.shape[-2], x.shape[-1]
    if ops[3].shape != (*B, S, p) or ops[4].shape != (*B, S):
        raise ValueError("white_mh_lanes: inconsistent draw shapes")
    if x.device.type == "cpu":
        xo, acc = white_mh_loop(*ops, rows_g, specs_g, var)
        return xo.reshape(x.shape), acc.reshape(x.shape[:-1])
    _check_kernel("white_mh_lanes", x, var)
    xo = torch.empty(ops[0].shape, dtype=x.dtype, device=x.device)
    acc = torch.empty(B, dtype=x.dtype, device=x.device)
    if x.numel():
        _launch("gst_white_mh", ops, rows_g, specs_g, var, xo, acc, B,
                (az.shape[-1], x.shape[-1], dx.shape[-2]))
        white_mh.launches_lanes += 1
    return xo.reshape(x.shape), acc.reshape(x.shape[:-1])


def white_mtm_loop(x, az, yred2, dx, dxr, gumb, logu, rows, specs, var):
    """The white block under multiple-try Metropolis in plain PyTorch:
    ``x (C, p)``, ``az/yred2 (C, n)``, ``dx (C, S, K, p)``,
    ``dxr (C, S, K-1, p)``, ``gumb (C, S, K)``, ``logu (C, S)``; grouped
    as in :func:`white_mh_loop`. Returns ``(x_new, acc_rate (C,))``."""
    rows, specs = group_axes(rows, 2, 2), group_axes(specs, 2, 2)

    def weight(q):
        ll, lp = white_ll_lp(q, az[..., None, :], yred2[..., None, :], rows,
                             var, specs)
        return ll + lp

    return mtm_loop(weight, x, dx, dxr, gumb, logu)


def white_mtm(x, az, yred2, dx, dxr, gumb, logu, rows, specs, var):
    """``(x_new, acc_rate)`` for the white block under multiple-try
    Metropolis, one launch on a CUDA device, the plain loop on the CPU.
    Shapes as in :func:`white_mtm_loop`; constants as in :func:`white_mh`."""
    B = _check_white("white_mtm", x, az, yred2, (dx, dxr, gumb, logu),
                     rows, specs)
    p, n = x.shape[-1], az.shape[-1]
    S, K = dx.shape[-3], dx.shape[-2]
    if (dx.shape != (*B, S, K, p) or dxr.shape != (*B, S, K - 1, p)
            or gumb.shape != (*B, S, K) or logu.shape != (*B, S)):
        raise ValueError("white_mtm: inconsistent draw shapes")
    if x.device.type == "cpu":
        return white_mtm_loop(x, az, yred2, dx, dxr, gumb, logu, rows, specs,
                              var)
    _check_kernel("white_mtm", x, var)
    xo = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    acc = torch.empty(B, dtype=x.dtype, device=x.device)
    if x.numel():
        _launch("gst_white_mtm", (x, az, yred2, dx, dxr, gumb, logu), rows,
                specs, var, xo, acc, B, (n, p, S, K))
        if len(B) == 2:
            white_mtm.launches_grouped += 1
        else:
            white_mtm.launches += 1
    return xo, acc


white_mtm.launches = 0
white_mtm.launches_grouped = 0


def _check_white(name, x, az, yred2, draws, rows, specs):
    """Dtypes, devices and shapes of a white block's operands; returns the
    chains' batch shape, ``(C,)`` or, grouped, ``(G, C)``."""
    for t in (x, az, yred2, *draws, rows, specs):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 only, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: operands on different devices")
    B, p = tuple(x.shape[:-1]), x.shape[-1]
    n = az.shape[-1]
    groups = B[:1] if rows.dim() == 3 else ()
    if (len(B) != 1 + len(groups) or az.shape != (*B, n)
            or yred2.shape != (*B, n) or rows.shape[:-2] != groups
            or rows.shape[-1] != n or specs.shape != (*groups, 3, p)):
        raise ValueError(f"{name}: inconsistent operand shapes")
    return B


def _check_kernel(name, x, var):
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    if len(var) > MAX_WHITE_VAR:
        raise ValueError(f"{name}: {len(var)} varying groups exceed "
                         f"MAX_WHITE_VAR ({MAX_WHITE_VAR})")


def _launch(entry, ops, rows, specs, var, xo, acc, batch, dims):
    """One launch of a white kernel: ``ops`` the per-chain operands in the
    C entry's order, then the constants, the var table, the outputs, the
    chains and chains per group (``batch`` ``(C,)``: one group of C;
    ``(G, C)``: G groups of C, group-major, as the contiguous operands lie),
    the dimensions and R."""
    from gibbs_student_t_tpu_torch.ops import _cuda

    ops = [t.contiguous() for t in (*ops, rows, specs)]
    vt = _cuda.host_ints([k for trip in var for k in trip])
    _cuda.check(getattr(_cuda.lib(), entry)(
        *(_cuda.ptr(t) for t in ops), _cuda.addr(vt), len(var),
        _cuda.ptr(xo), _cuda.ptr(acc), math.prod(batch), batch[-1], *dims,
        rows.shape[-2], _cuda.stream(xo.device)), entry[4:])
