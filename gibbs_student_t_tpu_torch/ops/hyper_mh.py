"""The whole hyper-parameter MH block: kernel wrapper and plain version.

Counterpart of ``gibbs_student_t_tpu/ops/pallas_hyper.py``. The
reference's red-noise update is 10 sequential Metropolis steps on the
b-marginalized likelihood (reference gibbs.py:80-111, 288-329), each
paying a factorization. On the Schur path only the phi-varying block
``S0 (v x v)`` changes with a proposal, through its diagonal.
``hyper_mh`` runs the whole block for every chain in one launch of
``csrc/hyper_mh.cu`` (replacing ``pallas_hyper.py::_hyper_kernel``).

On the H100 the kernel is bound by operations (S + 1 factorizations per
chain against one read of ``S0``, ~60 flops per byte at v = 60). The
first kernel, one 128-thread block per chain, was held back by latency
instead: 1,320 block barriers per chain at v = 60, S = 10, integer
divisions in the update and in the build of each proposal's matrix, and
per-column scalar work on one thread. Now, for ``v <=
HYPER_WARP_MAX_V``, a warp owns a chain and several chains share a block:
``S0`` stays in shared memory as its packed lower triangle for the whole
block of steps, a
proposal's equilibrated matrix is never built (the recurrence,
``csrc/gst_common.cuh gst_chol_fwd_warp``, forms each entry as it starts
the entry's column and writes only the factor), the sums are warp
shuffles, each warp stages its chain's constants, and the kernel has no
block barrier. Larger blocks, up to ``MAX_HYPER_V`` (two v x v float
buffers per thread block), keep a block per chain with one barrier per
column; beyond that the sampler takes the closure path,
:func:`hyper_mh_loop` with the ``chol_fused`` kernel as its factorization.
:func:`launch_form` says which form a shape takes.

Every varying phi block's log-precision is affine in the sampled hypers
(powerlaw in log10_A and gamma, ecorr in each log10_ecorr), so a
proposal's phi is ``log phi = K0 + sum_k K_k x[hyp_idx[k]]`` over
constant rows (:func:`build_hyper_consts`).

The wrapper takes one model's constants (``K (1 + nk, v)``, ``sel (v,)``,
``specs (3, p)``) or, in grouped form, G models' (``(G, 1 + nk, v)``,
``(G, v)``, ``(G, 3, p)``) with the chains as ``(G, C, ...)``: the
multi-pulsar ensemble's per-pulsar constants (replacing
``hyper_mh_fused`` at G > 1). A grouped launch is the same kernel over the
G x C chains, each reading its group's constants, and counts on
``hyper_mh.launches_grouped``; the plain version takes the group axis as
a batch axis. ``hyper_mh_lanes`` is the serving slot pool's entry:
per-lane operands and constants under the lanes' ``gid`` contract
(``ops/lanes.py``), one grouped launch with 16 lanes a group (replacing
the Pallas core of ``linalg.py::_fused_hyper_lanes_dispatcher``), counted
on ``hyper_mh.launches_lanes``.

Float64 operands launch the kernel's float64 form (``gst_hyper_mh_f64``,
the sampler's ``dtype=float64``), counted on ``hyper_mh.launches_f64`` and
``launches_grouped_f64``: a chain takes twice the shared memory, so the
warp form holds fewer chains a block (:func:`launch_form`) and the block
form stops at ``MAX_HYPER_V_F64`` (:func:`max_hyper_v`), past which the
sampler takes the closure path. The lanes entry has no float64 form yet
and raises for float64 CUDA tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from gibbs_student_t_tpu_torch.models.pta import (
    ConstBlock,
    EcorrBlock,
    ImproperBlock,
    PowerlawBlock,
)
from gibbs_student_t_tpu_torch.obs.introspect import note_kernel
from gibbs_student_t_tpu_torch.ops.chol import (
    MAX_PER_BLOCK,
    SM_COUNT,
    SMEM_OPTIN,
    check_per_block,
    chol_fused_plain,
    tri,
)
from gibbs_student_t_tpu_torch.ops.lanes import (
    check_lanes_gid,
    flat_lanes,
    lane_tiles,
    lead_dims,
)
from gibbs_student_t_tpu_torch.ops.white_mh import (
    group_axes,
    lnprior_sum,
    mh_loop,
)

LN10 = float(np.log(10.0))

#: largest Schur block the kernel takes: 2 v^2 + (11 + nk) v floats of
#: shared memory stay within a Hopper block's 227 KB up to v ~ 165
MAX_HYPER_V = 160
#: the same bound of the float64 form: 2 v^2 + (10 + nk) v + 5 p doubles
#: stay within 227 KB at v = 112 for up to 16 hyper indices and 64
#: parameters (csrc/hyper_mh.cu checks the bytes)
MAX_HYPER_V_F64 = 112
#: most hyper indices the kernel's by-value table takes
MAX_HYPER_K = 16
#: largest v the kernel's warp form takes (csrc/hyper_mh.cu checks the
#: same bound, GST_WARP_MAX_M): above it a chain keeps a block, though the
#: factor's own warp form reaches further (``chol.WARP_MAX_DIM``)
HYPER_WARP_MAX_V = 64


def max_hyper_v(dtype=torch.float32):
    """The largest Schur block the kernel takes in ``dtype``."""
    return MAX_HYPER_V_F64 if dtype == torch.float64 else MAX_HYPER_V


def warp_bytes(v, p, nk, dtype=torch.float32):
    """Shared memory one chain of the warp form takes in ``dtype``: its
    group's constants and its buffers (``csrc/hyper_mh.cu``
    ``hyper_const_floats`` + ``hyper_warp_floats``)."""
    const = ((2 + nk) * v + 3 * p + 3) & ~3
    bufs = (tri(v) + ((tri(v + 1) + 3) & ~3) + 3 * v + 1 + 2 * p + 3) & ~3
    return (const + bufs) * torch.finfo(dtype).bits // 8


def launch_form(C, v, dtype=torch.float32, p=0, nk=0):
    """``(form, per_block)`` of the hyper kernel's launch for ``C`` chains
    on a ``v x v`` block: ``("warp", n)`` puts one chain on each of ``n``
    warps of a block (v <= HYPER_WARP_MAX_V), with ``n`` the chains an SM
    gets when ``C`` is dealt over the card (1,024 chains: 8 a block, 128
    blocks, one wave; 64 chains: 64 one-warp blocks, an SM each), at most
    as many as a block's SMEM_OPTIN holds at ``p`` parameters and ``nk``
    hyper indices (:func:`warp_bytes`; in float64, 6 at the flagship's v =
    60, so 1,024 chains take two waves); ``("block", 1)`` gives a chain a
    256-thread block (v <= :func:`max_hyper_v`)."""
    vmax = max_hyper_v(dtype)
    if not 1 <= v <= vmax:
        raise ValueError(f"hyper_mh: v = {v} outside 1..{vmax}")
    if v > HYPER_WARP_MAX_V:
        return "block", 1
    fit = max(1, SMEM_OPTIN // warp_bytes(v, p, nk, dtype))
    return "warp", min(MAX_PER_BLOCK, fit, max(1, -(-C // SM_COUNT)))


class HyperConsts(NamedTuple):
    """Constants of one model's marginalized likelihood over a column
    subset ``cols`` (the Schur varying block, or all m columns).

    ``K`` (1 + nk, v): row 0 the constant part of log phi on the varying
    columns, row 1+k the coefficient of ``x[hyp_idx[k]]``. ``phi_sel``
    (v,): 1 where the column's phi varies with x. ``phiinv_static`` (v,):
    the constant phiinv of static-phi columns inside the subset (zero for
    improper columns). ``logdet_phi_static``: sum of log phi over all
    static-phi columns of the model. ``specs`` (3, p): prior table."""

    K: np.ndarray
    hyp_idx: Tuple[int, ...]
    phi_sel: np.ndarray
    phiinv_static: np.ndarray
    logdet_phi_static: float
    specs: np.ndarray


def build_hyper_consts(ma, cols, dtype=np.float32) -> HyperConsts:
    """Decompose ``models.pta.phiinv_logdet`` into affine-in-x form (float64,
    cast to ``dtype`` at the end: float32, or float64 kept as it is)."""
    from gibbs_student_t_tpu_torch.models.signals import FYR

    m = ma.m
    s2 = float(ma.time_scale) ** 2
    const_col = np.zeros(m)
    has_phi = np.zeros(m, bool)
    varying = np.zeros(m, bool)
    coefs: dict[int, np.ndarray] = {}

    def coef_row(idx):
        if idx not in coefs:
            coefs[idx] = np.zeros(m)
        return coefs[idx]

    for blk in ma.phi_blocks:
        sl = slice(blk.start, blk.stop)
        if isinstance(blk, ImproperBlock):
            continue
        if isinstance(blk, ConstBlock):
            const_col[sl] = np.log(np.asarray(blk.phi, np.float64))
            has_phi[sl] = True
            continue
        if isinstance(blk, PowerlawBlock):
            freqs = np.asarray(blk.freqs, np.float64)
            const_col[sl] = (-np.log(12.0 * np.pi ** 2)
                             - 3.0 * np.log(FYR)
                             + np.log(float(blk.df)) + np.log(s2))
            gam_vec = np.log(FYR) - np.log(freqs)
            if blk.idx_log10A >= 0:
                coef_row(blk.idx_log10A)[sl] += 2.0 * LN10
                varying[sl] = True
            else:
                const_col[sl] += 2.0 * LN10 * float(blk.const_log10A)
            if blk.idx_gamma >= 0:
                coef_row(blk.idx_gamma)[sl] += gam_vec
                varying[sl] = True
            else:
                const_col[sl] += float(blk.const_gamma) * gam_vec
            has_phi[sl] = True
            continue
        if isinstance(blk, EcorrBlock):
            group = np.asarray(blk.col_group)
            const_col[sl] += np.log(s2)
            for g, idx in enumerate(blk.idx):
                gcols = blk.start + np.flatnonzero(group == g)
                if idx >= 0:
                    coef_row(idx)[gcols] += 2.0 * LN10
                    varying[gcols] = True
                else:
                    const_col[gcols] += 2.0 * LN10 * float(blk.const[g])
            has_phi[sl] = True
            continue
        raise TypeError(f"unknown phi block {type(blk)}")

    cols = np.asarray(cols, int)
    hyp_idx = tuple(sorted(coefs))
    K = np.zeros((1 + len(hyp_idx), len(cols)))
    K[0] = np.where(varying[cols], const_col[cols], 0.0)
    for k, idx in enumerate(hyp_idx):
        K[1 + k] = coefs[idx][cols]
    static = has_phi & ~varying
    phiinv_static = np.where(static[cols], np.exp(-const_col[cols]), 0.0)
    logdet_static = float(const_col[static].sum())
    specs = np.asarray(ma.prior_specs, dtype)[:, :3].T.copy()
    kinds = set(np.unique(specs[0].astype(int)))
    if not kinds <= {0, 1, 2}:
        raise ValueError(f"unsupported prior kinds for fused MH: {kinds}")
    return HyperConsts(K=K.astype(dtype), hyp_idx=hyp_idx,
                       phi_sel=varying[cols].astype(dtype),
                       phiinv_static=phiinv_static.astype(dtype),
                       logdet_phi_static=logdet_static, specs=specs)


def hyper_ll_lp(q, S0, dS0, rt, base, K, sel, specs, hyp_idx,
                jitter: float, factor=chol_fused_plain):
    """(ll, lp) of proposals ``q (C, p)``: the marginalized likelihood on
    the matrix block ``S0`` (non-finite -> -inf) and the full prior; the
    constant tables broadcast against ``q``'s leading axes.
    ``factor(S, rhs) -> (L, logdet, u)`` factors the equilibrated matrix."""
    v = S0.shape[-1]
    eye = torch.eye(v, dtype=torch.bool, device=S0.device)
    lph = K[..., 0, :]
    for k, idx in enumerate(hyp_idx):
        lph = lph + K[..., 1 + k, :] * q[..., idx:idx + 1]
    phiinv = sel * torch.exp(-lph)
    d = dS0 + phiinv
    isd = torch.rsqrt(d)
    A = torch.where(eye, 1.0 + jitter,
                    S0 * isd[..., :, None] * isd[..., None, :])
    _, logdet_A, u = factor(A, rt * isd)
    ll = base + 0.5 * ((u * u).sum(-1)
                       - (logdet_A + torch.log(d).sum(-1))
                       - (sel * lph).sum(-1))
    ll = torch.where(torch.isfinite(ll), ll, -math.inf)
    return ll, lnprior_sum(q, specs)


def hyper_mh_loop(x, S0, dS0, rt, base, dx, logu, K, sel, specs, hyp_idx,
                  jitter: float, factor=chol_fused_plain):
    """The hyper MH block over precomputed draws in PyTorch: ``x (C, p)``,
    ``S0 (C, v, v)``, ``dS0/rt (C, v)``, ``base (C,)``, ``dx (C, S, p)``,
    ``logu (C, S)``; constants ``K (1+nk, v)``, ``sel (v,)``,
    ``specs (3, p)``, or grouped, chains ``(G, C, ...)`` with ``K
    (G, 1+nk, v)``, ``sel (G, v)``, ``specs (G, 3, p)``. ``factor`` factors
    each proposal's equilibrated matrix: the plain recurrence by default
    (the kernel's plain version), the ``chol_fused`` kernel on the closure
    path. Returns ``(x_new, acc_rate (C,))``."""
    K, sel, specs = (group_axes(K, 2, 1), group_axes(sel, 1, 1),
                     group_axes(specs, 2, 1))
    return mh_loop(
        lambda q: hyper_ll_lp(q, S0, dS0, rt, base, K, sel, specs, hyp_idx,
                              jitter, factor), x, dx, logu)


def hyper_mh(x, S0, dS0, rt, base, dx, logu, K, sel, specs, hyp_idx,
             jitter: float, per_block=None):
    """``(x_new, acc_rate)`` for the whole hyper MH block, one launch on a
    CUDA device (``v <=`` :func:`max_hyper_v`), the plain loop on the
    CPU. Shapes as in :func:`hyper_mh_loop`; every operand float32, or
    every one float64 (the float64 form, counted in ``launches_f64`` /
    ``launches_grouped_f64``), the constants on the same device (grouped
    as in :func:`hyper_mh_loop`), ``hyp_idx`` the static
    ``HyperConsts.hyp_idx``. ``per_block`` overrides :func:`launch_form`'s
    chains per block (0: the block form), for measurements."""
    out, launched = _hyper_mh("hyper_mh", x, S0, dS0, rt, base, dx, logu, K,
                              sel, specs, hyp_idx, jitter, per_block)
    suffix = "_f64" if x.dtype == torch.float64 else ""
    attr = ("launches_grouped" if K.dim() == 3 else "launches") + suffix
    setattr(hyper_mh, attr, getattr(hyper_mh, attr) + launched)
    return out


hyper_mh.launches = 0
hyper_mh.launches_grouped = 0
hyper_mh.launches_lanes = 0
hyper_mh.launches_f64 = 0
hyper_mh.launches_grouped_f64 = 0


def _hyper_mh(name, x, S0, dS0, rt, base, dx, logu, K, sel, specs, hyp_idx,
              jitter, per_block=None):
    """``((x_new, acc_rate), launches)`` of one hyper block call: the plain
    loop on the CPU, one launch of the hyper kernel on a CUDA device."""
    from gibbs_student_t_tpu_torch.ops import _cuda

    ops_ = (x, S0, dS0, rt, base, dx, logu, K, sel, specs)
    dtype = _cuda.check_float_dtype(name, ops_)
    for t in ops_:
        if t.device != x.device:
            raise ValueError(f"{name}: operands on different devices")
    B, p = tuple(x.shape[:-1]), x.shape[-1]
    v = S0.shape[-1]
    S = dx.shape[-2]
    nk = len(hyp_idx)
    groups = B[:1] if K.dim() == 3 else ()
    if (len(B) != 1 + len(groups) or S0.shape != (*B, v, v)
            or dS0.shape != (*B, v) or rt.shape != (*B, v)
            or base.shape != B or dx.shape != (*B, S, p)
            or logu.shape != (*B, S) or K.shape != (*groups, 1 + nk, v)
            or sel.shape != (*groups, v) or specs.shape != (*groups, 3, p)):
        raise ValueError(f"{name}: inconsistent operand shapes")
    check_per_block(name, per_block, v, HYPER_WARP_MAX_V,
                    warp_bytes(min(v, HYPER_WARP_MAX_V), p, nk, dtype))
    kname = name + "_grouped" if groups and name == "hyper_mh" else name

    if not _cuda.use_kernel(x, name):
        note_kernel(kname, "plain", (*B, v, p))
        return hyper_mh_loop(x, S0, dS0, rt, base, dx, logu, K, sel, specs,
                             hyp_idx, jitter), 0
    if dtype == torch.float64 and name != "hyper_mh":
        _cuda.refuse_float64(name, "the lanes entry")
    vmax = max_hyper_v(dtype)
    if v > vmax or nk > MAX_HYPER_K:
        raise ValueError(f"{name}: v = {v} / nk = {nk} exceed the "
                         f"kernel bounds ({vmax}, {MAX_HYPER_K})")

    ops = [t.contiguous() for t in (x, S0, dS0, rt, base, dx, logu, K, sel,
                                    specs)]
    xo = torch.empty_like(ops[0])
    acc = torch.empty(B, dtype=x.dtype, device=x.device)
    hi = _cuda.host_ints(hyp_idx)
    C = math.prod(B)
    if C:
        if per_block is None:
            form, per_block = launch_form(C, v, dtype, p, nk)
            per_block = per_block if form == "warp" else 0
        note_kernel(kname, "cuda", (*B, v, p), lambda: {
            "form": "warp" if per_block else "block",
            "per_block": per_block})
        _cuda.launch(_cuda.entry_of("hyper_mh", dtype), x.device,
                     *(_cuda.ptr(t) for t in ops),
                     _cuda.addr(hi), nk, _cuda.ptr(xo), _cuda.ptr(acc), C,
                     B[-1], v, p, S, float(jitter), per_block, what=name)
    return (xo, acc), int(C > 0)


def _hyper_lanes_operands(x, S0, dS0, rt, base, dx, logu, K, sel, specs,
                          gid):
    """The lanes entry's operands as the grouped block takes them: the
    per-lane ones as ``(B/16, 16, ...)`` tiles, the constants of each
    tile's first lane ``(B/16, ...)``."""
    lead = lead_dims(x, 1, "hyper_mh_lanes")
    check_lanes_gid(flat_lanes(x, lead), gid, "hyper_mh_lanes")
    ops = [lane_tiles(t, lead) for t in (x, S0, dS0, rt, base, dx, logu)]
    consts = [lane_tiles(t, lead)[:, 0] for t in (K, sel, specs)]
    return ops + consts


def hyper_mh_lanes_plain(x, S0, dS0, rt, base, dx, logu, K, sel, specs, gid,
                         hyp_idx, jitter: float):
    """The plain version of :func:`hyper_mh_lanes`: the grouped plain loop
    on the tiles, one row of constants per tile."""
    ops = _hyper_lanes_operands(x, S0, dS0, rt, base, dx, logu, K, sel,
                                specs, gid)
    xo, acc = hyper_mh_loop(*ops, hyp_idx, jitter)
    return xo.reshape(x.shape), acc.reshape(x.shape[:-1])


def hyper_mh_lanes(x, S0, dS0, rt, base, dx, logu, K, sel, specs, gid,
                   hyp_idx, jitter: float):
    """The serving slot pool's hyper MH block (the Pallas core of the JAX
    package's ``linalg.py::_fused_hyper_lanes_dispatcher``): per-lane
    operands ``x (B, p)``, ``S0 (B, v, v)``, ``dS0/rt (B, v)``, ``base
    (B,)``, ``dx (B, S, p)``, ``logu (B, S)`` and per-lane constants ``K
    (B, 1 + nk, v)``, ``sel (B, v)``, ``specs (B, 3, p)``, each with its
    lanes flat or as ``(B/16, 16, ...)`` tiles, under the tile-uniform
    ``gid (B,)`` contract (``ops/lanes.py``). One row of constants per
    16-lane tile is read, and the block is one grouped launch of the hyper
    kernel with the 16 lanes of a tile as one group's chains, counted on
    ``hyper_mh.launches_lanes``; on the CPU, :func:`hyper_mh_lanes_plain`.
    Returns ``(x_new, acc_rate)`` in ``x``'s layout."""
    ops = _hyper_lanes_operands(x, S0, dS0, rt, base, dx, logu, K, sel,
                                specs, gid)
    (xo, acc), launched = _hyper_mh("hyper_mh_lanes", *ops, hyp_idx, jitter)
    hyper_mh.launches_lanes += launched
    return xo.reshape(x.shape), acc.reshape(x.shape[:-1])
