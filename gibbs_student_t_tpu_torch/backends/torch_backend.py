"""The many-chain Gibbs sampler in PyTorch: ``TorchGibbs``.

Counterpart of ``gibbs_student_t_tpu/backends/jax_backend.py::JaxGibbs``
(the solo sampler). Chains are a leading batch axis of every tensor; one
sweep is the reference's blocked Metropolis-within-Gibbs scan (reference
gibbs.py:342-385)::

    white MH -> TNT/d -> Schur elimination -> hyper MH -> b draw
             -> theta -> z -> alpha -> df (-> Robbins-Monro adaptation)

The white and hyper MH blocks each run as one kernel launch
(ops/white_mh.py, ops/hyper_mh.py), the factorizations and vector
back-substitutions go to the chol kernels (ops/chol.py, via
ops/linalg.py), the TOA-blocked TNT reduction of large pulsars (the
1e5-TOA stress path) to the Gram kernel (ops/tnt.py), and the rest is
plain PyTorch. Under multiple-try Metropolis (``MHConfig.mtm_tries``) the
white block runs as one launch of the white MTM kernel and the hyper
block as the MTM loop over stacked factorizations through the chol
kernel.

A sweep is split into ``draws = self._draw(keys, sweep, state)``, which
makes every random number the sweep needs, and a deterministic ``state =
self._sweep(state, draws, sweep)``, so tests can feed both this sampler
and the JAX stages the same numbers. Two draws depend on values the sweep
itself produces, and are drawn for both outcomes: the alpha update's
Gamma((z + df)/2) comes as a pair of gammas (for z = 0 and z = 1)
selected by the new z, and the z and df draws are a uniform and Gumbel
noise the sweep compares against. ``jax.random`` streams are not
reproduced: the two samplers agree in law, not bitwise.

The draws are keyed per chain, as the JAX backend keys chain k with
``random.split(PRNGKey(seed), nchains)[k]`` and folds the sweep index in
each sweep: ``keys`` holds each chain's Philox key words
(``ops/rng.chain_key(seed, k)``, built once a run), ``sweep`` is the sweep
index as a device tensor, and every number is one Philox block at
counters (element, attempt, field tag, sweep) under the chain's key
(ops/rng.py). One launch of the draw kernel (``ops/rng.sweep_draws``, D1)
writes every field; the glue here turns its uniforms into the scale
mixture's step sizes and coordinate picks, scatters the jumps and takes
``L @ xi`` for covariance proposals. So chain k's numbers depend only on
(seed, k, sweep): not on the chunk a sweep falls in, nor on
``start_sweep``, ``nchains`` or the chain's position in the batch, and a
card run and a CPU run of one seed draw the same numbers (to a float64
ulp of libm). N sweeps and N more from ``last_state`` at
``start_sweep=N`` are the 2N unbroken sweeps.

The stages are written over a leading batch shape: ``(C,)`` chains of
one model here, ``(P, C)`` pulsars x chains in the ensemble
(parallel/ensemble.py), whose model tensors carry a leading pulsar axis
and broadcast against the state as ``(P, 1, ...)``.

The chunked loop follows ``JaxGibbs.sample``: records stay on the
device for a chunk and cross to the host in narrow wire dtypes
(``record="compact8"`` by default), every ``record_thin``-th sweep is
recorded, the in-run telemetry (obs/telemetry.py) rides each chunk,
numerically dead chains can be re-drawn at chunk boundaries
(``reinit_diverged``), and ``sample_until`` samples until split-R-hat
(and optionally ESS) clears a target.

Entry points run on the GPU: ``device=None`` means ``"cuda"`` and raises
when CUDA is absent; pass ``device="cpu"`` to run the kernels' plain
versions (the tests do).
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from gibbs_student_t_tpu_torch.backends.base import (
    META_STATS,
    ChainResult,
    SamplerBackend,
)
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.models.pta import (
    ConstBlock,
    EcorrBlock,
    ImproperBlock,
    ModelArrays,
    PowerlawBlock,
    static_phi_columns,
)
from gibbs_student_t_tpu_torch.models.signals import FYR
from gibbs_student_t_tpu_torch.obs.telemetry import (
    Telemetry,
    TelemetryAccumulator,
    combine_tele_stats,
    state_bad,
    telemetry_init,
    telemetry_update,
)
from gibbs_student_t_tpu_torch.obs.tracing import block_span, host_span
from gibbs_student_t_tpu_torch.ops import rng
from gibbs_student_t_tpu_torch.ops.chol import chol_fused
from gibbs_student_t_tpu_torch.ops.hyper_mh import (
    MAX_HYPER_V,
    build_hyper_consts,
    hyper_ll_lp,
    hyper_mh,
    hyper_mh_loop,
)
from gibbs_student_t_tpu_torch.ops.linalg import (
    backward_solve,
    precond_quad_logdet,
    robust_precond_draw,
    schur_eliminate,
)
from gibbs_student_t_tpu_torch.ops.rng import sweep_draws
from gibbs_student_t_tpu_torch.ops.tnt import (
    auto_block_size,
    matvec_blocked,
    pad_rows,
    tnt_batched,
    tnt_products,
)
from gibbs_student_t_tpu_torch.ops.white_mh import (
    build_white_consts,
    group_axes,
    lnprior_sum,
    mtm_loop,
    white_mh,
    white_mtm,
)

LN10 = float(np.log(10.0))

_RECORD_FIELDS = ("x", "b", "z", "theta", "alpha", "df", "pout",
                  "acc_white", "acc_hyper")
#: record="light": the O(1)-per-sweep fields only (at the 1e5-TOA stress
#: shape the per-TOA z, alpha and pout dominate the device-to-host bytes)
_LIGHT_FIELDS = ("x", "theta", "df", "acc_white", "acc_hyper")

# The systematic-scan block order of ``_sweep`` (white x, hyper x, b,
# theta, z, alpha, df) splits the recorded fields at the partial-scan point
# after the coefficient draw: a mid-scan state holds the new values of the
# fields the scan has updated and the old values of the rest. Recycling
# Gibbs (parallel/recycle.py) rebuilds those states from adjacent recorded
# rows by these two groups (the JAX backend's, pinned equal in
# tests/test_torch_recycle.py).
RECYCLE_EARLY_FIELDS = ("x", "b", "acc_white", "acc_hyper")
RECYCLE_LATE_FIELDS = ("z", "theta", "alpha", "df", "pout")

# Adaptive block scans (serve/adapt.py): the indices into ``_sweep``'s
# per-chain block-enable operand, one per conditional block in the scan
# order above (the JAX backend's). The b draw's effective gate is tied to
# the hyper gate (``BLOCK_HYPER & BLOCK_B``): b is drawn conditioned on the
# proposed hyper x, so a kept b under a discarded x would condition on a
# value the chain never took.
BLOCK_WHITE, BLOCK_HYPER, BLOCK_B = 0, 1, 2
BLOCK_THETA, BLOCK_Z, BLOCK_ALPHA, BLOCK_DF = 3, 4, 5, 6
NBLOCKS = 7
BLOCK_NAMES = ("white", "hyper", "b", "theta", "z", "alpha", "df")

# record="compact": device->host transport dtypes for the bulky recorded
# fields (jax_backend.py's ``_COMPACT_CASTS``). z is exactly 0/1 so it is
# bit-packed (8 indicators per byte, lossless); pout is a probability
# (float16 keeps ~3 decimal digits); b/alpha need float32 *range* (alpha
# spans many decades) so bfloat16. Host arrays are float32 again: the
# narrow dtypes exist only between the device and the host.
_PACKBITS = "packbits"
_U8PROB = "u8prob"

_COMPACT_CASTS = {"z": _PACKBITS, "pout": torch.float16,
                  "b": torch.bfloat16, "alpha": torch.bfloat16}

# record="compact8": compact plus pout quantized to uint8 (levels of
# 1/255), the JAX package's default tier
_COMPACT8_CASTS = dict(_COMPACT_CASTS, pout=_U8PROB)

_BIT_WEIGHTS = tuple(1 << k for k in range(8))


def _pack_bits(a):
    """Little-endian bit-pack a 0/1 tensor along its last axis: (..., n)
    -> (..., ceil(n/8)) uint8, in int32 arithmetic (CUDA has no uint32
    sum). Lossless for the z indicator chains; the host restores them
    with :func:`_unpack_bits`. A NaN indicator (a dead chain) has no
    defined integer value, here as in the JAX package."""
    n = a.shape[-1]
    pad = (-n) % 8
    b = a.to(torch.int32)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(*b.shape[:-1], (n + pad) // 8, 8)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=a.device)
    return (b * w).sum(-1, dtype=torch.int32).to(torch.uint8)


def _unpack_bits(h, n):
    """Host-side inverse of ``_pack_bits``: (..., ceil(n/8)) uint8 ->
    (..., n) float32 of exact 0/1 values."""
    bits = np.unpackbits(np.asarray(h, np.uint8), axis=-1,
                         bitorder="little")
    return bits[..., :n].astype(np.float32)


def record_tuple(st, fields, casts):
    """Records in wire dtypes: ``getattr(st, f)`` for each field, cast on
    the device by ``casts`` (``_COMPACT_CASTS`` / ``_COMPACT8_CASTS``, or
    empty). Shared by ``TorchGibbs`` and the ensemble, which applies it
    to a chunk's stacked rows: the casts are elementwise, so casting the
    stacked chunk once gives each row's bits and costs a launch a chunk
    instead of one a sweep. Rounding as ``astype`` in the JAX package:
    to nearest even; uint8 pout as ``clamp(round(v * 255), 0, 255)``
    (``torch.round`` rounds half to even, as ``jnp.round``); a NaN pout
    has no defined uint8, on either side."""
    out = []
    for f in fields:
        v = getattr(st, f)
        c = casts.get(f) if casts else None
        if c is _PACKBITS:
            v = _pack_bits(v)
        elif c is _U8PROB:
            v = torch.clamp(torch.round(v * 255.0), 0, 255).to(torch.uint8)
        elif c is not None:
            v = v.to(c)
        out.append(v)
    return tuple(out)


class _HostCopy:
    """Tensors on their way to the host: on a CUDA device, copied with
    ``non_blocking=True`` into pinned host memory on ``stream`` (ordered
    after the work that produced them: the event ``after``, recorded
    where that work was issued, or else everything issued so far on the
    calling thread's current stream), with an event recorded after the
    copies; on the CPU they are the host tensors already. :meth:`wait`
    returns the host tensors once the copy is complete. The device
    tensors are held until then, so their memory is not reused while
    the copy reads it."""

    def __init__(self, tensors, stream=None, after=None):
        self._src, self._event = list(tensors), None
        if stream is None:
            self._host = self._src
            return
        if after is not None:
            stream.wait_event(after)
        else:
            stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            self._host = [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                    t, non_blocking=True) for t in self._src]
            self._event = torch.cuda.Event()
            self._event.record(stream)

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
        self._src = None
        return self._host


def chunked_sweep_loop(state, niter, chunk_size, start_sweep,
                       step_fn, flush_fn, reinit_fn=None, n_reinits=0,
                       pre_chunk_fn=None, pre_chunk_until=0):
    """The chunk-orchestration loop shared by ``TorchGibbs`` and
    ``EnsembleGibbs`` (the JAX package's ``chunked_sweep_loop``).

    ``step_fn(state, offset, length) -> (state, recs)`` advances one
    chunk; ``flush_fn(recs, chunk_state, sweep_end, n_reinits)`` moves a
    chunk's records to the host (to memory or to a spool);
    ``reinit_fn(state, sweep_end) -> (state, n_bad)``, when given, repairs
    diverged chains at each chunk boundary, counting from ``n_reinits``.
    ``pre_chunk_fn(state) -> state``, when given, runs before each chunk
    whose offset is below ``pre_chunk_until`` (the population-covariance
    re-estimation, MHConfig.adapt_cov). Without ``reinit_fn`` flushes are
    deferred: chunk k+1's sweeps are issued before chunk k's records are
    read, so the pull overlaps the next chunk's work. With it, flushes
    are sequential (the divergence scan needs each post-chunk state).
    The JAX loop's ``snapshot_fn`` (a copy of a deferred flush's state
    before donated buffers are reused) has no counterpart: no sweep
    writes a state tensor in place, and a spooled run's chunk-end state
    rides the chunk's own host copy (``TorchGibbs._run``). Returns
    ``(state, n_reinits)``."""
    done = 0
    pending = None
    while done < niter:
        length = min(chunk_size, niter - done)
        if pre_chunk_fn is not None and start_sweep + done < pre_chunk_until:
            state = pre_chunk_fn(state)
        state, recs = step_fn(state, start_sweep + done, length)
        done += length
        if reinit_fn is not None:
            state, n_bad = reinit_fn(state, start_sweep + done)
            n_reinits += n_bad
            flush_fn(recs, state, start_sweep + done, n_reinits)
        else:
            if pending is not None:
                flush_fn(*pending, n_reinits)
            pending = (recs, state, start_sweep + done)
    if pending is not None:
        flush_fn(*pending, n_reinits)
    return state, n_reinits


def _ess_per_param(window):
    """(p,) total effective sample size per parameter over a
    (rows, nchains, p) window (all chains pooled)."""
    from gibbs_student_t_tpu_torch.parallel.diagnostics import ess_per_param

    return ess_per_param(window)


def _rhat_per_param(window):
    """(p,) split-R-hat per parameter over a (rows, nchains, p) window."""
    from gibbs_student_t_tpu_torch.parallel.diagnostics import split_rhat

    return np.array([split_rhat(window[..., pi])
                     for pi in range(window.shape[-1])])


def _sample_until_loop(sample_fn, last_state_fn, record_thin, rhat_of,
                       rhat_target, max_sweeps, check_every, min_sweeps,
                       state, spool_mode=False, ess_of=None, min_ess=None):
    """The convergence-stopping loop behind ``TorchGibbs.sample_until``
    and ``EnsembleGibbs.sample_until`` (the JAX package's
    ``_sample_until_loop``): segments of ``check_every`` sweeps until
    ``rhat_of`` (computed on the second half of the accumulated rows)
    clears ``rhat_target`` everywhere, and (when ``min_ess`` is set)
    ``ess_of`` reports at least ``min_ess`` effective samples for EVERY
    parameter in the same window.

    ``sample_fn(length, state, start_sweep) -> ChainResult`` runs one
    segment. In ``spool_mode`` every segment appends to one spool and its
    result is the reloaded full history (utils/spool.py), so only the
    latest is kept, with its cumulative counters; otherwise segments are
    concatenated, with per-call ``n_reinits`` summed. Either way the
    ``tele_*`` stats of the segments are merged by
    ``combine_tele_stats``."""
    if check_every % record_thin or (check_every // record_thin) < 8:
        raise ValueError(
            "check_every must be a multiple of record_thin covering "
            ">= 8 recorded rows, or the split-R-hat window degenerates"
            f" (got {check_every} at record_thin={record_thin})")
    if max_sweeps < 1:
        raise ValueError(f"max_sweeps must be >= 1, got {max_sweeps}")
    if max_sweeps % record_thin:
        # fail now, not at the final partial segment after hours of work
        raise ValueError(
            f"max_sweeps ({max_sweeps}) must be a multiple of "
            f"record_thin ({record_thin})")
    segments = []
    history = []
    ess_history = []
    tele_segs = []  # per-segment tele_* stats (sweep-weighted merge below)
    done = 0
    converged = False

    def window_of(segs, total_rows):
        """Rows [total_rows//2:] without re-concatenating the full
        history every check (only the tail segments that overlap)."""
        start = total_rows // 2
        out, r0 = [], 0
        for s in segs:
            r1 = r0 + s.shape[0]
            if r1 > start:
                out.append(s[max(0, start - r0):])
            r0 = r1
        return np.concatenate(out)

    res = None
    while done < max_sweeps:
        length = min(check_every, max_sweeps - done)
        res = sample_fn(length, state, done)
        state = last_state_fn()
        done += length
        tele_segs.append({k: v for k, v in res.stats.items()
                          if k.startswith("tele_")})
        # second half of the accumulated run: the usual split-R-hat
        # convention folds early-transient sweeps out of the window
        if spool_mode:
            window = res.chain[res.chain.shape[0] // 2:]
        else:
            segments.append(res)
            total_rows = sum(s.chain.shape[0] for s in segments)
            window = window_of([s.chain for s in segments], total_rows)
        rhat = rhat_of(window)
        history.append(rhat)
        ess = None
        if min_ess is not None:
            ess = ess_of(window)
            ess_history.append(ess)
        if done >= max(min_sweeps, 2 * check_every) and (
                rhat < rhat_target).all() and (
                min_ess is None or (ess >= min_ess).all()):
            converged = True
            break
    if spool_mode:
        out = res  # already the full history, cumulative counters
    else:
        cols = {}
        for f in dataclasses.fields(ChainResult):
            if f.name == "stats":
                continue
            arrs = [getattr(s, f.name) for s in segments]
            cols[f.name] = (np.concatenate(arrs) if arrs[0].size
                            else arrs[0])
        stats = {}
        for k in segments[0].stats:
            v0 = segments[0].stats[k]
            if k.startswith("tele_"):
                continue  # merged below with sweep-count weighting
            if k == "n_reinits":
                # per-call counters: the run's total is the sum
                stats[k] = np.asarray(sum(int(s.stats[k])
                                          for s in segments))
            elif k in META_STATS or np.ndim(v0) == 0:
                stats[k] = v0
            else:
                stats[k] = np.concatenate([s.stats[k] for s in segments])
        out = ChainResult(**cols, stats=stats)
    # a spooled segment's tele_* stats cover only that call's chunks, so
    # the merge is the same in both modes
    out.stats.update(combine_tele_stats(tele_segs))
    out.stats["rhat_history"] = np.stack(history)
    out.stats["rhat"] = history[-1]
    if ess_history:
        out.stats["ess_history"] = np.stack(ess_history)
        out.stats["ess"] = ess_history[-1]
    out.stats["converged"] = np.asarray(converged)
    return out


def merge_reinit(state, bad, fresh, batch_ndim: int):
    """Replace the ``bad``-masked entries of ``state`` (a bool of its
    ``batch_ndim`` leading batch axes) with ``fresh`` draws; healthy
    entries stay bitwise identical.

    The adapted MH jump scales (and population-covariance proposal
    factors) survive re-init: a chain diverges in its x/b/alpha state,
    not its (bounded) step sizes, and Robbins-Monro may already be
    frozen — a zeroed scale would silently run the rest of the sampling
    un-adapted."""
    fresh = fresh._replace(mh_log_scale=state.mh_log_scale,
                           mh_cov_chol=state.mh_cov_chol)
    mask = torch.as_tensor(np.asarray(bad, bool), device=state.x.device)
    return type(state)(*(
        torch.where(mask.reshape(mask.shape + (1,) * (cur.dim()
                                                      - batch_ndim)),
                    fr, cur)
        for cur, fr in zip(state, fresh)))


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises (the port
    never falls back to the CPU on its own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TorchGibbs runs on a CUDA device and CUDA is not available "
            "here; pass device='cpu' to run the kernels' plain versions")
    return dev


def _lift(v):
    """A per-model constant as an operand of per-column ``(..., w)``
    arithmetic: a number as it is, a ``(P, 1)`` tensor of per-pulsar
    values as ``(P, 1, 1)``."""
    return v[..., None] if torch.is_tensor(v) else v


def _fill(x0, c):
    """``c`` broadcast to ``x0``'s shape: a number (one model's constant)
    or a ``(P, 1)`` tensor of per-pulsar constants."""
    return c.expand_as(x0) if torch.is_tensor(c) else torch.full_like(
        x0, float(c))


class ChainState(NamedTuple):
    """Batched sampler state, leading axis = chains (``(P, C)`` leading
    axes in the ensemble; shapes below are the solo sampler's)."""

    x: torch.Tensor             # (C, p) sampled parameters
    b: torch.Tensor             # (C, m) basis coefficients
    z: torch.Tensor             # (C, n) outlier indicators
    alpha: torch.Tensor         # (C, n) variance scales
    theta: torch.Tensor         # (C,) outlier fraction
    df: torch.Tensor            # (C,) Student-t dof
    pout: torch.Tensor          # (C, n) outlier probabilities
    acc_white: torch.Tensor     # (C,) last-sweep acceptance rates
    acc_hyper: torch.Tensor     # (C,)
    mh_log_scale: torch.Tensor  # (C, 2) log jump scales [white, hyper]
    mh_cov_chol: torch.Tensor   # (C, 2, p, p) proposal factors, or (C, 0)


class SweepDraws(NamedTuple):
    """Every random number of one sweep (see the module docstring). A block
    under multiple-try Metropolis (K tries) has ``dx`` of shape
    ``(C, S, K, p)`` and its ``dxr``/``gumb`` fields set; otherwise those
    are empty ``(C, 0)``."""

    dx_w: torch.Tensor      # (C, Sw, p) white jumps
    logu_w: torch.Tensor    # (C, Sw) white log-uniform accept draws
    dx_h: torch.Tensor      # (C, Sh, p) hyper jumps
    logu_h: torch.Tensor    # (C, Sh)
    xi: torch.Tensor        # (C, m) standard normals of the b draw
    g_theta: torch.Tensor   # (C, 2) Gamma(a), Gamma(b) of the theta Beta
    u_z: torch.Tensor       # (C, n) uniforms of the z Bernoulli
    g_alpha: torch.Tensor   # (C, 2, n) Gamma(df/2), Gamma((1+df)/2)
    gumbel_df: torch.Tensor  # (C, df_max) Gumbel noise of the df draw
    dxr_w: Optional[torch.Tensor] = None  # (C, Sw, K-1, p) MTM references
    gumb_w: Optional[torch.Tensor] = None  # (C, Sw, K) MTM selection noise
    dxr_h: Optional[torch.Tensor] = None  # (C, Sh, K-1, p)
    gumb_h: Optional[torch.Tensor] = None  # (C, Sh, K)


class TorchGibbs(SamplerBackend):
    """Many-chain Gibbs sampler; ``sample`` returns ``(niter, nchains, ...)``
    chains in float32.

    The path is the JAX backend's float32 one with its fused MH blocks:
    the Schur split of the phi-static columns when at least 8 exist,
    b-draw block-factor reuse on that path, population-covariance
    proposals, Robbins-Monro adaptation and multiple-try Metropolis when
    the config asks for them.

    ``tnt_block_size`` selects the TOA reduction as in ``JaxGibbs``:
    ``None`` dense, an int for the TOA-blocked reduction (the TOA axis
    zero-padded to a multiple of it; on the GPU one launch of the Gram
    kernel), ``"auto"`` dense below 16384 TOAs and blocks of 4096 above.

    ``record`` picks the recording tier, as in ``JaxGibbs``:
    ``"compact8"`` (the default) records every field but moves the bulky
    ones to the host in narrow wire dtypes, cast on the device — z
    bit-packed 8 to a byte (exact), pout as uint8 (steps of 1/255), b and
    alpha as bfloat16 — and hands back float32 host arrays; ``"compact"``
    keeps pout at float16; ``"full"`` moves everything in float32, bit
    for bit; ``"light"`` records only x, theta, df and the acceptance
    rates (the other chains come back empty). x, theta, df, z and the
    acceptance rates are exact in every tier. ``record_thin=t`` records
    the state before sweeps 0, t, 2t, ...: every sweep still runs with its
    own key, so row k of a thinned run is bitwise row k·t of an unthinned
    one; ``chunk_size`` (sweeps a chunk: records move to the host, and
    population-covariance proposals are re-estimated, at chunk
    boundaries) must be a multiple of t.

    ``telemetry`` (default on) carries the in-run ``Telemetry`` counters
    through each chunk (obs/telemetry.py): per-block accept sums, the
    per-chain non-finite counters and the chunk-end log-posterior, pulled
    with the records; run-level aggregates land in ``ChainResult.stats``
    under ``tele_*`` keys. Updates draw no random number: chains are
    bitwise the same either way. ``metrics`` (an
    ``obs.metrics.MetricsRegistry``) receives one ``chunk`` event per
    flushed chunk of a telemetry-on run
    (``TelemetryAccumulator.emit_chunk``)."""

    supports_chains = True

    def __init__(self, ma: ModelArrays, config: GibbsConfig,
                 nchains: int = 64, device=None, chunk_size: int = 100,
                 tnt_block_size: int | str | None = "auto",
                 record: str = "compact8", record_thin: int = 1,
                 telemetry: bool = True, metrics=None):
        super().__init__(ma, config)
        if record not in ("full", "compact", "compact8", "light"):
            raise ValueError("record must be 'full', 'compact', "
                             f"'compact8' or 'light', got {record!r}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if record_thin < 1:
            raise ValueError(f"record_thin must be >= 1, got {record_thin}")
        if chunk_size % record_thin:
            raise ValueError(
                f"chunk_size ({chunk_size}) must be a multiple of "
                f"record_thin ({record_thin}) so chunk boundaries land "
                "on recorded sweeps")
        self.record_mode = record
        self.chunk_size = int(chunk_size)
        self.record_thin = int(record_thin)
        self.telemetry = bool(telemetry)
        self.metrics = metrics
        self._record_fields = (_LIGHT_FIELDS if record == "light"
                               else _RECORD_FIELDS)
        # the port runs float32 only, so the wire casts are always active
        self._record_casts = {"compact": _COMPACT_CASTS,
                              "compact8": _COMPACT8_CASTS}.get(record, {})
        self._pull_stream = None
        mh = config.mh
        self._mtm = {blk: mh.mtm_tries >= 2 and blk in mh.mtm_blocks
                     for blk in ("white", "hyper")}
        self.device = resolve_device(device)
        self.nchains = int(nchains)
        self.dtype = torch.float32
        dev, f32 = self.device, torch.float32

        def t(a, dtype=f32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        if tnt_block_size == "auto":
            tnt_block_size = auto_block_size(ma.n)
        self._block_size = tnt_block_size
        base_mask = None
        self._n_real = ma.n
        if ma.row_mask is not None:
            base_mask = np.asarray(ma.row_mask, dtype=bool)
            self._n_real = int(base_mask.sum())
            if not base_mask[:self._n_real].all():
                raise ValueError("ModelArrays.row_mask must be suffix padding")
        y, T, sigma2 = ma.y, ma.T, ma.sigma2
        efac_masks, equad_masks = ma.efac_masks, ma.equad_masks
        n_pad = 0
        if tnt_block_size is not None:
            T, y, n_pad = pad_rows(np.asarray(T), np.asarray(y),
                                   tnt_block_size)
            if n_pad:
                sigma2 = np.concatenate([sigma2, np.zeros(n_pad)])
                efac_masks = np.concatenate(
                    [efac_masks, np.zeros((efac_masks.shape[0], n_pad))], 1)
                equad_masks = np.concatenate(
                    [equad_masks, np.zeros((equad_masks.shape[0], n_pad))], 1)
        self._ma = dataclasses.replace(
            ma, y=np.asarray(y, np.float32), T=np.asarray(T, np.float32),
            sigma2=np.asarray(sigma2, np.float32),
            efac_masks=np.asarray(efac_masks, np.float32),
            efac_const=np.asarray(ma.efac_const, np.float32),
            equad_masks=np.asarray(equad_masks, np.float32),
            equad_const=np.asarray(ma.equad_const, np.float32),
            row_mask=None)
        self._n = self._ma.n
        if base_mask is None and not n_pad:
            row_mask = None
        else:
            bm = base_mask if base_mask is not None else np.ones(ma.n, bool)
            row_mask = np.concatenate([bm, np.zeros(n_pad, bool)])
        self._mask = None if row_mask is None else t(row_mask, torch.bool)

        mm = self._ma
        self._y, self._T = t(mm.y), t(mm.T)
        self._sigma2 = t(mm.sigma2)
        self._efac_masks, self._equad_masks = (t(mm.efac_masks),
                                               t(mm.equad_masks))

        # Schur pre-elimination of the phi-static columns (the JAX
        # backend's hyper_schur="auto" rule: at least 8 of them): exact
        # block algebra, the per-proposal factorization shrinks to the
        # varying columns.
        smask = static_phi_columns(mm)
        n_static = int(smask.sum())
        self._schur = ((np.flatnonzero(smask), np.flatnonzero(~smask))
                       if 8 <= n_static < mm.m else None)
        if self._schur is not None:
            self._s_i = t(self._schur[0], torch.long)
            self._v_i = t(self._schur[1], torch.long)

        self._white = None
        if len(mm.white_indices):
            wc = build_white_consts(mm, row_mask)
            self._white = (t(wc.rows), t(wc.specs), wc.var)
        self._hyper = None
        if len(mm.hyper_indices):
            cols = (self._schur[1] if self._schur is not None
                    else np.arange(mm.m))
            hc = build_hyper_consts(mm, cols)
            self._hyper = dict(K=t(hc.K), sel=t(hc.phi_sel),
                               specs=t(hc.specs),
                               phiinv_static=t(hc.phiinv_static),
                               logdet_static=float(hc.logdet_phi_static),
                               hyp_idx=hc.hyp_idx,
                               fused=len(cols) <= MAX_HYPER_V)
        # per phi block, its model constants: a const block's phi, a
        # powerlaw block's log frequencies, log df and pinned values, an
        # ecorr block's column groups and pinned values (numbers here;
        # (P, 1, ...) tensors in the ensemble)
        self._phi_consts = []
        for blk in mm.phi_blocks:
            if isinstance(blk, ConstBlock):
                const = {"phi": t(blk.phi)}
            elif isinstance(blk, PowerlawBlock):
                const = {"logf": torch.log(t(blk.freqs)),
                         "logdf": math.log(float(blk.df)),
                         "log10A": float(blk.const_log10A),
                         "gamma": float(blk.const_gamma)}
            elif isinstance(blk, EcorrBlock):
                const = {"group": t(blk.col_group, torch.long),
                         "const": [float(c) for c in blk.const]}
            elif isinstance(blk, ImproperBlock):
                const = {}
            else:
                raise TypeError(f"unknown phi block {type(blk)}")
            self._phi_consts.append((blk, const))
        # the prior table (kind, a, b) x p of the log-posterior's lnprior
        # (a (P, 3, p) stack in the ensemble)
        self._prior_specs = t(np.asarray(mm.prior_specs)[:, :3].T)
        self._efac_c = [float(c) for c in mm.efac_const]
        self._equad_c = [float(c) for c in mm.equad_const]
        # the statistical TOA count and the theta prior's pseudo-counts
        # (numbers here; (P, 1) tensors in the ensemble)
        self._nstat = float(self._n_real)
        if config.theta_prior == "beta":
            self._theta_prior = (self._nstat * config.outlier_mean,
                                 self._nstat * (1.0 - config.outlier_mean))
        else:
            self._theta_prior = (1.0, 1.0)
        self._batch = (self.nchains,)
        self._pspin = (config.pspin * ma.time_scale
                       if config.pspin is not None else 1.0)
        self._scale_sizes = t(mh.scale_sizes)
        self._scale_cdf = t(np.cumsum(np.asarray(mh.scale_probs)) /
                            np.sum(mh.scale_probs))
        self._white_idx = t(mm.white_indices, torch.long)
        self._hyper_idx = t(mm.hyper_indices, torch.long)
        self._df_grid = torch.arange(1, config.df_max + 1, dtype=f32,
                                     device=dev)
        self._table = self._draw_table()
        self.last_state: Optional[ChainState] = None

    # ------------------------------------------------------------------
    # model functions on the device (models/pta.py ndiag / phiinv_logdet,
    # batched over chains)
    # ------------------------------------------------------------------

    def _pvals(self, x, idxs, consts):
        """(..., G) parameter-or-constant values per group."""
        cols = [x[..., i] if i >= 0 else _fill(x[..., 0], c)
                for i, c in zip(idxs, consts)]
        return torch.stack(cols, dim=-1)

    def _ndiag(self, x):
        """White-noise variances Nvec0(x) (scaled), (..., p) -> (..., n)."""
        mm = self._ma
        ef = self._pvals(x, mm.efac_idx, self._efac_c)
        nv = ((ef[..., None] ** 2) * self._efac_masks
              * self._sigma2[..., None, :]).sum(-2)
        if len(mm.equad_idx):
            eq = self._pvals(x, mm.equad_idx, self._equad_c)
            # 10^(2 eq) as exp(2 ln10 eq), the white kernels' form: the
            # CPU's vectorized pow rounds some inputs otherwise than its
            # scalar loop, so a chain's variance would depend on its
            # position in the batch
            scaled = torch.exp(2.0 * LN10 * eq) * mm.time_scale ** 2
            nv = nv + (scaled[..., None] * self._equad_masks).sum(-2)
        return nv

    def _masked_nvec(self, x, az):
        nv = az * self._ndiag(x)
        return nv if self._mask is None else torch.where(self._mask, nv, 1.0)

    def _phiinv(self, x, logdet: bool = False):
        """Prior precision diag phi^-1(x), (..., p) -> (..., m) (scaled;
        models/pta.py ``phiinv_logdet``); with ``logdet``, the pair
        ``(phiinv, logdet phi)``, logdet of the batch shape."""
        batch = x.shape[:-1]
        s2 = self._ma.time_scale ** 2
        pieces, logdets = [], []
        for blk, k in self._phi_consts:
            if isinstance(blk, ImproperBlock):
                pieces.append(x.new_zeros(batch + (blk.stop - blk.start,)))
            elif isinstance(blk, ConstBlock):
                pieces.append((1.0 / k["phi"]).expand(*batch, -1))
                if logdet:
                    logdets.append(torch.log(k["phi"]).sum(-1))
            elif isinstance(blk, PowerlawBlock):
                la = (x[..., blk.idx_log10A] if blk.idx_log10A >= 0
                      else _fill(x[..., 0], k["log10A"]))
                ga = (x[..., blk.idx_gamma] if blk.idx_gamma >= 0
                      else _fill(x[..., 0], k["gamma"]))
                logphi = (2.0 * la[..., None] * LN10
                          - np.log(12.0 * np.pi ** 2)
                          + (ga[..., None] - 3.0) * np.log(FYR)
                          - ga[..., None] * k["logf"]
                          + _lift(k["logdf"]) + np.log(s2))
                pieces.append(torch.exp(-logphi))
                if logdet:
                    logdets.append(logphi.sum(-1))
            else:
                ec = self._pvals(x, blk.idx, k["const"])
                logphi = (2.0 * ec * LN10 + np.log(s2))[..., k["group"]]
                pieces.append(torch.exp(-logphi))
                if logdet:
                    logdets.append(logphi.sum(-1))
        phiinv = (torch.cat(pieces, dim=-1) if pieces
                  else x.new_zeros(batch + (0,)))
        if not logdet:
            return phiinv
        total = x.new_zeros(batch)
        for ld in logdets:
            total = total + ld
        return phiinv, total

    def _marginal_ll(self, x, az):
        """The marginalized log-likelihood of the hyper block at ``x
        (..., p)`` and ``alpha**z`` ``az (..., n)``, batch shape out (the
        JAX backend's ``lnlikelihood`` math): one TNT reduction and one
        factorization of the full ``(m, m)`` Sigma through the chol
        kernel."""
        nvec = self._masked_nvec(x, az)
        TNT, d, const_white = self._tnt(nvec)
        phiinv, logdet_phi = self._phiinv(x, logdet=True)
        Sigma = TNT + torch.diag_embed(phiinv)
        quad, logdet_sigma = precond_quad_logdet(Sigma, d, self.config.jitter)
        return const_white + 0.5 * (quad - logdet_sigma - logdet_phi)

    def _logpost_chain(self, state: ChainState) -> torch.Tensor:
        """Every chain's marginalized log-posterior at its current z and
        alpha (:meth:`_marginal_ll` plus the log-prior), -inf where it is
        not finite: the telemetry's chunk-end ``logpost`` (the JAX
        backend's ``_logpost_chain``, batched over the chains)."""
        lp = (self._marginal_ll(state.x, state.alpha ** state.z)
              + lnprior_sum(state.x, group_axes(self._prior_specs, 2, 1)))
        return torch.where(torch.isfinite(lp), lp, -math.inf)

    def lnlikelihood(self, x, z=None, alpha=None) -> float:
        """Single-point marginalized log-likelihood (the JAX backend's
        ``lnlikelihood``, for parity checks against the NumPy oracle): z
        defaults to zeros and alpha to ones over the real TOAs, both
        padded with (0, 1) over the padding rows; -inf where the value is
        not finite."""
        dev, f32 = self.device, self.dtype

        def vec(a, fill):
            a = (torch.full((self._n_real,), fill, dtype=f32, device=dev)
                 if a is None else torch.as_tensor(np.asarray(a, np.float32),
                                                   device=dev))
            pad = self._n - self._n_real
            if pad:
                a = torch.cat([a, torch.full((pad,), fill, dtype=f32,
                                             device=dev)])
            return a

        x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        z, alpha = vec(z, 0.0), vec(alpha, 1.0)
        ll = float(self._marginal_ll(x[None], (alpha ** z)[None])[0])
        return ll if math.isfinite(ll) else -math.inf

    # ------------------------------------------------------------------
    # state and draws
    # ------------------------------------------------------------------

    def init_state(self, x0: Optional[np.ndarray] = None,
                   seed: int = 0) -> ChainState:
        """Prior draws of x (numpy, from ``seed``) unless ``x0`` is given;
        z/alpha/theta/df at the reference's starting values."""
        mm, cfg = self._ma, self.config
        rng = np.random.default_rng(seed)
        if x0 is None:
            x0 = np.stack([mm.x_init(rng) for _ in range(self.nchains)])
        x0 = np.asarray(x0, dtype=np.float32)
        if x0.ndim == 1:
            x0 = np.broadcast_to(x0, (self.nchains, len(x0))).copy()
        n, m, c, p = self._n, mm.m, self.nchains, mm.nparam
        dev, f32 = self.device, self.dtype

        def full(shape, v):
            return torch.full(shape, float(v), dtype=f32, device=dev)

        z0 = full((c, n), 1.0 if cfg.z_init_ones else 0.0)
        alpha0 = full((c, n), 1.0 if cfg.vary_alpha else cfg.alpha)
        if self._mask is not None:
            z0 = torch.where(self._mask, z0, 0.0)
            alpha0 = torch.where(self._mask, alpha0, 1.0)
        if cfg.mh.adapt_cov:
            L0 = np.zeros((2, p, p), np.float32)
            for k, ind in enumerate((mm.white_indices, mm.hyper_indices)):
                L0[k, ind, ind] = 1.0
            cov0 = torch.as_tensor(L0, device=dev).expand(c, 2, p, p).clone()
        else:
            cov0 = torch.zeros((c, 0), dtype=f32, device=dev)
        return ChainState(
            x=torch.as_tensor(x0, device=dev), b=full((c, m), 0.0),
            z=z0, alpha=alpha0, theta=full((c,), cfg.outlier_mean),
            df=full((c,), cfg.tdf), pout=full((c, n), 0.0),
            acc_white=full((c,), 0.0), acc_hyper=full((c,), 0.0),
            mh_log_scale=full((c, 2), 0.0), mh_cov_chol=cov0)

    def _draw_table(self) -> rng.DrawTable:
        """The raw fields of one sweep's draws: per MH block the
        scale-mixture uniforms, the coordinate-pick uniforms and jump
        normals (or, under population-covariance proposals, the p normals
        of each joint direction), under multiple-try Metropolis the same
        again for the K-1 reference jumps and the Gumbel selection noise,
        and the log-uniforms; then the b draw's normals, the theta gammas
        (shape columns 0 and 1), the z uniforms, the alpha gammas (columns
        2 and 3, n each) and the df Gumbel noise."""
        mh, p = self.config.mh, self._ma.nparam
        fields = []
        for blk, S in (("white", mh.n_white_steps),
                       ("hyper", mh.n_hyper_steps)):
            K = mh.mtm_tries if self._mtm[blk] else 1
            for suffix, ns in (("", S * K),) + (
                    (("_ref", S * (K - 1)),) if K > 1 else ()):
                fields.append(rng.DrawField(f"{blk}_scale{suffix}",
                                            rng.UNIFORM, (ns,)))
                if mh.adapt_cov:
                    fields.append(rng.DrawField(f"{blk}_jump{suffix}",
                                                rng.NORMAL, (ns, p)))
                else:
                    fields += [rng.DrawField(f"{blk}_pick{suffix}",
                                             rng.UNIFORM, (ns,)),
                               rng.DrawField(f"{blk}_jump{suffix}",
                                             rng.NORMAL, (ns,))]
            if K > 1:
                fields.append(rng.DrawField(f"{blk}_gumbel", rng.GUMBEL,
                                            (S, K)))
            fields.append(rng.DrawField(f"{blk}_logu", rng.LOG_UNIFORM,
                                        (S,)))
        n = self._n
        fields += [rng.DrawField("xi", rng.NORMAL, (self._ma.m,)),
                   rng.DrawField("g_theta", rng.GAMMA, (2,), col=0, per=1),
                   rng.DrawField("u_z", rng.UNIFORM, (n,)),
                   rng.DrawField("g_alpha", rng.GAMMA, (2, n), col=2,
                                 per=n),
                   rng.DrawField("gumbel_df", rng.GUMBEL,
                                 (self.config.df_max,))]
        return rng.DrawTable(fields)

    def _jumps(self, raw, blk, suffix, ind, jump_scale, cov_chol):
        """``dx (..., ns, p)``: one MH jump set from its raw fields
        (``{blk}_scale{suffix}``, ``_pick``, ``_jump``; ``suffix`` is
        ``_ref`` for the MTM reference jumps). One random coordinate
        per step with the discrete scale mixture (reference
        gibbs.py:91-97): the step size from the uniform's bin of the
        mixture's CDF, the coordinate ``floor(u * len(ind))`` (exact in
        float64 on the 2^-24 grid of the uniforms); or, with ``cov_chol
        (..., p, p)``, the joint direction ``L @ xi`` of
        population-covariance proposals."""
        mh = self.config.mh
        sigma = mh.sigma_per_param * len(ind) * jump_scale
        k = torch.searchsorted(self._scale_cdf, raw[f"{blk}_scale{suffix}"],
                               right=True)
        scales = self._scale_sizes[k.clamp_(max=len(mh.scale_sizes) - 1)]
        step = sigma[..., None] * scales                         # (..., ns)
        jump = raw[f"{blk}_jump{suffix}"]
        if cov_chol is not None:
            return step[..., None] * torch.matmul(
                jump, cov_chol.transpose(-1, -2))
        pick = (raw[f"{blk}_pick{suffix}"].double() * len(ind)).long()
        jumps = jump * step
        dx = step.new_zeros(step.shape + (self._ma.nparam,))
        return dx.scatter_(-1, ind[pick][..., None], jumps[..., None])

    def _block_draws(self, raw, blk: str, ind, jump_scale, cov_chol):
        """``(dx, logu, dxr, gumb)`` of one MH block, single- or
        multiple-try (the JAX backend's ``_mtm_draws``: per step K
        candidate jumps and K-1 reference jumps from the same jump kernel,
        K Gumbel selection draws and one log-uniform; ``dxr``/``gumb``
        empty for single-try)."""
        logu = raw[blk + "_logu"]
        dx = self._jumps(raw, blk, "", ind, jump_scale, cov_chol)
        if not self._mtm[blk]:
            empty = dx.new_zeros((*jump_scale.shape, 0))
            return dx, logu, empty, empty
        B, p = tuple(jump_scale.shape), self._ma.nparam
        gumb = raw[blk + "_gumbel"]
        S, K = gumb.shape[-2:]
        dxr = self._jumps(raw, blk, "_ref", ind, jump_scale, cov_chol)
        return (dx.reshape(*B, S, K, p), logu,
                dxr.reshape(*B, S, K - 1, p), gumb)

    def _draw(self, keys, sweep, state: ChainState, out=None) -> SweepDraws:
        """All of one sweep's random numbers (see the module docstring) for
        the chains keyed ``keys (*batch, 2)`` (int64 words from
        ``ops.rng.chain_key``) at ``sweep`` (an int64 device tensor: one
        index, or one a chain), at the state's batch shape: the sampler's
        own, a subset of its chains, or the serving pool's lanes (it reads
        ``z``, ``df``, ``mh_log_scale`` and ``mh_cov_chol`` of ``state``).
        One launch of the draw kernel writes the raw fields (into ``out``
        when given); ``out`` and the fields' views stay valid until the
        next call that writes the same buffer."""
        mh = self.config.mh
        B = tuple(state.df.shape)
        a, b = self._theta_shapes(state.z)
        df = state.df
        shapes = torch.stack([a, b, df / 2.0, (df + 1.0) / 2.0], -1)
        raw = self._table.views(
            sweep_draws(keys, sweep, shapes, self._table, out=out), B)
        cov = state.mh_cov_chol if mh.adapt_cov else None
        scale = torch.exp(state.mh_log_scale)
        dx_w, logu_w, dxr_w, gumb_w = self._block_draws(
            raw, "white", self._white_idx, scale[..., 0],
            None if cov is None else cov[..., 0, :, :])
        dx_h, logu_h, dxr_h, gumb_h = self._block_draws(
            raw, "hyper", self._hyper_idx, scale[..., 1],
            None if cov is None else cov[..., 1, :, :])
        return SweepDraws(dx_w, logu_w, dx_h, logu_h, raw["xi"],
                          raw["g_theta"], raw["u_z"], raw["g_alpha"],
                          raw["gumbel_df"], dxr_w, gumb_w, dxr_h, gumb_h)

    def _theta_shapes(self, z):
        """The Beta(a, b) shapes of the outlier-fraction conditional
        (reference gibbs.py:185-198) at the current indicators."""
        mk, k1mm = self._theta_prior
        sz = z.sum(-1)
        return sz + mk, self._nstat - sz + k1mm

    def _prop_cov_update(self, state: ChainState) -> ChainState:
        """Re-estimate each block's proposal Cholesky from the chain
        population (shrunk toward its diagonal plus a tiny ridge); a
        non-finite factor keeps the previous one. In the ensemble each
        pulsar's population is its own (the JAX ensemble vmaps this over
        pulsars)."""
        mh = self.config.mh
        x = state.x
        C, p = x.shape[-2:]
        xm = x - x.mean(-2, keepdim=True)
        cov = (xm.transpose(-1, -2) @ xm) / max(C - 1, 1)
        new = []
        for k, ind in enumerate((self._ma.white_indices,
                                 self._ma.hyper_indices)):
            prev = state.mh_cov_chol[..., 0, k, :, :]
            if len(ind) == 0:
                new.append(prev)
                continue
            it = torch.as_tensor(ind, device=x.device)
            sub = cov[..., it, :][..., it]
            dsub = torch.diag_embed(torch.diagonal(sub, dim1=-2, dim2=-1))
            sub = (1.0 - mh.cov_shrinkage) * sub + mh.cov_shrinkage * dsub
            ridge = torch.diagonal(sub, dim1=-2, dim2=-1).mean(-1)
            sub = sub + (1e-8 * ridge[..., None, None]
                         * torch.eye(len(ind), dtype=x.dtype, device=x.device))
            L, _ = torch.linalg.cholesky_ex(sub)
            Lk = torch.zeros(L.shape[:-2] + (p, p), dtype=x.dtype,
                             device=x.device)
            Lk[..., it[:, None], it[None, :]] = L
            ok = torch.isfinite(Lk).all(-1).all(-1)
            new.append(torch.where(ok[..., None, None], Lk, prev))
        stacked = torch.stack(new, -3)
        return state._replace(mh_cov_chol=stacked[..., None, :, :, :].expand(
            *x.shape[:-1], 2, p, p).clone())

    # ------------------------------------------------------------------
    # the sweep
    # ------------------------------------------------------------------

    def _sweep(self, state: ChainState, draws: SweepDraws,
               sweep: Optional[int] = None,
               block_gates: Optional[torch.Tensor] = None) -> ChainState:
        """One full Gibbs sweep for all chains, deterministic given
        ``draws``. ``sweep`` (the sweep index) is needed only while the
        MH scales adapt (MHConfig.adapt_until).

        ``block_gates`` (``(..., NBLOCKS)`` 0/1 floats, one row a chain;
        the adaptive scan of serve/adapt.py) gates each conditional block
        as the JAX backend does: a block whose gate is 0 is computed and
        discarded, and its fields keep their carried values (the draws are
        made either way, so the key schedule does not change). A gated
        white block leaves ``nvec`` built from the carried x; b keeps its
        value unless both the hyper and the b gate are 1; a gated MH
        block's acceptance reads 0 and its Robbins-Monro term is frozen.
        ``None`` is the ungated sweep, op for op."""
        cfg = self.config
        mm = self._ma
        mask = self._mask
        m = mm.m
        n_stat = _lift(self._nstat)
        x, b, z, alpha, theta, df = (state.x, state.b, state.z, state.alpha,
                                     state.theta, state.df)
        zeros = torch.zeros_like(state.theta)
        gate = None if block_gates is None else block_gates > 0.5

        # --- white MH block (reference gibbs.py:114-143) ---------------
        az = alpha ** z
        acc_w = zeros
        with block_span("gibbs/white_mh"):
            if self._white is not None:
                yred = self._y - matvec_blocked(self._T, b, self._block_size)
                x, acc_w = self._white_block(x, az, yred * yred, draws)
            if gate is not None:
                g_w = gate[..., BLOCK_WHITE]
                x = torch.where(g_w[..., None], x, state.x)
                acc_w = torch.where(g_w, acc_w, zeros)
            nvec = self._masked_nvec(x, az)

        # --- per-sweep inner products (reference gibbs.py:302-304) -----
        with block_span("gibbs/tnt_reduction"):
            TNT, d, const_white = self._tnt(nvec)

        # --- hyper MH block on the marginalized likelihood -------------
        acc_h = zeros
        hp = self._hyper
        jits = (cfg.jitter, 1e-4, 1e-2, 1e-1)
        if self._schur is not None and hp is not None:
            s_i, v_i = self._s_i, self._v_i
            ns = len(self._schur[0])
            phiinv_s = self._phiinv(x)[..., s_i]   # x-independent
            TNT_s = TNT.index_select(-2, s_i)
            A = TNT_s.index_select(-1, s_i) + torch.diag_embed(phiinv_s)
            Bm = TNT_s.index_select(-1, v_i)
            Cv = TNT.index_select(-2, v_i).index_select(-1, v_i)
            S0, rt, quad_s, logdetA, (La, isd_a, U_B, u_s) = schur_eliminate(
                A, Bm, Cv, d[..., s_i], d[..., v_i], cfg.jitter,
                return_factor=True)
            base = (const_white + 0.5 * (quad_s - logdetA)
                    - 0.5 * hp["logdet_static"])
            x_in = x
            with block_span("gibbs/hyper_mh"):
                x, acc_h = self._hyper_block(x, S0, rt, base, draws)
            if gate is not None:
                x, acc_h = _gate_hyper(gate, x, x_in, acc_h, zeros)
            # b draw with block-factor reuse: factor only the phi-varying
            # block S_v = S0 + diag(phiinv_v) (escalating jitters) and
            # assemble the permuted full factor from the A-block pieces
            with block_span("gibbs/b_draw"):
                phiinv = self._phiinv(x)
                Sv = S0 + torch.diag_embed(phiinv[..., v_i])
                y_v, isd_v, _ = robust_precond_draw(
                    Sv, rt, draws.xi[..., ns:], jitters=jits)
                wty = torch.matmul(U_B, (isd_v * y_v)[..., None])[..., 0]
                y_s = backward_solve(La, u_s + draws.xi[..., :ns] - wty)
                b = torch.empty(x.shape[:-1] + (m,), dtype=x.dtype,
                                device=x.device)
                b[..., s_i] = y_s * isd_a
                b[..., v_i] = y_v * isd_v
        else:
            x_in = x
            if hp is not None:
                base = const_white - 0.5 * hp["logdet_static"]
                with block_span("gibbs/hyper_mh"):
                    x, acc_h = self._hyper_block(x, TNT, d, base, draws)
            if gate is not None:
                x, acc_h = _gate_hyper(gate, x, x_in, acc_h, zeros)
            with block_span("gibbs/b_draw"):
                phiinv = self._phiinv(x)
                Sigma = TNT + torch.diag_embed(phiinv)
                y, isd, _ = robust_precond_draw(Sigma, d, draws.xi,
                                                jitters=jits)
                b = y * isd
        if gate is not None:
            # tied to the hyper gate on both b paths (see BLOCK_B)
            g_b = gate[..., BLOCK_HYPER] & gate[..., BLOCK_B]
            b = torch.where(g_b[..., None], b, state.b)

        resid = self._y - matvec_blocked(self._T, b, self._block_size)
        nvec0 = self._ndiag(x)
        if mask is not None:
            nvec0 = torch.where(mask, nvec0, 1.0)

        # --- outlier fraction theta ~ Beta (reference gibbs.py:185-198)
        if cfg.is_outlier_model:
            ga, gb = draws.g_theta[..., 0], draws.g_theta[..., 1]
            theta = ga / (ga + gb)
            if gate is not None:
                theta = torch.where(gate[..., BLOCK_THETA], theta,
                                    state.theta)

        # --- outlier indicators z ~ Bernoulli (gibbs.py:201-226) --------
        pout = state.pout
        if cfg.is_outlier_model:
            p_in = _norm_pdf(resid, nvec0)
            if cfg.model == "vvh17":
                top = (theta / self._pspin)[..., None].expand_as(resid)
            else:
                top = theta[..., None] * _norm_pdf(resid, alpha * nvec0)
            bot = top + (1.0 - theta[..., None]) * p_in
            q = top / bot
            q = torch.where(torch.isnan(q), 1.0, q)
            if mask is not None:
                q = torch.where(mask, q, 0.0)
            pout = q
            z = (draws.u_z < q.clamp(0.0, 1.0)).to(x.dtype)
            if gate is not None:
                g_z = gate[..., BLOCK_Z, None]
                z = torch.where(g_z, z, state.z)
                pout = torch.where(g_z, pout, state.pout)

        # --- auxiliary scales alpha (gibbs.py:229-242) -------------------
        if cfg.vary_alpha:
            top = (resid * resid * z / nvec0 + df[..., None]) / 2.0
            g = torch.where(z > 0.5, draws.g_alpha[..., 1, :],
                            draws.g_alpha[..., 0, :])
            alpha_new = top / g
            if mask is not None:
                alpha_new = torch.where(mask, alpha_new, 1.0)
            alpha = torch.where((z.sum(-1) >= 1.0)[..., None], alpha_new,
                                alpha)
            if gate is not None:
                alpha = torch.where(gate[..., BLOCK_ALPHA, None], alpha,
                                    state.alpha)

        # --- degrees of freedom on the grid (gibbs.py:244-259) -----------
        if cfg.vary_df:
            grid = self._df_grid
            terms = torch.log(alpha) + 1.0 / alpha
            if mask is not None:
                terms = torch.where(mask, terms, 0.0)
            s = terms.sum(-1)
            logp = (-(grid / 2.0) * s[..., None]
                    + n_stat * (grid / 2.0) * torch.log(grid / 2.0)
                    - n_stat * torch.special.gammaln(grid / 2.0))
            df = grid[torch.argmax(logp + draws.gumbel_df, dim=-1)]
            if gate is not None:
                df = torch.where(gate[..., BLOCK_DF], df, state.df)

        # --- Robbins-Monro jump-scale adaptation --------------------------
        mh_ls = state.mh_log_scale
        if cfg.mh.adapt_until > 0:
            eta = self._rm_step(sweep)
            target = (cfg.mh.cov_target_accept if cfg.mh.adapt_cov
                      else cfg.mh.target_accept)
            step = torch.stack([acc_w, acc_h], -1) - target
            if block_gates is not None:
                # a gated MH block's zeroed acceptance must not read as a
                # rejection: its adaptation term is frozen instead
                step = block_gates[..., :2].to(step.dtype) * step
            mh_ls = mh_ls + eta * step

        return ChainState(x=x, b=b, z=z, alpha=alpha, theta=theta, df=df,
                          pout=pout, acc_white=acc_w, acc_hyper=acc_h,
                          mh_log_scale=mh_ls, mh_cov_chol=state.mh_cov_chol)

    def _white_block(self, x, az, yred2, draws):
        """The white MH block, ``(x_new, acc_rate)``: one launch of the
        white MH kernel, or of the white MTM kernel under multiple-try
        Metropolis."""
        rows, wspecs, var = self._white
        if self._mtm["white"]:
            return white_mtm(x, az, yred2, draws.dx_w, draws.dxr_w,
                             draws.gumb_w, draws.logu_w, rows, wspecs, var)
        return white_mh(x, az, yred2, draws.dx_w, draws.logu_w, rows, wspecs,
                        var)

    def _tnt(self, nvec):
        """``(TNT, d, const_white)`` of the sweep: the dense product, or the
        Gram kernel over the TOA blocks."""
        if self._block_size is None:
            return tnt_products(self._T, self._y, nvec)
        return tnt_batched(self._T, self._y, nvec, self._block_size)

    def _rm_step(self, sweep):
        """The Robbins-Monro step size of sweep ``sweep`` (a number, 0
        once the sweep index reaches ``adapt_until``)."""
        mh = self.config.mh
        if sweep is None:
            raise ValueError("MHConfig.adapt_until > 0 needs the sweep "
                             "index; drive the sampler through sample()")
        return ((sweep + 1.0) ** (-mh.adapt_decay)
                if sweep < mh.adapt_until else 0.0)

    def _hyper_block(self, x, Sh, rh, base, draws):
        """The hyper MH block on the matrix block ``Sh``: one kernel launch
        when ``v <= MAX_HYPER_V``, else the closure path (the plain loop
        with the chol kernel as its factorization). Under multiple-try
        Metropolis, the MTM loop whose each step factors the K candidates
        and the K-1 references as one stacked batch through the chol
        kernel (the JAX backend's closure ``_mtm_block``)."""
        hp, cfg = self._hyper, self.config
        dS0 = torch.diagonal(Sh, dim1=-2, dim2=-1) + hp["phiinv_static"]
        if self._mtm["hyper"]:
            # the constant tables broadcast over (chains, tries)
            K, sel, specs = (group_axes(hp["K"], 2, 2),
                             group_axes(hp["sel"], 1, 2),
                             group_axes(hp["specs"], 2, 2))

            def weight(q):
                ll, lp = hyper_ll_lp(
                    q, Sh[..., None, :, :], dS0[..., None, :],
                    rh[..., None, :], base[..., None], K, sel, specs,
                    hp["hyp_idx"], cfg.jitter, factor=chol_fused)
                return ll + lp

            return mtm_loop(weight, x, draws.dx_h, draws.dxr_h, draws.gumb_h,
                            draws.logu_h)
        args = (x, Sh, dS0, rh, base, draws.dx_h, draws.logu_h, hp["K"],
                hp["sel"], hp["specs"], hp["hyp_idx"], cfg.jitter)
        if hp["fused"]:
            return hyper_mh(*args)
        return hyper_mh_loop(*args, factor=chol_fused)

    # ------------------------------------------------------------------
    # chunked driver
    # ------------------------------------------------------------------

    def sample(self, x0: Optional[np.ndarray] = None, niter: int = 1000,
               seed: int = 0, state: Optional[ChainState] = None,
               start_sweep: int = 0, spool_dir: Optional[str] = None,
               reinit_diverged: bool = False) -> ChainResult:
        """Run ``niter`` sweeps for all chains and return the recorded
        rows (the state BEFORE sweeps ``start_sweep, start_sweep + t, ...``
        for ``record_thin=t``, as the JAX backend records) as float32 host
        arrays, in the tier ``record`` names.

        Records stay on the device for a chunk of ``chunk_size`` sweeps,
        are cast to their wire dtypes there and then copied to the host;
        chunk k's copy runs on a side stream while chunk k+1's sweeps are
        issued (the JAX backend's double-buffered flush). With
        population-covariance proposals the proposal factors are
        re-estimated at chunk boundaries while the sweep index is below
        ``adapt_until``. Chain k's draws at sweep ``i`` are keyed by
        ``(seed, k, i)`` (the module docstring), so a run resumed from
        ``last_state`` at ``start_sweep`` continues the unbroken run
        bitwise when both cut their chunks at the same sweeps.
        ``reinit_diverged`` re-draws numerically dead chains
        (:meth:`diverged_mask`) from the prior at chunk boundaries, with
        the count in ``stats['n_reinits']``; its flushes are sequential
        (the scan needs each post-chunk state).

        With ``spool_dir``, each chunk's float32 rows go to the spool
        files of that directory and its chunk-end state to its checkpoint
        (utils/spool.py) instead of memory, and the result is the spool
        reloaded (the whole spooled history) with this call's telemetry.
        A killed run resumes with ``load_spool_state(spool_dir)`` ->
        ``sample(state=, start_sweep=, spool_dir=)``: ``start_sweep > 0``
        appends to the spool after cutting any rows past ``start_sweep``,
        and ``n_reinits`` counts on from ``run_stats.json``. Without
        ``reinit_diverged`` the chunk-end state is copied to the host with
        the chunk's records, so the checkpoint adds no synchronization;
        with it, the checkpoint is the state after the re-draw."""
        self._check_run(niter, start_sweep)
        if state is None:
            state = self.init_state(x0, seed=seed)
        spool = self._open_spool(spool_dir, seed, start_sweep)
        cols, stats = self._run(niter, seed, state, start_sweep,
                                reinit_diverged, spool=spool)
        if spool is not None:
            from gibbs_student_t_tpu_torch.utils.spool import load_spool

            res = load_spool(spool_dir)
        else:
            res = self._to_result({f: self._trim(f, a)
                                   for f, a in cols.items()})
        res.stats.update(stats)
        return res

    def _open_spool(self, spool_dir, seed: int, start_sweep: int,
                    extra_meta=None):
        """The run's ``ChainSpool`` (None without ``spool_dir``): a
        resume (``start_sweep > 0``) appends, after cutting the rows
        past ``start_sweep``."""
        if spool_dir is None:
            return None
        from gibbs_student_t_tpu_torch.utils.spool import ChainSpool

        resume = start_sweep > 0
        return ChainSpool(spool_dir, seed, resume=resume,
                          resume_at=start_sweep if resume else None,
                          record_mode=self.record_mode,
                          record_thin=self.record_thin,
                          extra_meta=extra_meta)

    def _check_run(self, niter: int, start_sweep: int) -> None:
        if niter < 1:
            raise ValueError(f"niter must be >= 1, got {niter}")
        if niter % self.record_thin:
            raise ValueError(f"niter ({niter}) must be a multiple of "
                             f"record_thin ({self.record_thin})")
        if start_sweep % self.record_thin:
            raise ValueError(
                f"start_sweep ({start_sweep}) must land on a recorded "
                f"sweep (multiple of record_thin={self.record_thin})")

    def _run(self, niter: int, seed: int, state: ChainState,
             start_sweep: int, reinit_diverged: bool = False, spool=None):
        """The chunked loop of :meth:`sample` from ``state``: ``(cols,
        stats)``, the recorded fields as float32 host arrays ``(rows,
        *batch, ...)`` (per-TOA fields at the padded length; none when the
        rows go to ``spool``, a ``ChainSpool``, instead, cut to the real
        TOAs by :meth:`_trim`) and the run's ``n_reinits`` and ``tele_*``
        stats; ``last_state`` is set."""
        mh = self.config.mh
        keys = self._chain_keys(seed)
        rng.check_counter("the last sweep index", start_sweep + niter - 1)
        thin = self.record_thin
        fields = self._record_fields
        if self.device.type == "cuda" and self._pull_stream is None:
            self._pull_stream = torch.cuda.Stream(self.device)
        # the run's host arrays, filled chunk by chunk: a chunk's pinned
        # buffers go back to the allocator once copied, so pinned memory
        # stays at two chunks however long the run
        cols = {}
        filled = [0]
        tele_acc = TelemetryAccumulator() if self.telemetry else None
        n_tele = len(Telemetry._fields) if self.telemetry else 0
        # a spooled run's chunk-end state rides the chunk's host copy,
        # ordered after the chunk on the pull stream, so the checkpoint
        # waits for nothing the deferred flush does not; under
        # reinit_diverged the flush checkpoints the re-drawn state
        # itself (flushes are sequential there)
        state_in_pull = spool is not None and not reinit_diverged
        # a resumed spool's re-init count goes on from the interrupted run
        n_reinits0 = (int(spool.load_run_stats().get("n_reinits", 0))
                      if spool is not None and start_sweep > 0 else 0)

        def step(st, offset, length):
            rows = {f: [] for f in fields}
            tl = (telemetry_init(self._batch, self.device, self.dtype)
                  if self.telemetry else None)
            # the chunk's sweep indices on the device: sweep i reads its
            # own element, a view (no launch)
            sweeps = torch.arange(offset, offset + length, device=self.device)
            for j, i in enumerate(range(offset, offset + length)):
                if j % thin == 0:
                    for f in fields:
                        rows[f].append(getattr(st, f))
                st = self._sweep(st, self._draw(keys, sweeps[j], st),
                                 sweep=i)
                if tl is not None:
                    tl = telemetry_update(tl, st)
            recs = record_tuple(
                SimpleNamespace(**{f: torch.stack(v)
                                   for f, v in rows.items()}),
                fields, self._record_casts)
            if tl is not None:
                tl = tl._replace(logpost=self._logpost_chain(st))
                recs = recs + tuple(tl)
            if state_in_pull:
                recs = recs + tuple(st)
            return st, _HostCopy(recs, self._pull_stream)

        def flush(pull, chunk_state, sweep_end, n_reinits):
            host = pull.wait()
            k = len(fields)
            if tele_acc is not None:
                summary = tele_acc.add(Telemetry(*(
                    t.numpy() for t in host[k:k + n_tele])))
                if self.metrics is not None:
                    tele_acc.emit_chunk(self.metrics, sweep_end, summary)
            rows = self._materialize(host[:k])
            if spool is not None:
                with host_span("gibbs/spool_append"):
                    spool.append(
                        {f: self._trim(f, a) for f, a in zip(fields, rows)},
                        (type(chunk_state)(*host[k + n_tele:])
                         if state_in_pull else chunk_state), sweep_end,
                        run_stats=({"n_reinits": n_reinits}
                                   if reinit_diverged else None))
                return
            r0 = filled[0]
            for f, a in zip(fields, rows):
                if f not in cols:
                    cols[f] = np.empty((niter // thin,) + a.shape[1:],
                                       a.dtype)
                cols[f][r0:r0 + len(a)] = a
            filled[0] = r0 + len(a)

        try:
            state, n_reinits = chunked_sweep_loop(
                state, niter, self.chunk_size, start_sweep, step_fn=step,
                flush_fn=flush, pre_chunk_fn=self._prop_cov_update,
                pre_chunk_until=mh.adapt_until if mh.adapt_cov else 0,
                reinit_fn=((lambda st, end: self._reinit_diverged(
                    st, seed=seed + 7919 * end)) if reinit_diverged
                    else None),
                n_reinits=n_reinits0)
        finally:
            if spool is not None:
                spool.close()
        self.last_state = state
        stats = {}
        if reinit_diverged:
            stats["n_reinits"] = np.asarray(n_reinits)
        if tele_acc is not None:
            stats.update(tele_acc.stats())
        return cols, stats

    def _chain_keys(self, seed: int) -> torch.Tensor:
        """``(*batch, 2)`` key words of the run ``seed``'s chains on the
        device: the batch's chains numbered in row-major order (chain k
        of the solo sampler is k; pulsar p's chain c of an ensemble of C
        chains a pulsar is ``p * C + c``, as the JAX ensemble splits its
        keys pulsar-major)."""
        idx = np.arange(math.prod(self._batch)).reshape(self._batch)
        return rng.chain_keys(seed, idx, device=self.device)

    def sample_until(self, rhat_target: float = 1.01,
                     max_sweeps: int = 20000, check_every: int = 500,
                     seed: int = 0,
                     x0: Optional[np.ndarray] = None,
                     state: Optional[ChainState] = None,
                     min_sweeps: int = 0,
                     min_ess: Optional[float] = None,
                     **sample_kwargs) -> ChainResult:
        """Sample until every parameter's split-R-hat across the chain
        axis drops below ``rhat_target`` (checked every ``check_every``
        sweeps over the second half of the accumulated rows), or
        ``max_sweeps`` is reached (the JAX backend's ``sample_until``).

        ``min_ess`` adds the complementary criterion: the pooled window
        must also hold at least that many effective samples of EVERY
        parameter. The result carries the R-hat trajectory in
        ``stats['rhat_history']`` ((checks, p)), the final values in
        ``stats['rhat']`` (plus ``stats['ess']``/``ess_history`` when
        ``min_ess`` is set), and ``stats['converged']``; segments are
        concatenated, ``n_reinits`` summed and the ``tele_*`` stats
        merged. Extra kwargs (``spool_dir``, ``reinit_diverged``) pass
        through to :meth:`sample`; with ``spool_dir`` the segments append
        to one spool and the result is the reloaded full history, its
        counters cumulative. ``check_every`` must be a multiple of
        ``record_thin`` covering at least 8 recorded rows. The segments
        are ``sample`` calls resumed at their start sweeps, so the rows
        are those of one ``sample`` call of the same length when the
        chunks are cut at the same sweeps."""
        def sample_fn(length, st, start):
            return self.sample(x0=x0 if start == 0 else None,
                               niter=length, seed=seed, state=st,
                               start_sweep=start, **sample_kwargs)

        return _sample_until_loop(
            sample_fn, lambda: self.last_state, self.record_thin,
            _rhat_per_param, rhat_target, max_sweeps, check_every,
            min_sweeps, state,
            spool_mode=bool(sample_kwargs.get("spool_dir")),
            ess_of=_ess_per_param, min_ess=min_ess)

    # ------------------------------------------------------------------
    # divergence recovery
    # ------------------------------------------------------------------

    def diverged_mask(self, state: ChainState) -> np.ndarray:
        """Boolean mask of numerically dead chains, of the batch shape
        (:func:`obs.telemetry.state_bad`: a non-finite x, b, theta, alpha
        or df, or an alpha <= 0). Computed on the device; only the mask
        crosses to the host.

        The reference's failure handling is purely local (SVD->QR
        fallback, -inf on Cholesky failure, NaN clamps); a chain whose
        state still goes non-finite stays dead forever. With a population
        of chains, chain-level recovery is cheap: detect here,
        re-initialize in ``sample``."""
        return state_bad(state, len(self._batch)).cpu().numpy()

    def _reinit_diverged(self, state: ChainState, seed: int):
        """``(state, n_bad)``: dead chains replaced with fresh prior draws
        (``init_state(seed=seed)``); healthy chains untouched bitwise."""
        bad = self.diverged_mask(state)
        n_bad = int(bad.sum())
        if n_bad == 0:
            return state, 0
        return merge_reinit(state, bad, self.init_state(seed=seed),
                            batch_ndim=len(self._batch)), n_bad

    # ------------------------------------------------------------------
    # records on the host
    # ------------------------------------------------------------------

    def _materialize(self, host):
        """Undo the wire casts: host tensors in wire dtypes -> float32
        numpy arrays, as a ``record="full"`` run returns them. The packed z
        unpacks to the sampler's padded TOA count (in the ensemble, the
        largest pulsar's: the JAX ensemble passes it as ``n_last``)."""
        out = []
        for f, h in zip(self._record_fields, host):
            c = self._record_casts.get(f)
            if c is _PACKBITS:
                out.append(_unpack_bits(h.numpy(), self._n))
            elif c is _U8PROB:
                out.append(h.numpy().astype(np.float32) / 255.0)
            elif c is not None:
                out.append(h.float().numpy())
            else:
                out.append(h.numpy())
        return out

    def _trim(self, field: str, arr: np.ndarray) -> np.ndarray:
        """Cut TOA padding (block padding and/or a pre-padded model's
        suffix rows) back off the recorded per-TOA chains."""
        if self._n != self._n_real and field in ("z", "alpha", "pout"):
            return arr[..., :self._n_real]
        return arr

    def _to_result(self, cols: dict) -> ChainResult:
        empty = np.zeros((0,), np.float32)
        stats = {k: v for k, v in cols.items() if k.startswith("acc_")}
        # the tier is discoverable downstream: host arrays are float32
        # either way, so the dtype alone cannot tell a ~2-3-digit b/alpha
        # chain from a bit-exact one
        stats["record_mode"] = np.asarray(self.record_mode)
        if self.record_thin != 1:
            stats["record_thin"] = np.asarray(self.record_thin)
        return ChainResult(
            chain=cols["x"], bchain=cols.get("b", empty),
            zchain=cols.get("z", empty), thetachain=cols["theta"],
            alphachain=cols.get("alpha", empty),
            poutchain=cols.get("pout", empty), dfchain=cols["df"],
            stats=stats)


def _gate_hyper(gate, x, x_in, acc_h, zeros):
    """The hyper block's gate: a gated chain keeps the x it entered the
    block with, and its acceptance reads 0."""
    g_h = gate[..., BLOCK_HYPER]
    return (torch.where(g_h[..., None], x, x_in),
            torch.where(g_h, acc_h, zeros))


def _norm_pdf(x, var):
    return torch.exp(-0.5 * x * x / var) / torch.sqrt(2.0 * math.pi * var)
