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

A sweep is split into ``draws = self._draw(gen, state)``, which takes
every random number the sweep needs from one ``torch.Generator``, and a
deterministic ``state = self._sweep(state, draws, sweep)``, so tests can
feed both this sampler and the JAX stages the same numbers. Two draws
depend on values the sweep itself produces, and are drawn for both
outcomes: the alpha update's Gamma((z + df)/2) comes as a pair of
gammas (for z = 0 and z = 1) selected by the new z, and the z and df
draws are a uniform and Gumbel noise the sweep compares against.
``jax.random`` streams are not reproduced: the two samplers agree in
law, not bitwise.

Every sweep draws from the run's generator re-seeded with
:func:`sweep_key` of ``(seed, sweep index)``, as the JAX backend keys
each sweep by ``fold_in(key, sweep)``: a sweep's draws depend on neither
the chunk it falls in nor ``start_sweep``, so N sweeps and N more from
``last_state`` at ``start_sweep=N`` are the 2N unbroken sweeps.

The stages are written over a leading batch shape: ``(C,)`` chains of
one model here, ``(P, C)`` pulsars x chains in the ensemble
(parallel/ensemble.py), whose model tensors carry a leading pulsar axis
and broadcast against the state as ``(P, 1, ...)``.

Entry points run on the GPU: ``device=None`` means ``"cuda"`` and raises
when CUDA is absent; pass ``device="cpu"`` to run the kernels' plain
versions (the tests do).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from gibbs_student_t_tpu_torch.backends.base import ChainResult, SamplerBackend
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
    robust_precond_draw,
    schur_eliminate,
)
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


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises (the port
    never falls back to the CPU on its own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TorchGibbs runs on a CUDA device and CUDA is not available "
            "here; pass device='cpu' to run the kernels' plain versions")
    return dev


_MASK64 = (1 << 64) - 1


def sweep_key(seed: int, sweep: int) -> int:
    """The 64-bit generator seed of sweep ``sweep`` of the run ``seed``:
    the two packed into 64 bits and passed through the splitmix64
    finalizer, a bijection, so distinct ``(seed, sweep)`` pairs give
    distinct keys (both must lie in ``[0, 2**32)``). The mixing matters on
    the CPU, whose Mersenne-Twister generator keeps only the key's low 32
    bits: there, two pairs share a stream only by a hash collision."""
    seed, sweep = int(seed), int(sweep)
    if not (0 <= seed < 1 << 32 and 0 <= sweep < 1 << 32):
        raise ValueError(f"seed ({seed}) and sweep ({sweep}) must lie in "
                         f"[0, 2**32)")
    z = (seed << 32) | sweep
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


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
    ``record`` is ``"full"`` (every field of every sweep) or ``"light"``
    (x, theta, df and the acceptance rates; the other chains come back
    empty)."""

    supports_chains = True

    #: sweeps per chunk: records move to the host, and population-
    #: covariance proposals are re-estimated, at chunk boundaries
    chunk_size = 100

    def __init__(self, ma: ModelArrays, config: GibbsConfig,
                 nchains: int = 64, device=None,
                 tnt_block_size: int | str | None = "auto",
                 record: str = "full"):
        super().__init__(ma, config)
        if record not in ("full", "light"):
            raise ValueError(f"record must be 'full' or 'light', got "
                             f"{record!r}")
        self.record = record
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
            scaled = 10.0 ** (2.0 * eq) * mm.time_scale ** 2
            nv = nv + (scaled[..., None] * self._equad_masks).sum(-2)
        return nv

    def _masked_nvec(self, x, az):
        nv = az * self._ndiag(x)
        return nv if self._mask is None else torch.where(self._mask, nv, 1.0)

    def _phiinv(self, x):
        """Prior precision diag phi^-1(x), (..., p) -> (..., m) (scaled;
        the ``phiinv`` half of models/pta.py ``phiinv_logdet``)."""
        batch = x.shape[:-1]
        s2 = self._ma.time_scale ** 2
        pieces = []
        for blk, k in self._phi_consts:
            if isinstance(blk, ImproperBlock):
                pieces.append(x.new_zeros(batch + (blk.stop - blk.start,)))
            elif isinstance(blk, ConstBlock):
                pieces.append((1.0 / k["phi"]).expand(*batch, -1))
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
            else:
                ec = self._pvals(x, blk.idx, k["const"])
                pieces.append(torch.exp(-(2.0 * ec * LN10 + np.log(s2))
                                        [..., k["group"]]))
        if not pieces:
            return x.new_zeros(batch + (0,))
        return torch.cat(pieces, dim=-1)

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

    def _mh_draws(self, gen, ind, nsteps: int, jump_scale, cov_chol=None):
        """One MH block's randomness for every chain: ``(dx (C, S, p),
        logu (C, S))``. One random coordinate per step with the discrete
        scale mixture (reference gibbs.py:91-97), or, with ``cov_chol``
        (C, p, p), the joint direction ``L @ xi`` of population-covariance
        proposals."""
        mh = self.config.mh
        B, p = tuple(jump_scale.shape), self._ma.nparam
        dev, f32 = self.device, self.dtype
        sigma = mh.sigma_per_param * len(ind) * jump_scale          # (C,)
        u = torch.rand((*B, nsteps), generator=gen, device=dev, dtype=f32)
        k = torch.searchsorted(self._scale_cdf, u, right=True)
        scales = self._scale_sizes[k.clamp_(max=len(mh.scale_sizes) - 1)]
        step = sigma[..., None] * scales                             # (C, S)
        if cov_chol is None:
            pick = torch.randint(0, len(ind), (*B, nsteps), generator=gen,
                                 device=dev)
            jumps = torch.randn((*B, nsteps), generator=gen, device=dev,
                                dtype=f32) * step
            dx = torch.zeros((*B, nsteps, p), dtype=f32, device=dev)
            dx.scatter_(-1, ind[pick][..., None], jumps[..., None])
        else:
            xi = torch.randn((*B, nsteps, p), generator=gen, device=dev,
                             dtype=f32)
            dx = step[..., None] * torch.matmul(xi, cov_chol.transpose(-1, -2))
        logu = torch.log(torch.rand((*B, nsteps), generator=gen, device=dev,
                                    dtype=f32))
        return dx, logu

    def _mtm_draws(self, gen, ind, nsteps: int, jump_scale, cov_chol=None):
        """One MTM block's randomness (the JAX backend's ``_mtm_draws``):
        per step K candidate jumps and K-1 reference jumps from the same
        jump kernel as :meth:`_mh_draws`, K Gumbel selection draws and one
        log-uniform. Returns ``(dx (C, S, K, p), dxr (C, S, K-1, p),
        gumb (C, S, K), logu (C, S))``."""
        K = self.config.mh.mtm_tries
        B, p = tuple(jump_scale.shape), self._ma.nparam
        dev, f32 = self.device, self.dtype
        dx, _ = self._mh_draws(gen, ind, nsteps * K, jump_scale, cov_chol)
        dxr, _ = self._mh_draws(gen, ind, nsteps * (K - 1), jump_scale,
                                cov_chol)
        u = torch.rand((*B, nsteps, K), generator=gen, device=dev, dtype=f32)
        logu = torch.log(torch.rand((*B, nsteps), generator=gen, device=dev,
                                    dtype=f32))
        return (dx.reshape(*B, nsteps, K, p),
                dxr.reshape(*B, nsteps, K - 1, p),
                -torch.log(-torch.log(u)), logu)

    def _block_draws(self, gen, blk: str, ind, nsteps: int, jump_scale,
                     cov_chol):
        """``(dx, logu, dxr, gumb)`` of one MH block, single- or
        multiple-try (``dxr``/``gumb`` empty for single-try)."""
        if self._mtm[blk]:
            dx, dxr, gumb, logu = self._mtm_draws(gen, ind, nsteps,
                                                  jump_scale, cov_chol)
            return dx, logu, dxr, gumb
        dx, logu = self._mh_draws(gen, ind, nsteps, jump_scale, cov_chol)
        empty = dx.new_zeros((*jump_scale.shape, 0))
        return dx, logu, empty, empty

    def _draw(self, gen, state: ChainState) -> SweepDraws:
        """All of one sweep's random numbers (see the module docstring), at
        the state's batch shape: the sampler's own, or, in the serving
        slot pool, one tenant's ``(C_t,)`` chains (it reads ``z``, ``df``,
        ``mh_log_scale`` and ``mh_cov_chol`` of ``state``)."""
        cfg, mh = self.config, self.config.mh
        B, n, m = tuple(state.df.shape), self._n, self._ma.m
        dev, f32 = self.device, self.dtype
        cov = state.mh_cov_chol if mh.adapt_cov else None
        scale = torch.exp(state.mh_log_scale)
        dx_w, logu_w, dxr_w, gumb_w = self._block_draws(
            gen, "white", self._white_idx, mh.n_white_steps, scale[..., 0],
            None if cov is None else cov[..., 0, :, :])
        dx_h, logu_h, dxr_h, gumb_h = self._block_draws(
            gen, "hyper", self._hyper_idx, mh.n_hyper_steps, scale[..., 1],
            None if cov is None else cov[..., 1, :, :])
        xi = torch.randn((*B, m), generator=gen, device=dev, dtype=f32)
        a, b = self._theta_shapes(state.z)
        g_theta = torch._standard_gamma(torch.stack([a, b], -1),
                                        generator=gen)
        u_z = torch.rand((*B, n), generator=gen, device=dev, dtype=f32)
        shape = torch.stack([state.df, state.df + 1.0], -1) / 2.0
        g_alpha = torch._standard_gamma(
            shape[..., None].expand(*B, 2, n).contiguous(), generator=gen)
        ug = torch.rand((*B, cfg.df_max), generator=gen, device=dev,
                        dtype=f32)
        gumbel = -torch.log(-torch.log(ug))
        return SweepDraws(dx_w, logu_w, dx_h, logu_h, xi, g_theta, u_z,
                          g_alpha, gumbel, dxr_w, gumb_w, dxr_h, gumb_h)

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
               sweep: Optional[int] = None) -> ChainState:
        """One full Gibbs sweep for all chains, deterministic given
        ``draws``. ``sweep`` (the sweep index) is needed only while the
        MH scales adapt (MHConfig.adapt_until)."""
        cfg = self.config
        mm = self._ma
        mask = self._mask
        m = mm.m
        n_stat = _lift(self._nstat)
        x, b, z, alpha, theta, df = (state.x, state.b, state.z, state.alpha,
                                     state.theta, state.df)
        zeros = torch.zeros_like(state.theta)

        # --- white MH block (reference gibbs.py:114-143) ---------------
        az = alpha ** z
        acc_w = zeros
        if self._white is not None:
            yred = self._y - matvec_blocked(self._T, b, self._block_size)
            x, acc_w = self._white_block(x, az, yred * yred, draws)
        nvec = self._masked_nvec(x, az)

        # --- per-sweep inner products (reference gibbs.py:302-304) -----
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
            x, acc_h = self._hyper_block(x, S0, rt, base, draws)
            # b draw with block-factor reuse: factor only the phi-varying
            # block S_v = S0 + diag(phiinv_v) (escalating jitters) and
            # assemble the permuted full factor from the A-block pieces
            phiinv = self._phiinv(x)
            Sv = S0 + torch.diag_embed(phiinv[..., v_i])
            y_v, isd_v, _ = robust_precond_draw(Sv, rt, draws.xi[..., ns:],
                                                jitters=jits)
            wty = torch.matmul(U_B, (isd_v * y_v)[..., None])[..., 0]
            y_s = backward_solve(La, u_s + draws.xi[..., :ns] - wty)
            b = torch.empty(x.shape[:-1] + (m,), dtype=x.dtype,
                            device=x.device)
            b[..., s_i] = y_s * isd_a
            b[..., v_i] = y_v * isd_v
        else:
            if hp is not None:
                base = const_white - 0.5 * hp["logdet_static"]
                x, acc_h = self._hyper_block(x, TNT, d, base, draws)
            phiinv = self._phiinv(x)
            Sigma = TNT + torch.diag_embed(phiinv)
            y, isd, _ = robust_precond_draw(Sigma, d, draws.xi, jitters=jits)
            b = y * isd

        resid = self._y - matvec_blocked(self._T, b, self._block_size)
        nvec0 = self._ndiag(x)
        if mask is not None:
            nvec0 = torch.where(mask, nvec0, 1.0)

        # --- outlier fraction theta ~ Beta (reference gibbs.py:185-198)
        if cfg.is_outlier_model:
            ga, gb = draws.g_theta[..., 0], draws.g_theta[..., 1]
            theta = ga / (ga + gb)

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

        # --- Robbins-Monro jump-scale adaptation --------------------------
        mh_ls = state.mh_log_scale
        if cfg.mh.adapt_until > 0:
            eta = self._rm_step(sweep)
            target = (cfg.mh.cov_target_accept if cfg.mh.adapt_cov
                      else cfg.mh.target_accept)
            mh_ls = mh_ls + eta * (torch.stack([acc_w, acc_h], -1) - target)

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
               start_sweep: int = 0) -> ChainResult:
        """Run ``niter`` sweeps for all chains and return every sweep's
        state (the state BEFORE sweeps ``start_sweep .. start_sweep +
        niter - 1``, as the JAX backend records) in float32, every field
        or, with ``record="light"``, the light ones.

        Records stay on the device for a chunk of ``chunk_size`` sweeps
        and then move to the host. With population-covariance proposals
        the proposal factors are re-estimated at chunk boundaries while
        the sweep index is below ``adapt_until``. Sweep ``i`` draws from
        the generator seeded with ``sweep_key(seed, i)``, so a
        run resumed from ``last_state`` at ``start_sweep`` continues the
        unbroken run bitwise when both cut their chunks at the same
        sweeps."""
        if state is None:
            state = self.init_state(x0, seed=seed)
        cols = self._run(niter, seed, state, start_sweep)
        for f in ("z", "alpha", "pout"):
            if f in cols:
                cols[f] = cols[f][..., :self._n_real]
        return self._result(cols)

    def _run(self, niter: int, seed: int, state: ChainState,
             start_sweep: int) -> dict:
        """The chunked loop of :meth:`sample` from ``state``: the recorded
        fields as host arrays ``(niter, *batch, ...)``; ``last_state`` is
        set."""
        if niter < 1:
            raise ValueError(f"niter must be >= 1, got {niter}")
        gen = torch.Generator(device=self.device)
        mh = self.config.mh
        fields = _RECORD_FIELDS if self.record == "full" else _LIGHT_FIELDS
        host = {f: [] for f in fields}
        done = 0
        while done < niter:
            length = min(self.chunk_size, niter - done)
            off = start_sweep + done
            if mh.adapt_cov and off < mh.adapt_until:
                state = self._prop_cov_update(state)
            recs = {f: [] for f in fields}
            for i in range(off, off + length):
                for f in fields:
                    recs[f].append(getattr(state, f))
                draws = self._draw(gen.manual_seed(sweep_key(seed, i)),
                                   state)
                state = self._sweep(state, draws, sweep=i)
            for f in fields:
                host[f].append(torch.stack(recs[f]).cpu().numpy())
            done += length
        self.last_state = state
        return {f: np.concatenate(v) for f, v in host.items()}

    def _result(self, cols: dict) -> ChainResult:
        empty = np.zeros((0,), np.float32)
        return ChainResult(
            chain=cols["x"], bchain=cols.get("b", empty),
            zchain=cols.get("z", empty), thetachain=cols["theta"],
            alphachain=cols.get("alpha", empty),
            poutchain=cols.get("pout", empty), dfchain=cols["df"],
            stats={"acc_white": cols["acc_white"],
                   "acc_hyper": cols["acc_hyper"],
                   "record_mode": np.asarray(self.record)})


def _norm_pdf(x, var):
    return torch.exp(-0.5 * x * x / var) / torch.sqrt(2.0 * math.pi * var)
