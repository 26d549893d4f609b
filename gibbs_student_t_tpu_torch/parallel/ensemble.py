"""Multi-pulsar, multi-chain ensembles on one GPU: ``EnsembleGibbs``.

Counterpart of ``gibbs_student_t_tpu/parallel/ensemble.py`` in its
grouped form. A pulsar timing array is analysed by sampling every
pulsar's noise model at once; the model family has no cross-pulsar term,
so each pulsar keeps its own chains and the sweep needs no communication.
The state is held as ``(P, C, ...)`` (pulsars x chains) and each pulsar's
model tensors as ``(P, 1, ...)``, so the solo sampler's sweep stages
(backends/torch_backend.py) broadcast over both, and each MH block is one
launch of its kernel for all pulsars: the grouped forms of the white MH,
white MTM and hyper MH kernels, which read each pulsar's constants by
group.

Pulsars with different TOA counts are padded to the largest with masked
rows (:func:`pad_model_arrays`); basis size, parameter structure and the
structure the grouped kernels share (the white-noise variance groups, the
hyper indices, the Schur split) must be equal across pulsars, or the
constructor raises ``ValueError``.

The JAX package also has an unrolled form (``unroll=True``), which bakes
each pulsar's constants into its own XLA trace as literals. Eager PyTorch
has no trace to bake into, and the grouped form already launches once per
block for every pulsar, so the port has only the grouped form. The mesh
over several devices is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from gibbs_student_t_tpu_torch.backends.base import ChainResult, SamplerBackend
from gibbs_student_t_tpu_torch.backends.torch_backend import (
    ChainState,
    TorchGibbs,
    _ess_per_param,
    _rhat_per_param,
    _sample_until_loop,
    resolve_device,
)
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.models.pta import (
    ConstBlock,
    EcorrBlock,
    ImproperBlock,
    ModelArrays,
    PowerlawBlock,
)

#: the array-valued ("data") fields of ``ModelArrays`` and of each phi
#: block: stacked along the pulsar axis. Every other field is structure
#: and must be equal across pulsars (the JAX package registers the same
#: split as its pytree data and meta fields, models/pta.py).
MODEL_DATA_FIELDS = ("y", "T", "sigma2", "efac_masks", "efac_const",
                     "equad_masks", "equad_const", "prior_specs", "row_mask")
MODEL_META_FIELDS = ("name", "efac_idx", "equad_idx", "param_names",
                     "time_scale")
BLOCK_DATA_FIELDS = {
    PowerlawBlock: ("freqs", "df", "const_log10A", "const_gamma"),
    EcorrBlock: ("const",),
    ImproperBlock: (),
    ConstBlock: ("phi",),
}


#: the sampler attributes that hold one model's numbers, stacked with a
#: leading pulsar axis in the ensemble (see ``EnsembleGibbs.__init__``)
GROUPED_ATTRS = ("_y", "_sigma2", "_T", "_efac_masks", "_equad_masks",
                 "_mask", "_efac_c", "_equad_c", "_nstat", "_theta_prior",
                 "_phi_consts", "_white", "_hyper", "_prior_specs")


def _model_leaves(stacked, one):
    """``(stacked tensor, its one-model value)`` pairs of a grouped
    attribute and a solo sampler's: tensors and numbers, walked through
    lists, tuples and dicts; structure (an ecorr block's column groups,
    static tables, flags) is skipped."""
    if torch.is_tensor(stacked):
        yield stacked, one
    elif isinstance(stacked, (list, tuple)):
        for a, b in zip(stacked, one):
            yield from _model_leaves(a, b)
    elif isinstance(stacked, dict):
        for key, a in stacked.items():
            if key != "group":
                yield from _model_leaves(a, one[key])


def check_kernel_structure(s: TorchGibbs, t0: TorchGibbs) -> None:
    """Raise ``ValueError`` unless ``s`` shares with ``t0`` the structure
    the grouped sweep and kernels need: one Schur split, one set of
    white-noise variance groups, one set of hyper indices."""
    if (s._schur is None) != (t0._schur is None) or (
            s._schur is not None and not all(
                np.array_equal(a, b) for a, b in zip(s._schur, t0._schur))):
        raise ValueError(
            "pulsars split their phi-static columns differently "
            "(static_phi_columns); the grouped sweep needs one "
            "Schur split for every pulsar")
    if (s._white is None) != (t0._white is None) or (
            s._white is not None and s._white[2] != t0._white[2]):
        raise ValueError(
            "pulsars have different white-noise variance groups "
            "(WhiteConsts.var); the grouped white kernel needs one")
    if (s._hyper is None) != (t0._hyper is None) or (
            s._hyper is not None
            and s._hyper["hyp_idx"] != t0._hyper["hyp_idx"]):
        raise ValueError(
            "pulsars have different hyper indices "
            "(HyperConsts.hyp_idx); the grouped hyper kernel needs "
            "one")


def _localize_names(ma: ModelArrays) -> ModelArrays:
    """Strip the pulsar-name prefix from the parameter names, so that every
    pulsar's structure is the same and the models can stack."""
    prefix = ma.name + "_"
    local = tuple(nm[len(prefix):] if nm.startswith(prefix) else nm
                  for nm in ma.param_names)
    return dataclasses.replace(ma, name="ensemble", param_names=local)


def pad_model_arrays(mas: Sequence[ModelArrays],
                     n_to: Optional[int] = None) -> List[ModelArrays]:
    """Pad each pulsar's TOA axis to a common length with masked rows.

    Suffix rows get zero residual, basis and variance and ``row_mask =
    False``; the sweep pins their ``nvec`` to 1 and their ``z``/``alpha``
    to 0/1, so they add nothing to any reduction, and each pulsar's
    statistical TOA count is ``sum(row_mask)``. Basis size and parameter
    structure must match: they are the signal model, not the data size."""
    def local_names(ma):
        return _localize_names(ma).param_names

    n_max = max(ma.n for ma in mas) if n_to is None else n_to
    m0, p0 = mas[0].m, local_names(mas[0])
    out = []
    for ma in mas:
        if ma.m != m0:
            raise ValueError(
                f"cannot pad pulsar {ma.name!r}: basis size {ma.m} != "
                f"{m0}; ensembles need identical signal composition "
                "(equal Fourier components and timing columns)")
        if local_names(ma) != p0:
            raise ValueError(
                f"cannot pad pulsar {ma.name!r}: parameter structure "
                f"{local_names(ma)} != {p0}; ensembles need identical "
                "signal composition per pulsar")
        if ma.n > n_max:
            raise ValueError(f"pulsar {ma.name!r} has n={ma.n} > n_to={n_max}")
        pad = n_max - ma.n
        mask = np.concatenate([np.ones(ma.n, dtype=bool),
                               np.zeros(pad, dtype=bool)])
        if ma.row_mask is not None:
            mask[:ma.n] = np.asarray(ma.row_mask, dtype=bool)
        out.append(dataclasses.replace(
            ma,
            y=np.concatenate([ma.y, np.zeros(pad)]),
            T=np.concatenate([ma.T, np.zeros((pad, ma.m))]),
            sigma2=np.concatenate([ma.sigma2, np.zeros(pad)]),
            efac_masks=np.concatenate(
                [ma.efac_masks, np.zeros((ma.efac_masks.shape[0], pad))],
                axis=1),
            equad_masks=np.concatenate(
                [ma.equad_masks, np.zeros((ma.equad_masks.shape[0], pad))],
                axis=1),
            row_mask=mask,
        ))
    return out


def _structure(ma: ModelArrays):
    """Everything of a model that is not stacked: its meta fields, which
    optional fields are present, and each phi block's kind and meta
    fields."""
    blocks = tuple(
        (type(blk),) + tuple(
            (f.name, getattr(blk, f.name)) for f in dataclasses.fields(blk)
            if f.name not in BLOCK_DATA_FIELDS[type(blk)])
        for blk in ma.phi_blocks)
    return (tuple(getattr(ma, f) for f in MODEL_META_FIELDS),
            ma.row_mask is None, blocks)


def localized_padded(mas: Sequence[ModelArrays]) -> List[ModelArrays]:
    """Per-pulsar models localized (name prefixes stripped) and padded to
    a common TOA length, their structure checked equal: the pre-stack
    form."""
    if len({ma.n for ma in mas}) > 1 or any(
            ma.row_mask is not None for ma in mas):
        # every pulsar gets a row_mask, so the models stack uniformly
        mas = pad_model_arrays(mas)
    locs = [_localize_names(ma) for ma in mas]
    s0 = _structure(locs[0])
    for ma in locs[1:]:
        if _structure(ma) != s0:
            raise ValueError(
                "pulsar models have different structure; ensembles need "
                "identical signal composition per pulsar")
    return locs


def stack_model_arrays(mas: Sequence[ModelArrays]) -> ModelArrays:
    """Stack per-pulsar frozen models along a new leading pulsar axis: each
    data field (phi blocks' included) becomes ``np.stack`` of the pulsars'
    values. Heterogeneous TOA counts are padded to the maximum via
    :func:`pad_model_arrays`."""
    locs = localized_padded(mas)

    def stack(objs, name):
        vals = [getattr(o, name) for o in objs]
        return None if vals[0] is None else np.stack(vals)

    blocks = tuple(
        dataclasses.replace(blks[0], **{
            f: stack(blks, f) for f in BLOCK_DATA_FIELDS[type(blks[0])]})
        for blks in zip(*(ma.phi_blocks for ma in locs)))
    return dataclasses.replace(
        locs[0], phi_blocks=blocks,
        **{f: stack(locs, f) for f in MODEL_DATA_FIELDS})


class EnsembleGibbs(TorchGibbs):
    """(pulsars x chains) Gibbs populations on one GPU, in the grouped
    form; ``sample`` returns chains shaped ``(niter, P, C, ...)`` with
    ``stats["n_toa"]``, the pulsars' real TOA counts
    (``ChainResult.select_pulsar`` cuts each pulsar's padding off).

    Each pulsar keeps its own parameter vector and chain population: its
    model and MH constants ride the sweep with a leading pulsar axis,
    population-covariance proposals are estimated per pulsar, and each MH
    block is one grouped kernel launch for all pulsars. ``record``,
    ``record_thin`` and ``telemetry`` as in ``TorchGibbs`` (the JAX
    ensemble's same options): records move to the host every
    ``chunk_size`` sweeps in the tier's wire dtypes, the per-TOA fields
    at the padded length, and the ``tele_*`` stats have leading ``(P,
    C)`` axes (the log-posterior per pulsar and chain).
    ``sample(reinit_diverged=True)``, :meth:`diverged_mask` (over ``(P,
    C)``) and :meth:`sample_until` (every pulsar's every parameter must
    clear the target) follow the JAX ensemble, and so does
    ``sample(spool_dir=)``: spool rows are ``(rows, P, C, ...)`` at the
    padded TOA length, and the spool's ``meta.json`` keeps the pulsars'
    real TOA counts, so a reloaded result's ``select_pulsar`` cuts the
    padding as the in-memory result's does. The TOA reduction is dense
    (the JAX ensemble builds its template with ``tnt_block_size=None``).
    ``device`` as in ``TorchGibbs`` (CUDA unless the caller asks for the
    CPU), and so is ``metrics``."""

    def __init__(self, mas: Sequence[ModelArrays], config: GibbsConfig,
                 nchains: int = 64, device=None, chunk_size: int = 50,
                 record: str = "compact8", record_thin: int = 1,
                 telemetry: bool = True, metrics=None):
        device = resolve_device(device)
        self.npulsars = len(mas)
        # the pulsars' real TOA counts, before padding to the maximum
        self.n_toa = np.array([
            int(np.asarray(ma.row_mask).sum()) if ma.row_mask is not None
            else ma.n for ma in mas])
        per_pulsar = localized_padded(mas)
        self.stacked = stack_model_arrays(per_pulsar)
        # one solo sampler per pulsar: each builds its pulsar's tensors
        # and draws its initial state; the ensemble stacks them
        solos = [TorchGibbs(ma_p, config, nchains=nchains, device=device,
                            chunk_size=chunk_size, tnt_block_size=None,
                            record=record, record_thin=record_thin,
                            telemetry=telemetry)
                 for ma_p in per_pulsar]
        self._pulsar_backends = solos
        SamplerBackend.__init__(self, self.stacked, config)
        t0 = solos[0]
        for name in ("record_mode", "_record_fields", "_record_casts",
                     "chunk_size", "record_thin", "telemetry",
                     "_pull_stream", "_mtm", "device", "nchains", "dtype",
                     "_block_size", "_ma", "_n", "_pspin",
                     "_scale_sizes", "_scale_cdf", "_white_idx",
                     "_hyper_idx", "_df_grid", "_table"):
            setattr(self, name, getattr(t0, name))
        self._batch = (self.npulsars, self.nchains)
        self.metrics = metrics
        self.last_state: Optional[ChainState] = None

        def stack(name, *lead):
            return torch.stack([getattr(s, name) for s in solos]).reshape(
                len(solos), *lead, *getattr(t0, name).shape)

        def nums(vals):
            return torch.tensor(np.asarray(vals, np.float64), dtype=self.dtype,
                                device=self.device)[:, None]

        self._y, self._sigma2 = stack("_y", 1), stack("_sigma2", 1)
        self._T = stack("_T")
        self._efac_masks = stack("_efac_masks", 1)
        self._equad_masks = stack("_equad_masks", 1)
        self._mask = None if t0._mask is None else stack("_mask", 1)
        self._efac_c = [nums([s._efac_c[g] for s in solos])
                        for g in range(len(t0._efac_c))]
        self._equad_c = [nums([s._equad_c[g] for s in solos])
                         for g in range(len(t0._equad_c))]
        self._nstat = nums([s._nstat for s in solos])
        self._prior_specs = stack("_prior_specs")
        self._theta_prior = tuple(nums([s._theta_prior[k] for s in solos])
                                  for k in range(2))
        self._phi_consts = []
        for i, (blk, k0) in enumerate(t0._phi_consts):
            ks = [s._phi_consts[i][1] for s in solos]
            const = {}
            for key, v in k0.items():
                if key == "group":          # structure, equal by the check
                    const[key] = v
                elif isinstance(v, list):
                    const[key] = [nums([k[key][g] for k in ks])
                                  for g in range(len(v))]
                elif torch.is_tensor(v):
                    const[key] = torch.stack([k[key] for k in ks])[:, None]
                else:
                    const[key] = nums([k[key] for k in ks])
            self._phi_consts.append((blk, const))

        for s in solos[1:]:
            check_kernel_structure(s, t0)
        self._schur = t0._schur
        if self._schur is not None:
            self._s_i, self._v_i = t0._s_i, t0._v_i
        self._white = None
        if t0._white is not None:
            self._white = (torch.stack([s._white[0] for s in solos]),
                           torch.stack([s._white[1] for s in solos]),
                           t0._white[2])
        self._hyper = None
        if t0._hyper is not None:
            hs = [s._hyper for s in solos]
            self._hyper = dict(
                K=torch.stack([h["K"] for h in hs]),
                sel=torch.stack([h["sel"] for h in hs]),
                specs=torch.stack([h["specs"] for h in hs]),
                phiinv_static=torch.stack(
                    [h["phiinv_static"] for h in hs])[:, None],
                logdet_static=nums([h["logdet_static"] for h in hs]),
                hyp_idx=t0._hyper["hyp_idx"], fused=t0._hyper["fused"])

    def write_pulsar(self, p: int, solo: TorchGibbs) -> None:
        """Overwrite pulsar ``p``'s model tensors in place with ``solo``'s
        (a sampler of the same structure, :func:`check_kernel_structure`),
        as the constructor stacked them: the serving slot pool admits a
        tenant this way, into tensors allocated once."""
        for name in GROUPED_ATTRS:
            for dst, src in _model_leaves(getattr(self, name),
                                          getattr(solo, name)):
                if torch.is_tensor(src):
                    dst[p].copy_(src)
                else:
                    dst[p].fill_(float(src))

    def init_state(self, seed: int = 0) -> ChainState:
        """Batched state with leading ``(P, C)`` axes: pulsar ``p``'s from
        its own solo sampler at ``seed * 1000 + p`` (prior draws of x,
        z/alpha/theta/df at the reference's starting values)."""
        states = [s.init_state(seed=seed * 1000 + p)
                  for p, s in enumerate(self._pulsar_backends)]
        return ChainState(*(torch.stack(f) for f in zip(*states)))

    def sample(self, niter: int, seed: int = 0,
               state: Optional[ChainState] = None,
               start_sweep: int = 0, spool_dir: Optional[str] = None,
               reinit_diverged: bool = False) -> ChainResult:
        """Run ``niter`` sweeps for every (pulsar, chain) population from
        ``state`` (default: :meth:`init_state` at ``seed``); records as
        ``TorchGibbs.sample`` keeps them, with the pulsar axis after the
        sweep axis and the per-TOA fields at the padded length. Pulsar
        p's chain c draws at sweep ``i`` from its own key, ``(seed, p * C
        + c, i)`` (the JAX ensemble splits its keys pulsar-major), in one
        launch of the draw kernel for every pulsar, so a run resumed at
        ``start_sweep`` from ``last_state`` continues the unbroken run
        bitwise. ``reinit_diverged`` re-draws numerically
        dead (pulsar, chain) populations from the prior at chunk
        boundaries (count in ``stats['n_reinits']``). ``spool_dir`` as in
        ``TorchGibbs.sample``."""
        self._check_run(niter, start_sweep)
        if state is None:
            state = self.init_state(seed)
        spool = self._open_spool(spool_dir, seed, start_sweep,
                                 extra_meta={"n_toa": self.n_toa.tolist()})
        cols, stats = self._run(niter, seed, state, start_sweep,
                                reinit_diverged, spool=spool)
        if spool is not None:
            from gibbs_student_t_tpu_torch.utils.spool import load_spool

            res = load_spool(spool_dir)
        else:
            res = self._to_result(cols)
        res.stats["n_toa"] = self.n_toa
        res.stats.update(stats)
        return res

    def _program_label(self) -> str:
        """The JAX ensemble's label of its grouped chunk program."""
        return f"ensemble_grouped_chunk_p{self.npulsars}_c{self.nchains}"

    def _trim(self, field: str, arr: np.ndarray) -> np.ndarray:
        """The ensemble's rows keep the padded TOA axis (``select_pulsar``
        cuts each pulsar's padding by ``stats['n_toa']``)."""
        return arr

    def sample_until(self, rhat_target: float = 1.01,
                     max_sweeps: int = 20000, check_every: int = 500,
                     seed: int = 0, state: Optional[ChainState] = None,
                     min_sweeps: int = 0,
                     min_ess: Optional[float] = None,
                     **sample_kwargs) -> ChainResult:
        """Ensemble convergence stopping: sample until EVERY pulsar's
        every parameter clears ``rhat_target`` (split-R-hat over that
        pulsar's chain axis) and, with ``min_ess``, holds that many
        pooled effective samples. Same loop and result semantics as
        ``TorchGibbs.sample_until``; the R-hat arrays in stats are shaped
        (npulsars, p)."""
        def rhat_of(window):
            # window: (rows, npulsars, nchains, p) -> (npulsars, p)
            return np.array([_rhat_per_param(window[:, pl])
                             for pl in range(window.shape[1])])

        def ess_of(window):
            return np.array([_ess_per_param(window[:, pl])
                             for pl in range(window.shape[1])])

        def sample_fn(length, st, start):
            return self.sample(niter=length, seed=seed, state=st,
                               start_sweep=start, **sample_kwargs)

        return _sample_until_loop(
            sample_fn, lambda: self.last_state, self.record_thin, rhat_of,
            rhat_target, max_sweeps, check_every, min_sweeps, state,
            spool_mode=bool(sample_kwargs.get("spool_dir")),
            ess_of=ess_of, min_ess=min_ess)

    def lnlikelihood(self, x, z=None, alpha=None) -> float:
        raise NotImplementedError(
            "an ensemble has one likelihood per pulsar: call lnlikelihood "
            "on that pulsar's TorchGibbs")
