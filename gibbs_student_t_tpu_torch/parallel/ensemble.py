"""Multi-pulsar, multi-chain ensembles: ``EnsembleGibbs``, on one GPU or
over a mesh of blocks.

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

With ``mesh=`` (parallel/mesh.py, parallel/multihost.py) the ``(P, C)``
population is cut into blocks, as the JAX ensemble's ``shard_map`` cuts
it: pulsars over the mesh's ``'pulsar'`` axis, chains over its ``'chain'``
axis. Each block is an ensemble of its own over its pulsars and chains,
on its device, and launches the same grouped kernels; it draws from the
global chain keys and starts from its slice of the global initial state,
so a chain's numbers are the ones it gets unsharded. The sweep needs no
communication. Before each adapting chunk the population covariance
gathers each pulsar's chains across the chain axis (``torch.cat``
within a process, ``all_gather`` over the line's process group across
processes) and applies the unsharded update to them. Each chunk is issued
on every block before any block's records are read, so blocks on
different cards overlap. In one process the result is gathered into
global ``(P, C)`` order and equals the unsharded run's up to the
float32 rounding of the covariance estimate over another batch; a 1 x 1
mesh is the unsharded run, bit for bit. When the mesh spans processes,
each process runs only its own blocks and ``sample`` returns their rows
(see :meth:`EnsembleGibbs.sample`).

The JAX package also has an unrolled form (``unroll=True``), which bakes
each pulsar's constants into its own XLA trace as literals. Eager PyTorch
has no trace to bake into, and the grouped form already launches once per
block for every pulsar, so the port has only the grouped form; the
unrolled form is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

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
from gibbs_student_t_tpu_torch.ops import rng
from gibbs_student_t_tpu_torch.parallel.mesh import process_rank

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


class _Block(NamedTuple):
    """One block of an ensemble over a mesh: its position ``(i, j)`` on the
    pulsar and chain axes, its index in ``mesh.devices``, the ensemble
    that runs it, its global ``chains`` and its ``window`` of the ``(P,
    C)`` population this process holds."""

    i: int
    j: int
    index: tuple
    sampler: "EnsembleGibbs"
    chains: slice
    window: tuple


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
    CPU), and so is ``metrics``.

    ``mesh`` (a ``parallel.mesh.Mesh`` with axes ``'pulsar'`` and
    ``'chain'``; a missing axis counts as size 1) cuts the population into
    blocks (the module docstring): block ``(i, j)`` holds pulsars ``i P/nP
    ...`` and chains ``j C/nC ...`` on ``mesh.devices`` at that position.
    Both populations must split evenly, and ``device`` is not given with
    it (each block's device is the mesh's). A state (``init_state``,
    ``last_state``, ``sample(state=)``) is then the ``(P, C)`` population
    this process holds, on its first block's device.

    ``dtype`` as in ``TorchGibbs`` (the JAX ensemble's ``dtype``): passed
    to every pulsar's sampler, so the grouped kernels launch their
    float64 forms under ``torch.float64``."""

    def __init__(self, mas: Sequence[ModelArrays], config: GibbsConfig,
                 nchains: int = 64, device=None, chunk_size: int = 50,
                 record: str = "compact8", record_thin: int = 1,
                 telemetry: bool = True, metrics=None, mesh=None,
                 dtype=torch.float32):
        self.mesh = mesh
        if mesh is not None:
            if device is not None:
                raise ValueError(
                    "pass device= or mesh=, not both: a mesh names the "
                    "device of each of its blocks")
            self._build_blocks(mas, config, nchains, metrics, dict(
                chunk_size=chunk_size, record=record,
                record_thin=record_thin, telemetry=telemetry, dtype=dtype))
            return
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
                            telemetry=telemetry, dtype=dtype)
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
        # (first pulsar, first chain, chains a pulsar) of this ensemble in
        # the population its keys and initial state are drawn for: a
        # block of a mesh is a window of the global one
        self._origin = (0, 0, self.nchains)
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

    # ------------------------------------------------------------------
    # the ensemble over a mesh
    # ------------------------------------------------------------------

    def _build_blocks(self, mas, config, nchains, metrics, opts) -> None:
        """The blocks of this process (the class docstring), each an
        ensemble of its pulsars and chains on its device, and the
        attributes the chunked loop and the results read."""
        mesh = self.mesh
        unknown = {a: n for a, n in mesh.shape.items()
                   if a not in ("pulsar", "chain") and n != 1}
        if unknown:
            raise ValueError(f"mesh axes {unknown}: an ensemble splits only "
                             "'pulsar' and 'chain'")
        P, C = len(mas), int(nchains)
        nP, nC = mesh.size("pulsar"), mesh.size("chain")
        if P % nP or C % nC:
            raise ValueError(
                f"{P} pulsars x {C} chains do not split evenly over the "
                f"mesh's pulsar axis ({nP}) and chain axis ({nC})")
        Pb, Cb = P // nP, C // nC
        self.npulsars, self.nchains = P, C
        self.n_toa = np.array([
            int(np.asarray(ma.row_mask).sum()) if ma.row_mask is not None
            else ma.n for ma in mas])
        # padded to the largest pulsar of all, so every block's records
        # share one TOA length
        per_pulsar = localized_padded(mas)
        self.stacked = stack_model_arrays(per_pulsar)
        SamplerBackend.__init__(self, self.stacked, config)
        self.metrics = metrics
        self.last_state = None
        me = process_rank()
        names = mesh.axis_names
        own = []
        for i in range(nP):
            for j in range(nC):
                index = tuple(i if a == "pulsar" else j if a == "chain"
                              else 0 for a in names)
                if mesh.ranks[index] == me:
                    own.append((i, j, index))
        if not own:
            raise ValueError(f"process {me} owns no block of {mesh}")
        rows = sorted({i for i, _, _ in own})
        cols = sorted({j for _, j, _ in own})
        if (len(own) != len(rows) * len(cols)
                or rows != list(range(rows[0], rows[-1] + 1))
                or cols != list(range(cols[0], cols[-1] + 1))):
            raise ValueError(f"the blocks of process {me} do not form a "
                             f"rectangle of {mesh}")
        self.pulsar_slice = slice(rows[0] * Pb, (rows[-1] + 1) * Pb)
        self.chain_slice = slice(cols[0] * Cb, (cols[-1] + 1) * Cb)
        self._blocks = []
        for i, j, index in own:
            ps, cs = slice(i * Pb, (i + 1) * Pb), slice(j * Cb, (j + 1) * Cb)
            blk = EnsembleGibbs(per_pulsar[ps], config, nchains=Cb,
                                device=mesh.devices[index], **opts)
            blk._origin = (ps.start, cs.start, C)
            window = (slice(ps.start - self.pulsar_slice.start,
                            ps.stop - self.pulsar_slice.start),
                      slice(cs.start - self.chain_slice.start,
                            cs.stop - self.chain_slice.start))
            self._blocks.append(_Block(i, j, index, blk, cs, window))
        self.spans_processes = len(set(mesh.ranks.flat)) > 1
        t0 = self._blocks[0].sampler
        for name in ("record_mode", "_record_fields", "_record_casts",
                     "chunk_size", "record_thin", "telemetry", "device",
                     "dtype", "_ma", "_n"):
            setattr(self, name, getattr(t0, name))
        self._batch = (self.pulsar_slice.stop - self.pulsar_slice.start,
                       self.chain_slice.stop - self.chain_slice.start)

    def _parts(self):
        if self.mesh is None:
            return super()._parts()
        return [(b.sampler, b.window) for b in self._blocks]

    def _split(self, state: ChainState) -> list:
        """Each block's window of ``state``, on the block's device."""
        if self.mesh is None:
            return super()._split(state)
        return [ChainState(*(f[b.window].to(b.sampler.device).contiguous()
                             for f in state)) for b in self._blocks]

    def _join(self, states: list, device=None) -> ChainState:
        if self.mesh is None or len(states) == 1:
            return states[0]
        dev = self.device if device is None else device
        rows = {}
        for b, st in zip(self._blocks, states):
            rows.setdefault(b.i, []).append((b.j, st))

        def row(pieces, k):
            return torch.cat([st[k].to(dev) for _, st in sorted(
                pieces, key=lambda t: t[0])], dim=1)

        return ChainState(*(
            torch.cat([row(rows[i], k) for i in sorted(rows)], dim=0)
            for k in range(len(ChainState._fields))))

    def _pre_chunk(self, states: list) -> list:
        """Each pulsar's proposal covariance from all its chains: a
        pulsar row's blocks gather their x along the chain axis (in
        this process, then over the line's process group) and the
        unsharded update (:meth:`_prop_cov_update`, which reads the
        previous factor of the row's first chain here) is applied to the
        whole population; each block keeps its chains' slice."""
        if self.mesh is None:
            return super()._pre_chunk(states)
        out = list(states)
        by_row = {}
        for k, b in enumerate(self._blocks):
            by_row.setdefault(b.i, []).append(k)
        for ks in by_row.values():
            ks = sorted(ks, key=lambda k: self._blocks[k].j)
            first = self._blocks[ks[0]]
            dev = first.sampler.device
            xs = [states[k].x.to(dev) for k in ks]
            x_row = xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)
            group = self.mesh.group("chain", first.index)
            if group is not None:
                x_row = self._gather_chains(x_row, group, first)
            new = first.sampler._prop_cov_update(
                states[ks[0]]._replace(x=x_row)).mh_cov_chol
            for k in ks:
                b = self._blocks[k]
                out[k] = states[k]._replace(mh_cov_chol=new[:, b.chains].to(
                    b.sampler.device).contiguous())
        return out

    def _gather_chains(self, x_row, group, first: _Block):
        """``x_row`` (this process's chains of a pulsar row) gathered with
        the other processes' chains of that row over ``group``, in chain
        order: ``all_gather`` through the host under ``gloo``, of the
        device tensors under ``nccl``."""
        import torch.distributed as dist

        names = self.mesh.axis_names
        line = [slice(None) if a == "chain" else first.index[k]
                for k, a in enumerate(names)]
        ranks = self.mesh.ranks[tuple(line)]
        members = sorted(set(ranks.tolist()))
        start = {r: min(j for j, rr in enumerate(ranks.tolist()) if rr == r)
                 for r in members}
        via_host = dist.get_backend(group) == "gloo"
        buf = (x_row.cpu() if via_host else x_row).contiguous()
        got = [torch.empty_like(buf) for _ in members]
        dist.all_gather(got, buf, group=group)
        order = sorted(range(len(members)), key=lambda k: start[members[k]])
        return torch.cat([got[k] for k in order], dim=1).to(x_row.device)

    def init_state(self, seed: int = 0) -> ChainState:
        """Batched state with leading ``(P, C)`` axes: pulsar ``p``'s from
        its own solo sampler at ``seed * 1000 + p`` (prior draws of x,
        z/alpha/theta/df at the reference's starting values). Over a mesh,
        the blocks' slices of that global state, gathered."""
        if self.mesh is not None:
            return self._join([b.sampler.init_state(seed)
                               for b in self._blocks])
        p0, c0, C = self._origin
        states = [s.init_state(x0=s._x0_draws(seed * 1000 + p0 + k, C)[
                      c0:c0 + self.nchains])
                  for k, s in enumerate(self._pulsar_backends)]
        return ChainState(*(torch.stack(f) for f in zip(*states)))

    def chain_keys(self, seed: int) -> torch.Tensor:
        """``(P, C, 2)`` key words of the run ``seed``, pulsar-major (the
        JAX ensemble's ``chain_keys``: pulsar p's chain c is key ``p * C +
        c``). The words are the port's Philox keys
        (``ops/rng.chain_key``), not the JAX package's threefry keys."""
        return self._chain_keys(seed)

    def _chain_keys(self, seed: int) -> torch.Tensor:
        """``(P, C, 2)`` key words: pulsar p's chain c is ``p * C + c`` of
        the population (``_origin``), as the JAX ensemble splits its keys
        pulsar-major."""
        p0, c0, C = self._origin
        idx = ((p0 + np.arange(self.npulsars))[:, None] * C
               + c0 + np.arange(self.nchains))
        return rng.chain_keys(seed, idx, device=self.device)

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
        ``TorchGibbs.sample``.

        On a mesh that spans processes, each process runs its own blocks
        and the result holds their rows, ``(niter, Pl, C_l, ...)``: its
        ``stats`` name their global pulsars and chains
        (``pulsar_start``/``pulsar_stop``, ``chain_start``/``chain_stop``;
        ``n_toa`` is theirs). As in the JAX package, where no host can
        ``device_get`` what another holds, the whole population is on no
        process, so ``spool_dir`` (and :meth:`sample_until`) raise
        ``NotImplementedError`` there."""
        self._check_run(niter, start_sweep)
        if spool_dir is not None:
            self._one_process("spool_dir")
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
        if self.mesh is not None and self.spans_processes:
            ps, cs = self.pulsar_slice, self.chain_slice
            res.stats["n_toa"] = self.n_toa[ps]
            res.stats.update(pulsar_start=np.asarray(ps.start),
                             pulsar_stop=np.asarray(ps.stop),
                             chain_start=np.asarray(cs.start),
                             chain_stop=np.asarray(cs.stop))
        res.stats.update(stats)
        return res

    def _one_process(self, what: str) -> None:
        """Refuse ``what`` on a mesh that spans processes."""
        if self.mesh is not None and self.spans_processes:
            raise NotImplementedError(
                f"{what} on a mesh that spans processes: each process "
                "holds only its own blocks' rows, and no process has the "
                "whole population to spool or to test for convergence; "
                "run it on a mesh of one process")

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
        (npulsars, p). Not on a mesh that spans processes."""
        self._one_process("sample_until")

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
