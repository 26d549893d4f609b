"""The slot pool on one GPU: every lane a chain, tenants in 16-lane groups.

Counterpart of ``gibbs_student_t_tpu/serve/pool.py``. A :class:`SlotPool`
owns ``nlanes`` lanes, each an independent chain, and serves several
tenants (different models, seeds, chain counts and sweep budgets) in one
sweep: every MH block is one kernel launch for every lane, whatever
tenant owns it. Tenants are admitted into whole groups of
``LANES_GROUP`` = 16 lanes, so each aligned 16-lane tile belongs to one
tenant (the tile-uniform ``gid`` contract of ``ops/lanes.py``).

The state is held as ``(G, 16, ...)``, G = nlanes / 16 groups, and each
group's model and MH constants as ``(G, 1, ...)``: the ensemble's layout
(``parallel/ensemble.py``) with one "pulsar" per group, so the sweep is
the ensemble's. Its MH blocks and TOA reduction go to the lanes entries:
``white_mh_lanes``, ``hyper_mh_lanes`` (the grouped kernels with 16
chains a group) and ``tnt_lanes`` (the Gram kernel, one basis per group);
the factorizations and solves to ``chol_fused`` and ``tri_solve_T``, as on
the solo path (so does the JAX pool). Admission writes the tenant's model
into its groups' slices of tensors allocated once at construction; no
kernel is built or rebuilt per tenant (the eager counterpart of the JAX
pool's one compiled program).

Randomness (the JAX pool's per-lane philox keys): each lane carries its
tenant chain's key words and the tenant-local index of its next sweep, in
``(G, 16, 2)`` and ``(G, 16)`` device tensors written at admission (pad
lanes and free groups keep them parked at zeros). Every sweep draws every
lane's numbers in one launch of the draw kernel (``ops/rng.sweep_draws``)
at the lanes' own sweep indices, with the solo sampler's draw code
(``TorchGibbs._draw``). Chain k of a tenant with seed s draws at its sweep
i what chain k of ``TorchGibbs.sample(seed=s)`` draws at sweep i: the
numbers depend on neither its lanes nor its neighbours nor its chain
count, so a tenant alone in the pool is the solo sampler
(tests/test_torch_serve.py), wherever its lanes fall.

Lanes not owned by a tenant's chains (free groups, and the pad lanes of a
tenant whose chain count is not a multiple of 16) are frozen at the end
of each quantum, bitwise: their state is the quantum's starting state.
A tenant's pad lanes start as copies of its chain 0 (finite, discarded).

A quantum is dispatched by :meth:`SlotPool.dispatch_quantum`, which
returns the records still on the device, the quantum's telemetry and,
when asked, a copy of the post-quantum state (the checkpoint of a spooled
tenant, read by the pipelined server's drain thread while the next
quantum runs); :meth:`SlotPool.run_quantum` is its serial form.

Telemetry (``telemetry=True``, the default, as in the JAX pool): every
lane's ``obs/telemetry.Telemetry`` counters ride each quantum (per-block
accept sums, the non-finite count and the sticky ``diverged`` flag a
sweep, the log-posterior at the quantum's end); they read the state only,
so the chains are bitwise the same with it off. The lane-health writes
act on them at quantum boundaries (serve/server.py): :meth:`quarantine_lanes`
freezes lanes without freeing their groups, :meth:`reinit_lanes` writes
fresh chains into lanes and re-activates them, and :meth:`poison_lanes`
writes NaN into a lane's parameters (the ``lane_nan`` fault).

Adaptive block scans (serve/adapt.py; ``GST_ADAPT_SCAN``, resolved once at
construction into :attr:`SlotPool.adaptive`): an adaptive pool keeps a
host ``(nlanes, NBLOCKS)`` buffer of per-lane block gates with its own
dirty flag, which :meth:`SlotPool.set_block_gates` writes (the server's
drain, at a tenant's boundaries) and the next dispatch uploads; admission
and eviction write ones. While every lane's gates are ones the sweep gets
``block_gates=None``, the ungated sweep op for op, so launches a sweep
change only while some tenant thins. A gated block is computed and
discarded, as in the JAX pool: its kernel still launches.

Record tiers (``record``, the JAX pool's and ``TorchGibbs``'s: ``"full"``,
``"compact"``, ``"compact8"``, the default, and ``"light"``): a quantum's
records are cast to the tier's wire dtypes on the device, as the quantum
ends (``torch_backend.record_tuple``: z bit-packed, b and alpha to
bfloat16, pout to float16 or uint8), so the drain copies the narrow bytes.
:meth:`SlotPool.wire_host` holds them on the host uncast,
:meth:`SlotPool.tenant_wire` slices one tenant's lanes out, and
:meth:`SlotPool.materialize_tenant` turns a tenant's accumulated slices
into float32 once (the server does so at its finalize; a spool or an
``on_chunk`` consumer gets :meth:`SlotPool.tenant_quantum_records` each
quantum). The casts are elementwise, so a tenant's records are those of
``TorchGibbs(record=...)`` on the same chains.

Heterogeneous pools (``heterogeneous=True``): the template is padded with
:func:`parallel.ensemble.pad_model_arrays` to its own n, so every group
carries a row mask and its own statistical TOA count (``_mask``,
``_nstat``), and a tenant with fewer TOAs than the pool is admitted padded
with masked suffix rows, as the ensemble pads its pulsars; its per-TOA
records are cut back to its ``n_real`` TOAs. The lanes kernels take the
masked operands as they are (a zero mask row in the white constants, zero
suffix rows of T and y). A homogeneous pool keeps the count a number and
a tenant's chains bitwise ``TorchGibbs.sample``'s; a heterogeneous pool's
agree with it in law (the JAX pool's rule).

Thinning (``record_thin=t``, the JAX pool's and ``TorchGibbs``'s; the
quantum must be a multiple of it): a quantum records the state before
every t-th sweep, ``quantum // t`` rows, while the draws, the
Robbins-Monro steps and the telemetry stay per sweep. A tenant's row k is
bitwise row k·t of the same tenant at full rate, and a tenant alone in
the pool is ``TorchGibbs(record_thin=t).sample``.

Admission writes (``GST_SERVE_SCATTER``, strictly ``auto|1|0``, resolved
once at construction into :attr:`SlotPool.scatter`, the JAX pool's
gate): on (``auto`` and ``1``), :meth:`SlotPool.write_tenant`,
:meth:`SlotPool.reinit_lanes` and :meth:`SlotPool.poison_lanes` write
their lanes' rows into the state on the device (``index_copy_``) and
:meth:`SlotPool.tenant_state` gathers one tenant's
rows there. ``0`` is the JAX pool's reference arm, the host bounce: the
first write or read after a quantum pulls the whole lane state to the
host, the writes go into that copy, and the next dispatch uploads it
whole. Both arms write the same values, so chains, spools and recovery
are bitwise the same; :meth:`SlotPool.admission_stats` counts what each
admission moved (the delta and its lane index, or the delta and the
whole state down and up), :meth:`SlotPool.backend_info` says which arm
runs where.

Spans (``spans``, the server's ``obs/spans.SpanRecorder``): each dispatch
records ``operand_upload`` around the upload of the lane flags, gates and
(bounce arm) state when it copies anything, and ``chunk_call`` around the
quantum's launches, both on the dispatch role; host clocks, no device
synchronisation.

Not ported from the JAX pool: buffer donation (the eager pool writes the
state in place; there is no program to donate to). Like the JAX pool it
refuses population-covariance adaptation; it also refuses multiple-try
Metropolis, which the lanes entries do not cover.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from gibbs_student_t_tpu_torch.backends.torch_backend import (
    NBLOCKS,
    ChainState,
    SweepDraws,
    TorchGibbs,
    record_tuple,
    resolve_device,
)
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.models.pta import ModelArrays
from gibbs_student_t_tpu_torch.obs.introspect import (
    program_begin,
    program_end,
)
from gibbs_student_t_tpu_torch.obs.spans import ROLE_DISPATCH
from gibbs_student_t_tpu_torch.obs.telemetry import (
    telemetry_init,
    telemetry_update,
)
from gibbs_student_t_tpu_torch.ops import _cuda, rng
from gibbs_student_t_tpu_torch.ops.hyper_mh import hyper_mh_lanes
from gibbs_student_t_tpu_torch.ops.lanes import LANES_GROUP
from gibbs_student_t_tpu_torch.ops.tnt import tnt_lanes
from gibbs_student_t_tpu_torch.ops.white_mh import white_mh_lanes
from gibbs_student_t_tpu_torch.parallel.ensemble import (
    EnsembleGibbs,
    _localize_names,
    pad_model_arrays,
)
from gibbs_student_t_tpu_torch.serve.adapt import adapt_scan_enabled
from gibbs_student_t_tpu_torch.utils.env import env_choice

#: gid of lanes no tenant owns (whole free groups)
FREE_GID = -1


def serve_scatter_enabled() -> bool:
    """The validated ``GST_SERVE_SCATTER`` (strictly ``auto|1|0``, unset
    is ``auto``): True for the admission writes on the device (``auto``,
    ``1``), False for the host bounce (``0``, the reference arm). A pool
    reads it once, at construction."""
    return env_choice("GST_SERVE_SCATTER") != "0"


class TenantSlot:
    """Book-keeping of one admitted tenant (host side)."""

    def __init__(self, tenant_id: int, lanes: np.ndarray, nchains: int,
                 niter: int, start_sweep: int, seed: int,
                 n_real: Optional[int] = None):
        self.tenant_id = tenant_id
        self.lanes = lanes            # (ceil(nchains/16)*16,) lane indices
        self.nchains = nchains        # real chains; lanes[nchains:] pad
        self.niter = niter
        self.start_sweep = start_sweep
        self.done_sweeps = 0          # tenant-local sweeps served so far
        self.seed = seed
        # the tenant's own TOA count (the pool's when None, set at
        # admission): its per-TOA records are cut back to it
        self.n_real = n_real
        # a cancel (or a preemption, which is a cancel whose tenant is
        # requeued from its checkpoint) landing while a quantum is in
        # flight: the lanes freeze at the next quantum boundary
        self.cancelled = False
        self.preempted = False
        # a failed tenant freezes and releases at the next boundary as a
        # cancel does; where and why it failed (the first cause only)
        self.failed = False
        self.fail_where = ""
        self.fail_cause = None
        # tenant-chain indices frozen by the quarantine policy, and the
        # chains re-drawn by the reinit policy
        self.quarantined: set = set()
        self.n_reinits = 0

    @property
    def chain_lanes(self) -> np.ndarray:
        return self.lanes[:self.nchains]

    @property
    def groups(self) -> np.ndarray:
        return self.lanes[::LANES_GROUP] // LANES_GROUP

    @property
    def remaining(self) -> int:
        return self.niter - self.done_sweeps


def _flat(t):
    """A ``(G, 16, ...)`` lane tensor as ``(B, ...)`` (a view)."""
    return t.view(t.shape[0] * t.shape[1], *t.shape[2:])


class _LaneSampler(EnsembleGibbs):
    """The pool's sweep: the ensemble's over G groups of 16 lanes, with
    the white and hyper MH blocks and the TOA reduction taken by the
    lanes entries, and the Robbins-Monro step per lane."""

    def __init__(self, template: ModelArrays, config: GibbsConfig,
                 ngroups: int, device):
        super().__init__([template] * ngroups, config,
                         nchains=LANES_GROUP, device=device)
        self._pulsar_backends = None
        G = ngroups
        self.gid = torch.full((G, LANES_GROUP), FREE_GID, dtype=torch.int32,
                              device=self.device)
        self.eta = None             # (quantum, G, 16, 1) while adapting

    @staticmethod
    def _per_lane(t):
        """A per-group ``(G, ...)`` constant as a per-lane ``(G, 16, ...)``
        operand: a broadcast view, no copy."""
        return t[:, None].expand(t.shape[0], LANES_GROUP, *t.shape[1:])

    def _white_block(self, x, az, yred2, draws):
        rows, specs, var = self._white
        return white_mh_lanes(
            x, az, yred2, draws.dx_w, draws.logu_w, self._per_lane(rows),
            self._per_lane(specs), _flat(self.gid), var)

    def _tnt(self, nvec):
        return tnt_lanes(self._T[:, None].expand(-1, LANES_GROUP, -1, -1),
                         self._y.expand(-1, LANES_GROUP, -1), nvec,
                         _flat(self.gid))

    def _hyper_block(self, x, Sh, rh, base, draws):
        hp = self._hyper
        if not hp["fused"]:
            return super()._hyper_block(x, Sh, rh, base, draws)
        dS0 = torch.diagonal(Sh, dim1=-2, dim2=-1) + hp["phiinv_static"]
        return hyper_mh_lanes(
            x, Sh, dS0, rh, base, draws.dx_h, draws.logu_h,
            *(self._per_lane(hp[k]) for k in ("K", "sel", "specs")),
            _flat(self.gid), hp["hyp_idx"], self.config.jitter)

    def _rm_step(self, sweep):
        # sweep is the step within the quantum; each lane's step size was
        # taken at its tenant's own sweep index (SlotPool._eta_table)
        return self.eta[sweep]


class SlotPool:
    """``nlanes`` single-chain lanes behind one sweep.

    ``quantum`` is the scheduling granularity in sweeps: every
    :meth:`run_quantum` advances all lanes by that many sweeps (tenants'
    budgets are multiples of it). ``template_ma`` fixes the pool's model
    structure: TOA count, basis size, parameter structure, Schur split,
    noise groups and prior kinds; tenants must match it (the server
    validates at admission), or, with ``heterogeneous=True``, have at
    most its TOA count (see the module docstring). ``record`` is the
    record tier, ``"compact8"`` (the default, as the JAX pool's),
    ``"compact"``, ``"full"`` or ``"light"``, as in ``TorchGibbs``.
    ``device`` as in ``TorchGibbs``: CUDA unless the caller asks for the
    CPU. ``telemetry`` carries every lane's ``Telemetry`` through each
    quantum (the lane-health policies read its ``diverged`` flags).
    ``group`` is the admission granularity in lanes, a multiple of 16;
    ``record_thin`` records every that many sweeps (the quantum must be a
    multiple of it); ``metrics`` takes the first quantum's program record
    and ``spans`` the pool's dispatch spans (see the module
    docstring). ``dtype`` is the JAX pool's; the pool runs float32 only
    yet: any other dtype raises ``NotImplementedError`` (its lanes kernels
    have no float64 form, ROADMAP A-11b)."""

    def __init__(self, template_ma: ModelArrays, config: GibbsConfig,
                 nlanes: int = 1024, quantum: int = 25,
                 group: int = LANES_GROUP, device=None,
                 record: str = "compact8", telemetry: bool = True,
                 heterogeneous: bool = False, record_thin: int = 1,
                 metrics=None, spans=None, dtype=torch.float32):
        device = resolve_device(device)
        if dtype != torch.float32:
            # the CPU too: the pool's buffers and lanes entries are float32
            raise NotImplementedError(
                f"SlotPool runs float32 only, got {dtype}: its float64 form "
                "(the lanes entries tnt_lanes, white_mh_lanes, "
                "hyper_mh_lanes, chol_fused_lanes, tri_solve_T_lanes) is "
                "ROADMAP A-11b")
        if group % LANES_GROUP:
            raise ValueError(
                f"group ({group}) must be a multiple of {LANES_GROUP}: the "
                "lanes kernels need per-lane constants uniform within "
                f"every aligned {LANES_GROUP}-lane tile")
        if nlanes < group or nlanes % group:
            raise ValueError(f"nlanes ({nlanes}) must be a positive "
                             f"multiple of the admission group ({group})")
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        if record_thin < 1:
            raise ValueError(f"record_thin must be >= 1, got {record_thin}")
        if quantum % record_thin:
            raise ValueError(f"quantum ({quantum}) must be a multiple "
                             f"of record_thin ({record_thin})")
        if config.mh.adapt_cov:
            raise ValueError(
                "the serve slot pool does not support population-"
                "covariance adaptation (adapt_cov): proposal factors "
                "couple chains across one tenant's population, which "
                "has no lane-local form")
        if config.mh.mtm_tries >= 2:
            raise ValueError(
                "the serve slot pool runs single-try MH blocks; multiple-"
                "try Metropolis has no lanes form")
        tmpl = _localize_names(template_ma)
        if tmpl.row_mask is not None:
            raise ValueError("template_ma must be an unpadded model "
                             "(its n defines the pool TOA axis)")
        self.heterogeneous = bool(heterogeneous)
        if self.heterogeneous:
            # every group carries a row mask and its own TOA count
            (tmpl,) = pad_model_arrays([tmpl], n_to=tmpl.n)
        self.nlanes, self.quantum, self.group = nlanes, quantum, group
        self.config, self.device = config, device
        self.telemetry = bool(telemetry)
        self.template_ma = tmpl
        self.n_pool = tmpl.n
        G = nlanes // LANES_GROUP
        self.sampler = _LaneSampler(tmpl, config, G, device)
        # the draws of every lane (_draw reads only structure and the
        # state, which the pool's tenants share with the template), the
        # Robbins-Monro steps and the lanes' first state: the template's
        # (its record checks and tier: the wire fields and casts)
        self.drawer = TorchGibbs(tmpl, config, nchains=nlanes,
                                 device=device, chunk_size=quantum,
                                 tnt_block_size=None, record=record,
                                 record_thin=record_thin)
        self.record = self.drawer.record_mode
        self.record_thin = self.drawer.record_thin
        self.fields = self.drawer._record_fields
        self.casts = self.drawer._record_casts
        # the bytes of the last quantum's records in wire dtypes
        self.wire_bytes = 0
        # the run's record of the first quantum (obs/introspect.py), open
        # from its dispatch to its records' arrival on the host
        # (wire_host), and the registry its compile event goes to
        self._program = None
        self.metrics = metrics
        self.spans = spans
        # the admission writes' arm, resolved once; the bounce arm's host
        # copy of the lane state (canonical while set: from the first
        # boundary write or read after a quantum to the next dispatch);
        # the bytes each admission moved
        self.scatter = serve_scatter_enabled()
        self._host: Optional[ChainState] = None
        self._admit_bytes: list = []
        if self.heterogeneous:
            self._lane_theta_shapes()
        flat = self.drawer.init_state(seed=0)
        self.state = ChainState(*(t.reshape(G, LANES_GROUP, *t.shape[1:])
                                  for t in flat))
        # one sweep's raw draws for every lane, allocated once; each
        # lane's key words and next tenant-local sweep (host mirrors,
        # uploaded with the flags)
        self._raw = torch.empty(nlanes * self.drawer._table.width,
                                dtype=torch.float32, device=device)
        self._keys_np = np.zeros((nlanes, 2), np.int64)
        self._sweep_np = np.zeros(nlanes, np.int64)
        self._lane_keys = torch.zeros((G, LANES_GROUP, 2), dtype=torch.int64,
                                      device=device)
        self._lane_sweep = torch.zeros((G, LANES_GROUP), dtype=torch.int64,
                                       device=device)
        self._steps = torch.arange(quantum, dtype=torch.int64,
                                   device=device)[:, None, None]
        # host-authoritative lane flags, uploaded at the next quantum
        self._active_np = np.zeros(nlanes, bool)
        self._gid_np = np.full(nlanes, FREE_GID, np.int32)
        self._active = torch.zeros((G, LANES_GROUP), dtype=torch.bool,
                                   device=device)
        self._dirty = True
        self._slots: Dict[int, TenantSlot] = {}
        self._next_sweep: Dict[int, int] = {}
        # adaptive block scans: the lanes' gates, host-authoritative, with
        # their own dirty flag and lock (the server's drain thread writes
        # them while the dispatch thread may be uploading)
        self.adaptive = adapt_scan_enabled()
        self._bg_np = np.ones((nlanes, NBLOCKS), np.float32)
        self._bg_lock = threading.Lock()
        self._bg_dirty = False
        self._bg_ones = True
        self._bg = (torch.ones((G, LANES_GROUP, NBLOCKS),
                               dtype=torch.float32, device=device)
                    if self.adaptive else None)

    # ------------------------------------------------------------------
    # lane writes
    # ------------------------------------------------------------------

    def write_tenant(self, slot: TenantSlot, backend: TorchGibbs,
                     state: ChainState) -> None:
        """Admit a tenant into its lanes: its model into its groups' slices
        of the model tensors, its chains' state into its lanes (pad lanes:
        copies of chain 0), its lanes marked active and owned.
        ``backend`` is a ``TorchGibbs`` of the tenant's model on the pool's
        device (padded to the pool's TOA count in a heterogeneous pool),
        its structure already checked against the template; its numbers
        are copied, the pool keeps no reference to it."""
        lanes, k = slot.lanes, slot.nchains
        if slot.n_real is None:
            slot.n_real = self.n_pool
        for g in slot.groups:
            self.sampler.write_pulsar(int(g), backend)
        if self.heterogeneous:
            self._lane_theta_shapes()
        delta = {}
        for f, val in zip(ChainState._fields, state):
            if len(lanes) > k:
                val = torch.cat([val, val[:1].expand(len(lanes) - k,
                                                     *val.shape[1:])])
            delta[f] = val
        self._admit_bytes.append(self._write_rows(lanes, delta))
        self._active_np[lanes[:k]] = True
        self._active_np[lanes[k:]] = False
        self._gid_np[lanes] = slot.tenant_id
        self._keys_np[lanes[:k]] = rng.chain_keys(slot.seed,
                                                  np.arange(k)).numpy()
        self._keys_np[lanes[k:]] = 0
        self._sweep_np[lanes[:k]] = slot.start_sweep
        self._sweep_np[lanes[k:]] = 0
        self._dirty = True
        self.set_block_gates(lanes, np.ones(NBLOCKS, np.float32))
        self._slots[slot.tenant_id] = slot
        self._next_sweep[slot.tenant_id] = slot.start_sweep

    def _lane_theta_shapes(self) -> None:
        """Give the drawer each lane's statistical TOA count and theta
        prior (``(nlanes,)``, from its group's): the draws' Beta shapes of
        the outlier fraction (``TorchGibbs._theta_shapes``) read them, and
        in a heterogeneous pool they differ by group."""
        smp = self.sampler

        def lanes(t):
            return smp._per_lane(t).reshape(-1)

        self.drawer._nstat = lanes(smp._nstat)
        self.drawer._theta_prior = tuple(lanes(t) for t in smp._theta_prior)

    def _pull_state(self) -> bool:
        """The bounce arm's pull: make the host copy of the lane state
        canonical (a blocking copy, which waits for the quanta issued).
        Returns whether it copied (False: the copy was current)."""
        if self._host is not None:
            return False
        self._host = ChainState(*(t.to("cpu", copy=True)
                                  for t in self.state))
        return True

    def _write_rows(self, lanes, rows: Dict[str, torch.Tensor]) -> int:
        """Write ``rows[f]`` (one row a lane) into the lanes' rows of
        state field ``f``: on the device under the scatter arm, into the
        host copy (pulled first if it is not current) under the bounce.
        Returns the bytes moved as :meth:`admission_stats` counts them:
        the rows and the lane index, or the rows and, when it pulled, the
        whole state down and back up."""
        if self.scatter:
            idx = torch.as_tensor(np.asarray(lanes, np.int64),
                                  device=self.device)
            moved = idx.numel() * idx.element_size()
            for f, val in rows.items():
                _flat(getattr(self.state, f)).index_copy_(
                    0, idx, val.to(self.device))
                moved += val.numel() * val.element_size()
            return moved
        pulled = self._pull_state()
        idx = torch.as_tensor(np.asarray(lanes, np.int64))
        moved = (2 * sum(t.numel() * t.element_size() for t in self._host)
                 if pulled else 0)
        for f, val in rows.items():
            _flat(getattr(self._host, f)).index_copy_(0, idx, val.cpu())
            moved += val.numel() * val.element_size()
        return moved

    def evict(self, slot: TenantSlot) -> None:
        """Free a tenant's lanes: inactive, their groups free. Their model
        and state stay parked (frozen) until an admission overwrites
        them."""
        self._active_np[slot.lanes] = False
        self._gid_np[slot.lanes] = FREE_GID
        self._keys_np[slot.lanes] = 0
        self._sweep_np[slot.lanes] = 0
        self._dirty = True
        self.set_block_gates(slot.lanes, np.ones(NBLOCKS, np.float32))
        for d in (self._slots, self._next_sweep):
            d.pop(slot.tenant_id, None)

    def set_block_gates(self, lanes: np.ndarray, gates: np.ndarray,
                        tenant_id: Optional[int] = None) -> bool:
        """Write a tenant's ``(NBLOCKS,)`` block-enable vector into its
        lanes (the adaptive scan's boundary update, serve/adapt.py): a host
        write, uploaded at the next dispatch. With ``tenant_id``, only
        while that tenant still owns the lanes: the server's drain thread
        may update a tenant after its last quantum was dispatched, when
        its lanes may already hold the next tenant (an eviction resets
        the lanes' gates after it frees them, under the same lock).
        Returns whether it wrote; a no-op on a pool that is not
        adaptive."""
        if not self.adaptive:
            return False
        lanes = np.asarray(lanes, int)
        with self._bg_lock:
            if tenant_id is not None and not (
                    self._gid_np[lanes] == tenant_id).all():
                return False
            self._bg_np[lanes] = np.asarray(gates, np.float32)
            self._bg_dirty = True
        return True

    def quarantine_lanes(self, lanes: np.ndarray) -> None:
        """Mask lanes inactive without freeing their groups: they stop
        advancing (frozen at the next quantum, their draws discarded) but
        stay their tenant's, so its result keeps its shape and its other
        chains are untouched, bitwise. The groups free at eviction."""
        self._active_np[np.asarray(lanes, int)] = False
        self._dirty = True

    def poison_lanes(self, lanes: np.ndarray) -> None:
        """Write NaN into the lanes' parameters (the ``lane_nan`` fault
        of serve/faults.py): the next quantum's sticky ``diverged`` flag
        picks it up as it would a real divergence."""
        x = self.state.x
        self._write_rows(lanes, {"x": torch.full(
            (len(lanes),) + x.shape[2:], float("nan"), dtype=x.dtype,
            device=x.device)})

    def reinit_lanes(self, lanes: np.ndarray, fresh: ChainState,
                     fresh_idx: np.ndarray) -> None:
        """Write chains ``fresh_idx`` of the state ``fresh`` into the lanes
        and re-activate them (the ``reinit`` policy: a prior draw from the
        tenant's sampler). The lanes keep their adapted jump scales and
        covariance factors, as ``TorchGibbs``'s ``reinit_diverged`` does,
        and their key and sweep index; every other lane is untouched."""
        sel = np.asarray(fresh_idx, np.int64)
        self._write_rows(lanes, {
            f: val.index_select(0, torch.as_tensor(sel, device=val.device))
            for f, val in zip(ChainState._fields, fresh)
            if f not in ("mh_log_scale", "mh_cov_chol")})
        self._active_np[np.asarray(lanes, int)] = True
        self._dirty = True

    def tenant_state(self, slot: TenantSlot) -> ChainState:
        """The tenant's current chain state: ``(nchains, ...)`` tensors
        (copies), e.g. to resume it in ``TorchGibbs`` or in another pool
        at ``start_sweep``. The scatter arm gathers the tenant's rows on
        the pool's device; the bounce arm pulls the whole state and
        slices it on the host."""
        if self.scatter:
            return self.tenant_state_from(self.state, slot)
        self._pull_state()
        return self.tenant_state_from(self._host, slot)

    @staticmethod
    def tenant_state_from(snap: ChainState, slot: TenantSlot) -> ChainState:
        """One tenant's ``(nchains, ...)`` slice (copies) of a lane state
        ``snap`` (``(G, 16, ...)`` tensors on any device): of a snapshot
        from :meth:`dispatch_quantum`, the checkpoint of a deferred
        drain."""
        idx = torch.as_tensor(slot.chain_lanes, dtype=torch.long,
                              device=snap.x.device)
        return ChainState(*(_flat(f).index_select(0, idx) for f in snap))

    # ------------------------------------------------------------------
    # the quantum
    # ------------------------------------------------------------------

    def _upload(self) -> bool:
        """Upload what changed on the host since the last dispatch: the
        lane flags, keys and sweep indices, the block gates, and (bounce
        arm) the whole lane state. Returns whether it copied anything."""
        copied = False
        if self._dirty:
            for dst, src in ((self._active, self._active_np),
                             (self.sampler.gid, self._gid_np),
                             (self._lane_keys, self._keys_np),
                             (self._lane_sweep, self._sweep_np)):
                dst.copy_(torch.from_numpy(src).reshape(dst.shape))
            self._dirty = False
            copied = True
        if self._bg_dirty:
            with self._bg_lock:
                gates = self._bg_np.copy()
                self._bg_dirty = False
            self._bg_ones = bool((gates == 1.0).all())
            if not self._bg_ones:
                self._bg.copy_(torch.from_numpy(gates).reshape(
                    self._bg.shape))
                copied = True
        if self._host is not None:
            self.state = ChainState(*(t.to(self.device)
                                      for t in self._host))
            self._host = None
            copied = True
        return copied

    def block_gates(self):
        """The lanes' gates as the sweep's ``(G, 16, NBLOCKS)`` operand,
        or None while every lane's are ones (and on a pool that is not
        adaptive): the ungated sweep."""
        return None if self._bg_ones else self._bg

    def _eta_table(self):
        """``(quantum, G, 16, 1)`` Robbins-Monro step sizes: each lane's at
        its tenant's sweep index (0 where no tenant's chain runs)."""
        table = np.zeros((self.quantum, self.nlanes), np.float32)
        for tid, slot in self._slots.items():
            i0 = self._next_sweep[tid]
            for j in range(self.quantum):
                table[j, slot.chain_lanes] = self.drawer._rm_step(i0 + j)
        return torch.from_numpy(table).to(self.device).reshape(
            self.quantum, -1, LANES_GROUP, 1)

    def _lane_draws(self, st: ChainState, sweeps) -> SweepDraws:
        """Every lane's draws of one sweep, at the lanes' sweep indices
        ``sweeps (G, 16)``: one launch of the draw kernel over all lanes,
        written into the pool's one raw buffer."""
        G = self.nlanes // LANES_GROUP
        flat = ChainState(*(_flat(t) for t in st))
        dr = self.drawer._draw(_flat(self._lane_keys), _flat(sweeps), flat,
                               out=self._raw)
        return SweepDraws(*(t.reshape(G, LANES_GROUP, *t.shape[1:])
                            for t in dr))

    def dispatch_quantum(self, snapshot: bool = False):
        """Advance every lane by ``quantum`` sweeps without waiting for the
        device: returns ``(records, telemetry, snap)``. ``records`` is
        ``{field: (quantum, G, 16, ...)}`` device tensors in the tier's wire
        dtypes, the state before every ``record_thin``-th sweep (as
        ``TorchGibbs.sample`` records it); ``telemetry`` the
        quantum's ``Telemetry`` of ``(G, 16)`` tensors (None with
        ``telemetry`` off); ``snap``, with
        ``snapshot=True``, a copy of the post-quantum state made on the
        device before any later boundary writes the state in place
        (``write_tenant``), the checkpoint a deferred drain reads (else
        None). Lanes no tenant's chain owns end the quantum as they began
        it.

        The lane flags, keys and sweep indices are uploaded from host
        mirrors by a pageable copy, which returns only when it is done: a
        boundary write to a mirror while this quantum runs on the card
        can never reach its operands."""
        program = program_begin(f"serve_pool_chunk_l{self.nlanes}", self,
                                self.quantum, str(self.device))
        if program is not None:
            self._program = program
        t_up = time.monotonic()
        if self._upload() and self.spans is not None:
            self.spans.record("operand_upload", ROLE_DISPATCH, t_up,
                               time.monotonic() - t_up)
        t_call = time.monotonic()
        smp = self.sampler
        if self.config.mh.adapt_until > 0:
            smp.eta = self._eta_table()
        start = st = self.state
        recs = {f: [] for f in self.fields}
        G = self.nlanes // LANES_GROUP
        tl = (telemetry_init((G, LANES_GROUP), self.device)
              if self.telemetry else None)
        # each lane's sweep index at every step of the quantum
        sweeps = self._lane_sweep + self._steps
        gates = self.block_gates()
        for j in range(self.quantum):
            if j % self.record_thin == 0:
                for f in self.fields:
                    recs[f].append(getattr(st, f))
            st = smp._sweep(st, self._lane_draws(st, sweeps[j]), sweep=j,
                            block_gates=gates)
            if tl is not None:
                tl = telemetry_update(tl, st)
        if tl is not None:
            tl = tl._replace(logpost=smp._logpost_chain(st))
        if not self._active_np.all():
            st = ChainState(*(
                torch.where(self._active.reshape(
                    self._active.shape + (1,) * (new.dim() - 2)), new, old)
                for new, old in zip(st, start)))
        self.state = st
        for tid in self._next_sweep:
            self._next_sweep[tid] += self.quantum
        if self._slots:
            self._sweep_np[self._active_np] += self.quantum
            self._dirty = True
        snap = ChainState(*(t.clone() for t in st)) if snapshot else None
        # the tier's casts on the device, once over the stacked quantum
        wire = record_tuple(SimpleNamespace(**{
            f: torch.stack(v) for f, v in recs.items()}), self.fields,
            self.casts)
        if self.spans is not None:
            self.spans.record("chunk_call", ROLE_DISPATCH, t_call,
                               time.monotonic() - t_call)
        self.wire_bytes = sum(t.numel() * t.element_size() for t in wire)
        return dict(zip(self.fields, wire)), tl, snap

    def run_quantum(self):
        """The serial form of :meth:`dispatch_quantum`: ``(records,
        telemetry)`` (the state is read from the pool before the next
        boundary)."""
        return self.dispatch_quantum()[:2]

    # ------------------------------------------------------------------
    # records
    # ------------------------------------------------------------------
    # A quantum's records reach the host in the tier's wire dtypes, lanes
    # on axis 1: ``{field: (rows, nlanes, ...)}`` host tensors (bfloat16
    # has no numpy dtype). In-memory tenants keep their lanes' narrow
    # slices and are turned into float32 once, at finalize; a spool or an
    # on_chunk consumer pays the cast each quantum, for its lanes only.

    def wire_host(self, recs: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """A quantum's records (from :meth:`dispatch_quantum`) on the host
        in wire dtypes, no cast: ``{field: (rows, nlanes, ...)}``. Device
        tensors are copied by a blocking copy; host tensors (the
        pipelined drain's pull on its side stream) are only reshaped. The
        first quantum's arrival closes its program record
        (obs/introspect.py)."""
        host = {f: t.cpu().reshape(t.shape[0], self.nlanes, *t.shape[3:])
                for f, t in recs.items()}
        program, self._program = self._program, None
        program_end(program, self.device, self.metrics)
        return host

    def tenant_wire(self, wire: Dict[str, torch.Tensor],
                    slot: TenantSlot) -> Dict[str, torch.Tensor]:
        """One tenant's lanes of a wire-dtype quantum: ``{field: (rows,
        nchains, ...)}`` copies in ordinary host memory (the quantum's
        pinned buffers go back to the allocator after the drain)."""
        lanes = slot.chain_lanes
        lo, hi = int(lanes[0]), int(lanes[-1]) + 1
        idx = (None if hi - lo == len(lanes)
               else torch.as_tensor(lanes, dtype=torch.long))
        out = {}
        for f, a in wire.items():
            a = a[:, lo:hi] if idx is None else a.index_select(1, idx)
            out[f] = torch.empty(a.shape, dtype=a.dtype).copy_(a)
        return out

    def materialize_tenant(self, cols: Dict[str, torch.Tensor],
                           n_real: int) -> dict:
        """A tenant's wire-dtype records ``{field: (rows, nchains, ...)}``
        (one quantum's, or the quanta's concatenated on the rows axis) as
        float32 numpy arrays, as ``TorchGibbs`` turns a chunk back
        (``_materialize``), per-TOA fields cut to the tenant's ``n_real``
        TOAs. The casts are elementwise, so a slice turned back equals the
        same slice of the whole quantum turned back."""
        host = self.drawer._materialize([cols[f] for f in self.fields])
        return {f: self._cut(f, a, n_real)
                for f, a in zip(self.fields, host)}

    def _cut(self, field: str, a, n_real: int):
        """A per-TOA field cut from the pool's TOA count to ``n_real``."""
        if n_real != self.n_pool and field in ("z", "alpha", "pout"):
            return a[..., :n_real]
        return a

    def tenant_quantum_records(self, wire: Dict[str, torch.Tensor],
                               slot: TenantSlot) -> dict:
        """One tenant's float32 records of one quantum (the spool's and
        ``on_chunk``'s payload): its wire slice, turned back."""
        return self.materialize_tenant(self.tenant_wire(wire, slot),
                                       slot.n_real)

    def tenant_wire_device(self, recs: Dict[str, torch.Tensor],
                           slot: TenantSlot) -> Dict[str, torch.Tensor]:
        """:meth:`wire_host` then :meth:`tenant_wire` with the gather on
        the device: the tenant's lanes are gathered into ``(rows,
        nchains, ...)`` tensors on the pool's device and only those bytes
        are copied to the host. The values are the host slice's."""
        idx = torch.as_tensor(slot.chain_lanes, dtype=torch.long,
                              device=self.device)
        return {f: t.reshape(t.shape[0], self.nlanes, *t.shape[3:])
                .index_select(1, idx).cpu() for f, t in recs.items()}

    def materialize(self, recs: Dict[str, torch.Tensor]) -> dict:
        """A quantum's records (on the device, or already on the host)
        turned back to float32 for every lane, as host ``{field: (nlanes,
        rows, ...)}`` numpy arrays (the JAX pool's lane-major layout)."""
        host = self.materialize_tenant(self.wire_host(recs), self.n_pool)
        return {f: np.swapaxes(a, 0, 1) for f, a in host.items()}

    def tenant_records(self, host: dict, slot: TenantSlot) -> dict:
        """One tenant's slice of a materialized quantum: ``{field: (rows,
        nchains, ...)}`` (copies), per-TOA fields cut to its TOAs."""
        return {f: self._cut(f, np.ascontiguousarray(np.swapaxes(
            a[slot.chain_lanes], 0, 1)), slot.n_real)
            for f, a in host.items()}

    def result(self, cols: dict, n_real: Optional[int] = None):
        """A ``ChainResult`` from a tenant's float32 records ``{field:
        (niter, nchains, ...)}``, as ``TorchGibbs.sample`` returns it;
        ``stats["n_toa"]`` is the tenant's TOA count (the pool's when
        ``n_real`` is None)."""
        res = self.drawer._to_result(cols)
        res.stats["n_toa"] = np.asarray([self.n_pool if n_real is None
                                         else n_real])
        return res

    # ------------------------------------------------------------------
    # the status surface (the server's status() and summary())
    # ------------------------------------------------------------------

    def admission_stats(self) -> dict:
        """The admission writes: the arm (``scatter``), the admissions
        made, and the bytes they moved (a mean, and the total): the delta
        and its lane index under the scatter arm, the delta and the whole
        state down and back up under the bounce (the JAX pool's
        count)."""
        n = len(self._admit_bytes)
        return {"scatter": bool(self.scatter), "admits": n,
                "bytes_per_admit": (float(np.mean(self._admit_bytes))
                                    if n else None),
                "bytes_total": int(np.sum(self._admit_bytes)) if n else 0}

    def backend_info(self) -> dict:
        """Where the pool runs: ``platform`` (``"gpu"`` on CUDA, else
        ``"cpu"``), ``native`` (the kernels' library as
        ``ops/_cuda.library_record`` gives it on CUDA; on the CPU, that
        the plain versions run: a string either way, as the JAX pool's
        probe verdict and the status schema have it) and the admission
        arm (``scatter``)."""
        cuda = self.device.type == "cuda"
        return {"platform": "gpu" if cuda else "cpu",
                "native": (_cuda.library_record() if cuda
                           else "none: plain versions on the CPU"),
                "scatter": bool(self.scatter)}
