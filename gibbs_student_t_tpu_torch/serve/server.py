"""The serial chain server: a queue in front of the slot pool.

Counterpart of the serial quantum loop of
``gibbs_student_t_tpu/serve/server.py`` (``ChainServer.step``/``run``
with the pipelined executor off). Jobs are queued by :meth:`submit`; each
:meth:`step` admits what fits into free 16-lane groups (first fit, in
arrival order), advances the pool by one quantum, hands every resident
tenant its records, and releases the groups of tenants that finished, so
queued jobs backfill them at the next step. Everything runs on the
caller's thread.

Not ported from the JAX server: the pipelined executor, supervision and
fault containment, spools and manifests, monitors, adaptive scans, warm
starts, recycling, priorities and deadlines, observability and the wire
(ROADMAP A-9).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.models.pta import ModelArrays
from gibbs_student_t_tpu_torch.ops.rng import check_counter
from gibbs_student_t_tpu_torch.parallel.ensemble import (
    _localize_names,
    _structure,
    check_kernel_structure,
)
from gibbs_student_t_tpu_torch.serve.pool import SlotPool, TenantSlot
from gibbs_student_t_tpu_torch.serve.scheduler import (
    AdmissionQueue,
    TenantHandle,
    TenantRequest,
)


class ChainServer:
    """Serve many sampling jobs through one :class:`SlotPool`.

    ``nlanes``, ``quantum``, ``record`` and ``device`` configure the pool;
    ``max_queue`` bounds the admission queue, and ``backpressure`` says
    what :meth:`submit` does when it is full: ``"reject"`` raises
    :class:`QueueFull`, ``"block"`` serves quanta until a queued job is
    admitted (and raises :class:`QueueFull` only if that frees nothing)."""

    def __init__(self, template_ma: ModelArrays, config: GibbsConfig,
                 nlanes: int = 1024, quantum: int = 25, record: str = "full",
                 device=None, max_queue: int = 64,
                 backpressure: str = "block"):
        self.config = config
        self.queue = AdmissionQueue(max_queue, backpressure)
        self.pool = SlotPool(template_ma, config, nlanes=nlanes,
                             quantum=quantum, device=device, record=record)
        # admission groups (``pool.group`` lanes each) no tenant holds
        self._free_groups: List[int] = list(range(nlanes // self.pool.group))
        self._running: Dict[int, Tuple[TenantSlot, TenantHandle]] = {}
        self._next_id = 0
        self.quanta = 0
        self.busy_chain_sweeps = 0
        self.total_lane_sweeps = 0

    def submit(self, request: TenantRequest) -> TenantHandle:
        """Queue a job and return its handle. A model that does not match
        the pool's template is rejected at admission, through its handle."""
        pool = self.pool
        if request.niter < 1 or request.niter % pool.quantum:
            raise ValueError(
                f"niter ({request.niter}) must be a positive multiple "
                f"of the pool quantum ({pool.quantum})")
        if request.nchains < 1:
            raise ValueError("nchains must be >= 1")
        groups = self._groups_needed(request)
        if groups > pool.nlanes // pool.group:
            raise ValueError(
                f"tenant needs {groups} lane groups; the pool only has "
                f"{pool.nlanes // pool.group}")
        # the seed and every tenant-local sweep index must fit their
        # 32-bit key and counter words
        check_counter("seed", request.seed)
        check_counter("sweep", request.start_sweep + request.niter - 1)
        if self.queue.full() and self.queue.policy == "block":
            while self.queue.full() and self.step():
                pass
        handle = TenantHandle(self._next_id, request)
        self.queue.put(handle)
        self._next_id += 1
        return handle

    def _groups_needed(self, request: TenantRequest) -> int:
        return -(-request.nchains // self.pool.group)

    def _prepare(self, handle: TenantHandle):
        """``(backend, state)`` of a queued tenant: a ``TorchGibbs`` of its
        model on the pool's device, checked against the template, and its
        initial state (the solo sampler's at the same seed), or None when
        the model does not fit the pool (the handle is rejected)."""
        req, pool = handle.request, self.pool
        try:
            ma = _localize_names(req.ma)
            t = pool.template_ma
            if ma.row_mask is not None:
                raise ValueError("tenant models must be unpadded")
            if ma.n != pool.n_pool:
                raise ValueError(
                    f"tenant n={ma.n} != pool n={pool.n_pool}; the pool "
                    "admits only matching TOA counts")
            if ma.m != t.m:
                raise ValueError(f"tenant basis size {ma.m} != pool {t.m}")
            if _structure(ma) != _structure(t):
                raise ValueError(
                    "tenant model structure (parameters, noise groups, "
                    "phi blocks) differs from the pool template")
            backend = TorchGibbs(ma, self.config, nchains=req.nchains,
                                 device=pool.device, tnt_block_size=None)
            check_kernel_structure(backend, pool.drawer)
            state = (backend.init_state(seed=req.seed) if req.state is None
                     else req.state)
        except ValueError as e:
            handle._fail(f"{type(e).__name__}: {e}")
            return None
        return backend, state

    def _admit(self, handle: TenantHandle) -> None:
        prepared = self._prepare(handle)
        if prepared is None:
            return
        req, pool = handle.request, self.pool
        taken = sorted(self._free_groups.pop(0)
                       for _ in range(self._groups_needed(req)))
        G = pool.group
        lanes = np.concatenate([np.arange(g * G, (g + 1) * G)
                                for g in taken])
        slot = TenantSlot(handle.tenant_id, lanes, req.nchains, req.niter,
                          req.start_sweep, req.seed)
        pool.write_tenant(slot, *prepared)
        handle.status = "running"
        self._running[handle.tenant_id] = (slot, handle)

    def _try_admissions(self) -> None:
        while self._free_groups:
            free = len(self._free_groups)
            h = self.queue.pop_first_fit(
                lambda hh: self._groups_needed(hh.request) <= free)
            if h is None:
                break
            self._admit(h)

    def step(self) -> bool:
        """One quantum on the calling thread: admit, advance, hand out the
        records, release finished tenants. Returns True while there is
        work left (resident or queued)."""
        self._try_admissions()
        if not self._running:
            return len(self.queue) > 0
        pool = self.pool
        host = pool.materialize(pool.run_quantum())
        q = pool.quantum
        finished = []
        for tid, (slot, handle) in self._running.items():
            slot.done_sweeps += q
            handle._append(pool.tenant_records(host, slot),
                           slot.done_sweeps)
            if slot.remaining <= 0:
                finished.append(tid)
        self.quanta += 1
        busy = sum(slot.nchains for slot, _ in self._running.values())
        self.busy_chain_sweeps += busy * q
        self.total_lane_sweeps += pool.nlanes * q
        for tid in finished:
            slot, handle = self._running.pop(tid)
            pool.evict(slot)
            self._free_groups.extend(
                int(g) for g in slot.lanes[::pool.group] // pool.group)
            self._free_groups.sort()
            handle._finish(pool.result)
        return bool(self._running) or len(self.queue) > 0

    def run(self) -> None:
        """Serve quanta until the pool and the queue are empty."""
        while self.step():
            pass

    def summary(self) -> dict:
        """Run-level serving numbers: ``occupancy`` is the chain-lane
        sweeps served over the lane sweeps advanced; ``busy_chain_sweeps``
        the sum over served tenants of chains x sweeps."""
        occ = (self.busy_chain_sweeps / self.total_lane_sweeps
               if self.total_lane_sweeps else 0.0)
        return {"nlanes": self.pool.nlanes, "quantum": self.pool.quantum,
                "quanta": self.quanta, "occupancy": occ,
                "busy_chain_sweeps": self.busy_chain_sweeps}
