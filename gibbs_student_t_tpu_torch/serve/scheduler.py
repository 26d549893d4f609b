"""Requests, handles and the admission queue of the serial chain server.

Counterpart of the part of ``gibbs_student_t_tpu/serve/scheduler.py`` the
serial server uses: :class:`TenantRequest` (one job), :class:`TenantHandle`
(the caller's view of it), :class:`QueueFull` and a FIFO
:class:`AdmissionQueue` with first-fit backfill. The server runs on the
caller's thread, so nothing here waits or locks. The JAX request's other
fields (spools, monitors, warm starts, adaptive scans, priorities,
deadlines, fault policies, callbacks, tracing) are not ported; passing one
raises ``TypeError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from gibbs_student_t_tpu_torch.models.pta import ModelArrays


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the admission queue is at capacity: at
    once under the ``reject`` backpressure policy, and under ``block``
    when serving quanta frees no room."""


@dataclasses.dataclass
class TenantRequest:
    """One job for the slot pool: ``niter`` sweeps (a multiple of the pool
    quantum) of ``nchains`` chains of the model ``ma`` from the seed
    ``seed``. ``state`` and ``start_sweep`` resume a tenant: chain k of a
    tenant draws at its sweep ``i`` from the key of ``(seed, k)`` at
    counter ``i`` (ops/rng.py), whatever lanes it holds, so a
    continuation equals the unbroken run."""

    ma: ModelArrays
    niter: int
    nchains: int = 16
    seed: int = 0
    state: object = None
    start_sweep: int = 0


class TenantHandle:
    """The caller's view of a submitted job."""

    def __init__(self, tenant_id: int, request: TenantRequest):
        self.tenant_id = tenant_id
        self.request = request
        self.status = "queued"
        self.error: Optional[str] = None
        self.sweeps_done = 0
        self._cols: Dict[str, List[np.ndarray]] = {}
        self._builder: Optional[Callable] = None
        self._result = None

    def done(self) -> bool:
        return self.status in ("done", "rejected")

    def result(self):
        """The tenant's ``ChainResult``, ``(niter, nchains, ...)`` chains as
        ``TorchGibbs.sample`` returns them; raises when the job is not
        done (drive ``ChainServer.step()``/``run()``) or was rejected."""
        if not self.done():
            raise RuntimeError(
                f"tenant {self.tenant_id} not done (status "
                f"{self.status!r}); drive ChainServer.step()/run()")
        if self.error is not None:
            raise RuntimeError(
                f"tenant {self.tenant_id} rejected: {self.error}")
        if self._result is None:
            self._result = self._builder(
                {f: np.concatenate(c) for f, c in self._cols.items()})
            self._cols, self._builder = {}, None
        return self._result

    # -- server side ------------------------------------------------------

    def _append(self, records: Dict[str, np.ndarray], sweeps_done: int):
        for f, a in records.items():
            self._cols.setdefault(f, []).append(a)
        self.sweeps_done = sweeps_done

    def _finish(self, builder: Callable) -> None:
        """Complete the job; the records are joined into the result at
        the first ``result()`` call."""
        self._builder = builder
        self.status = "done"

    def _fail(self, why: str) -> None:
        self.error = why
        self.status = "rejected"


class AdmissionQueue:
    """A bounded FIFO queue of handles with first-fit backfill."""

    def __init__(self, maxsize: int = 64, policy: str = "block"):
        if policy not in ("block", "reject"):
            raise ValueError(
                f"backpressure policy must be 'block' or 'reject', "
                f"got {policy!r}")
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self.policy = policy
        self._q: List[TenantHandle] = []

    def __len__(self) -> int:
        return len(self._q)

    def full(self) -> bool:
        return len(self._q) >= self.maxsize

    def put(self, handle: TenantHandle) -> None:
        if self.full():
            raise QueueFull(f"admission queue at capacity ({self.maxsize})")
        self._q.append(handle)

    def pop_first_fit(self, fits) -> Optional[TenantHandle]:
        """Remove and return the first queued job for which ``fits(handle)``
        is true, else None."""
        for i, h in enumerate(self._q):
            if fits(h):
                return self._q.pop(i)
        return None
