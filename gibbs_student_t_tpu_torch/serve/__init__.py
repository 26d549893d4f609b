"""Serving many sampling jobs at once on one GPU: the slot pool, the
scheduler and the chain server.

Counterpart of ``gibbs_student_t_tpu/serve/``, in part: the
:class:`SlotPool` (``pool.py``) turns the 1024-chain sweep into 1024
lanes that independent jobs (tenants: their own model, seed, chain count
and sweep budget) share in groups of 16, each MH block one kernel launch
for every lane; the :class:`ChainServer` (``server.py``) queues jobs,
admits them into free groups by FIFO or priority order (preempting
spooled lower-tier tenants losslessly), runs quanta serially or through
its pipelined executor, and hands back each tenant's chains
(``scheduler.py`` holds the request, the handle, the queue and the
overload and failure signals). A tenant alone in the pool gets the solo
sampler's chains, ``TorchGibbs.sample`` at the same seed.

A tenant's failure stays its own: the server contains it, applies each
tenant's ``on_divergence`` policy to chains that go non-finite, restarts
dead worker threads, and with a ``manifest_dir`` journals itself
(``manifest.py``) so that :meth:`ChainServer.recover` resumes every
spooled tenant after a process kill. ``faults.py`` holds the injection
points that make each of those paths reproducible.
"""

from gibbs_student_t_tpu_torch.serve import faults
from gibbs_student_t_tpu_torch.serve.pool import SlotPool, TenantSlot
from gibbs_student_t_tpu_torch.serve.scheduler import (
    DIVERGENCE_POLICIES,
    AdmissionQueue,
    DeadlineExceeded,
    QueueFull,
    RetryAfter,
    TenantError,
    TenantHandle,
    TenantRequest,
    schedule_score,
)
from gibbs_student_t_tpu_torch.serve.server import ChainServer

__all__ = ["DIVERGENCE_POLICIES", "AdmissionQueue", "ChainServer",
           "DeadlineExceeded", "QueueFull", "RetryAfter", "SlotPool",
           "TenantError", "TenantHandle", "TenantRequest", "TenantSlot",
           "faults", "schedule_score"]
