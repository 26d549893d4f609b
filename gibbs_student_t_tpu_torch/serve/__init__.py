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
"""

from gibbs_student_t_tpu_torch.serve.pool import SlotPool, TenantSlot
from gibbs_student_t_tpu_torch.serve.scheduler import (
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

__all__ = ["AdmissionQueue", "ChainServer", "DeadlineExceeded", "QueueFull",
           "RetryAfter", "SlotPool", "TenantError", "TenantHandle",
           "TenantRequest", "TenantSlot", "schedule_score"]
