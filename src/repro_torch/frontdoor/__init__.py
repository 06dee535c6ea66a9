"""Front door: async multi-tenant serving gateway over the engine; the port
of the JAX package's ``repro/frontdoor`` (the queue and the result stores
are copies, the dispatcher and the gateway drive the port's engine).

Four pieces (one module each):

* :mod:`repro_torch.frontdoor.queue` — SLA-tier priority queue with
  per-tenant token-bucket quotas, weighted-fair dequeue, deadline
  escalation, and typed backpressure rejections;
* :mod:`repro_torch.frontdoor.dispatcher` — worker-thread bridge admitting
  the fair-share head of the queue into ``ServingEngine.serve_group`` at
  every step-group boundary (plus graceful node join/leave);
* :mod:`repro_torch.frontdoor.results` — pluggable result stores (memory /
  filesystem) and the completion handles clients poll or await;
* :mod:`repro_torch.frontdoor.gateway` — the client-facing API tying them
  together.

``python -m repro_torch.launch.frontdoor`` drives it with N concurrent
synthetic tenant clients.
"""
from repro_torch.frontdoor.dispatcher import Dispatcher
from repro_torch.frontdoor.gateway import Gateway
from repro_torch.frontdoor.queue import (BackpressureError, DEFAULT_TIERS,
                                         FrontDoorQueue, Job,
                                         QuotaExceededError, TierSpec,
                                         TokenBucket)
from repro_torch.frontdoor.results import (FileResultStore,
                                           GatewayClosedError,
                                           MemoryResultStore, ResultHandle,
                                           ResultStore)

__all__ = [
    "BackpressureError", "DEFAULT_TIERS", "Dispatcher", "FileResultStore",
    "FrontDoorQueue", "Gateway", "GatewayClosedError", "Job",
    "MemoryResultStore", "QuotaExceededError", "ResultHandle",
    "ResultStore", "TierSpec", "TokenBucket",
]
