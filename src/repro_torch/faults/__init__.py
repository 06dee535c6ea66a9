"""Deterministic fault-injection harness (chaos engineering surface).

``FaultSchedule`` is a replayable, seeded script of fault events at step
granularity; ``FaultInjector`` applies it to a live ``CacheGenius``
fleet through the serving engine's ``on_step`` hook (group mode fires it
per group, step-level mode per denoising step).  See
``docs/ARCHITECTURE.md`` (Fault tolerance) for the taxonomy and the
invariants every chaos run must preserve.
"""
from repro_torch.faults.injector import FaultInjector, FlakyBackend, \
    attach_journals
from repro_torch.faults.schedule import FaultEvent, FaultSchedule

__all__ = ["FaultEvent", "FaultSchedule", "FaultInjector", "FlakyBackend",
           "attach_journals"]
