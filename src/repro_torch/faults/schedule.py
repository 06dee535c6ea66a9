"""Replayable fault schedules — the deterministic half of the chaos harness;
a copy of the JAX package's ``repro/faults/schedule.py`` (numpy only: the
same seeded draws, event for event).

A :class:`FaultSchedule` is a tuple of :class:`FaultEvent` records plus a
seed.  Everything downstream is a pure function of (schedule, fleet,
trace): the injector derives every random draw (which blobs to corrupt)
from ``(seed, step)``, so re-running the same schedule over the same
trace replays the same faults bit-for-bit — chaos results are diffable
across commits, which is the whole point.

Fault taxonomy (``FaultEvent.kind``):

* ``"crash"``     — hard node crash (``CacheGenius.crash_node``: cache
  lost, nothing reassigned); ``duration > 0`` schedules a rejoin that
  many steps later — journal-replayed when the injector holds a
  ``CacheJournal`` for the node, cold otherwise.
* ``"fail"``      — graceful failure (``fail_node``: shard reassigned).
* ``"transient"`` — arm the
  :class:`repro_torch.faults.injector.FlakyBackend` to fail the next
  ``count`` backend generation calls with ``TransientBackendError``
  (fleet-level: backend calls carry no node identity; the Generate
  stage attributes each to the failing group's node).
* ``"corrupt"``   — silently corrupt a ``frac`` fraction of the blob
  store's entries (checksums left stale — only verify-on-hit catches it).
* ``"stall"``     — slow-node stall: multiply the node's speed by
  ``factor`` for ``duration`` steps, then restore it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

__all__ = ["FaultEvent", "FaultSchedule", "PRESETS"]

_KINDS = ("crash", "fail", "transient", "corrupt", "stall")


@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault.  ``step`` is the injection boundary the event
    fires at (group number in group mode, denoising-step number in
    step-level mode); unused fields are ignored per kind."""

    step: int
    kind: str
    node: int = -1          # crash/fail/stall target; -1 = fleet-level
    count: int = 1          # transient: backend calls to fail
    duration: int = 0       # crash: steps until rejoin (0 = stay down);
    #                         stall: steps before the speed is restored
    factor: float = 0.25    # stall: speed multiplier while stalled
    frac: float = 0.25      # corrupt: fraction of live blobs to damage

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {_KINDS}")
        if self.step < 0:
            raise ValueError(f"step must be >= 0, got {self.step}")


@dataclass(frozen=True)
class FaultSchedule:
    """An immutable, seeded script of fault events."""

    events: Tuple[FaultEvent, ...]
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    def at(self, step: int) -> List[FaultEvent]:
        """Events firing at this injection boundary, in script order."""
        return [e for e in self.events if e.step == step]

    def rng(self, step: int) -> np.random.Generator:
        """The deterministic per-step random stream: every draw the
        injector makes at ``step`` comes from here, so a schedule replays
        identically however many times it runs."""
        return np.random.default_rng([self.seed, step])

    @property
    def horizon(self) -> int:
        """Last scripted step (rejoins scheduled past it still apply —
        the injector tracks them independently)."""
        return max((e.step for e in self.events), default=0)

    # -- canned schedules -----------------------------------------------------

    @classmethod
    def preset(cls, name: str, *, nodes: int, horizon: int,
               seed: int = 0) -> "FaultSchedule":
        """A named schedule scaled to the fleet/trace at hand.  ``nodes``
        is the fleet size (crash/stall targets are chosen inside it);
        ``horizon`` the number of injection boundaries the run will see
        (events land at fixed fractions of it)."""
        if name not in PRESETS:
            raise ValueError(
                f"unknown preset {name!r}; expected one of "
                f"{sorted(PRESETS)}")
        if nodes < 2 and name in ("chaos", "crash"):
            raise ValueError(
                f"preset {name!r} crashes a node and needs nodes >= 2, "
                f"got {nodes}")
        horizon = max(int(horizon), 10)
        return cls(events=tuple(PRESETS[name](nodes, horizon)), seed=seed)

    @classmethod
    def generate(cls, *, nodes: int, horizon: int, seed: int,
                 rate: float = 0.05) -> "FaultSchedule":
        """A seeded random schedule: each boundary independently draws a
        fault with probability ``rate`` (kind uniform over transient /
        corrupt / stall — crashes are scripted, not drawn, so zero-loss
        accounting stays easy to reason about)."""
        rng = np.random.default_rng([seed, nodes, horizon])
        events = []
        for step in range(int(horizon)):
            if rng.random() >= rate:
                continue
            kind = ("transient", "corrupt", "stall")[int(rng.integers(3))]
            if kind == "stall":
                events.append(FaultEvent(
                    step=step, kind="stall",
                    node=int(rng.integers(nodes)),
                    duration=int(rng.integers(2, 6))))
            elif kind == "corrupt":
                events.append(FaultEvent(step=step, kind="corrupt",
                                         frac=0.1))
            else:
                events.append(FaultEvent(step=step, kind="transient",
                                         count=int(rng.integers(1, 3))))
        return cls(events=tuple(events), seed=seed)


def _crash_events(nodes: int, horizon: int) -> List[FaultEvent]:
    down = max(2, horizon // 5)
    return [FaultEvent(step=max(1, int(horizon * 0.3)), kind="crash",
                       node=nodes - 1, duration=down)]


def _corrupt_events(nodes: int, horizon: int) -> List[FaultEvent]:
    return [FaultEvent(step=max(1, int(horizon * f)), kind="corrupt",
                       frac=0.25) for f in (0.3, 0.6)]


def _transient_events(nodes: int, horizon: int) -> List[FaultEvent]:
    return [FaultEvent(step=max(1, int(horizon * f)), kind="transient",
                       count=2) for f in (0.2, 0.5, 0.8)]


def _chaos_events(nodes: int, horizon: int) -> List[FaultEvent]:
    events = (_transient_events(nodes, horizon)
              + _corrupt_events(nodes, horizon)
              + _crash_events(nodes, horizon))
    events.append(FaultEvent(step=max(1, int(horizon * 0.45)), kind="stall",
                             node=0, duration=max(2, horizon // 10),
                             factor=0.25))
    return sorted(events, key=lambda e: e.step)


PRESETS = {
    "crash": _crash_events,
    "corrupt": _corrupt_events,
    "transient": _transient_events,
    "chaos": _chaos_events,
}
