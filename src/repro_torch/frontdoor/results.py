"""Pluggable result stores + completion handles for the front door.

Finished images are OFFLOADED out of the serving process's working set
the moment a group completes: the dispatcher ``put``\\ s each image into a
:class:`ResultStore` and resolves the job's :class:`ResultHandle` with
the store reference — clients poll/await the handle and fetch the pixels
only when they want them, instead of every completed request pinning an
array in process memory (the paper's §V NFS image store, and the
object-storage offload production serving systems use).

Two backends ship:

* :class:`MemoryResultStore` — a dict; zero-dependency default for tests
  and benchmarks (the "offload" is then just decoupling lifetime from
  the engine's completion records).
* :class:`FileResultStore` — one ``.npy`` per image plus a ``.json``
  metadata sidecar under a directory; the process-memory cost of a
  finished job drops to a file path.

Handles are dual-mode: ``wait(timeout)``/``done()``/``image()`` from
plain threads, ``await handle.wait_async()`` from asyncio (the future is
a ``concurrent.futures.Future``, bridged with ``asyncio.wrap_future`` —
stdlib only).
"""
from __future__ import annotations

import concurrent.futures
import json
import os
from typing import Any, Dict, Iterator, Optional, Protocol, Tuple

import numpy as np

__all__ = ["FileResultStore", "GatewayClosedError", "MemoryResultStore",
           "ResultHandle", "ResultStore"]


class GatewayClosedError(RuntimeError):
    """The gateway shut down (without drain) before this job was served."""


class ResultStore(Protocol):
    """Where finished images live after the engine is done with them."""

    def put(self, job_id: int, image: np.ndarray,
            meta: Optional[Dict[str, Any]] = None) -> str:
        """Persist one result; returns an opaque reference."""
        ...

    def get(self, ref: str) -> np.ndarray:
        """Load the image back by reference."""
        ...

    def meta(self, ref: str) -> Dict[str, Any]:
        """Load the metadata sidecar (``{}`` if none was stored)."""
        ...

    def __len__(self) -> int: ...


class MemoryResultStore:
    """In-memory backend: a dict of ``ref -> (image, meta)``."""

    def __init__(self):
        self._items: Dict[str, Tuple[np.ndarray, Dict[str, Any]]] = {}

    def put(self, job_id: int, image: np.ndarray,
            meta: Optional[Dict[str, Any]] = None) -> str:
        ref = f"mem:{job_id}"
        self._items[ref] = (np.asarray(image), dict(meta or {}))
        return ref

    def get(self, ref: str) -> np.ndarray:
        return self._items[ref][0]

    def meta(self, ref: str) -> Dict[str, Any]:
        return dict(self._items[ref][1])

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)


class FileResultStore:
    """Filesystem backend: ``<dir>/<job_id>.npy`` + ``<job_id>.json``.
    The reference is the ``.npy`` path, so results survive the process
    and the serving host's memory holds only path strings."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._count = 0

    def put(self, job_id: int, image: np.ndarray,
            meta: Optional[Dict[str, Any]] = None) -> str:
        path = os.path.join(self.directory, f"{job_id}.npy")
        np.save(path, np.asarray(image))
        if meta:
            with open(os.path.join(self.directory, f"{job_id}.json"),
                      "w") as fh:
                json.dump(meta, fh)
        self._count += 1
        return path

    def get(self, ref: str) -> np.ndarray:
        return np.load(ref)

    def meta(self, ref: str) -> Dict[str, Any]:
        side = os.path.splitext(ref)[0] + ".json"
        if not os.path.exists(side):
            return {}
        with open(side) as fh:
            return json.load(fh)

    def __len__(self) -> int:
        return self._count


class ResultHandle:
    """Completion handle for one accepted job.

    Resolves (from the dispatcher's worker thread) to a store reference
    plus a small metadata dict — route, node, scores, latencies — never
    the pixels; ``image()`` fetches those from the store on demand.
    """

    def __init__(self, job_id: int, store: ResultStore):
        self.job_id = job_id
        self._store = store
        self._future: "concurrent.futures.Future[str]" = \
            concurrent.futures.Future()
        self.meta: Dict[str, Any] = {}

    # -- dispatcher side ----------------------------------------------------

    def _resolve(self, ref: str, meta: Dict[str, Any]) -> None:
        self.meta = meta
        self._future.set_result(ref)

    def _fail(self, exc: BaseException) -> None:
        if not self._future.done():
            self._future.set_exception(exc)

    # -- client side --------------------------------------------------------

    def done(self) -> bool:
        return self._future.done()

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until served; returns the result-store reference."""
        return self._future.result(timeout)

    async def wait_async(self) -> str:
        """Awaitable form of :meth:`wait` (asyncio, stdlib bridge)."""
        import asyncio
        return await asyncio.wrap_future(self._future)

    @property
    def ref(self) -> Optional[str]:
        return self._future.result(0) if self._future.done() else None

    def image(self) -> np.ndarray:
        """Fetch the finished image from the result store (blocks until
        the job is served)."""
        return self._store.get(self.wait())
