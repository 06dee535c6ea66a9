"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The libraries go to ``build/kernels/`` at the root of the checkout, named
by a hash of the source and the flags, so an edited source rebuilds and
an unchanged one is reused.  :func:`build_all` starts one ``nvcc`` per
source, all at once, and waits for them; :func:`library` builds at first
use.  Nothing here runs at import time.

The front door launches kernels from its worker thread, so a first use
can come from two threads at once: the check, the build, the load and
the ``ctypes`` declarations of a library happen under one lock, and a
library is published only once it is declared.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("vdb_topk", "flash_attention", "groupnorm_silu", "adaln")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# re-entrant: library() builds through build_all() while holding it
_LOCK = threading.RLock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels build only on a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """What ``nvcc``/``ptxas`` printed for the current build of ``name``
    (registers, shared memory and spills of each kernel)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all() -> Dict[str, float]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    process per source, all started together.  Returns the seconds each
    build took (0.0 for a library that was already built); raises with
    the compiler's output if any build fails."""
    with _LOCK:
        return _build_all()


def _build_all() -> Dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    secs = {name: 0.0 for name in SOURCES}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def library(name: str,
            declare: Optional[Callable[[ctypes.CDLL], None]] = None,
            ) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first
    use; ``declare(lib)`` sets its functions' ``argtypes`` and ``restype``
    before any caller sees it.  One library per name, whichever threads
    ask first."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                path = _target(name)
                if not path.exists():
                    build_all()
                lib = ctypes.CDLL(str(path))
                if declare is not None:
                    declare(lib)
                _LIBS[name] = lib
    return lib


def stream(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device, for
    every wrapper's launch: what ``torch.cuda.current_stream(dev)
    .cuda_stream`` gives, without making a Stream object (a few
    microseconds less host time per launch).  It is the call PyTorch's
    own generated kernels (``torch._inductor``'s ``get_raw_stream``) make
    before each launch."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def launch(t, fn, *args) -> int:
    """``fn(*args)``, a C launcher, with the CUDA runtime's current device
    set to ``t``'s.  A launcher launches on the current device and keeps
    its kernel attributes per device, and the caller's current device may
    be another card of the process.  The device switches only where the
    two differ (one look-up otherwise: K5's host time per call counts),
    and back afterwards."""
    dev = t.get_device()
    if torch._C._cuda_getDevice() == dev:
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def check(err: int, what: str) -> None:
    """Raise if a C launcher returned a nonzero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
