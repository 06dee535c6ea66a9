"""Hand-written Hopper kernels of the serving path, with their plain
PyTorch versions.

Every kernel here replaces one Pallas TPU kernel of the JAX package
(all six of them; flash attention has a float32 and a bfloat16 kernel,
counted apart):

==========================  ======  ==========================================
kernel                      route   replaces
==========================  ======  ==========================================
``vdb_topk_pernode``        CUDA    ``repro/kernels/vdb_topk.py::vdb_topk_pernode``
``vdb_topk_sharded``        CUDA    ``repro/kernels/vdb_topk.py::vdb_topk_sharded``
``vdb_topk``                CUDA    ``repro/kernels/vdb_topk.py::vdb_topk``
``flash_attention``         CUDA    ``repro/kernels/flash_attention.py::flash_attention``
``flash_attention_bf16``    CUDA    the same, at bfloat16
``adaln_modulate``          CUDA    ``repro/kernels/adaln.py::adaln_modulate``
``groupnorm_silu``          CUDA    ``repro/kernels/groupnorm_silu.py::groupnorm_silu``
==========================  ======  ==========================================

:mod:`repro_torch.kernels.ops` dispatches on the tensor's device: a CPU
tensor takes the plain version (:mod:`repro_torch.kernels.ref`), a CUDA
tensor launches the kernel or raises — there is no fallback.

``LAUNCHES`` counts kernel launches per kernel, and ``LAUNCHES_BY_SHAPE``
the same launches per kernel and input shape.  A wrapper calls
:func:`count_launch` right after its kernel was launched, and nowhere
else, so a run can show that its path really went through the kernels,
and at which shapes (``reset_launches`` before the run, the two dicts
after it).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Tuple

KERNELS = ("vdb_topk_pernode", "vdb_topk_sharded", "vdb_topk",
           "flash_attention", "flash_attention_bf16", "adaln_modulate",
           "groupnorm_silu")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
LAUNCHES_BY_SHAPE: Dict[str, Counter] = {name: Counter() for name in KERNELS}


def count_launch(name: str, shape: Tuple[int, ...]) -> None:
    LAUNCHES[name] += 1
    LAUNCHES_BY_SHAPE[name][tuple(shape)] += 1


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
        LAUNCHES_BY_SHAPE[name].clear()
