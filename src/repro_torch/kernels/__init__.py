"""Hand-written Hopper kernels of the serving path, with their plain
PyTorch versions.

Every kernel here replaces one Pallas TPU kernel of the JAX package
(all six of them):

==========================  ======  ==========================================
kernel                      route   replaces
==========================  ======  ==========================================
``vdb_topk_pernode``        CUDA    ``repro/kernels/vdb_topk.py::vdb_topk_pernode``
``vdb_topk_sharded``        CUDA    ``repro/kernels/vdb_topk.py::vdb_topk_sharded``
``vdb_topk``                CUDA    ``repro/kernels/vdb_topk.py::vdb_topk``
``flash_attention``         CUDA    ``repro/kernels/flash_attention.py::flash_attention``
``adaln_modulate``          Triton  ``repro/kernels/adaln.py::adaln_modulate``
``groupnorm_silu``          CUDA    ``repro/kernels/groupnorm_silu.py::groupnorm_silu``
==========================  ======  ==========================================

:mod:`repro_torch.kernels.ops` dispatches on the tensor's device: a CPU
tensor takes the plain version (:mod:`repro_torch.kernels.ref`), a CUDA
tensor launches the kernel or raises — there is no fallback.

``LAUNCHES`` counts kernel launches per kernel.  A wrapper adds one right
after its kernel was launched, and nowhere else, so a run can show that
its path really went through the kernels (``reset_launches`` before the
run, ``LAUNCHES`` after it).
"""
from __future__ import annotations

from typing import Dict

KERNELS = ("vdb_topk_pernode", "vdb_topk_sharded", "vdb_topk",
           "flash_attention", "adaln_modulate", "groupnorm_silu")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
