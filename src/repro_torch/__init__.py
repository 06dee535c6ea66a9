"""PyTorch/CUDA port of the CacheGenius serving system.

A second package beside the JAX reference (``src/repro``): the same
layout and names, written in PyTorch, with every TPU kernel on the
serving path rewritten by hand for NVIDIA Hopper (CUDA C++ built with
``nvcc`` for ``sm_90a``, or Triton).  Entry points take an explicit
``device`` that defaults to ``"cuda"``; pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels on the host.

This package imports ``torch`` and numpy only — never JAX, and nothing
of the JAX package.
"""
