"""PyTorch/CUDA port of the AdaParse engine (``repro``), for one NVIDIA
Hopper card. Mirrors ``repro``'s layout module for module; the hot-path
kernels under ``kernels/`` are CUDA C++ built for ``sm_90a`` at first
use. Imports no JAX and nothing of ``repro``."""
