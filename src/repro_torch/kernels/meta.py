"""Shape-only kernel calls: what each wrapper does with ``meta`` tensors.

A wrapper given meta tensors (the dry run, ``launch/dryrun.py``) launches
nothing and counts no launch: it returns empty meta outputs of the
kernel's shapes and dtypes and *charges* the kernel's own work, the
FLOPs and bytes behind its bound in ``PERF.md`` (the inputs read once,
the outputs written once) and the dtype its operations work in, to
every open ``charges`` sink. Where the bound counts data-dependent work
(distinct rows, kept rows, visible n-gram pairs) a meta call has no data
and charges the most the shapes allow. A CPU tensor still takes the plain version and a CUDA tensor the
kernel; meta is never a fallback for either.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

#: open sinks, each ``sink(kernel name, flops, bytes, dtype)``
_SINKS: list[Callable[[str, float, float, torch.dtype], None]] = []


def charge(name: str, flops: float, nbytes: float,
           dtype: torch.dtype) -> None:
    """Charge one shape-only call of kernel ``name``, whose operations
    work in ``dtype``, to every sink."""
    for sink in list(_SINKS):
        sink(name, float(flops), float(nbytes), dtype)


@contextlib.contextmanager
def charges(sink: Callable[[str, float, float, torch.dtype], None]):
    """Send every ``charge`` made inside the block to ``sink``."""
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def empty(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    """An output on ``like``'s (meta) device."""
    return torch.empty(tuple(shape), dtype=dtype, device=like.device)
