"""Device resolution for every entry point of the port.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; asking
for ``cuda`` without a card raises — nothing falls back to the CPU.
``meta`` gives shape-only tensors (the cell factory's abstract cells,
``launch/specs.build_cell``), which allocate nothing.

TF32 is switched off for matmuls and cuDNN: the f32 parity tolerances
(2e-5 against the JAX package's f32 encoder) assume full-f32 products,
and TF32 keeps only ~3 decimal digits.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> cuda. Raises when a CUDA device is asked for and no
    card is visible."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda, cpu or "
                         f"meta)")
    return dev
