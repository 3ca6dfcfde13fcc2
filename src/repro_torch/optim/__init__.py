"""The port of ``repro.optim``: the optimizer core and AdamW, which the
router's post-training (``core/dpo.py``) uses. ``adafactor``,
``schedules`` and ``compression`` are not ported yet (ROADMAP item 13c)."""
from repro_torch.optim.adamw import adamw
from repro_torch.optim.base import (Optimizer, apply_updates, chain_clip,
                                    clip_by_global_norm, global_norm)
