"""The port of ``repro.optim``: the optimizer core, AdamW and Adafactor,
the learning-rate schedules and gradient compression. Params, grads and
updates are lists of tensors in one order."""
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw
from repro_torch.optim.base import (Optimizer, apply_updates, chain_clip,
                                    clip_by_global_norm, global_norm)
from repro_torch.optim.compression import (compressed_gradients,
                                           error_feedback_topk)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         linear_warmup, warmup_cosine)
