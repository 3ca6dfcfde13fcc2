"""Workload batches, the port of ``repro/launch/specs.py``'s seeded
batch functions (its jitted cells are the JAX package's own lowering and
are not ported)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import RecsysConfig


def _recsys_batch(cfg: RecsysConfig, b: int, seed: int = 0,
                  device=None) -> dict:
    """A copy of the JAX function's concrete branch: numpy
    ``RandomState(seed)``, uniform ids per field (int32), labels with
    P(1) = 0.3, standard normal dense features; DIEN adds the history.
    Returns tensors on ``device`` (cuda unless "cpu")."""
    dev = device_lib.resolve(device)
    rng = np.random.RandomState(seed)
    sparse = np.stack([rng.randint(0, v, b) for v in cfg.vocab_sizes], 1)
    batch = {"sparse": sparse.astype(np.int32),
             "labels": (rng.rand(b) < 0.3).astype(np.float32)}
    if cfg.kind == "dlrm":
        batch["dense"] = rng.randn(b, cfg.n_dense).astype(np.float32)
    if cfg.kind == "dien":
        t = cfg.seq_len
        v0, v1 = cfg.vocab_sizes[0], sum(cfg.vocab_sizes)
        batch.update(
            hist=rng.randint(0, v0, (b, t)).astype(np.int32),
            hist_cat=rng.randint(v0, v1, (b, t)).astype(np.int32),
            hist_mask=np.ones((b, t), np.float32),
            target=rng.randint(0, v0, b).astype(np.int32),
            target_cat=rng.randint(v0, v1, b).astype(np.int32))
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
