"""Learning-rate schedules, the port of ``repro.optim.schedules``: pure
functions of the step (a host int) that return a numpy float32, computed
in float32 as the JAX package computes them (its cosine is taken in
float64 and rounded once; XLA's float32 cosine and this one may differ
in the last bit). The optimizers take the value on the host, so a
schedule costs no device work and gives the same value on every
device."""
from __future__ import annotations

import numpy as np

_f32 = np.float32


def constant(lr: float):
    return lambda step: _f32(lr)


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        s = _f32(step)
        return _f32(lr) * min(_f32(1.0), (s + _f32(1.0))
                              / _f32(max(warmup_steps, 1)))

    return fn


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        s = _f32(np.clip(_f32(step), _f32(0), _f32(total_steps)))
        arg = _f32(np.pi) * s / _f32(max(total_steps, 1))
        cos = _f32(0.5) * (_f32(1.0) + _f32(np.cos(np.float64(arg))))
        ff = _f32(final_frac)
        return _f32(lr) * (ff + (_f32(1.0) - ff) * cos)

    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    wu = linear_warmup(lr, warmup_steps)
    cd = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        s = _f32(step)
        return wu(step) if s < _f32(warmup_steps) else cd(
            s - _f32(warmup_steps))

    return fn
