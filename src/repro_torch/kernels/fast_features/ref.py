"""Plain PyTorch version of the fast_features kernel.

Same inputs as the kernel — the padded (n, width) token matrix and the
per-document scalars of ``ops.PackedBatch`` — and the same outputs:
the (n, 8) CLS-I features and, when ``max_len > 0``, the BOS-shifted
first-page (toks, mask) pair. Every per-document count is an exact
integer; the eight ratios and ``log1p`` are computed in float64 and
rounded to float32 once, term by term as the JAX package's float64
oracle (``repro/kernels/fast_features/ref.py``) assembles them. The
distinct-token count sorts each row's valid tokens and counts value
changes. Runs on any device; the CPU dispatch path of ``ops`` and the
reference the CUDA kernel is held against.
"""
from __future__ import annotations

import torch

N_FAST_FEATURES = 8


def fast_features_ref(tok, n_tok, first_len, n_pages, n_empty, *,
                      max_len: int, ws: int, scramble: int, mangled: int,
                      latex_lo: int, ident_lo: int, vocab_size: int,
                      bos: int = 1):
    """tok (n, width) int32, per-doc scalars (n,) int32 -> (fast (n, 8)
    f32, toks (n, max_len) i32, mask (n, max_len) f32), or
    (fast, None, None) when ``max_len == 0``. Raises ValueError on a
    valid token outside [0, vocab_size)."""
    n, width = tok.shape
    dev = tok.device
    nt = n_tok.long()
    t = tok.long()
    valid = torch.arange(width, device=dev)[None, :] < nt[:, None]
    if bool((valid & ((t < 0) | (t >= vocab_size))).any()):
        raise ValueError(f"fast_features: token id outside "
                         f"[0, vocab_size={vocab_size}) in the packed stream")

    def count(m):
        return (m & valid).sum(1)

    denom = nt.double().clamp(min=1.0)
    srt = torch.where(valid, t, vocab_size).sort(dim=1).values
    distinct = ((srt[:, :1] < vocab_size).sum(1)
                + ((srt[:, 1:] != srt[:, :-1])
                   & (srt[:, 1:] < vocab_size)).sum(1))
    pages = n_pages.double()
    fast = torch.stack([
        torch.log1p(nt.double()) / 10.0,
        count(t == ws) / denom,
        count(t == scramble) / denom,
        count(t == mangled) / denom,
        count((t >= latex_lo) & (t < ident_lo)) / denom,
        distinct / denom,
        n_empty.double() / pages.clamp(min=1.0),
        pages / 10.0,
    ], dim=1).float()
    fast[nt == 0] = 0.0              # empty-extraction signature row
    if not max_len:
        return fast, None, None
    m = first_len.long().clamp(max=max_len - 1)
    col = torch.arange(max_len, device=dev)[None, :]
    keep = col <= m[:, None]
    shifted = torch.cat([torch.full((n, 1), bos, dtype=torch.int32,
                                    device=dev),
                         tok[:, :max_len - 1].int()], dim=1)
    toks = torch.where(keep, shifted, torch.zeros_like(shifted))
    return fast, toks, keep.float()
