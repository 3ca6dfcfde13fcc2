"""Plain PyTorch version of the ngram_score kernel: exact float64 BLEU.

Same scoring rule as ``metrics.bleu`` (uniform n <= max_n weights,
brevity penalty, 1e-9 smoothing) on padded (B, max_len) id batches with
length masks, by the equality-matrix rule: the (max_len, max_len)
hyp-hyp and hyp-ref token equality matrices are extended per order by
the base matrix shifted up-left (an (n+1)-gram match is an n-gram match
AND a token match one position later); hyp occurrence i of an n-gram is
creditable iff its rank among equal earlier hyp grams is below the
gram's count in the reference. Counts are exact integers; the log
precision, brevity penalty and empty-hypothesis zero are float64. Runs
on any device; the CPU dispatch path of ``ops`` and the reference the
CUDA kernel is held against.
"""
from __future__ import annotations

import torch

SMOOTH = 1e-9


def _shift(eq, t: int):
    """eq[:, i + t, j + t] at (i, j); False past the edge."""
    if t == 0:
        return eq
    out = torch.zeros_like(eq)
    out[:, :-t, :-t] = eq[:, t:, t:]
    return out


def ngram_bleu_ref(ref, hyp, ref_len, hyp_len, *, max_n: int = 4):
    """ref, hyp (B, max_len) int; ref_len, hyp_len (B,) true lengths ->
    (B,) float64 per-document BLEU (padding beyond the lengths is
    ignored)."""
    b, max_len = ref.shape
    dev = ref.device
    lr = ref_len.long()
    lh = hyp_len.long()
    pos = torch.arange(max_len, device=dev)
    lower = pos[:, None] > pos[None, :]          # strictly earlier starts
    eq_hh = hyp[:, :, None] == hyp[:, None, :]
    eq_hr = hyp[:, :, None] == ref[:, None, :]
    m_hh, m_hr = eq_hh, eq_hr
    log_p = torch.zeros(b, dtype=torch.float64, device=dev)
    for n in range(1, max_n + 1):
        if n > 1:
            m_hh = m_hh & _shift(eq_hh, n - 1)
            m_hr = m_hr & _shift(eq_hr, n - 1)
        ph = pos[None, :] <= (lh - n)[:, None]    # valid hyp n-gram starts
        pr = pos[None, :] <= (lr - n)[:, None]
        total = torch.clamp(lh - n + 1, min=0)
        rc = (m_hr & pr[:, None, :]).sum(-1)
        occ = (m_hh & lower[None] & ph[:, None, :]).sum(-1)
        clipped = (ph & (occ < rc)).sum(-1)
        log_p = log_p + torch.log((clipped.double() + SMOOTH)
                                  / torch.clamp(total, min=1).double())
    log_p = log_p / max_n
    bp = torch.clamp(torch.exp(1.0 - lr.double()
                               / torch.clamp(lh, min=1).double()), max=1.0)
    return torch.where(lh > 0, bp * torch.exp(log_p),
                       torch.zeros_like(log_p))
