"""Parser-output quality metrics (§2.2, §7.2).

Texts are token-id sequences (numpy int arrays). Metrics:

- BLEU      — corpus/doc n-gram precision (n<=4), brevity penalty.
- ROUGE-L   — LCS-based F-measure (batched row DP).
- CAR       — character accuracy rate ~ 1 - normalized word-level
              Levenshtein, weighted by per-token character length.
- coverage  — fraction of reference pages with any matching output.
- AT        — accepted tokens: fraction of tokens in documents whose BLEU
              exceeds a threshold (the paper's goodput numerator).

``score_batch`` is the vectorized per-document front door: all three
hypothesis-vs-reference scorers run over one padded (B, max_len) batch
with length masks on a torch device — the hot path of the online
quality probe (core/quality). BLEU goes through the n-gram op
(kernels/ngram_score: the CUDA kernel on a CUDA device, the float64
plain version on the CPU); ROUGE-L and CAR are exact-integer DPs run one
row of the first sequence at a time over the whole batch. ``rouge_l``
and ``car`` are thin corpus-mean wrappers over it; ``evaluate_parser``
scores BLEU with the host ``bleu``.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.kernels.ngram_score.ops import ngram_bleu

# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------


def _ngram_counts(seq: np.ndarray, n: int) -> Counter:
    if len(seq) < n:
        return Counter()
    view = np.lib.stride_tricks.sliding_window_view(seq, n)
    return Counter(map(tuple, view))


def bleu(ref: np.ndarray, hyp: np.ndarray, max_n: int = 4,
         smooth: float = 1e-9) -> float:
    """Sentence/document BLEU with uniform weights and brevity penalty."""
    ref = np.asarray(ref).ravel()
    hyp = np.asarray(hyp).ravel()
    if len(hyp) == 0:
        return 0.0
    log_p = 0.0
    for n in range(1, max_n + 1):
        rc, hc = _ngram_counts(ref, n), _ngram_counts(hyp, n)
        total = max(sum(hc.values()), 1)
        clipped = sum(min(c, rc[g]) for g, c in hc.items())
        log_p += np.log((clipped + smooth) / total)
    log_p /= max_n
    bp = min(1.0, np.exp(1.0 - len(ref) / max(len(hyp), 1)))
    return float(bp * np.exp(log_p))


def corpus_bleu(refs: list[np.ndarray], hyps: list[np.ndarray],
                max_n: int = 4) -> float:
    """Corpus BLEU (pooled n-gram counts, standard Papineni definition)."""
    tot_clip = np.zeros(max_n)
    tot = np.zeros(max_n)
    ref_len = hyp_len = 0
    for ref, hyp in zip(refs, hyps):
        ref = np.asarray(ref).ravel()
        hyp = np.asarray(hyp).ravel()
        ref_len += len(ref)
        hyp_len += len(hyp)
        for n in range(1, max_n + 1):
            rc, hc = _ngram_counts(ref, n), _ngram_counts(hyp, n)
            tot[n - 1] += sum(hc.values())
            tot_clip[n - 1] += sum(min(c, rc[g]) for g, c in hc.items())
    if hyp_len == 0:
        return 0.0
    log_p = np.mean(np.log((tot_clip + 1e-9) / np.maximum(tot, 1)))
    bp = min(1.0, np.exp(1.0 - ref_len / max(hyp_len, 1)))
    return float(bp * np.exp(log_p))


# ---------------------------------------------------------------------------
# LCS (ROUGE-L) and Levenshtein (CAR) — batched row DPs
# ---------------------------------------------------------------------------


def _lcs_batch(a: torch.Tensor, b: torch.Tensor, la: torch.Tensor,
               lb: torch.Tensor) -> torch.Tensor:
    """Batched LCS length. a, b: (B, max_len) padded; la, lb true lengths.

    Row i of the DP over ``a`` for the whole batch at once:
    new[j] = max(prev[j], new[j-1], prev[j-1] + match[j]) unrolls to a
    prefix max, new = cummax(max(prev[j], prev[j-1] + match[j])). Rows
    past ``la`` match nothing and leave the (nondecreasing) row as it
    is, so the loop stops at the longest ``a``."""
    n, max_len = a.shape
    dev = a.device
    valid_b = torch.arange(max_len, device=dev)[None, :] < lb[:, None]
    prev = torch.zeros((n, max_len), dtype=torch.int64, device=dev)
    zero = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    n_rows = int(la.max()) if n else 0
    for i in range(n_rows):
        match = ((b == a[:, i:i + 1]) & valid_b
                 & (i < la)[:, None]).long()
        diag = torch.cat([zero, prev[:, :-1]], dim=1)
        prev = torch.cummax(torch.maximum(prev, diag + match), dim=1).values
    last = prev.gather(1, torch.clamp(lb - 1, min=0)[:, None].long())[:, 0]
    return last * (lb > 0)


def _edit_distance_batch(a: torch.Tensor, b: torch.Tensor,
                         la: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """Batched word-level Levenshtein distance on padded id sequences.

    Row i for the whole batch at once: with y[j] = min(prev[j] + 1,
    prev[j-1] + sub[j]) (prev[-1] = i), the left-neighbour recursion
    new[j] = min(y[j], new[j-1] + 1) unrolls to new[j] = j +
    cummin(y[k] - k). Rows past ``la`` keep the previous row."""
    n, max_len = a.shape
    dev = a.device
    j = torch.arange(max_len, device=dev)
    prev = torch.minimum((j + 1)[None, :], lb[:, None].long())
    n_rows = int(la.max()) if n else 0
    for i in range(n_rows):
        sub = (b != a[:, i:i + 1]).long()
        diag = torch.cat([torch.full((n, 1), i, dtype=torch.int64,
                                     device=dev), prev[:, :-1]], dim=1)
        y = torch.minimum(prev + 1, diag + sub)
        new = j[None, :] + torch.cummin(y - j[None, :], dim=1).values
        prev = torch.where((i < la)[:, None], new, prev)
    last = prev.gather(1, torch.clamp(lb - 1, min=0)[:, None].long())[:, 0]
    return last * (lb > 0) + torch.where(lb > 0, 0, la)


def _pad_batch(seqs: list[np.ndarray], max_len: int):
    arr = np.zeros((len(seqs), max_len), np.int32) - 1
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        s = np.asarray(s).ravel()[:max_len]
        arr[i, :len(s)] = s
        lens[i] = len(s)
    return arr, lens


SCORE_METRICS = ("bleu", "rouge", "car")


def score_batch(refs: list[np.ndarray], hyps: list[np.ndarray],
                max_len: int = 512, beta: float = 1.2,
                metrics: tuple[str, ...] = SCORE_METRICS,
                device=None) -> dict[str, np.ndarray]:
    """Vectorized per-document scores for a batch of (reference,
    hypothesis) token streams — the quality probe's hot path — on
    ``device`` (default cuda).

    Every sequence is truncated/padded (with -1) to ``max_len`` and
    scored with length masks: BLEU by the n-gram op (``ngram_bleu``),
    ROUGE-L and CAR by the batched DPs (``_lcs_batch``,
    ``_edit_distance_batch``); an empty hypothesis scores 0 on every
    metric. The batch dimension is padded to the next power of two
    (zero-length rows, sliced off before returning), as the JAX package
    pads it for its jit caches, so the kernel sees the same batches.

    Returns ``{"bleu"|"rouge"|"car": (n,), "ref_len": (n,),
    "hyp_len": (n,)}`` float64 arrays, restricted to ``metrics``.
    """
    if len(refs) != len(hyps):
        raise ValueError(f"score_batch needs one hypothesis per reference "
                         f"(got {len(refs)} refs, {len(hyps)} hyps)")
    bad = [m for m in metrics if m not in SCORE_METRICS]
    if bad:
        raise ValueError(f"unknown score metrics {bad}; "
                         f"choose from {SCORE_METRICS}")
    dev = device_lib.resolve(device)
    n = len(refs)
    if n == 0:
        out = {m: np.zeros(0) for m in metrics}
        out["ref_len"] = np.zeros(0)
        out["hyp_len"] = np.zeros(0)
        return out
    n_pad = 1 << (n - 1).bit_length()
    fill = [np.zeros(0, np.int32)] * (n_pad - n)
    ra, rl = _pad_batch(list(refs) + fill, max_len)
    ha, hl = _pad_batch(list(hyps) + fill, max_len)
    rln = rl.astype(np.float64)[:n]
    hln = hl.astype(np.float64)[:n]
    ra_t, rl_t, ha_t, hl_t = (torch.from_numpy(x).to(dev)
                              for x in (ra, rl, ha, hl))
    out: dict[str, np.ndarray] = {}
    if "bleu" in metrics:
        out["bleu"] = ngram_bleu(ra_t, ha_t, rl_t, hl_t).cpu().numpy() \
            .astype(np.float64)[:n]
    if "rouge" in metrics:
        lcs = _lcs_batch(ra_t, ha_t, rl_t.long(), hl_t.long()) \
            .cpu().numpy().astype(np.float64)[:n]
        p = lcs / np.maximum(hln, 1)
        r = lcs / np.maximum(rln, 1)
        out["rouge"] = ((1 + beta ** 2) * p * r
                        / np.maximum(r + beta ** 2 * p, 1e-9))
    if "car" in metrics:
        dist = _edit_distance_batch(ra_t, ha_t, rl_t.long(), hl_t.long()) \
            .cpu().numpy().astype(np.float64)[:n]
        out["car"] = np.clip(1.0 - dist / np.maximum(rln, 1), 0.0, 1.0)
    out["ref_len"] = rln
    out["hyp_len"] = hln
    return out


def rouge_l(refs: list[np.ndarray], hyps: list[np.ndarray],
            max_len: int = 512, beta: float = 1.2, device=None) -> float:
    """Mean ROUGE-L F score over documents (truncated to max_len tokens)."""
    return float(np.mean(score_batch(refs, hyps, max_len, beta,
                                     metrics=("rouge",),
                                     device=device)["rouge"]))


def car(refs: list[np.ndarray], hyps: list[np.ndarray],
        max_len: int = 512, mean_word_chars: float = 5.0,
        device=None) -> float:
    """Character accuracy rate ≈ 1 - char-edit/chars, where word-level
    edits are weighted by mean word length (substituted words cost a full
    word of characters; the id->charseq map is deterministic so this is a
    tight proxy)."""
    return float(np.mean(score_batch(refs, hyps, max_len,
                                     metrics=("car",),
                                     device=device)["car"]))


# ---------------------------------------------------------------------------
# Document-level aggregates
# ---------------------------------------------------------------------------


def coverage(ref_pages: list[list[np.ndarray]],
             hyp_pages: list[list[np.ndarray]]) -> float:
    """Fraction of reference pages retrieved (non-empty parser output)."""
    total = got = 0
    for rp, hp in zip(ref_pages, hyp_pages):
        total += len(rp)
        got += sum(1 for i in range(len(rp))
                   if i < len(hp) and len(np.asarray(hp[i]).ravel()) > 0)
    return got / max(total, 1)


def accepted_tokens(refs: list[np.ndarray], hyps: list[np.ndarray],
                    doc_bleus: list[float] | None = None,
                    threshold: float = 0.4) -> float:
    """AT: fraction of (reference) tokens living in documents whose BLEU
    exceeds the acceptance threshold."""
    if doc_bleus is None:
        doc_bleus = [bleu(r, h) for r, h in zip(refs, hyps)]
    tok = np.array([len(np.asarray(r).ravel()) for r in refs], np.float64)
    ok = np.array([b > threshold for b in doc_bleus], np.float64)
    return float((tok * ok).sum() / max(tok.sum(), 1))


def evaluate_parser(refs: list[np.ndarray], hyps: list[np.ndarray],
                    ref_pages=None, hyp_pages=None,
                    at_threshold: float = 0.4, device=None) -> dict:
    doc_bleus = [bleu(r, h) for r, h in zip(refs, hyps)]
    out = {
        "bleu": float(np.mean(doc_bleus)),
        "rouge": rouge_l(refs, hyps, device=device),
        "car": car(refs, hyps, device=device),
        "at": accepted_tokens(refs, hyps, doc_bleus, at_threshold),
    }
    if ref_pages is not None:
        out["coverage"] = coverage(ref_pages, hyp_pages)
    return out
