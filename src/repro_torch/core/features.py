"""CLS-I fast features (§5.1): aggregate statistics of the extracted text.

These are "coarse but fast-to-compute" (length, whitespace fraction,
garbage fraction, LaTeX markers, ...) — interpretable and vectorized.
``batch_fast_features`` computes all documents' features from one flat
token stream (segment reductions via bincount), so the engine never
loops over documents in Python on its hot path.

``prepare_routing_inputs`` is the fused prepare-stage entry the engine
dispatches through: one call derives the fast features *and* (for the
LLM router variant) the first-page token/mask pair via
``kernels.fast_features`` — the CUDA kernel on a CUDA device, its plain
PyTorch version on the CPU. The legacy per-function numpy pipeline
below stays as the bit-for-bit reference (``mode="host"``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.data.synthetic import MANGLED, SCRAMBLE, WS, CorpusConfig
from repro_torch.kernels.fast_features import ops as ff_ops

N_FAST_FEATURES = 8
FEATURE_KERNEL_MODES = ("auto", "force", "host")


def batch_fast_features(page_lists, cfg: CorpusConfig) -> np.ndarray:
    """Parser outputs (list of per-doc page lists) -> (n, F) float32.

    Vectorized over the whole batch: per-doc statistics are segment sums
    (``np.bincount`` keyed by a flat doc-of-token index) over the
    concatenated token stream. Documents with no output tokens get an
    all-zero row (the CLS-I "empty extraction" signature).
    """
    n_docs = len(page_lists)
    out = np.zeros((n_docs, N_FAST_FEATURES), np.float32)
    if n_docs == 0:
        return out
    pages_per_doc = np.fromiter((len(p) for p in page_lists), np.int64,
                                count=n_docs)
    doc_of_page = np.repeat(np.arange(n_docs), pages_per_doc)
    flat_pages = [pg for p in page_lists for pg in p]
    n_pages = len(flat_pages)
    page_lens = np.fromiter((len(pg) for pg in flat_pages), np.int64,
                            count=n_pages)
    empty_pages = np.bincount(doc_of_page[page_lens == 0],
                              minlength=n_docs).astype(np.float64)

    t = (np.concatenate(flat_pages) if n_pages
         else np.zeros(0, np.int32)).astype(np.int64)
    tok_doc = np.repeat(doc_of_page, page_lens)
    n_tok = np.bincount(tok_doc, minlength=n_docs).astype(np.float64)
    denom = np.maximum(n_tok, 1.0)

    def frac(mask):
        return np.bincount(tok_doc[mask], minlength=n_docs) / denom

    frac_ws = frac(t == WS)
    frac_scr = frac(t == SCRAMBLE)
    frac_mangled = frac(t == MANGLED)
    frac_latex = frac((t >= cfg.latex_lo) & (t < cfg.ident_lo))
    # distinct tokens per doc: unique composite (doc, token) keys
    key = tok_doc * int(cfg.vocab_size) + t
    uniq = (np.bincount(np.unique(key) // int(cfg.vocab_size),
                        minlength=n_docs) / denom)

    out[:, 0] = np.log1p(n_tok) / 10.0
    out[:, 1] = frac_ws
    out[:, 2] = frac_scr
    out[:, 3] = frac_mangled
    out[:, 4] = frac_latex
    out[:, 5] = uniq
    out[:, 6] = empty_pages / np.maximum(pages_per_doc, 1)
    out[:, 7] = pages_per_doc / 10.0
    # docs with no output at all keep the all-zero signature row
    out[n_tok == 0] = 0.0
    return out


def fast_features(pages: list[np.ndarray], cfg: CorpusConfig) -> np.ndarray:
    """Single-doc convenience wrapper -> (N_FAST_FEATURES,) float32."""
    return batch_fast_features([pages], cfg)[0]


def first_page_tokens(pages: list[np.ndarray], max_len: int,
                      bos: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """First-page text -> fixed-length (tokens, mask) for the CLS-III LLM."""
    page = pages[0] if pages and len(pages[0]) else np.zeros(0, np.int32)
    toks = np.zeros(max_len, np.int32)
    toks[0] = bos
    m = min(len(page), max_len - 1)
    toks[1:1 + m] = page[:m]
    mask = np.zeros(max_len, np.float32)
    mask[:1 + m] = 1.0
    return toks, mask


def prepare_routing_inputs(page_lists, cfg: CorpusConfig, *,
                           max_len: int | None = None,
                           mode: str = "auto", device=None):
    """Every routing input in one fused pass -> (fast, toks, mask)
    tensors on ``device`` (default cuda).

    ``fast`` is the (n, 8) CLS-I feature block; ``toks``/``mask`` are
    the (n, max_len) first-page encoder inputs, or None when
    ``max_len`` is None (the ft router variant needs features only).

    ``mode`` (``EngineConfig.feature_kernel``): "auto" runs the CUDA
    fast_features kernel on a CUDA device and its plain version on the
    CPU; "force" insists on the kernel and raises on the CPU; "host" is
    the legacy unfused numpy ``batch_fast_features`` +
    ``batch_first_page_tokens`` pipeline, moved to ``device``.
    """
    if mode not in FEATURE_KERNEL_MODES:
        raise ValueError(f"feature_kernel mode {mode!r} not in "
                         f"{FEATURE_KERNEL_MODES}")
    dev = device_lib.resolve(device)
    if mode == "host":
        fast = torch.from_numpy(batch_fast_features(page_lists, cfg)).to(dev)
        if max_len is None:
            return fast, None, None
        toks, mask = batch_first_page_tokens(page_lists, max_len)
        return fast, torch.from_numpy(toks).to(dev), \
            torch.from_numpy(mask).to(dev)
    if mode == "force" and dev.type != "cuda":
        raise ValueError(f"feature_kernel mode 'force' runs the CUDA "
                         f"kernel; device {str(dev)!r} has none (use "
                         f"'auto' or 'host')")
    packed = ff_ops.pack_routing_batch(page_lists,
                                       max_len=int(max_len or 0))
    return ff_ops.routing_features(
        packed, ws=WS, scramble=SCRAMBLE, mangled=MANGLED,
        latex_lo=cfg.latex_lo, ident_lo=cfg.ident_lo,
        vocab_size=cfg.vocab_size, device=dev)


def batch_first_page_tokens(page_lists, max_len: int, bos: int = 1
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Batched ``first_page_tokens`` -> ((n, L) int32, (n, L) float32).

    One scatter into the padded token matrix instead of n per-doc
    assemblies: first pages are concatenated (truncated to L-1) and
    written through flat (row, col) indices.
    """
    n = len(page_lists)
    toks = np.zeros((n, max_len), np.int32)
    mask = np.zeros((n, max_len), np.float32)
    if n == 0:
        return toks, mask
    toks[:, 0] = bos
    firsts = [(p[0][:max_len - 1] if p and len(p[0]) else
               np.zeros(0, np.int32)) for p in page_lists]
    lens = np.fromiter((len(f) for f in firsts), np.int64, count=n)
    rows = np.repeat(np.arange(n), lens)
    cols = (np.arange(len(rows)) -
            np.repeat(np.cumsum(lens) - lens, lens) + 1)
    if len(rows):
        toks[rows, cols] = np.concatenate(firsts)
    mask[np.arange(max_len)[None, :] < (lens + 1)[:, None]] = 1.0
    return toks, mask
