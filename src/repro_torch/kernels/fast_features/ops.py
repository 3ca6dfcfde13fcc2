"""Public fused prepare-stage op: pack once, derive every routing input.

``pack_routing_batch`` lowers a parser-output batch (list of per-doc
page lists) into one flat token stream plus per-doc scalars — the only
Python-loop pass the prepare stage makes over the batch — with the
kernel's (n, width) matrix built lazily, its width a power of two
(>= 128 and >= the encoder ``max_len``). It is the JAX package's
``PackedBatch`` unchanged.

``fast_features`` is the wrapper around the CUDA kernel
(``csrc/fast_features.cu``): for CPU tensors it runs the plain version
(``ref.py``); for CUDA tensors it launches the kernel or raises, at the
block size ``autotune.ensure_tuned`` gives for the packed shape (the
default, 256 threads, unless a tuning store is configured; with one, a
miss sweeps the candidates on the card first).
``routing_features`` moves a ``PackedBatch`` to a device and calls it.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import I, P
from repro_torch.kernels.fast_features import autotune
from repro_torch.kernels.fast_features.ref import (N_FAST_FEATURES,
                                                   fast_features_ref)

MIN_WIDTH = 128
# shared memory a block may use on Hopper (227 KB), less 256 bytes for
# the kernel's static shared memory: the presence bitmap holds
# ceil(vocab_size / 32) words
MAX_VOCAB = (227 * 1024 - 256) * 8

KERNEL = cuda_lib.CudaKernel(
    "fast_features", "adaparse_fast_features",
    [P] * 5 + [I] * 10 + [P] * 4 + [I, P])


@dataclasses.dataclass(frozen=True)
class PackedBatch:
    """One parser-output batch as packed stream + per-doc scalars."""

    flat: np.ndarray         # (T,) int32 concatenated per-doc streams
    rows: np.ndarray         # (T,) int32 doc index per token
    starts: np.ndarray       # (n,) int64 stream start offsets
    n_tok: np.ndarray        # (n,) int32 true stream lengths
    first_len: np.ndarray    # (n,) int32 first-page lengths
    n_pages: np.ndarray      # (n,) int32
    n_empty: np.ndarray      # (n,) int32 empty (zero-token) pages
    max_len: int             # requested encoder width (0: features only)
    width: int               # padded kernel matrix width (power of two)

    @functools.cached_property
    def tok_matrix(self) -> np.ndarray:
        """(n, width) zero-padded stream matrix."""
        tok = np.zeros((len(self.n_tok), self.width), np.int32)
        if len(self.flat):
            cols = np.arange(len(self.flat)) - self.starts[self.rows]
            tok[self.rows, cols] = self.flat
        return tok


def _pow2_width(target: int) -> int:
    return max(MIN_WIDTH, 1 << int(max(target, 1) - 1).bit_length())


def pack_routing_batch(page_lists, max_len: int = 0) -> PackedBatch:
    """Concatenate each document's pages into one flat stream.

    ``width`` = next power of two >= max(longest stream, ``max_len``,
    ``MIN_WIDTH``), guaranteeing the kernel's first-page slice
    (width >= max_len - 1) and bounding distinct widths."""
    n = len(page_lists)
    pages_per_doc = np.fromiter((len(p) for p in page_lists), np.int64,
                                count=n)
    doc_of_page = np.repeat(np.arange(n), pages_per_doc)
    flat_pages = [pg for p in page_lists for pg in p]
    page_lens = np.fromiter((len(pg) for pg in flat_pages), np.int64,
                            count=len(flat_pages))
    n_empty = np.bincount(doc_of_page[page_lens == 0], minlength=n)
    doc_lens = np.zeros(n, np.int64)
    np.add.at(doc_lens, doc_of_page, page_lens)
    first_len = np.fromiter(
        ((len(p[0]) if p else 0) for p in page_lists), np.int64, count=n)
    starts = np.cumsum(doc_lens) - doc_lens
    flat = (np.concatenate(flat_pages).astype(np.int32, copy=False)
            if page_lens.sum() else np.zeros(0, np.int32))
    rows = np.repeat(np.arange(n, dtype=np.int32), doc_lens)
    width = _pow2_width(max(int(doc_lens.max()) if n else 0, int(max_len)))
    return PackedBatch(flat=flat, rows=rows, starts=starts,
                       n_tok=doc_lens.astype(np.int32),
                       first_len=first_len.astype(np.int32),
                       n_pages=pages_per_doc.astype(np.int32),
                       n_empty=n_empty.astype(np.int32),
                       max_len=int(max_len), width=width)


def _check(tok, scalars, max_len: int, vocab_size: int) -> None:
    if tok.dim() != 2 or tok.dtype != torch.int32 or not tok.is_contiguous():
        raise ValueError(f"fast_features: tok must be a contiguous (n, "
                         f"width) int32 tensor (got {tuple(tok.shape)} "
                         f"{tok.dtype})")
    n, width = tok.shape
    for s in scalars:
        if (s.shape != (n,) or s.dtype != torch.int32
                or s.device != tok.device or not s.is_contiguous()):
            raise ValueError(f"fast_features: per-doc scalars must be "
                             f"contiguous ({n},) int32 tensors on "
                             f"{tok.device}")
    if max_len < 0 or (max_len and width < max_len - 1):
        raise ValueError(f"fast_features: width {width} < max_len-1="
                         f"{max_len - 1}")
    if not 1 <= vocab_size <= MAX_VOCAB:
        raise ValueError(f"fast_features: vocab_size {vocab_size} outside "
                         f"[1, {MAX_VOCAB}] (shared-memory bitmap)")


def launch_grid(n: int) -> list[tuple[int, int]]:
    """(blocks, threads) of the kernel one default launch runs."""
    return [(n, autotune.DEFAULT_THREADS)]


def _launch(tok, n_tok, first_len, n_pages, n_empty, fast, toks, mask,
            err, *, max_len, ws, scramble, mangled, latex_lo, ident_lo,
            vocab_size, bos, threads=autotune.DEFAULT_THREADS) -> None:
    """One kernel launch into preallocated outputs at ``threads`` a
    block, no synchronisation (``err`` must be zeroed)."""
    n, width = tok.shape
    KERNEL(tok.data_ptr(), n_tok.data_ptr(), first_len.data_ptr(),
           n_pages.data_ptr(), n_empty.data_ptr(), n, width, max_len,
           ws, scramble, mangled, latex_lo, ident_lo, vocab_size, bos,
           fast.data_ptr(), toks.data_ptr() if max_len else None,
           mask.data_ptr() if max_len else None, err.data_ptr(),
           int(threads), cuda_lib.stream_of(tok.device))


def fast_features(tok, n_tok, first_len, n_pages, n_empty, *,
                  max_len: int, ws: int, scramble: int, mangled: int,
                  latex_lo: int, ident_lo: int, vocab_size: int,
                  bos: int = 1, threads: int | None = None):
    """Packed (n, width) token matrix + per-doc scalars -> (fast (n, 8)
    f32, toks (n, max_len) i32, mask (n, max_len) f32), or (fast, None,
    None) when ``max_len == 0``. CPU tensors: plain version; CUDA
    tensors: the kernel, at ``threads`` a block (None: the tuned value
    for (width, max_len), ``autotune.ensure_tuned``). Raises ValueError
    on a token outside [0, vocab_size) either way."""
    kw = dict(max_len=max_len, ws=ws, scramble=scramble, mangled=mangled,
              latex_lo=latex_lo, ident_lo=ident_lo, vocab_size=vocab_size,
              bos=bos)
    scalars = (n_tok, first_len, n_pages, n_empty)
    _check(tok, scalars, max_len, vocab_size)
    if tok.device.type == "cpu":
        return fast_features_ref(tok, *scalars, **kw)
    if tok.device.type != "cuda":
        raise ValueError(f"fast_features: unsupported device {tok.device}")
    n = tok.shape[0]
    dev = tok.device
    fast = torch.empty((n, N_FAST_FEATURES), dtype=torch.float32,
                       device=dev)
    toks = mask = None
    if max_len:
        toks = torch.empty((n, max_len), dtype=torch.int32, device=dev)
        mask = torch.empty((n, max_len), dtype=torch.float32, device=dev)
    if n == 0:
        return fast, toks, mask
    if threads is None:
        threads = autotune.ensure_tuned(tok.shape[1], max_len, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch(tok, *scalars, fast, toks, mask, err, threads=threads, **kw)
    if int(err.item()):
        raise ValueError(f"fast_features: token id outside "
                         f"[0, vocab_size={vocab_size}) in the packed stream")
    return fast, toks, mask


def routing_features(packed: PackedBatch, *, ws: int, scramble: int,
                     mangled: int, latex_lo: int, ident_lo: int,
                     vocab_size: int, device, bos: int = 1):
    """Packed batch -> (fast, toks, mask) tensors on ``device``;
    toks/mask are None when the batch was packed with ``max_len == 0``."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return fast_features(
        dev(packed.tok_matrix), dev(packed.n_tok), dev(packed.first_len),
        dev(packed.n_pages), dev(packed.n_empty), max_len=packed.max_len,
        ws=ws, scramble=scramble, mangled=mangled, latex_lo=latex_lo,
        ident_lo=ident_lo, vocab_size=vocab_size, bos=bos)
