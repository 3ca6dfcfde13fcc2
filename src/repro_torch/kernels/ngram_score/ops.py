"""Public n-gram BLEU op: the quality probe's scoring hot path.

``ngram_bleu(ref, hyp, ref_len, hyp_len)`` scores a padded (B, max_len)
batch of (reference, hypothesis) token streams per document: the CUDA
kernel (``csrc/ngram_score.cu``, float32, one block of 24 warps per
document by default; a warp scans 32 starts at once for four
hypothesis starts) for CUDA tensors, at the block size the autotune
store holds for the shape (``autotune.tuned_threads``; dispatch reads a
winner, it never sweeps), the plain float64 version (``ref.py``) for CPU
tensors. Meta tensors (the dry run) give the (B,) float32 output and
charge the kernel's work (``kernels/meta.py``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.meshrules import refuse_dtensor
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import meta as meta_lib
from repro_torch.kernels.cuda_lib import I, P
from repro_torch.kernels.ngram_score.autotune import (DEFAULT_THREADS,
                                                      tuned_threads)
from repro_torch.kernels.ngram_score.ref import ngram_bleu_ref

MAX_N = 8                          # csrc kMaxN
# two int32 rows (and 40 ints of padding) of dynamic shared memory per
# block, beside the kernel's static shared memory, within Hopper's 227 KB
MAX_LEN = (227 * 1024 - 256) // 8

KERNEL = cuda_lib.CudaKernel(
    "ngram_score", "adaparse_ngram_bleu", [P, P, P, P, I, I, I, P, I, P])


def _check(ref, hyp, ref_len, hyp_len, max_n: int) -> None:
    if ref.dim() != 2 or ref.shape != hyp.shape:
        raise ValueError(f"ngram_bleu needs matching (B, max_len) ref/hyp "
                         f"batches (got {tuple(ref.shape)} vs "
                         f"{tuple(hyp.shape)})")
    b = ref.shape[0]
    if ref_len.shape != (b,) or hyp_len.shape != (b,):
        raise ValueError(f"ngram_bleu: lengths must be ({b},)")
    if len({t.device for t in (ref, hyp, ref_len, hyp_len)}) != 1:
        raise ValueError("ngram_bleu: all inputs must share one device")
    if not 1 <= max_n <= MAX_N:
        raise ValueError(f"ngram_bleu: max_n {max_n} outside [1, {MAX_N}]")
    if ref.device.type == "cuda":
        for t in (ref, hyp, ref_len, hyp_len):
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise ValueError("ngram_bleu: the kernel takes contiguous "
                                 "int32 tensors")
        if ref.shape[1] > MAX_LEN:
            raise ValueError(f"ngram_bleu: max_len {ref.shape[1]} > "
                             f"{MAX_LEN} (shared memory)")
    elif ref.device.type not in ("cpu", "meta"):
        raise ValueError(f"ngram_bleu: unsupported device {ref.device}")


def launch_grid(b: int, max_len: int) -> list[tuple[int, int]]:
    """(blocks, threads) of the kernel one default launch runs."""
    return [(b, DEFAULT_THREADS)]


def _launch(ref, hyp, ref_len, hyp_len, out, *, max_n: int,
            threads: int = DEFAULT_THREADS) -> None:
    """One kernel launch into a preallocated (B,) float32 ``out`` at
    ``threads`` a block; no synchronisation."""
    b, max_len = ref.shape
    KERNEL(ref.data_ptr(), hyp.data_ptr(), ref_len.data_ptr(),
           hyp_len.data_ptr(), b, max_len, max_n, out.data_ptr(),
           int(threads), cuda_lib.stream_of(ref.device))


def ngram_bleu(ref, hyp, ref_len, hyp_len, *, max_n: int = 4,
               threads: int | None = None):
    """ref, hyp (B, max_len) padded int ids; ref_len, hyp_len (B,) true
    lengths in [0, max_len]. Returns (B,) per-document BLEU: float32
    from the kernel on CUDA tensors (``threads`` a block; None: the
    tuned winner for the shape, else the default), float64 from the
    plain version on CPU tensors."""
    refuse_dtensor("ngram_bleu", ref, hyp, ref_len, hyp_len)
    _check(ref, hyp, ref_len, hyp_len, max_n)
    if ref.device.type == "cpu":
        return ngram_bleu_ref(ref, hyp, ref_len, hyp_len, max_n=max_n)
    b = ref.shape[0]
    if ref.is_meta:
        out = meta_lib.empty((b,), torch.float32, ref)
        # the bound's operations: every hypothesis start against every
        # reference start and every later hypothesis start, at full
        # length; two int32 rows and the lengths read, the scores written
        n = ref.shape[1]
        meta_lib.charge(KERNEL.name, b * (n * n + n * (n - 1) // 2),
                        2 * 4 * b * n + 8 * b + 4 * b, ref.dtype)
        return out
    out = torch.empty((b,), dtype=torch.float32, device=ref.device)
    if b:
        if threads is None:
            threads = tuned_threads(b, ref.shape[1], max_n,
                                    device=ref.device)
        _launch(ref, hyp, ref_len, hyp_len, out, max_n=max_n,
                threads=threads)
    return out
