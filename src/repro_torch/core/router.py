"""Hierarchical parser-selection router (Fig. 2): CLS I -> II -> III.

- CLS I : logistic regression on CLS-I fast features -> extracted-text
  validity. Invalid -> straight to the high-quality parser.
- CLS II: logistic regression on document metadata -> "would another
  parser significantly improve quality?". No -> accept extraction.
- CLS III: the SciBERT-class encoder regresses per-parser accuracy from
  first-page text; argmax-improvement parser wins (subject to the α
  budget, enforced by the scheduler).

Two production variants (§5.1):
- AdaParse (FT) : CLS I+II only (fast features + metadata, fastText-like
  linear models); improvement-likely -> Nougat directly.
- AdaParse (LLM): CLS I gate, then CLS III LLM inference (DPO-aligned).

``make_route_step`` builds the fused device step (encoder forward +
budget select-and-compact) that the LLM-variant engine routes with.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import EncoderConfig
from repro_torch.distributed.meshrules import is_dtensor, like_local
from repro_torch.kernels.budget_route import budget_route
from repro_torch.models.encoder import Encoder

# ---------------------------------------------------------------------------
# Linear stages (CLS I / II)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LinearStage:
    """Logistic regression trained with plain full-batch Newton/GD steps —
    small enough to fit anywhere, interpretable (§5.1)."""

    w: np.ndarray
    b: float

    @classmethod
    def fit(cls, x: np.ndarray, y: np.ndarray, steps: int = 300,
            lr: float = 0.5, l2: float = 1e-4) -> "LinearStage":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        w = np.zeros(x.shape[1])
        b = 0.0
        for _ in range(steps):
            z = x @ w + b
            p = 1.0 / (1.0 + np.exp(-z))
            g = p - y
            w -= lr * (x.T @ g / len(y) + l2 * w)
            b -= lr * float(g.mean())
        return cls(w, b)

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-(np.asarray(x) @ self.w + self.b)))


# ---------------------------------------------------------------------------
# Full router
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdaParseRouter:
    variant: str                          # "ft" | "llm"
    cls1: LinearStage                     # validity from fast features
    cls2: LinearStage | None              # improvement-likely from metadata
    enc_cfg: EncoderConfig | None = None  # CLS III model config
    encoder: Encoder | None = None        # CLS III model (on its device)
    valid_threshold: float = 0.5
    improve_threshold: float = 0.5
    cheap_idx: int = 0                    # index of pymupdf in regression out
    expensive_idx: int = 2                # index of nougat

    def predict_improvement(self, fast_feats: np.ndarray,
                            meta_feats: np.ndarray,
                            tokens: torch.Tensor | None,
                            mask: torch.Tensor | None) -> np.ndarray:
        """Per-doc predicted accuracy improvement of expensive over cheap.

        Invalid extraction (CLS I) forces +inf improvement (must re-parse).
        FT variant: improvement = CLS-II probability (- threshold).
        LLM variant: encoder per-parser accuracy regression difference.
        """
        valid = self.cls1.predict_proba(fast_feats) >= self.valid_threshold
        if self.variant == "ft":
            p_imp = self.cls2.predict_proba(meta_feats)
            imp = p_imp - self.improve_threshold
        else:
            pred = self.predict_all_accuracies(tokens, mask)
            imp = pred[:, self.expensive_idx] - pred[:, self.cheap_idx]
        imp = np.where(valid, imp, np.inf)
        return imp

    def predict_all_accuracies(self, tokens, mask) -> np.ndarray:
        if self.variant != "llm":
            raise ValueError("per-parser accuracies need the llm variant")
        dev = self.encoder.device
        with torch.inference_mode():
            return self.encoder.predict_accuracies(
                torch.as_tensor(tokens, device=dev),
                torch.as_tensor(mask, device=dev)).cpu().numpy()


# ---------------------------------------------------------------------------
# Fused device route step
# ---------------------------------------------------------------------------


# CLS-I invalid docs must be re-parsed: their improvement is overridden
# with this large finite score (the host mirror maps +inf to the same
# value via np.nan_to_num(..., posinf=CLS1_OVERRIDE)).
CLS1_OVERRIDE = 1e3


def make_route_step(alpha: float, cheap_idx: int = 0,
                    expensive_idx: int = 2):
    """Returns route_step(encoder, tokens, mask, fast_valid_logit):

    encoder fwd (B, S) -> per-parser accuracies (B, m) -> improvement
    scores -> α-budget threshold + fused select-and-compact
    (``kernels.budget_route``) -> dispatch indices + compacted token batch
    for the expensive parser, all on the encoder's device with no host
    round-trip between scoring and selection.

    ``selected_idx`` is (⌊α·B⌋,) int32 source rows, -1-filled past
    ``count``; ``routed_tokens`` is the compacted (⌊α·B⌋, S) gather.
    It runs under ``no_grad`` (DTensors have no inference tensors).
    """

    @torch.no_grad()
    def route_step(encoder: Encoder, tokens, mask, valid_logit):
        b = tokens.shape[0]
        pred = encoder.predict_accuracies(tokens, mask)               # (B, m)
        imp = pred[:, expensive_idx] - pred[:, cheap_idx]
        imp = torch.where(valid_logit < 0,
                          torch.full_like(imp, CLS1_OVERRIDE), imp)
        routed_tokens, sel_idx, count = budget_route(
            imp.contiguous(), tokens, alpha)
        # scatter the compacted indices back to a (B,) mask (-1 ->
        # dropped); on a mesh every rank holds the whole plan
        idx = sel_idx.to_local() if is_dtensor(sel_idx) else sel_idx
        sel_mask = torch.zeros((b + 1,), dtype=torch.bool,
                               device=tokens.device)
        sel_mask[torch.where(idx >= 0, idx, b).long()] = True
        return {
            "pred_acc": pred,
            "improvement": imp,
            "selected_mask": like_local(sel_mask[:b], sel_idx, (b,)),
            "selected_idx": sel_idx,
            "routed_tokens": routed_tokens,
            "count": count,
        }

    return route_step


# ---------------------------------------------------------------------------
# Training data assembly for the router stack
# ---------------------------------------------------------------------------


def make_cls1_labels(bleus_cheap: np.ndarray, thr: float = 0.15) -> np.ndarray:
    """Validity label: extraction yielded non-garbage text."""
    return (bleus_cheap > thr).astype(np.float64)


def make_cls2_labels(bleu_matrix: np.ndarray, cheap_idx: int,
                     margin: float = 0.02) -> np.ndarray:
    """'Another parser improves significantly' label from the accuracy
    matrix (n, m)."""
    best_other = np.delete(bleu_matrix, cheap_idx, axis=1).max(axis=1)
    return (best_other > bleu_matrix[:, cheap_idx] + margin).astype(np.float64)
