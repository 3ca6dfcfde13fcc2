"""Three-stage DPO post-training (Appendix A), the port of
``repro.core.dpo``.

Stage 1 (SFT): minimize L_REG = E ||pi_theta(x^1) - y||^2 — the encoder
regresses the m per-parser accuracies from the default parser's first-page
text.

Stage 2 (DPO): the encoder is reused inside a scorer g_phi (encoder +
positive scalar head) with a frozen reference copy g_ref; minimize

  L_DPO = -E log sigma( beta * [ log g(x+) - log g_ref(x+)
                               - log g(x-) + log g_ref(x-) ] )

over preference pairs (x+, x-) of parser outputs for the same page.

Stage 3: re-fit the regression head at a lowered learning rate on D.

The trainers take the port's ``Encoder`` (whose ``cfg`` stands in for
the reference's ``cfg`` argument), train it in place on its device with
the ``repro_torch.optim`` stack, and return it in ``FitResult``. Each
step updates every parameter, those the loss does not reach included
(their grad is zero, as ``jax.grad`` gives it: they still decay). The
minibatches are the reference's: ``np.random.RandomState(seed)``
permutations.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.encoder import Encoder
from repro_torch.optim import adamw, apply_updates, chain_clip

# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def dpo_loss(enc: Encoder, ref: Encoder, batch: dict,
             beta: float = 1.0) -> torch.Tensor:
    """batch: tok_pos/mask_pos and tok_neg/mask_neg (B, S). The frozen
    reference ``ref`` runs without grad."""
    g_pos = enc.preference_score(batch["tok_pos"], batch["mask_pos"])
    g_neg = enc.preference_score(batch["tok_neg"], batch["mask_neg"])
    with torch.no_grad():
        r_pos = ref.preference_score(batch["tok_pos"], batch["mask_pos"])
        r_neg = ref.preference_score(batch["tok_neg"], batch["mask_neg"])
    logits = beta * (torch.log(g_pos) - torch.log(r_pos)
                     - torch.log(g_neg) + torch.log(r_neg))
    return -torch.mean(F.logsigmoid(logits))


@torch.no_grad()
def pref_accuracy(enc: Encoder, batch: dict) -> torch.Tensor:
    g_pos = enc.preference_score(batch["tok_pos"], batch["mask_pos"])
    g_neg = enc.preference_score(batch["tok_neg"], batch["mask_neg"])
    return torch.mean((g_pos > g_neg).float())


# ---------------------------------------------------------------------------
# Trainers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FitResult:
    encoder: Encoder
    losses: list[float]


def _batches(n, bs, rng):
    idx = rng.permutation(n)
    for i in range(0, n - bs + 1, bs):
        yield idx[i:i + bs]


def _fit(enc: Encoder, data: dict, n_key: str, loss_fn, opt, steps: int,
         bs: int, seed: int) -> FitResult:
    """The reference's step loop: ``data`` goes to the encoder's device
    once and each minibatch is indexed there; ``float(loss)`` each step
    synchronises with the device, as the reference's does."""
    dev = enc.device
    data = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    params = list(enc.parameters())
    state = opt.init(params)
    rng = np.random.RandomState(seed)
    n = data[n_key].shape[0]
    losses = []
    it = 0
    enc.requires_grad_(True)
    try:
        while it < steps:
            for bidx in _batches(n, min(bs, n), rng):
                if it >= steps:
                    break
                idx = torch.from_numpy(bidx).to(dev)
                batch = {k: v.index_select(0, idx) for k, v in data.items()}
                loss = loss_fn(batch)
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                updates, state = opt.update(list(grads), state, params, it)
                apply_updates(params, updates)
                losses.append(float(loss.detach()))
                it += 1
    finally:
        enc.requires_grad_(False)
    return FitResult(enc, losses)


def fit_regression(enc: Encoder, data: dict, steps: int = 200,
                   lr: float = 1e-3, bs: int = 16,
                   seed: int = 0) -> FitResult:
    """Stage 1 / Stage 3. data: tokens (N,S), mask (N,S), targets (N,m),
    optional target_mask."""
    opt = chain_clip(adamw(lr, weight_decay=0.01), 1.0)
    return _fit(enc, data, "tokens", enc.regression_loss, opt, steps, bs,
                seed)


def fit_dpo(enc: Encoder, pref_data: dict, steps: int = 100,
            lr: float = 5e-4, bs: int = 8, beta: float = 1.0,
            seed: int = 0) -> FitResult:
    """Stage 2. pref_data: tok_pos/mask_pos/tok_neg/mask_neg (M, S)."""
    ref = copy.deepcopy(enc)                                # frozen copy
    opt = chain_clip(adamw(lr, weight_decay=0.0), 1.0)
    return _fit(enc, pref_data, "tok_pos",
                lambda batch: dpo_loss(enc, ref, batch, beta), opt, steps,
                bs, seed)


def three_stage_posttrain(enc: Encoder, reg_data: dict, pref_data: dict, *,
                          sft_steps=200, dpo_steps=100, refit_steps=60,
                          lr=1e-3, seed=0):
    """The full Appendix-A recipe, a fresh optimizer state and step count
    per stage. Returns (encoder, diagnostics)."""
    r1 = fit_regression(enc, reg_data, steps=sft_steps, lr=lr, seed=seed)
    r2 = fit_dpo(r1.encoder, pref_data, steps=dpo_steps, lr=lr / 2,
                 seed=seed)
    r3 = fit_regression(r2.encoder, reg_data, steps=refit_steps,
                        lr=lr / 10, seed=seed)
    return r3.encoder, {
        "sft_loss": r1.losses, "dpo_loss": r2.losses,
        "refit_loss": r3.losses,
    }


@torch.no_grad()
def regression_r2(enc: Encoder, data: dict) -> np.ndarray:
    """Per-parser R^2 of the accuracy regression (paper: 40.0% / 46.5%)."""
    dev = enc.device
    pred = enc.predict_accuracies(
        torch.as_tensor(data["tokens"], device=dev),
        torch.as_tensor(data["mask"], device=dev)).cpu().numpy()
    y = np.asarray(torch.as_tensor(data["targets"]).cpu())
    ss_res = np.sum((pred - y) ** 2, axis=0)
    ss_tot = np.sum((y - y.mean(axis=0)) ** 2, axis=0) + 1e-12
    return 1.0 - ss_res / ss_tot
