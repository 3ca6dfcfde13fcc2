"""The port's CLS-III encoder and route step against the JAX package on
the reduced ``router-tiny`` config (2 layers, d=32, float32).

The JAX encoder's params (``init_encoder``, stacked per-layer leaves as
numpy) are carried across with ``encoder_from_jax_params``, so both
packages compute the same function. Tolerance 2e-5 on the float32
outputs: the two frameworks sum the matmuls in another order (the
JAX package's own f32 bar). Selections may differ only for documents
whose improvement lies within 1e-5 of tau.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import unwrap
from repro.configs import get_config as j_get_config
from repro.core.router import make_route_step as j_make_route_step
from repro.models import encoder as jenc
from repro_torch.configs import get_config
from repro_torch.core import scheduler
from repro_torch.core.router import CLS1_OVERRIDE, make_route_step
from repro_torch.kernels.budget_route.ops import (POSITIVE_TAU,
                                                  capacity_floor)
from repro_torch.models import encoder as tenc
from repro_torch.models.layers import embed_lookup


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_get_config("adaparse-router").reduced().model
    tcfg = get_config("adaparse-router").reduced().model
    assert repr(jcfg) == repr(tcfg)
    raw = jax.tree_util.tree_map(np.asarray,
                                 unwrap(jenc.init_encoder(jcfg, 0)))
    return jcfg, tcfg, raw, tenc.encoder_from_jax_params(raw, tcfg, "cpu")


def _inputs(cfg, b, seed):
    rng = np.random.RandomState(seed)
    s = cfg.max_len
    toks = rng.randint(2, 8000, (b, s)).astype(np.int32)
    lens = rng.randint(1, s + 1, b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.float32)
    toks[:, 0] = 1
    return toks, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_encoder_heads_match_jax(tiny, seed):
    jcfg, tcfg, raw, enc = tiny
    toks, mask = _inputs(tcfg, 12, seed)
    with torch.no_grad():
        acc = enc.predict_accuracies(torch.from_numpy(toks),
                                     torch.from_numpy(mask)).numpy()
        pref = enc.preference_score(torch.from_numpy(toks),
                                    torch.from_numpy(mask)).numpy()
    j_acc = np.asarray(jenc.predict_accuracies(raw, jcfg, toks, mask))
    j_pref = np.asarray(jenc.preference_score(raw, jcfg, toks, mask))
    assert acc.shape == (12, tcfg.n_outputs) and acc.dtype == np.float32
    np.testing.assert_allclose(acc, j_acc, atol=2e-5)
    np.testing.assert_allclose(pref, j_pref, atol=2e-5)
    targets = np.random.RandomState(seed).rand(12, tcfg.n_outputs)
    tmask = (targets > 0.3).astype(np.float32)
    batch = {"tokens": toks, "mask": mask, "targets": targets,
             "target_mask": tmask}
    with torch.no_grad():
        loss = enc.regression_loss(
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    np.testing.assert_allclose(
        float(loss), float(jenc.regression_loss(raw, jcfg, batch)),
        atol=2e-5)


def test_init_encoder_layout_and_seed(tiny):
    cfg = get_config("adaparse-router").reduced().model
    a = tenc.init_encoder(cfg, torch.Generator().manual_seed(3), "cpu")
    b = tenc.init_encoder(cfg, torch.Generator().manual_seed(3), "cpu")
    c = tenc.init_encoder(cfg, torch.Generator().manual_seed(4), "cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["p.tok_embed"], sc["p.tok_embed"])
    d, h = cfg.d_model, cfg.n_heads
    assert sa["layers.0.p.wq"].shape == (d, h, d // h)
    assert sa["layers.1.p.wo"].shape == (h, d // h, d)
    assert all(v.dtype == torch.float32 for v in sa.values())
    full = get_config("adaparse-router").model
    assert full.param_dtype == "bfloat16" and full.n_layers == 12
    raw = tiny[2]
    assert sum(v.numel() for v in sa.values()) == sum(
        np.size(x) for x in jax.tree_util.tree_leaves(raw))


def test_embed_lookup_follows_jnp_take():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([[0, 3, -1, 4]])
    got = embed_lookup(table, ids).numpy()
    want = np.asarray(jnp.take(jnp.asarray(table.numpy()),
                               jnp.asarray(ids.numpy()), axis=0))
    np.testing.assert_array_equal(got, want)        # NaN row included


def _tau(imp, alpha):
    cap = capacity_floor(alpha, len(imp))
    return max(float(np.sort(imp)[::-1][cap - 1]), POSITIVE_TAU)


@pytest.mark.parametrize("alpha", [0.1, 0.25])
def test_route_step_matches_jax_and_host_plan(tiny, alpha):
    """Same params, tokens and CLS-I logits: the port's route step
    selects the JAX step's set (flips only within 1e-5 of tau), its
    selection equals the host plan on its own scores, and CLS-I invalid
    docs carry the override score."""
    jcfg, tcfg, raw, enc = tiny
    b = 40
    toks, mask = _inputs(tcfg, b, 7)
    valid = np.random.RandomState(8).randn(b).astype(np.float32)
    out = make_route_step(alpha)(enc, torch.from_numpy(toks),
                                 torch.from_numpy(mask),
                                 torch.from_numpy(valid))
    j_out = jax.jit(j_make_route_step(jcfg, alpha))(
        raw, jnp.asarray(toks), jnp.asarray(mask), jnp.asarray(valid))
    imp = out["improvement"].numpy()
    j_imp = np.asarray(j_out["improvement"])
    np.testing.assert_allclose(imp, j_imp, atol=2e-5)
    idx = out["selected_idx"].numpy()
    sel = set(idx[idx >= 0].tolist())
    j_idx = np.asarray(j_out["selected_idx"])
    j_sel = set(j_idx[j_idx >= 0].tolist())
    tau = _tau(j_imp, alpha)
    flips = sorted(sel ^ j_sel)
    assert all(abs(j_imp[i] - tau) <= 1e-5 for i in flips), flips
    host = scheduler.plan_batch(imp, alpha)
    assert sel == set(host.expensive_idx.tolist())
    assert set(np.nonzero(out["selected_mask"].numpy())[0].tolist()) == sel
    assert (imp[valid < 0] == CLS1_OVERRIDE).all()
    assert int(out["count"]) == len(sel)
    np.testing.assert_array_equal(
        out["routed_tokens"].numpy()[:len(sel)], toks[idx[:len(sel)]])
