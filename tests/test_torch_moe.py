"""The port's mixture-of-experts LMs (``repro_torch.models.moe`` and the
MoE branch of ``models/transformer.py``) and ``phi3-medium-14b`` against
the JAX package on the CPU.

- ``moe_ffn``'s two routers on (T, D) tokens drawn with numpy: fed the
  same probabilities, the routing integers (top-k ``eids``, the dispatch
  ``order``, ``slot``, ``keep``; the budget router's ``tok``) are equal,
  with capacity factors that drop tokens and duplicated tokens that tie;
  ``y`` and ``aux`` within 2e-5 in float32 and 2e-2 in bfloat16. The
  combines reproduce XLA's bfloat16 scatter-add bit for bit.
- ``olmoe-tiny`` (top-2 of 4, qk-norm), ``grok-tiny`` (top-2 of 4, GQA,
  logit soft cap) and ``phi3-tiny`` (dense GQA), the JAX params carried
  across with ``lm_from_jax_params``: ``lm_logits`` with its aux,
  ``prefill``, ``decode_step``, ``lm_loss`` and every gradient within
  2e-5; 5 ``lm_train_step``s and a resume from JAX's step-3 optimizer
  state against ``_lm_train_cell`` (AdamW for OLMoE, Adafactor for grok,
  each config's own optimizer); the train CLI's restart bit-exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.common import unwrap
from repro.configs import get_config as j_get_config
from repro.launch import specs as JS
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.attention import KVCache as JKVCache
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.launch import specs as TS
from repro_torch.launch import train
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import from_numpy

ARCHS = ["olmoe-1b-7b", "grok-1-314b", "phi3-medium-14b"]
MOE_ARCHS = ARCHS[:2]
B, S = 2, 24
T, D, FE = 48, 32, 16
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32, 2e-5),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16,
                       2e-2)}


# -- moe_ffn ---------------------------------------------------------------

def _moe_case(cfg: MoEConfig, dtype: str, seed: int = 0, dup: bool = False):
    """Tokens (T, D) and expert params drawn with numpy (with ``dup``,
    every fourth token repeats its predecessor, so probs tie), and the
    JAX router's float32 probs for them."""
    rng = np.random.RandomState(seed)
    E = cfg.n_experts
    xt = rng.randn(T, D).astype(np.float32)
    if dup:
        xt[3::4] = xt[2::4][:len(xt[3::4])]
    np_dt = DTYPES[dtype][0]
    xt = xt.astype(np_dt)
    p = {"router": rng.randn(D, E) / np.sqrt(D),
         "w_gate": rng.randn(E, D, FE) / np.sqrt(D),
         "w_up": rng.randn(E, D, FE) / np.sqrt(D),
         "w_down": rng.randn(E, FE, D) / np.sqrt(FE)}
    p = {k: v.astype(np_dt) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    logits = jnp.einsum("td,de->te", jnp.asarray(xt).astype(jnp.float32),
                        jp["router"].astype(jnp.float32))
    probs = np.array(jax.nn.softmax(logits, axis=-1))
    tp = {k: from_numpy(v) for k, v in p.items()}
    return xt, p, jp, tp, probs


def _jax_topk_ints(probs, cfg: MoEConfig):
    """The reference ``_topk_route``'s routing integers, by its lines."""
    t, E = probs.shape
    k = cfg.top_k
    cap = max(-(-int(cfg.capacity_factor * t * k) // E), 1)
    _, eids = jax.lax.top_k(jnp.asarray(probs), k)
    flat_e = eids.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se, st = flat_e[order], jnp.repeat(jnp.arange(t), k)[order]
    counts = jnp.bincount(flat_e, length=E)
    pos = jnp.arange(t * k) - (jnp.cumsum(counts) - counts)[se]
    keep = pos < cap
    return {"eids": eids, "order": order, "st": st,
            "slot": jnp.where(keep, pos, cap), "keep": keep}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cf", [1.25, 1.0, 0.5])
def test_topk_route_matches_jax(cf, dtype):
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=FE,
                    capacity_factor=cf)
    xt, _, jp, tp, probs = _moe_case(cfg, dtype, seed=int(cf * 8))
    got = TM.topk_dispatch(torch.from_numpy(probs), cfg)
    want = _jax_topk_ints(probs, cfg)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)
    if cf < 1.0:
        assert not got["keep"].all()           # overflow drops occur
    tol = DTYPES[dtype][3]
    jy, jaux = JM._topk_route(jnp.asarray(xt), jnp.asarray(probs), jp, cfg)
    ty, taux = TM._topk_route(from_numpy(xt), torch.from_numpy(probs), tp,
                              cfg)
    assert ty.dtype == DTYPES[dtype][1] and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy).astype(np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(float(taux), float(jaux), atol=2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("alpha", [0.2, 0.125])
def test_budget_route_matches_jax_with_ties(alpha, dtype):
    cfg = MoEConfig(n_experts=4, top_k=2, d_ff_expert=FE, router="budget",
                    budget_alpha=alpha)
    xt, _, jp, tp, probs = _moe_case(cfg, dtype, seed=3, dup=True)
    assert (probs[3] == probs[2]).all()        # duplicated tokens tie
    g, tok = TM.budget_select(torch.from_numpy(probs), cfg)
    jg, jtok = jax.lax.top_k(jnp.asarray(probs).T,
                             max(int(alpha * T), 1))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    tol = DTYPES[dtype][3]
    jy, jaux = JM._budget_route(jnp.asarray(xt), jnp.asarray(probs), jp,
                                cfg)
    ty, taux = TM._budget_route(from_numpy(xt), torch.from_numpy(probs),
                                tp, cfg)
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy).astype(np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(float(taux), float(jaux), atol=2e-5)


@pytest.mark.parametrize("router", ["topk", "budget"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_ffn_matches_jax(router, dtype):
    """The whole layer, router included, on (B, S, D) input."""
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=FE, router=router,
                    budget_alpha=0.2)
    xt, _, jp, tp, _ = _moe_case(cfg, dtype, seed=5)
    x = xt.reshape(2, T // 2, D)
    jy, jaux = JM.moe_ffn(jnp.asarray(x), jp, cfg)
    ty, taux = TM.moe_ffn(from_numpy(x), tp, cfg)
    tol = DTYPES[dtype][3]
    assert ty.shape == (2, T // 2, D)
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy).astype(np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(float(taux), float(jaux), atol=2e-5)


def _bf16_bits(a):
    return np.asarray(a).view(np.uint16)


def test_combines_reproduce_xla_bf16_scatter_add_bit_for_bit():
    """Contributions spanning four decades, so that the order of the
    bfloat16 adds shows in the bits."""
    rng = np.random.RandomState(11)
    cfg = MoEConfig(n_experts=8, top_k=4, d_ff_expert=FE,
                    capacity_factor=0.75)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(rng.randn(T, 8)), -1))
    st = _jax_topk_ints(probs, cfg)["st"]
    contrib = (rng.randn(T * 4, D) * 10.0 ** rng.uniform(
        -2, 2, (T * 4, 1))).astype(ml_dtypes.bfloat16)
    want = jnp.zeros((T, D), jnp.bfloat16).at[st].add(jnp.asarray(contrib))
    got = TM.combine_topk(from_numpy(contrib), from_numpy(st), T, 4)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), _bf16_bits(want))
    assert not np.array_equal(_bf16_bits(want), _bf16_bits(
        np.asarray(contrib, np.float32).reshape(-1, D)[np.argsort(
            np.asarray(st), kind="stable")].reshape(T, 4, D).sum(1)
        .astype(ml_dtypes.bfloat16)))          # the order matters

    _, tok = jax.lax.top_k(jnp.asarray(probs).T, 12)
    upd = (rng.randn(8, 12, D) * 10.0 ** rng.uniform(
        -2, 2, (8, 12, 1))).astype(ml_dtypes.bfloat16)
    want = jnp.zeros((T, D), jnp.bfloat16).at[tok.reshape(-1)].add(
        jnp.asarray(upd).reshape(-1, D))
    got = TM.combine_budget(from_numpy(upd), from_numpy(tok), T)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), _bf16_bits(want))


def test_moe_gradients_match_jax():
    """d(sum of y * w + aux) w.r.t. the tokens and every expert leaf,
    the gates' gradient included, within 2e-5."""
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=FE,
                    capacity_factor=1.0)
    xt, p, _, _, _ = _moe_case(cfg, "float32", seed=9)
    w = np.random.RandomState(10).randn(2, T // 2, D).astype(np.float32)
    x = xt.reshape(2, T // 2, D)

    def jloss(x, p):
        y, aux = JM.moe_ffn(x, p, cfg)
        return jnp.sum(y * w) + aux

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                         {k: jnp.asarray(v)
                                          for k, v in p.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    y, aux = TM.moe_ffn(tx, tp, cfg)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]),
                               atol=2e-5)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[1][k]),
                                   atol=2e-5, err_msg=k)


def test_routing_trace_records_each_call():
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=FE,
                    capacity_factor=0.5)
    xt, _, _, tp, _ = _moe_case(cfg, "float32")
    x = from_numpy(xt).reshape(1, T, D)
    with TM.routing_trace() as tr:
        TM.moe_ffn(x, tp, cfg)
        TM.moe_ffn(x, tp, dataclasses.replace(cfg, router="budget"))
    assert TM._TRACE is None and len(tr) == 2
    probs = TM.router_probs(from_numpy(xt), tp["router"], cfg)
    r = TM.topk_dispatch(probs, cfg)
    assert torch.equal(tr[0]["eids"], r["eids"])
    assert int(tr[0]["keep"].sum()) == int(r["keep"].sum()) < T * 2
    assert tr[1]["tok"].shape == (8, int(0.125 * T))


# -- the LMs -----------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    jcfg = j_get_config(request.param).reduced().model
    tcfg = get_config(request.param).reduced().model
    assert repr(jcfg) == repr(tcfg)
    raw = jax.tree_util.tree_map(np.asarray, unwrap(JT.init_lm(jcfg, 0)))
    toks = np.random.RandomState(1).randint(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, raw, TT.lm_from_jax_params(raw, tcfg, "cpu"), toks


def _impl(cfg, impl):
    return dataclasses.replace(cfg, attention_impl=impl, q_chunk=8,
                               kv_chunk=8)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_lm_logits_and_aux_match_jax(lm, impl):
    jcfg, tcfg, raw, params, toks = lm
    want, jaux = JT.lm_logits(raw, _impl(jcfg, impl), jnp.asarray(toks))
    got, aux = TT.lm_logits(params, _impl(tcfg, impl),
                            torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), atol=2e-5)
    assert (float(aux) > 0) == (tcfg.moe is not None)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_prefill_and_decode_match_jax(lm, impl):
    jcfg, tcfg, raw, params, toks = lm
    jc, tc = _impl(jcfg, impl), _impl(tcfg, impl)
    j_logits, jc_ = JT.prefill(raw, jc, jnp.asarray(toks[:, :-1]))
    t_logits, tc_ = TT.prefill(params, tc, torch.from_numpy(toks[:, :-1]))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=2e-5)
    np.testing.assert_allclose(tc_.k.numpy(), np.asarray(jc_.k), atol=2e-5)
    pad = ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))
    jcache = JKVCache(jnp.pad(jc_.k, pad), jnp.pad(jc_.v, pad))
    tcache = KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 1))
                       for t in (tc_.k, tc_.v)))
    for pos in (S - 1,):
        jl, jcache = JT.decode_step(raw, jc, jnp.asarray(toks[:, -1:]),
                                    jcache, jnp.asarray(pos))
        tl, tcache = TT.decode_step(params, tc,
                                    torch.from_numpy(toks[:, -1:]),
                                    tcache, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)
        np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                                   atol=2e-5)


@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_and_gradients_match_jax(lm, remat):
    """Every leaf's gradient, the experts' and the router's included."""
    jcfg, tcfg, raw, _, toks = lm
    jcfg = dataclasses.replace(jcfg, remat=remat)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    labels = np.roll(toks, -1, axis=1)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jl, jm), jg = jax.value_and_grad(
        lambda q: JT.lm_loss(q, jcfg, jbatch), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, raw))
    params = TT.lm_from_jax_params(raw, tcfg, "cpu")
    leaves = TS.lm_param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tl, tm = TT.lm_loss(params, tcfg, {"tokens": torch.from_numpy(toks),
                                       "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=2e-5)
    np.testing.assert_allclose(float(tm["aux"].detach()), float(jm["aux"]),
                               atol=2e-5)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for j, t in zip(jleaves, grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5)


def test_remat_recompute_routes_as_the_first_pass(lm):
    """With and without remat the gradients are equal bit for bit: the
    recomputed forward routes and sums exactly as the first."""
    _, tcfg, raw, _, toks = lm
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = TT.lm_from_jax_params(raw, cfg, "cpu")
        leaves = TS.lm_param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = TT.lm_loss(params, cfg, {
            "tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(np.roll(toks, -1, axis=1))})
        out.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_param_leaves_follow_jax_tree_order(lm):
    jcfg, tcfg, raw, params, _ = lm
    jleaves = jax.tree_util.tree_leaves(raw)
    tleaves = TS.lm_param_leaves(params)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_array_equal(t.numpy(), j)
    if tcfg.moe is not None:
        names = sorted(params["layers"])
        assert names[names.index("ln_ffn") + 1] == "moe"
        assert sorted(params["layers"]["moe"]) == ["router", "w_down",
                                                   "w_gate", "w_up"]


def test_lm_from_jax_params_checks_the_expert_leaves():
    tcfg = get_config("olmoe-1b-7b").reduced().model
    raw = jax.tree_util.tree_map(np.asarray, unwrap(JT.init_lm(
        j_get_config("olmoe-1b-7b").reduced().model, 0)))
    moe = raw["layers"]["moe"]
    for bad, match in (
            (dict(moe, w_up=moe["w_up"][:, :-1]), "w_up"),
            ({k: v for k, v in moe.items() if k != "router"}, "keys"),
            (dict(moe, extra=moe["router"]), "keys")):
        with pytest.raises(ValueError, match=match):
            TT.lm_from_jax_params(
                dict(raw, layers=dict(raw["layers"], moe=bad)), tcfg, "cpu")
    dense = {k: v for k, v in raw["layers"].items() if k != "moe"}
    with pytest.raises(ValueError, match="keys"):
        TT.lm_from_jax_params(dict(raw, layers=dense), tcfg, "cpu")


def test_registered_configs_and_param_counts_equal_the_reference():
    for arch in ARCHS:
        a, j = get_config(arch), j_get_config(arch)
        assert repr(a.model) == repr(j.model)
        assert repr(a.reduced().model) == repr(j.reduced().model)
        assert a.model.n_params() == j.model.n_params()
        assert a.model.n_active_params() == j.model.n_active_params()
        assert a.skips == j.skips and a.source == j.source
    olmoe = get_config("olmoe-1b-7b").model
    assert olmoe.n_params() == 6_919_100_416
    assert olmoe.n_active_params() == 1_281_951_744
    assert get_config("phi3-medium-14b").model.n_params() == 14_659_507_200


def test_init_lm_draws_the_experts_on_the_params_device():
    cfg = get_config("olmoe-1b-7b").reduced().model
    a = TT.init_lm(cfg, torch.Generator().manual_seed(3), "cpu")
    b = TT.init_lm(cfg, torch.Generator().manual_seed(3), "cpu")
    moe = a["layers"]["moe"]
    E, Fe, d, L = 4, 32, 64, 2
    assert {k: tuple(v.shape) for k, v in moe.items()} == {
        "router": (L, d, E), "w_gate": (L, E, d, Fe),
        "w_up": (L, E, d, Fe), "w_down": (L, E, Fe, d)}
    assert "w_gate" not in a["layers"]
    for x, y in zip(TS.lm_param_leaves(a), TS.lm_param_leaves(b)):
        assert torch.equal(x, y)
    assert sum(p.numel() for p in TS.lm_param_leaves(a)) == cfg.n_params()
    np.testing.assert_allclose(float(moe["w_down"].std()), Fe ** -0.5,
                               rtol=0.1)


def _tiny_lm(**kw):
    base = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab_size=256, param_dtype="float32",
                compute_dtype="float32", q_chunk=8, kv_chunk=8)
    base.update(kw)
    return LMConfig(**base)


def test_moe_topk_capacity_and_aux():
    """The port of ``tests/test_models.py::test_moe_topk_capacity_and_aux``."""
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=16,
                    capacity_factor=1.0)
    lm_cfg = _tiny_lm(n_kv_heads=4, moe=cfg)
    p = TT.init_lm(lm_cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                         .manual_seed(4))
    logits, aux = TT.lm_logits(p, lm_cfg, toks)
    assert torch.isfinite(logits).all()
    assert float(aux) > 0                      # load-balance loss active


def test_moe_budget_router_runs():
    """The port of ``tests/test_models.py::test_moe_budget_router_runs``."""
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, router="budget",
                    budget_alpha=0.2)
    lm_cfg = _tiny_lm(n_kv_heads=4, moe=cfg)
    p = TT.init_lm(lm_cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                         .manual_seed(5))
    logits, _ = TT.lm_logits(p, lm_cfg, toks)
    assert torch.isfinite(logits).all()


# -- training ----------------------------------------------------------------

STEPS = 6


def _train_cfgs(arch_id):
    chunks = dict(q_chunk=16, kv_chunk=32)
    jarch = j_get_config(arch_id).reduced()
    jarch = dataclasses.replace(
        jarch, model=dataclasses.replace(jarch.model, **chunks))
    tarch = get_config(arch_id).reduced()
    tarch = dataclasses.replace(
        tarch, model=dataclasses.replace(tarch.model, **chunks))
    assert repr(jarch.model) == repr(tarch.model)
    return jarch, tarch


@pytest.fixture(scope="module", params=MOE_ARCHS)
def jax_run(request):
    """The reference's train cell for the arch (its own optimizer:
    AdamW for OLMoE, Adafactor for grok), ``STEPS`` steps of batches
    from seeds 1..: the seed-0 init, the optimizer state after 3 steps,
    the losses and the params after each step."""
    jarch, tarch = _train_cfgs(request.param)
    assert JS._optimizer_for(jarch)[1] == TS._optimizer_for(tarch)[1]
    shape = JS._reduce_shape("lm", jarch.shape("train_4k"))
    cell = JS._lm_train_cell(jarch, shape, None, False, seed=0)
    params, opt_state = cell.args[0], cell.args[1]
    step_fn = jax.jit(cell.fn)
    b, s = shape["global_batch"], shape["seq_len"]
    out = {"arch": request.param, "init": jax.tree_util.tree_map(
        np.asarray, params), "losses": [], "params": [], "b": b, "s": s}
    for step in range(STEPS):
        toks = np.random.RandomState(step + 1).randint(
            0, jarch.model.vocab_size, size=(b, s + 1)).astype(np.int32)
        batch = {"tokens": jnp.asarray(toks[:, :-1]),
                 "labels": jnp.asarray(toks[:, 1:])}
        params, opt_state, loss = step_fn(params, opt_state,
                                          jnp.asarray(step, jnp.int32), batch)
        out["losses"].append(float(loss))
        out["params"].append(jax.tree_util.tree_map(np.asarray, params))
        if step == 2:
            out["state3"] = jax.tree_util.tree_map(np.asarray, opt_state)
    return out


def _port_steps(run, params, opt_state, steps):
    _, tarch = _train_cfgs(run["arch"])
    opt, _ = TS._optimizer_for(tarch)
    step_fn = TS.lm_train_step(tarch.model, opt)
    if opt_state is None:
        opt_state = opt.init(TS.lm_param_leaves(params))
    losses = []
    for step in steps:
        batch = TS._lm_train_batch(tarch.model, run["b"], run["s"],
                                   step + 1, "cpu")
        params, opt_state, loss = step_fn(params, opt_state, step, batch)
        losses.append(float(loss))
    return params, losses


def _assert_params_close(tparams, jparams, atol):
    jleaves = jax.tree_util.tree_leaves(jparams)
    tleaves = TS.lm_param_leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_allclose(t.numpy(), j, atol=atol, rtol=0)


def test_train_steps_match_jax_cell(jax_run):
    """Five steps from the reference cell's init: losses within 2e-5,
    params within 1e-4."""
    _, tarch = _train_cfgs(jax_run["arch"])
    params = TT.lm_from_jax_params(jax_run["init"], tarch.model, "cpu")
    params, losses = _port_steps(jax_run, params, None, range(5))
    np.testing.assert_allclose(losses, jax_run["losses"][:5], atol=2e-5)
    _assert_params_close(params, jax_run["params"][4], atol=1e-4)


def test_resume_from_jax_state(jax_run):
    """JAX's params and optimizer state after 3 steps carried across;
    the port's steps 3-5 match the JAX run's."""
    _, tarch = _train_cfgs(jax_run["arch"])
    params = TT.lm_from_jax_params(jax_run["params"][2], tarch.model, "cpu")
    kind = TS._optimizer_for(tarch)[1]
    state = TS.opt_state_from_jax(jax_run["state3"], params, kind)
    params, losses = _port_steps(jax_run, params, state, range(3, 6))
    np.testing.assert_allclose(losses, jax_run["losses"][3:], atol=2e-5)
    _assert_params_close(params, jax_run["params"][5], atol=1e-4)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_cli_restart_is_bit_exact(arch, tmp_path):
    def run(*extra):
        return train.main(["--arch", arch, "--shape", "train_4k",
                           "--reduced", "--log-every", "100",
                           "--device", "cpu", *extra])

    full = run("--steps", "4", "--ckpt-dir", str(tmp_path / "full"))
    part = run("--steps", "2", "--ckpt-dir", str(tmp_path / "ck"),
               "--ckpt-every", "2")
    resumed = run("--steps", "4", "--ckpt-dir", str(tmp_path / "ck"))
    assert len(full) == 4 and part == full[:2] and resumed == full[2:]
    (_, a, _), (_, b, _) = (ckpt.restore(tmp_path / d, device="cpu")
                            for d in ("full", "ck"))
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert any("moe" in str(p) for p, _ in fa)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert torch.equal(x, y), path
