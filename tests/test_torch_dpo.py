"""The port's router post-training (``repro_torch.core.dpo``) and
``serve --variant llm`` against the JAX package on the CPU.

Both packages start from the JAX ``router-tiny`` init (2 layers, d=32,
float32), carried across with ``encoder_from_jax_params``: the JAX PRNG
cannot be reproduced in torch. Tolerances:

- loss values and their gradients within 2e-5 of ``jax.grad`` (the
  JAX package's f32 bar; the frameworks sum in other orders);
- 30-step ``fit_regression``/``fit_dpo`` on serve's training data:
  losses within rtol 1e-5; params within 1e-5 except for at most a
  1e-5 share of the elements, and all within 1e-4. AdamW's eps (1e-8)
  sits near the few grads that nearly cancel (a token seen once): the
  two frameworks round such a grad apart, and AdamW turns that into a
  step that differs by a few 1e-5 for that one element;
- ``build_llm_router`` after its full 150/60/50-step schedule: training
  data identical, params and predicted improvements within 1e-4, plans
  equal except for documents whose JAX improvement lies within 1e-4 of
  tau.

The parity tests print the largest differences they saw (``-s``).
"""
import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from repro.common import unwrap
from repro.configs import get_config as j_get_config
from repro.configs.base import EncoderConfig as JEncoderConfig
from repro.core import dpo as jdpo
from repro.core import engine as JE
from repro.core.router import make_route_step as j_make_route_step
from repro.data.synthetic import CorpusConfig as JCorpusConfig
from repro.data.synthetic import generate_corpus as j_generate
from repro.launch import serve as JS
from repro.models import encoder as jenc
from repro_torch.configs import get_config
from repro_torch.configs.base import EncoderConfig
from repro_torch.core import dpo as tdpo
from repro_torch.core import engine as TE
from repro_torch.core import scheduler
from repro_torch.data.synthetic import CorpusConfig, generate_corpus
from repro_torch.kernels.budget_route.ops import (POSITIVE_TAU,
                                                  capacity_floor)
from repro_torch.launch import serve as TS
from repro_torch.models import encoder as tenc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models gain nothing from intra-op threads, and the
    suite's other workers (some with wall-clock heartbeats) share the
    cores; the thread count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_get_config("adaparse-router").reduced().model
    tcfg = get_config("adaparse-router").reduced().model
    assert repr(jcfg) == repr(tcfg) and tcfg.remat
    raw = _np_tree(unwrap(jenc.init_encoder(jcfg, 0)))
    return jcfg, tcfg, raw


def _reg_data(cfg, n, seed):
    rng = np.random.RandomState(seed)
    s = cfg.max_len
    toks = rng.randint(2, 8000, (n, s)).astype(np.int32)
    toks[:, 0] = 1
    lens = rng.randint(1, s + 1, n)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.float32)
    return {"tokens": toks, "mask": mask,
            "targets": rng.rand(n, cfg.n_outputs).astype(np.float32)}


def _pref_data(cfg, n, seed):
    a, b = _reg_data(cfg, n, seed), _reg_data(cfg, n, seed + 1)
    return {"tok_pos": a["tokens"], "mask_pos": a["mask"],
            "tok_neg": b["tokens"], "mask_neg": b["mask"]}


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _grads_as_jax(enc, grads):
    """A list of grads aligned with ``enc.parameters()`` (``None`` for a
    parameter the loss does not reach) -> the JAX param tree layout."""
    by_param = {id(p): g for p, g in zip(enc.parameters(), grads)}
    out: dict = {"layers": {}}
    for name, i, p in tenc._named_params(enc):
        g = by_param[id(p)]
        g = torch.zeros_like(p) if g is None else g
        if i is None:
            out[name] = g.numpy()
        else:
            out["layers"].setdefault(name, []).append(g.numpy())
    out["layers"] = {k: np.stack(v) for k, v in out["layers"].items()}
    return out


def _port_grads(enc, loss_fn):
    enc.requires_grad_(True)
    try:
        params = list(enc.parameters())
        loss = loss_fn()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        enc.requires_grad_(False)
    return float(loss.detach()), _grads_as_jax(enc, grads)


def _assert_trees_close(got, want, atol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    worst = 0.0
    for path, g in flat_g:
        w = np.asarray(flat_w[path], np.float32)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
        worst = max(worst, float(np.abs(g - w).max()))
    return worst


def test_losses_and_grads_match_jax(tiny):
    """regression_loss and dpo_loss (policy and reference apart), their
    values and every parameter's gradient: embed_lookup, layer_norm and
    the tanh gelu backward included. Unreached params get zero grads."""
    jcfg, tcfg, raw = tiny
    ref_raw = _np_tree(unwrap(jenc.init_encoder(jcfg, 1)))
    enc = tenc.encoder_from_jax_params(raw, tcfg, "cpu")
    ref = tenc.encoder_from_jax_params(ref_raw, tcfg, "cpu")
    reg = _reg_data(tcfg, 12, 0)
    reg["target_mask"] = (reg["targets"] > 0.3).astype(np.float32)
    pref = _pref_data(tcfg, 10, 3)

    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jenc.regression_loss(p, jcfg, reg)))(raw)
    t_loss, t_grads = _port_grads(
        enc, lambda: enc.regression_loss(_to_torch(reg)))
    np.testing.assert_allclose(t_loss, float(j_loss), atol=2e-5)
    _assert_trees_close(t_grads, j_grads, 2e-5)
    assert not t_grads["pref_w"].any()              # not reached: zero

    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jdpo.dpo_loss(p, ref_raw, jcfg, pref, 0.7)))(raw)
    t_loss, t_grads = _port_grads(
        enc, lambda: tdpo.dpo_loss(enc, ref, _to_torch(pref), 0.7))
    np.testing.assert_allclose(t_loss, float(j_loss), atol=2e-5)
    _assert_trees_close(t_grads, j_grads, 2e-5)
    assert not t_grads["head_w"].any()
    assert all(p.grad is None and not p.requires_grad
               for p in ref.parameters())


def test_dpo_loss_at_reference_is_log2():
    """With policy == reference the DPO logits are 0 -> loss = log 2
    (the JAX package's property test, on the port)."""
    cfg = EncoderConfig(name="t", n_layers=1, d_model=16, n_heads=2,
                        d_ff=32, vocab_size=64, max_len=16,
                        param_dtype="float32", compute_dtype="float32")
    enc = tenc.init_encoder(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tok_pos": torch.ones((4, 8), dtype=torch.int32),
             "mask_pos": torch.ones((4, 8)),
             "tok_neg": torch.ones((4, 8), dtype=torch.int32) * 2,
             "mask_neg": torch.ones((4, 8))}
    loss = tdpo.dpo_loss(enc, enc, batch)
    assert abs(float(loss) - np.log(2.0)) < 1e-6


def test_remat_grads_are_bit_equal(tiny):
    """Layers under torch.utils.checkpoint give the very same grads."""
    _, tcfg, raw = tiny
    reg = _to_torch(_reg_data(tcfg, 8, 5))
    grads = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        enc = tenc.encoder_from_jax_params(raw, cfg, "cpu")
        grads[remat] = _port_grads(enc, lambda: enc.regression_loss(reg))
    assert grads[True][0] == grads[False][0]
    for a, b in zip(jax.tree_util.tree_leaves(grads[True][1]),
                    jax.tree_util.tree_leaves(grads[False][1])):
        np.testing.assert_array_equal(a, b)


N_DOCS = 60          # serve --docs 60: 20 training docs, 40 test docs


@pytest.fixture(scope="module")
def corpus_data(tiny):
    """serve's router training data (the 60-doc corpus's 20 training
    docs, rng seeded 1) as numpy: the regression set and 20 preference
    pairs. ``test_build_llm_router_matches_jax`` holds it equal to the
    JAX package's."""
    tc = CorpusConfig(n_docs=N_DOCS, seed=0)
    _, reg, pref = TS.llm_training_data(
        generate_corpus(tc)[:N_DOCS // 3], tc, np.random.RandomState(1),
        tiny[1].max_len, "cpu")
    return {k: v.numpy() for k, v in reg.items()}, pref


@pytest.mark.parametrize("stage", ["regression", "dpo"])
def test_fit_30_steps_tracks_jax(tiny, corpus_data, stage):
    """fit_regression (wd 0.01: the unreached pref head still decays) and
    fit_dpo (frozen reference, wd 0: the unreached regression head stays
    put) for 30 steps from one init, the same minibatches; then the
    regression's per-parser R^2 (within 2e-5)."""
    jcfg, tcfg, raw = tiny
    reg, pref = corpus_data
    enc = tenc.encoder_from_jax_params(raw, tcfg, "cpu")
    if stage == "regression":
        jres = jdpo.fit_regression(raw, jcfg, reg, steps=30)
        tres = tdpo.fit_regression(enc, reg, steps=30)
    else:
        jres = jdpo.fit_dpo(raw, jcfg, pref, steps=30)
        tres = tdpo.fit_dpo(enc, pref, steps=30)
    assert tres.encoder is enc and len(tres.losses) == 30
    assert all(not p.requires_grad for p in enc.parameters())
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-5)
    got = tenc.encoder_to_jax_params(enc)
    _assert_trees_close(got, _np_tree(jres.params_raw), 1e-4)
    diff = np.concatenate([
        np.abs(a - np.asarray(b)).ravel() for a, b in zip(
            jax.tree_util.tree_leaves(got),
            jax.tree_util.tree_leaves(_np_tree(jres.params_raw)))])
    assert (diff > 1e-5).mean() <= 1e-5, np.sort(diff)[-5:]
    print(f"{stage}: max |param diff| {diff.max():.3g}, "
          f"{int((diff > 1e-5).sum())} of {diff.size} beyond 1e-5")
    if stage == "regression":
        assert not np.array_equal(got["pref_w"], raw["pref_w"])
        np.testing.assert_allclose(
            tdpo.regression_r2(enc, reg),
            jdpo.regression_r2(jres.params_raw, jcfg, reg), atol=2e-5)
    else:
        np.testing.assert_array_equal(got["head_w"], raw["head_w"])
        np.testing.assert_array_equal(got["head_b"], raw["head_b"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_roundtrip(tiny, dtype):
    """encoder_to_jax_params inverts encoder_from_jax_params: numpy
    leaves, layers stacked (bf16 leaves come out as float32, exactly)."""
    jcfg, tcfg, _ = tiny
    jcfg = dataclasses.replace(jcfg, param_dtype=dtype)
    tcfg = dataclasses.replace(tcfg, param_dtype=dtype)
    raw = _np_tree(unwrap(jenc.init_encoder(jcfg, 2)))
    enc = tenc.encoder_from_jax_params(raw, tcfg, "cpu")
    out = tenc.encoder_to_jax_params(enc)
    assert jax.tree_util.tree_structure(out) == \
        jax.tree_util.tree_structure(raw)
    for a, b in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(raw)):
        assert isinstance(a, np.ndarray) and a.shape == b.shape
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    again = tenc.encoder_from_jax_params(out, tcfg, "cpu")
    for p, q in zip(enc.parameters(), again.parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q)


def test_fit_dpo_improves_preference_accuracy():
    """The port's stage-2 DPO raises pairwise preference accuracy, as
    ``tests/test_adaparse_core.py`` holds for the JAX package (same
    config, data and init)."""
    kw = dict(name="t", n_layers=2, d_model=32, n_heads=4, d_ff=64,
              vocab_size=128, max_len=16, param_dtype="float32",
              compute_dtype="float32")
    rng = np.random.RandomState(0)
    n, s = 48, 16
    pref = {"tok_pos": rng.randint(2, 60, (n, s)).astype(np.int32),
            "mask_pos": np.ones((n, s), np.float32),
            "tok_neg": rng.randint(64, 126, (n, s)).astype(np.int32),
            "mask_neg": np.ones((n, s), np.float32)}
    raw = _np_tree(unwrap(jenc.init_encoder(JEncoderConfig(**kw), 0)))
    enc = tenc.encoder_from_jax_params(raw, EncoderConfig(**kw), "cpu")
    batch = _to_torch(pref)
    acc0 = float(tdpo.pref_accuracy(enc, batch))
    res = tdpo.fit_dpo(enc, pref, steps=40, lr=1e-3, bs=16)
    acc1 = float(tdpo.pref_accuracy(res.encoder, batch))
    assert acc1 > max(acc0, 0.8)
    assert res.losses[-1] < res.losses[0]


# -- build_llm_router and serve --variant llm ----------------------------------


@contextlib.contextmanager
def _spy(module, name, calls):
    """Record each call's arguments and result of ``module.name``."""
    real = getattr(module, name)

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append((a, kw, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, name, spy)
        yield


@pytest.fixture(scope="module")
def llm_pair(tiny):
    """``build_llm_router`` in both packages on serve's corpus and rng;
    the port starts from the JAX init that its spy saw."""
    jc, tc = (JCorpusConfig(n_docs=N_DOCS, seed=0),
              CorpusConfig(n_docs=N_DOCS, seed=0))
    jd, td = j_generate(jc), generate_corpus(tc)
    jcalls, tcalls = [], []
    with _spy(jdpo, "three_stage_posttrain", jcalls):
        jr = JS.build_llm_router(jd[:N_DOCS // 3], jc,
                                 np.random.RandomState(1))
    (j_init, jcfg, j_reg, j_pref), _, _ = jcalls[0]
    start = tenc.encoder_from_jax_params(_np_tree(j_init), tiny[1], "cpu")
    with _spy(tdpo, "three_stage_posttrain", tcalls):
        tr = TS.build_llm_router(td[:N_DOCS // 3], tc,
                                 np.random.RandomState(1), device="cpu",
                                 encoder=start)
    (_, t_reg, t_pref), t_kw, (_, t_diag) = tcalls[0]
    assert t_kw == jcalls[0][1]                     # the same step counts
    return dict(jc=jc, jd=jd, tc=tc, td=td, jr=jr, tr=tr, j_reg=j_reg,
                j_pref=j_pref, t_reg=t_reg, t_pref=t_pref,
                j_diag=jcalls[0][2][1], t_diag=t_diag)


@pytest.mark.slow
def test_build_llm_router_matches_jax(llm_pair):
    r = llm_pair
    jr, tr = r["jr"], r["tr"]
    np.testing.assert_array_equal(tr.cls1.w, jr.cls1.w)
    for k in ("tokens", "mask", "targets"):
        got = r["t_reg"][k].numpy()
        want = np.asarray(r["j_reg"][k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert r["t_pref"].keys() == r["j_pref"].keys()
    for k in r["j_pref"]:
        assert r["t_pref"][k].dtype == r["j_pref"][k].dtype, k
        np.testing.assert_array_equal(r["t_pref"][k], r["j_pref"][k],
                                      err_msg=k)
    for k in ("sft_loss", "dpo_loss", "refit_loss"):
        assert len(r["t_diag"][k]) == len(r["j_diag"][k])
        assert all(np.isfinite(r["t_diag"][k]))
    param_diff = _assert_trees_close(
        tenc.encoder_to_jax_params(tr.encoder), _np_tree(jr.enc_params),
        1e-4)

    # the engines over the test split, at an alpha that routes docs
    alpha, bs = 0.25, 16
    kw = dict(alpha=alpha, batch_size=bs, seed=0)
    test_j, test_t = r["jd"][N_DOCS // 3:], r["td"][N_DOCS // 3:]
    je = JE.AdaParseEngine(JE.EngineConfig(**kw), jr, r["jc"])
    te = TE.AdaParseEngine(TE.EngineConfig(**kw), tr, r["tc"], device="cpu")
    jrec, trec = je.run(test_j), te.run(test_t)
    assert any(x.parser == te.cfg.expensive for x in trec.values())
    j_step = j_make_route_step(jr.enc_cfg, alpha)
    imp_diff, near_tau = 0.0, []
    for b, i in enumerate(range(0, len(test_t), bs)):
        prep = je.prepare_batch(test_j[i:i + bs], batch_key=b)
        j_imp = np.asarray(j_step(jr.enc_params, prep.route_host["tokens"],
                                  prep.route_host["mask"],
                                  prep.route_host["valid_logit"])
                           ["improvement"])
        tprep = te.prepare_batch(test_t[i:i + bs], batch_key=b)
        t_imp = tr.predict_improvement(tprep.fast, None,
                                       tprep.route_host["tokens"],
                                       tprep.route_host["mask"])
        t_imp = np.nan_to_num(t_imp, posinf=1e3)
        np.testing.assert_allclose(t_imp, j_imp, atol=1e-4, rtol=0)
        imp_diff = max(imp_diff, float(np.abs(t_imp - j_imp).max()))
        plan = scheduler.plan_batch(t_imp, alpha)
        cap = capacity_floor(alpha, len(j_imp))
        tau = max(float(np.sort(j_imp)[::-1][cap - 1]), POSITIVE_TAU)
        for k, d in enumerate(test_t[i:i + bs]):
            if trec[d.doc_id].parser != jrec[d.doc_id].parser:
                near_tau.append(abs(float(j_imp[k]) - tau))
                assert near_tau[-1] <= 1e-4, (d.doc_id, j_imp[k], tau)
            assert (trec[d.doc_id].parser == te.cfg.expensive) == \
                (k in set(plan.expensive_idx.tolist()))
    print(f"build_llm_router: max |param diff| {param_diff:.3g}, max "
          f"|improvement diff| {imp_diff:.3g}, {len(near_tau)} plan "
          f"flips near tau")


@pytest.mark.slow
def test_serve_llm_cpu_prints_the_reference_metrics(llm_pair, capsys):
    """``serve --variant llm --device cpu`` trains the router and prints
    the metric names that ``repro.launch.serve`` prints (those of the
    engine's ``evaluate``), with frac_expensive <= alpha."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = TS.main(["--variant", "llm", "--device", "cpu", "--docs",
                       str(N_DOCS), "--batch-size", "16"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("[serve] AdaParse(llm) alpha=0.05 n_test=40")
    je = JE.AdaParseEngine(JE.EngineConfig(alpha=0.05, batch_size=16),
                           llm_pair["jr"], llm_pair["jc"])
    test_j = llm_pair["jd"][N_DOCS // 3:]
    want = list(je.evaluate(test_j, je.run(test_j)))
    assert [ln.split()[0] for ln in lines[1:]] == want == list(res)
    assert 0.0 <= res["frac_expensive"] <= 0.05
    assert all(np.isfinite(v) for v in res.values())


def test_serve_llm_without_device_asks_for_cuda(capsys):
    """No --device means cuda: without a card, --variant llm exits 2
    with the device error instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(SystemExit) as e:
        TS.main(["--docs", "30", "--variant", "llm"])
    assert e.value.code == 2
    assert "cuda" in capsys.readouterr().err
