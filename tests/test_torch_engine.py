"""The port's engine and single-node serve against the JAX package, on
the CPU: the same seeded corpus through both packages.

The ft variant's records (parser, page arrays, cost) and serve's metric
dict must be identical. The llm variant carries the JAX ``router-tiny``
encoder params across; its records must agree except for documents
whose improvement lies within 1e-5 of tau (f32 sums in another order),
and its probe qualities to 1e-9.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.common import unwrap
from repro.configs import get_config as j_get_config
from repro.core import engine as JE
from repro.core import quality as JQ
from repro.core.router import AdaParseRouter as JRouter
from repro.data.synthetic import CorpusConfig as JCorpusConfig
from repro.data.synthetic import generate_corpus as j_generate
from repro.launch import serve as JS
from repro.models import encoder as jenc
from repro_torch.configs import get_config
from repro_torch.core import backends as TB
from repro_torch.core import engine as TE
from repro_torch.core import quality as TQ
from repro_torch.core.router import AdaParseRouter as TRouter
from repro_torch.core.router import make_route_step
from repro_torch.data.synthetic import CorpusConfig
from repro_torch.data.synthetic import generate_corpus
from repro_torch.kernels.budget_route.ops import (POSITIVE_TAU,
                                                  capacity_floor)
from repro_torch.launch import serve as TS
from repro_torch.models.encoder import (encoder_from_jax_params,
                                        encoder_to_jax_params)

N_DOCS = 90


@pytest.fixture(scope="module")
def corpora():
    jc, tc = JCorpusConfig(n_docs=N_DOCS, seed=0), CorpusConfig(
        n_docs=N_DOCS, seed=0)
    jd, td = j_generate(jc), generate_corpus(tc)
    for a, b in zip(jd, td):
        assert a.doc_id == b.doc_id and a.producer == b.producer
        assert all(np.array_equal(p, q) for p, q in zip(a.pages, b.pages))
    return jc, jd, tc, td


@pytest.fixture(scope="module")
def ft_routers(corpora):
    jc, jd, tc, td = corpora
    jr = JS.build_ft_router(jd[:30], jc, np.random.RandomState(1))
    tr = TS.build_ft_router(td[:30], tc, np.random.RandomState(1),
                            device="cpu")
    np.testing.assert_array_equal(tr.cls1.w, jr.cls1.w)
    np.testing.assert_array_equal(tr.cls2.w, jr.cls2.w)
    return jr, tr


def _assert_records_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        ra, rb = a[k], b[k]
        assert (ra.doc_id, ra.parser, ra.cost_s) == \
            (rb.doc_id, rb.parser, rb.cost_s)
        assert len(ra.pages) == len(rb.pages)
        assert all(np.array_equal(p, q) for p, q in zip(ra.pages, rb.pages))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_ft_run_is_record_identical(corpora, ft_routers, prefetch):
    jc, jd, tc, td = corpora
    jr, tr = ft_routers
    kw = dict(alpha=0.2, batch_size=16, seed=3, prefetch_depth=prefetch)
    je = JE.AdaParseEngine(JE.EngineConfig(**kw), jr, jc)
    te = TE.AdaParseEngine(TE.EngineConfig(**kw), tr, tc, device="cpu")
    jrec, trec = je.run(jd[30:]), te.run(td[30:])
    _assert_records_equal(trec, jrec)
    assert any(r.parser == te.cfg.expensive for r in trec.values())
    assert te.evaluate(td[30:], trec) == je.evaluate(jd[30:], jrec)
    assert te.stats.n_expensive == je.stats.n_expensive


def test_ft_cache_replay_is_record_identical(corpora, ft_routers):
    jc, jd, tc, td = corpora
    _, tr = ft_routers
    cache = TB.ResultCache()
    cfg = TE.EngineConfig(alpha=0.2, batch_size=16, seed=3)
    cold = TE.AdaParseEngine(cfg, tr, tc, cache=cache, device="cpu")
    rec_cold = cold.run(td[30:])
    warm = TE.AdaParseEngine(cfg, tr, tc, cache=cache, device="cpu")
    rec_warm = warm.run(td[30:])
    _assert_records_equal(rec_warm, rec_cold)
    assert warm.stats.cache_hits == -(-len(td[30:]) // 16)
    assert warm.stats.node_seconds == 0.0


@pytest.fixture(scope="module")
def llm_routers(ft_routers):
    """The JAX router-tiny encoder behind each package's CLS-I stage (the
    ft routers' fit: fit_cls1_stage fits the same stage for both
    variants)."""
    jft, tft = ft_routers
    jcfg = j_get_config("adaparse-router").reduced().model
    tcfg = get_config("adaparse-router").reduced().model
    raw = jax.tree_util.tree_map(np.asarray,
                                 unwrap(jenc.init_encoder(jcfg, 0)))
    enc = encoder_from_jax_params(raw, tcfg, "cpu")
    # random weights: read the "expensive" accuracy off the output that
    # most often beats output 0, so the budget has docs to route
    toks = torch.randint(2, 8000, (16, tcfg.max_len),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        pred = enc.predict_accuracies(toks)
    exp = int((pred[:, 1:] > pred[:, :1]).sum(0).argmax()) + 1
    jr = JRouter("llm", jft.cls1, None, enc_cfg=jcfg, enc_params=raw,
                 expensive_idx=exp)
    tr = TRouter("llm", tft.cls1, None, enc_cfg=tcfg, encoder=enc,
                 expensive_idx=exp)
    return jr, tr


def test_llm_run_matches_jax(corpora, llm_routers):
    jc, jd, tc, td = corpora
    jr, tr = llm_routers
    kw = dict(alpha=0.1, batch_size=32, seed=3)
    je = JE.AdaParseEngine(JE.EngineConfig(**kw), jr, jc,
                           probe=JQ.QualityProbe(
                               JQ.QualityProbeConfig(probe_rate=1.0)))
    te = TE.AdaParseEngine(TE.EngineConfig(**kw), tr, tc,
                           probe=TQ.QualityProbe(
                               TQ.QualityProbeConfig(probe_rate=1.0),
                               device="cpu"),
                           device="cpu")
    test_j, test_t = jd[30:], td[30:]
    jrec, trec = je.run(test_j), te.run(test_t)
    assert any(r.parser == te.cfg.expensive for r in trec.values())
    step = make_route_step(0.1, expensive_idx=tr.expensive_idx)
    bs = 32
    for b, (jt, tt) in enumerate(zip(je.telemetry, te.telemetry)):
        docs = test_t[b * bs:(b + 1) * bs]
        flipped = [i for i, d in enumerate(docs)
                   if trec[d.doc_id].parser != jrec[d.doc_id].parser]
        if flipped:
            prep = te.prepare_batch(docs, batch_key=b)
            imp = step(tr.encoder, prep.route_host["tokens"],
                       prep.route_host["mask"],
                       torch.from_numpy(prep.route_host["valid_logit"])
                       )["improvement"].numpy()
            cap = capacity_floor(0.1, len(imp))
            tau = max(float(np.sort(imp)[::-1][cap - 1]), POSITIVE_TAU)
            assert all(abs(imp[i] - tau) <= 1e-5 for i in flipped), flipped
            continue
        for d in docs:
            _assert_records_equal({0: trec[d.doc_id]}, {0: jrec[d.doc_id]})
        assert jt.quality.keys() == tt.quality.keys()
        for p in jt.quality:
            assert tt.quality[p][1] == jt.quality[p][1]
            assert abs(tt.quality[p][0] - jt.quality[p][0]) <= 1e-9


def test_router_fingerprint_is_content_based(llm_routers, ft_routers):
    _, tr = llm_routers
    fp = TE._router_fingerprint(tr)
    copy = encoder_from_jax_params(encoder_to_jax_params(tr.encoder),
                                   tr.enc_cfg, "cpu")
    twin = dataclasses.replace(tr, encoder=copy)
    assert TE._router_fingerprint(twin) == fp
    with torch.no_grad():
        twin.encoder.layers[1].p["b_out"][0] += 1e-3
    twin._cache_fp = None
    assert TE._router_fingerprint(twin) != fp
    assert TE._router_fingerprint(ft_routers[1]) != fp


def test_serve_ft_matches_jax():
    argv = ["--docs", "60", "--batch-size", "16", "--variant", "ft"]
    got = TS.main(argv + ["--device", "cpu"])
    assert got == JS.main(argv)


@pytest.mark.parametrize("argv", [
    ["--fabric-workers", "2"], ["--workers", "2"],
    ["--heartbeat-timeout", "5"], ["--transport", "pickle"],
    ["--coordinator", "127.0.0.1:0"], ["--scenario", "list"],
    ["--status-interval", "1"], ["--tuning-dir", "tuning"],
    ["--device", "tpu"], ["--prefetch-depth", "-1"],
])
def test_serve_rejects_unported_flags(argv, capsys):
    """The flags still waiting for their ROADMAP item exit 2 and name it
    (the campaign flags of item 12a run: tests/test_torch_campaign.py)."""
    with pytest.raises(SystemExit) as e:
        TS.main(["--docs", "30", "--device", "cpu"] + argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "error" in err
    if argv[0] in TS.UNPORTED_FLAGS:
        assert f"ROADMAP item {TS.UNPORTED_FLAGS[argv[0]]}" in err


def test_entry_points_default_to_cuda(corpora, ft_routers):
    """No device given means cuda: on a host without a card every entry
    point raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, _, tc, _ = corpora
    with pytest.raises(RuntimeError, match="cuda"):
        TE.AdaParseEngine(TE.EngineConfig(), ft_routers[1], tc)
    with pytest.raises(RuntimeError, match="cuda"):
        TQ.QualityProbe()
    with pytest.raises(SystemExit):
        TS.main(["--docs", "30"])
