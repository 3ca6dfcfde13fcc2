"""ngram_score + core/metrics + core/quality of the PyTorch port against
the JAX package, on the CPU.

Tolerances: the port's plain BLEU is float64 with exact integer counts,
held to 1e-12 of the JAX float64 oracle (``ngram_bleu_ref``); against
the JAX float32 kernel (interpret mode) the bar is the JAX kernel's own,
atol 1e-6 and rtol 1e-5. ROUGE-L and CAR come from exact integer DPs
and are held equal; probe qualities to 1e-9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as JM
from repro.core import quality as JQ
from repro.kernels.ngram_score.kernel import ngram_bleu_kernel
from repro.kernels.ngram_score.ref import ngram_bleu_ref as j_bleu_ref
from repro_torch.core import metrics as TM
from repro_torch.core import quality as TQ
from repro_torch.kernels.ngram_score import ops as tops


def _batch(b, max_len, lens_r, lens_h, vocab=12, seed=0):
    """Padded batches whose pad region is garbage (not -1), so parity
    proves the length masks."""
    rng = np.random.RandomState(seed)
    ref = rng.randint(1, vocab, (b, max_len)).astype(np.int32)
    hyp = rng.randint(1, vocab, (b, max_len)).astype(np.int32)
    return ref, hyp, np.asarray(lens_r, np.int32), np.asarray(lens_h,
                                                            np.int32)


def _port(ref, hyp, lr, lh):
    return tops.ngram_bleu(*(torch.from_numpy(x)
                             for x in (ref, hyp, lr, lh))).numpy()


@pytest.mark.parametrize("b,max_len,vocab", [
    (4, 32, 6), (6, 48, 30), (3, 64, 4), (16, 40, 9)])
def test_plain_bleu_matches_jax_oracle(b, max_len, vocab):
    rng = np.random.RandomState(b * 7 + max_len)
    lr = rng.randint(1, max_len + 1, b)
    lh = rng.randint(1, max_len + 1, b)
    ref, hyp, lr, lh = _batch(b, max_len, lr, lh, vocab=vocab, seed=max_len)
    got = _port(ref, hyp, lr, lh)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, j_bleu_ref(ref, hyp, lr, lh),
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("b,max_len,vocab", [(4, 24, 5), (3, 32, 30)])
def test_plain_bleu_matches_jax_interpret_kernel(b, max_len, vocab):
    rng = np.random.RandomState(b + max_len)
    lr = rng.randint(0, max_len + 1, b)
    lh = rng.randint(0, max_len + 1, b)
    ref, hyp, lr, lh = _batch(b, max_len, lr, lh, vocab=vocab, seed=b)
    j = ngram_bleu_kernel(jnp.asarray(ref), jnp.asarray(hyp),
                          jnp.asarray(lr), jnp.asarray(lh),
                          max_len=max_len, interpret=True)
    np.testing.assert_allclose(_port(ref, hyp, lr, lh),
                               np.asarray(j, np.float64),
                               atol=1e-6, rtol=1e-5)


def test_bleu_edge_cases_and_padding():
    """Empty hypotheses score exactly 0; empty references, full rows and
    rows shorter than the n-gram order agree with the oracle; garbage
    beyond the lengths changes nothing."""
    max_len = 24
    lens_r = [0, 10, max_len, 2, 1, max_len]
    lens_h = [5, 0, max_len, 3, 1, 1]
    ref, hyp, lr, lh = _batch(6, max_len, lens_r, lens_h, vocab=5)
    got = _port(ref, hyp, lr, lh)
    np.testing.assert_allclose(got, j_bleu_ref(ref, hyp, lr, lh),
                               atol=1e-12, rtol=0)
    assert got[1] == 0.0
    ref2, hyp2 = ref.copy(), hyp.copy()
    rng = np.random.RandomState(99)
    for i in range(6):
        ref2[i, lr[i]:] = rng.randint(1000, 2000, max_len - lr[i])
        hyp2[i, lh[i]:] = -1
    np.testing.assert_array_equal(_port(ref2, hyp2, lr, lh), got)


def test_plain_bleu_matches_host_scorer():
    rng = np.random.RandomState(3)
    max_len = 40
    refs = [rng.randint(1, 9, rng.randint(1, max_len + 1)).astype(np.int32)
            for _ in range(5)]
    hyps = [rng.randint(1, 9, rng.randint(0, max_len + 1)).astype(np.int32)
            for _ in range(5)]
    ra, rl = TM._pad_batch(refs, max_len)
    ha, hl = TM._pad_batch(hyps, max_len)
    want = np.asarray([TM.bleu(r, h) for r, h in zip(refs, hyps)])
    np.testing.assert_allclose(_port(ra, ha, rl, hl), want, atol=1e-12)
    assert [TM.bleu(r, h) for r, h in zip(refs, hyps)] == \
        [JM.bleu(r, h) for r, h in zip(refs, hyps)]


def _streams(n, seed, max_tok=70):
    rng = np.random.RandomState(seed)
    refs, hyps = [], []
    for i in range(n):
        r = rng.randint(10, 30, rng.randint(1, max_tok)).astype(np.int32)
        kind = i % 4
        if kind == 0:
            h = np.zeros(0, np.int32)                 # empty hypothesis
        elif kind == 1:
            h = r.copy()
            h[rng.rand(len(h)) < 0.2] = 2             # corrupted copy
        elif kind == 2:
            h = rng.randint(10, 30, rng.randint(1, 2 * max_tok)) \
                .astype(np.int32)                     # may exceed max_len
        else:
            h = np.concatenate([r[: len(r) // 2], r])
        refs.append(r)
        hyps.append(h)
    return refs, hyps


@pytest.mark.parametrize("n,max_len", [(11, 48), (5, 64)])
def test_score_batch_matches_jax(n, max_len):
    refs, hyps = _streams(n, n)
    got = TM.score_batch(refs, hyps, max_len=max_len, device="cpu")
    want = JM.score_batch(refs, hyps, max_len=max_len)
    assert set(got) == set(want)
    for k in ("rouge", "car", "ref_len", "hyp_len"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["bleu"], want["bleu"], atol=1e-12,
                               rtol=0)
    assert (got["bleu"][::4] == 0).all()             # empty hypotheses
    sub = TM.score_batch(refs, hyps, max_len=max_len, metrics=("car",),
                         device="cpu")
    assert set(sub) == {"car", "ref_len", "hyp_len"}
    with pytest.raises(ValueError, match="unknown score metrics"):
        TM.score_batch(refs, hyps, metrics=("wer",), device="cpu")
    with pytest.raises(ValueError, match="one hypothesis per reference"):
        TM.score_batch(refs, hyps[:-1], device="cpu")
    empty = TM.score_batch([], [], device="cpu")
    assert all(v.size == 0 for v in empty.values())


def test_evaluate_parser_matches_jax():
    refs, hyps = _streams(9, 4)
    pages = [[r[: len(r) // 2], r[len(r) // 2:]] for r in refs]
    hpages = [[h] if len(h) else [] for h in hyps]
    got = TM.evaluate_parser(refs, hyps, pages, hpages, device="cpu")
    want = JM.evaluate_parser(refs, hyps, pages, hpages)
    assert got == want
    assert TM.corpus_bleu(refs, hyps) == JM.corpus_bleu(refs, hyps)


class _Rec:
    def __init__(self, parser, pages):
        self.parser, self.pages = parser, pages


class _Doc:
    def __init__(self, text):
        self.text = text

    def full_text(self):
        return self.text


@pytest.mark.parametrize("metric", ["bleu", "mean"])
def test_quality_probe_and_policy_match_jax(metric):
    refs, hyps = _streams(12, 6, max_tok=40)
    docs = [_Doc(r) for r in refs]
    recs = [_Rec("pymupdf" if i % 3 else "nougat", [h] if len(h) else [])
            for i, h in enumerate(hyps)]
    tcfg = TQ.QualityProbeConfig(probe_rate=0.5, seed=3, max_len=32,
                                 metric=metric)
    jcfg = JQ.QualityProbeConfig(probe_rate=0.5, seed=3, max_len=32,
                                 metric=metric)
    tp, jp = TQ.QualityProbe(tcfg, device="cpu"), JQ.QualityProbe(jcfg)
    assert [tp.should_probe(k) for k in range(20)] == \
        [jp.should_probe(k) for k in range(20)]
    got, want = tp.score_records(docs, recs), jp.score_records(docs, recs)
    assert got.keys() == want.keys()
    for p in got:
        assert got[p][1] == want[p][1]
        assert abs(got[p][0] - want[p][0]) <= 1e-9
    tm, jm = TQ.QualityMonitor(), JQ.QualityMonitor()
    tm.observe(got)
    jm.observe(want)
    for a in (0.05, 0.2):
        t = TQ.propose_alpha(a, tm, "pymupdf", "nougat", bounds=(0.05, 0.5),
                             step=0.05, quality_target=0.45)
        j = JQ.propose_alpha(a, jm, "pymupdf", "nougat", bounds=(0.05, 0.5),
                             step=0.05, quality_target=0.45)
        assert t[1] == j[1] and abs(t[0] - j[0]) <= 1e-9


def test_kernel_timing_inputs_plain_bleu_matches_jax_oracle():
    """The probe batch the card's A/B timing scores (256 documents of
    the seeded corpus at L = 256, references against the cheap parser's
    output): the port's plain version equals the JAX oracle there."""
    from repro_torch.launch.kernel_timing import probe_inputs

    ngram, ff, kw = probe_inputs("cpu")
    ref, hyp, lr, lh = (t.numpy() for t in ngram)
    assert ref.shape == hyp.shape == (256, 256)
    assert ff[0].shape[0] == 256 and kw["max_len"] == 512
    np.testing.assert_allclose(_port(ref, hyp, lr, lh),
                               j_bleu_ref(ref, hyp, lr, lh),
                               atol=1e-12, rtol=0)
