"""fast_features + core/features of the PyTorch port against the JAX
package, on the CPU (the port's plain version) — same page lists, made
with numpy from a seed, through both packages.

Tolerances: the port's plain version and the JAX float64 oracle count
every per-document quantity exactly and assemble the features in
float64 term by term, so tokens, mask and seven of the eight features
are bit-equal. Feature 0 is log1p(n_tok)/10: torch's and numpy's
float64 log1p may differ in the last bit, which can move the float32
rounding by at most 1 ulp, so that column is held to 1 float32 ulp.
Against the JAX kernel (interpret mode, float32 arithmetic) the bar is
the JAX kernel's own, 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as JF
from repro.data.synthetic import CorpusConfig as JCorpusConfig
from repro.kernels.fast_features import ops as jops
from repro.kernels.fast_features.kernel import fast_features_kernel
from repro.kernels.fast_features.ref import routing_features_ref
from repro_torch.core import features as TF
from repro_torch.data.synthetic import CorpusConfig
from repro_torch.kernels.fast_features import ops as tops
from repro_torch.kernels.fast_features.ref import fast_features_ref

KW = dict(ws=2, scramble=3, mangled=4)


def _page_batch(n, seed, vocab=10000, max_pg_tok=200):
    """Parser-output batches covering the CLS-I edge cases: docs with no
    pages, docs whose pages are all empty, max-length single-page docs,
    and high token ids near the top of the vocabulary."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        kind = r.randint(0, 7)
        if kind == 0:
            out.append([])
        elif kind == 1:
            out.append([np.zeros(0, np.int32)
                        for _ in range(r.randint(1, 4))])
        elif kind == 2:
            out.append([r.randint(vocab - 300, vocab,
                                  max_pg_tok).astype(np.int32)])
        else:
            out.append([r.randint(0, vocab,
                                  r.randint(0, max_pg_tok)).astype(np.int32)
                        for _ in range(r.randint(1, 6))])
    return out


def _assert_features_equal(got: np.ndarray, want: np.ndarray):
    """Bit-equal, except 1 float32 ulp allowed in the log1p column."""
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    np.testing.assert_array_max_ulp(got[:, 0], want[:, 0], maxulp=1)


def _torch_inputs(packed):
    return [torch.from_numpy(np.asarray(a, np.int32)) for a in (
        packed.tok_matrix, packed.n_tok, packed.first_len, packed.n_pages,
        packed.n_empty)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_len", [0, 32])
def test_plain_version_matches_jax_oracle(seed, max_len):
    cfg = CorpusConfig()
    pls = _page_batch(50, seed, vocab=cfg.vocab_size)
    tp = tops.pack_routing_batch(pls, max_len=max_len)
    jp = jops.pack_routing_batch(pls, max_len=max_len)
    for field in ("flat", "rows", "starts", "n_tok", "first_len",
                  "n_pages", "n_empty", "max_len", "width"):
        np.testing.assert_array_equal(getattr(tp, field),
                                      getattr(jp, field))
    np.testing.assert_array_equal(tp.tok_matrix, jp.tok_matrix)
    kw = dict(KW, latex_lo=cfg.latex_lo, ident_lo=cfg.ident_lo,
              vocab_size=cfg.vocab_size, max_len=max_len)
    want = routing_features_ref(jp.flat, jp.rows, jp.starts, jp.n_tok,
                                jp.first_len, jp.n_pages, jp.n_empty, **kw)
    got = fast_features_ref(*_torch_inputs(tp), **kw)
    assert got[0].dtype == torch.float32
    _assert_features_equal(got[0].numpy(), want[0])
    if max_len:
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(got[2].numpy(), want[2])
    else:
        assert got[1] is None and got[2] is None and want[1] is None


@pytest.mark.parametrize("seed,max_len", [(3, 32), (4, 0)])
def test_plain_version_matches_jax_interpret_kernel(seed, max_len):
    cfg = CorpusConfig()
    pls = _page_batch(24, seed, vocab=cfg.vocab_size)
    tp = tops.pack_routing_batch(pls, max_len=max_len)
    kw = dict(KW, latex_lo=cfg.latex_lo, ident_lo=cfg.ident_lo)
    j = fast_features_kernel(
        *(jnp.asarray(a) for a in (tp.tok_matrix, tp.n_tok, tp.first_len,
                                   tp.n_pages, tp.n_empty)),
        max_len=max_len, block_l=256, interpret=True, **kw)
    got = fast_features_ref(*_torch_inputs(tp), max_len=max_len,
                            vocab_size=cfg.vocab_size, **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(j[0]), atol=1e-6)
    if max_len:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(j[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(j[2]))


@pytest.mark.parametrize("mode", ["auto", "host"])
@pytest.mark.parametrize("max_len", [None, 24])
def test_prepare_routing_inputs_modes_match_jax(mode, max_len):
    """Every CPU mode of the port equals the JAX package's legacy host
    pipeline; ``force`` insists on the CUDA kernel and so raises on the
    CPU; an unknown mode raises."""
    jcfg, tcfg = JCorpusConfig(), CorpusConfig()
    pls = _page_batch(30, 5, vocab=tcfg.vocab_size)
    hf, ht, hm = JF.prepare_routing_inputs(pls, jcfg, max_len=max_len,
                                           mode="host")
    f, t, m = TF.prepare_routing_inputs(pls, tcfg, max_len=max_len,
                                        mode=mode, device="cpu")
    assert f.device.type == "cpu"
    _assert_features_equal(f.numpy(), hf)
    if max_len is None:
        assert t is None and m is None
    else:
        np.testing.assert_array_equal(t.numpy(), ht)
        np.testing.assert_array_equal(m.numpy(), hm)
    with pytest.raises(ValueError, match="force"):
        TF.prepare_routing_inputs(pls, tcfg, max_len=max_len,
                                  mode="force", device="cpu")
    with pytest.raises(ValueError, match="feature_kernel"):
        TF.prepare_routing_inputs(pls, tcfg, mode="gpu", device="cpu")


def test_host_helpers_match_jax():
    cfg = CorpusConfig()
    pls = _page_batch(20, 9, vocab=cfg.vocab_size)
    np.testing.assert_array_equal(
        TF.batch_fast_features(pls, cfg),
        JF.batch_fast_features(pls, JCorpusConfig()))
    for a, b in zip(TF.batch_first_page_tokens(pls, 16),
                    JF.batch_first_page_tokens(pls, 16)):
        np.testing.assert_array_equal(a, b)
    for p in pls[:5]:
        for a, b in zip(TF.first_page_tokens(p, 16),
                        JF.first_page_tokens(p, 16)):
            np.testing.assert_array_equal(a, b)


def test_out_of_vocabulary_token_raises():
    """A valid token outside [0, vocab_size) is an error (the JAX oracle
    fails on it too); padding beyond n_tok is never inspected."""
    pls = [[np.array([5, 7, 12000], np.int32)]]
    tp = tops.pack_routing_batch(pls)
    ins = _torch_inputs(tp)
    with pytest.raises(ValueError, match="vocab"):
        tops.fast_features(*ins, max_len=0, latex_lo=8010, ident_lo=8510,
                           vocab_size=10000, **KW)
    ins[0][0, 3:] = 99999                     # garbage past the stream
    ins[0][0, 2] = 9
    fast, _, _ = tops.fast_features(*ins, max_len=0, latex_lo=8010,
                                    ident_lo=8510, vocab_size=10000, **KW)
    assert torch.isfinite(fast).all()


def test_default_device_is_cuda():
    """Without a device the entry point runs on cuda; on a host with no
    card that is an error, never a silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        TF.prepare_routing_inputs([[np.arange(3, dtype=np.int32)]],
                                  CorpusConfig())
