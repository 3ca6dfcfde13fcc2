"""The inits and dense layers of ``repro_torch.models.layers``
(``init_rms_norm``, ``init_layer_norm``, ``init_dense``, ``dense``,
``mlp_stack``, ``mlp_apply``, ``init_embedding``) against
``repro.models.layers`` on the CPU: shapes and dtypes with and without a
leading ``layers`` axis, the meta form (``abstract=True``) against the
reference's ``ShapeDtypeStruct``, the constant inits' values, the random
inits' spread, and ``dense`` / ``mlp_apply`` from the reference's
weights within 2e-5."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.common import KeyGen, unwrap
from repro.models import layers as JL
from repro_torch.models import layers as TL
from torch_cells_common import signature

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("abstract", [False, True])
@pytest.mark.parametrize("layers", [None, 3])
@pytest.mark.parametrize("jdt, tdt", DTYPES)
def test_norm_inits_match(jdt, tdt, layers, abstract):
    want = unwrap(JL.init_rms_norm(24, jdt, abstract, layers))
    got = TL.init_rms_norm(24, tdt, abstract, layers, device="cpu")
    assert signature(got) == signature(want) and got.is_meta == abstract
    wln = unwrap(JL.init_layer_norm(24, jdt, abstract, layers))
    gln = TL.init_layer_norm(24, tdt, abstract, layers, device="cpu")
    assert sorted(gln) == sorted(wln) == ["bias", "scale"]
    for k in gln:
        assert signature(gln[k]) == signature(wln[k])
        assert gln[k].is_meta == abstract
    if not abstract:
        for g, w in [(got, want), (gln["scale"], wln["scale"]),
                     (gln["bias"], wln["bias"])]:
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))


@pytest.mark.parametrize("abstract", [False, True])
@pytest.mark.parametrize("bias, layers, stddev", [
    (False, None, None), (True, None, None), (True, 2, None),
    (False, 2, 0.5)])
@pytest.mark.parametrize("jdt, tdt", DTYPES)
def test_init_dense_matches(jdt, tdt, bias, layers, stddev, abstract):
    key = None if abstract else jax.random.key(0)
    want = unwrap(JL.init_dense(key, 16, 8, ("d_model", "d_ff"), jdt,
                                abstract, bias=bias, layers=layers,
                                stddev=stddev))
    got = TL.init_dense(_gen(), 16, 8, ("d_model", "d_ff"), tdt, abstract,
                        bias=bias, layers=layers, stddev=stddev,
                        device="cpu")
    assert sorted(got) == sorted(want)
    for k in got:
        assert signature(got[k]) == signature(want[k]), k
        assert got[k].is_meta == abstract
    if bias and not abstract:
        assert not got["b"].any()


@pytest.mark.parametrize("layers, stddev", [(None, None), (4, None),
                                            (None, 0.02)])
def test_random_inits_spread_as_the_reference(layers, stddev):
    """Both draw normal(std) in float32: std = d_in ** -0.5 (LeCun on
    the fan-in axis, 1 with a leading layers axis) unless given; the
    sample stds agree within 3%."""
    want = unwrap(JL.init_dense(jax.random.key(1), 256, 192, (None, None),
                                jnp.float32, layers=layers, stddev=stddev))
    got = TL.init_dense(_gen(1), 256, 192, (None, None), torch.float32,
                        layers=layers, stddev=stddev, device="cpu")
    expect = stddev if stddev is not None else 256 ** -0.5
    for s in (float(np.std(np.asarray(want["w"]))), float(got["w"].std())):
        assert abs(s / expect - 1) < 0.03, (s, expect)
    we = np.asarray(JL.init_embedding(jax.random.key(2), 512, 96,
                                      jnp.float32).value)
    ge = TL.init_embedding(_gen(2), 512, 96, torch.float32, device="cpu")
    assert signature(ge) == signature(we)
    for s in (float(we.std()), float(ge.std())):
        assert abs(s / 0.02 - 1) < 0.03, s


@pytest.mark.parametrize("jdt, tdt", DTYPES)
def test_init_embedding_meta_matches(jdt, tdt):
    want = JL.init_embedding(None, 1000, 64, jdt, abstract=True).value
    got = TL.init_embedding(None, 1000, 64, tdt, abstract=True)
    assert got.is_meta and signature(got) == signature(want)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_dense_from_carried_weights(bias, lead):
    p = unwrap(JL.init_dense(jax.random.key(3), 12, 7, (None, None),
                             jnp.float32, bias=bias))
    if bias:
        p["b"] = jax.random.normal(jax.random.key(4), (7,), jnp.float32)
    x = np.random.RandomState(0).randn(*lead, 12).astype(np.float32)
    want = JL.dense(jnp.asarray(x), p, out_hint=("batch", "d_ff"))
    got = TL.dense(torch.from_numpy(x), {k: _tensor(v) for k, v in p.items()},
                   out_hint=("batch", "d_ff"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("abstract", [False, True])
def test_mlp_stack_matches(abstract):
    dims = [10, 32, 16, 1]
    want = unwrap(JL.mlp_stack(KeyGen(5), dims, jnp.bfloat16, abstract))
    got = TL.mlp_stack(_gen(5), dims, torch.bfloat16, abstract,
                       device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["b", "w"]
        for k in g:
            assert signature(g[k]) == signature(w[k])
            assert g[k].is_meta == abstract
    assert not TL.mlp_stack(_gen(), dims, torch.float32, bias=False,
                            device="cpu")[0].get("b")


@pytest.mark.parametrize("final", [None, "sigmoid"])
def test_mlp_apply_from_carried_weights(final):
    dims = [10, 32, 16, 3]
    want_p = unwrap(JL.mlp_stack(KeyGen(6), dims, jnp.float32))
    x = np.random.RandomState(1).randn(8, 10).astype(np.float32)
    jfin = jax.nn.sigmoid if final else None
    tfin = torch.sigmoid if final else None
    want = JL.mlp_apply(jnp.asarray(x), want_p, final_act=jfin)
    got = TL.mlp_apply(torch.from_numpy(x),
                       [{k: _tensor(v) for k, v in p.items()}
                        for p in want_p], act=F.relu, final_act=tfin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
