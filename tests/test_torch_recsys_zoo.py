"""The port's recsys zoo (DeepFM, AutoInt, DIEN beside DLRM), its
training and retrieval, and the ``embedding_bag`` backward against the
JAX package on the CPU.

Inputs are made by numpy from a seed; the JAX models' params (their
``init_recsys``, unwrapped to numpy) are carried across with
``recsys_from_jax_params``. On CPU tensors the lookup runs the kernels'
plain versions (the CUDA kernels are held against them in
``tests/test_torch_cuda.py``). Tolerances: the interaction ops within
2e-5 in float32 and 2e-2 in bfloat16 (another summation order, bf16
rounding); logits, loss and every gradient within 2e-5; the table
gradient in bf16 equal to XLA's scatter-add bit for bit (the same adds
in the same order); retrieval ids equal and scores within 2e-5; five
train steps and a resume from JAX's step-3 AdamW state within 2e-5 (loss
and params).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import unwrap
from repro.configs import get_config as j_get_config
from repro.launch import specs as JS
from repro.models.recsys import embedding as JE
from repro.models.recsys import interactions as JI
from repro.models.recsys import models as JM
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import _REGISTRY
from repro_torch.kernels.embedding_bag import ops
from repro_torch.launch import specs as TS
from repro_torch.launch import train
from repro_torch.models.recsys import embedding as TE
from repro_torch.models.recsys import interactions as TI
from repro_torch.models.recsys import models as TM

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ZOO = ["deepfm", "autoint", "dien"]
ALL = ZOO + ["dlrm-mlperf"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(a, dtype):
    """numpy values rounded to ``dtype`` once, as (jax, torch)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(dtype), t


def _tree(shapes, seed, dtype, scale=0.5):
    """A dict of random leaves of ``shapes`` as (jax tree, torch tree)."""
    rng = np.random.RandomState(seed)
    pairs = {k: _pair(rng.randn(*s) * scale, dtype)
             for k, s in shapes.items()}
    return ({k: j for k, (j, _) in pairs.items()},
            {k: t for k, (_, t) in pairs.items()})


def _cfgs(arch, dtype="float32"):
    jcfg = j_get_config(arch).reduced().model
    tcfg = get_config(arch).reduced().model
    assert repr(jcfg) == repr(tcfg)
    if dtype != "float32":
        jcfg = dataclasses.replace(jcfg, param_dtype=dtype,
                                   compute_dtype=dtype)
        tcfg = dataclasses.replace(tcfg, param_dtype=dtype,
                                   compute_dtype=dtype)
    return jcfg, tcfg


def _raw(jcfg, seed=3):
    return jax.tree_util.tree_map(np.asarray,
                                  unwrap(JM.init_recsys(jcfg, seed)))


def _batch(jcfg, b, seed, partial_mask=False):
    batch = JS._recsys_batch(jcfg, b, False, seed)
    if partial_mask:
        rng = np.random.RandomState(seed + 100)
        lens = rng.randint(1, jcfg.seq_len + 1, b)
        lens[0] = jcfg.seq_len
        mask = (np.arange(jcfg.seq_len)[None, :] < lens[:, None])
        batch["hist_mask"] = jnp.asarray(mask.astype(np.float32))
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_configs_copy_the_jax_configs(arch):
    ja, ta = j_get_config(arch), get_config(arch)
    assert repr(ja.model) == repr(ta.model)
    assert repr(ja.reduced().model) == repr(ta.reduced().model)
    assert repr(ja.shapes) == repr(ta.shapes) and ja.source == ta.source


def test_criteo_kaggle_table_rows():
    """DeepFM's and AutoInt's table: 33,763,877 rows, 33,764,352 once
    padded to 512 (0.675 GB at D = 10 and 1.08 GB at D = 16 in bf16)."""
    from repro_torch.configs.deepfm import CRITEO_KAGGLE_VOCAB

    offs, rows = TE.table_offsets(CRITEO_KAGGLE_VOCAB, 512)
    assert sum(CRITEO_KAGGLE_VOCAB) == 33_763_877 and rows == 33_764_352
    assert round(rows * 10 * 2 / 1e9, 3) == 0.675
    assert round(rows * 16 * 2 / 1e9, 2) == 1.08
    assert TE.table_offsets((367983, 1601), 512)[1] == 369_664


# ------------------------------------------------------------- interactions


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fm_interaction_matches_jax(dtype):
    jv, tv = _pair(np.random.RandomState(0).randn(6, 5, 8), dtype)
    got, want = TI.fm_interaction(tv), JI.fm_interaction(jv)
    assert got.dtype == tv.dtype and got.shape == (6,)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autoint_layer_matches_jax(dtype):
    jx, tx = _pair(np.random.RandomState(1).randn(4, 5, 8), dtype)
    jp, tp = _tree({"wq": (8, 2, 4), "wk": (8, 2, 4), "wv": (8, 2, 4),
                    "w_res": (8, 8)}, 2, dtype)
    got, want = TI.autoint_layer(tx, tp, 2), JI.autoint_layer(jx, jp, 2)
    assert got.dtype == tx.dtype and got.shape == (4, 5, 8)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _gru(d_in, h, seed, dtype):
    shapes = {}
    for g in "zrn":
        shapes.update({f"wx_{g}": (d_in, h), f"wh_{g}": (h, h),
                       f"b_{g}": (h,)})
    return _tree(shapes, seed, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_gru_scan_matches_jax(dtype, with_h0):
    jx, tx = _pair(np.random.RandomState(3).randn(4, 7, 6), dtype)
    jp, tp = _gru(6, 5, 4, dtype)
    jh, th = _pair(np.random.RandomState(5).randn(4, 5), dtype)
    want = JI.gru_scan(jx, jp, jh if with_h0 else None)
    for unroll in (False, True):
        got = TI.gru_scan(tx, tp, th if with_h0 else None, unroll=unroll)
        assert got.dtype == tx.dtype and got.shape == (4, 7, 5)
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_augru_scan_matches_jax(dtype, with_h0):
    """The AUGRU blends the other way round from the GRU: a wrong blend
    gives another final state."""
    jx, tx = _pair(np.random.RandomState(6).randn(4, 7, 5), dtype)
    ja, ta = _pair(np.random.RandomState(7).rand(4, 7), dtype)
    jp, tp = _gru(5, 5, 8, dtype)
    jh, th = _pair(np.random.RandomState(9).randn(4, 5), dtype)
    want = JI.augru_scan(jx, ja, jp, jh if with_h0 else None)
    got = TI.augru_scan(tx, ta, tp, th if with_h0 else None)
    assert got.dtype == tx.dtype and got.shape == (4, 5)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    gru_blend = TI.gru_scan(tx, tp, th if with_h0 else None)[:, -1]
    assert not np.allclose(_np(gru_blend), _np(want), atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_scores_matches_jax(dtype):
    jh, th = _pair(np.random.RandomState(10).randn(3, 6, 4), dtype)
    jt, tt = _pair(np.random.RandomState(11).randn(3, 4), dtype)
    jp, tp = _tree({"w1": (16, 64), "b1": (64,), "w2": (64, 1), "b2": (1,)},
                   12, dtype, scale=0.2)
    got = TI.attention_scores(th, tt, tp)
    want = JI.attention_scores(jh, jt, jp)
    assert got.shape == (3, 6)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_init_gru_draws_from_the_generator():
    p = TI.init_gru(torch.Generator().manual_seed(0), 6, 5, torch.bfloat16)
    assert sorted(p) == sorted(JI.init_gru(None, 6, 5, jnp.bfloat16,
                                           abstract=True))
    assert p["wx_z"].shape == (6, 5) and p["wh_n"].shape == (5, 5)
    assert p["wx_z"].dtype == torch.bfloat16 and not p["b_r"].any()
    again = TI.init_gru(torch.Generator().manual_seed(0), 6, 5,
                        torch.bfloat16)
    assert all(torch.equal(p[k], again[k]) for k in p)


# ------------------------------------------------------------- models


@pytest.mark.parametrize("arch,partial_mask", [
    ("deepfm", False), ("autoint", False), ("dien", False), ("dien", True),
    ("dlrm-mlperf", False)])
def test_logits_scores_loss_and_grads_match_jax(arch, partial_mask):
    """``recsys_logits``, ``recsys_scores``, ``recsys_loss`` and the
    gradient of every leaf within 2e-5 of the JAX functions and
    ``jax.value_and_grad(recsys_loss)``; the DIEN batch may mask part of
    each history."""
    jcfg, tcfg = _cfgs(arch)
    raw = _raw(jcfg)
    batch = _batch(jcfg, 16, 1, partial_mask)
    serve = {k: v for k, v in batch.items() if k != "labels"}
    params = TM.recsys_from_jax_params(raw, tcfg, "cpu")
    tb = _torch_batch(batch)
    np.testing.assert_allclose(
        _np(TM.recsys_logits(params, tcfg, tb)),
        _np(JM.recsys_logits(raw, jcfg, serve)), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        _np(TM.recsys_scores(params, tcfg, tb)),
        _np(JM.recsys_scores(raw, jcfg, serve)), atol=2e-5, rtol=2e-5)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.recsys_loss(p, jcfg, batch), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, raw))
    leaves = TS.recsys_param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = TM.recsys_loss(params, tcfg, tb)
    grads = torch.autograd.grad(loss, leaves)
    assert loss.dtype == torch.float32 and metrics["bce"] is loss
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=2e-5,
                               rtol=2e-5)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)
    assert any(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("arch", ALL)
def test_param_leaves_follow_jax_tree_order(arch):
    jcfg, tcfg = _cfgs(arch)
    raw = _raw(jcfg)
    jleaves = jax.tree_util.tree_leaves(raw)
    tleaves = TS.recsys_param_leaves(TM.recsys_from_jax_params(raw, tcfg,
                                                               "cpu"))
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("arch", ALL)
def test_init_recsys_has_the_jax_leaves(arch):
    """The port's random init has the JAX init's tree, shapes and
    dtypes; the checks of ``recsys_from_jax_params`` refuse a missing,
    extra or misshapen leaf."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    p = TM.init_recsys(tcfg, torch.Generator().manual_seed(0), "cpu")
    raw = _raw(jcfg)
    want = jax.tree_util.tree_leaves(raw)
    got = TS.recsys_param_leaves(p)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert all(t.dtype == torch.bfloat16 for t in got)
    assert abs(float(p["table"].float().std())
               - tcfg.embed_dim ** -0.5) < 0.05
    TM.recsys_from_jax_params(raw, tcfg, "cpu")
    with pytest.raises(ValueError, match="keys"):
        TM.recsys_from_jax_params(dict(raw, extra=raw["table"]), tcfg, "cpu")
    missing = {k: v for k, v in raw.items() if k != "table"}
    with pytest.raises(ValueError, match="keys"):
        TM.recsys_from_jax_params(missing, tcfg, "cpu")
    with pytest.raises(ValueError, match="shape"):
        TM.recsys_from_jax_params(dict(raw, table=raw["table"][:, :-1]),
                                  tcfg, "cpu")
    lists = [k for k, v in raw.items() if isinstance(v, list)]
    for k in lists:
        with pytest.raises(ValueError, match="layers"):
            TM.recsys_from_jax_params(dict(raw, **{k: raw[k][:-1]}), tcfg,
                                      "cpu")


def test_dien_gathers_are_one_lookup(monkeypatch):
    """DIEN's four takes into the shared table go through one lookup
    (one kernel launch each way on the card)."""
    jcfg, tcfg = _cfgs("dien")
    params = TM.recsys_from_jax_params(_raw(jcfg), tcfg, "cpu")
    calls = []
    real = ops.lookup
    monkeypatch.setattr(ops, "lookup",
                        lambda t, i: calls.append(i.shape) or real(t, i))
    TM.recsys_logits(params, tcfg, _torch_batch(_batch(jcfg, 5, 2)))
    assert calls == [(2 * 5 * jcfg.seq_len + 2 * 5,)]


# ------------------------------------------------------------- table grad


def _jax_table_grad(rows, ids, g, dtype):
    _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(ids), axis=0),
                     jnp.zeros((rows, g.shape[1]), dtype))
    return vjp(jnp.asarray(g.float().numpy()).astype(dtype))[0]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_table_gradient_equals_xla_scatter_add_bit_for_bit(dtype, id_dtype):
    """5 rows, 64 x 4 ids, most of them row 2, grads over six decades:
    ``embedding_bag_backward`` equals the transpose of ``jnp.take``
    bit for bit, where float32 accumulation rounded once would not.
    Wrapped ids join their row's run; ids outside [-5, 5) add nothing."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 5, (64, 4))
    ids[rng.rand(64, 4) < 0.7] = 2
    ids[0, 0], ids[1, 1], ids[2, 2], ids[3, 3] = -1, 7, -5, -6
    flat = ids.reshape(-1).astype(id_dtype)
    g = torch.from_numpy((rng.randn(256, 3) * np.exp(
        rng.randn(256, 1) * 3)).astype(np.float32)).to(getattr(torch, dtype))
    want = _np(_jax_table_grad(5, flat, g, dtype))
    got = ops.embedding_bag_backward(g, torch.from_numpy(flat), 5)
    assert got.dtype == g.dtype and got.shape == (5, 3)
    np.testing.assert_array_equal(_np(got), want)
    if dtype == "bfloat16":
        wrapped = np.where(flat < 0, flat + 5, flat)
        keep = (wrapped >= 0) & (wrapped < 5)
        once = torch.zeros(5, 3).index_add_(
            0, torch.from_numpy(wrapped[keep]).long(),
            g.float()[torch.from_numpy(keep)]).to(g.dtype)
        assert not np.array_equal(_np(once), want)


def test_lookup_fields_bf16_table_grad_equals_jax_bit_for_bit():
    """The same through ``lookup_fields``' autograd path: the gradient of
    a bf16 table reached by a duplicate-heavy batch."""
    vocab = (3, 2)
    offs, rows = TE.table_offsets(vocab, 512)
    jt, tt = _pair(np.random.RandomState(1).randn(rows, 4), "bfloat16")
    ids = np.stack([np.random.RandomState(2).randint(0, v, 300)
                    for v in vocab], 1).astype(np.int32)
    jw, tw = _pair(np.random.RandomState(3).randn(300, 2, 4) * 10,
                   "bfloat16")
    _, vjp = jax.vjp(lambda t: JE.lookup_fields(
        t, jnp.asarray(offs.astype(np.int32)), jnp.asarray(ids)), jt)
    want = vjp(jw)[0]
    tt.requires_grad_(True)
    out = TE.lookup_fields(tt, torch.from_numpy(offs),
                           torch.from_numpy(ids))
    (got,) = torch.autograd.grad(out, tt, tw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


def test_embedding_bag_backward_edges():
    g = torch.randn(0, 4)
    out = ops.embedding_bag_backward(g, torch.zeros(0, dtype=torch.int64), 6)
    assert out.shape == (6, 4) and not out.any()
    g = torch.randn(3, 4)
    out = ops.embedding_bag_backward(
        g, torch.tensor([9, -9, 6], dtype=torch.int32), 6)
    assert not out.any()                    # every id dropped
    with pytest.raises(ValueError, match=r"\(N,\)"):
        ops.embedding_bag_backward(g, torch.zeros(3, 1, dtype=torch.int64), 6)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.embedding_bag_backward(g.double(),
                                   torch.zeros(3, dtype=torch.int64), 6)
    with pytest.raises(ValueError, match="N = 3"):
        ops.embedding_bag_backward(g, torch.zeros(2, dtype=torch.int64), 6)
    with pytest.raises(ValueError, match=r"\(N,\)"):
        ops.lookup(torch.zeros(6, 4), torch.zeros(3, 1, dtype=torch.int64))


# ------------------------------------------------------------- retrieval


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 100, 10_000])
def test_recsys_retrieval_matches_jax(dtype, offset):
    """Ids equal and scores within 2e-5 of ``recsys_retrieval``, with
    tied rows (duplicated, so their bf16 scores tie exactly) and a
    ``cand_offset`` past R - n_cand, which both clamp."""
    jcfg, tcfg = _cfgs("deepfm", dtype)
    raw = _raw(jcfg)
    table = np.array(raw["table"], np.float32)
    table[150:170] = table[140]
    table[300:310] = 0.0
    raw["table"] = jnp.asarray(table).astype(dtype)
    q = np.random.RandomState(4).randn(2, tcfg.embed_dim).astype(np.float32)
    batch = {"user_query": q, "n_candidates": 300, "cand_offset": offset}
    wv, wi = JM.recsys_retrieval(raw, jcfg, batch, k=40)
    params = TM.recsys_from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                              raw),
                                       tcfg, "cpu")
    gv, gi = TM.recsys_retrieval(
        params, tcfg, dict(batch, user_query=torch.from_numpy(q)), k=40)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(_np(gv), _np(wv), atol=2e-5, rtol=2e-5)


def test_retrieval_step_copies_the_cell():
    """n_cand = min(n_candidates, rows) over the unpadded rows and
    k = min(100, n_cand), as ``_recsys_cell``'s retrieval branch sets
    them; the query is its seeded draw."""
    for arch in ("dien", "deepfm"):
        for reduced in (False, True):
            ja, ta = j_get_config(arch), get_config(arch)
            if reduced:
                ja, ta = ja.reduced(), ta.reduced()
            shape = ta.shape("retrieval_cand")
            if reduced:
                shape = TS._reduce_shape("recsys", shape)
            _, n = TS.recsys_retrieval_step(ta.model, shape)
            cell = JS.build_cell(arch, "retrieval_cand", abstract=True,
                                 reduced=reduced)
            assert cell.note == f"n_cand={n}"
    assert TS.recsys_retrieval_step(get_config("dien").model, get_config(
        "dien").shape("retrieval_cand"))[1] == 369_584
    jarch = j_get_config("deepfm").reduced()
    want = JS._recsys_cell(jarch, JS._reduce_shape(
        "recsys", jarch.shape("retrieval_cand")), None, False, seed=5)
    got = TS._retrieval_query(get_config("deepfm").reduced().model, 1, 5,
                              "cpu")
    np.testing.assert_array_equal(got["user_query"].numpy(),
                                  np.asarray(want.args[1]["user_query"]))


def test_reduce_shape_recsys_copies_the_jax_branch():
    """The recsys branch, every registered arch's shapes under its own
    family, and a family the JAX function has no branch for (the shape
    comes back unchanged), all equal to the JAX function's."""
    for name in ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"):
        want = JS._reduce_shape("recsys", j_get_config("deepfm").shape(name))
        got = TS._reduce_shape("recsys", get_config("deepfm").shape(name))
        assert repr(got) == repr(want)
    for arch in sorted(_REGISTRY):
        for s in get_config(arch).shapes:
            fam = get_config(arch).family
            want = JS._reduce_shape(fam, j_get_config(arch).shape(s.name))
            assert repr(TS._reduce_shape(fam, s)) == repr(want), (arch, s)
    shape = get_config("deepfm").shape("train_batch")
    assert repr(TS._reduce_shape("unknown-family", shape)) == repr(shape) \
        == repr(JS._reduce_shape("unknown-family", j_get_config(
            "deepfm").shape("train_batch")))


# ------------------------------------------------------------- training


STEPS = 6


@pytest.fixture(scope="module", params=["deepfm", "dien"])
def jax_run(request):
    """The reference's reduced train cell (its seed-0 init, AdamW with
    clipping from ``_optimizer_for``), ``STEPS`` steps of batches from
    seeds 1.. as ``launch/train.py`` draws them: the losses, the params
    after each step and the optimizer state after 3."""
    jarch = j_get_config(request.param).reduced()
    shape = JS._reduce_shape("recsys", jarch.shape("train_batch"))
    cell = JS._recsys_cell(jarch, shape, None, False, seed=0)
    params, opt_state = cell.args[0], cell.args[1]
    step_fn = jax.jit(cell.fn)
    out = {"arch": request.param, "init": jax.tree_util.tree_map(
        np.asarray, params), "losses": [], "params": [],
        "b": shape["batch"]}
    for step in range(STEPS):
        batch = JS._recsys_batch(jarch.model, shape["batch"], False,
                                 step + 1)
        params, opt_state, loss = step_fn(params, opt_state,
                                          jnp.asarray(step, jnp.int32), batch)
        out["losses"].append(float(loss))
        out["params"].append(jax.tree_util.tree_map(np.asarray, params))
        if step == 2:
            out["state3"] = jax.tree_util.tree_map(np.asarray, opt_state)
    return out


def _port_steps(run, params, opt_state, steps):
    tarch = get_config(run["arch"]).reduced()
    step_fn = TS.recsys_train_step(tarch.model, TS._optimizer_for(tarch)[0])
    losses = []
    for step in steps:
        batch = TS._recsys_batch(tarch.model, run["b"], step + 1, "cpu")
        params, opt_state, loss = step_fn(params, opt_state, step, batch)
        losses.append(float(loss))
    return params, opt_state, losses


def _assert_params_close(tparams, jparams):
    jleaves = jax.tree_util.tree_leaves(jparams)
    tleaves = TS.recsys_param_leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_allclose(t.numpy(), j, atol=2e-5, rtol=0)


def test_train_steps_match_jax_cell(jax_run):
    tcfg = get_config(jax_run["arch"]).reduced().model
    params = TM.recsys_from_jax_params(jax_run["init"], tcfg, "cpu")
    opt = TS._optimizer_for(get_config(jax_run["arch"]).reduced())[0]
    state = opt.init(TS.recsys_param_leaves(params))
    params, _, losses = _port_steps(jax_run, params, state, range(5))
    np.testing.assert_allclose(losses, jax_run["losses"][:5], atol=2e-5,
                               rtol=2e-5)
    _assert_params_close(params, jax_run["params"][4])


def test_resume_from_jax_state(jax_run):
    """JAX's params and AdamW state after 3 steps carried across
    (``recsys_from_jax_params``, ``opt_state_from_jax``); the port's
    steps 3-5 match the JAX run's."""
    tcfg = get_config(jax_run["arch"]).reduced().model
    params = TM.recsys_from_jax_params(jax_run["params"][2], tcfg, "cpu")
    state = TS.opt_state_from_jax(jax_run["state3"], params, "adamw")
    params, _, losses = _port_steps(jax_run, params, state, range(3, 6))
    np.testing.assert_allclose(losses, jax_run["losses"][3:], atol=2e-5,
                               rtol=2e-5)
    _assert_params_close(params, jax_run["params"][5])


def _main(arch, *extra):
    return train.main(["--arch", arch, "--shape", "train_batch",
                       "--reduced", "--log-every", "100", "--device", "cpu",
                       *extra])


@pytest.mark.parametrize("arch", ["deepfm", "dien"])
def test_train_cli_restart_is_bit_exact(tmp_path, arch):
    """6 steps against 3 steps, a checkpoint and a resume to 6: equal
    losses, params and optimizer state, bit for bit."""
    full = _main(arch, "--steps", "6", "--ckpt-dir", str(tmp_path / "full"),
                 "--ckpt-every", "100")
    part = _main(arch, "--steps", "3", "--ckpt-dir", str(tmp_path / "ck"),
                 "--ckpt-every", "3")
    resumed = _main(arch, "--steps", "6", "--ckpt-dir", str(tmp_path / "ck"),
                    "--ckpt-every", "100")
    assert len(full) == 6 and part == full[:3] and resumed == full[3:]
    assert all(np.isfinite(full))
    (sa, a, _), (sb, b, _) = (ckpt.restore(tmp_path / d, device="cpu")
                              for d in ("full", "ck"))
    assert sa == sb == 6
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert torch.equal(x, y), path


def test_train_cli_refuses_what_the_port_does_not_train():
    with pytest.raises(NotImplementedError, match="13e"):
        _main("deepfm", "--steps", "1", "--shape", "serve_p99")
