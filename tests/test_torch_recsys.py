"""The port's DLRM serve path (``repro_torch.models.recsys``) and its
``embedding_bag`` op (the other recsys kinds, training and retrieval are
in ``tests/test_torch_recsys_zoo.py``) against the JAX package on the CPU.

The JAX DLRM's params (``init_recsys``, unwrapped to numpy) are carried
across with ``recsys_from_jax_params``; batches come from the JAX
``_recsys_batch`` and its copy in the port. On CPU tensors
``ops.embedding_bag`` runs the plain version; the CUDA kernel is held
against it in ``tests/test_torch_cuda.py``. Tolerances: the field lookup
is exact (bags of one, weight 1); DLRM scores within 2e-5 in float32 and
2e-2 in bfloat16 (another summation order, bf16 rounding); the plain
mirrors within 2e-5 (f32) and 2e-2 (bf16); the embedding_bag op within
the JAX kernel test's ``TOL`` (2e-5 f32, 2e-2 bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import unwrap
from repro.configs import get_config as j_get_config
from repro.kernels.embedding_bag.kernel import embedding_bag_kernel
from repro.kernels.embedding_bag.ref import embedding_bag_ref as j_bag_ref
from repro.launch.specs import _recsys_batch as j_recsys_batch
from repro.models.recsys import embedding as JE
from repro.models.recsys import interactions as JI
from repro.models.recsys import models as JM
from repro_torch.configs import get_config
from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.launch.specs import _recsys_batch
from repro_torch.models.recsys import embedding as TE
from repro_torch.models.recsys import interactions as TI
from repro_torch.models.recsys import models as TM

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _table(r, d, dtype, seed=0):
    """numpy values rounded to ``dtype`` once, as (jax, torch)."""
    t = torch.from_numpy(np.random.RandomState(seed).randn(r, d)
                         .astype(np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(dtype), t


def _tiny(dtype="float32"):
    jcfg = j_get_config("dlrm-mlperf").reduced().model
    tcfg = get_config("dlrm-mlperf").reduced().model
    assert repr(jcfg) == repr(tcfg)
    if dtype != "float32":
        jcfg = dataclasses.replace(jcfg, param_dtype=dtype,
                                   compute_dtype=dtype)
        tcfg = dataclasses.replace(tcfg, param_dtype=dtype,
                                   compute_dtype=dtype)
    return jcfg, tcfg


# ------------------------------------------------------------- configs


def test_dlrm_config_copies_the_jax_config_at_full_width():
    jcfg = j_get_config("dlrm-mlperf").model
    tcfg = get_config("dlrm-mlperf").model
    assert repr(jcfg) == repr(tcfg)
    assert tcfg.table_rows() == 187_767_399
    offs, rows = TE.table_offsets(tcfg.vocab_sizes, 512)
    j_offs, j_rows = JE.table_offsets(jcfg.vocab_sizes, 512)
    np.testing.assert_array_equal(offs, j_offs)
    assert rows == j_rows == 187_767_808
    # the table's size in bf16 (the docstring's 48.07 GB) and in fp32
    assert round(rows * tcfg.embed_dim * 2 / 1e9, 2) == 48.07
    assert round(rows * tcfg.embed_dim * 4 / 1e9, 2) == 96.14


def test_recsys_and_gnn_shapes_copy_the_jax_shapes():
    from repro.configs.base import GNN_SHAPES as JG
    from repro.configs.base import RECSYS_SHAPES as JR
    from repro_torch.configs.base import GNN_SHAPES, RECSYS_SHAPES

    assert repr(JG) == repr(GNN_SHAPES) and repr(JR) == repr(RECSYS_SHAPES)


@pytest.mark.parametrize("arch,b,seed", [("dlrm-mlperf", 64, 0),
                                         ("dlrm-mlperf", 33, 5)])
def test_recsys_batch_copy_equals_jax(arch, b, seed):
    for reduced in (False, True):
        jcfg = j_get_config(arch)
        tcfg = get_config(arch)
        if reduced:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        want = j_recsys_batch(jcfg.model, b, False, seed)
        got = _recsys_batch(tcfg.model, b, seed, device="cpu")
        assert set(got) == set(want)
        for k in want:
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_recsys_batch_copy_equals_jax_for_dien():
    """The history branch, on each package's own DIEN config."""
    cfg = j_get_config("dien").reduced().model
    tcfg = get_config("dien").reduced().model
    assert repr(cfg) == repr(tcfg)
    want = j_recsys_batch(cfg, 24, False, 2)
    got = _recsys_batch(tcfg, 24, 2, device="cpu")
    assert set(got) == set(want) and "hist_cat" in got
    for k in want:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------------------------------------- embedding


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lookup_fields_matches_jax_exactly(dtype):
    vocab = (100, 50, 200, 30)
    offs, rows = TE.table_offsets(vocab, 512)
    jt, tt = _table(rows, 8, dtype)
    ids = np.stack([np.random.RandomState(i).randint(0, v, 40)
                    for i, v in enumerate(vocab)], 1).astype(np.int32)
    want = JE.lookup_fields(jt, jnp.asarray(offs.astype(np.int32)),
                            jnp.asarray(ids))
    got = TE.lookup_fields(tt, torch.from_numpy(offs),
                           torch.from_numpy(ids))
    assert got.dtype == tt.dtype and got.shape == (40, 4, 8)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_init_table_draws_in_place_with_the_jax_shape_and_scale():
    g = torch.Generator().manual_seed(0)
    table, offs = TE.init_table((100, 50, 200, 30), 8, torch.bfloat16, g,
                                "cpu")
    assert table.shape == (512, 8) and table.dtype == torch.bfloat16
    np.testing.assert_array_equal(offs.numpy(), [0, 100, 150, 350])
    assert abs(float(table.float().std()) - 8 ** -0.5) < 0.03
    again, _ = TE.init_table((100, 50, 200, 30), 8, torch.bfloat16,
                             torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(table, again)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("mask", [None, "float32", "bool"])
def test_embedding_bag_mirror_matches_jax(dtype, combiner, mask):
    jt, tt = _table(60, 8, dtype, seed=1)
    rng = np.random.RandomState(2)
    ids = rng.randint(-60, 70, (9, 5)).astype(np.int32)   # wrap + NaN rows
    ids[:4] = np.abs(ids[:4]) % 60
    m = None
    if mask is not None:
        m = (rng.rand(9, 5) < 0.6).astype(mask)
        m[0] = 0                                           # an empty bag
    want = JE.embedding_bag(jt, jnp.asarray(ids),
                            None if m is None else jnp.asarray(m), combiner)
    got = TE.embedding_bag(tt, torch.from_numpy(ids),
                           None if m is None else torch.from_numpy(m),
                           combiner)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_ragged_mirror_matches_jax(dtype, combiner, weighted):
    jt, tt = _table(50, 6, dtype, seed=3)
    rng = np.random.RandomState(4)
    flat = rng.randint(0, 50, 40).astype(np.int32)
    bags = np.sort(rng.randint(-1, 9, 40)).astype(np.int32)   # -1, 8: dropped
    w = rng.rand(40).astype(np.float32) if weighted else None
    want = JE.embedding_bag_ragged(jt, jnp.asarray(flat), jnp.asarray(bags),
                                   8, None if w is None else jnp.asarray(w),
                                   combiner)
    got = TE.embedding_bag_ragged(tt, torch.from_numpy(flat),
                                  torch.from_numpy(bags), 8,
                                  None if w is None else torch.from_numpy(w),
                                  combiner)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_retrieval_topk_matches_lax_top_k_order():
    rng = np.random.RandomState(5)
    q = rng.randn(3, 4).astype(np.float32)
    items = rng.randn(40, 4).astype(np.float32)
    items[10:20] = items[0]            # exact ties: lower id first
    items[30] = 0.0                    # a zero score
    want_v, want_i = JE.retrieval_topk(jnp.asarray(q), jnp.asarray(items),
                                       k=15)
    got_v, got_i = TE.retrieval_topk(torch.from_numpy(q),
                                     torch.from_numpy(items), k=15)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("keep_self", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_interaction_matches_jax(keep_self, dtype):
    jv, tv = _table(6 * 7, 16, dtype, seed=6)
    jv, tv = jv.reshape(6, 7, 16), tv.reshape(6, 7, 16)
    want = JI.dot_interaction(jv, keep_self)
    got = TI.dot_interaction(tv, keep_self)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


# ------------------------------------------------------------- the op


# the grid of tests/test_kernels.py::test_embedding_bag_sweep
BAG_GRID = [(500, 16, 32, 8, "sum"), (1000, 8, 50, 5, "mean"),
            (64, 4, 7, 3, "sum")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,d,b,bag,comb", BAG_GRID)
def test_embedding_bag_op_matches_jax_kernel(r, d, b, bag, comb, dtype):
    """The JAX Pallas kernel in interpret mode, and its oracle."""
    jt, tt = _table(r, d, dtype, seed=r)
    rng = np.random.RandomState(b)
    ids = rng.randint(0, r, (b, bag)).astype(np.int32)
    w = rng.rand(b, bag).astype(np.float32)
    want_k = embedding_bag_kernel(jt, jnp.asarray(ids), jnp.asarray(w),
                                  combiner=comb, interpret=True)
    want_r = j_bag_ref(jt, jnp.asarray(ids), jnp.asarray(w), combiner=comb)
    got = ops.embedding_bag(tt, torch.from_numpy(ids), torch.from_numpy(w),
                            combiner=comb)
    assert got.dtype == tt.dtype and got.shape == (b, d)
    for want in (want_k, want_r):
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                                   rtol=TOL[dtype])
    # int64 ids and weights=None (ones) through the same op
    ones = ops.embedding_bag(tt, torch.from_numpy(ids).long(), None,
                             combiner=comb)
    want_1 = j_bag_ref(jt, jnp.asarray(ids), jnp.ones((b, bag)),
                       combiner=comb)
    np.testing.assert_allclose(_np(ones), _np(want_1), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_embedding_bag_out_of_range_ids_follow_the_oracle():
    """jnp.take: an id >= R (or < -R) gives a NaN bag and a negative id
    counts from the end. The JAX kernel (interpret mode) clamps instead:
    with table (5, 4) and bag [0, 7] it returns t[0] + t[4]."""
    jt, tt = _table(5, 4, "float32", seed=7)
    ids = np.array([[0, 7], [0, -1], [-6, 1], [2, 3]], np.int32)
    w = np.ones((4, 2), np.float32)
    want = _np(j_bag_ref(jt, jnp.asarray(ids), jnp.asarray(w)))
    got = _np(ops.embedding_bag(tt, torch.from_numpy(ids),
                                torch.from_numpy(w)))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[0]).all() and np.isnan(got[2]).all()
    t = tt.numpy()
    np.testing.assert_array_equal(got[1], t[0] + t[4])
    clamp = _np(embedding_bag_kernel(jt, jnp.asarray(ids), jnp.asarray(w),
                                     interpret=True))
    np.testing.assert_array_equal(clamp[0], t[0] + t[4])


def test_embedding_bag_ref_mean_guards_an_all_zero_weight_bag():
    _, tt = _table(10, 4, "float32", seed=8)
    ids = torch.tensor([[1, 2], [3, 4]])
    w = torch.tensor([[0.0, 0.0], [0.5, 1.5]])
    out = embedding_bag_ref(tt, ids, w, combiner="mean")
    assert torch.equal(out[0], torch.zeros(4))
    torch.testing.assert_close(out[1], (0.5 * tt[3] + 1.5 * tt[4]) / 2.0)


def test_embedding_bag_op_refuses_what_it_does_not_take():
    t = torch.zeros(10, 4)
    ids = torch.zeros(3, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="combiner"):
        ops.embedding_bag(t, ids, combiner="max")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.embedding_bag(t.half(), ids)
    with pytest.raises(ValueError, match="int32 or int64"):
        ops.embedding_bag(t, ids.float())
    with pytest.raises(ValueError, match=r"\(B, L\)"):
        ops.embedding_bag(t, ids[0])
    with pytest.raises(ValueError, match="weights"):
        ops.embedding_bag(t, ids, torch.ones(3, 3))
    with pytest.raises(ValueError, match="weights"):
        ops.embedding_bag(t, ids, torch.ones(3, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="one device"):
        ops.embedding_bag(t, ids.to("meta"))


# ------------------------------------------------------------- DLRM


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dlrm_scores_match_jax(dtype):
    jcfg, tcfg = _tiny(dtype)
    raw = jax.tree_util.tree_map(np.asarray, unwrap(JM.init_recsys(jcfg, 3)))
    params = TM.recsys_from_jax_params(raw, tcfg, "cpu")
    assert params["table"].dtype == getattr(torch, dtype)
    batch = j_recsys_batch(jcfg, 64, False, 1)
    jb = {k: v for k, v in batch.items() if k != "labels"}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    want = JM.recsys_scores(raw, jcfg, jb)
    got = TM.recsys_scores(params, tcfg, tb)
    assert got.dtype == torch.float32 and got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(
        _np(TM.recsys_logits(params, tcfg, tb)),
        _np(JM.recsys_logits(raw, jcfg, jb)), atol=TOL[dtype],
        rtol=TOL[dtype])


def test_dlrm_init_and_param_checks():
    _, tcfg = _tiny()
    p = TM.init_recsys(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert p["table"].shape == (512, 8)
    assert [tuple(l["w"].shape) for l in p["bot"]] == [(5, 16), (16, 8)]
    assert [tuple(l["w"].shape) for l in p["top"]] == [(18, 32), (32, 16),
                                                       (16, 1)]
    batch = _recsys_batch(tcfg, 16, 0, device="cpu")
    s = TM.recsys_scores(p, tcfg, batch)
    assert bool(((s > 0) & (s < 1)).all())
    raw = jax.tree_util.tree_map(
        np.asarray, unwrap(JM.init_recsys(_tiny()[0], 0)))
    bad = dict(raw, top=raw["top"][:-1])
    with pytest.raises(ValueError, match="layers"):
        TM.recsys_from_jax_params(bad, tcfg, "cpu")
    bad = dict(raw, table=raw["table"][:-1])
    with pytest.raises(ValueError, match="table"):
        TM.recsys_from_jax_params(bad, tcfg, "cpu")
    wide = RecsysConfig(name="wide", kind="wide-and-deep", n_dense=0,
                        n_sparse=2, embed_dim=4, vocab_sizes=(5, 6),
                        mlp=(8,))
    with pytest.raises(ValueError, match="unknown recsys kind"):
        TM.init_recsys(wide, torch.Generator(), "cpu")
