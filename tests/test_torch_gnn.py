"""The port's EquiformerV2 slice (``repro_torch.models.gnn.so3``,
``sampler``, ``equiformer``, the GNN train cells of ``launch/specs.py``
and ``launch/train.py``) and ``ops.segment_sum`` against the JAX package
on the CPU.

Inputs are made by numpy from a seed (or are the JAX cell's own batches
and params, unwrapped to numpy) and handed to both packages. On CPU
tensors the gathers and segment sums run the ``embedding_bag`` kernels'
plain versions (the CUDA kernels are held against them in
``tests/test_torch_cuda.py``). Tolerances: 2e-5 in float32 (another
summation order; the JAX package's own f32 ``eq-tiny`` forward is 4.4e-6
from float64 at an output scale of 2.1) and 2e-2 of the largest magnitude
in bfloat16 (bf16 rounding at other points of a product); the sampler's
arrays, the batches, the pinv constants and the bf16 segment sums equal
bit for bit; rotation invariance within 5e-5 (the JAX test's bar).
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
from repro.models.gnn import equiformer as JEq
from repro.models.gnn import sampler as JSa
from repro.models.gnn import so3 as JSo3
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import round_up
from repro_torch.kernels.embedding_bag import ops
from repro_torch.launch import specs as TS
from repro_torch.launch import train
from repro_torch.models.gnn import equiformer as TEq
from repro_torch.models.gnn import sampler as TSa
from repro_torch.models.gnn import so3 as TSo3

ARCH = "equiformer-v2"
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(a, dtype):
    """numpy values rounded to ``dtype`` once, as (jax, torch)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(dtype), t


def _close(got, want, dtype, what=""):
    """Within 2e-5 (f32), or 2e-2 of the largest magnitude (bf16)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = 1.0 if dtype == "float32" else max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= TOL[dtype] * scale, f"{what}: {err} (scale {scale})"


def _rotation(seed):
    q, _ = np.linalg.qr(np.random.RandomState(seed).randn(3, 3))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


def _cell_cfgs(shape_name, layers=None, dtype="float32"):
    """The reduced cell's model config in both packages (the dataset's
    d_in and n_out), optionally with another depth and dtype."""
    tarch = get_config(ARCH).reduced()
    shape = TS._reduce_shape("gnn", tarch.shape(shape_name))
    tcfg = TS.gnn_cell_config(tarch, shape)
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced().model,
                               d_in=tcfg.d_in, n_out=tcfg.n_out)
    kw = {"param_dtype": dtype, "compute_dtype": dtype}
    if layers is not None:
        kw["n_layers"] = layers
    return (dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw),
            shape)


def _jax_batch(batch):
    return {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
                else v) for k, v in batch.items()}


def _jax_fn(fn, cfg, batch):
    """``fn(params, cfg, batch)`` of the JAX package as one jitted
    function of the params (one compile, not one per eager op)."""
    return jax.jit(lambda p: fn(p, cfg, batch))


def _models(shape_name, layers=None, dtype="float32", seed=3):
    """(jcfg, tcfg, JAX params, port params, port batch, JAX batch) of
    the reduced cell, the port's params carried from JAX's init."""
    jcfg, tcfg, shape = _cell_cfgs(shape_name, layers, dtype)
    jp = unwrap(JEq.init_equiformer(jcfg, seed))
    tp = TEq.equiformer_from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                               jp),
                                        tcfg, "cpu")
    tb = TS._gnn_batch(shape, 1, "cpu")
    return jcfg, tcfg, jp, tp, tb, _jax_batch(tb)


# ------------------------------------------------------------- configs


def test_config_copies_the_jax_config():
    ja, ta = j_get_config(ARCH), get_config(ARCH)
    assert repr(ja.model) == repr(ta.model)
    assert repr(ja.reduced().model) == repr(ta.reduced().model)
    assert repr(ja.shapes) == repr(ta.shapes) and ja.source == ta.source
    assert ta.family == "gnn" and ta.model.n_coeff == ja.model.n_coeff == 29
    assert ta.reduced().model.n_coeff == ja.reduced().model.n_coeff == 14
    for a, b in [(2708, 512), (61_859_140, 512), (1024, 512), (0, 512)]:
        from repro.common import round_up as j_round_up
        assert round_up(a, b) == j_round_up(a, b)


@pytest.mark.parametrize("name", SHAPES)
def test_reduce_shape_and_dims_copy_the_jax_cell(name):
    for reduced in (False, True):
        jshape = j_get_config(ARCH).shape(name)
        tshape = get_config(ARCH).shape(name)
        if reduced:
            jshape = JS._reduce_shape("gnn", jshape)
            tshape = TS._reduce_shape("gnn", tshape)
        assert repr(tshape) == repr(jshape)
        assert TS._gnn_dims(tshape) == JS._gnn_dims(jshape)
    assert TS.GNN_DATASETS == JS.GNN_DATASETS


def test_full_width_param_count_and_one_card_reckoning():
    """72.57 M params at Reddit's d_in; minibatch_lg's node state 2.13
    GB; ogb_products refused: a 776 GB edge tensor."""
    arch = get_config(ARCH)
    cfg = TS.gnn_cell_config(arch, arch.shape("minibatch_lg"))
    n = TEq.equiformer_param_count(cfg)
    jn = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        unwrap(JEq.init_equiformer(j_get_config(ARCH).model.__class__(
            **dataclasses.asdict(cfg)), abstract=True))))
    assert n == jn == 72_574_848
    b = TS.gnn_one_card_bytes(cfg, arch.shape("minibatch_lg"))
    assert (b["n_nodes"], b["n_edges"]) == (169_984, 168_960)
    assert round(b["node_state"] / 1e9, 2) == 2.13
    assert TS.gnn_refusal(cfg, arch.shape("minibatch_lg")) is None
    shp = arch.shape("ogb_products")
    why = TS.gnn_refusal(TS.gnn_cell_config(arch, shp), shp)
    assert "776 GB" in why and "30.7 GB" in why and "13e" in why
    with pytest.raises(ValueError, match="776 GB"):
        train.main(["--arch", ARCH, "--shape", "ogb_products", "--steps",
                    "1", "--device", "cpu"])


# ------------------------------------------------------------- so3


@pytest.mark.parametrize("l_max", [3, 6])
def test_sample_pinvs_equal_bit_for_bit(l_max):
    jp, jpinv = JSo3._sample_pinvs(l_max)
    tp, tpinv = TSo3._sample_pinvs(l_max)
    assert np.array_equal(jp, tp) and len(jpinv) == len(tpinv) == l_max + 1
    for a, b in zip(jpinv, tpinv):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_real_sph_harm_matches_jax():
    u = np.random.RandomState(0).randn(40, 3)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    u[0] = [0, 0, 1]                        # the poles
    u[1] = [0, 0, -1]
    got = TSo3.real_sph_harm(_t(u.astype(np.float32)), 6)
    want = JSo3.real_sph_harm(jnp.asarray(u, jnp.float32), 6)
    assert got.shape == (40, 49) and got.dtype == torch.float32
    _close(got, want, "float32")
    # the numpy path (the host precompute) is the reference's bit for bit
    assert np.array_equal(TSo3.real_sph_harm(u, 6, xp=np),
                          JSo3.real_sph_harm(u, 6, xp=np))


def test_wigner_matches_jax_and_represents_rotations():
    """Y(R u) = D(R) Y(u) and D D^T = I (the JAX test's 5e-6), and D
    within 2e-5 of the JAX matrices, for a batch of rotations."""
    rots = np.stack([_rotation(s) for s in range(4)])
    d = TSo3.wigner_from_rotation(_t(rots), 4)
    dj = JSo3.wigner_from_rotation(jnp.asarray(rots), 4)
    u = np.random.RandomState(2).randn(20, 3).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    yu = TSo3.real_sph_harm(_t(u), 4)
    for i in range(len(rots)):
        yru = TSo3.real_sph_harm(_t(u @ rots[i].T), 4)
        for l in range(5):
            _close(d[l], dj[l], "float32", f"D_{l}")
            sl = slice(l * l, (l + 1) ** 2)
            rhs = torch.einsum("nm,km->kn", d[l][i], yu[:, sl])
            np.testing.assert_allclose(yru[:, sl].numpy(), rhs.numpy(),
                                       atol=5e-6)
            np.testing.assert_allclose((d[l][i] @ d[l][i].T).numpy(),
                                       np.eye(2 * l + 1), atol=5e-6)


def test_align_to_z_edge_cases_match_jax():
    """A generic direction, +z, an exact and a nearly antiparallel one
    (the flip about x) and a zero vector (the identity)."""
    g = np.random.RandomState(4).randn(3)
    v = np.array([g / np.linalg.norm(g), [0, 0, 1], [0, 0, -1],
                  [1e-4, 0, -np.sqrt(1 - 1e-8)], [0, 0, 0]], np.float32)
    got = TSo3.align_to_z(_t(v))
    want = JSo3.align_to_z(jnp.asarray(v))
    _close(got, want, "float32")
    z = (got @ _t(v)[..., None])[..., 0].numpy()
    np.testing.assert_allclose(z[:3], [[0, 0, 1]] * 3, atol=2e-5)
    for i in (2, 3):                        # within 1e-6 of -z: the flip
        np.testing.assert_array_equal(got[i].numpy(), np.diag([1, -1, -1]))
    np.testing.assert_array_equal(got[4].numpy(), np.eye(3))


@pytest.mark.parametrize("l_max,m_max", [(3, 2), (6, 2), (4, 4), (2, 0)])
def test_trunc_indices_and_block_rotate_match_jax(l_max, m_max):
    for a, b in zip(TSo3.trunc_indices(l_max, m_max),
                    JSo3.trunc_indices(l_max, m_max)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rots = np.stack([_rotation(s) for s in range(3)])
    wig = TSo3.wigner_from_rotation(_t(rots), l_max)
    jwig = JSo3.wigner_from_rotation(jnp.asarray(rots), l_max)
    x = np.random.RandomState(l_max).randn(3, (l_max + 1) ** 2, 5)
    for tr in (False, True):
        _close(TSo3.block_rotate(_t(x.astype(np.float32)), wig, tr),
               JSo3.block_rotate(jnp.asarray(x, jnp.float32), jwig, tr),
               "float32", f"transpose={tr}")
    # the model's one block-diagonal product (m-major rows) equals
    # rotate-then-take, and its transpose scatter-into-zeros-then-rotate
    tidx = TSo3.trunc_indices(l_max, m_max)[0]
    order = TEq._mmajor(l_max, m_max)
    rot = TEq._trunc_rotation(wig, l_max, m_max)
    xt = _t(x.astype(np.float32))
    _close(torch.bmm(rot, xt), TSo3.block_rotate(xt, wig)[:, tidx[order]],
           "float32", "rotate in")
    full = torch.zeros_like(xt)
    full[:, tidx] = xt[:, tidx]
    _close(torch.bmm(rot.transpose(1, 2), xt[:, tidx[order]]),
           TSo3.block_rotate(full, wig, transpose=True), "float32",
           "rotate out")


# ------------------------------------------------------------- pieces


def test_radial_basis_matches_jax():
    r = np.abs(np.random.RandomState(5).randn(50)).astype(np.float32) * 3
    r[:3] = [0.0, 5.0, 7.5]                 # at and past the cutoff
    got = TEq.radial_basis(_t(r), 32, 5.0)
    _close(got, JEq.radial_basis(jnp.asarray(r), 32, 5.0), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_so2_conv_matches_jax(dtype):
    jcfg, tcfg, _ = _cell_cfgs("molecule", dtype=dtype)
    C, e = tcfg.d_hidden, 11
    shapes = {k: s for k, (s, _) in TEq._layer_shapes(tcfg).items()
              if k.startswith("so2")}
    rng = np.random.RandomState(6)
    pairs = {k: _pair(rng.randn(*s) * 0.2, dtype) for k, s in shapes.items()}
    jf, tf = _pair(rng.randn(e, tcfg.n_coeff, 2 * C), dtype)
    js, ts = _pair(rng.randn(e, tcfg.m_max + 1, C), dtype)
    got = TEq._so2_conv(tf, {k: t for k, (_, t) in pairs.items()}, tcfg, ts)
    want = JEq._so2_conv(jf, {k: j for k, (j, _) in pairs.items()}, jcfg, js)
    assert got.dtype == tf.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_equi_norm_and_gated_act_match_jax(dtype):
    rng = np.random.RandomState(7)
    jx, tx = _pair(rng.randn(9, 16, 8) * 3, dtype)
    js, ts = _pair(rng.randn(4, 8) * 0.1, dtype)
    jg, tg = _pair(rng.randn(8, 3 * 8) * 0.3, dtype)
    got = TEq._equi_norm(tx, ts, 3)
    assert got.dtype == tx.dtype
    _close(got, JEq._equi_norm(jx, js, 3), dtype, "equi_norm")
    got = TEq._gated_act(tx, tg, 3)
    assert got.dtype == tx.dtype
    _close(got, JEq._gated_act(jx, jg, 3), dtype, "gated_act")


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("shape_name,layers,dtype", [
    ("full_graph_sm", None, "float32"), ("molecule", None, "float32"),
    ("minibatch_lg", 3, "float32"), ("full_graph_sm", None, "bfloat16"),
    ("molecule", 3, "bfloat16")])
def test_forward_matches_jax(shape_name, layers, dtype):
    """Node-level (full_graph_sm, minibatch_lg) and pooled (molecule)
    outputs; three layers reach the m > 0 SO(2) maps' effect on the
    readout."""
    jcfg, tcfg, jp, tp, tb, jb = _models(shape_name, layers, dtype)
    got = TEq.equiformer_forward(tp, tcfg, tb)
    want = _jax_fn(JEq.equiformer_forward, jcfg, jb)(jp)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("shape_name,mask", [
    ("minibatch_lg", False), ("minibatch_lg", True), ("molecule", False)])
def test_loss_and_grads_match_jax(shape_name, mask):
    """``equiformer_loss`` (classification, with and without a
    ``label_mask``; MSE) and every leaf's gradient within 2e-5 of
    ``jax.value_and_grad``; three layers, so the m > 0 maps get a
    gradient."""
    jcfg, tcfg, jp, tp, tb, jb = _models(shape_name, layers=3)
    if mask:
        m = (np.random.RandomState(8).rand(tb["pos"].shape[0]) < 0.3)
        tb["label_mask"] = _t(m)
        jb["label_mask"] = jnp.asarray(m)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JEq.equiformer_loss(p, jcfg, jb)[0]))(jp)
    leaves = TS.gnn_param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl, _ = TEq.equiformer_loss(tp, tcfg, tb)
    tg = torch.autograd.grad(tl, leaves)
    assert abs(float(tl) - float(jl)) <= 2e-5
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tg) == 15
    for i, (a, b) in enumerate(zip(tg, jleaves)):
        _close(a, b, "float32", f"leaf {i}")
    so2 = [g for g, k in zip(tg, sorted(TEq._layer_shapes(tcfg)))
           if k.startswith("so2_m2")]
    assert all(bool(g.any()) for g in so2)


def test_param_leaves_follow_jax_tree_order():
    jcfg, tcfg, jp, tp, _, _ = _models("molecule")
    jl = jax.tree_util.tree_leaves(jp)
    tl = TS.gnn_param_leaves(tp)
    assert [tuple(a.shape) for a in jl] == [tuple(b.shape) for b in tl]
    for a, b in zip(jl, tl):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_init_and_from_jax_params_check_the_leaves():
    """The port's random init has the JAX init's tree, shapes, dtypes and
    zero norm scales; ``equiformer_from_jax_params`` refuses a missing,
    extra or misshapen leaf."""
    jcfg, tcfg, _ = _cell_cfgs("full_graph_sm", dtype="bfloat16")
    tp = TEq.init_equiformer(tcfg, torch.Generator().manual_seed(0), "cpu")
    jp = unwrap(JEq.init_equiformer(jcfg, 0, abstract=True))
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(jp)] == \
        [tuple(x.shape) for x in TS.gnn_param_leaves(tp)]
    assert all(x.dtype == torch.bfloat16 for x in TS.gnn_param_leaves(tp))
    assert not tp["layers"]["norm_scale"].any()
    assert tp["embed_w"].shape == (1433, tcfg.d_hidden)
    d0 = dataclasses.replace(tcfg, d_in=0)
    assert TEq.init_equiformer(d0, None, "cpu")["embed_w"].shape[0] == 128
    raw = jax.tree_util.tree_map(np.asarray, unwrap(
        JEq.init_equiformer(jcfg, 0)))
    TEq.equiformer_from_jax_params(raw, tcfg, "cpu")
    bad = dict(raw, layers=dict(raw["layers"]))
    del bad["layers"]["gate_w"]
    with pytest.raises(ValueError, match="keys"):
        TEq.equiformer_from_jax_params(bad, tcfg, "cpu")
    with pytest.raises(ValueError, match="keys"):
        TEq.equiformer_from_jax_params(dict(raw, extra=raw["out_w1"]), tcfg,
                                       "cpu")
    bad = dict(raw, out_w2=raw["out_w2"][:, :2])
    with pytest.raises(ValueError, match="shape"):
        TEq.equiformer_from_jax_params(bad, tcfg, "cpu")


def test_rotation_and_translation_invariance():
    """The JAX test's check on the port: rotating or translating every
    position leaves the outputs within 5e-5."""
    _, tcfg, _, tp, tb, _ = _models("full_graph_sm", layers=3)
    q = _t(_rotation(5))
    o1 = TEq.equiformer_forward(tp, tcfg, tb)
    o2 = TEq.equiformer_forward(tp, tcfg, dict(tb, pos=tb["pos"] @ q.T))
    o3 = TEq.equiformer_forward(
        tp, tcfg, dict(tb, pos=tb["pos"] + torch.tensor([1.0, -2.0, 3.0])))
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=5e-5)
    np.testing.assert_allclose(o1.numpy(), o3.numpy(), atol=5e-5)


def test_self_loops_take_no_part():
    """Zero-length edges are masked out: adding self-loops changes
    nothing."""
    _, tcfg, _, tp, tb, _ = _models("molecule")
    n = tb["pos"].shape[0]
    keep = tb["src"] != tb["dst"]
    loops = torch.arange(n, dtype=tb["src"].dtype)
    a = TEq.equiformer_forward(tp, tcfg, dict(tb, src=tb["src"][keep],
                                              dst=tb["dst"][keep]))
    b = TEq.equiformer_forward(tp, tcfg, dict(
        tb, src=torch.cat([tb["src"][keep], loops]),
        dst=torch.cat([tb["dst"][keep], loops])))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6)


# ------------------------------------------------------------- segment sum


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_drops_out_of_range_ids_like_jax(dtype):
    """Negative ids and ids >= n add nothing (they never wrap); the
    forward equals ``jax.ops.segment_sum`` bit for bit (the same adds in
    position order, each rounded), and its gradient is the gathered
    cotangent, zero for a dropped id."""
    rng = np.random.RandomState(9)
    n, e = 7, 300
    ids = rng.randint(-4, n + 4, e).astype(np.int32)
    ids[:150] = 2                            # a long segment
    jm, tm = _pair(rng.randn(e, 3, 2) * 10.0 ** rng.randint(-3, 3, (e, 1, 1)),
                   dtype)
    got = ops.segment_sum(tm, _t(ids), n)
    want = jax.ops.segment_sum(jm, jnp.asarray(ids), num_segments=n)
    assert got.dtype == tm.dtype and got.shape == (n, 3, 2)
    assert np.array_equal(_np(got), _np(want))
    jc, tc = _pair(rng.randn(n, 3, 2), dtype)
    tm.requires_grad_(True)
    (gt,) = torch.autograd.grad(ops.segment_sum(tm, _t(ids), n), tm, tc)
    _, vjp = jax.vjp(lambda m: jax.ops.segment_sum(
        m, jnp.asarray(ids), num_segments=n), jm)
    assert np.array_equal(_np(gt), _np(vjp(jc)[0]))
    assert not gt[(ids < 0) | (ids >= n)].any()
    assert ops.segment_sum(tm[:0], _t(ids[:0]), n).shape == (n, 3, 2)


def test_per_l_weight_take_grad_equals_xla_bit_for_bit():
    """The per-l FFN weights' take: the bf16 gradient of the 2l+1 copies
    added in position order, as XLA's scatter-add adds."""
    rng = np.random.RandomState(10)
    jw, tw = _pair(rng.randn(4, 3, 3), "bfloat16")
    jc, tc = _pair(rng.randn(16, 3, 3) * 10.0 ** rng.randint(-3, 3,
                                                            (16, 1, 1)),
                   "bfloat16")
    l_of = TEq._l_of(3, "cpu")
    tw.requires_grad_(True)
    (gt,) = torch.autograd.grad(TEq._take_per_l(tw, l_of), tw, tc)
    _, vjp = jax.vjp(lambda w: jnp.take(w, jnp.asarray(l_of.numpy()),
                                        axis=0), jw)
    assert np.array_equal(_np(gt), _np(vjp(jc)[0]))


# ------------------------------------------------------------- data


@pytest.mark.parametrize("name", SHAPES)
def test_gnn_batch_equals_the_jax_cell(name):
    for seed in (0, 3):
        cell = JS.build_cell(ARCH, name, reduced=True, abstract=False,
                             seed=seed)
        jb = cell.args[-1]
        shape = TS._reduce_shape("gnn", get_config(ARCH).shape(name))
        tb = TS._gnn_batch(shape, seed, "cpu")
        assert sorted(jb) == sorted(k for k in tb if k != "n_graphs")
        for k, v in jb.items():
            assert str(v.dtype) == str(tb[k].dtype).split(".")[-1], k
            assert np.array_equal(np.asarray(v), tb[k].numpy()), k
        assert ("n_graphs" in tb) == (name == "molecule")
        if name == "molecule":
            assert tb["n_graphs"] == shape["batch"]


def test_sampler_arrays_equal():
    g_j = JSa.random_powerlaw_graph(500, 6, seed=1)
    g_t = TSa.random_powerlaw_graph(500, 6, seed=1)
    assert g_t.n_nodes == g_j.n_nodes
    assert np.array_equal(g_t.indptr, g_j.indptr)
    assert np.array_equal(g_t.indices, g_j.indices)
    # a node of degree 0 self-loops
    src, dst = np.array([0, 1, 1]), np.array([1, 2, 2])
    small = (TSa.CSRGraph.from_edges(src, dst, 4),
             JSa.CSRGraph.from_edges(src, dst, 4))
    seeds = np.array([0, 2, 3, 7, 11])
    for (gt, gj), seeds_, fo in [((g_t, g_j), seeds, [4, 3]),
                                 (small, np.array([0, 3, 2]), [2, 2])]:
        for fn in ("sample_subgraph", "static_sample"):
            a = getattr(TSa, fn)(gt, seeds_, fo, np.random.RandomState(2))
            b = getattr(JSa, fn)(gj, seeds_, fo, np.random.RandomState(2))
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k],
                                                                   b[k]), k
    for b, fo in [(1024, [15, 10]), (8, [3, 2]), (5, [])]:
        assert TSa.static_node_count(b, fo) == JSa.static_node_count(b, fo)
        assert TSa.static_edge_count(b, fo) == JSa.static_edge_count(b, fo)


# ------------------------------------------------------------- training


STEPS = 5


@pytest.fixture(scope="module")
def jax_run():
    """The reference's reduced molecule cell (its seed-0 init, AdamW with
    clipping), ``STEPS`` steps of batches from seeds 1.. as
    ``launch/train.py`` draws them: the losses, the params after each
    step and the optimizer state after 2."""
    cell = JS.build_cell(ARCH, "molecule", reduced=True, abstract=False)
    params, opt_state = cell.args[0], cell.args[1]
    step_fn = jax.jit(cell.fn)
    out = {"init": jax.tree_util.tree_map(np.asarray, params),
           "losses": [], "params": []}
    for step in range(STEPS):
        batch = JS.build_cell(ARCH, "molecule", reduced=True,
                              abstract=False, seed=step + 1).args[-1]
        params, opt_state, loss = step_fn(params, opt_state,
                                          jnp.asarray(step, jnp.int32), batch)
        out["losses"].append(float(loss))
        out["params"].append(jax.tree_util.tree_map(np.asarray, params))
        if step == 1:
            out["state2"] = jax.tree_util.tree_map(np.asarray, opt_state)
    return out


def _port_steps(params, opt_state, steps):
    arch = get_config(ARCH).reduced()
    shape = TS._reduce_shape("gnn", arch.shape("molecule"))
    cfg = TS.gnn_cell_config(arch, shape)
    step_fn = TS.gnn_train_step(cfg, TS._optimizer_for(arch)[0])
    losses = []
    for step in steps:
        batch = TS._gnn_batch(shape, step + 1, "cpu")
        params, opt_state, loss = step_fn(params, opt_state, step, batch)
        losses.append(float(loss))
    return params, losses


def _params_close(tparams, jparams):
    jl = jax.tree_util.tree_leaves(jparams)
    tl = TS.gnn_param_leaves(tparams)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t.numpy(), j, atol=2e-5, rtol=0)


def _cell_cfg():
    arch = get_config(ARCH).reduced()
    return TS.gnn_cell_config(arch, TS._reduce_shape(
        "gnn", arch.shape("molecule")))


def test_train_steps_match_jax_cell(jax_run):
    params = TEq.equiformer_from_jax_params(jax_run["init"], _cell_cfg(),
                                            "cpu")
    opt = TS._optimizer_for(get_config(ARCH).reduced())[0]
    state = opt.init(TS.gnn_param_leaves(params))
    params, losses = _port_steps(params, state, range(3))
    np.testing.assert_allclose(losses, jax_run["losses"][:3], atol=2e-5,
                               rtol=2e-5)
    _params_close(params, jax_run["params"][2])


def test_three_steps_from_jax_params_and_opt_state(jax_run):
    """JAX's params and AdamW state after 2 steps carried across
    (``equiformer_from_jax_params``, ``opt_state_from_jax``); the port's
    steps 2-4 match the JAX run's."""
    params = TEq.equiformer_from_jax_params(jax_run["params"][1],
                                            _cell_cfg(), "cpu")
    state = TS.opt_state_from_jax(jax_run["state2"], params, "adamw")
    params, losses = _port_steps(params, state, range(2, 5))
    np.testing.assert_allclose(losses, jax_run["losses"][2:], atol=2e-5,
                               rtol=2e-5)
    _params_close(params, jax_run["params"][4])


def _main(shape, *extra):
    return train.main(["--arch", ARCH, "--shape", shape, "--reduced",
                       "--log-every", "100", "--device", "cpu", *extra])


@pytest.mark.parametrize("shape", ["minibatch_lg", "molecule"])
def test_train_cli_restart_is_bit_exact(tmp_path, shape):
    """6 steps against 3 steps, a checkpoint and a resume to 6: equal
    losses, params and optimizer state, bit for bit."""
    full = _main(shape, "--steps", "6", "--ckpt-dir", str(tmp_path / "full"),
                 "--ckpt-every", "100")
    part = _main(shape, "--steps", "3", "--ckpt-dir", str(tmp_path / "ck"),
                 "--ckpt-every", "3")
    resumed = _main(shape, "--steps", "6", "--ckpt-dir",
                    str(tmp_path / "ck"), "--ckpt-every", "100")
    assert len(full) == 6 and part == full[:3] and resumed == full[3:]
    assert all(np.isfinite(full))
    (sa, a, _), (sb, b, _) = (ckpt.restore(tmp_path / d, device="cpu")
                              for d in ("full", "ck"))
    assert sa == sb == 6
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert torch.equal(x, y), path
