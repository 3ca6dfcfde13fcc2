"""The port's ViT parser slice (``repro_torch.models.vit_parser``,
``configs/nougat_base.py``, the ``train_pages`` and router ``sft_4k``
cells of ``launch/specs.py`` and ``launch/train.py``) against the JAX
package on the CPU.

The port's params are carried from the JAX package's init
(``vit_parser_from_jax_params``, ``encoder_from_jax_params``); inputs
are made by numpy from a seed, or are the JAX cells' own batches.
Tolerances: 2e-5 in float32 (another summation order), 2e-2 of the
largest magnitude in bfloat16 (bf16 rounding at other points of a
product); the batches, greedy tokens and the train CLI's restart equal
bit for bit.
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
from repro.models import vit_parser as JV
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.launch import specs as TS
from repro_torch.launch import train
from repro_torch.models import vit_parser as TV
from repro_torch.models.encoder import encoder_from_jax_params

ARCH = "nougat-base"
ROUTER = "adaparse-router"
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype="float32", what=""):
    """Within 2e-5 (f32), or 2e-2 of the largest magnitude (bf16)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = 1.0 if dtype == "float32" else max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= TOL[dtype] * scale, f"{what}: {err} (scale {scale})"


def _cfgs(dtype="float32", **kw):
    """nougat-tiny in both packages, optionally in another dtype or with
    other fields."""
    kw = dict(kw, param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(j_get_config(ARCH).reduced().model, **kw),
            dataclasses.replace(get_config(ARCH).reduced().model, **kw))


def _models(dtype="float32", seed=3, **kw):
    """(jcfg, tcfg, JAX params (numpy leaves), port params)."""
    jcfg, tcfg = _cfgs(dtype, **kw)
    jp = jax.tree_util.tree_map(np.asarray,
                                unwrap(JV.init_vit_parser(jcfg, seed)))
    return jcfg, tcfg, jp, TV.vit_parser_from_jax_params(jp, tcfg, "cpu")


def _inputs(cfg, b=3, t=10, seed=0):
    rng = np.random.RandomState(seed)
    patches = rng.randn(b, cfg.n_patches, cfg.patch ** 2 * 3).astype(
        np.float32)
    toks = rng.randint(0, cfg.vocab_size, (b, t)).astype(np.int32)
    return patches, toks


# ------------------------------------------------------------- configs


def test_config_copies_the_jax_config():
    for full in (True, False):
        j, t = j_get_config(ARCH), get_config(ARCH)
        if not full:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
        assert (t.family, t.source) == (j.family, j.source)
        assert [repr(s) for s in t.shapes] == [repr(s) for s in j.shapes]
        assert t.model.n_patches == j.model.n_patches
        assert t.model.n_params() == j.model.n_params()
    # the reference's formula, copied as it stands
    assert get_config(ARCH).model.n_params() == 372_375_552


def test_param_leaves_and_full_width_count_follow_the_jax_tree():
    """The port's leaves in ``jax.tree_util.tree_leaves`` order with the
    reference's shapes, and the full-width tree's 466,362,368 elements
    reckoned from the shapes (the JAX side from its abstract init)."""
    jcfg, tcfg, jp, tp = _models()
    jl = jax.tree_util.tree_leaves(jp)
    tl = TS.vit_parser_param_leaves(tp)
    assert [a.shape for a in jl] == [tuple(b.shape) for b in tl]
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(jl, tl))
    full_j = j_get_config(ARCH).model
    abstract = unwrap(JV.init_vit_parser(full_j, abstract=True))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(abstract))
    assert want == TV.vit_parser_param_count(get_config(ARCH).model) \
        == 466_362_368
    init = TV.init_vit_parser(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(a.shape) for a in TS.vit_parser_param_leaves(init)] == \
        [a.shape for a in jl]
    assert TV.vit_parser_param_count(tcfg) == sum(a.size for a in jl)


def test_from_jax_params_checks_the_leaves():
    jcfg, tcfg, jp, _ = _models()
    bad = dict(jp, extra=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="keys"):
        TV.vit_parser_from_jax_params(bad, tcfg, "cpu")
    bad = dict(jp, dec_layers=dict(jp["dec_layers"],
                                   xk=jp["dec_layers"]["xk"][:, :-1]))
    with pytest.raises(ValueError, match="xk"):
        TV.vit_parser_from_jax_params(bad, tcfg, "cpu")


# ------------------------------------------------------------- encoder


# nougat-tiny has 12 patches: window 8 pads 4 rows, windows 6 and 4 none
@pytest.mark.parametrize("window", [8, 6, 4])
@pytest.mark.parametrize("odd", [False, True])
def test_window_attn_matches_jax(window, odd):
    jcfg, tcfg, jp, tp = _models(window=window)
    shift = window // 2 if odd else 0
    x = np.random.RandomState(window).randn(2, jcfg.n_patches,
                                            jcfg.enc_d_model).astype(
        np.float32)
    lj = jax.tree_util.tree_map(lambda a: a[int(odd)], jp["enc_layers"])
    lt = {k: v[int(odd)] for k, v in tp["enc_layers"].items()}
    want = JV._window_attn(jnp.asarray(x), lj, jcfg, jnp.asarray(shift))
    got = TV._window_attn(torch.from_numpy(x), lt, tcfg, shift)
    _close(got, want, what=f"window {window} shift {shift}")


@pytest.mark.parametrize("window", [8, 6])
@pytest.mark.parametrize("remat", [False, True])
def test_encode_pages_matches_jax(window, remat):
    jcfg, tcfg, jp, tp = _models(window=window, remat=remat)
    patches, _ = _inputs(jcfg)
    want = JV.encode_pages(jp, jcfg, jnp.asarray(patches))
    got = TV.encode_pages(tp, tcfg, torch.from_numpy(patches))
    _close(got, want, what="encode_pages")


def test_bf16_forward_matches_jax():
    jcfg, tcfg, jp, tp = _models("bfloat16")
    patches, toks = _inputs(jcfg)
    mj = JV.encode_pages(jp, jcfg, jnp.asarray(patches))
    mt = TV.encode_pages(tp, tcfg, torch.from_numpy(patches))
    assert mt.dtype == torch.bfloat16
    _close(mt, mj, "bfloat16", "encode_pages")
    _close(TV.decode_logits(tp, tcfg, mt, torch.from_numpy(toks)),
           JV.decode_logits(jp, jcfg, mj, jnp.asarray(toks)), "bfloat16",
           "decode_logits")


# ------------------------------------------------------------- decoder


@pytest.mark.parametrize("mask", [False, True])
def test_logits_loss_and_grads_match_jax(mask):
    """decode_logits, parser_loss and the gradient of every leaf within
    2e-5; the port's remat gradients equal its no-remat ones bit for
    bit."""
    jcfg, tcfg, jp, tp = _models()
    patches, toks = _inputs(jcfg, t=12)
    labels = np.roll(toks, -1, axis=1)
    batch = {"patches": patches, "tokens": toks, "labels": labels}
    if mask:
        batch["mask"] = (np.random.RandomState(1).rand(*toks.shape)
                         < 0.7).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    mj = JV.encode_pages(jp, jcfg, jb["patches"])
    _close(TV.decode_logits(tp, tcfg, TV.encode_pages(tp, tcfg,
                                                      tb["patches"]),
                            tb["tokens"]),
           JV.decode_logits(jp, jcfg, mj, jb["tokens"]), what="logits")
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: JV.parser_loss(p, jcfg, jb)[0]))(jp)
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        leaves = TS.vit_parser_param_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = TV.parser_loss(tp, cfg, tb)
        grads[remat] = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        assert abs(float(loss.detach()) - float(loss_j)) <= 2e-5
    jl = jax.tree_util.tree_leaves(grads_j)
    assert len(jl) == len(grads[False])
    for i, (a, b) in enumerate(zip(grads[False], jl)):
        _close(a, b, what=f"grad leaf {i}")
    assert all(torch.equal(a, b) for a, b in zip(grads[False],
                                                 grads[True]))


def test_dec_step_matches_jax_and_teacher_forcing():
    """``dec_step`` run token by token: each step's logits within 2e-5 of
    the reference's ``dec_step`` and of the port's teacher-forced
    ``decode_logits`` at that position."""
    jcfg, tcfg, jp, tp = _models()
    patches, toks = _inputs(jcfg, t=jcfg.max_dec_len, seed=4)
    mj = JV.encode_pages(jp, jcfg, jnp.asarray(patches))
    mt = TV.encode_pages(tp, tcfg, torch.from_numpy(patches))
    forced = TV.decode_logits(tp, tcfg, mt, torch.from_numpy(toks))
    sj = JV.init_dec_state(jp, jcfg, mj)
    st = TV.init_dec_state(tp, tcfg, mt)
    assert tuple(st.cache.k.shape) == sj.cache.k.shape
    _close(st.xk, sj.xk, what="xk")
    step_j = jax.jit(lambda tok, s, pos: JV.dec_step(jp, jcfg, tok, s, pos))
    for pos in range(toks.shape[1]):
        tok = toks[:, pos:pos + 1]
        lj, sj = step_j(jnp.asarray(tok), sj, jnp.asarray(pos))
        lt, st = TV.dec_step(tp, tcfg, torch.from_numpy(tok), st, pos)
        _close(lt, lj, what=f"dec_step {pos}")
        _close(lt, forced[:, pos], what=f"teacher-forced {pos}")
    _close(st.cache.k, sj.cache.k, what="cache")


@pytest.mark.parametrize("seed", [0, 5])
def test_generate_tokens_equal_jax(seed):
    jcfg, tcfg, jp, tp = _models(seed=seed)
    patches, _ = _inputs(jcfg, b=4, seed=seed)
    want = np.asarray(JV.generate(jp, jcfg, jnp.asarray(patches), 16))
    got = TV.generate(tp, tcfg, torch.from_numpy(patches), 16)
    assert got.dtype == torch.int32 and got.shape == (4, 16)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- cells


@pytest.mark.parametrize("arch, shape_name", [(ARCH, "train_pages"),
                                              (ROUTER, "sft_4k")])
def test_batches_equal_the_jax_cells(arch, shape_name):
    tarch = get_config(arch).reduced()
    shape = TS._reduce_shape(tarch.family, tarch.shape(shape_name))
    make = TS._nougat_batch if arch == ARCH else TS._router_batch
    for seed in range(1, 7):
        want = JS.build_cell(arch, shape_name, reduced=True, abstract=False,
                             seed=seed).args[-1]
        got = make(tarch.model, shape, seed, "cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].numpy().dtype == w.dtype, k
            np.testing.assert_array_equal(got[k].numpy(), w)


STEPS = 6


def _jax_run(arch, shape_name):
    """The reference's reduced cell (its seed-0 init, chain_clip(adamw)),
    ``STEPS`` jitted steps of batches from seeds 1.. as its
    ``launch/train.py`` draws them: the init and the losses."""
    cell = JS.build_cell(arch, shape_name, reduced=True, abstract=False)
    params, opt_state = cell.args[0], cell.args[1]
    init = jax.tree_util.tree_map(np.asarray, params)
    step_fn = jax.jit(cell.fn)
    losses = []
    for step in range(STEPS):
        batch = JS.build_cell(arch, shape_name, reduced=True,
                              abstract=False, seed=step + 1).args[-1]
        params, opt_state, loss = step_fn(params, opt_state,
                                          jnp.asarray(step, jnp.int32),
                                          batch)
        losses.append(float(loss))
    return init, losses, jax.tree_util.tree_map(np.asarray, params)


def test_parser_train_steps_match_the_jax_cell():
    init, want, final = _jax_run(ARCH, "train_pages")
    arch = get_config(ARCH).reduced()
    shape = TS._reduce_shape("vit_parser", arch.shape("train_pages"))
    params = TV.vit_parser_from_jax_params(init, arch.model, "cpu")
    opt = TS._optimizer_for(arch)[0]
    state = opt.init(TS.vit_parser_param_leaves(params))
    step_fn = TS.vit_parser_train_step(arch.model, opt)
    losses = []
    for step in range(STEPS):
        batch = TS._nougat_batch(arch.model, shape, step + 1, "cpu")
        params, state, loss = step_fn(params, state, step, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want, atol=2e-5, rtol=0)
    for a, b in zip(TS.vit_parser_param_leaves(params),
                    jax.tree_util.tree_leaves(final)):
        _close(a, b, what="params after 6 steps")


def test_router_train_steps_match_the_jax_cell():
    init, want, final = _jax_run(ROUTER, "sft_4k")
    arch = get_config(ROUTER).reduced()
    shape = TS._reduce_shape("encoder", arch.shape("sft_4k"))
    params = TS.router_param_tree(encoder_from_jax_params(init, arch.model,
                                                          "cpu"))
    leaves = TS.router_param_leaves(params)
    jl = jax.tree_util.tree_leaves(init)
    assert [tuple(a.shape) for a in leaves] == [a.shape for a in jl]
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(leaves, jl))
    opt = TS._optimizer_for(arch)[0]
    state = opt.init(leaves)
    step_fn = TS.router_train_step(arch.model, opt)
    losses = []
    for step in range(STEPS):
        batch = TS._router_batch(arch.model, shape, step + 1, "cpu")
        params, state, loss = step_fn(params, state, step, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want, atol=2e-5, rtol=0)
    for a, b in zip(TS.router_param_leaves(params),
                    jax.tree_util.tree_leaves(final)):
        _close(a, b, what="params after 6 steps")


def test_router_init_is_the_encoders():
    cfg = get_config(ROUTER).reduced().model
    tree = TS.init_router_params(cfg, torch.Generator().manual_seed(7),
                                 "cpu")
    from repro_torch.models.encoder import init_encoder
    enc = init_encoder(cfg, torch.Generator().manual_seed(7), "cpu")
    assert torch.equal(tree["tok_embed"], enc.p["tok_embed"])
    assert torch.equal(tree["layers"]["wq"][1], enc.layers[1].p["wq"])
    assert torch.equal(tree["layers"]["ln2_s"],
                       torch.ones_like(tree["layers"]["ln2_s"]))


def _main(arch, shape, *extra):
    return train.main(["--arch", arch, "--shape", shape, "--reduced",
                       "--log-every", "100", "--device", "cpu", *extra])


@pytest.mark.parametrize("arch, shape", [(ARCH, "train_pages"),
                                         (ROUTER, "sft_4k")])
def test_train_cli_restart_is_bit_exact(tmp_path, arch, shape):
    """6 steps against 3 steps, a checkpoint and a resume to 6: equal
    losses, params and optimizer state, bit for bit."""
    full = _main(arch, shape, "--steps", "6", "--ckpt-dir",
                 str(tmp_path / "full"), "--ckpt-every", "100")
    part = _main(arch, shape, "--steps", "3", "--ckpt-dir",
                 str(tmp_path / "ck"), "--ckpt-every", "3")
    resumed = _main(arch, shape, "--steps", "6", "--ckpt-dir",
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


def test_train_cli_refuses_dpo_and_serve_shapes():
    with pytest.raises(NotImplementedError, match="TypeError.*fit_dpo"):
        _main(ROUTER, "dpo_2k", "--steps", "1")
    for arch, shape in [(ARCH, "parse_encode"), (ARCH, "parse_decode"),
                        (ROUTER, "route_64k")]:
        with pytest.raises(NotImplementedError, match="13e"):
            _main(arch, shape, "--steps", "1")
    with pytest.raises(RuntimeError, match="cuda"):    # no card here
        train.main(["--arch", ARCH, "--shape", "train_pages", "--reduced",
                    "--steps", "1"])
