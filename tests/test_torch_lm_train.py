"""The port's LM training path (``repro_torch.models.transformer.lm_loss``,
``launch/specs.py``'s train step and ``launch/train.py``) against the JAX
package on the CPU, on the reduced f32 ``qwen3-1.7b`` (qwen3-tiny) with
``q_chunk=16, kv_chunk=32``, so that both packages attend through
``xla_flash`` (and its backward) at the reduced ``train_4k`` shape (4 x
64), not the naive fallback.

The JAX LM's params (its ``_lm_train_cell``'s seed-0 init, as numpy) are
carried across with ``lm_from_jax_params``, and its optimizer state with
``opt_state_from_jax``. Tolerances: 2e-5 on the loss and every gradient
leaf (another summation order), 1e-5 relative on the losses and 1e-4 on
the params over train steps; the port's own restart is bit-exact.
"""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.common import unwrap
from repro.configs import get_config as j_get_config
from repro.launch import specs as JS
from repro.models import transformer as JT
from repro_torch import optim as topt
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.launch import specs as TS
from repro_torch.launch import train
from repro_torch.models import transformer as TT

STEPS = 6


def _cfgs():
    chunks = dict(q_chunk=16, kv_chunk=32)
    jarch = j_get_config("qwen3-1.7b").reduced()
    jarch = dataclasses.replace(
        jarch, model=dataclasses.replace(jarch.model, **chunks))
    tcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced().model,
                               **chunks)
    assert repr(jarch.model) == repr(tcfg)
    return jarch, tcfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, b, s, seed):
    """The reference cell's batch for ``seed``, as numpy."""
    toks = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module", params=["adamw", "adafactor"])
def jax_run(request):
    """The reference's train cell, ``STEPS`` steps of batches from seeds
    1.. (as ``launch/train.py`` draws them): its seed-0 init, the
    optimizer state after 3 steps, the losses, and the params after each
    step. ``adamw`` is the cell's own optimizer (``_optimizer_for``);
    ``adafactor`` is ``adafactor(1e-3, min_dim_factored=32)``, which
    factors the 64-wide leaves."""
    jarch, tcfg = _cfgs()
    shape = JS._reduce_shape("lm", jarch.shape("train_4k"))
    cell = JS._lm_train_cell(jarch, shape, None, False, seed=0)
    params, opt_state = cell.args[0], cell.args[1]
    if request.param == "adamw":
        fn, jopt_ = cell.fn, None
    else:
        jopt_ = jopt.adafactor(1e-3, min_dim_factored=32)
        opt_state = jopt_.init(params)

        def fn(p, st, step, batch):
            (loss, _), g = jax.value_and_grad(
                lambda q: JT.lm_loss(q, jarch.model, batch),
                has_aux=True)(p)
            u, st = jopt_.update(g, st, p, step)
            return jopt.apply_updates(p, u), st, loss
    step_fn = jax.jit(fn)
    b, s = shape["global_batch"], shape["seq_len"]
    out = {"kind": request.param, "init": _np_tree(params), "losses": [],
           "params": [], "b": b, "s": s}
    for step in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in
                 _batch(tcfg, b, s, step + 1).items()}
        params, opt_state, loss = step_fn(params, opt_state,
                                          jnp.asarray(step, jnp.int32), batch)
        out["losses"].append(float(loss))
        out["params"].append(_np_tree(params))
        if step == 2:
            out["state3"] = _np_tree(opt_state)
    return out


def _port_opt(kind):
    if kind == "adamw":
        return TS._optimizer_for(get_config("qwen3-1.7b").reduced())[0]
    return topt.adafactor(1e-3, min_dim_factored=32)


def _assert_params_close(tparams, jparams, atol):
    jleaves = jax.tree_util.tree_leaves(jparams)
    tleaves = TS.lm_param_leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.detach().numpy(), j, atol=atol, rtol=0)


def _port_steps(run, params, opt_state, steps):
    _, tcfg = _cfgs()
    step_fn = TS.lm_train_step(tcfg, _port_opt(run["kind"]))
    losses = []
    for step in steps:
        batch = TS._lm_train_batch(tcfg, run["b"], run["s"], step + 1, "cpu")
        params, opt_state, loss = step_fn(params, opt_state, step, batch)
        losses.append(float(loss))
    return params, opt_state, losses


def test_param_leaves_follow_jax_tree_order():
    _, tcfg = _cfgs()
    raw = _np_tree(JT.init_lm(j_get_config("qwen3-1.7b").reduced().model, 0))
    jleaves = jax.tree_util.tree_leaves(unwrap(raw))
    tleaves = TS.lm_param_leaves(TT.lm_from_jax_params(unwrap(raw), tcfg,
                                                       "cpu"))
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_array_equal(t.numpy(), j)
    assert len(jleaves) == len(tleaves) == 14


@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_and_gradients_match_jax(remat):
    """``lm_loss`` and the gradient of every leaf within 2e-5 of
    ``jax.value_and_grad(lm_loss)``; remat (each layer under
    ``torch.utils.checkpoint``) gives the same values."""
    jarch, tcfg = _cfgs()
    raw = _np_tree(unwrap(JT.init_lm(jarch.model, 0)))
    batch = _batch(tcfg, 4, 64, seed=3)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.lm_loss(p, jarch.model, batch), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, raw))
    params = TT.lm_from_jax_params(raw, tcfg, "cpu")
    leaves = TS.lm_param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    cfg = dataclasses.replace(tcfg, remat=remat)
    loss, metrics = TT.lm_loss(params, cfg,
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=2e-5,
                               rtol=2e-5)
    assert float(metrics["aux"]) == 0.0 and metrics["aux"].dtype == \
        torch.float32
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(jm["ce"]),
                               atol=2e-5, rtol=2e-5)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)


def test_cross_entropy_loss_matches_jax():
    from repro.models.layers import cross_entropy_loss as j_ce
    from repro_torch.models.layers import cross_entropy_loss as t_ce

    rng = np.random.RandomState(4)
    logits = (rng.randn(3, 5, 11) * 4).astype(np.float32)
    labels = rng.randint(0, 11, (3, 5)).astype(np.int32)
    for mask in (None, (rng.rand(3, 5) < 0.6).astype(np.float32),
                 np.zeros((3, 5), np.float32)):
        want = float(j_ce(jnp.asarray(logits), jnp.asarray(labels),
                          None if mask is None else jnp.asarray(mask)))
        got = t_ce(torch.from_numpy(logits), torch.from_numpy(labels),
                   None if mask is None else torch.from_numpy(mask))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, atol=2e-6, rtol=2e-6)


def test_train_steps_match_jax_cell(jax_run):
    """Five ``lm_train_step`` steps from the reference cell's init:
    losses within 1e-5 relative, params within 1e-4."""
    _, tcfg = _cfgs()
    params = TT.lm_from_jax_params(jax_run["init"], tcfg, "cpu")
    opt_state = _port_opt(jax_run["kind"]).init(TS.lm_param_leaves(params))
    params, _, losses = _port_steps(jax_run, params, opt_state, range(5))
    np.testing.assert_allclose(losses, jax_run["losses"][:5], rtol=1e-5)
    _assert_params_close(params, jax_run["params"][4], atol=1e-4)


def test_resume_from_jax_state(jax_run):
    """JAX's params and optimizer state after 3 steps carried across
    (``lm_from_jax_params``, ``opt_state_from_jax``); the port's steps
    3-5 match the JAX run's."""
    _, tcfg = _cfgs()
    params = TT.lm_from_jax_params(jax_run["params"][2], tcfg, "cpu")
    state = TS.opt_state_from_jax(jax_run["state3"], params,
                                  jax_run["kind"])
    if jax_run["kind"] == "adafactor":
        kinds = [set(st) for st in state["v"]]
        assert {"vr", "vc"} in kinds and {"v"} in kinds
    params, _, losses = _port_steps(jax_run, params, state, range(3, 6))
    np.testing.assert_allclose(losses, jax_run["losses"][3:], rtol=1e-5)
    _assert_params_close(params, jax_run["params"][5], atol=1e-4)


def test_opt_state_from_jax_checks_shapes(jax_run):
    _, tcfg = _cfgs()
    params = TT.lm_from_jax_params(jax_run["init"], tcfg, "cpu")
    bad = jax.tree_util.tree_map(lambda a: a[..., :1] if a.ndim else a,
                                 jax_run["state3"])
    with pytest.raises(ValueError, match="shape"):
        TS.opt_state_from_jax(bad, params, jax_run["kind"])
    with pytest.raises(ValueError, match="kind"):
        TS.opt_state_from_jax(jax_run["state3"], params, "sgd")


@pytest.mark.parametrize("seed", [0, 7])
def test_lm_train_batch_tokens_equal_the_reference(seed):
    jarch, tcfg = _cfgs()
    shape = JS._reduce_shape("lm", jarch.shape("train_4k"))
    want = JS._lm_train_cell(jarch, shape, None, False, seed=seed).args[-1]
    got = TS._lm_train_batch(tcfg, shape["global_batch"], shape["seq_len"],
                             seed, "cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(RuntimeError, match="cuda"):
        TS._lm_train_batch(tcfg, 1, 8, seed)          # no card here


def _main(*extra):
    return train.main(["--arch", "qwen3-1.7b", "--shape", "train_4k",
                       "--reduced", "--log-every", "100", "--device", "cpu",
                       *extra])


def _restored(path):
    step, tree, meta = ckpt.restore(path, device="cpu")
    return step, ckpt._flatten(tree), meta


def test_train_restart_is_bit_exact(tmp_path):
    """6 steps against 3 steps, a checkpoint and a resume to 6: equal
    losses and equal params and optimizer state, bit for bit."""
    full = _main("--steps", "6", "--ckpt-dir", str(tmp_path / "full"),
                 "--ckpt-every", "100")
    part = _main("--steps", "3", "--ckpt-dir", str(tmp_path / "ck"),
                 "--ckpt-every", "3")
    resumed = _main("--steps", "6", "--ckpt-dir", str(tmp_path / "ck"),
                    "--ckpt-every", "100")
    assert len(full) == 6 and part == full[:3] and resumed == full[3:]
    assert ckpt.all_steps(tmp_path / "ck") == [3, 6]
    (sa, a, ma), (sb, b, mb) = (_restored(tmp_path / "full"),
                                _restored(tmp_path / "ck"))
    assert sa == sb == 6 and ma == mb == {"step": 6, "arch": "qwen3-1.7b",
                                          "loss": full[-1]}
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), path


def test_sigterm_checkpoints_and_exits(tmp_path, monkeypatch):
    """A SIGTERM during step 2 ends the run after that step with a
    checkpoint at step 3, from which a resume to 6 gives the
    uninterrupted run's losses."""
    real = train._lm_train_batch

    def batch(cfg, b, s, seed, device):
        if seed == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(cfg, b, s, seed, device)

    full = _main("--steps", "6")
    with monkeypatch.context() as m:
        m.setattr(train, "_lm_train_batch", batch)
        cut = _main("--steps", "6", "--ckpt-dir", str(tmp_path))
    assert cut == full[:3] and ckpt.latest_step(tmp_path) == 3
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    assert _main("--steps", "6", "--ckpt-dir", str(tmp_path)) == full[3:]


def test_mesh_and_device_are_checked():
    with pytest.raises(ValueError, match="one card"):
        _main("--steps", "1", "--mesh", "2x1")
    with pytest.raises(RuntimeError, match="cuda"):    # no card here
        train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="13e"):
        _main("--steps", "1", "--shape", "prefill_32k")
