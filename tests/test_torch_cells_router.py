"""The port's router cells (``repro_torch.launch.specs._router_cell``:
``sft_4k``, the reference's five-argument ``dpo_2k`` step on
``core/dpo.dpo_loss``, and ``route_64k`` through
``core/router.make_route_step`` at alpha 0.05) against the JAX
package's: each at full size on meta leaf by leaf, the reduced batches
bit for bit at seeds 0 and 1, one reduced DPO step (loss and params,
from distinct sides and a reference that differs from the params) and
the route step's plan from the reference's params (the reduced
batch of 4, whose budget routes nothing, and a batch of 64 through the
private builders, which routes 3)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import get_config as jax_config
from repro.launch import specs as JS
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import specs as TS
from torch_cells_common import (assert_abstract_cell, assert_data_bit_equal,
                                assert_refusals, assert_registry_matches,
                                carried, close, family_cells, port_params)

CELLS = family_cells("encoder")
ROUTER = "adaparse-router"


def test_registry_and_cell_list_match_the_reference():
    assert_registry_matches()
    assert CELLS == [(ROUTER, "sft_4k"), (ROUTER, "dpo_2k"),
                     (ROUTER, "route_64k")]


@pytest.mark.parametrize("arch, shape", CELLS)
def test_abstract_cell_matches_the_reference(arch, shape):
    assert_abstract_cell(arch, shape)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch, shape", CELLS)
def test_reduced_data_bit_equal(arch, shape, seed):
    assert_data_bit_equal(arch, shape, seed)


def _distinct_dpo_cells():
    """The reduced ``dpo_2k`` cells of both packages with the batch's
    rejected side drawn at seed 1 (the cell's own draws both sides at
    seed 0, so they are equal and the loss is ln 2 for any policy) and
    the frozen reference's ``pref_w`` moved off the params, so that the
    preference term, the encoder differentiated and which argument is
    frozen all show in the step's result."""
    want, got = carried(ROUTER, "dpo_2k")
    tarch = get_config(ROUTER).reduced()
    b, s = np.asarray(want.args[4]["tok_pos"]).shape
    tok_neg = np.random.RandomState(1).randint(
        2, tarch.model.vocab_size, (b, s)).astype(np.int32)
    raw = jax.tree_util.tree_map(np.asarray, want.args[0])
    ref_raw = {**raw, "pref_w": raw["pref_w"] + 0.5 * np.random.RandomState(
        2).randn(*raw["pref_w"].shape).astype(np.float32)}
    want.args = (want.args[0], jax.tree_util.tree_map(jnp.asarray, ref_raw),
                 *want.args[2:4], {**want.args[4],
                                   "tok_neg": jnp.asarray(tok_neg)})
    got.args = (got.args[0], port_params("encoder", ref_raw, tarch.model),
                *got.args[2:4], {**got.args[4],
                                 "tok_neg": torch.from_numpy(tok_neg)})
    return want, got


def test_dpo_step_matches_the_reference():
    """Five arguments, from distinct sides and a frozen reference that
    differs from the params (``_distinct_dpo_cells``): the loss and every
    updated param within 2e-5 of ``jax.jit`` of the reference's step; the
    frozen reference is left as it was."""
    want, got = _distinct_dpo_cells()
    ref_before = [t.clone() for t in TS.router_param_leaves(got.args[1])]
    p, _, loss = got.fn(*got.args)
    wp, _, wloss = jax.jit(want.fn)(*want.args)
    close(loss, wloss)
    assert abs(float(wloss) - np.log(2.0)) > 1e-3, float(wloss)
    gl, wl = TS.router_param_leaves(p), jax.tree_util.tree_leaves(wp)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)
    assert all(torch.equal(a, b) for a, b in zip(
        TS.router_param_leaves(got.args[1]), ref_before))


def _route_cells(batch: int):
    if batch == 4:
        return carried(ROUTER, "route_64k")
    dims = {"seq_len": 64, "global_batch": batch}
    tarch, jarch = get_config(ROUTER).reduced(), jax_config(ROUTER).reduced()
    want = JS._router_cell(jarch, jax_base.ShapeConfig(
        "route_64k", "serve", dims), None, False)
    got = TS._router_cell(tarch, ShapeConfig("route_64k", "serve", dims),
                          None, False, device="cpu")
    raw = jax.tree_util.tree_map(np.asarray, want.args[0])
    got.args = (port_params("encoder", raw, tarch.model),) + got.args[1:]
    return want, got


@pytest.mark.parametrize("batch", [4, 64])
def test_route_step_plan_equals_the_reference(batch):
    want, got = _route_cells(batch)
    out, ref = got.fn(*got.args), jax.jit(want.fn)(*want.args)
    assert sorted(out) == sorted(ref)
    for k in ("selected_idx", "count", "selected_mask", "routed_tokens"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    close([out["pred_acc"], out["improvement"]],
          [ref["pred_acc"], ref["improvement"]])
    assert (int(out["count"]) > 0) == (batch == 64)


def test_skipped_shapes_and_rules_are_refused():
    assert_refusals("encoder")
