"""The port's GNN cells (``repro_torch.launch.specs._gnn_train_cell``,
with ``_gnn_dims``'s padding of the full-graph cells to multiples of
512) against the JAX package's: every EquiformerV2 cell at full size on
meta leaf by leaf (``ogb_products``' 61,859,328 padded edges included),
its note, the reduced batches bit for bit at seeds 0 and 1 (the
molecule cell's ``n_graphs`` stays out of the batch, as the reference's
step adds it), and one reduced train step of the molecule cell against
the reference's jitted step."""
from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.launch import specs as JS
from repro_torch.launch import specs as TS
from repro_torch.models.gnn.equiformer import equiformer_from_jax_params
from torch_cells_common import (assert_abstract_cell, assert_data_bit_equal,
                                assert_refusals, assert_registry_matches,
                                close, family_cells)

CELLS = family_cells("gnn")


def test_registry_and_cell_list_match_the_reference():
    assert_registry_matches()
    assert [s for _, s in CELLS] == ["full_graph_sm", "minibatch_lg",
                                     "ogb_products", "molecule"]


@pytest.mark.parametrize("arch, shape", CELLS)
def test_abstract_cell_matches_the_reference(arch, shape):
    assert_abstract_cell(arch, shape)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch, shape", CELLS)
def test_reduced_data_bit_equal(arch, shape, seed):
    assert_data_bit_equal(arch, shape, seed)


def test_molecule_step_adds_n_graphs_as_the_reference():
    want = JS.build_cell("equiformer-v2", "molecule", abstract=False,
                         reduced=True)
    got = TS.build_cell("equiformer-v2", "molecule", abstract=False,
                        reduced=True, device="cpu")
    assert "n_graphs" not in got.args[3] and "n_graphs" not in want.args[3]
    cfg = TS.gnn_cell_config(TS.get_config("equiformer-v2").reduced(),
                             TS.cell_shape("equiformer-v2", "molecule",
                                           True)[1])
    raw = jax.tree_util.tree_map(np.asarray, want.args[0])
    params = equiformer_from_jax_params(raw, cfg, "cpu")
    opt_state = TS.opt_state_from_jax(
        jax.tree_util.tree_map(np.asarray, want.args[1]), params, "adamw")
    p, _, loss = got.fn(params, opt_state, 0, got.args[3])
    wp, _, wloss = jax.jit(want.fn)(*want.args)
    close(loss, wloss)
    close(TS.gnn_param_leaves(p), jax.tree_util.tree_leaves(wp))


def test_skipped_shapes_and_rules_are_refused():
    assert_refusals("gnn")
