"""The port's recsys cells (``repro_torch.launch.specs._recsys_cell``:
train, serve and ``retrieval_cand``) against the JAX package's: every
recsys cell at full size on meta leaf by leaf (the 48.07 GB DLRM table
included, which nothing allocates), the reduced batches bit for bit at
seeds 0 and 1, one reduced serve step of each serve cell from the
reference's params within 2e-5 (the tiny configs are float32) and each
retrieval's top-k ids equal."""
from __future__ import annotations

import jax
import pytest

from torch_cells_common import (assert_abstract_cell, assert_data_bit_equal,
                                assert_refusals, assert_registry_matches,
                                carried, close, family_cells)

CELLS = family_cells("recsys")
SERVE = [(a, s) for a, s in CELLS if s != "train_batch"]


def test_registry_and_cell_list_match_the_reference():
    assert_registry_matches()
    assert len(CELLS) == 16


@pytest.mark.parametrize("arch, shape", CELLS)
def test_abstract_cell_matches_the_reference(arch, shape):
    assert_abstract_cell(arch, shape)


def test_full_size_dlrm_cell_allocates_nothing():
    from repro_torch.launch import specs as TS

    cell = TS.build_cell("dlrm-mlperf", "train_batch")
    table = cell.args[0]["table"]
    assert table.is_meta and table.numel() * 2 > 48e9
    assert all(m.is_meta for m in cell.args[1]["m"])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch, shape", CELLS)
def test_reduced_data_bit_equal(arch, shape, seed):
    assert_data_bit_equal(arch, shape, seed)


@pytest.mark.parametrize("arch, shape", SERVE)
def test_reduced_serve_step_matches_the_reference(arch, shape):
    want, got = carried(arch, shape)
    out, ref = got.fn(*got.args), jax.jit(want.fn)(*want.args)
    if shape == "retrieval_cand":     # (scores, ids): the ids equal
        assert isinstance(out, tuple) and not out[1].is_floating_point()
    close(out, ref)


def test_skipped_shapes_and_rules_are_refused():
    assert_refusals("recsys")
