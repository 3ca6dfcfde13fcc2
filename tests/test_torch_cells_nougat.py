"""The port's Nougat parser cells (``repro_torch.launch.specs
._nougat_cell``: ``train_pages``, ``parse_encode`` and
``parse_decode``) against the JAX package's: each at full size on meta
leaf by leaf (``parse_decode``'s caches and cross keys and values
included), the reduced batches, caches and positions bit for bit at
seeds 0 and 1, and one reduced ``parse_encode`` (cross keys and values)
and ``parse_decode`` step (logits and both caches) from the
reference's params within 2e-5 (nougat-tiny is float32)."""
from __future__ import annotations

import jax
import pytest

from torch_cells_common import (assert_abstract_cell, assert_data_bit_equal,
                                assert_refusals, assert_registry_matches,
                                carried, close, family_cells)

CELLS = family_cells("vit_parser")


def test_registry_and_cell_list_match_the_reference():
    assert_registry_matches()
    assert [s for _, s in CELLS] == ["train_pages", "parse_encode",
                                     "parse_decode"]


@pytest.mark.parametrize("arch, shape", CELLS)
def test_abstract_cell_matches_the_reference(arch, shape):
    assert_abstract_cell(arch, shape)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch, shape", CELLS)
def test_reduced_data_bit_equal(arch, shape, seed):
    assert_data_bit_equal(arch, shape, seed)


@pytest.mark.parametrize("shape", ["parse_encode", "parse_decode"])
def test_reduced_serve_step_matches_the_reference(shape):
    want, got = carried("nougat-base", shape)
    close(got.fn(*got.args), jax.jit(want.fn)(*want.args))


def test_skipped_shapes_and_rules_are_refused():
    assert_refusals("vit_parser")
