"""The port's LM cells (``repro_torch.launch.specs``: ``_lm_train_cell``,
``_lm_prefill_cell``, ``_lm_decode_cell``, ``build_cell``,
``all_cells``, ``configs.list_archs``) against the JAX package's: every
LM cell at full size on meta leaf by leaf, the reduced cells' batches,
caches and positions bit for bit at seeds 0 and 1, one reduced prefill
and one reduced decode step of every LM arch from the reference's
params within 2e-5 (the tiny configs are float32), the skipped shapes
and the refused rules."""
from __future__ import annotations

import jax
import pytest

from torch_cells_common import (assert_abstract_cell, assert_data_bit_equal,
                                assert_refusals, assert_registry_matches,
                                carried, close, family_cells)

CELLS = family_cells("lm")
SERVE = [(a, s) for a, s in CELLS if s != "train_4k"]


def test_registry_and_cell_list_match_the_reference():
    assert_registry_matches()
    assert len(CELLS) == 16


@pytest.mark.parametrize("arch, shape", CELLS)
def test_abstract_cell_matches_the_reference(arch, shape):
    assert_abstract_cell(arch, shape)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_model_override_matches_the_reference(shape):
    """``model_override`` replaces the arch's model (the smoke run's
    ``attention_impl="pallas"``); ``reduced`` then takes the tiny one."""
    import dataclasses

    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as TS

    arch = "qwen3-1.7b"
    jm = dataclasses.replace(jax_config(arch).model, attention_impl="pallas",
                             n_layers=3)
    tm = dataclasses.replace(get_config(arch).model,
                             attention_impl="pallas", n_layers=3)
    assert_abstract_cell(arch, shape, {"model_override": jm},
                         {"model_override": tm})
    assert len(TS.build_cell(arch, shape, model_override=tm).args[0][
        "layers"]["wq"]) == 3
    assert TS.build_cell(arch, shape, reduced=True, model_override=tm
                         ).args[0]["layers"]["wq"].shape[0] == \
        get_config(arch).reduced().model.n_layers


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch, shape", CELLS)
def test_reduced_data_bit_equal(arch, shape, seed):
    assert_data_bit_equal(arch, shape, seed)


@pytest.mark.parametrize("arch, shape", SERVE)
def test_reduced_serve_step_matches_the_reference(arch, shape):
    """prefill: last-position logits and the cache it builds; decode:
    the logits and the cache with the step's keys and values written."""
    want, got = carried(arch, shape)
    close(got.fn(*got.args), jax.jit(want.fn)(*want.args))


def test_skipped_shapes_and_rules_are_refused():
    assert_refusals("lm")
