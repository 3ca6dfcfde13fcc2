"""The cells' ``in_shardings`` (``launch/specs.py`` given ``rules``)
against the JAX package's: every leaf's spec of all 42 cells, on the
(16, 16) and (2, 16, 16) production meshes, equal to the reference's leaf
by key path, and the donated arguments equal. The reference builds its
cells in a child interpreter with 512 host devices; the port's meshes
are ``DeviceMesh``es on the fake backend."""
import pytest

from torch_mesh_common import (CELLS_SCRIPT, fake_world_512,  # noqa: F401
                               port_sharding_leaves, run_jax_child)

from repro_torch.launch.specs import all_cells

CELLS = all_cells()


@pytest.fixture(scope="module")
def reference():
    return run_jax_child(CELLS_SCRIPT)


@pytest.fixture(scope="module")
def rules(fake_world_512):  # noqa: F811
    from repro_torch.distributed.meshrules import AxisRules
    from repro_torch.launch.mesh import make_production_mesh

    return {mp: AxisRules(make_production_mesh(multi_pod=mp))
            for mp in (False, True)}


def test_all_cells_match_the_reference(reference):
    assert len(CELLS) == 42
    assert sorted(reference) == sorted(f"{a}/{s}/{mp}" for a, s in CELLS
                                       for mp in (0, 1))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
@pytest.mark.parametrize("arch, shape", CELLS)
def test_in_shardings_equal_reference(reference, rules, arch, shape,
                                      multi_pod):
    from repro_torch.launch.specs import build_cell

    cell = build_cell(arch, shape, rules=rules[multi_pod], abstract=True)
    want = reference[f"{arch}/{shape}/{int(multi_pod)}"]
    got = port_sharding_leaves(cell)
    assert got == dict(want["leaves"])
    assert list(cell.donate_argnums) == want["donate"]


def test_rules_none_gives_no_shardings():
    from repro_torch.launch.specs import build_cell

    assert build_cell("qwen3-1.7b", "decode_32k").in_shardings is None
