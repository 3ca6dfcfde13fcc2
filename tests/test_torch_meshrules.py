"""``distributed/meshrules.py`` against ``repro.distributed.meshrules``:

- ``spec_for`` and ``zero_spec_for`` equal the reference's for drawn
  logical axes, shapes and mesh sizes (the reference's ``AxisRules``
  reads only ``mesh.shape``, so both take a stand-in mesh);
- on the fake backend's production meshes, ``distribute_tensor`` with
  the port's placements gives the local shapes the reference's
  ``NamedSharding.shard_shape`` gives (the reference in a child with 512
  host devices);
- ``shard_hint``'s four cases; the process group is destroyed after the
  module (``fake_world_512``)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_mesh_common import (fake_world_512, run_jax_child,  # noqa: F401
                               spec_json)

from repro.distributed import meshrules as JM
from repro_torch.distributed import meshrules as TM

LOGICAL = sorted(TM.DEFAULT_RULES)
MESHES = [(("data", "model"), (16, 16)), (("pod", "data", "model"),
                                          (2, 16, 16)),
          (("data", "model"), (1, 1)), (("data", "model"), (2, 4)),
          (("pod", "data", "model"), (4, 2, 2)), (("model",), (8,))]
DIMS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 512, 1000,
        4096]


class _JaxMesh:
    """The reference's stand-in: ``spec_for`` reads only ``.shape``."""

    def __init__(self, names, sizes):
        self.shape = dict(zip(names, sizes))


class _PortMesh:
    def __init__(self, names, sizes):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(sizes)


def _ref_spec(spec) -> list:
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


def test_default_rules_equal_reference():
    assert TM.DEFAULT_RULES == JM.DEFAULT_RULES


case = st.tuples(
    st.sampled_from(MESHES),
    st.lists(st.one_of(st.none(), st.sampled_from(LOGICAL)), min_size=0,
             max_size=5),
    st.data())


@settings(max_examples=300, deadline=None)
@given(case)
def test_spec_for_and_zero_spec_for_equal_reference(c):
    (names, sizes), axes, data = c
    shape = tuple(data.draw(st.sampled_from(DIMS)) for _ in axes)
    ref = JM.AxisRules(_JaxMesh(names, sizes))
    port = TM.AxisRules(_PortMesh(names, sizes))
    assert spec_json(port.spec_for(axes, shape)) == _ref_spec(
        ref.spec_for(axes, shape))
    assert spec_json(port.spec_for(axes)) == _ref_spec(ref.spec_for(axes))
    assert spec_json(port.zero_spec_for(axes, shape)) == _ref_spec(
        ref.zero_spec_for(axes, shape))


@settings(max_examples=60, deadline=None)
@given(st.sampled_from(MESHES),
       st.dictionaries(st.sampled_from(LOGICAL),
                       st.lists(st.sampled_from(["pod", "data", "model",
                                                 "stage"]),
                                max_size=3, unique=True).map(tuple),
                       max_size=4),
       st.lists(st.sampled_from(LOGICAL), min_size=1, max_size=4))
def test_overrides_equal_reference(mesh, overrides, axes):
    names, sizes = mesh
    shape = tuple(64 for _ in axes)
    ref = JM.AxisRules(_JaxMesh(names, sizes), overrides=overrides)
    port = TM.AxisRules(_PortMesh(names, sizes), overrides=overrides)
    assert spec_json(port.spec_for(axes, shape)) == _ref_spec(
        ref.spec_for(axes, shape))


def _shard_cases() -> list:
    """(multi_pod, logical axes, shape) drawn once from a seed."""
    r = np.random.RandomState(0)
    out = []
    for i in range(60):
        n = r.randint(1, 4)
        axes = [None if r.rand() < 0.2 else LOGICAL[r.randint(len(LOGICAL))]
                for _ in range(n)]
        shape = [int(r.choice([2, 4, 8, 16, 32, 64, 6, 3])) for _ in axes]
        out.append((bool(i % 2), axes, shape))
    return out


SHARD_CASES = _shard_cases()


@pytest.fixture(scope="module")
def reference_shards():
    return run_jax_child(f"""
from jax.sharding import NamedSharding
from repro.distributed.meshrules import AxisRules
from repro.launch.mesh import make_production_mesh
rules = {{mp: AxisRules(make_production_mesh(multi_pod=mp))
          for mp in (False, True)}}
out = []
for mp, axes, shape in {SHARD_CASES!r}:
    sh = rules[mp].sharding_for(axes, shape)
    out.append([[e if e is None or isinstance(e, str) else list(e)
                 for e in sh.spec], list(sh.shard_shape(tuple(shape)))])
""")


@pytest.mark.parametrize("i", range(len(SHARD_CASES)))
def test_distribute_tensor_local_shapes_equal_reference(
        fake_world_512, reference_shards, i):  # noqa: F811
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh

    multi_pod, axes, shape = SHARD_CASES[i]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = TM.AxisRules(mesh)
    want_spec, want_local = reference_shards[i]
    sh = rules.sharding_for(axes, shape)
    assert spec_json(sh.spec) == want_spec
    assert list(sh.shard_shape(shape)) == want_local
    d = distribute_tensor(torch.zeros(shape), mesh,
                          rules.placements(axes, shape))
    assert list(d.to_local().shape) == want_local


def test_placements_of_a_tuple_entry(fake_world_512):  # noqa: F811
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_production_mesh

    rules = TM.AxisRules(make_production_mesh(multi_pod=True))
    assert rules.spec_for(("batch", "seq"), (64, 32)) == TM.P(
        ("pod", "data"), "model")
    assert rules.placements(("batch", "seq"), (64, 32)) == [
        Shard(0), Shard(0), Shard(1)]
    assert rules.placements((None, "d_head"), (4, 4)) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        TM.placements_for(TM.P(("model", "data")), rules.mesh)


def test_shard_hint_without_rules_is_identity():
    x = torch.ones(4, 4)
    assert TM.current_rules() is None
    assert TM.shard_hint(x, "batch", "seq") is x
    assert TM.logical_sharding(("batch",), (4,)) is None


def test_shard_hint_redistributes_a_dtensor(fake_world_512):  # noqa: F811
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    rules = TM.AxisRules(mesh)
    x = distribute_tensor(torch.zeros(32, 64), mesh,
                          [Replicate(), Replicate()])
    with TM.use_rules(rules):
        y = TM.shard_hint(x, "batch", "seq")
        assert TM.logical_sharding(("batch",), (32,)).spec == TM.P("data")
    assert list(y.placements) == rules.placements(("batch", "seq"),
                                                  (32, 64))
    assert tuple(y.to_local().shape) == (2, 4)
    assert TM.current_rules() is None


def test_shard_hint_plain_tensor_on_a_world_of_one():
    rules = TM.AxisRules(_PortMesh(("data", "model"), (1, 1)))
    x = torch.ones(4, 4)
    with TM.use_rules(rules):
        assert TM.shard_hint(x, "batch", "seq") is x


def test_shard_hint_plain_tensor_on_a_larger_mesh_raises():
    rules = TM.AxisRules(_PortMesh(("data", "model"), (16, 16)))
    with TM.use_rules(rules), pytest.raises(ValueError, match="plain"):
        TM.shard_hint(torch.ones(32, 32), "batch", "seq")


def test_use_rules_nests_and_restores():
    a = TM.AxisRules(_PortMesh(("data",), (2,)))
    b = TM.AxisRules(_PortMesh(("model",), (4,)))
    with TM.use_rules(a):
        with TM.use_rules(b):
            assert TM.current_rules() is b
        assert TM.current_rules() is a
    assert TM.current_rules() is None
