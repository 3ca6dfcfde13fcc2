"""The forward cells on DTensors (``specs.place_args`` under
``meshrules.use_rules``) against ``rules=None`` and against the JAX
package on the same mesh.

- A world of one (gloo, one rank, in this process): a reduced cell of
  each wired family placed on the 1x1 mesh is bit-equal to the same
  cell with ``rules=None``, runs no collective, and takes its hand
  kernels' DTensor branches; the router's plan equals ``plan_batch``.
- A world of four (gloo ranks spawned once for the module) on a (2, 2)
  ``("data", "model")`` mesh against the reference under ``jax.jit``
  and ``use_rules`` on four host devices (a child interpreter, beside
  the world): float32 within 2e-5, top-k ids and routing plans
  identical, two runs of each step bit-equal, and the placements
  really shard ``batch``, ``heads``, ``kv_seq``, ``vocab`` and
  ``table_rows``; the qwen3 prefill with ``attention_impl="pallas"``
  runs the flash op's ``local_map`` on batch and head shards of q and
  k; ``meshrules.einsum`` keeps a product whose contracted dim both
  operands cut as partial sums, sending nothing; ``embedding_bag``'s
  lookup on a row-sharded table keeps the NaN rows and wrapped ids of
  the whole table's.
- The kernels no forward cell hands a DTensor refuse one.
Every test leaves ``torch.distributed.is_initialized()`` false."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_mesh_common import finish_jax_child, start_jax_child
from torch_mesh_world import (build_reduced, in_process_world_of_one,
                              numpy_tree, run_on_mesh, run_world)

from repro_torch.distributed.meshrules import AxisRules

ROUTE_DIMS = {"seq_len": 64, "global_batch": 64}     # a plan that selects
# (arch, shape, dims replacing the reduced shape's)
CELLS = [("qwen3-1.7b", "prefill_32k", None),
         ("qwen3-1.7b", "decode_32k", None),
         ("adaparse-router", "route_64k", ROUTE_DIMS),
         ("nougat-base", "parse_encode", None),
         ("nougat-base", "parse_decode", None),
         ("dlrm-mlperf", "serve_p99", None),
         ("deepfm", "serve_p99", None),
         ("autoint", "serve_p99", None),
         ("dien", "serve_p99", None),
         ("dlrm-mlperf", "retrieval_cand", None)]
IDS = [f"{a}/{s}" for a, s, _ in CELLS]
# run again with the hand flash kernel's op (its plain version here)
PALLAS = ("qwen3-1.7b", "prefill_32k", "pallas")

JAX_CELLS = """
import dataclasses
import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.distributed.meshrules import AxisRules, use_rules
from repro.launch import specs as JS
from repro.launch.mesh import make_mesh

mesh = make_mesh((2, 2), ("data", "model"))
rules = AxisRules(mesh)
out = {}
for a, s, dims, raw, impl in INPUTS:
    arch = get_config(a).reduced()
    sh = JS._reduce_shape(arch.family, arch.shape(s))
    sh = ShapeConfig(sh.name, sh.kind, {**sh.dims, **(dims or {})}, sh.note)
    if impl:
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, attention_impl=impl))
        c = JS._lm_prefill_cell(arch, sh, rules, False)
    elif dims:
        c = JS._router_cell(arch, sh, rules, False)
    else:
        c = JS.build_cell(a, s, rules=rules, abstract=False, reduced=True)
    args = (jax.tree_util.tree_map(jnp.asarray, raw),) + tuple(c.args[1:])
    with mesh, use_rules(rules):
        res = jax.jit(c.fn, in_shardings=c.in_shardings)(*args)
    key = f"{a}/{s}" + (f"/{impl}" if impl else "")
    out[key] = [np.asarray(x) for x in jax.tree_util.tree_leaves(res)]
"""

TABLE = np.random.RandomState(3).randn(16, 4).astype(np.float32)
# wrapped (-1, -16), last row (15), outside [-16, 16) (16, -17, 99)
LOOKUP_IDS = np.array([3, -1, 15, 16, -16, -17, 8, 99, 0, 7], np.int64)
# an activation (b, s, f) and a weight (f, d) for meshrules.einsum
EINSUM = tuple(np.random.RandomState(4).randn(*sh).astype(np.float32)
               for sh in ((4, 3, 8), (8, 6)))


@pytest.fixture(scope="module")
def four():
    """(the port's world of four, the reference's outputs). Both take
    the port's reduced params (seeded draws, in the reference's raw
    layout), and the JAX child runs beside the world."""
    assert not dist.is_initialized()
    cells = [(a, s, d, numpy_tree(build_reduced(a, s, None, dims=d,
                                                impl=i).args[0]), i)
             for a, s, d, i in [c + (None,) for c in CELLS]
             + [PALLAS[:2] + (None, PALLAS[2])]]
    child = start_jax_child(JAX_CELLS, devices=4, inputs=cells)
    payload = {"cells": cells, "table": TABLE, "ids": LOOKUP_IDS,
               "einsum": EINSUM}
    port = run_world(4, (2, 2), ("data", "model"), "exec_task", payload,
                     timeout=300)
    ref = finish_jax_child(child, timeout=300)
    assert not dist.is_initialized()
    return port, ref


def _assert_close(got, want, tol=2e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g.astype(np.float32),
                                       w.astype(np.float32), rtol=tol,
                                       atol=tol)
        else:
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- world of one


@pytest.mark.parametrize("arch, shape, dims", CELLS, ids=IDS)
def test_world_of_one_bit_equal_to_no_rules(arch, shape, dims):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.common import tree_leaves

    plain = build_reduced(arch, shape, None, dims=dims)
    want = tree_leaves(plain.fn(*plain.args))
    with in_process_world_of_one() as mesh:
        rules = AxisRules(mesh)
        cell = build_reduced(arch, shape, rules, dims=dims)
        with CommDebugMode() as comm:
            got, _ = run_on_mesh(cell, rules)
        assert comm.get_total_counts() == 0
        assert all(isinstance(g, DTensor) for g in got
                   if isinstance(g, torch.Tensor))
        got = [g.to_local() if isinstance(g, DTensor) else g for g in got]
    assert not dist.is_initialized()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.uint8) if g.is_floating_point()
                           else g, w.view(torch.uint8)
                           if w.is_floating_point() else w)
    if shape == "route_64k":
        from repro_torch.core.scheduler import plan_batch

        out = dict(zip(sorted(["pred_acc", "improvement", "selected_mask",
                               "selected_idx", "routed_tokens", "count"]),
                       got))
        idx = out["selected_idx"].numpy()
        plan = plan_batch(out["improvement"].numpy(), 0.05)
        assert set(idx[idx >= 0].tolist()) == \
            set(plan.expensive_idx.tolist()) != set()


def test_world_of_one_hand_kernels_take_their_dtensor_branches():
    """flash_attention through local_map, budget_route replicated and
    embedding_bag's lookup by row range: each gives a DTensor equal to
    the plain call."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.budget_route import budget_route
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.flash_attention.ops import flash_attention

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 16, 4, 8, generator=g)
    k = torch.randn(2, 16, 2, 8, generator=g)
    v = torch.randn(2, 16, 2, 8, generator=g)
    scores = torch.randn(64, generator=g)
    tokens = torch.randn(64, 4, generator=g)
    table = torch.randn(12, 4, generator=g)
    ids = torch.tensor([0, -1, 11, 12, 5])
    with in_process_world_of_one() as mesh:
        def d(t):
            return DTensor.from_local(t, mesh, [Replicate(), Replicate()])

        rules = AxisRules(mesh)
        from repro_torch.distributed.meshrules import use_rules

        with use_rules(rules):
            fa = flash_attention(d(q), d(k), d(v), causal=True)
            br = budget_route(d(scores), d(tokens), 0.25)
            lk = bag_ops.lookup(d(table), ids)
        assert all(isinstance(t, DTensor) for t in (fa, *br, lk))
        assert torch.equal(fa.to_local(), flash_attention(q, k, v))
        for a, b in zip(br, budget_route(scores, tokens, 0.25)):
            assert torch.equal(a.to_local(), b)
        torch.testing.assert_close(lk.to_local(),
                                   bag_ops.lookup(table, ids),
                                   rtol=0, atol=0, equal_nan=True)
    assert not dist.is_initialized()


def test_kernels_without_a_mesh_path_refuse_a_dtensor():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.fast_features.ops import fast_features
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ngram_score.ops import ngram_bleu
    from repro_torch.kernels.segment_mm import ops as sm

    with in_process_world_of_one() as mesh:
        def d(t, *pl):
            return DTensor.from_local(t, mesh, list(pl) or [Replicate()] * 2)

        i32 = torch.zeros(4, 8, dtype=torch.int32)
        n = torch.full((4,), 3, dtype=torch.int32)
        x = torch.randn(10, 8)
        e = torch.zeros(30, dtype=torch.int32)
        calls = {
            "fast_features": lambda: fast_features(
                d(i32), n, n, n, n, max_len=8, ws=2, scramble=3, mangled=4,
                latex_lo=800, ident_lo=850, vocab_size=1000),
            "ngram_bleu": lambda: ngram_bleu(d(i32), i32, n, n),
            "segment_matmul": lambda: sm.segment_matmul(
                d(x), e, e, torch.randn(8, 4), n_nodes=10),
            "segment_matmul_kernel": lambda: sm.segment_matmul_kernel(
                d(torch.randn(30, 8)), torch.randn(8, 4), e, n_nodes=10),
            "embedding_bag": lambda: bag_ops.embedding_bag(
                d(x), torch.zeros(4, 2, dtype=torch.int64)),
            "embedding_bag_backward": lambda: bag_ops.embedding_bag_backward(
                d(torch.randn(30, 8)), e.long(), 10),
            "segment_sum": lambda: bag_ops.segment_sum(
                d(torch.randn(30, 8)), e, 10),
        }
        for name, call in calls.items():
            with pytest.raises(TypeError, match="DTensor"):
                call()
        # a sequence or d_head shard would number positions or sum dot
        # products wrongly on a rank
        q = torch.randn(2, 16, 4, 8)
        for dim in (1, 3):
            with pytest.raises(ValueError, match="batch and head"):
                flash_attention(d(q, Shard(dim), Replicate()), d(q), d(q))
    assert not dist.is_initialized()


# ------------------------------------------------------------ world of four


@pytest.mark.parametrize("arch, shape, dims", CELLS, ids=IDS)
def test_world_of_four_matches_the_reference(four, arch, shape, dims):
    port, ref = four
    _assert_close(port["cells"][f"{arch}/{shape}"]["runs"][0],
                  ref[f"{arch}/{shape}"])


@pytest.mark.parametrize("arch, shape, dims", CELLS, ids=IDS)
def test_world_of_four_two_runs_bit_equal(four, arch, shape, dims):
    a, b = four[0]["cells"][f"{arch}/{shape}"]["runs"]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_world_of_four_really_shards(four):
    """The placed arguments cut the hinted dims over the mesh."""
    cells = four[0]["cells"]

    def placements(cell, path):
        return dict(cells[cell]["placements"])[path]

    # batch: the prefill's tokens; vocab and heads: the embedding and wq
    assert placements("qwen3-1.7b/prefill_32k", "1") == ["S(0)", "S(1)"]
    assert "S(0)" in placements("qwen3-1.7b/prefill_32k", "0/embed")
    assert "S(2)" in placements("qwen3-1.7b/prefill_32k", "0/layers/wq")
    # kv_seq: the decode cache (L, B, S, Hk, Dh) cut on S
    assert "S(2)" in placements("qwen3-1.7b/decode_32k", "2/0")
    # table_rows: the recsys table
    assert "S(0)" in placements("dlrm-mlperf/serve_p99", "0/table")


def test_world_of_four_flash_op_on_head_and_batch_shards(four):
    """The qwen3 prefill with ``attention_impl="pallas"``: the flash op's
    ``local_map`` takes q and k cut over batch ("data") and heads
    ("model": the reduced config's 4 q heads and 2 kv heads, so a rank's
    q heads read its own kv head), once a layer and run; its outputs
    match the reference's Pallas kernel on the same mesh within 2e-5,
    and two runs are bit-equal."""
    port, ref = four
    key = "/".join(PALLAS)
    got = port["cells"][key]
    assert len(got["local_map"]) == 2 * 2           # 2 layers, 2 runs
    for q_pl, k_pl, v_pl in got["local_map"]:
        assert q_pl == k_pl == v_pl == ["S(0)", "S(2)"]
    _assert_close(got["runs"][0], ref[key])
    for x, y in zip(*got["runs"]):
        np.testing.assert_array_equal(x, y)


def test_einsum_keeps_a_cut_contraction_as_partial_sums(four):
    """The row-parallel product of two operands cut on their contracted
    dim over "model" gives partial sums there and sends nothing; the
    column-parallel one cuts its output; both equal the plain
    products."""
    got = four[0]["einsum"]
    assert got["row"]["placements"] == ["S(0)", "P(sum)"]
    assert got["col"]["placements"] == ["S(0)", "S(2)"]
    for case in got.values():
        assert case["collectives"] == 0
        np.testing.assert_allclose(case["got"], case["want"], rtol=1e-6,
                                   atol=1e-6)


def test_lookup_on_a_row_sharded_table(four):
    got = four[0]["lookup"]
    assert "S(0)" in got["table_placements"]
    assert "P(sum)" in got["out_placements"]
    np.testing.assert_array_equal(got["got"], got["want"])
    assert np.isnan(got["got"][[3, 5, 7]]).all()
    assert not np.isnan(np.delete(got["got"], [3, 5, 7], 0)).any()
