"""``models/moe._moe_shardmap`` against the reference's on the same
mesh: the port's ``moe_ffn`` on DTensors in a world of four gloo ranks,
the reference's under ``jax.jit`` and ``use_rules`` on four host devices
(a child interpreter, beside the world), E = 8 experts, top-2 at
capacity factor 1.0 and the budget router at alpha 0.25, x (4, 16, 32)
float32 from a numpy seed.

- top-k on (2, 2) ``("data", "model")``: y within 2e-5 and aux (each
  data shard routes its own tokens at its own capacity, so both differ
  from one device's);
- top-k and budget on (4,) ``("data",)``: y, aux, and each rank's
  routing (``routing_trace``: the top-k ids and kept slots, the budget's
  token choice) equal to the reference's routing of the same shard;
- budget on (2, 2): both packages raise (ROADMAP §3: the reference's
  budget router never sums its partial sums over "model").
"""
import numpy as np
import pytest
import torch.distributed as dist

from torch_mesh_common import finish_jax_child, start_jax_child
from torch_mesh_world import run_world

E, K, D, FE = 8, 2, 32, 16
CFGS = [dict(n_experts=E, top_k=K, d_ff_expert=FE, capacity_factor=1.0,
             router="topk"),
        dict(n_experts=E, top_k=K, d_ff_expert=FE, capacity_factor=1.0,
             router="budget", budget_alpha=0.25)]
MESHES = [((2, 2), ("data", "model")), ((4,), ("data",))]

JAX_MOE = """
import math
import jax
import jax.numpy as jnp
from repro.configs.base import MoEConfig
from repro.distributed.meshrules import AxisRules, use_rules
from repro.launch.mesh import make_mesh
from repro.models.moe import moe_ffn

x, p, cfgs, meshes = (INPUTS[k] for k in ("x", "params", "cfgs", "meshes"))
x = jnp.asarray(x)
p = {k: jnp.asarray(v) for k, v in p.items()}
out = {}
for shape, names in meshes:
    mesh = make_mesh(shape, names)
    rules = AxisRules(mesh)
    tag = "x".join(map(str, shape))
    for kw in cfgs:
        cfg = MoEConfig(**kw)
        try:
            with mesh, use_rules(rules):
                y, aux = jax.jit(lambda a, b: moe_ffn(a, b, cfg))(x, p)
        except Exception as e:
            out[f"{tag}/{cfg.router}"] = {"error": f"{type(e).__name__}: {e}"}
            continue
        # each data shard's routing, as _moe_local routes it
        n_data = shape[list(names).index("data")]
        xt = np.asarray(x).reshape(-1, x.shape[-1])
        shards = []
        for xs in np.split(xt, n_data):
            probs = jax.nn.softmax(jnp.einsum(
                "td,de->te", jnp.asarray(xs), p["router"]), axis=-1)
            t = xs.shape[0]
            if cfg.router == "budget":
                cap = max(int(cfg.budget_alpha * t), 1)
                shards.append({"tok": np.asarray(
                    jax.lax.top_k(probs.T, cap)[1])})
                continue
            eids = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])
            cap = max(-(-int(cfg.capacity_factor * t * cfg.top_k)
                        // cfg.n_experts), 1)
            flat = eids.reshape(-1)
            order = np.argsort(flat, kind="stable")
            counts = np.bincount(flat, minlength=cfg.n_experts)
            starts = np.cumsum(counts) - counts
            keep = np.empty_like(flat, bool)
            keep[order] = (np.arange(flat.size) - starts[flat[order]]) < cap
            shards.append({"eids": eids, "keep": keep.reshape(t, -1)})
        out[f"{tag}/{cfg.router}"] = {"y": np.asarray(y),
                                      "aux": float(aux), "shards": shards}
"""


@pytest.fixture(scope="module")
def runs():
    assert not dist.is_initialized()
    rng = np.random.RandomState(0)
    payload = {
        "x": rng.randn(4, 16, D).astype(np.float32),
        "params": {"router": (rng.randn(D, E) / D ** 0.5).astype(np.float32),
                   "w_gate": (rng.randn(E, D, FE) / D ** 0.5).astype(
                       np.float32),
                   "w_up": (rng.randn(E, D, FE) / D ** 0.5).astype(
                       np.float32),
                   "w_down": (rng.randn(E, FE, D) / FE ** 0.5).astype(
                       np.float32)},
        "cfgs": CFGS, "meshes": MESHES}
    child = start_jax_child(JAX_MOE, devices=4, inputs=payload)
    port = run_world(4, (4,), ("data",), "moe_task", payload, timeout=240)
    ref = finish_jax_child(child, timeout=240)
    assert not dist.is_initialized()
    return port, ref


@pytest.mark.parametrize("case", ["2x2/topk", "4/topk", "4/budget"])
def test_moe_shardmap_matches_the_reference(runs, case):
    port, ref = runs
    got, want = port[case], ref[case]
    assert "error" not in got and "error" not in want, (got, want)
    np.testing.assert_allclose(got["y"], want["y"], rtol=2e-5, atol=2e-5)
    assert got["aux"] == pytest.approx(want["aux"], rel=2e-5, abs=2e-7)
    # tokens stay on their data shard: y is cut over the data dim
    assert got["placements"][0] == "S(0)"


@pytest.mark.parametrize("router", ["topk", "budget"])
def test_each_rank_routes_its_shard_as_the_reference(runs, router):
    port, ref = runs
    got, want = port[f"4/{router}"], ref[f"4/{router}"]
    assert len(got["traces"]) == len(want["shards"]) == 4
    for trace, shard in zip(got["traces"], want["shards"]):
        (rec,) = trace                        # one moe_ffn call a rank
        assert sorted(rec) == sorted(shard)
        for k in shard:
            np.testing.assert_array_equal(rec[k], shard[k])


def test_budget_router_on_a_model_dim_raises_in_both(runs):
    port, ref = runs
    assert "model" in port["2x2/budget"]["error"]
    assert "ValueError" in ref["2x2/budget"]["error"]
    assert "replication" in ref["2x2/budget"]["error"]
