"""A world of gloo processes for the mesh execution tests
(``test_torch_mesh_exec.py``, ``test_torch_moe_mesh.py``). It imports
no JAX: the spawned ranks start in seconds.

``run_world(n, shape, names, task, payload)`` spawns ``n`` ranks that
join one gloo group (a file store under a temporary directory: no
port), build a ``DeviceMesh`` of ``shape`` with dims ``names`` and call
``task(mesh, payload)`` (a function of this module, by name); rank 0's
return value comes back, pickled. Every wait has a limit. The ranks run
one intra-op thread each.

``in_process_world_of_one()`` is the same group of one rank in the
calling process, destroyed after the block.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import tempfile
import traceback

import numpy as np
import torch

# ------------------------------------------------------------------ worlds


def _rank_main(rank, n, store, shape, names, task, payload, out):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        result = globals()[task](make_mesh(shape, names), payload)
    except Exception:  # noqa: BLE001
        result = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(result, f)


def run_world(n: int, shape, names, task: str, payload,
              timeout: float = 240.0):
    """Rank 0's result of ``task`` on a world of ``n`` gloo ranks."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "out")
        saved = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            procs = [ctx.Process(target=_rank_main, args=(
                r, n, store, tuple(shape), tuple(names), task, payload,
                out)) for r in range(n)]
            for p in procs:
                p.start()
        finally:
            if saved is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = saved
        for p in procs:
            p.join(timeout)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        assert not alive, f"{task}: {len(alive)} ranks still running"
        assert all(p.exitcode == 0 for p in procs), \
            [p.exitcode for p in procs]
        with open(out, "rb") as f:
            result = pickle.load(f)
    assert "error" not in result, result.get("error")
    return result


@contextlib.contextmanager
def in_process_world_of_one():
    """A gloo group of one rank in this process and its 1x1 mesh
    ``("data", "model")``; the group is destroyed after the block."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ helpers


def port_params(family: str, raw, cfg):
    """The reference's raw params (numpy leaves) as the port's, with no
    JAX in the process."""
    from repro_torch.launch import specs as TS
    from repro_torch.models.encoder import encoder_from_jax_params
    from repro_torch.models.recsys.models import recsys_from_jax_params
    from repro_torch.models.transformer import lm_from_jax_params
    from repro_torch.models.vit_parser import vit_parser_from_jax_params

    if family == "lm":
        return lm_from_jax_params(raw, cfg, "cpu")
    if family == "recsys":
        return recsys_from_jax_params(raw, cfg, "cpu")
    if family == "vit_parser":
        return vit_parser_from_jax_params(raw, cfg, "cpu")
    if family == "encoder":
        return TS.router_param_tree(encoder_from_jax_params(raw, cfg, "cpu"))
    raise ValueError(family)


def whole(x):
    """A leaf as a numpy array on every rank: a DTensor gathered (a
    collective: every rank calls it in the same order)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def placements_of(tree) -> list[tuple[str, list[str]]]:
    """(key path, placements) of every DTensor leaf of ``tree``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.common import tree_leaves_with_path

    return [("/".join(str(k) for k in path), [str(p) for p in t.placements])
            for path, t in tree_leaves_with_path(tree)
            if isinstance(t, DTensor)]


def build_reduced(arch: str, shape: str, rules, raw=None, dims=None,
                  impl=None):
    """The port's reduced cell on the CPU with ``rules`` (``dims``
    replacing some of the reduced shape's; an LM's ``attention_impl``
    ``impl`` when given), with the reference's params ``raw`` carried
    across when given."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import specs as TS

    tarch, sh = TS.cell_shape(arch, shape, reduced=True)
    if impl:
        tarch = dataclasses.replace(tarch, model=dataclasses.replace(
            tarch.model, attention_impl=impl))
    if dims:
        sh = ShapeConfig(sh.name, sh.kind, {**sh.dims, **dims}, sh.note)
    cell = TS.build_cell_for(tarch, sh, rules, abstract=False, seed=0,
                             device="cpu")
    if raw is not None:
        cell.args = (port_params(tarch.family, raw, tarch.model),) \
            + tuple(cell.args[1:])
    return cell


def run_on_mesh(cell, rules):
    """One step of ``cell`` on its arguments placed as DTensors, under
    ``rules``; (the outputs' leaves, the placed arguments)."""
    from repro_torch.common import tree_leaves
    from repro_torch.distributed.meshrules import use_rules
    from repro_torch.launch import specs as TS

    args = TS.place_args(cell)
    with use_rules(rules):
        out = cell.fn(*args)
    return tree_leaves(out), args


# -------------------------------------------------------------------- tasks


@contextlib.contextmanager
def local_map_calls():
    """The ``in_placements`` of every ``local_map`` call in the block, as
    strings (the flash kernel's DTensor branch is the port's one
    caller)."""
    import torch.distributed.tensor.experimental as experimental

    orig, calls = experimental.local_map, []

    def spy(*args, **kwargs):
        calls.append([[str(p) for p in pl]
                      for pl in kwargs["in_placements"]])
        return orig(*args, **kwargs)

    experimental.local_map = spy
    try:
        yield calls
    finally:
        experimental.local_map = orig


def cell_key(arch: str, shape: str, impl=None) -> str:
    return f"{arch}/{shape}" + (f"/{impl}" if impl else "")


def cells_task(mesh, payload):
    """Each (arch, shape, dims, raw params, attention impl) of
    ``payload["cells"]``, its step run twice on ``mesh`` (a decode step
    writes the same cache rows again): {cell: {"runs": [[leaf arrays] x
    2], "placements": placed argument placements, "local_map": the
    placements each ``local_map`` call took}}."""
    from repro_torch.distributed.meshrules import AxisRules

    rules = AxisRules(mesh)
    out = {}
    for arch, shape, dims, raw, impl in payload["cells"]:
        runs, placed = [], None
        cell = build_reduced(arch, shape, rules, raw, dims, impl)
        with local_map_calls() as calls:
            for _ in range(2):
                leaves, placed = run_on_mesh(cell, rules)
                runs.append([whole(x) for x in leaves])
        out[cell_key(arch, shape, impl)] = {
            "runs": runs, "placements": placements_of(placed),
            "local_map": calls}
    return out


def exec_task(mesh, payload):
    """``cells_task``, ``lookup_task`` and ``einsum_task`` in one
    world."""
    return {"cells": cells_task(mesh, payload),
            "lookup": lookup_task(mesh, payload),
            "einsum": einsum_task(mesh, payload)}


def einsum_task(mesh, payload):
    """``meshrules.einsum`` of a row-parallel product (``bsf,fd->bsd``,
    f cut over "model" in both operands, b over "data") and of a
    column-parallel one (``bsd,df->bsf``, f cut over "model" in the
    weight): the outputs' placements, the collectives each product
    issued, and the whole results against the plain products."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed.meshrules import P, NamedSharding, einsum
    from repro_torch.launch.specs import place_tensor

    def put(t, *spec):
        return place_tensor(t, NamedSharding(mesh, P(*spec)))

    x, w = (torch.from_numpy(a) for a in payload["einsum"])
    h = torch.einsum("bsf,fd->bsd", x, w)
    out = {}
    for name, eq, a, b in (
            ("row", "bsf,fd->bsd", put(x, "data", None, "model"),
             put(w, "model", None)),
            ("col", "bsd,df->bsf", put(h, "data", None, None),
             put(w.T.contiguous(), None, "model"))):
        with CommDebugMode() as comm:
            got = einsum(eq, a, b)
        out[name] = {"placements": [str(p) for p in got.placements],
                     "collectives": comm.get_total_counts(),
                     "got": whole(got),
                     "want": torch.einsum(eq, a.full_tensor(),
                                          b.full_tensor()).numpy()}
    return out


def lookup_task(mesh, payload):
    """``embedding_bag.ops.lookup`` of a table whose rows are cut over
    "model", against the plain lookup of the whole table."""
    from repro_torch.distributed.meshrules import AxisRules, use_rules
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.launch.specs import place_tensor

    rules = AxisRules(mesh)
    table = torch.from_numpy(payload["table"])
    ids = torch.from_numpy(payload["ids"])
    sh = rules.sharding_for(("table_rows", "embed_dim"), tuple(table.shape))
    dt = place_tensor(table, sh)
    with use_rules(rules):
        got = bag_ops.lookup(dt, ids)
    return {"got": whole(got), "want": bag_ops.lookup(table, ids).numpy(),
            "table_placements": [str(p) for p in dt.placements],
            "out_placements": [str(p) for p in got.placements]}


def moe_task(mesh, payload):
    """``moe_ffn`` on each mesh of ``payload["meshes"]`` (over the same
    ranks) with each config of ``payload["cfgs"]``: y, aux, y's
    placements and every rank's routing trace, or the error it
    raised, keyed "<mesh>/<router>"."""
    import torch.distributed as dist

    from repro_torch.configs.base import MoEConfig
    from repro_torch.distributed.meshrules import AxisRules, use_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import place_tensor
    from repro_torch.models import moe

    x = torch.from_numpy(payload["x"])
    p = {k: torch.from_numpy(v) for k, v in payload["params"].items()}
    out = {}
    for shape, names in payload["meshes"]:
        rules = AxisRules(make_mesh(shape, names))
        tag = "x".join(map(str, shape))
        for kw in payload["cfgs"]:
            cfg = MoEConfig(**kw)
            axes = moe.moe_shapes(x.shape[-1], cfg)
            xs = place_tensor(x, rules.sharding_for(
                ("batch", "seq", "d_model"), tuple(x.shape)))
            ps = {k: place_tensor(v, rules.sharding_for(
                axes[k][2], tuple(v.shape))) for k, v in p.items()}
            try:
                with use_rules(rules), moe.routing_trace() as trace:
                    y, aux = moe.moe_ffn(xs, ps, cfg)
            except ValueError as e:
                out[f"{tag}/{cfg.router}"] = {"error": str(e)}
                continue
            mine = [{k: v.numpy() for k, v in rec.items()} for rec in trace]
            traces = [None] * dist.get_world_size()
            dist.all_gather_object(traces, mine)
            out[f"{tag}/{cfg.router}"] = {
                "y": whole(y), "aux": float(whole(aux)), "traces": traces,
                "placements": [str(q) for q in y.placements]}
    return out


def numpy_tree(tree):
    """A tree of tensors as numpy (for pickling to the ranks)."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(numpy_tree(v) for v in tree)
    return np.asarray(tree)
