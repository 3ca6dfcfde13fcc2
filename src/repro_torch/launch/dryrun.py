"""Dry run: every (arch x shape) cell on a mesh, shape only, with its
memory fit and roofline terms at the H100's datasheet peaks; the port of
``repro/launch/dryrun.py``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch qwen3-1.7b] [--shape train_4k] [--multi-pod] [--both] \\
        [--no-costing] [--out results/dryrun]

The reference lowers and compiles each cell for 256 or 512 host devices
and reads XLA's memory and cost analyses. The port has no compiler in
between, so for each cell it

1. builds the cell with ``abstract=True`` (every argument on ``meta``)
   and ``AxisRules`` on the mesh, and sums each argument's largest
   shard (``meshrules.local_shape``: ceil division, as GSPMD pads);
2. runs the step once on meta under ``roofline.OpCounter`` (no card, no
   allocation): its FLOPs and bytes, and the peak of its live
   intermediates. The run is global, one process for the whole mesh:
   FLOPs and bytes a device are the global counts over ``chips`` (the
   ideal partition, which a real partition only approaches), and the
   temporaries a device are the global peak over the cell's
   data-parallel factor (``batch_shards``: the shards its batch
   arguments are cut into over the ``pod`` and ``data`` dims; the
   ``model`` dim is not counted). Both are reckonings, not
   measurements;
3. for a forward cell (serve, prefill, decode, route), runs the step
   once more on the mesh itself: its arguments as meta DTensors
   (``specs.place_args``) under ``use_rules``, on the fake backend,
   which sends nothing; ``roofline.CollCounter`` counts each collective
   a rank issues by kind (``coll_costs``), and ``t_collective`` takes
   them at ``mesh.NVLINK_BW``. A mesh of more than 8 cards crosses
   nodes, whose links are slower, so that term is a lower bound. Train
   and GNN cells run on the mesh in a later slice: ``coll_bytes`` None;
4. records ``per_device_mem`` = argument shards + temporaries, whether
   it fits the card's 80 GB (``fits_hbm``; ``mem_gb`` in 1e9 bytes) and
   the roofline terms.

``--no-costing`` skips step 2: FLOPs, bytes and temporaries are None and
``per_device_mem`` holds the argument shards alone. An LM's meta run is
two runs, of one and of two layers, extrapolated to its depth
(``costing_plan``, ``scan_corrected`` True), as the reference extrapolates
its costing compiles; the collectives of an LM are counted the same
way, with the reference's coarse attention chunks for a sequence of 16k
or more (2,048 queries and 4,096 keys a block, its ``costing_plan``'s:
the block loop sends nothing, so only its op count changes). With
``--both`` each cell's meta run is made once and read on both meshes.

The production meshes are ``DeviceMesh``es on torch's fake backend
(``launch/mesh.fake_world``), started when ``main`` or ``run_cell``
without a mesh runs, never at import; ``run_cell(..., mesh=...)`` takes
any mesh (``chip_smoke.py`` gives it a 1x1 mesh on NCCL), and ``arch``
and ``shape`` for a cut of a registered cell.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.common import tree_leaves
from repro_torch.distributed.meshrules import AxisRules, NamedSharding
from repro_torch.kernels import meta as meta_lib
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import HBM_BYTES


def _is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


def arg_shards(cell) -> list[tuple[torch.Tensor, NamedSharding]]:
    """Each argument leaf with its sharding (``cell.in_shardings``)."""
    args = tree_leaves(cell.args)
    shs = tree_leaves(cell.in_shardings, _is_sharding)
    if len(args) != len(shs):
        raise ValueError(f"{cell.arch_id}/{cell.shape_name}: "
                         f"{len(args)} arguments, {len(shs)} shardings")
    return list(zip(args, shs))


def arg_bytes_per_device(cell) -> int:
    """Bytes of the largest shard of every argument on one device."""
    return sum(math.prod(sh.shard_shape(t.shape)) * t.element_size()
               for t, sh in arg_shards(cell))


def batch_shards(cell, rules: AxisRules) -> int:
    """The data-parallel factor of the cell's batch: the most shards any
    batch argument (a train cell's batch dict; every argument after the
    params of the others) is cut into over the mesh dims the rules map
    the logical ``batch`` axis to (``pod`` and ``data``). The factor a
    step's temporaries are divided by: a model-parallel dim cuts an
    argument but not the step's activations in this reckoning."""
    batch = cell.args[-1:] if cell.kind == "train" else cell.args[1:]
    n_batch = len(tree_leaves(batch))
    pairs = arg_shards(cell)
    data_dims = [a for a in rules.rules.get("batch", ()) if a in rules.shape]
    out = 1
    for _, sh in pairs[len(pairs) - n_batch:]:
        used = sh.spec.mesh_dims()
        out = max(out, math.prod(rules.shape[a] for a in data_dims
                                 if a in used))
    return out


def meta_costs(cell, trace: bool = False) -> dict:
    """One step of ``cell`` (meta arguments) under ``OpCounter``: global
    FLOPs, bytes, heavy-op bytes, the peak of live intermediates, each
    hand kernel's charged calls, FLOPs and bytes, and with ``trace`` the
    live bytes after every op."""
    t0 = time.perf_counter()
    counter = rl.OpCounter(resident=cell.args, trace=trace)
    with meta_lib.charges(counter.charge), counter:
        out = cell.fn(*cell.args)
        del out
    return {"flops": counter.flops,
            "flops_by_dtype": dict(counter.flops_by_dtype),
            "hbm_bytes": counter.hbm_bytes,
            "hbm_bytes_fused": counter.hbm_bytes_fused,
            "temp_bytes": counter.peak_bytes, "kernels": counter.kernels,
            "trace": counter.trace, "meta_s": time.perf_counter() - t0}


def costing_plan(arch) -> list[tuple[object, float]] | None:
    """[(model config, coefficient)] whose weighted sum of meta runs
    stands for the whole model, or None to run it whole. An LM's layers
    are identical, so its counts are linear in the layer count: they are
    taken from runs of one and two layers, c1 * (2 - L) + c2 * (L - 1),
    as the reference's ``costing_plan`` does (there to correct XLA's
    count of a scanned loop, here because a meta run pays Python's cost
    per op: a 32k prefill's attention runs about 1,000 block pairs a
    layer). The peak of live intermediates is not linear (the op that
    sets it can change with depth: a prefill's last stack of the layers'
    caches outgrows any one layer's temporaries), so it is taken from the
    two runs' traces (``extrapolated_peak``)."""
    if arch.family != "lm":
        return None
    L = arch.model.n_layers
    mk = lambda n: dataclasses.replace(arch.model, n_layers=n)  # noqa: E731
    return [(mk(1), 2.0 - L), (mk(2), L - 1.0)]


def _lcp(a: list, b: list) -> int:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def extrapolated_peak(t1: list, t2: list, n_layers: int) -> int | None:
    """The live-bytes peak of an ``n_layers``-deep step from the traces
    (op name, live bytes) of its one- and two-layer runs. The two-layer
    run's ops are split as prefix P, layer blocks B1 B2 and suffix S,
    where the one-layer run's are P B S (op names equal). At depth L the
    prefix is unchanged; the last layer block lives at B2 + (L - 2)(B2 -
    B1), every earlier one below it; the suffix at S1 + (L - 1)(S2 - S1),
    op by op. None when the traces do not split so."""
    names1 = [n for n, _ in t1]
    names2 = [n for n, _ in t2]
    blk = len(t2) - len(t1)
    if blk <= 0:
        return None
    lcp = _lcp(names1, names2)
    lcs = _lcp(names1[::-1], names2[::-1])
    for p in range(max(0, len(t1) - blk - lcs), min(lcp, len(t1) - blk) + 1):
        if names2[p:p + blk] != names2[p + blk:p + 2 * blk]:
            continue
        L = n_layers
        pre = [v for _, v in t2[:p]]
        last = [b + (L - 2) * (b - a) for (_, a), (_, b) in
                zip(t2[p:p + blk], t2[p + blk:p + 2 * blk])]
        s1, s2 = t1[p + blk:], t2[p + 2 * blk:]
        suf = [a + (L - 1) * (b - a) for (_, a), (_, b) in zip(s1, s2)]
        return max(pre + last + suf)
    return None


def step_costs(arch, shape) -> dict:
    """``meta_costs`` of the (arch, shape) cell, through ``costing_plan``
    where it has one (``scan_corrected`` then True)."""
    from repro_torch.launch import specs

    plan = costing_plan(arch)
    if plan is None:
        costs = meta_costs(specs.build_cell_for(arch, shape, None, True))
        return {**costs, "scan_corrected": False}
    out = {"flops": 0.0, "hbm_bytes": 0.0, "hbm_bytes_fused": 0.0,
           "temp_bytes": 0.0, "kernels": {}, "meta_s": 0.0,
           "flops_by_dtype": {}, "scan_corrected": True}
    traces = []
    for model, coef in plan:
        c = meta_costs(specs.build_cell_for(
            dataclasses.replace(arch, model=model), shape, None, True),
            trace=True)
        traces.append(c["trace"])
        for k in ("flops", "hbm_bytes", "hbm_bytes_fused", "temp_bytes"):
            out[k] += coef * c[k]
        out["meta_s"] += c["meta_s"]
        for d, f in c["flops_by_dtype"].items():
            out["flops_by_dtype"][d] = (out["flops_by_dtype"].get(d, 0.0)
                                        + coef * f)
        for name, kc in c["kernels"].items():
            acc = out["kernels"].setdefault(name, {"calls": 0.0,
                                                   "flops": 0.0,
                                                   "bytes": 0.0})
            for k in acc:
                acc[k] += coef * kc[k]
    for k in ("flops", "hbm_bytes", "hbm_bytes_fused", "temp_bytes"):
        out[k] = max(out[k], 0.0)
    out["flops_by_dtype"] = {d: max(f, 0.0)
                             for d, f in out["flops_by_dtype"].items()}
    for kc in out["kernels"].values():
        kc["calls"] = round(kc["calls"])
    peak = extrapolated_peak(*traces, arch.model.n_layers)
    out["temp_bytes"] = int(out["temp_bytes"] if peak is None else peak)
    return out


def runs_on_mesh(arch, shape) -> bool:
    """Whether the cell's step runs on DTensors in this slice: every
    forward cell; train cells and the GNN's (all train) wait for the
    mesh's backward."""
    return shape.kind != "train" and arch.family != "gnn"


def coll_costs(arch, shape, rules: AxisRules) -> dict | None:
    """Per-device collective bytes by kind of one step of the cell on
    ``rules``' mesh (``roofline.CollCounter`` over the step on meta
    DTensors), through ``costing_plan`` as ``step_costs``; None for a
    cell that does not run on the mesh yet (``runs_on_mesh``)."""
    from repro_torch.distributed.meshrules import use_rules
    from repro_torch.launch import specs

    if not runs_on_mesh(arch, shape):
        return None
    plan = costing_plan(arch)
    if plan is None:
        plan = [(arch.model, 1.0)]
    elif shape.dims.get("seq_len", 0) >= 16384 and shape.kind == "prefill":
        plan = [(dataclasses.replace(m, q_chunk=2048, kv_chunk=4096), c)
                for m, c in plan]
    out = {k: 0.0 for k in rl.COLL_KINDS}
    for model, coef in plan:
        cell = specs.build_cell_for(dataclasses.replace(arch, model=model),
                                    shape, rules, True)
        counter = rl.CollCounter()
        with use_rules(rules), counter:
            cell.fn(*specs.place_args(cell))
        for k, v in counter.bytes.items():
            out[k] += coef * v
    return {k: max(v, 0.0) for k, v in out.items()}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool = False,
             costing: bool = True, verbose: bool = True, mesh=None,
             arch=None, shape=None, cache: dict | None = None) -> dict:
    """The dry run of one cell on ``mesh`` (default: the production mesh
    on the fake backend), as the record ``main`` writes. ``arch`` and
    ``shape`` (an ``ArchConfig`` and a ``ShapeConfig``) replace the
    registered ones; ``cache`` keeps meta runs across meshes."""
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import fake_production_mesh

    if mesh is None:
        mesh = fake_production_mesh(multi_pod=multi_pod)
    rules = AxisRules(mesh)
    chips = rules.size
    mesh_name = "x".join(str(s) for s in rules.shape.values())
    if arch is None or shape is None:
        arch, shape = specs.cell_shape(arch_id, shape_name)
    t0 = time.perf_counter()
    cell = specs.build_cell_for(arch, shape, rules, abstract=True)
    arg_bytes = arg_bytes_per_device(cell)
    t_build = time.perf_counter() - t0

    costs = None
    if costing:
        key = (arch_id, shape_name, repr(arch.model), repr(shape.dims))
        if cache is not None and key in cache:
            costs = cache[key]
        else:
            costs = step_costs(arch, shape)
            if cache is not None:
                cache[key] = costs
    coll = coll_costs(arch, shape, rules) if costing else None
    shards = batch_shards(cell, rules)
    temp = None if costs is None else -(-costs["temp_bytes"] // shards)
    per_dev = arg_bytes + (temp or 0)

    def per_chip(k):
        return None if costs is None else costs[k] / chips

    by_dtype = None if costs is None else {
        d: f / chips for d, f in costs["flops_by_dtype"].items()}

    rec = rl.Roofline(
        arch=arch_id, shape=shape_name, mesh=mesh_name, chips=chips,
        flops=per_chip("flops"), hbm_bytes=per_chip("hbm_bytes"),
        coll_bytes=coll, per_device_mem=int(per_dev),
        model_flops=rl.model_flops_for(arch_id, shape_name, arch, shape),
        hbm_bytes_fused=per_chip("hbm_bytes_fused"),
        flops_by_dtype=by_dtype).to_dict()
    rec["compile_s"] = round(time.perf_counter() - t0, 2)
    rec["prod_compile_s"] = round(t_build, 2)
    rec["fits_hbm"] = per_dev <= HBM_BYTES
    rec["mem_gb"] = round(per_dev / 1e9, 2)
    rec["scan_corrected"] = bool(costs and costs["scan_corrected"])
    rec.update(arg_bytes=arg_bytes, temp_bytes=temp, batch_shards=shards,
               flops_by_dtype=by_dtype,
               kernels=None if costs is None else costs["kernels"],
               shape_dims=dict(shape.dims), note=cell.note)
    if verbose:
        fl = "—" if rec["flops"] is None else f"{rec['flops'] / 1e9:.1f}"
        frac = ("—" if rec["roofline_fraction"] is None
                else f"{rec['roofline_fraction'] * 100:.1f}%")
        print(f"[dryrun] {arch_id}/{shape_name} mesh={mesh_name} "
              f"mem/dev={rec['mem_gb']}GB fits={rec['fits_hbm']} "
              f"GFLOPs/dev={fl} bottleneck={rec['bottleneck']} "
              f"frac={frac} ({rec['compile_s']}s)", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true")
    ap.add_argument("--no-costing", action="store_true",
                    help="skip the meta run: no FLOPs, bytes or "
                         "temporaries")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.specs import all_cells

    cells = all_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    meshes = [False, True] if args.both else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    cache: dict = {}
    with fake_world(512):
        for multi_pod in meshes:
            for arch_id, shape_name in cells:
                tag = (f"{arch_id}__{shape_name}__"
                       f"{'pod2' if multi_pod else 'pod1'}")
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[dryrun] skip cached {tag}", flush=True)
                    continue
                try:
                    rec = run_cell(arch_id, shape_name, multi_pod,
                                   costing=not args.no_costing, cache=cache)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                except Exception as e:  # noqa: BLE001
                    failures.append((tag, repr(e)))
                    print(f"[dryrun] FAIL {tag}: {e}", flush=True)
                    traceback.print_exc()
    print(f"\n[dryrun] done; {len(failures)} failures", flush=True)
    for t, e in failures:
        print("  FAIL", t, e[:200])
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
