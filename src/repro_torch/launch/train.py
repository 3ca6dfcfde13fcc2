"""Fault-tolerant training driver, the port of ``repro/launch/train.py``
on one card: the LM train cells, the GNN train cells, the recsys
``train_batch`` cell, the ViT parser's ``train_pages`` and the router's
``sft_4k``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --shape train_4k [--reduced] [--steps 100] [--ckpt-dir ckpts/qwen] \\
        [--ckpt-every 50] [--mesh 1x1] [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepfm|autoint|dien|dlrm-mlperf --shape train_batch [--reduced]
    PYTHONPATH=src python -m repro_torch.launch.train --arch equiformer-v2 \\
        --shape full_graph_sm|minibatch_lg|molecule [--reduced]
    PYTHONPATH=src python -m repro_torch.launch.train --arch nougat-base \\
        --shape train_pages [--reduced]
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch adaparse-router --shape sft_4k [--reduced]

A GNN cell's model is the arch's with the dataset's input width and
output count (``specs.gnn_cell_config``); ``ogb_products`` at full size
does not fit one card and raises with the reckoning
(``specs.gnn_refusal``); its reduced cell trains. The router trains its
``Encoder`` through ``specs.router_train_step`` on the JAX package's raw
param layout (``specs.router_param_tree``), so its optimizer state and
checkpoint line up with the reference's leaves. ``dpo_2k`` is refused:
the reference's CLI cannot run it (``DPO_REFUSAL``); DPO trains through
``core/dpo.py``.

As the reference does:
- restart-from-latest: on launch, restores the newest checkpoint in
  --ckpt-dir (params, optimizer state and step) and resumes;
- the batch of step ``t`` is drawn from seed ``t + 1`` (a stateless
  pipeline), so a resumed run equals an uninterrupted one bit for bit;
- atomic async checkpoints every --ckpt-every steps (the previous write
  joined first), and a final save at the end;
- SIGTERM: checkpoint and exit;
- step durations go to a ``StragglerDetector``.

On one card: ``--device`` (cuda unless "cpu") places the params, the
optimizer state and each batch; ``--mesh`` takes only ``1x1`` (one card
has no mesh). There is no gradient accumulation, as in the reference, so
the shape's global batch is one step's batch. Params are drawn from a
seed-0 generator on the device. The final checkpoint is written at the
step reached; the reference writes it at ``--steps`` even after a
SIGTERM, so that its resume would skip the steps not taken.
"""
from __future__ import annotations

import argparse
import signal
import time

import torch

from repro_torch import device as device_lib
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import get_config
from repro_torch.distributed.fault import StragglerDetector
from repro_torch.launch.specs import (_gnn_batch, _lm_train_batch,
                                      _nougat_batch, _optimizer_for,
                                      _recsys_batch, _reduce_shape,
                                      _router_batch, gnn_cell_config,
                                      gnn_param_leaves, gnn_refusal,
                                      gnn_train_step, init_router_params,
                                      lm_param_leaves, lm_train_step,
                                      recsys_param_leaves, recsys_train_step,
                                      router_param_leaves, router_train_step,
                                      vit_parser_param_leaves,
                                      vit_parser_train_step)
from repro_torch.models.gnn.equiformer import init_equiformer
from repro_torch.models.recsys.models import init_recsys
from repro_torch.models.transformer import init_lm
from repro_torch.models.vit_parser import init_vit_parser

#: why ``--arch adaparse-router --shape dpo_2k`` is refused
DPO_REFUSAL = (
    "the JAX package's train CLI raises TypeError on this cell: its step "
    "takes five arguments, (params, ref_params, opt_state, step, batch) "
    "(src/repro/launch/specs.py:456), but src/repro/launch/train.py "
    "passes four; the port does not train it here either. DPO trains "
    "through repro_torch.core.dpo (fit_dpo), as serve --variant llm does")


def _check_mesh(spec: str) -> None:
    dims = tuple(int(x) for x in spec.split("x"))
    if any(d != 1 for d in dims):
        raise ValueError(f"--mesh {spec}: the port trains on one card, "
                         f"which has no mesh; only 1x1 is accepted "
                         f"(meshes wait for ROADMAP.md item 13e)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny config for CPU runs")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="1x1", help="only 1x1 (one card)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    _check_mesh(args.mesh)
    dev = device_lib.resolve(args.device)

    arch = get_config(args.arch)
    if args.reduced:
        arch = arch.reduced()
        shape = _reduce_shape(arch.family, arch.shape(args.shape))
    else:
        shape = arch.shape(args.shape)
    if args.shape in arch.skips and not args.reduced:
        raise ValueError(f"{args.arch}/{args.shape} skipped: "
                         f"{arch.skips[args.shape]}")
    if shape.kind != "train":
        raise NotImplementedError(
            f"{args.arch}/{args.shape}: the train CLI takes train cells "
            f"only; the serve cells wait for the port's cell factory "
            f"(ROADMAP.md item 13e-3)")
    if arch.family == "encoder" and shape.name.startswith("dpo"):
        raise NotImplementedError(f"{args.arch}/{args.shape}: "
                                  f"{DPO_REFUSAL}")
    cfg = arch.model
    opt, _ = _optimizer_for(arch)
    if arch.family == "gnn":
        cfg = gnn_cell_config(arch, shape)
        why = None if args.reduced else gnn_refusal(cfg, shape)
        if why:
            raise ValueError(f"{args.arch}/{why}")
        init, leaves_of = init_equiformer, gnn_param_leaves
        train_step = gnn_train_step(cfg, opt)

        def make_batch(seed):
            return _gnn_batch(shape, seed, device=dev)
    elif arch.family == "lm":
        b, s = shape["global_batch"], shape["seq_len"]
        init, leaves_of = init_lm, lm_param_leaves
        train_step = lm_train_step(cfg, opt)

        def make_batch(seed):
            return _lm_train_batch(cfg, b, s, seed=seed, device=dev)
    elif arch.family == "vit_parser":
        init, leaves_of = init_vit_parser, vit_parser_param_leaves
        train_step = vit_parser_train_step(cfg, opt)

        def make_batch(seed):
            return _nougat_batch(cfg, shape, seed, device=dev)
    elif arch.family == "encoder":
        init, leaves_of = init_router_params, router_param_leaves
        train_step = router_train_step(cfg, opt)

        def make_batch(seed):
            return _router_batch(cfg, shape, seed, device=dev)
    else:
        init, leaves_of = init_recsys, recsys_param_leaves
        train_step = recsys_train_step(cfg, opt)

        def make_batch(seed):
            return _recsys_batch(cfg, shape["batch"], seed, device=dev)

    stop = {"now": False}
    previous = signal.signal(signal.SIGTERM,
                             lambda *_: stop.update(now=True))
    try:
        params = init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        opt_state = opt.init(leaves_of(params))
        start_step = 0
        if args.ckpt_dir and ckpt_lib.latest_step(args.ckpt_dir) is not None:
            start_step, tree, _ = ckpt_lib.restore(args.ckpt_dir,
                                                   device=dev)
            params, opt_state = tree["params"], tree["opt_state"]
            print(f"[train] restored step {start_step} from {args.ckpt_dir}")

        detector = StragglerDetector()
        losses = []
        pending = None
        done = start_step
        for step in range(start_step, args.steps):
            if stop["now"]:
                print("[train] SIGTERM — checkpointing and exiting")
                break
            t0 = time.time()
            batch = make_batch(step + 1)
            params, opt_state, loss = train_step(params, opt_state, step,
                                                 batch)
            loss = float(loss)
            losses.append(loss)
            done = step + 1
            detector.record(0, time.time() - t0)
            if step % args.log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({time.time()-t0:.2f}s)", flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                if pending is not None:
                    pending.join()
                pending = ckpt_lib.save_async(
                    args.ckpt_dir, step + 1,
                    {"params": params, "opt_state": opt_state},
                    metadata={"arch": args.arch, "loss": loss})
        if pending is not None:
            pending.join()
        if args.ckpt_dir:
            ckpt_lib.save(args.ckpt_dir, done,
                          {"params": params, "opt_state": opt_state},
                          metadata={"arch": args.arch,
                                    "loss": losses[-1] if losses else None})
    finally:
        signal.signal(signal.SIGTERM, previous)
    stragglers = detector.stragglers()
    print(f"[train] done; final loss "
          f"{losses[-1] if losses else float('nan'):.4f}; "
          f"stragglers={stragglers}")
    return losses


if __name__ == "__main__":
    main()
