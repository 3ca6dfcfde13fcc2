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

As the reference does, the step function and the initial params and
optimizer state come from the train cell of ``specs.build_cell``, and
serve, prefill and decode cells are refused: the loop trains train
cells. A GNN cell's model is the arch's with the dataset's input width
and output count (``specs.gnn_cell_config``); ``ogb_products`` at full
size does not fit one card and raises with the reckoning
(``specs.gnn_refusal``); its reduced cell trains. The router trains its
``Encoder`` through ``specs.router_train_step`` on the JAX package's raw
param layout (``specs.router_param_tree``), so its optimizer state and
checkpoint line up with the reference's leaves. ``dpo_2k`` is refused:
the reference's CLI cannot run it (``DPO_REFUSAL``); DPO trains through
``core/dpo.py``.

Also as the reference does:
- restart-from-latest: on launch, restores the newest checkpoint in
  --ckpt-dir (params, optimizer state and step) and resumes;
- the batch of step ``t`` is the cell's batch drawn at seed ``t + 1``
  by the cell's own batch builder (``specs._train_batch``; the params
  are not drawn again): a stateless pipeline, so a resumed run equals
  an uninterrupted one bit for bit;
- atomic async checkpoints every --ckpt-every steps (the previous write
  joined first), and a final save at the end;
- SIGTERM: checkpoint and exit;
- step durations go to a ``StragglerDetector``.

On one card: ``--device`` (cuda unless "cpu") places the params, the
optimizer state and each batch; ``--mesh`` takes only ``1x1`` (one card
has no mesh). There is no gradient accumulation, as in the reference, so
the shape's global batch is one step's batch. Params are the seed-0
cell's (``specs.build_cell``: a generator on the device; the router's
on the CPU). The final checkpoint is written at the
step reached; the reference writes it at ``--steps`` even after a
SIGTERM, so that its resume would skip the steps not taken.
"""
from __future__ import annotations

import argparse
import signal
import time

from repro_torch import device as device_lib
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.distributed.fault import StragglerDetector
from repro_torch.launch.specs import (_lm_train_batch, _train_batch,
                                      build_cell, cell_shape,
                                      gnn_cell_config, gnn_refusal)

#: why ``--arch adaparse-router --shape dpo_2k`` is refused
DPO_REFUSAL = (
    "the JAX package's train CLI raises TypeError on this cell: its step "
    "takes five arguments, (params, ref_params, opt_state, step, batch) "
    "(src/repro/launch/specs.py:456), but src/repro/launch/train.py "
    "passes four; the port does not train it here either. DPO trains "
    "through repro_torch.core.dpo (fit_dpo), as serve --variant llm does")


def _step_batch(arch, shape, seed: int, dev) -> dict:
    """The train cell's batch at ``seed`` (``specs._train_batch``; an
    LM's through this module's ``_lm_train_batch``, the function that
    builder calls)."""
    if arch.family == "lm":
        return _lm_train_batch(arch.model, shape["global_batch"],
                               shape["seq_len"], seed, dev)
    return _train_batch(arch, shape, seed, dev)


def _check_mesh(spec: str) -> None:
    dims = tuple(int(x) for x in spec.split("x"))
    if any(d != 1 for d in dims):
        raise ValueError(f"--mesh {spec}: the port trains on one card, "
                         f"which has no mesh; only 1x1 is accepted "
                         f"(training on a mesh waits for ROADMAP.md item "
                         f"13e-4b)")


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

    arch, shape = cell_shape(args.arch, args.shape, args.reduced)
    if shape.kind != "train":
        raise NotImplementedError(
            f"{args.arch}/{args.shape} is a {shape.kind} cell: the train "
            f"CLI trains train cells, as the reference's loop does; build "
            f"the others with launch.specs.build_cell (ROADMAP.md item "
            f"13e-3)")
    if arch.family == "encoder" and shape.name.startswith("dpo"):
        raise NotImplementedError(f"{args.arch}/{args.shape}: "
                                  f"{DPO_REFUSAL}")
    if arch.family == "gnn" and not args.reduced:
        why = gnn_refusal(gnn_cell_config(arch, shape), shape)
        if why:
            raise ValueError(f"{args.arch}/{why}")

    stop = {"now": False}
    previous = signal.signal(signal.SIGTERM,
                             lambda *_: stop.update(now=True))
    try:
        cell = build_cell(args.arch, args.shape, abstract=False,
                          reduced=args.reduced, device=dev)
        train_step = cell.fn
        params, opt_state = cell.args[:2]
        del cell
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
            batch = _step_batch(arch, shape, step + 1, dev)
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
