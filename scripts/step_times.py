"""Training step times and embedding kernel rows of one checkout, for
holding a kernel change against its parent on one card.

    python scripts/step_times.py [--rows] CHECKOUT [CHECKOUT ...]

For each CHECKOUT (the root of a checkout of this repository; ``.`` for
this one, or another commit's ``git archive`` unpacked into a git-ignored
directory), in the order given and each in a process of its own, builds
that checkout's kernel library and runs its ``chip_smoke.py`` phases
``recsys_train`` (DeepFM, AutoInt, DIEN) and ``gnn_train``
(EquiformerV2's minibatch_lg, full_graph_sm and molecule), which print
their JSON lines (``ms_a_step`` and ``ms_steps`` among them). With
``--rows`` it runs instead that checkout's kernel rows 6-6d
(``check_embedding_bag``, ``check_embedding_bag_backward`` and
``check_segment_sum``: each launch held against the plain version, then
timed) and prints them as one JSON line, so each checkout's kernels go
through its own wrappers and C interface. Give the checkouts in turns
(parent, change, change, parent): a card may differ from the next. Needs
a CUDA card and nvcc.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

CHILD = """
import sys
root, rows = sys.argv[1], sys.argv[2] == "rows"
sys.path[:0] = [root, root + "/src"]
import chip_smoke as C
from repro_torch.kernels import cuda_lib
cuda_lib.build()
print("CHECKOUT", root, flush=True)
C.reset_counts()
if rows:
    import torch
    dev = torch.device("cuda")
    C.emit({"phase": "kernel_rows", "checkout": root, "results":
            C.check_embedding_bag(dev) + C.check_embedding_bag_backward(dev)
            + C.check_segment_sum(dev)})
else:
    C.phase_recsys_train()
    C.free_cuda()
    C.phase_gnn_train()
"""


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    mode = "rows" if "--rows" in args else "steps"
    roots = [Path(a).resolve() for a in args if a != "--rows"]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in roots:
        if not (root / "chip_smoke.py").is_file():
            print(f"{root} holds no chip_smoke.py", file=sys.stderr)
            return 2
        rc |= subprocess.run([sys.executable, "-c", CHILD, str(root), mode],
                             check=False).returncode
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
