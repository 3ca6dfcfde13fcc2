"""Where ``embedding_bag_backward``'s time goes: its two kernels alone
and together.

    python scripts/backward_split.py

Builds three copies of this checkout's
``src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu`` into
shared libraries of their own (nvcc, beside the kernel library): the
source as it is, one that launches only the long-run kernel
(``bag_long_kernel``) and one that launches only the tile kernel
(``bag_tiles_kernel``), by setting the other's launch count to 0 in the
copy. It times the C entry of each (``kernel_timing.device_ms``, on
plumbing made beforehand) at the table gradients of DeepFM's, AutoInt's
and DIEN's train_batch lookups (``chip_smoke.py``'s row 6c),
minibatch_lg's ``segment_sum`` (row 6d) and a lone run of 50,000 ids on
one row (D = 10 bf16 and D = 18 f32), and holds the whole source's
result bit-equal to the plain version. Prints one JSON line a shape.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu"
OUT = ROOT / "src/repro_torch/kernels/_build/backward_split"
# the copies: the text each one's launch counts are set by
LONG = ("  const long long n_units = (n_ids + 32LL * kLongRun - 1) / "
        "(32LL * kLongRun);\n")
TILES = ("  const long long tile_blocks =\n"
         "      (n_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;\n")
VARIANTS = {"both": {}, "long_only": {TILES: "  const long long "
                                      "tile_blocks = 0;\n"},
            "tiles_only": {LONG: "  const long long n_units = 0;\n"}}


def build(name: str, edits: dict, nvcc: str):
    text = SRC.read_text().replace('#include "../../csrc/common.cuh"',
                                   '#include "common.cuh"')
    for old, new in edits.items():
        if old not in text:
            raise SystemExit(f"backward_split: {SRC.name} no longer holds "
                             f"{old!r}; update the script")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(text)
    return subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
         str(ROOT / "src/repro_torch/kernels/csrc"), str(cu), "-o", str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.embedding_bag import ops, ref
    from repro_torch.launch import specs as S
    from repro_torch.launch.kernel_timing import device_ms
    from repro_torch.models.recsys import embedding as E

    if not torch.cuda.is_available():
        print("backward_split: needs a CUDA card", file=sys.stderr)
        return 2
    jobs = {k: build(k, v, cuda_lib._nvcc()) for k, v in VARIANTS.items()}
    fns = {}
    for k, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(so)).adaparse_embedding_bag_backward
        fn.argtypes, fn.restype = ops.BACKWARD.argtypes, ctypes.c_int
        fns[k] = fn
    dev = torch.device("cuda")
    st = cuda_lib.stream_of(dev)
    print(C.card_line(), flush=True)

    def cases():
        for arch_id in ("deepfm", "autoint", "dien"):
            cfg = get_config(arch_id).model
            ids = C.backward_ids(arch_id, dev)
            g = torch.Generator(device=dev).manual_seed(C.SEED)
            yield arch_id, torch.randn(
                (ids.numel(), cfg.embed_dim), generator=g, device=dev).to(
                getattr(torch, cfg.param_dtype)), ids, \
                E.table_offsets(cfg.vocab_sizes, 512)[1]
        for d, dt in ((10, torch.bfloat16), (18, torch.float32)):
            ids = torch.full((50_000,), 17, dtype=torch.int32, device=dev)
            yield f"lone_run_d{d}", torch.randn((50_000, d),
                                                device=dev).to(dt), ids, 40
        shape = get_config("equiformer-v2").shape("minibatch_lg")
        n, e = S._gnn_dims(shape)
        yield "equiformer_aggregation", torch.randn(
            (e, 6272), device=dev).to(torch.bfloat16), S._gnn_batch(
            shape, 1, dev)["dst"], n

    for name, grad, ids, rows in cases():
        d, el = grad.shape[1], grad.element_size()
        out = torch.empty((rows, d), dtype=grad.dtype, device=dev)
        vb = ops.vec_bytes(el, d * el, grad.data_ptr(), out.data_ptr())
        tile = ops.tile_rows(d * el // vb, ids.numel(), rows)
        keys, perm, ptr = ops.row_offsets(ids, rows, tile)
        row = {"shape": name, "tile": tile, "vec_bytes": vb}
        for k, fn in fns.items():
            def entry():
                err = fn(grad.data_ptr(), ops._TABLE_DTYPES[grad.dtype], rows,
                         d, keys.data_ptr(), perm.data_ptr(), keys.numel(),
                         ptr.data_ptr(), tile, vb, out.data_ptr(), st)
                if err:
                    raise RuntimeError(f"{k}: CUDA error {err}")
            entry()
            torch.cuda.synchronize()
            if k == "both":
                row["equal"] = bool(torch.equal(
                    out, ref.embedding_bag_backward_ref(grad, ids, rows)))
            row[f"{k}_ms_device"] = device_ms(entry)
        print(json.dumps(row), flush=True)
        del grad, ids, keys, perm, ptr, out
        C.free_cuda()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
