"""Device time of the port's kernels, and the small kernels of two
checkouts timed in turns on one card.

``device_ms`` (CUDA events around back-to-back launches), ``profiled_ms``
(torch.profiler's durations of the kernels themselves) and ``empty_ms``
(a do-nothing kernel at a kernel's grid) are the readings of
``chip_smoke.py``'s kernels phase.

    python -m repro_torch.launch.kernel_timing --baseline DIR

builds the kernel library of the checkout at DIR (another commit of this
repository, e.g. its ``git archive`` unpacked into a git-ignored
directory) beside this checkout's and times both checkouts'
``ngram_score`` and ``fast_features`` at the quality probe's and the
prepare stage's shapes (256 documents) in turns: baseline, this, this,
baseline. Each launch is first held against the plain version. The two
kernels' C interfaces must agree between the checkouts. Prints one JSON
line. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import cuda_lib


def device_ms(launch, reps: int = 100, warmup: int = 5) -> float:
    """Device ms per launch over ``reps`` back-to-back launches: CUDA
    events around the run, elapsed time over the count, after a warm-up.
    The run is queued behind a sleep kernel, so the card finds every
    launch queued and runs them without waiting for the host; the sleep
    is lengthened until the host has queued the whole run before the
    first event fires (else a small kernel would read the host's
    launch rate)."""
    for _ in range(warmup):
        launch()
    torch.cuda.synchronize()
    cycles = 1 << 22
    for _ in range(8):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            launch()
        b.record()
        queued_ahead = not a.query()
        b.synchronize()
        if queued_ahead:
            return a.elapsed_time(b) / reps
        cycles *= 4
    raise RuntimeError("the host could not queue the launches ahead of "
                       "the card")


def profiled_ms(launch, reps: int = 20) -> dict:
    """torch.profiler's device time of the kernels one ``launch()`` runs
    (their durations only, no gaps), per launch: total and by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    by = {e.key[:60]: e.self_device_time_total / reps / 1e3 for e in ops}
    if not by:
        raise RuntimeError("torch.profiler recorded no device time")
    return {"ms": sum(by.values()), "kernels": by}


def empty_ms(grids, device) -> dict:
    """The floor under a small kernel: back-to-back device ms and
    profiler ms of do-nothing kernels at the grids one launch of it runs
    (``[(blocks, threads), ...]``). Not a bound."""
    def launch():
        st = cuda_lib.stream_of(device)
        for blocks, threads in grids:
            cuda_lib.EMPTY(blocks, threads, st)

    return {"empty_launch_ms": device_ms(launch),
            "empty_profiler_ms": profiled_ms(launch)["ms"]}


def probe_inputs(device, n_docs: int = 256, seed: int = 0):
    """The main path's inputs of the two kernels on ``device``: the
    probe's (ref, hyp, ref_len, hyp_len) at L = 256 (references against
    the cheap parser's output) and the prepare stage's packed batch at
    max_len 512, from a seeded corpus."""
    from repro_torch.core import metrics, parsers
    from repro_torch.data.synthetic import (MANGLED, SCRAMBLE, WS,
                                            CorpusConfig, generate_corpus)
    from repro_torch.kernels.fast_features.ops import pack_routing_batch

    ccfg = CorpusConfig(n_docs=n_docs, seed=seed)
    docs = generate_corpus(ccfg)
    pages = parsers.run_parser_batch(parsers.CHEAP_PARSER, docs, ccfg,
                                     np.random.RandomState(seed))
    hyps = [np.concatenate(p) if sum(map(len, p)) else np.zeros(0, np.int32)
            for p in pages]
    ra, rl = metrics._pad_batch([d.full_text() for d in docs], 256)
    ha, hl = metrics._pad_batch(hyps, 256)
    ngram = [torch.from_numpy(x).to(device) for x in (ra, ha, rl, hl)]
    packed = pack_routing_batch(pages, max_len=512)
    ff = [torch.from_numpy(np.asarray(a, np.int32)).to(device) for a in (
        packed.tok_matrix, packed.n_tok, packed.first_len, packed.n_pages,
        packed.n_empty)]
    ff_kw = dict(max_len=512, ws=WS, scramble=SCRAMBLE, mangled=MANGLED,
                 latex_lo=ccfg.latex_lo, ident_lo=ccfg.ident_lo,
                 vocab_size=ccfg.vocab_size, bos=1)
    return ngram, ff, ff_kw


def _bind(lib: ctypes.CDLL, kernel: cuda_lib.CudaKernel):
    fn = getattr(lib, kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    return fn


def compare(baseline: Path, device) -> dict:
    """Both checkouts' ngram_score and fast_features, held against the
    plain versions and timed in turns (baseline, this, this, baseline)."""
    from repro_torch.kernels.fast_features import ops as ff_ops
    from repro_torch.kernels.fast_features.ref import fast_features_ref
    from repro_torch.kernels.ngram_score import ops as ng_ops
    from repro_torch.kernels.ngram_score.ref import ngram_bleu_ref

    libs = {"this": cuda_lib.library(),
            "baseline": ctypes.CDLL(str(cuda_lib.build(
                baseline / "src" / "repro_torch" / "kernels")))}
    ng_in, ff_in, kw = probe_inputs(device)
    b, max_len = ng_in[0].shape
    n, width = ff_in[0].shape
    ng_want = ngram_bleu_ref(*ng_in)
    ff_want = fast_features_ref(*ff_in, **kw)
    st = cuda_lib.stream_of(device)

    def ngram(lib):
        fn = _bind(lib, ng_ops.KERNEL)
        out = torch.empty(b, dtype=torch.float32, device=device)

        def launch():
            fn(*(t.data_ptr() for t in ng_in), b, max_len, 4,
               out.data_ptr(), st)

        def check():
            d = (out.double() - ng_want).abs()
            assert bool((d <= 1e-6 + 1e-5 * ng_want.abs()).all()), d.max()
        return launch, check

    def features(lib):
        fn = _bind(lib, ff_ops.KERNEL)
        fast = torch.empty((n, 8), dtype=torch.float32, device=device)
        toks = torch.empty((n, kw["max_len"]), dtype=torch.int32,
                           device=device)
        mask = torch.empty((n, kw["max_len"]), dtype=torch.float32,
                           device=device)
        err = torch.zeros(1, dtype=torch.int32, device=device)

        def launch():
            fn(*(t.data_ptr() for t in ff_in), n, width, kw["max_len"],
               kw["ws"], kw["scramble"], kw["mangled"], kw["latex_lo"],
               kw["ident_lo"], kw["vocab_size"], kw["bos"], fast.data_ptr(),
               toks.data_ptr(), mask.data_ptr(), err.data_ptr(), st)

        def check():
            assert torch.equal(fast, ff_want[0]), "fast_features features"
            assert torch.equal(toks, ff_want[1]) and torch.equal(
                mask, ff_want[2]), "fast_features toks/mask"
            assert int(err) == 0
        return launch, check

    res = {}
    for name, make in (("ngram_score", ngram), ("fast_features", features)):
        rows = res[name] = {"baseline": {"ms_device": [], "profiler_ms": []},
                            "this": {"ms_device": [], "profiler_ms": []}}
        for which in ("baseline", "this", "this", "baseline"):
            launch, check = make(libs[which])
            launch()
            torch.cuda.synchronize()
            check()
            rows[which]["ms_device"].append(device_ms(launch))
            rows[which]["profiler_ms"].append(profiled_ms(launch)["ms"])
    res["ngram_score"]["shape"] = {"b": b, "L": max_len}
    res["fast_features"]["shape"] = {"n": n, "width": width,
                                     "max_len": kw["max_len"]}
    res["empty_this_grids"] = {
        "ngram_score": empty_ms(ng_ops.launch_grid(b, max_len), device),
        "fast_features": empty_ms(ff_ops.launch_grid(n), device)}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="root of another checkout of this repository")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("needs a CUDA card")
    if not (args.baseline / "src" / "repro_torch" / "kernels").is_dir():
        ap.error(f"{args.baseline} holds no src/repro_torch/kernels")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    res = compare(args.baseline.resolve(), torch.device("cuda"))
    print(json.dumps({"card": card, "baseline": str(args.baseline),
                      **res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
