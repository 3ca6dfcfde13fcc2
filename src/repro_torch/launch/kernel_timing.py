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
prepare stage's shapes (256 documents), and ``budget_route`` at N = 256
and at route_64k's N = 65,536 (D = 512, alpha = 0.05), in turns:
baseline, this, this, baseline. Each launch is first held against the
plain version. ``ngram_score``'s and ``fast_features``' C interfaces
must agree between the checkouts but for the block-size argument a
checkout from before the autotune knob lacks (both are then timed at
the default block size); ``budget_route``'s baseline may be
the two-pass kernel (a ``counts`` scratch, outputs zeroed by the
caller), which is bound with its own interface. The whole
``budget_route()`` op at N = 256 (``route_tau``, the allocations and
the kernel) is profiled for both as well: device launches and device
time a call. Prints one JSON line. Needs a CUDA card and nvcc.
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
from repro_torch.kernels.autotune_common import device_ms


def profiled_ms(launch, reps: int = 20) -> dict:
    """torch.profiler's device time of the kernels (and memsets and
    copies) one ``launch()`` runs (their durations only, no gaps), per
    launch: total, by kernel, and their count.

    A session on the H100 (torch 2.11) once came back with no device
    events at all though the kernels ran, so an empty session is taken
    again, up to three sessions in all; when all three are empty the
    profiler's figures are not measured (None), and the CUDA-event
    timing (``device_ms``) stands alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                launch()
            torch.cuda.synchronize()
        ops = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        by: dict[str, float] = {}
        for e in ops:            # kernels may share a name's first 60 chars
            by[e.key[:60]] = by.get(e.key[:60], 0.0) + (
                e.self_device_time_total / reps / 1e3)
        if by:
            return {"ms": sum(by.values()), "kernels": by,
                    "launches": sum(e.count for e in ops) / reps}
    return {"ms": None, "kernels": {}, "launches": None}


def empty_ms(grids, device) -> dict:
    """The floor under a small kernel: back-to-back device ms and
    profiler ms of do-nothing kernels at the grids one launch of it runs
    (``[(blocks, threads), ...]``, or ``(blocks, threads, cooperative)``
    where a launch is cooperative). Not a bound."""
    def launch():
        st = cuda_lib.stream_of(device)
        for blocks, threads, *coop in grids:
            cuda_lib.EMPTY(blocks, threads, int(bool(coop and coop[0])), st)

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


def _bind_args(lib: ctypes.CDLL, symbol: str, argtypes: list):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _bind(lib: ctypes.CDLL, kernel: cuda_lib.CudaKernel):
    return _bind_args(lib, kernel.symbol, kernel.argtypes)


# budget_route's C interface as the two-pass kernel had it: (scores, tau,
# tokens, n, row_bytes, capacity, vec16, counts, out, idx, count, stream)
TWO_PASS_ROUTE = [cuda_lib.P, cuda_lib.P, cuda_lib.P, cuda_lib.I, cuda_lib.I,
                  cuda_lib.I, cuda_lib.I, cuda_lib.P, cuda_lib.P, cuda_lib.P,
                  cuda_lib.P, cuda_lib.P]


def has_threads_knob(kernels_dir: Path, name: str) -> bool:
    """Whether a checkout's ``name`` kernel takes its block size (the
    autotune knob) as the ``threads`` argument before the stream."""
    src = kernels_dir / name / "csrc" / f"{name}.cu"
    return "int threads, void* stream" in src.read_text()


def _bind_knob(lib: ctypes.CDLL, kernel: cuda_lib.CudaKernel, knob: bool):
    """``kernel``'s C entry in ``lib``, bound with or without the
    ``threads`` argument before the stream."""
    types = kernel.argtypes if knob else kernel.argtypes[:-2] + [cuda_lib.P]
    return _bind_args(lib, kernel.symbol, types)


def is_two_pass_route(kernels_dir: Path) -> bool:
    """Whether a checkout's budget_route is the two-pass kernel (its
    source defines the ``route_count`` pass)."""
    src = kernels_dir / "budget_route" / "csrc" / "budget_route.cu"
    return "route_count" in src.read_text()


def route_inputs(device, n: int, d: int = 512, seed: int = 0):
    """Scores on a 0.25 grid (many ties at tau), tokens and capacity at
    alpha = 0.05, as chip_smoke.py's budget_route rows draw them."""
    from repro_torch.kernels.budget_route import ops as br

    g = torch.Generator(device=device).manual_seed(seed)
    scores = torch.round(torch.randn(n, generator=g, device=device) * 4) / 4
    tokens = torch.randint(0, 10000, (n, d), generator=g, dtype=torch.int32,
                           device=device)
    return scores, tokens, br.capacity_floor(0.05, n)


def compare(baseline: Path, device) -> dict:
    """Both checkouts' ngram_score, fast_features and budget_route, held
    against the plain versions and timed in turns (baseline, this, this,
    baseline), and the budget_route() op of both profiled."""
    from repro_torch.kernels.budget_route import ops as br
    from repro_torch.kernels.budget_route.ref import budget_route_ref
    from repro_torch.kernels.fast_features import ops as ff_ops
    from repro_torch.kernels.fast_features.ref import fast_features_ref
    from repro_torch.kernels.ngram_score import ops as ng_ops
    from repro_torch.kernels.ngram_score.ref import ngram_bleu_ref

    base_dir = baseline / "src" / "repro_torch" / "kernels"
    libs = {"this": cuda_lib.library(),
            "baseline": ctypes.CDLL(str(cuda_lib.build(base_dir)))}
    two_pass = {"this": False, "baseline": is_two_pass_route(base_dir)}
    knob = {name: {"this": True,
                   "baseline": has_threads_knob(base_dir, name)}
            for name in ("ngram_score", "fast_features")}
    ng_in, ff_in, kw = probe_inputs(device)
    b, max_len = ng_in[0].shape
    n, width = ff_in[0].shape
    ng_want = ngram_bleu_ref(*ng_in)
    ff_want = fast_features_ref(*ff_in, **kw)
    st = cuda_lib.stream_of(device)

    def ngram(which):
        has = knob["ngram_score"][which]
        fn = _bind_knob(libs[which], ng_ops.KERNEL, has)
        threads = (ng_ops.DEFAULT_THREADS,) if has else ()
        out = torch.empty(b, dtype=torch.float32, device=device)

        def launch():
            fn(*(t.data_ptr() for t in ng_in), b, max_len, 4,
               out.data_ptr(), *threads, st)

        def check():
            d = (out.double() - ng_want).abs()
            assert bool((d <= 1e-6 + 1e-5 * ng_want.abs()).all()), d.max()
        return launch, check

    def features(which):
        has = knob["fast_features"][which]
        fn = _bind_knob(libs[which], ff_ops.KERNEL, has)
        threads = (ff_ops.autotune.DEFAULT_THREADS,) if has else ()
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
               toks.data_ptr(), mask.data_ptr(), err.data_ptr(), *threads,
               st)

        def check():
            assert torch.equal(fast, ff_want[0]), "fast_features features"
            assert torch.equal(toks, ff_want[1]) and torch.equal(
                mask, ff_want[2]), "fast_features toks/mask"
            assert int(err) == 0
        return launch, check

    def route_kernel(which, scores, tokens, tau, cap, garbage=True):
        """One launch of a checkout's kernel into outputs allocated as its
        wrapper does (zeroed for the two-pass kernel, which leaves the
        unused rows to its caller), or, with ``garbage``, for the
        one-launch kernel filled with garbage."""
        n, d = tokens.shape
        out = torch.empty((cap, d), dtype=torch.int32, device=device)
        if two_pass[which]:
            out.zero_()
        elif garbage:
            out.fill_(0x5A5A5A5A)
        idx = torch.empty(cap, dtype=torch.int32, device=device)
        count = torch.empty(1, dtype=torch.int32, device=device)
        head = (scores.data_ptr(), tau.data_ptr(), tokens.data_ptr(), n,
                4 * d, cap, 1)
        if two_pass[which]:
            fn = _bind_args(libs[which], br.KERNEL.symbol, TWO_PASS_ROUTE)
            counts = torch.empty(2 * (-(-n // 1024)), dtype=torch.int32,
                                 device=device)
            args = (*head, counts.data_ptr(), out.data_ptr(),
                    idx.data_ptr(), count.data_ptr(), st)
        else:
            fn = _bind(libs[which], br.KERNEL)
            plan = br.launch_plan(n, br.sm_count(device))
            scratch = torch.empty(2 * plan[0], dtype=torch.int32,
                                  device=device)
            args = (*head, out.data_ptr(), idx.data_ptr(), count.data_ptr(),
                    scratch.data_ptr(), *plan, st)

        def launch():
            err = fn(*args)
            if err:
                raise RuntimeError(f"budget_route ({which}): CUDA launch "
                                   f"failed with error {err}")
        return launch, (out, idx, count)

    def route(n):
        scores, tokens, cap = route_inputs(device, n)
        tau = br.route_tau(scores, cap)
        want = budget_route_ref(scores, tokens, tau[0], capacity=cap)

        def make(which):
            launch, (out, idx, count) = route_kernel(which, scores, tokens,
                                                     tau, cap)

            def check():
                assert torch.equal(idx, want[1]) and int(count) == int(
                    want[2]), f"budget_route idx/count n={n}"
                assert torch.equal(out, want[0]), f"budget_route rows n={n}"
            return launch, check
        return make

    res = {}
    for name, make in (("ngram_score", ngram), ("fast_features", features),
                       ("budget_route_n256", route(256)),
                       ("budget_route_n65536", route(65536))):
        rows = res[name] = {"baseline": {"ms_device": [], "profiler_ms": []},
                            "this": {"ms_device": [], "profiler_ms": []}}
        for which in ("baseline", "this", "this", "baseline"):
            launch, check = make(which)
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
        "fast_features": empty_ms(ff_ops.launch_grid(n), device),
        **{f"budget_route_n{m}": empty_ms(br.launch_grid(m, device), device)
           for m in (256, 65536)}}
    res["empty_two_pass_grids"] = {
        f"budget_route_n{m}": empty_ms([(-(-m // 1024), 1024)] * 2, device)
        for m in (256, 65536)}

    # the budget_route() op at N = 256: the threshold, the allocations the
    # wrapper makes (a zeroed output and a counts scratch for the two-pass
    # kernel) and the kernel
    scores, tokens, cap = route_inputs(device, 256)

    def baseline_op():
        tau = br.route_tau(scores, cap)
        route_kernel("baseline", scores, tokens, tau, cap, garbage=False)[0]()

    res["budget_route_op_n256"] = {
        "baseline": profiled_ms(baseline_op),
        "this": profiled_ms(lambda: br.budget_route(scores, tokens, 0.05))}
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
