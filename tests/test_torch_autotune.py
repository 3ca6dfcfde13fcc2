"""The port's kernel autotune (``repro_torch.kernels.autotune_common``,
the three kernels' ``autotune.py`` and ``kernels/tuning_store``) against
the JAX package's, on the CPU.

The store is the reference's protocol (WAL plus snapshot under flock):
round trip, compaction that folds another handle's tail, a torn WAL
line, concurrent handles, and two processes sharing one directory; the
two packages read each other's stores, and their keys have one format.
The ``ensure_tuned`` contract runs on a toy kernel with the card's
timer stood in for (this host has no card): sweep once and publish,
then read the store after a restart, and never sweep without a store.
On a CPU tensor the plain version runs, which has no knob: the default
comes back and nothing sweeps, and a device sweep without a card
raises. A CPU process fleet with a ``tuning_dir`` opens the shared store
in every worker, sweeps 0 times cold and warm, leaves the store's bytes
as they were, and reproduces the JAX package's single-node records; and
``serve --tuning-dir`` prints what ``repro.launch.serve`` prints. The
knobs' candidates, on the card, are in ``tests/test_torch_cuda.py``.
"""
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import threading
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.engine import AdaParseEngine as JEngine
from repro.core.engine import EngineConfig as JEngineConfig
from repro.kernels import autotune_common as JAC
from repro.kernels import tuning_store as JTS
from repro.launch import serve as JS
from repro_torch.core import specs as TSP
from repro_torch.core import workers as TW
from repro_torch.core.campaign import CampaignExecutor, ExecutorConfig
from repro_torch.core.engine import EngineConfig
from repro_torch.data.synthetic import CorpusConfig, generate_corpus
from repro_torch.kernels import autotune_common as AC
from repro_torch.kernels import tuning_store as TS
from repro_torch.kernels.budget_route import autotune as BRA
from repro_torch.kernels.budget_route import ops as BR
from repro_torch.kernels.fast_features import autotune as FFA
from repro_torch.kernels.fast_features import ops as FF
from repro_torch.kernels.ngram_score import autotune as NGA
from repro_torch.kernels.ngram_score import ops as NG
from repro_torch.launch import serve as TSV
from torch_spawn_env import one_thread_workers  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
CARD = "NVIDIA H100 80GB HBM3"          # a card name for the toy sweeps


@pytest.fixture(autouse=True)
def _isolated_tuning_state():
    """Each test starts and ends with no global store and a cold
    in-memory winner cache, in both packages."""
    for ac, ts in ((AC, TS), (JAC, JTS)):
        ac.clear_cache()
        ts.reset()
    yield
    for ac, ts in ((AC, TS), (JAC, JTS)):
        ac.clear_cache()
        ts.reset()


def _rec(value=256, kernel="fast_features", shape=(4096, 512)):
    return AC._record_to_dict(AC.TuneRecord(
        kernel=kernel, shape=tuple(shape), backend=CARD, device=True,
        param="threads", value=value,
        timings_s=((128, 5.4e-6), (256, 4.9e-6))))


# -- the store ----------------------------------------------------------------


def test_store_roundtrip_persists_across_handles(tmp_path):
    """put/get roundtrip, hit/miss counters, WAL-only recovery before
    any compaction, snapshot recovery after flush(); the JAX package's
    store reads what the port's wrote, and the port's what it writes."""
    d = tmp_path / "t"
    st = TS.TuningStore(d)
    st.put("k1", _rec(value=512))
    assert st.get("k1")["value"] == 512
    assert st.get("nope") is None
    assert st.hits == 1 and st.misses == 1 and st.hit_rate == 0.5
    fresh = TS.TuningStore(d)            # WAL only, no snapshot yet
    assert fresh.get("k1")["value"] == 512
    assert JTS.TuningStore(d).get("k1") == st.get("k1")
    st.flush()
    assert (d / TS.TuningStore.WAL_NAME).read_bytes() == b""
    again = TS.TuningStore(d)
    assert again.get("k1")["value"] == 512 and len(again) == 1
    JTS.TuningStore(d).put("kj", _rec(value=128))
    assert TS.TuningStore(d).keys() == ("k1", "kj")


def test_compaction_folds_other_handles_wal_tail(tmp_path):
    """A stale reader refolds a concurrent writer's appends on get(),
    and compaction in one handle folds the other's WAL tail into the
    snapshot instead of truncating it away."""
    d = tmp_path / "t"
    a, b = TS.TuningStore(d), TS.TuningStore(d)
    a.put("ka", _rec(value=128))
    assert b.get("ka")["value"] == 128
    b.put("kb", _rec(value=512))
    a.flush()
    assert (d / TS.TuningStore.WAL_NAME).read_bytes() == b""
    assert a.get("kb")["value"] == 512
    assert TS.TuningStore(d).keys() == ("ka", "kb")


def test_torn_wal_tail_is_skipped(tmp_path):
    """A torn final WAL line is dropped; every complete record before it
    is kept, and the next compaction discards the tail."""
    d = tmp_path / "t"
    st = TS.TuningStore(d)
    st.put("k0", _rec(value=128))
    st.put("k1", _rec(value=256))
    with open(d / TS.TuningStore.WAL_NAME, "a") as f:
        f.write('{"k": "k2", "v": {"trunca')
    fresh = TS.TuningStore(d)
    assert len(fresh) == 2 and fresh.get("k2") is None
    assert fresh.get("k1")["value"] == 256
    fresh.flush()
    assert TS.TuningStore(d).keys() == ("k0", "k1")


def test_concurrent_handles_interleave_safely(tmp_path):
    """Concurrent puts and compactions from three handles keep every
    handle's records."""
    d = tmp_path / "t"
    stores = [TS.TuningStore(d) for _ in range(3)]
    errs = []

    def work(st, base):
        try:
            for i in range(30):
                st.put(f"k{base + i}", _rec(value=128 + i))
                if i % 10 == 9:
                    st.flush()
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=work, args=(st, 100 * j))
               for j, st in enumerate(stores)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    fresh = TS.TuningStore(d)
    assert len(fresh) == 90
    assert all(fresh.get(f"k{100 * j + i}") is not None
               for j in range(3) for i in range(30))


# -- the harness --------------------------------------------------------------


def test_store_key_has_the_reference_format():
    for shape in ((4096, 512), (65536, 512, 3276), (256, 256, 4)):
        for kernel in ("fast_features", "budget_route", "ngram_score"):
            assert AC.store_key(kernel, shape, CARD) == \
                JAC.store_key(kernel, shape, CARD, True)
    assert AC.store_key("fast_features", (4096, 512), CARD) == \
        f"v1|fast_features|4096x512|{CARD}|device"
    assert AC.cache_key("k", (1, 2), CARD) == ("k", (1, 2), CARD, True)


def _toy_card(monkeypatch):
    """Stand in for the card: its name, and a timer that runs the
    candidate once and takes the time the run returns."""
    monkeypatch.setattr(AC, "backend_name", lambda device=None: CARD)
    monkeypatch.setattr(AC, "_time_candidate", lambda run, device: run())


def test_ensure_tuned_sweeps_once_then_reads_store(tmp_path, monkeypatch):
    """The dispatch-time contract: the first call sweeps and publishes;
    after a restart (memory wiped, store kept) the winner is a read —
    zero sweeps, zero kernel runs; without a store, the default and no
    sweep; on a CPU device, the default and no sweep even with a store."""
    _toy_card(monkeypatch)
    TS.configure(str(tmp_path / "t"))
    calls = []

    def make_run(cand):
        def run():
            calls.append(cand)
            return 1e-6 if cand == 256 else 2e-6
        return run

    args = ("toy", (64,), "threads", (128, 256), make_run, 999)
    assert AC.ensure_tuned(*args) == 256 and AC.sweeps_run() == 1
    assert sorted(calls) == [128, 256]
    rec = AC.lookup("toy", (64,))
    assert rec.timings_s == ((128, 2e-6), (256, 1e-6)) and rec.device
    key = f"v1|toy|64|{CARD}|device"
    assert TS.get_store().keys() == (key,)
    AC.clear_cache()
    calls.clear()
    assert AC.ensure_tuned(*args) == 256
    assert AC.sweeps_run() == 0 and calls == []
    assert AC.tuned_value("toy", (64,), 999) == 256
    assert AC.ensure_tuned(*args, device=CPU) == 999
    assert AC.tuned_value("toy", (64,), 999, device=CPU) == 999
    assert AC.lookup("toy", (64,), device=CPU) is None
    TS.reset()
    AC.clear_cache()
    assert AC.ensure_tuned(*args) == 999
    assert AC.sweeps_run() == 0 and calls == []


def test_cpu_tensors_take_the_default_and_never_sweep(tmp_path):
    """The plain versions have no knob: with a store configured, each
    kernel's ``ensure_tuned`` and ``tuned_*`` on the CPU give the default
    launch's value, sweep nothing and write nothing; the wrappers run the
    plain version on CPU tensors whatever ``threads`` says."""
    TS.configure(str(tmp_path / "t"))
    assert FFA.ensure_tuned(4096, 512, device=CPU) == FFA.DEFAULT_THREADS
    assert NGA.ensure_tuned(256, 256, device=CPU) == NGA.DEFAULT_THREADS
    assert BRA.ensure_tuned(65536, 512, 3276, device=CPU) == \
        BRA.DEFAULT_BLOCK_ROWS
    assert FFA.tuned_threads(4096, 512, device=CPU) == 256
    assert NGA.tuned_threads(256, 256, device=CPU) == 768
    assert BRA.tuned_block_rows(65536, 512, 3276, device=CPU) == 512
    assert AC.sweeps_run() == 0 and len(TS.get_store()) == 0
    ref = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    lens = torch.tensor([4], dtype=torch.int32)
    assert torch.equal(NG.ngram_bleu(ref, ref, lens, lens, threads=256),
                       NG.ngram_bleu(ref, ref, lens, lens))


def test_device_sweep_without_a_card_raises():
    """A sweep times the card: without one (or asked for the CPU) it
    raises, as the reference's device sweep raises off a TPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        FFA.autotune_fast_features(4096, 512)
    with pytest.raises(RuntimeError, match="CUDA card"):
        NGA.autotune_ngram_bleu(256, 256)
    with pytest.raises(RuntimeError, match="CUDA card"):
        BRA.autotune_budget_route(65536, 512, 3276, device=CPU)
    with pytest.raises(RuntimeError, match="CUDA card"):
        AC.lookup("fast_features", (4096, 512))
    assert AC.sweeps_run() == 0


_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[2])
from repro_torch.kernels import autotune_common as AC
from repro_torch.kernels import tuning_store as TS
AC.backend_name = lambda device=None: "toy card"
AC._time_candidate = lambda run, device: run()
TS.configure(sys.argv[1])
v = AC.ensure_tuned("fast_features", (4096, 512), "threads",
                    (128, 256, 512),
                    lambda c: (lambda: abs(c - 256) * 1e-9 + 1e-6), 256)
TS.get_store().flush()
print(json.dumps({"value": int(v), "sweeps": AC.sweeps_run(),
                  "keys": list(TS.get_store().keys())}))
"""


def _run_child(tdir):
    out = subprocess.run([sys.executable, "-c", _CHILD, str(tdir),
                          str(ROOT / "src")], capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_two_processes_share_one_tuning_dir(tmp_path):
    """Two OS processes over one directory, through a toy sweep: the
    first sweeps and publishes; the second resolves the same shape as a
    store read — zero sweeps, the same winner; the JAX package's store
    reads the winner too."""
    d = tmp_path / "t"
    first = _run_child(d)
    assert first["sweeps"] == 1 and first["value"] == 256
    assert first["keys"] == ["v1|fast_features|4096x512|toy card|device"]
    second = _run_child(d)
    assert second["sweeps"] == 0
    assert second["value"] == first["value"]
    assert second["keys"] == first["keys"]
    assert JTS.TuningStore(d).get(first["keys"][0])["value"] == 256


# -- the knobs ----------------------------------------------------------------


@pytest.mark.parametrize("block_rows", BRA.DEFAULT_CANDIDATES)
@pytest.mark.parametrize("n,sms", [(4097, 132), (65536, 132), (67585, 132),
                                   (1 << 20, 132), (65536, 8)])
def test_budget_route_block_rows_plan_covers_every_row(n, sms, block_rows):
    """Beyond one block, ``block_rows`` sets a grid block's chunk:
    block_rows / 4 threads of 4 rows, at most one block an SM, the
    fewest chunks, no idle block; up to 4,096 rows the one-block launch
    whatever the knob."""
    blocks, threads, rows, chunks = BR.launch_plan(n, sms, block_rows)
    assert threads * rows == block_rows and rows == BR.GRID_ROWS
    assert threads % 32 == 0 and threads <= BR.MAX_THREADS
    assert 1 < blocks <= sms and blocks * block_rows * chunks >= n
    assert (blocks - 1) * block_rows * chunks < n
    assert chunks == 1 or sms * block_rows * (chunks - 1) < n
    assert BR.launch_plan(4096, sms, block_rows) == BR.launch_plan(4096, sms)
    assert BR.launch_plan(n, sms) == BR.launch_plan(n, sms, 512)


def test_knob_candidates_and_clamps():
    """The defaults are the launches the kernels had before the knob;
    each kernel refuses a block size it was not built for; at N <= 4,096
    budget_route's candidates clamp to the one launch there is."""
    assert (FFA.DEFAULT_THREADS, FFA.DEFAULT_CANDIDATES) == \
        (256, (128, 256, 512))
    assert (NGA.DEFAULT_THREADS, NGA.DEFAULT_CANDIDATES) == \
        (768, (256, 512, 768, 1024))
    assert (BRA.DEFAULT_BLOCK_ROWS, BRA.DEFAULT_CANDIDATES) == \
        (512, (512, 1024, 2048, 4096))
    assert BR.GRID_THREADS * BR.GRID_ROWS == BRA.DEFAULT_BLOCK_ROWS
    assert BRA._clamp_candidates(BRA.DEFAULT_CANDIDATES, 256) == (512,)
    assert BRA._clamp_candidates(BRA.DEFAULT_CANDIDATES, 4096) == (512,)
    assert BRA._clamp_candidates((4096, 512), 65536) == (512, 4096)
    for clamp in (FFA._clamp_candidates, NGA._clamp_candidates,
                  lambda c: BRA._clamp_candidates(c, 65536)):
        with pytest.raises(ValueError, match="64"):
            clamp((64,))
    with pytest.raises(ValueError, match="block_rows"):
        BR.launch_plan(65536, 132, 768)
    assert FF.launch_grid(256) == [(256, 256)]
    assert NG.launch_grid(256, 256) == [(256, 768)]
    assert FF.KERNEL.argtypes[-2:] == NG.KERNEL.argtypes[-2:] == [
        FF.I, FF.P]                      # (threads, stream)


def test_worker_spec_carries_tuning_dir_outside_the_fingerprint():
    """``WorkerSpec.tuning_dir`` is back, as in the JAX package, and a
    knob never changes a record, so it stays out of the fingerprint."""
    from repro.core import workers as JW

    names = [f.name for f in dataclasses.fields(TW.WorkerSpec)]
    assert [n for n in names if n != "device"] == [
        f.name for f in dataclasses.fields(JW.WorkerSpec)]
    from repro_torch.launch.serve import build_ft_router

    tc = CorpusConfig(n_docs=30, seed=0)
    router = build_ft_router(generate_corpus(tc)[:10], tc,
                             np.random.RandomState(1), device=CPU)
    spec = TW.WorkerSpec(0, EngineConfig(), router, tc)
    assert TSP.spec_fingerprint(spec) == TSP.spec_fingerprint(
        dataclasses.replace(spec, tuning_dir="/elsewhere"))


# -- the fleet ----------------------------------------------------------------


def _same_records(a: dict, b: dict):
    assert set(a) == set(b)
    for i in a:
        assert a[i].parser == b[i].parser
        assert a[i].cost_s == b[i].cost_s
        assert len(a[i].pages) == len(b[i].pages)
        for pa, pb in zip(a[i].pages, b[i].pages):
            assert pa.dtype == pb.dtype
            np.testing.assert_array_equal(pa, pb)


def _store_bytes(d: Path) -> tuple:
    return tuple((p.name, p.read_bytes()) for p in sorted(d.iterdir())
                 if not p.name.startswith("."))


def test_cpu_worker_fleet_opens_the_store_and_never_sweeps(
        corpus, ft_router, tmp_path):
    """A 2-worker CPU process fleet with a ``tuning_dir`` holding a
    winner published on a card: every worker opens the shared store
    (its gauge reads the one key), sweeps 0 times cold and warm, and
    leaves the store's bytes as they were; both record sets equal the
    JAX package's single-node run."""
    from repro_torch.launch.serve import build_ft_router

    jc, jd = corpus
    tc = CorpusConfig(n_docs=150, seed=0)
    td = generate_corpus(tc)
    tr = build_ft_router(td[:75], tc, np.random.RandomState(1), device=CPU)
    test = td[110:]
    single = JEngine(JEngineConfig(alpha=0.1, batch_size=16), ft_router,
                     jc).run(jd[110:])
    tdir = tmp_path / "tuning"
    TS.TuningStore(tdir).put(AC.store_key("fast_features", (4096, 512),
                                          CARD), _rec())
    before = _store_bytes(tdir)
    xcfg = ExecutorConfig(n_nodes=2, runtime="process", obs=True,
                          tuning_dir=str(tdir))
    for _ in ("cold", "warm"):
        res = CampaignExecutor(EngineConfig(alpha=0.1, batch_size=16),
                               xcfg, tr, tc, device=CPU).run(test)
        _same_records(res.records, single)
        g = res.obs_metrics["gauges"]
        for w in range(2):
            assert g[f"autotune.sweeps.n{w}"] == 0
            assert g[f"autotune.store_keys.n{w}"] == 1
        assert _store_bytes(tdir) == before


_MEASURED = re.compile(r"(wall|docs/s|busy)=[0-9.]+")


def test_serve_tuning_dir_matches_the_reference(tmp_path):
    """``serve --workers 2 --tuning-dir DIR`` prints the reference's
    report line and metric dict (measured fields masked), opens the
    store in the coordinator and hands the directory to the fleet."""
    argv = ["--docs", "60", "--batch-size", "16", "--workers", "2",
            "--transport", "pickle"]
    outs = []
    for main, extra, d in ((TSV.main, ["--device", CPU], "t"),
                           (JS.main, [], "j")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            res = main(argv + extra + ["--tuning-dir", str(tmp_path / d)])
        outs.append((res, [_MEASURED.sub(r"\1=*", ln)
                           for ln in buf.getvalue().splitlines()
                           if ln.startswith("[serve] executor[")]))
    (t, tl), (j, jl) = outs
    assert tl == jl and "runtime=process" in tl[0]
    t.pop("throughput_docs_per_node_s")
    j.pop("throughput_docs_per_node_s")
    assert t == j
    assert TS.get_store() is not None
    assert os.path.samefile(TS.get_store().dir, tmp_path / "t")
    assert (tmp_path / "t" / TS.TuningStore.WAL_NAME).exists()
    assert AC.sweeps_run() == 0
