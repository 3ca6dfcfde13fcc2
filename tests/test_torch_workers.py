"""The port's process worker runtime (``repro_torch.core.workers``
``ProcessWorkerPool`` with ``launch/worker_main.py``) against the JAX
package, on the CPU.

Each campaign of ``tests/test_workers.py`` runs here through real
spawned worker processes on ``device="cpu"``, and its records must be
byte-identical to the JAX package's single-node run and to the port's
own local (in-process) run. Also: the coordinator's bookkeeping
regressions on a bare pool, the router's portable form (its
fingerprint survives the rebuild on the worker's device), an llm
forwarded prep that crosses processes as numpy only, a cuda worker on a
host without a card, and ``serve
--workers`` against the reference's metric dict.

The flap scenario keeps the reference's assertions; its mute slowdown
has a stated margin over the largest heartbeat deadline
``_deadline_for`` can grant at its window (the reference's 0.9 s fell
inside the 1.0 s deadline a queue depth of one grants).
"""
import dataclasses
import io
import os
import pickle
import re
import subprocess
import sys
import time
from collections import deque
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.engine import AdaParseEngine as JEngine
from repro.core.engine import EngineConfig as JEngineConfig
from repro.launch import serve as JS
from repro_torch.configs import get_config
from repro_torch.core import shm as TSHM
from repro_torch.core import specs as TSP
from repro_torch.core import workers as TW
from repro_torch.core.backends import DiskResultStore, ResultCache
from repro_torch.core.campaign import (CampaignController, CampaignExecutor,
                                       ControllerConfig, ExecutorConfig,
                                       FaultInjection)
from repro_torch.core.engine import (AdaParseEngine, EngineConfig,
                                     _router_fingerprint)
from repro_torch.core.router import AdaParseRouter
from repro_torch.data.synthetic import CorpusConfig, generate_corpus
from repro_torch.launch import serve as TS
from repro_torch.launch import worker_main as WM
from repro_torch.models.encoder import init_encoder
from torch_spawn_env import ignore_sigterm_then_sleep
from torch_spawn_env import one_thread_workers  # noqa: F401

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]


def _same_records(a: dict, b: dict):
    assert set(a) == set(b)
    for i in a:
        assert a[i].parser == b[i].parser
        assert a[i].cost_s == b[i].cost_s
        assert len(a[i].pages) == len(b[i].pages)
        for pa, pb in zip(a[i].pages, b[i].pages):
            assert pa.dtype == pb.dtype
            np.testing.assert_array_equal(pa, pb)


@pytest.fixture(scope="module")
def port(corpus):
    """The port's copy of the shared corpus and an ft router fit the
    way ``tests/conftest.py`` fits the reference's."""
    jc, jd = corpus
    tc = CorpusConfig(n_docs=150, seed=0)
    td = generate_corpus(tc)
    for a, b in zip(jd, td):
        assert a.doc_id == b.doc_id
    tr = TS.build_ft_router(td[:75], tc, np.random.RandomState(1),
                            device=CPU)
    return tc, td, tr


@pytest.fixture(scope="module")
def single_run(corpus, ft_router, port):
    """The record sets every process campaign must reproduce
    byte-for-byte: the JAX package's single-node run, and the port's
    own, which must already be equal to it."""
    jc, jd = corpus
    tc, td, tr = port
    ekw = dict(alpha=0.1, batch_size=16)
    jrecs = JEngine(JEngineConfig(**ekw), ft_router, jc).run(jd[75:])
    trecs = AdaParseEngine(EngineConfig(**ekw), tr, tc, device=CPU).run(
        td[75:])
    _same_records(jrecs, trecs)
    return td[75:], EngineConfig(**ekw), jrecs


def test_process_pool_matches_single_node(port, single_run):
    """2 real worker processes produce the byte-identical record set of
    the single-node run, and both workers did real work."""
    tc, _, tr = port
    test, ecfg, single = single_run
    xcfg = ExecutorConfig(n_nodes=2, runtime="process")
    res = CampaignExecutor(ecfg, xcfg, tr, tc, device=CPU).run(test)
    _same_records(single, res.records)
    assert res.wall_s > 0 and res.docs_per_s > 0
    assert all(s.n_docs > 0 for s in res.node_stats)
    assert sum(s.n_docs for s in res.node_stats) == len(test)


def test_process_pool_pools_prefetch_disk_adaptive_parity(
        port, single_run, tmp_path):
    """Heterogeneous pools + prefetch windows + a shared on-disk store +
    adaptive rounds over 4 worker processes reproduce the single-node
    records; the port's local executor then replays every batch the
    workers stored."""
    tc, _, tr = port
    test, ecfg, single = single_run
    store = DiskResultStore(tmp_path / "cache")
    xcfg = ExecutorConfig(n_nodes=4,
                          node_pools=["cpu", "cpu", "cpu", "gpu"],
                          prefetch_depth=2, runtime="process")
    res = CampaignController(ecfg, xcfg, ControllerConfig(rounds=2), tr,
                             tc, device=CPU).run(test, cache=store)
    _same_records(single, res.records)
    assert res.rounds == 2
    assert res.cache_hits == 0 and res.cache_misses > 0
    assert res.node_stats[3].n_docs == 0
    assert res.node_stats[3].n_expensive > 0
    assert sum(s.n_docs for s in res.node_stats[:3]) == len(test)

    store2 = DiskResultStore(tmp_path / "cache")
    warm = CampaignExecutor(
        ecfg, ExecutorConfig(n_nodes=2, straggler_rate=0.0), tr, tc,
        device=CPU).run(test, cache=store2)
    _same_records(single, warm.records)
    assert warm.cache_misses == 0
    assert warm.cache_hits == res.cache_misses


def test_process_pool_survives_worker_crash(port, single_run):
    """A worker hard-exits with a batch in flight: liveness re-issues
    its work to the surviving peer and the records still match."""
    tc, _, tr = port
    test, ecfg, single = single_run
    xcfg = ExecutorConfig(
        n_nodes=2, runtime="process", heartbeat_timeout_s=5.0,
        heartbeat_interval_s=0.1,
        fault_injection=FaultInjection(crash_after=((1, 1),)))
    res = CampaignExecutor(ecfg, xcfg, tr, tc, device=CPU).run(test)
    assert res.reissued >= 1
    _same_records(single, res.records)
    assert sum(s.n_docs for s in res.node_stats) == len(test)


@pytest.mark.parametrize("slowdown", [0.9, 1.4])
def test_heartbeat_reissue_never_duplicates_records(port, single_run,
                                                    slowdown):
    """Worker 1 stops heartbeating but keeps working (slowed): its batch
    re-issues to the peer, both attempts finish, and exactly one
    emission per batch survives."""
    tc, _, tr = port
    test, ecfg, single = single_run
    xcfg = ExecutorConfig(
        n_nodes=2, runtime="process", heartbeat_timeout_s=0.5,
        heartbeat_interval_s=0.1, straggler_grace_s=2.5,
        fault_injection=FaultInjection(mute_after=((1, 0),),
                                       mute_slowdown_s=slowdown))
    res = CampaignExecutor(ecfg, xcfg, tr, tc, device=CPU).run(test)
    _same_records(single, res.records)
    assert res.reissued >= 1
    assert sum(s.n_docs for s in res.node_stats) == len(test)
    assert res.duplicates_dropped >= 1


class _FakeQ:
    def __init__(self):
        self.sent = []

    def put(self, msg):
        self.sent.append(msg)


class _FakeProc:
    def is_alive(self):
        return True


def _bare_pool(n_nodes=2, window=3):
    """A ProcessWorkerPool with coordinator state only (no processes,
    no queues), built by the pool's own ``_init_state``."""
    pool = TW.ProcessWorkerPool.__new__(TW.ProcessWorkerPool)
    pool._init_state(EngineConfig(alpha=0.1),
                     ExecutorConfig(n_nodes=n_nodes, runtime="process",
                                    prefetch_depth=window - 1),
                     n_nodes, list(range(n_nodes)), list(range(n_nodes)),
                     None, None, has_cache=False, device=CPU)
    pool._shm = None                     # inline payloads
    pool.task_qs = [_FakeQ() for _ in range(n_nodes)]
    pool.procs = [_FakeProc() for _ in range(n_nodes)]
    pool._beat = [time.time()] * n_nodes
    return pool


def test_recovered_straggler_window_counts_owed_late_results():
    """A quieted worker's re-issued batches still execute on it when it
    heartbeats back: the refill counts those owed results against the
    window instead of refilling it in full."""
    pool = _bare_pool(n_nodes=2, window=3)
    pending = {1: deque({"batch_key": k, "docs": ()} for k in range(8))}
    pool._top_up(pending)
    assert pool._load[1] == 3

    pool._quiet.add(1)
    pool._reissue_from(1)
    assert pool._load[1] == 0 and pool._owed(1) == 3
    assert pool._load[0] == 3
    assert pool.reissued == 3

    pool._quiet.discard(1)
    sent_before = len(pool.task_qs[1].sent)
    pool._top_up(pending)
    assert len(pool.task_qs[1].sent) == sent_before
    assert pool._load[1] + pool._owed(1) <= pool._window

    pool._late.discard(next(iter(pool._late)))
    pool._top_up(pending)
    assert len(pool.task_qs[1].sent) == sent_before + 1
    assert pool._load[1] + pool._owed(1) <= pool._window
    # every task went out inline (no shm transport on a bare pool)
    assert pool.payloads_inline == len(pool.task_qs[0].sent) + len(
        pool.task_qs[1].sent) and pool.payloads_shm == 0


def test_backlogged_but_alive_worker_not_reissued_early():
    """A worker whose last beacon reported queued work gets one extra
    base timeout per queued task (bounded at 4x) before re-issue; one
    that reported an empty queue keeps the base deadline."""
    pool = _bare_pool(n_nodes=2, window=3)
    pool.xcfg = ExecutorConfig(n_nodes=2, runtime="process",
                               heartbeat_timeout_s=1.0)
    pending = {0: deque([{"batch_key": 0, "docs": ()}]),
               1: deque([{"batch_key": 1, "docs": ()}])}
    pool._top_up(pending)
    assert pool._load == [1, 1]

    pool._beat = [time.time() - 2.0, time.time() - 2.0]
    pool._hb_depth = [3, 0]
    assert pool._deadline_for(0) == pytest.approx(4.0)
    assert pool._deadline_for(1) == pytest.approx(1.0)
    pool._police()
    assert 0 not in pool._quiet
    assert 1 in pool._quiet
    assert pool.reissued == 1
    assert pool._load[0] == 2

    pool._hb_depth[0] = 500
    assert pool._deadline_for(0) == pytest.approx(5.0)
    pool._beat[0] = time.time() - 6.0
    pool._police()
    assert 0 in pool._quiet


def test_heartbeat_send_stamp_is_same_host_only():
    """The send stamp feeds only the same-host queue-delay diagnostic;
    liveness runs on receive time, whatever the stamp's skew."""
    pool = _bare_pool(n_nodes=1, window=1)
    pool._beat = [0.0]
    pool._mono_comparable = False
    for skew in (9999.0, -9999.0):
        pool._handle(TW.Heartbeat(0, time.time(), None,
                                  sent_mono=time.monotonic() + skew,
                                  queue_depth=2))
        assert pool._hb_delay[0] == 0.0
        assert pool._beat[0] == pytest.approx(time.time(), abs=2.0)
        assert pool._hb_depth[0] == 2
    pool._mono_comparable = True
    pool._handle(TW.Heartbeat(0, time.time(), None,
                              sent_mono=time.monotonic() - 0.5,
                              queue_depth=0))
    assert 0.4 < pool._hb_delay[0] < 5.0
    pool._handle(TW.Heartbeat(0, time.time(), None,
                              sent_mono=time.monotonic() + 50.0,
                              queue_depth=0))
    assert pool._hb_delay[0] == 0.0


#: the flap's fault timings. The reference mutes worker 1 for one task
#: with a 0.9 s slowdown, but its last beat before the mute can report
#: one task queued, and then ``_deadline_for`` grants 0.5 s x (1 + 1) =
#: 1.0 s: the silence (the 0.9 s sleep plus a ~0.01-0.07 s batch) ends
#: just inside it and nothing re-issues. Here the silence outlasts the
#: largest deadline the window can grant by FLAP_MARGIN_S.
FLAP_TIMEOUT_S = 0.5
FLAP_WINDOW = 3                          # prefetch_depth 2
FLAP_SLOWDOWN_S = 3.0
FLAP_MARGIN_S = 1.0


def test_straggler_flap_recovers_without_overcommit(port, single_run):
    """End-to-end flap (mute -> re-issue -> heartbeats resume): the
    record set matches the single-node run, something re-issued, and
    every doc is counted exactly once."""
    tc, _, tr = port
    test, ecfg, single = single_run
    # a queue holds at most the window's tasks, so the deadline is at
    # most FLAP_TIMEOUT_S * (1 + min(FLAP_WINDOW, 4))
    bare = _bare_pool(n_nodes=2, window=FLAP_WINDOW)
    bare.xcfg = ExecutorConfig(heartbeat_timeout_s=FLAP_TIMEOUT_S)
    bare._hb_depth = [FLAP_WINDOW, FLAP_WINDOW]
    assert FLAP_SLOWDOWN_S - bare._deadline_for(1) >= FLAP_MARGIN_S
    xcfg = ExecutorConfig(
        n_nodes=2, runtime="process", prefetch_depth=FLAP_WINDOW - 1,
        heartbeat_timeout_s=FLAP_TIMEOUT_S, heartbeat_interval_s=0.1,
        straggler_grace_s=2.5,
        fault_injection=FaultInjection(mute_after=((1, 0),),
                                       unmute_after=((1, 2),),
                                       mute_slowdown_s=FLAP_SLOWDOWN_S))
    res = CampaignExecutor(ecfg, xcfg, tr, tc, device=CPU).run(test)
    _same_records(single, res.records)
    assert res.reissued >= 1
    assert sum(s.n_docs for s in res.node_stats) == len(test)


def test_process_runtime_rejects_simulation_only_config(port):
    """Actionable errors before any process spawns: simulated speed
    factors and in-memory result stores are local-runtime concepts."""
    tc, td, tr = port
    ecfg = EngineConfig(alpha=0.1, batch_size=16)
    with pytest.raises(ValueError, match="simulation-only"):
        CampaignExecutor(
            ecfg, ExecutorConfig(n_nodes=2, runtime="process",
                                 node_speed_factors=[1.0, 4.0]),
            tr, tc, device=CPU).run(td[75:])
    with pytest.raises(ValueError, match="cannot be shared across"):
        CampaignExecutor(
            ecfg, ExecutorConfig(n_nodes=2, runtime="process"),
            tr, tc, device=CPU).run(td[75:], cache=ResultCache())
    with pytest.raises(ValueError, match="heartbeat_timeout_s"):
        CampaignExecutor(
            ecfg, ExecutorConfig(n_nodes=2, runtime="process",
                                 heartbeat_timeout_s=0.0),
            tr, tc, device=CPU).run(td[75:])
    with pytest.raises(ValueError, match="unknown worker runtime"):
        CampaignExecutor(
            ecfg, ExecutorConfig(n_nodes=2, runtime="threads"),
            tr, tc, device=CPU).run(td[75:])


def test_reissue_candidates_exclude_precedes_pool_short_circuit():
    from repro_torch.core import scheduler

    pools = ["cpu", "cpu", "gpu"]
    assert scheduler.reissue_candidates(0, pools, "cpu", 3,
                                        exclude={1}) == [2]
    assert scheduler.reissue_candidates(0, pools, "cpu", 3) == [1]
    assert scheduler.reissue_candidates(2, ["cpu", "gpu", "gpu"],
                                        "gpu", 3, exclude={1}) == []
    assert scheduler.reissue_candidates(0, None, "cpu", 3,
                                        exclude={2}) == [1]


def test_local_pool_satisfies_worker_pool_protocol(port):
    tc, _, tr = port
    ex = CampaignExecutor(EngineConfig(alpha=0.1, batch_size=16),
                          ExecutorConfig(n_nodes=2), tr, tc, device=CPU)
    pool = ex._make_pool(2, [0, 1], [0, 1], None, {}, None)
    assert isinstance(pool, TW.LocalWorkerPool)
    assert isinstance(pool, TW.WorkerPool)
    for method in ("drain", "node_telemetry", "set_alpha", "node_stats",
                   "snapshot_cache", "finalize", "close"):
        assert callable(getattr(TW.ProcessWorkerPool, method))


# -- the port's own seams ---------------------------------------------------


def _tiny_llm_router(ft, dtype="float32"):
    """``router-tiny`` from a seeded init behind the ft router's CLS-I
    stage; its expensive parser is the one the random encoder most
    often predicts an improvement for, so batches route work."""
    cfg = dataclasses.replace(get_config("adaparse-router").reduced().model,
                              param_dtype=dtype)
    enc = init_encoder(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.randint(2, 8000, (16, cfg.max_len),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        pred = enc.predict_accuracies(toks).float()
    exp = int((pred[:, 1:] > pred[:, :1]).sum(0).argmax()) + 1
    return AdaParseRouter("llm", ft.cls1, None, enc_cfg=cfg, encoder=enc,
                          expensive_idx=exp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_portable_router_keeps_its_fingerprint(port, dtype):
    """The router crosses a process as numpy (no tensor) and the encoder
    rebuilt on the receiver's device hashes to the coordinator's
    fingerprint, so every worker's cache tags match."""
    tc, _, tr = port
    assert TSP.portable_router(tr) is tr          # ft: numpy already
    router = _tiny_llm_router(tr, dtype)
    fp = _router_fingerprint(router)
    pr = TSP.portable_router(router)
    assert pr.fingerprint == fp and pr.router.encoder is None

    def leaves(x):
        return (leaves(list(x.values())) if isinstance(x, dict) else
                [y for v in x for y in leaves(v)]
                if isinstance(x, list) else [x])

    assert all(isinstance(a, np.ndarray) for a in leaves(pr.enc_params))
    back = TSP.materialize_router(pickle.loads(pickle.dumps(pr)),
                                  torch.device(CPU))
    assert getattr(back, "_cache_fp", None) is None
    assert _router_fingerprint(back) == fp
    spec = TW.WorkerSpec(0, EngineConfig(), pr, tc, device=CPU)
    assert TSP.spec_fingerprint(spec)["router"] == fp
    # the device is not fingerprinted: workers on the card and on the
    # CPU join one fleet
    assert TSP.spec_fingerprint(dataclasses.replace(spec, device="cuda")) \
        == TSP.spec_fingerprint(spec)


def test_llm_forwarded_prep_crosses_processes_as_numpy(port, monkeypatch):
    """An llm prepare forwarded to the re-parse pool leaves the worker
    with its routing inputs as host numpy equal to the tensors the
    engine produced; the shm codec and a pickle both carry it exactly,
    and the codec refuses the tensors themselves. A pooled llm campaign
    over real processes (every routed batch forwarded), on either
    transport, equals the port's single-node run, and its workers exit
    with code 0."""
    tc, td, ft = port
    router = _tiny_llm_router(ft)
    ecfg = EngineConfig(alpha=0.1, batch_size=16)
    eng = AdaParseEngine(ecfg, router, tc, device=CPU)
    test = td[75:]
    # the first batch that routes expensive work
    key, docs = next((b, test[b * 16:(b + 1) * 16]) for b in range(5)
                     if eng.route_batch(eng.prepare_batch(
                         test[b * 16:(b + 1) * 16], batch_key=b))
                     .expensive_idx.size)
    prep = eng.prepare_batch(docs, batch_key=key)
    done = WM._run_task(eng, 0, TW.PrepareTask(0, key, docs, 0.1,
                                               forward=True))
    assert done.prep is not None and done.records is None
    for k in ("tokens", "mask"):
        assert isinstance(prep.route_host[k], torch.Tensor)
        got = done.prep.route_host[k]
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, prep.route_host[k].numpy())
    with pytest.raises(TypeError, match="torch.Tensor"):
        TSHM.pack_payload(prep)
    header, arrays, descs, nbytes = TSHM.pack_payload((done.prep,
                                                       done.plan))
    buf = bytearray(nbytes)
    for a, (_dt, _shape, off) in zip(arrays, descs):
        buf[off:off + a.nbytes] = memoryview(a.reshape(-1)).cast("B")
    p2, plan2 = TSHM.unpack_payload(header, descs, bytes(buf))
    for k in ("tokens", "mask", "valid_logit"):
        np.testing.assert_array_equal(p2.route_host[k],
                                      done.prep.route_host[k])
    np.testing.assert_array_equal(plan2.expensive_idx,
                                  done.plan.expensive_idx)

    single = AdaParseEngine(ecfg, router, tc, device=CPU).run(test)
    # the workers end cleanly once they have run the encoder (a live
    # heartbeat thread at interpreter exit used to abort them)
    exitcodes = []
    close = TW.ProcessWorkerPool.close

    def spy(pool):
        close(pool)
        exitcodes.extend(p.exitcode for p in pool.procs)

    monkeypatch.setattr(TW.ProcessWorkerPool, "close", spy)
    for transport in ("shm", "pickle"):
        xcfg = ExecutorConfig(n_nodes=2, node_pools=["cpu", "gpu"],
                              runtime="process", transport=transport)
        res = CampaignExecutor(ecfg, xcfg, router, tc, device=CPU).run(test)
        _same_records(single, res.records)
        assert res.node_stats[1].n_expensive > 0
    assert exitcodes == [0] * 4


def test_cuda_worker_without_a_card_fails_start(port):
    """A worker asked for cuda on a host with no card fails the pool's
    start with its own traceback; it never builds on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: a cuda worker starts")
    tc, _, tr = port
    ecfg = EngineConfig(alpha=0.1, batch_size=16)
    with pytest.raises(RuntimeError, match="failed to start") as e:
        TW.make_worker_pool(ecfg, ExecutorConfig(n_nodes=1,
                                                 runtime="process"),
                            tr, tc, 1, [0], [0], None, device="cuda")
    assert "torch.cuda.is_available() is False" in str(e.value)


_MEASURED = re.compile(r"(wall|docs/s|busy)=[0-9.]+")


def test_serve_workers_matches_reference():
    """``serve --workers 2`` prints the reference's report line and
    metric dict; only what is measured (wall seconds, documents/s,
    busy share, and the throughput derived from the measured clocks)
    differs run to run."""
    argv = ["--docs", "90", "--batch-size", "16", "--workers", "2",
            "--transport", "pickle", "--heartbeat-timeout", "20"]
    outs = []
    for main, extra in ((TS.main, ["--device", CPU]), (JS.main, [])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            res = main(argv + extra)
        lines = [_MEASURED.sub(r"\1=*", ln)
                 for ln in buf.getvalue().splitlines()
                 if ln.startswith("[serve] executor[")]
        outs.append((res, lines))
    (t, tl), (j, jl) = outs
    assert tl == jl and "runtime=process" in tl[0]
    assert t.pop("throughput_docs_per_node_s") > 0
    j.pop("throughput_docs_per_node_s")
    assert t == j


_ORPHANING_COORDINATOR = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from repro_torch.core import workers as TW
from repro_torch.core.campaign import ExecutorConfig
from repro_torch.core.engine import EngineConfig
from repro_torch.data.synthetic import CorpusConfig, generate_corpus
from repro_torch.launch.serve import build_ft_router

if __name__ == "__main__":
    tc = CorpusConfig(n_docs=30, seed=0)
    tr = build_ft_router(generate_corpus(tc)[:10], tc,
                         np.random.RandomState(1), device="cpu")
    pool = TW.ProcessWorkerPool(EngineConfig(), ExecutorConfig(
        n_nodes=2, runtime="process", transport="pickle"), tr, tc, 2,
        [0, 1], [0, 1], None, device="cpu")
    print(" ".join(str(p.pid) for p in pool.procs), flush=True)
    os._exit(0)                       # dies without closing its pool
"""


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:                              # a zombie is not alive
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ", 1)[1][0] != "Z"
    except OSError:
        return False


def test_workers_exit_when_their_coordinator_dies():
    """A coordinator that dies without closing its pool leaves no worker
    behind: each worker polls its task queue and takes the death of its
    coordinator as the shutdown sentinel, where it used to block on the
    queue for ever (holding its engine, and on a card its CUDA
    context)."""
    out = subprocess.run(
        [sys.executable, "-c", _ORPHANING_COORDINATOR, str(ROOT / "src")],
        capture_output=True, text=True, timeout=180, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    pids = [int(p) for p in out.stdout.split()]
    assert len(pids) == 2
    deadline = time.time() + 60.0
    while any(_alive(p) for p in pids) and time.time() < deadline:
        time.sleep(0.2)
    assert not any(_alive(p) for p in pids), pids


def test_drain_raises_when_no_task_moves(monkeypatch):
    """A drain whose open task never returns while its worker keeps
    beating (never quieted, so never re-issued) fails with the open
    tasks, their workers and the heartbeat ages once ``DRAIN_STALL_S``
    passes without a ``BatchDone`` or a sent task, instead of waiting
    for ever."""
    pool = TW.ProcessWorkerPool.__new__(TW.ProcessWorkerPool)
    task = TW._TaskState.__new__(TW._TaskState)
    task.current = {1}
    pool._tasks, pool._open = {7: task}, {7}
    pool.n_nodes, pool._beat = 2, [time.time()] * 2
    pool._dead, pool._quiet = set(), set()
    monkeypatch.setattr(TW.ProcessWorkerPool, "DRAIN_STALL_S", 0.05)
    pool._progress_t = time.time()
    pool._check_stall()                     # within the limit: nothing
    time.sleep(0.1)
    with pytest.raises(RuntimeError, match=r"no progress.*\{7: \[1\]\}"):
        pool._check_stall()


def test_reap_terminates_then_kills_what_outlives_its_close():
    """``reap`` joins within one deadline, then terminates, then kills a
    worker that ignores SIGTERM: none outlives its pool's ``close``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    ready = ctx.Event()
    done = ctx.Process(target=time.sleep, args=(0,))
    stubborn = ctx.Process(target=ignore_sigterm_then_sleep, args=(ready,))
    done.start()
    stubborn.start()
    assert ready.wait(timeout=120), "the child did not start in 120 s"
    t0 = time.time()
    TW.reap([done, stubborn], wait_s=0.5)
    assert time.time() - t0 < 30
    assert not done.is_alive() and not stubborn.is_alive()
    assert done.exitcode == 0 and stubborn.exitcode == -9


def test_injected_crash_frees_the_shared_result_queue(monkeypatch):
    """An injected crash exits only after its heartbeat thread has
    stopped and the result queue's feeder has written out what it held,
    so the queue's write lock, which every worker shares, is free: a
    worker that exits with it held stops every other worker's replies
    and heartbeats, and the drain waits (fault 3i)."""
    import multiprocessing as mp
    import queue as queue_lib
    import threading

    q = mp.get_context("spawn").Queue()
    stop, done = threading.Event(), threading.Event()

    def beat():
        while not stop.wait(0.0005):
            q.put(b"x" * 4096)

    def read():                              # the coordinator's reads
        while not done.is_set():
            try:
                q.get(timeout=0.1)
            except queue_lib.Empty:
                pass

    beat_t = threading.Thread(target=beat, daemon=True)
    reader = threading.Thread(target=read, daemon=True)
    beat_t.start()
    reader.start()
    time.sleep(0.3)
    exits = []
    monkeypatch.setattr(WM.os, "_exit", exits.append)
    WM._crash_exit(q, stop, beat_t)
    assert exits == [3] and not beat_t.is_alive()
    assert q._wlock.acquire(timeout=5), "the write lock stayed taken"
    q._wlock.release()
    done.set()
    reader.join(timeout=10)
    assert not reader.is_alive()
