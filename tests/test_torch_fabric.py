"""The port's TCP fabric (``repro_torch.core.fabric`` with
``core/specs`` and ``launch/fabric_worker``) against the JAX package, on
the CPU: frames, spec-fingerprint admission with actionable rejections
(the port's fingerprints equal the reference's for the same engine
config), elastic membership over live loopback workers, and fabric
campaigns — plain, and adaptive with a worker joining and another
crashing mid-run — whose records equal the JAX package's single-node
run. ``serve --fabric-workers`` prints the reference's metric dict, and
a standalone ``serve --connect`` worker runs on its own ``--device``."""
import io
import queue as queue_lib
import re
import socket
import struct
import subprocess
import sys
import time
from collections import Counter, deque
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import specs as JSP
from repro.core.engine import AdaParseEngine as JEngine
from repro.core.engine import EngineConfig as JEngineConfig
from repro.launch import serve as JS
from repro_torch.core import obs
from repro_torch.core import specs
from repro_torch.core.campaign import (CampaignController, CampaignExecutor,
                                       ControllerConfig, ExecutorConfig,
                                       FaultInjection)
from repro_torch.core.engine import EngineConfig
from repro_torch.core.fabric import (MAX_FRAME_BYTES, MISMATCHED_FINGERPRINT,
                                     FabricElastic, FabricWorkerPool,
                                     FrameDecoder, Hello, Shutdown,
                                     encode_frame, parse_addr)
from repro_torch.core.workers import ProcessWorkerPool
from repro_torch.data.synthetic import CorpusConfig, generate_corpus
from repro_torch.launch import serve as TS
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
            np.testing.assert_array_equal(pa, pb)


@pytest.fixture(scope="module")
def fleet(corpus, ft_router):
    """The port's corpus and ft router, and the JAX package's
    single-node records at batch size 8 (so small fleets see enough
    batches for the elastic schedules to fire)."""
    jc, jd = corpus
    tc = CorpusConfig(n_docs=150, seed=0)
    td = generate_corpus(tc)
    tr = TS.build_ft_router(td[:75], tc, np.random.RandomState(1),
                            device=CPU)
    single = JEngine(JEngineConfig(alpha=0.1, batch_size=8), ft_router,
                     jc).run(jd[75:])
    return tc, td[75:], tr, EngineConfig(alpha=0.1, batch_size=8), single


# -- wire format ------------------------------------------------------------


def test_frame_roundtrip_one_byte_at_a_time():
    msgs = [Hello(fingerprint=None, host="h", pid=7), Shutdown(),
            {"arr": np.arange(5, dtype=np.int32), "s": "x" * 100}]
    stream = b"".join(encode_frame(m) for m in msgs)
    dec = FrameDecoder()
    got = []
    for i in range(len(stream)):
        got.extend(dec.feed(stream[i:i + 1]))
    assert len(got) == 3
    assert isinstance(got[0], Hello) and got[0].pid == 7
    assert isinstance(got[1], Shutdown)
    np.testing.assert_array_equal(got[2]["arr"], np.arange(5))
    assert len(list(FrameDecoder().feed(stream))) == 3


def test_frame_decoder_rejects_absurd_lengths():
    bad = struct.pack("!Q", MAX_FRAME_BYTES + 1) + b"x"
    with pytest.raises(ValueError, match="exceeds"):
        list(FrameDecoder().feed(bad))


def test_parse_addr():
    assert parse_addr("127.0.0.1:7777") == ("127.0.0.1", 7777)
    assert parse_addr("0.0.0.0:0") == ("0.0.0.0", 0)
    with pytest.raises(ValueError, match="HOST:PORT"):
        parse_addr("7777")
    with pytest.raises(ValueError, match="HOST:PORT"):
        parse_addr(":7777")


# -- spec fingerprints and admission --------------------------------------


def test_describe_mismatch_names_the_differing_field():
    fp = {"router": "a" * 16, "engine_config": "b" * 16,
          "backends": "c" * 16}
    assert specs.describe_mismatch(fp, dict(fp)) is None
    msg = specs.describe_mismatch(fp, dict(fp, router="0" * 16))
    assert "'router'" in msg and "a" * 16 in msg and "0" * 16 in msg
    assert msg == JSP.describe_mismatch(fp, dict(fp, router="0" * 16))
    msg = specs.describe_mismatch(fp, dict(fp, engine_config="0" * 16))
    assert "'engine_config'" in msg and "EngineConfig" in msg
    msg = specs.describe_mismatch(fp, dict(fp, extra="zzz"))
    assert "unknown fields" in msg and "extra" in msg


def test_engine_config_fingerprint_tracks_record_shaping_fields():
    """The port's digests equal the reference's for the same fields, and
    move with every record-shaping one."""
    a = specs.engine_config_fingerprint(EngineConfig(alpha=0.1))
    assert a == specs.engine_config_fingerprint(EngineConfig(alpha=0.1))
    assert a != specs.engine_config_fingerprint(EngineConfig(alpha=0.2))
    assert a == JSP.engine_config_fingerprint(JEngineConfig(alpha=0.1))
    x = specs.backend_specs_fingerprint((("m", "f"),))
    assert x == specs.backend_specs_fingerprint((("m", "f"),))
    assert x != specs.backend_specs_fingerprint((("m", "g"),))
    assert x != specs.backend_specs_fingerprint(())
    assert x == JSP.backend_specs_fingerprint((("m", "f"),))


def test_admission_decision_is_actionable():
    from collections import deque
    fp = {"router": "a" * 16, "engine_config": "b" * 16,
          "backends": "c" * 16}
    pool = FabricWorkerPool.__new__(FabricWorkerPool)
    pool.n_nodes = 2
    pool._expected_fp = fp
    pool._unassigned = deque([0])
    assert pool._admission_error(Hello(fingerprint=None)) is None
    assert pool._admission_error(Hello(fingerprint=dict(fp))) is None
    reason = pool._admission_error(
        Hello(fingerprint=MISMATCHED_FINGERPRINT))
    assert "'router'" in reason
    pool._unassigned.clear()
    assert "fleet full" in pool._admission_error(Hello())
    assert "'router'" in pool._admission_error(
        Hello(fingerprint=MISMATCHED_FINGERPRINT))


def test_fabric_pool_heartbeat_clocks_not_comparable():
    assert ProcessWorkerPool._mono_comparable is True
    assert FabricWorkerPool._mono_comparable is False


# -- elastic membership over a live loopback fleet ------------------------


def _pump_until(pool, cond, timeout_s: float, what: str):
    deadline = time.time() + timeout_s
    while not cond():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        try:
            msg = pool.result_q.get(timeout=0.2)
        except queue_lib.Empty:
            continue
        pool._handle(msg)


def test_membership_span_conservation_law(fleet):
    """#join - #leave == the live fleet: every admission emits a join
    span, every dropped connection a leave span, every refused dialer an
    admission_rejected span naming the differing field."""
    tc, _, tr, ecfg, _ = fleet
    xcfg = ExecutorConfig(n_nodes=2, runtime="fabric", obs=True,
                          heartbeat_interval_s=0.2)
    rec = obs.configure(enabled=True, node=-1)
    base = obs.metrics().snapshot()
    pool = None
    reject_proc = None
    try:
        pool = FabricWorkerPool(ecfg, xcfg, tr, tc, 2, [0, 1], [0, 1],
                                None, device=CPU)
        assert pool._joins == 2 and pool._leaves == 0
        assert sorted(pool.live_ingest_nodes()) == [0, 1]

        from repro_torch.launch.fabric_worker import spawn_loopback
        reject_proc = spawn_loopback(pool.addr,
                                     fingerprint=MISMATCHED_FINGERPRINT)
        _pump_until(pool, lambda: pool._rejected == 1, 120.0,
                    "the mismatched dialer's rejection")
        reject_proc.join(timeout=60.0)
        assert reject_proc.exitcode == 4
        assert pool._joins == 2

        pool._local_procs[0].terminate()
        _pump_until(pool, lambda: pool._leaves == 1, 60.0,
                    "the killed worker's leave")
        live = pool.live_ingest_nodes()
        assert pool._joins - pool._leaves == len(live) == 1

        spans = rec.drain(100000)
        names = Counter(s.name for s in spans)
        assert names["join"] == 2
        assert names["leave"] == 1
        assert names["admission_rejected"] == 1
        rejected = [s for s in spans if s.name == "admission_rejected"]
        assert "'router'" in rejected[0].detail

        pool._flush_net_counters()
        counters = obs.diff(obs.metrics().snapshot(), base)["counters"]
        assert counters.get("fabric.joins", 0) == 2
        assert counters.get("fabric.leaves", 0) == 1
        assert counters.get("fabric.rejected", 0) == 1
        assert counters.get("fabric.bytes_tx", 0) > 0
        assert counters.get("fabric.bytes_rx", 0) > 0
    finally:
        if pool is not None:
            pool.close()
        if reject_proc is not None and reject_proc.is_alive():
            reject_proc.terminate()
        obs.configure(enabled=False)


# -- campaign determinism over the fabric ---------------------------------


def test_fabric_pool_matches_single_node(fleet):
    """2 loopback fabric workers give the JAX package's single-node
    records; every payload rode inline."""
    tc, test, tr, ecfg, single = fleet
    xcfg = ExecutorConfig(n_nodes=2, runtime="fabric",
                          heartbeat_interval_s=0.2)
    res = CampaignExecutor(ecfg, xcfg, tr, tc, device=CPU).run(test)
    _same_records(single, res.records)
    assert sum(s.n_docs for s in res.node_stats) == len(test)
    assert all(s.n_docs > 0 for s in res.node_stats)
    counters = res.obs_metrics["counters"]
    assert counters["pool.payloads_inline"] == 2 * (-(-len(test) // 8))
    assert "pool.payloads_shm" not in counters


def test_elastic_join_crash_campaign_matches_single_node(fleet):
    """An adaptive fabric campaign where a worker joins mid-run and
    another hard-crashes reproduces the single-node records, with the
    membership spans and fabric counters to show for it."""
    tc, test, tr, ecfg, single = fleet
    xcfg = ExecutorConfig(
        n_nodes=3, runtime="fabric", obs=True,
        heartbeat_timeout_s=5.0, heartbeat_interval_s=0.1,
        fault_injection=FaultInjection(crash_after=((1, 2),)),
        fabric=FabricElastic(join_after=((2, 3),)))
    res = CampaignController(ecfg, xcfg, ControllerConfig(rounds=2), tr,
                             tc, device=CPU).run(test)
    _same_records(single, res.records)
    assert res.reissued >= 1
    assert res.rounds == 2

    by = Counter(s.name for s in (res.spans or []))
    assert by["leave"] == 1
    assert by["join"] >= 2
    assert by["join"] - by["leave"] >= 1
    assert set(by) <= set(obs.SPAN_STAGES)

    counters = (res.obs_metrics or {}).get("counters", {})
    assert counters.get("fabric.joins", 0) == by["join"]
    assert counters.get("fabric.leaves", 0) == 1
    assert counters.get("fabric.bytes_tx", 0) > 0
    assert counters.get("fabric.bytes_rx", 0) > 0
    # the workers publish their kernel launch counts (zero on the CPU:
    # the plain versions run there)
    gauges = res.obs_metrics["gauges"]
    assert "kernel.launches.fast_features.n0" in gauges
    assert all(v == 0 for k, v in gauges.items()
               if k.startswith("kernel.launches."))


def test_joiner_launched_mid_drain_takes_queued_work(fleet):
    """A one-shot fabric campaign (one drain, no round boundary) whose
    joiner is launched after 2 batches while every peer stays healthy:
    the drain waits for it, and it takes queued batches from its peers'
    queues, so it serves documents; the records equal single node."""
    tc, test, tr, ecfg, single = fleet
    xcfg = ExecutorConfig(
        n_nodes=3, runtime="fabric", obs=True,
        heartbeat_timeout_s=5.0, heartbeat_interval_s=0.1,
        fabric=FabricElastic(join_after=((2, 2),)))
    res = CampaignExecutor(ecfg, xcfg, tr, tc, device=CPU).run(test)
    _same_records(single, res.records)
    assert res.reissued == 0
    assert res.node_stats[2].n_docs > 0
    by = Counter(s.name for s in res.spans)
    assert by["join_spawn"] == by["join_ready"] == 1
    assert set(by) <= set(obs.SPAN_STAGES)


@pytest.mark.parametrize("queues, loads, want", [
    # the elastic scenario's last round sharded 3:1 over nodes 0 and 1
    # (node 0 holds two in flight): node 1's free slot takes the tail
    # batch before the idle joiner, node 2
    ({0: [9]}, [2, 1, 0], {1: [9]}),
    # 4:0: node 1 fills its window from node 0's tail, the joiner takes
    # what is left
    ({0: [7, 8, 9]}, [2, 0, 0], {1: [8, 9], 2: [7]}),
    ({0: [5, 6, 7, 8, 9]}, [2, 2, 0], {0: [5, 6, 7], 2: [8, 9]}),
    # windows full or nothing queued: nothing moves
    ({0: [9]}, [2, 2, 2], {0: [9]}),
    ({}, [0, 0, 0], {}),
])
def test_rebalance_takes_tail_batches_in_node_order(monkeypatch, queues,
                                                    loads, want):
    pool = FabricWorkerPool.__new__(FabricWorkerPool)
    pool._window = 2
    pool._effective_load = lambda w: loads[w]
    pool.live_ingest_nodes = lambda: [0, 1, 2]
    monkeypatch.setattr(ProcessWorkerPool, "_top_up",
                        lambda self, pending: None)
    pending = {n: deque({"batch_key": b} for b in q)
               for n, q in queues.items()}
    pool._rebalance(pending)
    got = {n: [b["batch_key"] for b in q] for n, q in pending.items() if q}
    assert got == want


def test_fabric_runtime_rejects_bad_config(fleet):
    tc, test, tr, _, _ = fleet
    ecfg = EngineConfig(alpha=0.1, batch_size=16)
    with pytest.raises(ValueError, match="simulation-only"):
        CampaignExecutor(
            ecfg, ExecutorConfig(n_nodes=2, runtime="fabric",
                                 node_speed_factors=[1.0, 4.0]),
            tr, tc, device=CPU).run(test)
    with pytest.raises(ValueError, match="join_after"):
        CampaignExecutor(
            ecfg, ExecutorConfig(n_nodes=2, runtime="fabric",
                                 fabric=FabricElastic(
                                     join_after=((7, 1),))),
            tr, tc, device=CPU).run(test)


# -- serve --------------------------------------------------------------------

_MEASURED = re.compile(r"(wall|docs/s|busy)=[0-9.]+")


def _serve(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = main(argv)
    lines = [_MEASURED.sub(r"\1=*", ln) for ln in buf.getvalue().splitlines()
             if ln.startswith("[serve] executor[")]
    return res, lines


def test_serve_fabric_workers_matches_reference():
    """``serve --fabric-workers 2`` (loopback workers) prints the
    reference's report line and metric dict, but for what is measured
    (wall, documents/s, busy and the throughput derived from them)."""
    argv = ["--docs", "90", "--batch-size", "16", "--fabric-workers", "2"]
    t, tl = _serve(TS.main, argv + ["--device", CPU])
    j, jl = _serve(JS.main, argv)
    assert tl == jl and "runtime=fabric" in tl[0]
    assert t.pop("throughput_docs_per_node_s") > 0
    j.pop("throughput_docs_per_node_s")
    assert t == j


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_connect_worker_runs_on_its_own_device():
    """A coordinator started with ``--coordinator`` waits for a
    standalone ``serve --connect ... --device cpu`` worker, whose
    metric dict equals the loopback fleet's; ``--connect`` refuses
    campaign flags and a card it does not have."""
    port = _free_port()
    argv = ["--docs", "90", "--batch-size", "16", "--fabric-workers", "1",
            "--coordinator", f"127.0.0.1:{port}", "--device", CPU]
    env_src = str(ROOT / "src")
    worker = subprocess.Popen(
        [sys.executable, "-c",
         "import socket, sys, time\n"
         f"sys.path.insert(0, {env_src!r})\n"
         "from repro_torch.launch import serve\n"
         "deadline = time.time() + 120\n"
         "while True:\n"
         "    try:\n"
         f"        socket.create_connection(('127.0.0.1', {port})).close()\n"
         "        break\n"
         "    except OSError:\n"
         "        assert time.time() < deadline\n"
         "        time.sleep(0.2)\n"
         f"serve.main(['--connect', '127.0.0.1:{port}', '--device', "
         "'cpu'])\n"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT)
    try:
        t, tl = _serve(TS.main, argv)
        out, err = worker.communicate(timeout=120)
    finally:
        worker.kill()
    assert worker.returncode == 0, err[-2000:]
    loop, ll = _serve(TS.main, ["--docs", "90", "--batch-size", "16",
                                "--fabric-workers", "1", "--device", CPU])
    assert tl == ll and "runtime=fabric" in tl[0]
    t.pop("throughput_docs_per_node_s")
    loop.pop("throughput_docs_per_node_s")
    assert t == loop
    bad_argvs = [["--device", CPU, "--workers", "2"],
                 ["--device", CPU, "--nodes", "2"]]
    if not torch.cuda.is_available():
        bad_argvs.append(["--device", "cuda"])
    for bad in bad_argvs:
        with pytest.raises(SystemExit) as e:
            TS.main(["--connect", "127.0.0.1:1"] + bad)
        assert e.value.code == 2
