"""The port's shared-memory transport (``repro_torch.core.shm``) against
the JAX package's, on the CPU: the codec round-trips exactly what the
reference's does (and lays out the same arrays at the same offsets),
refuses a torch tensor with an actionable message, generation-tagged
slots turn a reclaimed read into ``ShmStale``, oversize and exhausted
slots fall back inline, response slots cycle, and real 2-worker
campaigns over shm and pickle give records equal to the JAX package's
single-node run, with every payload counted by its carrier and no
``/dev/shm`` entry left behind, even after a hard worker crash."""
import glob
import os

import numpy as np
import pytest
import torch

from repro.core import shm as JSHM
from repro.core.engine import AdaParseEngine as JEngine
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import ParseRecord as JParseRecord
from repro.data.synthetic import Document as JDocument
from repro_torch.core import shm as S
from repro_torch.core.campaign import (CampaignExecutor, ExecutorConfig,
                                       FaultInjection)
from repro_torch.core.engine import EngineConfig, ParseRecord
from repro_torch.data.synthetic import CorpusConfig, Document, generate_corpus
from repro_torch.launch import serve as TS
from torch_spawn_env import one_thread_workers  # noqa: F401

CPU = "cpu"


def _roundtrip(obj, codec=S):
    header, arrays, descs, nbytes = codec.pack_payload(obj)
    buf = bytearray(nbytes)
    for a, (_dt, _shape, off) in zip(arrays, descs):
        buf[off:off + a.nbytes] = memoryview(a.reshape(-1)).cast("B")
    return codec.unpack_payload(header, descs, bytes(buf))


def _assert_docs_equal(a, b):
    assert (a.doc_id, a.difficulty, a.latex_density) == \
        (b.doc_id, b.difficulty, b.latex_density)
    assert (a.producer, a.publisher, a.category, a.year, a.scanned) == \
        (b.producer, b.publisher, b.category, b.year, b.scanned)
    assert len(a.pages) == len(b.pages)
    for pa, pb in zip(a.pages, b.pages):
        assert pa.dtype == pb.dtype
        np.testing.assert_array_equal(pa, pb)


def _doc(doc_id=0, pages=None, producer="pdflatex", publisher="acm",
         cls=Document):
    return cls(doc_id=doc_id,
               pages=(pages if pages is not None
                      else [np.arange(5, dtype=np.int32)]),
               difficulty=0.3, latex_density=0.1, producer=producer,
               publisher=publisher, category="cs.DC", year=2024,
               scanned=False)


def _same_layout(obj, jobj):
    """The port's codec and the reference's pack the same arrays at the
    same offsets (the header trees name the same dataclasses)."""
    h, arrays, descs, n = S.pack_payload(obj)
    jh, jarrays, jdescs, jn = JSHM.pack_payload(jobj)
    assert (descs, n) == (jdescs, jn)
    for a, b in zip(arrays, jarrays):
        assert a.tobytes() == b.tobytes()


def test_codec_roundtrips_empty_document():
    for pages in ([], [np.zeros(0, np.int32)],
                  [np.zeros(0, np.int32), np.arange(3, dtype=np.int32)]):
        doc = _doc(pages=pages)
        _assert_docs_equal(doc, _roundtrip(doc))
        _same_layout(doc, _doc(pages=pages, cls=JDocument))


def test_codec_roundtrips_non_ascii_text():
    doc = _doc(producer="pdfTeX-1.40 — фреймворк", publisher="Éditions 数学")
    out = _roundtrip(doc)
    _assert_docs_equal(doc, out)
    assert out.producer == "pdfTeX-1.40 — фреймворк"


def test_codec_roundtrips_max_length_pages():
    rng = np.random.RandomState(0)
    pages = [rng.randint(0, 2**31 - 1, 6144).astype(np.int32),
             rng.randint(0, 255, 6144).astype(np.uint8),
             rng.randn(6144)]
    rec = ParseRecord(doc_id=7, parser="pymupdf", pages=pages,
                      cost_s=0.125)
    out = _roundtrip(rec)
    assert (out.doc_id, out.parser, out.cost_s) == (7, "pymupdf", 0.125)
    for pa, pb in zip(pages, out.pages):
        assert pa.dtype == pb.dtype
        np.testing.assert_array_equal(pa, pb)
    _same_layout(rec, JParseRecord(doc_id=7, parser="pymupdf",
                                   pages=pages, cost_s=0.125))


def test_codec_roundtrips_rng_and_containers():
    rs = np.random.RandomState(42)
    rs.rand(17)
    obj = {"rng": rs, "t": (1, "α", None, np.float32(0.5)),
           "l": [np.arange(4), b"raw"], "flag": True}
    out = _roundtrip(obj)
    assert out["t"] == (1, "α", None, np.float32(0.5))
    assert isinstance(out["t"], tuple) and isinstance(out["l"], list)
    assert type(out["t"][3]) is np.float32
    assert out["l"][1] == b"raw" and out["flag"] is True
    np.testing.assert_array_equal(out["rng"].rand(9),
                                  np.random.RandomState(42).rand(17 + 9)[17:])


def test_codec_rejects_unknown_types_actionably():
    with pytest.raises(TypeError, match="cannot pack"):
        S.pack_payload({"bad": object()})


def test_codec_refuses_torch_tensors_actionably():
    """A tensor never rides a payload: the codec names it and says to
    move it to the host, and the encode side ships it inline only as a
    counted fallback (which the worker never lets happen)."""
    for t in (torch.arange(4), torch.zeros(2, 3, dtype=torch.bfloat16)):
        with pytest.raises(TypeError, match=r"torch\.Tensor.*cpu\(\)\.numpy"):
            S.pack_payload({"route_host": {"tokens": t}})
    tr = S.CoordinatorShmTransport("adp-tshm-tensor", 1, n_task_slots=2,
                                   n_resp_slots=2)
    try:
        assert tr.encode_task([torch.arange(3)]) is None
        assert tr.fallbacks == 1
    finally:
        tr.close()


def _shm_entries(prefix: str) -> list[str]:
    return sorted(glob.glob(f"/dev/shm/{prefix}*"))


def test_stale_generation_raises_shm_stale():
    t = S.CoordinatorShmTransport("adp-tshm-stale", 1, n_task_slots=2,
                                  n_resp_slots=2)
    try:
        ref = t.encode_task([np.arange(10)])
        assert ref is not None
        np.testing.assert_array_equal(t._task.read(ref)[0], np.arange(10))
        t.free_task(ref)
        with pytest.raises(S.ShmStale):
            t._task.read(ref)
    finally:
        t.close()
    assert _shm_entries("adp-tshm-stale") == []


def test_oversize_and_exhausted_slots_fall_back_inline():
    t = S.CoordinatorShmTransport("adp-tshm-fb", 1, n_task_slots=2,
                                  n_resp_slots=2)
    try:
        small = [np.zeros(8, np.uint8)]
        r1, r2 = t.encode_task(small), t.encode_task(small)
        assert r1 is not None and r2 is not None
        assert t.encode_task(small) is None
        big = [np.zeros(2 * t._task.slot_bytes, np.uint8)]
        assert t.encode_task(big) is None
        assert t.fallbacks == 2
        t.free_task(r1)
        assert t.encode_task(small) is not None
    finally:
        t.close()
    assert _shm_entries("adp-tshm-fb") == []


def test_small_dev_shm_falls_back_inline_with_one_warning(monkeypatch):
    """A /dev/shm too small for the arenas is refused when they are
    created (their pages are reserved then), never by a SIGBUS at a
    later write: one warning, every payload inline, no segment left."""
    import errno

    def full(fd, offset, length):
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(S.os, "posix_fallocate", full)
    t = S.CoordinatorShmTransport("adp-tshm-small", 2, n_task_slots=4,
                                  n_resp_slots=2)
    try:
        with pytest.warns(RuntimeWarning, match="falling back"):
            assert t.encode_task([np.arange(10)]) is None
        assert t.encode_task([np.arange(10)]) is None
        # the transport counts the refusal once and is disabled after;
        # the pool counts every inline payload (payloads_inline)
        assert t.fallbacks == 1 and t._disabled
    finally:
        t.close()
    assert _shm_entries("adp-tshm-small") == []


def test_worker_response_slots_cycle_free_full():
    t = S.CoordinatorShmTransport("adp-tshm-resp", 1, n_task_slots=2,
                                  n_resp_slots=2)
    try:
        assert t.encode_task([np.arange(3)]) is not None
        w = S.WorkerShmTransport("adp-tshm-resp", 0, 1, n_resp_slots=2)
        payload = {"recs": [np.arange(100, dtype=np.int64)], "n": 5}
        refs = [w.encode_result(payload) for _ in range(2)]
        assert all(r is not None for r in refs)
        assert w.encode_result(payload) is None
        out = t.take_result(refs[0])
        np.testing.assert_array_equal(out["recs"][0],
                                      np.arange(100, dtype=np.int64))
        assert out["n"] == 5
        assert w.encode_result(payload) is not None
        w.close()
    finally:
        t.close()
    assert _shm_entries("adp-tshm-resp") == []


# -- real worker fleets -------------------------------------------------


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
    single-node records over the test half."""
    jc, jd = corpus
    tc = CorpusConfig(n_docs=150, seed=0)
    td = generate_corpus(tc)
    tr = TS.build_ft_router(td[:75], tc, np.random.RandomState(1),
                            device=CPU)
    single = JEngine(JEngineConfig(alpha=0.1, batch_size=16), ft_router,
                     jc).run(jd[75:])
    return tc, td[75:], tr, single


@pytest.fixture()
def pool_spy(monkeypatch):
    from repro_torch.core import workers as W

    pools = []
    orig = W.ProcessWorkerPool.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        pools.append(self)

    monkeypatch.setattr(W.ProcessWorkerPool, "__init__", spy)
    return pools


def test_shm_and_pickle_campaigns_match_record_for_record(fleet,
                                                          pool_spy):
    """The same 2-worker campaign over shm and pickle gives the JAX
    package's single-node records; the shm run carried every payload in
    an arena slot (none inline) and the pickle run every one inline, as
    the pools' carrier counts and counters show."""
    tc, test, tr, single = fleet
    ecfg = EngineConfig(alpha=0.1, batch_size=16)
    runs = {}
    for transport in ("shm", "pickle"):
        xcfg = ExecutorConfig(n_nodes=2, runtime="process",
                              transport=transport)
        runs[transport] = CampaignExecutor(ecfg, xcfg, tr, tc,
                                           device=CPU).run(test)
    _same_records(single, runs["shm"].records)
    _same_records(runs["pickle"].records, runs["shm"].records)
    shm_pool, pickle_pool = pool_spy
    n_batches = -(-len(test) // 16)
    assert shm_pool._shm is not None and shm_pool._shm.fallbacks == 0
    assert (shm_pool.payloads_shm, shm_pool.payloads_inline) == \
        (2 * n_batches, 0)
    assert pickle_pool._shm is None
    assert (pickle_pool.payloads_shm, pickle_pool.payloads_inline) == \
        (0, 2 * n_batches)
    counters = runs["shm"].obs_metrics["counters"]
    assert counters["pool.payloads_shm"] == 2 * n_batches
    assert "pool.payloads_inline" not in counters
    assert shm_pool._shm._task is None
    assert _shm_entries(shm_pool._shm.base) == []


def test_invalid_transport_is_actionable(fleet):
    tc, test, tr, _ = fleet
    with pytest.raises(ValueError, match="transport"):
        CampaignExecutor(
            EngineConfig(alpha=0.1, batch_size=16),
            ExecutorConfig(n_nodes=2, runtime="process", transport="grpc"),
            tr, tc, device=CPU).run(test[:24])


def test_crashed_worker_leaves_no_shm_orphans(fleet, pool_spy):
    tc, test, tr, single = fleet
    xcfg = ExecutorConfig(
        n_nodes=2, runtime="process", transport="shm",
        heartbeat_timeout_s=5.0, heartbeat_interval_s=0.1,
        fault_injection=FaultInjection(crash_after=((1, 1),)))
    res = CampaignExecutor(EngineConfig(alpha=0.1, batch_size=16), xcfg,
                           tr, tc, device=CPU).run(test)
    _same_records(single, res.records)
    assert res.reissued >= 1
    base = pool_spy[0]._shm.base
    assert base.startswith(f"adaparse-{os.getpid():x}-")
    assert _shm_entries(base) == []
    assert _shm_entries(f"adaparse-{os.getpid():x}-") == []
