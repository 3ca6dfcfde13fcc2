"""The port's campaign layer against the JAX package, on the CPU.

The same seeded corpora go through both packages' ``CampaignExecutor``
and ``CampaignController`` (in-process simulated fleet), with the ft
router built by each package's ``build_ft_router`` (whose stages are
held equal). Records (doc id, parser, page arrays, cost), the simulated
clocks (``wall_s``, ``docs_per_s``, ``node_busy_frac``), re-issue and
cache counters, node α's, weight histories, per-round throughput, α
and decisions must be identical; probe quality EWMAs agree to 1e-9
(``tests/test_torch_metrics.py``'s probe bar). The ``llm`` variant
carries the JAX ``router-tiny`` params across; its records agree except
for documents whose improvement lies within 1e-5 of tau. Also: the
fleet helpers of ``core/scheduler.py``, ``serve``'s campaign flags
(the reference's metric dict and report lines), the refused runtimes
and flags, and ``obs_report`` over the port's trace directory.
"""
import dataclasses
import io
import pickle
import threading
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.common import unwrap
from repro.configs import get_config as j_get_config
from repro.core import backends as JB
from repro.core import campaign as JC
from repro.core import engine as JE
from repro.core import obs as jobs
from repro.core import quality as JQ
from repro.core import scheduler as JS_
from repro.core.router import AdaParseRouter as JRouter
from repro.data.synthetic import CorpusConfig as JCorpusConfig
from repro.data.synthetic import generate_corpus as j_generate
from repro.launch import obs_report as JOR
from repro.launch import serve as JS
from repro.models import encoder as jenc
from repro_torch.configs import get_config
from repro_torch.core import backends as TB
from repro_torch.core import campaign as TC
from repro_torch.core import engine as TE
from repro_torch.core import obs as tobs
from repro_torch.core import quality as TQ
from repro_torch.core import scheduler as TS_
from repro_torch.core import workers as TW
from repro_torch.core.router import AdaParseRouter as TRouter
from repro_torch.core.router import make_route_step
from repro_torch.data.synthetic import CorpusConfig, generate_corpus
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.budget_route.ops import (POSITIVE_TAU,
                                                  capacity_floor)
from repro_torch.launch import obs_report as TOR
from repro_torch.launch import serve as TS
from repro_torch.models.encoder import encoder_from_jax_params
from torch_spawn_env import one_thread_workers  # noqa: F401

PROBE_TOL = 1e-9        # probe qualities, tests/test_torch_metrics.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The small campaigns gain nothing from intra-op threads, and the
    suite's other workers (some with wall-clock heartbeats) share the
    cores; the thread count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(n_docs: int):
    jc, tc = JCorpusConfig(n_docs=n_docs, seed=0), CorpusConfig(
        n_docs=n_docs, seed=0)
    jd, td = j_generate(jc), generate_corpus(tc)
    for a, b in zip(jd, td):
        assert a.doc_id == b.doc_id
        assert all(np.array_equal(p, q) for p, q in zip(a.pages, b.pages))
    return jc, jd, tc, td


def _routers(jc, jd, tc, td, n_train):
    jr = JS.build_ft_router(jd[:n_train], jc, np.random.RandomState(1))
    tr = TS.build_ft_router(td[:n_train], tc, np.random.RandomState(1),
                            device="cpu")
    np.testing.assert_array_equal(tr.cls1.w, jr.cls1.w)
    np.testing.assert_array_equal(tr.cls2.w, jr.cls2.w)
    return jr, tr


@pytest.fixture(scope="module")
def shared(corpus, ft_router):
    """The shared 150-document corpus and ft routers fit on its first
    half: the reference's from ``tests/conftest.py``, the port's built
    the same way and held equal to it."""
    jc, jd = corpus
    tc = CorpusConfig(n_docs=150, seed=0)
    td = generate_corpus(tc)
    for a, b in zip(jd, td):
        assert a.doc_id == b.doc_id
        assert all(np.array_equal(p, q) for p, q in zip(a.pages, b.pages))
    tr = TS.build_ft_router(td[:75], tc, np.random.RandomState(1),
                            device="cpu")
    np.testing.assert_array_equal(tr.cls1.w, ft_router.cls1.w)
    np.testing.assert_array_equal(tr.cls2.w, ft_router.cls2.w)
    return jc, jd[75:], ft_router, tc, td[75:], tr


@pytest.fixture(scope="module")
def degrading():
    """``tests/test_quality.py``'s degrading corpus: an easy segment then
    an equally long hard one where the cheap parser collapses."""
    jc, jd, tc, td = _pair(420)
    jr, tr = _routers(jc, jd, tc, td, 96)

    def split(docs):
        pool = sorted(docs[96:], key=lambda d: d.difficulty)
        return pool[:96] + pool[-96:]

    return jc, split(jd), jr, tc, split(td), tr


def _records_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        ra, rb = a[k], b[k]
        assert (ra.doc_id, ra.parser, ra.cost_s) == \
            (rb.doc_id, rb.parser, rb.cost_s)
        assert len(ra.pages) == len(rb.pages)
        assert all(np.array_equal(p, q) for p, q in zip(ra.pages, rb.pages))


def _results_equal(j, t) -> None:
    """Every simulated figure and counter, exactly."""
    _records_equal(t.records, j.records)
    for f in ("wall_s", "docs_per_s", "node_busy_frac", "reissued",
              "reissued_reparse", "cache_hits", "cache_misses",
              "node_alphas"):
        assert getattr(t, f) == getattr(j, f), f
    assert [dataclasses.asdict(s) for s in t.node_stats] == \
        [dataclasses.asdict(s) for s in j.node_stats]


def _controller_equal(j, t) -> None:
    _results_equal(j, t)
    assert t.rounds == j.rounds
    assert t.weight_history == j.weight_history
    assert len(t.telemetry) == len(j.telemetry)
    for jt, tt in zip(j.telemetry, t.telemetry):
        assert (tt.alpha, tt.throughput, tt.decision, tt.n_probe_docs) == \
            (jt.alpha, jt.throughput, jt.decision, jt.n_probe_docs)
        assert tt.quality.keys() == jt.quality.keys()
        for p in jt.quality:
            assert abs(tt.quality[p] - jt.quality[p]) <= PROBE_TOL


def _assert_numpy_records_on_disk(cache_dir) -> None:
    """A stored batch holds ParseRecords of numpy arrays and Python
    values only, never a tensor, so it replays on either device."""
    files = list(Path(cache_dir).glob("*.pkl"))
    assert files

    def walk(x):
        if isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
        elif isinstance(x, TE.ParseRecord):
            walk(dataclasses.astuple(x))
        else:
            assert isinstance(x, (np.ndarray, np.generic, int, float, str,
                                  type(None))), type(x)

    for f in files:
        walk(pickle.loads(f.read_bytes()))


# -- core/scheduler.py: the fleet helpers ---------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_fleet_helpers_match_reference(seed):
    rng = np.random.RandomState(seed)
    for _ in range(50):
        n = int(rng.randint(0, 400))
        t_c, t_e = rng.uniform(0.001, 0.1, 2)
        budget = float(rng.uniform(0, 2) * max(n, 1) * max(t_c, t_e))
        assert TS_.alpha_for_budget(budget, n, t_c, t_e) == \
            JS_.alpha_for_budget(budget, n, t_c, t_e)
        a = float(rng.uniform(0, 1))
        assert TS_.expected_goodput(a, t_c, t_e, 0.002) == \
            JS_.expected_goodput(a, t_c, t_e, 0.002)
    # quantised accuracies give exact ties between upgrades, which the
    # unstable argsort must break as the reference's does
    n, m = 64, 4
    pred = np.round(rng.uniform(0, 1, (n, m)), 1)
    costs = np.array([0.01, 0.2, 0.05, 0.4])
    devices = ["cpu", "gpu", "cpu", "gpu"]
    for budget in (n * 0.01, n * 0.05, n * 0.15, n * 1.0):
        assert np.array_equal(
            TS_.assign_parsers_greedy(pred, costs, budget),
            JS_.assign_parsers_greedy(pred, costs, budget))
        caps = {"gpu": budget * float(rng.uniform(0.05, 0.5))}
        got = TS_.assign_parsers_greedy(pred, costs, budget, devices, caps)
        want = JS_.assign_parsers_greedy(pred, costs, budget, devices,
                                         caps)
        assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="parser devices"):
        TS_.assign_parsers_greedy(pred, costs, 1.0, ["cpu"], {"cpu": 1.0})


# -- CampaignExecutor -----------------------------------------------------

_EXECUTOR_CASES = {
    "1node": (dict(alpha=0.1, batch_size=32), dict(n_nodes=1)),
    "2node": (dict(alpha=0.1, batch_size=16), dict(n_nodes=2)),
    "4node": (dict(alpha=0.1, batch_size=16), dict(n_nodes=4)),
    "pools": (dict(alpha=0.1, batch_size=16),
              dict(n_nodes=4, node_pools=["cpu", "cpu", "cpu", "gpu"],
                   straggler_rate=0.0)),
    "prefetch": (dict(alpha=0.1, batch_size=16),
                 dict(n_nodes=2, prefetch_depth=2)),
    "straggler": (dict(alpha=0.1, batch_size=16),
                  dict(n_nodes=3, straggler_rate=0.9,
                       straggler_slowdown=1000.0)),
    "reparse_straggler": (dict(alpha=0.2, batch_size=16),
                          dict(n_nodes=3, node_pools=["cpu", "gpu", "gpu"],
                               straggler_rate=0.9,
                               straggler_slowdown=1000.0)),
    "weighted": (dict(alpha=0.1, batch_size=16),
                 dict(n_nodes=2, node_budget_weights=[3.0, 1.0],
                      straggler_rate=0.0)),
    "speed": (dict(alpha=0.1, batch_size=16),
              dict(n_nodes=4, straggler_rate=0.0,
                   node_speed_factors=[1.0, 1.0, 1.0, 4.0])),
    "disk_cache": (dict(alpha=0.1, batch_size=16),
                   dict(n_nodes=4, node_pools=["cpu", "cpu", "cpu", "gpu"],
                        prefetch_depth=2, straggler_rate=0.0)),
}


@pytest.mark.parametrize("case", list(_EXECUTOR_CASES))
def test_executor_matches_reference(shared, case, tmp_path):
    jc, jtest, jr, tc, ttest, tr = shared
    ekw, xkw = _EXECUTOR_CASES[case]
    jx = JC.CampaignExecutor(JE.EngineConfig(**ekw),
                             JC.ExecutorConfig(**xkw), jr, jc)
    tx = TC.CampaignExecutor(TE.EngineConfig(**ekw),
                             TC.ExecutorConfig(**xkw), tr, tc, device="cpu")
    if case == "disk_cache":
        jstore = JB.DiskResultStore(tmp_path / "j")
        tstore = TB.DiskResultStore(tmp_path / "t")
        passes = []
        for _ in ("cold", "warm"):
            passes.append((jx.run(jtest, cache=jstore),
                           tx.run(ttest, cache=tstore)))
        (jcold, tcold), (jwarm, twarm) = passes
        assert tcold.cache_hits == 0 and twarm.cache_misses == 0
        assert twarm.cache_hits == tcold.cache_misses == len(tstore)
        _assert_numpy_records_on_disk(tmp_path / "t")
        # a restart over the same directory replays every batch
        restart = TC.CampaignExecutor(
            TE.EngineConfig(**ekw), TC.ExecutorConfig(**xkw), tr, tc,
            device="cpu").run(ttest, cache=TB.DiskResultStore(tmp_path / "t"))
        assert restart.cache_misses == 0
        _records_equal(restart.records, tcold.records)
    else:
        passes = [(jx.run(jtest), tx.run(ttest))]
    for jres, tres in passes:
        _results_equal(jres, tres)
    if case in ("straggler", "reparse_straggler"):
        assert passes[0][1].reissued > 0
    if case == "reparse_straggler":
        assert passes[0][1].reissued_reparse > 0
    tres = passes[-1][1]
    assert any(r.parser == TE.EngineConfig().expensive
               for r in tres.records.values())
    if case == "weighted":
        # skewed budgets route each node at its own alpha, so the record
        # set is not the single-node one; the faster node gets more
        a0, a1 = tres.node_alphas
        assert a0 > ekw["alpha"] > a1 >= 0.0
        return
    # and the port's N-node records equal its own single-node run
    single = TE.AdaParseEngine(TE.EngineConfig(**ekw), tr, tc,
                               device="cpu").run(ttest)
    _records_equal(tres.records, single)


# -- CampaignController ---------------------------------------------------

_RETUNE_CTL = dict(rounds=6, alpha_bounds=(0.05, 0.9), alpha_step=0.3,
                   quality_target=0.5, quality_ewma=1.0)


def _ctl_pair(ctl_kw, probe=None):
    """(JAX, port) ControllerConfigs with the same knobs."""
    return (JC.ControllerConfig(
        probe=JQ.QualityProbeConfig(**probe) if probe else None, **ctl_kw),
        TC.ControllerConfig(
            probe=TQ.QualityProbeConfig(**probe) if probe else None,
            **ctl_kw))


@pytest.mark.parametrize("case", ["skewed", "trace_replay",
                                  "pooled_disk_restart", "retune",
                                  "retune_replay_restart"])
def test_controller_matches_reference(shared, degrading, case, tmp_path):
    if case.startswith("retune"):
        jc, jtest, jr, tc, ttest, tr = degrading
        ekw = dict(alpha=0.05, batch_size=16)
        xkw = dict(n_nodes=2, straggler_rate=0.0)
        ctl_kw, probe = _RETUNE_CTL, dict(probe_rate=1.0, max_len=128)
    else:
        jc, jtest, jr, tc, ttest, tr = shared
        ekw = dict(alpha=0.1, batch_size=4 if case == "skewed" else 16)
        xkw = dict(n_nodes=4, straggler_rate=0.0,
                   node_speed_factors=[1.0, 1.0, 1.0, 4.0])
        ctl_kw, probe = dict(rounds=4 if case == "skewed" else 3), None
    if case == "pooled_disk_restart":
        ekw["batch_size"] = 16
        xkw = dict(n_nodes=4, node_pools=["cpu", "cpu", "cpu", "gpu"],
                   prefetch_depth=2, straggler_rate=0.0)
        ctl_kw = dict(rounds=3,
                      telemetry_trace=[[210.0, 180.0, 150.0]] * 3)

    def pair(ctl_kw, xkw=xkw, store=None, replay=None):
        """Both packages' controllers; ``replay``: the (JAX, port)
        results whose telemetry each side replays as its trace."""
        if replay is not None:
            jctl, _ = _ctl_pair(dict(ctl_kw,
                                     telemetry_trace=replay[0].telemetry),
                                probe)
            _, tctl = _ctl_pair(dict(ctl_kw,
                                     telemetry_trace=replay[1].telemetry),
                                probe)
        else:
            jctl, tctl = _ctl_pair(ctl_kw, probe)
        js = ts = None
        if store is not None:
            js = JB.DiskResultStore(tmp_path / f"j{store}")
            ts = TB.DiskResultStore(tmp_path / f"t{store}")
        j = JC.CampaignController(JE.EngineConfig(**ekw),
                                  JC.ExecutorConfig(**xkw), jctl, jr,
                                  jc).run(jtest, cache=js)
        t = TC.CampaignController(TE.EngineConfig(**ekw),
                                  TC.ExecutorConfig(**xkw), tctl, tr, tc,
                                  device="cpu").run(ttest, cache=ts)
        _controller_equal(j, t)
        return j, t

    disk = case in ("pooled_disk_restart", "retune_replay_restart")
    jfirst, first = pair(ctl_kw, store="0" if disk else None)
    if case.startswith("retune"):
        traj = first.alpha_trajectory
        assert all(0.05 <= a <= 0.9 for a in traj) and traj[-1] > 0.05
        assert any(t.decision == "raise" for t in first.telemetry)
    else:
        _records_equal(first.records, TE.AdaParseEngine(
            TE.EngineConfig(**ekw), tr, tc, device="cpu").run(ttest))
    if case == "skewed":
        assert first.weight_history[-1][3] < 0.15
    elif case == "trace_replay":
        slow = dict(xkw, node_speed_factors=[1.0, 9.0, 1.0, 1.0])
        _, again = pair(ctl_kw, slow, replay=(jfirst, first))
        assert again.weight_history == first.weight_history
        _records_equal(again.records, first.records)
    elif disk:
        # a fresh store instance and controller over the same directory
        # ("process restart"), replaying the recorded trace
        _, again = pair(ctl_kw, store="0",
                        replay=((jfirst, first)
                                if case == "retune_replay_restart"
                                else None))
        assert again.cache_misses == 0
        assert again.cache_hits == first.cache_misses
        assert again.weight_history == first.weight_history
        assert again.alpha_trajectory == first.alpha_trajectory
        _records_equal(again.records, first.records)


# -- the llm variant --------------------------------------------------------


def test_llm_executor_matches_reference(shared):
    """``router-tiny`` from the JAX init on both sides, a 2-node
    executor: records equal but for documents within 1e-5 of tau."""
    jc, jtest, jr_ft, tc, ttest, tr_ft = shared
    jcfg = j_get_config("adaparse-router").reduced().model
    tcfg = get_config("adaparse-router").reduced().model
    raw = jax.tree_util.tree_map(np.asarray,
                                 unwrap(jenc.init_encoder(jcfg, 0)))
    enc = encoder_from_jax_params(raw, tcfg, "cpu")
    toks = torch.randint(2, 8000, (16, tcfg.max_len),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        pred = enc.predict_accuracies(toks)
    exp = int((pred[:, 1:] > pred[:, :1]).sum(0).argmax()) + 1
    jr = JRouter("llm", jr_ft.cls1, None, enc_cfg=jcfg, enc_params=raw,
                 expensive_idx=exp)
    tr = TRouter("llm", tr_ft.cls1, None, enc_cfg=tcfg, encoder=enc,
                 expensive_idx=exp)
    ekw, bs = dict(alpha=0.1, batch_size=16, seed=3), 16
    xkw = dict(n_nodes=2, straggler_rate=0.0)
    jres = JC.CampaignExecutor(JE.EngineConfig(**ekw),
                               JC.ExecutorConfig(**xkw), jr, jc).run(jtest)
    tres = TC.CampaignExecutor(TE.EngineConfig(**ekw),
                               TC.ExecutorConfig(**xkw), tr, tc,
                               device="cpu").run(ttest)
    assert tres.node_alphas == jres.node_alphas
    assert any(r.parser == TE.EngineConfig().expensive
               for r in tres.records.values())
    step = make_route_step(0.1, expensive_idx=exp)
    eng = TE.AdaParseEngine(TE.EngineConfig(**ekw), tr, tc, device="cpu")
    for b in range(-(-len(ttest) // bs)):
        docs = ttest[b * bs:(b + 1) * bs]
        flipped = [i for i, d in enumerate(docs)
                   if tres.records[d.doc_id].parser
                   != jres.records[d.doc_id].parser]
        if not flipped:
            _records_equal({d.doc_id: tres.records[d.doc_id] for d in docs},
                           {d.doc_id: jres.records[d.doc_id] for d in docs})
            continue
        prep = eng.prepare_batch(docs, batch_key=b)
        imp = step(tr.encoder, prep.route_host["tokens"],
                   prep.route_host["mask"],
                   torch.from_numpy(prep.route_host["valid_logit"])
                   )["improvement"].numpy()
        tau = max(float(np.sort(imp)[::-1][capacity_floor(0.1, len(imp))
                                          - 1]), POSITIVE_TAU)
        assert all(abs(imp[i] - tau) <= 1e-5 for i in flipped), flipped
    # the port's 2-node records equal its own single-node run exactly
    _records_equal(tres.records, eng.run(ttest))


# -- serve, the refused runtimes and flags, obs_report ---------------------


def _serve(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        res = main(argv)
    return res, out.getvalue().splitlines()


def test_serve_campaign_flags_match_reference(tmp_path):
    """The 12a flags together: the reference's metric dict and executor
    report lines, a trace the port's obs_report summarises as the
    reference's summarises its own, and the same metric names."""
    def argv(who):
        return ["--docs", "96", "--batch-size", "16", "--alpha", "0.1",
                "--pools", "cpu:2,gpu:1", "--prefetch-depth", "2",
                "--adaptive-rounds", "2", "--quality-probe-rate", "0.5",
                "--alpha-bounds", "0.02:0.3", "--alpha-step", "0.05",
                "--quality-target", "0.45", "--warm-cache",
                "--cache-dir", str(tmp_path / f"store_{who}"),
                "--cache-max-bytes", str(1 << 30),
                "--trace-dir", str(tmp_path / f"trace_{who}"),
                "--metrics-out", str(tmp_path / f"metrics_{who}.txt")]

    jres, jout = _serve(JS.main, argv("j"))
    tres, tout = _serve(TS.main, argv("t") + ["--device", "cpu"])
    assert tres == jres

    def report(out):
        return [ln for ln in out if ln.startswith(("[serve] executor[",
                                                   "[serve]   "))]

    assert len(report(tout)) == 6
    assert report(tout) == report(jout)
    trep = TOR.main(["--trace-dir", str(tmp_path / "trace_t")])
    jrep = JOR.summarize(*jobs.load_spans(tmp_path / "trace_j"))
    assert trep["n_spans"] == jrep["n_spans"] > 0
    assert trep["complete"] == jrep["complete"]
    assert trep["complete_cached"] == jrep["complete_cached"]
    assert trep["reissue_causes"] == jrep["reissue_causes"]
    for stage in ("prepare", "route", "reparse", "probe", "complete"):
        assert trep["stages"][stage]["n"] == jrep["stages"][stage]["n"]
        # the simulated stage durations, not the host's clock
        assert trep["stages"][stage]["total_s"] == pytest.approx(
            jrep["stages"][stage]["total_s"], rel=1e-9)
    assert {n: w["spans"] for n, w in trep["workers"].items()} == \
        {n: w["spans"] for n, w in jrep["workers"].items()}
    assert "completes:" in TOR.render(trep)

    def names(path):
        return {ln.split("{")[0].split(" ")[0]
                for ln in Path(path).read_text().splitlines()
                if ln and not ln.startswith("#")}

    assert names(tmp_path / "metrics_t.txt") == \
        names(tmp_path / "metrics_j.txt")


@pytest.mark.parametrize("argv", [
    ["--pools", "tpu:4"], ["--pools", "cpu:x"], ["--pools", "cpu:0"],
    ["--nodes", "0"], ["--cache-max-bytes", "10"],
    ["--quality-probe-rate", "0.5"], ["--alpha-bounds", "0.02:0.2"],
    ["--adaptive-rounds", "2", "--quality-probe-rate", "0.5",
     "--alpha-bounds", "0.3:0.1"],
    ["--adaptive-rounds", "2", "--quality-probe-rate", "0.5",
     "--alpha-bounds", "0.1:0.3"],
    ["--adaptive-rounds", "-1"], ["--alpha-step", "0"],
])
def test_serve_campaign_flag_errors_match_reference(argv, capsys):
    """A malformed campaign flag exits 2 with the reference's message,
    never a traceback."""
    errs = []
    for main, extra in ((JS.main, []), (TS.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(["--docs", "30"] + argv + extra)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[1] == errs[0]
    assert "error:" in errs[0]


def test_obs_report_summarizes_stages_workers_and_causes(tmp_path):
    """The reference's own obs_report case (tests/test_obs.py), on the
    port's copy."""
    spans = [
        tobs.Span("prepare", "7", 0, 4242, 100.0, 0.5),
        tobs.Span("complete", "7", 1, 4242, 101.0, 0.25, cached=True),
        tobs.Span("dedup", "7", 2, 4242, 101.5, 0.0),
        tobs.Span("reissue", "8", 0, 4242, 102.0, 0.0,
                  detail="crash worker 2, prepare stage"),
        tobs.Span("reissue", "9", 1, 4242, 102.5, 0.0,
                  detail="wedged worker 0, complete stage"),
    ]
    tobs.TraceWriter(tmp_path).write(spans)
    rep = TOR.main(["--trace-dir", str(tmp_path)])
    assert rep["n_spans"] == 5
    assert rep["stages"]["prepare"]["p50_s"] == pytest.approx(0.5)
    assert rep["reissue_causes"] == {"crash": 1, "wedged": 1}
    assert rep["complete"] == 1 and rep["complete_cached"] == 1
    assert rep["dedup"] == 1
    assert 0 in rep["workers"] and rep["workers"][0]["busy_s"] > 0
    jspans, jmeta = jobs.load_spans(tmp_path)
    assert rep == JOR.summarize(jspans, jmeta)


@pytest.mark.parametrize("runtime,item", [("process", "12b"),
                                          ("fabric", "12c")])
def test_real_worker_runtimes_raise_instead_of_running_locally(
        shared, runtime, item):
    """The real worker runtimes (ROADMAP ``item``, ported) never fall
    back to the in-process fleet: ``make_worker_pool`` builds their own
    pool class, and what they do not support — the simulated speed
    factors of the local fleet — raises before any worker spawns
    instead of being ignored, as in the JAX package. Their campaigns
    run in ``tests/test_torch_workers.py`` and
    ``tests/test_torch_fabric.py``; their autotune store (item 11) in
    ``tests/test_torch_autotune.py``."""
    from repro_torch.core.fabric import FabricWorkerPool

    jc, jtest, jr, tc, ttest, tr = shared
    cls = {"process": TW.ProcessWorkerPool,
           "fabric": FabricWorkerPool}[runtime]
    assert not issubclass(cls, TW.LocalWorkerPool), item
    xcfg = TC.ExecutorConfig(n_nodes=2, runtime=runtime,
                             node_speed_factors=[1.0, 4.0])
    ex = TC.CampaignExecutor(TE.EngineConfig(batch_size=16), xcfg, tr, tc,
                             device="cpu")
    with pytest.raises(ValueError, match="simulation-only"):
        ex.run(ttest)
    with pytest.raises(ValueError, match="simulation-only"):
        TW.make_worker_pool(TE.EngineConfig(), ex.xcfg, tr, tc, 2, [0, 1],
                            [0, 1], None, device="cpu")


def test_campaign_defaults_to_cuda(shared):
    """No device given means cuda: without a card the executor and the
    controller raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    jc, jtest, jr, tc, ttest, tr = shared
    with pytest.raises(RuntimeError, match="cuda"):
        TC.CampaignExecutor(TE.EngineConfig(), TC.ExecutorConfig(), tr, tc)
    with pytest.raises(RuntimeError, match="cuda"):
        TC.CampaignController(TE.EngineConfig(), TC.ExecutorConfig(),
                              TC.ControllerConfig(), tr, tc)


def test_executor_config_round_trips_every_reference_field():
    jf = {f.name: f.default for f in dataclasses.fields(JC.ExecutorConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TC.ExecutorConfig)}
    assert tf == jf
    for cls in ("ControllerConfig", "RoundTelemetry", "CampaignConfig"):
        assert [f.name for f in dataclasses.fields(getattr(TC, cls))] == \
            [f.name for f in dataclasses.fields(getattr(JC, cls))]
    cfg = JC.CampaignConfig(n_nodes=16, n_docs=40_000)
    for parser in ("pymupdf", "nougat", "adaparse_ft"):
        j = JC.simulate_parser_campaign(parser, cfg)
        t = TC.simulate_parser_campaign(
            parser, TC.CampaignConfig(**dataclasses.asdict(cfg)))
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert TC.scaling_curve("pymupdf", [1, 8], TC.CampaignConfig()) == \
        JC.scaling_curve("pymupdf", [1, 8], JC.CampaignConfig())
    hist = [[0.25] * 4, [0.3, 0.3, 0.2, 0.2], [0.31, 0.29, 0.2, 0.2]]
    assert TC.autotune_convergence_rounds(hist) == \
        JC.autotune_convergence_rounds(hist)
    assert TC.weighted_shard_batches(100, [3.0, 1.0, 0.5]) == \
        JC.weighted_shard_batches(100, [3.0, 1.0, 0.5])


def test_launch_counts_are_exact_under_threads():
    """Prefetch threads launch kernels at once (ctypes drops the GIL), so
    a wrapper's count must not lose a bump."""
    k = cuda_lib.CudaKernel("probe", "adaparse_probe", [])
    k._fn = lambda *a: 0
    n, per = 8, 5000

    def bump():
        for _ in range(per):
            k()

    threads = [threading.Thread(target=bump) for _ in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive(), "a launching thread did not finish"
    assert k.launches == n * per
