"""The port's scenario lab (``repro_torch.core.scenarios``) against the
JAX package's (``repro.core.scenarios``), on the CPU.

The registry is the reference's, spec for spec. Each fast scenario (the
local simulated fleet) runs in both packages: the port's fleet records
equal the reference's byte for byte, and so do the scenario counters
(re-issues, duplicates, cache hits and misses, simulated wall and
goodput, the α trajectory of ``bimodal_retune``). One process scenario
(``shm_crash_reissue``) and the elastic fabric scenario run on real
worker processes, their records held against the JAX package's
single-node run; the elastic run's joiner must serve documents. ``serve
--scenario`` and ``serve --status-interval`` print what
``repro.launch.serve`` prints with the same flags.
"""
import dataclasses
import io
import re
from contextlib import redirect_stdout

import numpy as np
import pytest

from repro.core import scenarios as JSC
from repro.core.engine import AdaParseEngine as JEngine
from repro.core.engine import EngineConfig as JEngineConfig
from repro.launch import serve as JS
from repro_torch.core import scenarios as TSC
from repro_torch.core.engine import ParseRecord
from repro_torch.launch import serve as TS
from torch_spawn_env import one_thread_workers  # noqa: F401

CPU = "cpu"
REQUIRED = {"crash_storm", "wedged_straggler_flap", "bursty_arrivals",
            "bimodal_retune", "cold_warm_shared_store", "slowdown_skew",
            "shm_crash_reissue", "elastic_join_leave"}


def _same_records(a: dict, b: dict):
    assert set(a) == set(b)
    for i in a:
        assert a[i].parser == b[i].parser
        assert a[i].cost_s == b[i].cost_s
        assert len(a[i].pages) == len(b[i].pages)
        for pa, pb in zip(a[i].pages, b[i].pages):
            assert pa.dtype == pb.dtype
            np.testing.assert_array_equal(pa, pb)


def _plain(obj):
    """A spec field as plain data (the two packages' FaultInjection and
    FabricElastic are different classes with the same fields)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj


def _run_capturing(module, monkeypatch, spec, **kw):
    """(result, fleet records) of ``module.run_scenario(spec)``: the
    records the runner held against its single-node reference."""
    seen = []
    check = module._assert_records_match

    def capture(name, reference, got):
        check(name, reference, got)
        seen.append(got)

    monkeypatch.setattr(module, "_assert_records_match", capture)
    res = module.run_scenario(spec, **kw)
    monkeypatch.setattr(module, "_assert_records_match", check)
    return res, seen[0]


def test_registry_ships_the_reference_matrix():
    """The eight scenarios of the JAX package, each spec field for field
    the reference's; the fast subset avoids process spawns."""
    assert set(TSC.SCENARIOS) == set(JSC.SCENARIOS) >= REQUIRED
    assert list(TSC.SCENARIOS) == list(JSC.SCENARIOS)
    assert TSC.FAST_SCENARIOS == JSC.FAST_SCENARIOS
    for name, spec in TSC.SCENARIOS.items():
        assert spec.name == name and spec.description
        assert isinstance(spec, TSC.ScenarioSpec)
        assert _plain(spec) == _plain(JSC.SCENARIOS[name])
    elastic = TSC.SCENARIOS["elastic_join_leave"]
    assert elastic.runtime == "fabric" and elastic.fault is not None
    assert elastic.fabric.join_after and elastic.fabric.reject >= 1
    assert all(TSC.SCENARIOS[n].runtime == "local"
               for n in TSC.FAST_SCENARIOS)
    assert [f.name for f in dataclasses.fields(TSC.ScenarioResult)] == [
        f.name for f in dataclasses.fields(JSC.ScenarioResult)] + [
        "joiner_docs"]


def test_get_scenario_unknown_name_is_actionable():
    with pytest.raises(KeyError) as t:
        TSC.get_scenario("no_such_scenario")
    with pytest.raises(KeyError) as j:
        JSC.get_scenario("no_such_scenario")
    assert "crash_storm" in t.value.args[0]
    assert t.value.args == j.value.args


@pytest.mark.parametrize("name", JSC.FAST_SCENARIOS)
def test_fast_scenarios_match_the_reference(name, monkeypatch):
    """Each fast scenario reproduces its single-node reference inside
    ``run_scenario`` in both packages, and the port's fleet records and
    counters equal the JAX package's: the same re-issues (slowdown_skew
    trips the deadline re-issue), simulated clocks, and α trajectory
    (bimodal_retune's retuner moves α)."""
    spec = TSC.SCENARIOS[name]
    t, trecs = _run_capturing(TSC, monkeypatch, spec, device=CPU)
    j, jrecs = _run_capturing(JSC, monkeypatch, JSC.SCENARIOS[name])
    _same_records(trecs, jrecs)
    tm = t.metrics()
    assert tm.pop("joiner_docs") is None
    assert tm == j.metrics()
    assert t.records_match and t.n_docs > 0 and t.goodput_docs_per_s > 0
    if name == "slowdown_skew":
        assert t.reissued >= 1
    if name == "bimodal_retune":
        assert t.rounds == spec.rounds == len(t.alpha_trajectory)
        assert len(set(t.alpha_trajectory)) > 1


def test_record_mismatch_raises_scenario_mismatch():
    """The determinism assert fires on any divergence: a missing doc,
    a different parser, or different page payloads."""
    def rec(i, parser="pymupdf", fill=0):
        return ParseRecord(i, parser, [np.full(8, fill, np.int32)], 1.0)

    ref = {0: rec(0), 1: rec(1)}
    TSC._assert_records_match("t", ref, {0: rec(0), 1: rec(1)})
    with pytest.raises(TSC.ScenarioMismatch, match="doc ids"):
        TSC._assert_records_match("t", ref, {0: rec(0)})
    with pytest.raises(TSC.ScenarioMismatch, match="diverged"):
        TSC._assert_records_match("t", ref,
                                  {0: rec(0), 1: rec(1, parser="nougat")})
    with pytest.raises(TSC.ScenarioMismatch, match="diverged"):
        TSC._assert_records_match("t", ref, {0: rec(0), 1: rec(1, fill=7)})


def test_spec_overrides_stay_declarative():
    """Specs are frozen dataclasses: a tweaked copy runs without
    touching the registry (the serve.py --scenario contract)."""
    spec = dataclasses.replace(TSC.SCENARIOS["bursty_arrivals"], rounds=1,
                               arrival_skew=((4.0, 1.0, 1.0, 0.5),))
    res = TSC.run_scenario(spec, device=CPU)
    assert res.records_match and res.rounds == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        TSC.SCENARIOS["bursty_arrivals"].rounds = 5


def _jax_single_node(corpus, ft_router, spec) -> dict:
    ccfg, docs = corpus
    assert (spec.n_docs, spec.corpus_seed) == (len(docs), ccfg.seed)
    return JEngine(JEngineConfig(alpha=spec.alpha,
                                 batch_size=spec.batch_size),
                   ft_router, ccfg).run(docs[spec.n_docs // 2:])


def test_shm_crash_reissue_on_worker_processes(corpus, ft_router,
                                               monkeypatch):
    """Four spawned CPU workers over the shm transport, one crashing and
    one flapping: the records equal the JAX package's single-node run,
    and the crash re-issues."""
    spec = TSC.SCENARIOS["shm_crash_reissue"]
    res, recs = _run_capturing(TSC, monkeypatch, spec, device=CPU)
    _same_records(recs, _jax_single_node(corpus, ft_router, spec))
    assert res.reissued >= 1 and res.joiner_docs is None


def test_elastic_join_leave_joiner_serves(corpus, ft_router, monkeypatch):
    """The elastic fabric scenario on CPU workers: one crash, one rejected
    dialer, and a joiner that serves documents inside the campaign; the
    records equal the JAX package's single-node run."""
    spec = TSC.SCENARIOS["elastic_join_leave"]
    res, recs = _run_capturing(TSC, monkeypatch, spec, device=CPU)
    _same_records(recs, _jax_single_node(corpus, ft_router, spec))
    assert res.reissued >= 1
    assert res.joiner_docs > 0


def test_join_not_exercised_is_a_failure():
    """A scheduled join whose joiner served nothing fails the scenario
    instead of passing without its join."""
    spec = TSC.SCENARIOS["elastic_join_leave"]

    class Stats:
        def __init__(self, n):
            self.n_docs = n

    class Res:
        node_stats = [Stats(40), Stats(35), Stats(0)]

    assert TSC._joiner_docs(spec, Res) == 0
    assert TSC._joiner_docs(TSC.SCENARIOS["crash_storm"], Res) is None
    Res.node_stats[2] = Stats(8)
    assert TSC._joiner_docs(spec, Res) == 8
    assert issubclass(TSC.JoinNotExercised, AssertionError)


def _serve_out(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = main(argv)
    return res, buf.getvalue().splitlines()


def test_serve_scenario_list_and_run_match_the_reference():
    """``serve --scenario list`` prints the reference's registry, and
    ``serve --scenario bursty_arrivals`` its report lines and counters
    (on the CPU the port's simulated clocks are the reference's)."""
    t, tl = _serve_out(TS.main, ["--scenario", "list", "--device", CPU])
    j, jl = _serve_out(JS.main, ["--scenario", "list"])
    assert t is None and j is None and tl == jl and len(tl) == 8
    t, tl = _serve_out(TS.main, ["--scenario", "bursty_arrivals",
                                 "--device", CPU])
    j, jl = _serve_out(JS.main, ["--scenario", "bursty_arrivals"])
    assert t.pop("joiner_docs") is None
    assert t == j
    assert [ln for ln in tl if ln.startswith("[serve]")] == \
        [ln for ln in jl if ln.startswith("[serve]")]


_MEASURED = re.compile(r"(wall|docs/s|busy)=[0-9.]+")


def test_serve_status_interval_prints_status_lines(capsys):
    """``serve --workers 2 --status-interval S`` prints the live status
    line to stderr while the fleet drains, and otherwise the reference's
    report line and metric dict (measured fields masked)."""
    argv = ["--docs", "90", "--batch-size", "8", "--workers", "2",
            "--transport", "pickle", "--status-interval", "0.01"]
    outs = []
    for main, extra in ((TS.main, ["--device", CPU]), (JS.main, [])):
        res, lines = _serve_out(main, argv + extra)
        status = [ln for ln in capsys.readouterr().err.splitlines()
                  if ln.startswith("[status] ")]
        outs.append((res, [_MEASURED.sub(r"\1=*", ln) for ln in lines
                           if ln.startswith("[serve] executor[")], status))
    (t, tl, ts), (j, jl, _) = outs
    assert tl == jl and "runtime=process" in tl[0]
    t.pop("throughput_docs_per_node_s")
    j.pop("throughput_docs_per_node_s")
    assert t == j
    assert ts, "no status line"
    assert all(re.match(r"\[status\] \d+/\d+ batches ", ln) for ln in ts)
