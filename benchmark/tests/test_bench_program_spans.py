"""The readers of the program's spans and counters: each reads its value from spans and a record built by hand,
and finds nothing where the record or the program has nothing; the spans put nothing into a profiler's trace."""

import copy
import os
import types

import numpy as np
import pytest
import torch

from benchmark.harness import spans, spec as spec_mod

US = 1_000  # ns a microsecond: the harness's trace holds microseconds, spans nanoseconds


def _span(name, t0_us, t1_us, id, parent=None, root=None, **fields):
    return types.SimpleNamespace(name=name, t0=t0_us * US, t1=t1_us * US, id=id, parent=parent,
                                 root=id if root is None else root, fields=fields)


@pytest.fixture
def given(monkeypatch):
    """Make `spans.recorded()` the list handed to it."""

    def put(found):
        monkeypatch.setattr(spans, "recorded", lambda: list(found))

    return put


def test_live_trial_share_reads_the_last_windows(given):
    read = spec_mod.reader("dopri5_live_trial_share.train")
    found = [_span("restart", 0, 10, 1), _span("window", 1, 2, 2, 1, 1, step_trials_live=900, step_trials_run=1000),
             _span("restart", 20, 30, 3),  # another restart, whose windows are the measured ones
             _span("window", 21, 22, 4, 3, 3, step_trials_live=100, step_trials_run=400, val_trials_live=7,
                   val_trials_run=70),
             _span("window", 23, 24, 5, 3, 3, step_trials_live=300, step_trials_run=400),
             _span("evaluate", 25, 26, 6)]
    given(found)
    assert read({"validations": 2}) == pytest.approx(50.0)
    assert read({"validations": 3}) == pytest.approx(100.0 * 1300 / 1800)
    assert read({"validations": 4}) is None  # more windows measured than recorded
    assert read({}) is None
    given([_span("window", 1, 2, 1, window=1)])  # an uncaptured run counts nothing
    assert read({"validations": 1}) is None


def test_graph_warmup_s_sums_the_warmups_of_the_last_restart(given):
    read = spec_mod.reader("graph_warmup_s")
    found = [_span("warmup", 1, 3, 2, 1, 1, graph="step"), _span("restart", 0, 10, 1),
             _span("warmup", 21, 21 + 2_000_000, 5, 4, 3, graph="step"),
             _span("warmup", 2_100_000, 2_600_000, 6, 4, 3, graph="validation"),
             _span("window", 20, 3_000_000, 4, 3, 3), _span("restart", 20, 3_000_001, 3),
             _span("window", 3_000_050, 3_000_060, 7, 3, 3)]
    given(found)
    assert read({"iterations": 10}) == pytest.approx(2.5)
    assert read({}) is None
    given(found[:2] + [_span("restart", 20, 41, 3)])  # the last restart captured nothing (the CPU)
    assert read({"iterations": 10}) is None


def _forecast_run():
    """Four requests of 190 us before the trace, then two traced ones from 1,000 us. Each request: encode, decode,
    score and bootstrap."""
    found, rid = [], 1
    for start, decode in ((0, 50), (200, 60), (400, 70), (600, 80), (1000, 100), (1200, 150)):
        root = rid
        found += [_span("encode", start + 1, start + 5, rid + 1, root, root),
                  _span("decode", start + 5, start + 5 + decode, rid + 2, root, root),
                  _span("score", start + 5 + decode, start + 180, rid + 3, root, root),
                  _span("bootstrap", start + 180, start + 189, rid + 4, root, root),
                  _span("evaluate", start, start + 190, root)]
        rid += 5
    return found


def test_forecast_decode_share_reads_the_windows_requests(given):
    read = spec_mod.reader("forecast_decode_share")
    given(_forecast_run())
    trace = {"kernels": [("k", 1010.0, 1020.0)], "host": [("aten::randn", 1000.0, 1001.0)], "requests": 2}
    assert read({"requests": 3, "trace": trace}) == pytest.approx(100.0 * (60 + 70 + 80) / (3 * 190))
    assert read({"requests": 4, "trace": trace}) == pytest.approx(100.0 * (50 + 60 + 70 + 80) / (4 * 190))
    assert read({"requests": 5, "trace": trace}) is None
    assert read({"requests": 3, "trace": dict(trace, kernels=[], host=[])}) is None  # a trace of nothing
    assert read({"requests": 3}) is None


def test_idle_under_decode_share_puts_each_gap_down_to_the_decode_that_covers_it(given):
    read = spec_mod.reader("forecast_idle_under_decode_share")
    given(_forecast_run())
    # The traced requests' decodes: 1,005-1,105 and 1,205-1,355 us. Device operations (two overlap) leave gaps of
    # 1,010-1,050 (inside a decode, 40), 1,060-1,150 (45 inside, 45 outside), 1,160-1,300 (95 inside, 45 outside).
    kernels = [("a", 1000.0, 1010.0), ("b", 1005.0, 1008.0), ("c", 1050.0, 1060.0), ("d", 1150.0, 1160.0),
               ("e", 1300.0, 1400.0)]
    trace = {"kernels": kernels, "host": [("aten::randn", 999.0, 1000.0)], "requests": 2}
    assert read({"requests": 3, "trace": trace}) == pytest.approx(100.0 * (40 + 45 + 95) / (40 + 90 + 140))
    assert read({"requests": 3, "trace": dict(trace, kernels=kernels[:1])}) is None  # no idle gap
    assert read({"requests": 9, "trace": trace}) is None


def test_interval_helpers():
    assert spans.union([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
    assert spans.gaps([(0, 2), (1, 3), (5, 6), (8, 9)]) == [(3, 5), (6, 8)]
    assert spans.overlap([(0, 4), (6, 10)], [[3, 7], [9, 20]]) == 1 + 1 + 1


@pytest.mark.parametrize("metric", ["dopri5_live_trial_share.train", "graph_warmup_s", "forecast_decode_share",
                                    "forecast_idle_under_decode_share"])
def test_a_reader_finds_nothing_in_an_empty_record_beside_recorded_spans(metric):
    from hybridode_torch.utils.logging import RECORDER

    with RECORDER.span("restart", None):
        with RECORDER.span("window", window=1, step_trials_live=1, step_trials_run=2):
            with RECORDER.span("warmup", graph="step"):
                pass
    with RECORDER.span("evaluate", None):
        with RECORDER.span("decode"):
            pass
    assert spec_mod.reader(metric)({"spec": None, "device_kind": "NVIDIA H100 80GB HBM3"}) is None


def test_the_spans_put_nothing_into_a_profilers_trace(monkeypatch):
    """One request of the forecast cell under torch.profiler, after one to warm it up: no event is named after a
    span, and the trace holds the events of the same request with every span of `eval/metrics` made a no-op."""
    from hybridode_torch.cli.common import build_sim_model
    from hybridode_torch.config import DataConfig
    from hybridode_torch.data import SyntheticCohort
    from hybridode_torch.eval import metrics
    from hybridode_torch.inference import init_vi

    cohort = SyntheticCohort.load(os.path.join(spec_mod.ROOT, "data_s123", "datafile_dose_exp.pkl"), device="cpu")
    view = copy.copy(cohort)
    view.data_test = {k: v[:, :4] for k, v in cohort.data_test.items()}
    view.test_size = 4
    model = build_sim_model("hybrid", DataConfig(), mc_size=5)
    params = init_vi(torch.Generator().manual_seed(0), model, device="cpu")

    def call(fn):
        np.random.seed(0)
        return fn(params, model, view, 4, 5, mc_itr=3, generator=torch.Generator().manual_seed(1), verbose=False,
                  device="cpu")

    def traced(fn):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = call(fn)
        return out, sorted(e.name() for e in prof.profiler.kineto_results.events())

    call(metrics.evaluate)
    out, names = traced(metrics.evaluate)
    assert not {"evaluate", "encode", "decode", "score", "bootstrap"} & set(names)
    assert not [n for n in names if "annotation" in n.lower()]

    class NoSpan:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(metrics, "span", NoSpan)
    plain_out, plain_names = traced(metrics.evaluate.__wrapped__)
    assert out == plain_out and names == plain_names
