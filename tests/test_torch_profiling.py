"""The port's phase timer and profiler trace (JAX-free; the timer as tests/test_utils.py holds JAX's)."""

import json
import os

import torch

from hybridode_torch.utils import PhaseTimer, trace_to


def test_phase_timer_accumulates():
    t = PhaseTimer()
    for name in ("a", "a", "b"):
        with t.phase(name):
            pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    assert t.report().splitlines()[0].startswith("a: total=") and "n=2" in t.report()


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with trace_to(str(tmp_path)):
        torch.tanh(torch.ones(4, 4)).sum()
    (name,) = os.listdir(tmp_path)
    assert name.endswith(".pt.trace.json")
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::tanh" for e in events)
