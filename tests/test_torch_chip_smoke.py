"""`chip_smoke.py`'s trace helper leaves no profiler events behind (JAX-free; runs on the CPU).

A torch.profiler trace's events hold one another in reference cycles, so a
trace keeps ~10 objects an ATen call alive until Python's next full
collection (6.7 million after one training step on the H100,
`flow_step_study.py`). `_traced` collects them before it returns.
"""

import gc

import torch

import chip_smoke


def test_traced_releases_the_trace():
    def work():
        x = torch.ones(50, 6)
        for _ in range(5000):
            x = torch.tanh(x) * 1.0001
        return x

    chip_smoke._traced(lambda: torch.ones(1), activities=("CPU",))  # the profiler's one-time imports and state
    gc.collect()
    before = len(gc.get_objects())
    out, kernels, launches = chip_smoke._traced(work, activities=("CPU",))
    assert out.shape == (50, 6) and kernels == [] and launches == 0  # no device in a CPU trace
    assert len(gc.get_objects()) - before < 5_000  # a bare trace leaves ~330,000 objects for these 10,000 ops
