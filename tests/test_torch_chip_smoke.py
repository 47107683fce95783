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


def test_cohort_check_of_phase_8_fails_loudly_on_a_mismatch():
    """`cohort_faults` holds a generated cohort file against data_s123: silent on the file itself, loud on one
    flipped mask, on latents moved by 1e-4 and on a missing array."""
    import copy
    import os

    from hybridode_torch.utils.pickling import load_pickle

    want = load_pickle(os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl"))["state"]
    assert chip_smoke.cohort_faults(want, want) == []

    flipped = copy.deepcopy(want)
    flipped["masks"][3, 7, 2] = 1.0 - flipped["masks"][3, 7, 2]
    assert chip_smoke.cohort_faults(flipped, want) == ["masks is not byte-equal to the committed file's"]

    moved = copy.deepcopy(want)
    moved["latents"] = moved["latents"] + 1e-4
    (fault,) = chip_smoke.cohort_faults(moved, want)
    assert fault.startswith("latents: ") and "beyond rtol=1e-05 atol=1e-06" in fault

    missing = {k: v for k, v in want.items() if k != "dose_time"}
    assert chip_smoke.cohort_faults(missing, want) == ["dose_time is missing"]
