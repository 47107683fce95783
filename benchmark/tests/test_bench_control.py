"""The control: the reference in the program's place in the precision below the configuration's float32 (float32
with TF32 matrix products) is not correct by the cells' limits. TF32 exists only on the card."""

import pytest
import torch

from benchmark.generators import train
from benchmark.harness import compare, env, spec as spec_mod
from benchmark.harness.spec import ROOT
from benchmark.tests import small


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sim_hybrid.train", "real_hybrid.train"])
def test_tf32_reference_fails_a_training_cells_limits(workload):
    if not torch.cuda.is_available():
        pytest.skip("TF32 matrix products need an NVIDIA GPU")
    work = env.prepare(ROOT)
    spec = spec_mod.load(workload)
    small.adjust(spec)
    device = torch.device("cuda", 0)
    restart = train.Restart(spec, 11, device, ROOT, work)
    _, inputs, w0 = restart.start(11)
    restart.close()
    want = train.reference(spec.config, spec.mix, inputs, w0, ROOT, device)
    with compare.tf32():
        low = train.reference(spec.config, spec.mix, inputs, w0, ROOT, device, dtype=torch.float32)
    gaps = train.gaps(train.as_program(low), want, w0)
    assert any(gaps[k] > v["limit"] for k, v in spec.limits.items()), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sim_hybrid.forecast_dopri5"])
def test_tf32_reference_fails_a_forecast_cells_limit(workload):
    if not torch.cuda.is_available():
        pytest.skip("TF32 matrix products need an NVIDIA GPU")
    from benchmark.generators import forecast
    from benchmark.harness import weights
    from benchmark.reference import cohort

    spec = spec_mod.load(workload)
    small.adjust(spec)
    cfg, mix = spec.config, spec.mix
    device = torch.device("cuda", 0)
    test = cohort.load(cfg, ROOT)["test"]
    w0 = weights.make(cfg, 11, device)
    requests = forecast.Requests(11, cfg["cohort"]["test"] // mix["patients_per_request"])
    worst = 0.0
    for _ in range(2):
        req = requests.next()
        want, _ = forecast.reference(cfg, mix, req, w0, test, device)
        with compare.tf32():
            low, _ = forecast.reference(cfg, mix, req, w0, test, device, dtype=torch.float32)
        worst = max(worst, forecast.score_gap([low[k] for k in forecast.SCORES], want))
    assert worst > spec.limits["scores"]["limit"], worst
