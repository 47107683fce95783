"""The real track on the GPU against the same code on the CPU.

The cases skip without a GPU. This file imports no JAX, so that the GPU
machine, which has none, runs it:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_real.py`.

Full width of data_real/ (obs 28, 1 dose channel, 11 statics, latent 20,
explicit Adams over the 73 hourly intervals), 16 patients, weights from a
seed. The hybrid decodes with two steps an hour (`ode_step_div=2`): at the
CLI's one step a randomly initialised hybrid solve is unstable, and float32
on one CPU is already more than 1e-2 from float64 on the loss, at two steps
less than 1e-5
(tests/test_torch_real_models.py::test_cli_default_hybrid_solve_amplifies_rounding_at_init).
The loss: value rtol 1e-4, each gradient leaf
|g_gpu - g_cpu| <= 2e-3 max|g_cpu| + 1e-6 (float32 reductions and matrix
products round differently on the two devices). The forecast of every
method: |x_gpu - x_cpu| <= 1e-4 max|x_cpu| + 1e-5, scaled to the largest
entry because the ODE decoders' forecasts reach a few hundred at init.
"""

import copy
import os

import numpy as np
import pytest
import torch

from hybridode_torch.cli.common import build_real_model
from hybridode_torch.cli.run_real import predict_test
from hybridode_torch.data import RealCohort
from hybridode_torch.inference import elbo, init_vi

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "data_real")
B = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture
def cohort():
    c = RealCohort(DATA, device="cpu")
    c.split_sample()
    return c


def _model(c, method):
    return build_real_model(method, c.obs_dim, c.action_dim, c.static_dim, c.t_max, c.step_size,
                            encoder_output_dim=4 if method == "expert" else 20,
                            ode_step_div=2 if method == "hybrid" else 1)


@pytest.mark.cuda
def test_cuda_real_loss_and_gradients_match_cpu(cuda_device, cohort):
    model = _model(cohort, "hybrid")
    params = init_vi(torch.Generator().manual_seed(3), model, device="cpu")
    batch = cohort.get_split("train", B, 1)
    out = {}
    for device in ("cpu", "cuda"):
        p = copy.deepcopy(params).to(device)
        loss = elbo.real_loss(p, model, {k: v.to(device) for k, v in batch.items()})
        loss.backward()
        out[device] = loss.item(), {k: v.grad.cpu().numpy() for k, v in p.named_parameters() if v.grad is not None}
    assert np.isfinite(out["cpu"][0]) and np.isfinite(out["cuda"][0])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    assert out["cuda"][1].keys() == out["cpu"][1].keys() and "decoder.ode.kel2" in out["cpu"][1]
    for name, want in out["cpu"][1].items():
        got = out["cuda"][1][name]
        assert np.isfinite(got).all(), name
        assert np.max(np.abs(got - want)) <= 2e-3 * np.max(np.abs(want)) + 1e-6, name


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["neural", "hybrid", "expert", "2nd", "tlstm", "gruode"])
def test_cuda_forecast_matches_cpu(cuda_device, cohort, method):
    model = _model(cohort, method)
    params = init_vi(torch.Generator().manual_seed(4), model, device="cpu")
    batch = cohort.get_split("test", B, 0)
    want = predict_test(params, model, batch, 24)
    got = predict_test(copy.deepcopy(params).to(cuda_device), model,
                       {k: v.to(cuda_device) for k, v in batch.items()}, 24).cpu()
    assert got.shape == (73, B, 28) and torch.isfinite(want).all()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-5
