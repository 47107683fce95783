"""The training slice on the GPU against the same code on the CPU, and the CLI's device rule.

The `cuda` cases skip without a GPU. This file imports no JAX, so that the
GPU machine, which has none, runs it:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_train.py`.

Per-row DOPRI5 on 8 patients of data_s123 at the CLI's settings
(max_steps=256, rtol=1e-7). In float64 the step sequence does not depend on
rounding, so the GPU and the CPU take the same steps on every row and agree
to rtol 1e-7, atol 1e-9. In float32 the error estimate is at rounding level
and the GPU's reductions and matrix products round differently from the
CPU's, so accept decisions may flip (as between the port and JAX,
tests/test_torch_dopri5.py): trajectories agree to rtol 1e-4, atol 2e-5, and
the step counts summed over the batch within 5 %. One `sim_loss` gradient of
the hybrid model: value rtol 1e-4, each leaf |g_gpu - g_cpu| <= 2e-3
max|g_cpu| + 1e-6.
"""

import copy
import os

import numpy as np
import pytest
import torch

from hybridode_torch.cli.common import build_sim_model
from hybridode_torch.cli.run_simulation import main
from hybridode_torch.config import DataConfig
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.fields import doses_from_actions, init_roche_field, roche_field
from hybridode_torch.inference import elbo, init_vi
from hybridode_torch.solvers import odeint_dopri5

COHORT = os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl")
B = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_cli_refuses_to_start_without_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--method", "hybrid", "--arg_itr", "1", "--restart", "1", "--data_path", COHORT,
            "--path", str(tmp_path) + "/"]
    for device in ([], ["--device", "0"], ["--device", "1"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv + device)
    assert not list(tmp_path.iterdir())  # refused before any work


def _solve(device, dtype):
    c = SyntheticCohort.load(COHORT, device="cpu")
    ctx = doses_from_actions(c.get_split("train", B, 0)["actions"], 1.0)
    gen = torch.Generator().manual_seed(0)
    params = init_roche_field(gen, 6, device="cpu").to(device=device, dtype=dtype)
    y0 = torch.exp(0.3 * torch.randn(B, 6, generator=gen)) / 10
    cast = lambda x: x.to(device=device, dtype=dtype)  # noqa: E731
    with torch.no_grad():
        ys, st = odeint_dopri5(roche_field, cast(y0), cast(torch.arange(15.0)),
                               (params, ctx._replace(times=cast(ctx.times), amounts=cast(ctx.amounts))),
                               max_steps=256, per_row=True)
    return ys.cpu().numpy(), st.n_accepted.cpu().numpy(), st.n_steps.cpu().numpy(), st.success.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_cuda_per_row_dopri5_matches_cpu(cuda_device, dtype):
    got, want = _solve(cuda_device, dtype), _solve("cpu", dtype)
    assert np.all(got[3]) and np.all(want[3]) and np.isfinite(got[0]).all()
    if dtype == torch.float64:
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-7, atol=1e-9)
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=2e-5)
        for g, w in ((got[1], want[1]), (got[2], want[2])):
            assert abs(int(g.sum()) - int(w.sum())) <= 0.05 * int(w.sum()), (g, w)


@pytest.mark.cuda
def test_cuda_sim_loss_gradient_matches_cpu(cuda_device):
    c = SyntheticCohort.load(COHORT, device="cpu")
    model = build_sim_model("hybrid", DataConfig())
    params = init_vi(torch.Generator().manual_seed(3), model, device="cpu")
    eps, eps_kl = elbo.draw_noise(model, B, torch.Generator().manual_seed(5), "cpu")
    batch = c.get_split("train", B, 0)
    out = {}
    for device in ("cpu", "cuda"):
        p = copy.deepcopy(params).to(device)
        loss = elbo.sim_loss(p, model, {k: v.to(device) for k, v in batch.items()}, eps=eps.to(device),
                             eps_kl=eps_kl.to(device))
        loss.backward()
        out[device] = loss.item(), {k: v.grad.cpu().numpy() for k, v in p.named_parameters() if v.requires_grad}
    assert np.isfinite(out["cpu"][0]) and np.isfinite(out["cuda"][0])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for name, want in out["cpu"][1].items():
        got = out["cuda"][1][name]
        assert np.isfinite(got).all(), name
        assert np.max(np.abs(got - want)) <= 2e-3 * np.max(np.abs(want)) + 1e-6, name
