"""The flow posterior, the horizon and the ensemble evaluations on the GPU against the same code on the CPU.

The `cuda` cases skip without a GPU. This file imports no JAX, so that the
GPU machine, which has none, runs it:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_flow.py`.

The flow loss: the CLI's flow model (per-patient DOPRI5, 4 planar flows, a
50-sample MC KL) on 8 patients of data_s123, value rtol 1e-4 and each leaf
|g_gpu - g_cpu| <= 2e-3 max|g_cpu| + 1e-6, as tests/test_torch_cuda_train.py
holds the sim loss. The evaluations decode with RK4 at ode_step_size=0.125 on
the whole test fold (4 chunks of 50): on the GPU through the RK4 kernel, one
launch per chunk and model with a Roche field, on the CPU through its plain
version; every vector or metric within rtol 1e-3, as `chip_smoke.py` holds
`evaluate`.
"""

import copy
import os

import numpy as np
import pytest
import torch

from hybridode_torch.cli import run_eval, run_simulation_ensemble, run_simulation_flow, run_simulation_residual
from hybridode_torch.cli.common import build_sim_model
from hybridode_torch.config import DataConfig
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.eval import evaluate, evaluate_ensemble_horizon, evaluate_horizon
from hybridode_torch.inference import elbo, init_vi
from hybridode_torch.ops import roche_rk4

COHORT = os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl")
B = 8
METRIC_RTOL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("cli,argv", [
    (run_simulation_flow, ["--restart", "1", "--arg_itr", "1"]),
    (run_eval, ["--method", "expert"]),
    (run_simulation_ensemble, []),
    (run_simulation_residual, ["--restart", "1"]),
], ids=["run_simulation_flow", "run_eval", "run_simulation_ensemble", "run_simulation_residual"])
def test_cli_refuses_to_start_without_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path, cli, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = argv + ["--data_path", COHORT, "--path", str(tmp_path) + "/", "--result_path", str(tmp_path / "r.pkl")]
    if cli is run_simulation_flow:
        argv = argv[:-2]
    for device in ([], ["--device", "0"], ["--device", "1"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv + device)
    assert not list(tmp_path.iterdir())  # refused before any work


def _rk4(model):
    return model._replace(decoder_spec=model.decoder_spec._replace(method="rk4", ode_step_size=0.125))


@pytest.mark.cuda
def test_cuda_flow_loss_gradient_matches_cpu(cuda_device):
    c = SyntheticCohort.load(COHORT, device="cpu")
    model = build_sim_model("hybrid", DataConfig(), flow=True, mc_size=50)
    params = init_vi(torch.Generator().manual_seed(3), model, device="cpu")
    eps, eps_kl = elbo.draw_noise(model, B, torch.Generator().manual_seed(5), "cpu")
    batch = c.get_split("train", B, 0)
    out = {}
    for device in ("cpu", "cuda"):
        p = copy.deepcopy(params).to(device)
        loss = elbo.flow_loss(p, model, {k: v.to(device) for k, v in batch.items()}, eps=eps.to(device),
                              eps_kl=eps_kl.to(device))
        loss.backward()
        out[device] = loss.item(), {k: v.grad.cpu().numpy() for k, v in p.named_parameters() if v.requires_grad}
    assert np.isfinite(out["cpu"][0]) and np.isfinite(out["cuda"][0])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    assert sum(".amor_" in name for name in out["cpu"][1]) == 6
    for name, want in out["cpu"][1].items():
        got = out["cuda"][1][name]
        assert np.isfinite(got).all(), name
        assert np.max(np.abs(got - want)) <= 2e-3 * np.max(np.abs(want)) + 1e-6, name


def _on_both(fn):
    """fn(device) on the GPU (kernel launches counted) and on the CPU, np.random seeded alike for the bootstrap
    SDs; -> (gpu, cpu, launches)."""
    np.random.seed(0)
    roche_rk4.roche_rk4_trajectory.launches = 0
    gpu = fn("cuda")
    torch.cuda.synchronize()
    launches = roche_rk4.roche_rk4_trajectory.launches
    np.random.seed(0)
    return gpu, fn("cpu"), launches


def _members(device):
    p_e_m = []
    for seed, method in ((1, "expert"), (2, "neural")):
        model = _rk4(build_sim_model(method, DataConfig()))
        p_e_m += [init_vi(torch.Generator().manual_seed(seed), model, device=device), model]
    return p_e_m


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["evaluate_horizon", "evaluate_ensemble_horizon", "flow_evaluate"])
def test_cuda_evaluation_paths_launch_the_kernel_and_match_the_plain_path(cuda_device, path):
    hybrid = _rk4(build_sim_model("hybrid", DataConfig(), flow=path == "flow_evaluate"))
    params = init_vi(torch.Generator().manual_seed(0), hybrid, device="cpu")

    def run(device):
        cohort = SyntheticCohort.load(COHORT, device=device)
        gen = torch.Generator().manual_seed(4)
        if path == "evaluate_horizon":
            return evaluate_horizon(copy.deepcopy(params).to(device), hybrid, cohort, 50, 5, generator=gen,
                                    device=device)
        if path == "evaluate_ensemble_horizon":
            return evaluate_ensemble_horizon(*_members(device), cohort, 50, 5, generator=gen, device=device)
        out = evaluate(copy.deepcopy(params).to(device), hybrid, cohort, 50, 5, generator=gen, verbose=False,
                       device=device)
        return {"rmse_z0": out[0], "cprs_z0": out[2], "rmse_x": out[3], "cprs_x": out[5]}

    gpu, cpu, launches = _on_both(run)
    assert launches == 4  # one per chunk of 50; the ensemble's neural member has no Roche field
    for k, want in cpu.items():
        got = np.asarray(gpu[k])
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, want, rtol=METRIC_RTOL, err_msg=k)
