"""The adjoint solver and cohort generation on the GPU against the same code on the CPU, and the device rule.

The `cuda` cases skip without a GPU. This file imports no JAX, so that the
GPU machine, which has none, runs it:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_lockstep.py`.

A lockstep solve of the Roche field is not reproducible to rounding, even in
float64: one controller serves the batch through the RMS error norm over
every element, and the dose jumps make the step sequence sensitive to the
last bits of that norm. Permuting the 8 patients below on one CPU, which only
reorders the norm's sum, moves the float64 trajectory by up to 2.6e-6 at
the CLI's rtol 1e-7 and by ~1e-9 at rtol 1e-10, and the trial steps by up
to 1.5 % and 4.3 % (`lockstep_order_study.py`); the GPU's reductions and
transcendentals reorder and round likewise. So the devices are held to the solve's own accuracy: the
adjoint at rtol 1e-10, atol 1e-12, trajectories within rtol 1e-7, atol 1e-8
and gradients within rtol 1e-6, atol 1e-9; the float64 ground truth of a
generated cohort (rtol 1e-8) stored as float32 within rtol 1e-5, atol 1e-6,
the tolerance it is held to against JAX's, the drawn arrays byte for byte.
In float32 (the precision the model trains in) the `sim_loss` gradients of
the lockstep hybrid are held to |g_gpu - g_cpu| <= 2e-3 max|g_cpu| + 1e-6
per leaf, the loss to rtol 1e-4, as tests/test_torch_cuda_train.py holds
the per-row solve.
"""

import copy
import os

import numpy as np
import pytest
import torch

from hybridode_torch.cli import create_data
from hybridode_torch.cli.common import build_sim_model
from hybridode_torch.config import DataConfig, RocheConfig
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.fields import DoseContext, doses_from_actions, init_roche_field, roche_field
from hybridode_torch.inference import elbo, init_vi
from hybridode_torch.solvers import odeint_dopri5_adjoint

COHORT = os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl")
B = 8
DRAWN = ("output_coef", "ml_coef", "dose_time", "dose_amount", "actions", "masks")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_generation_and_create_data_refuse_to_start_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ([], ["--device", "0"], ["--device", "1"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_data.main(["--which", "train", "--out", str(tmp_path)] + device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticCohort(n_sample=4, obs_dim=2, t_max=14, step_size=1, roche_config=RocheConfig(), output_sigma=0.2)
    assert not list(tmp_path.iterdir())  # refused before any work


def _adjoint_grads(device, per_row):
    """Gradients of a float64 lockstep or per-row adjoint solve of 8 cohort patients w.r.t. y0 and the ml net."""
    c = SyntheticCohort.load(COHORT, device="cpu")
    ctx = doses_from_actions(c.get_split("train", B, 0)["actions"].double(), 1.0)
    gen = torch.Generator().manual_seed(0)
    params = init_roche_field(gen, 6, device="cpu").to(device=device, dtype=torch.float64)
    y0 = (torch.exp(0.3 * torch.randn(B, 6, generator=gen, dtype=torch.float64)) / 10).to(device).requires_grad_()
    ctx = type(ctx)(*(x.to(device) for x in ctx))
    ys, st = odeint_dopri5_adjoint(roche_field, y0, torch.arange(15.0, dtype=torch.float64, device=device),
                                   (params, ctx), rtol=1e-10, atol=1e-12, max_steps=4096, max_record=4096,
                                   per_row=per_row)
    (ys[1:] ** 2).sum().backward()
    grads = {n: p.grad.cpu() for n, p in params.named_parameters() if p.grad is not None}
    return ys.detach().cpu(), y0.grad.cpu(), grads, type(st)(*(x.cpu() for x in st))


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True], ids=["lockstep", "per_row"])
def test_adjoint_gradients_on_the_card_match_the_cpu(cuda_device, per_row):
    ys, gy, grads, st = _adjoint_grads(cuda_device, per_row)
    ys_c, gy_c, grads_c, st_c = _adjoint_grads("cpu", per_row)
    assert bool(st.success.all()) and bool(st_c.success.all())
    assert bool(st.recorded_all.all()) and bool(st_c.recorded_all.all())
    torch.testing.assert_close(ys, ys_c, rtol=1e-7, atol=1e-8)
    torch.testing.assert_close(gy, gy_c, rtol=1e-6, atol=1e-9)
    assert sorted(grads) == sorted(grads_c) == ["ml_net.0.b", "ml_net.0.w"]
    for name in grads:
        torch.testing.assert_close(grads[name], grads_c[name], rtol=1e-6, atol=1e-9)


@pytest.mark.cuda
def test_lockstep_sim_loss_gradient_on_the_card_matches_the_cpu(cuda_device):
    model = build_sim_model("hybrid", DataConfig(), lockstep=True)
    params = init_vi(torch.Generator().manual_seed(0), model, device="cpu")
    c = SyntheticCohort.load(COHORT, device="cpu")
    batch = c.get_split("train", B, 0)
    eps, eps_kl = elbo.draw_noise(model, B, torch.Generator().manual_seed(1), "cpu")
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        p = copy.deepcopy(params).to(device)
        loss = elbo.sim_loss(p, model, {k: v.to(device) for k, v in batch.items()}, eps=eps.to(device),
                             eps_kl=eps_kl.to(device))
        loss.backward()
        out[device.type] = loss.item(), {n: q.grad.cpu() for n, q in p.named_parameters() if q.grad is not None}
    (loss_g, g), (loss_c, gc) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(loss_g, loss_c, rtol=1e-4)
    assert sorted(g) == sorted(gc)
    for name in g:
        assert float((g[name] - gc[name]).abs().max()) <= 2e-3 * float(gc[name].abs().max()) + 1e-6, name


def _small(device):
    dg = SyntheticCohort(n_sample=40, obs_dim=10, t_max=14, step_size=1, roche_config=RocheConfig(kel=1),
                         output_sigma=0.2, dose_max=10, latent_dim=6, sparsity=0.5, output_sparsity=0.5,
                         p_remove=0.5, val_size=8, test_size=8, rng=np.random.RandomState(666), device=device)
    dg.generate_data()
    dg.split_sample()
    return dg, dg.solve_stats


@pytest.mark.cuda
def test_float64_generation_on_the_card_matches_the_cpu(cuda_device):
    gpu, st = _small(cuda_device)
    cpu, st_c = _small("cpu")
    assert bool(st.success) and bool(st_c.success)
    for k in DRAWN:
        assert getattr(gpu, k).tobytes() == getattr(cpu, k).tobytes(), k
    np.testing.assert_allclose(gpu.latents, cpu.latents, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gpu.measurements, cpu.measurements, rtol=0, atol=1e-5)
    assert gpu.data_train["latents"].is_cuda


@pytest.mark.cuda
def test_cohort_written_on_the_card_loads_on_the_cpu(cuda_device, tmp_path):
    create_data.main(["--which", "train", "--seed", "5", "--out", str(tmp_path)])
    path = os.path.join(str(tmp_path), "datafile_dose_exp.pkl")
    cpu = SyntheticCohort.load(path, device="cpu")
    assert cpu.n_sample == 1300 and cpu.latents.shape == (15, 1300, 6) and np.all(np.isfinite(cpu.latents))
    assert not cpu.data_train["latents"].is_cuda and not hasattr(cpu, "rng")
    gpu = SyntheticCohort.load(path, device=cuda_device)
    assert torch.equal(gpu.data_test["measurements"].cpu(), cpu.data_test["measurements"])



class _Lane(torch.nn.Module):
    """One lane's lockstep adjoint solve of 8 patients on the Roche field `ode` -> (ys, loss, trial, accepted)."""

    def __init__(self, ode):
        super().__init__()
        self.ode = ode

    def forward(self, y, times, amounts):
        ys, st = odeint_dopri5_adjoint(roche_field, y, torch.arange(15.0, dtype=y.dtype, device=y.device),
                                       (self.ode, DoseContext(times, amounts)), rtol=1e-7, atol=1e-8, max_steps=4096)
        return ys, (ys[1:] ** 2).sum(), st.n_steps, st.n_accepted


@pytest.mark.cuda
def test_vmapped_lockstep_lanes_take_their_own_solves_steps_on_the_card(cuda_device):
    """Three lanes of 8 patients each (three inits of the field, three blocks of the cohort's doses), float64 on the
    card: `torch.func.vmap` of the lockstep adjoint solve, its loss summed outside the vmap, against each lane's
    own solve on the card. The same trial and accepted steps a lane, trajectory and gradients within rtol 1e-10
    of the largest entry (each lane's arithmetic is its own solve's, `solvers/adjoint.py`)."""
    c = SyntheticCohort.load(COHORT, device="cpu")
    odes, ctxs, y0 = [], [], []
    for r in range(3):
        odes.append(init_roche_field(torch.Generator().manual_seed(r), 6, device="cpu").to(cuda_device, torch.float64))
        ctx = doses_from_actions(c.get_split("train", B, r)["actions"].double(), 1.0)
        ctxs.append(type(ctx)(*(x.to(cuda_device) for x in ctx)))
        y0.append(torch.rand(B, 6, generator=torch.Generator().manual_seed(10 + r), dtype=torch.float64) * 2)
    y0 = torch.stack(y0).to(cuda_device)
    names = [n for n, p in odes[0].named_parameters() if p.requires_grad]
    stacked, _ = torch.func.stack_module_state(odes)
    base = _Lane(copy.deepcopy(odes[0]).to("meta"))

    def lane(params, y, times, amounts):
        return torch.func.functional_call(base, {"ode." + n: p for n, p in params.items()}, (y, times, amounts))

    y = y0.clone().requires_grad_()
    ys, loss, n_steps, n_acc = torch.func.vmap(lane)(stacked, y, torch.stack([x.times for x in ctxs]),
                                                     torch.stack([x.amounts for x in ctxs]))
    grads = torch.autograd.grad(loss.sum(), [y] + [stacked[n] for n in names])
    for r in range(3):
        y_r = y0[r].clone().requires_grad_()
        want_ys, want_loss, want_steps, want_acc = _Lane(odes[r])(y_r, ctxs[r].times, ctxs[r].amounts)
        want = torch.autograd.grad(want_loss, [y_r] + [p for p in odes[r].parameters() if p.requires_grad])
        assert (int(n_steps[r]), int(n_acc[r])) == (int(want_steps), int(want_acc)), r
        torch.testing.assert_close(ys[r], want_ys.detach(), rtol=1e-10, atol=1e-10 * float(want_ys.detach().abs().max()))
        for g, w in zip(grads, want):
            torch.testing.assert_close(g[r], w, rtol=1e-10, atol=1e-10 * float(w.abs().max()))
