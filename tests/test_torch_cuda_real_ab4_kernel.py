"""The real track's explicit-Adams kernels (`roche_real_ab4`, `roche_real_ab4_grad`) on the card.

The cases skip without a GPU. This file imports no JAX, so that the GPU
machine, which has none, runs it:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_real_ab4_kernel.py`.

At the benchmark cell's shape (B 100 patients of data_real/, the hybrid's
latent 20 with field hidden 48, two substeps an hour over hours 23 ... 96)
and at the expert's latent 4, the kernels are held to the plain route
(`odeint_fixed` and its autograd on the card, the route emptied of kernel
devices): the trajectory within TRAJ_RTOL, `real_loss` within LOSS_RTOL and
each leaf's gradient within GRAD_RTOL, each relative and in norm, float32
tolerances (the kernels' dot products use FMAs and sum in other orders than
PyTorch's matrix products). Against a float64 solve the kernel's trajectory
is as accurate as the plain float32 route's (ACCURACY). Two backward passes
agree bit for bit, a captured CUDA graph of the training step's decode
replays the eager call bit for bit and counts its rows, and each launch is
counted. At the edges of the widths the route takes (`build.AB4_DIMS`,
`build.AB4_HIDDEN`), each built on first use, the pair is the plain route's
and neither kernel spills.
"""

import copy
import os

import pytest
import torch

from hybridode_torch.cli.common import build_real_model
from hybridode_torch.data import RealCohort
from hybridode_torch.fields import init_roche_real_field
from hybridode_torch.inference import elbo, init_vi
from hybridode_torch.ops import build, contract, roche_real_ab4

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "data_real")
B, N_SUB = 100, 2
TRAJ_RTOL = 1e-5  # kernel against the plain route on the card
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-3  # each leaf
ACCURACY, ATOL = 4.0, 1e-6  # against float64: the kernel's error <= ACCURACY x the plain route's + ATOL


@pytest.fixture(scope="module")
def cohort():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or interpret mode")
    c = RealCohort(DATA, device="cpu")
    c.split_sample()
    return c


def _model(c, method):
    return build_real_model(method, c.obs_dim, c.action_dim, c.static_dim, c.t_max, c.step_size,
                            encoder_output_dim=4 if method == "expert" else 20, ode_step_div=N_SUB)


def _setup(cohort, method, seed=3):
    model = _model(cohort, method)
    params = init_vi(torch.Generator().manual_seed(seed), model, device="cuda")
    batch = {k: v.cuda() for k, v in cohort.get_split("train", B, 0).items()}
    eps, eps_kl = elbo.draw_noise(model, B, torch.Generator().manual_seed(seed + 1), "cuda")
    return model, params, batch, dict(eps=eps, eps_kl=eps_kl)


def _decode_inputs(model, params, batch, seed=5):
    spec = model.decoder_spec
    y0 = 0.5 * torch.randn(B, spec.latent_dim, generator=torch.Generator().manual_seed(seed)).cuda()
    ts = torch.as_tensor(spec.ts, dtype=torch.float32, device="cuda")
    return y0, batch["actions"].contiguous(), params["decoder"]["ode"], ts


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _plain(monkeypatch):
    monkeypatch.setattr(contract, "KERNEL_DEVICES", ())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["hybrid", "expert"])
def test_the_trajectory_is_the_plain_routes_and_as_accurate_against_float64(cohort, method):
    model, params, batch, _ = _setup(cohort, method)
    y0, actions, ode, ts = _decode_inputs(model, params, batch)
    launches = roche_real_ab4.roche_real_ab4.launches
    with torch.no_grad():
        got = roche_real_ab4.roche_real_ab4(y0, actions, ode, ts, N_SUB)
        plain = roche_real_ab4.roche_real_ab4_reference(y0, actions, ode, ts, N_SUB)
        ode64 = copy.deepcopy(ode).to(device="cpu", dtype=torch.float64)
        exact = roche_real_ab4.roche_real_ab4_reference(y0.cpu().double(), actions.cpu().double(), ode64,
                                                        ts.cpu().double(), N_SUB)
    assert roche_real_ab4.roche_real_ab4.launches == launches + 1
    assert got.shape == (ts.shape[0], B, y0.shape[1]) and torch.isfinite(got).all()
    assert torch.equal(got[0], y0)
    assert _rel(got, plain) < TRAJ_RTOL
    assert _rel(got.cpu(), exact) <= ACCURACY * _rel(plain.cpu(), exact) + ATOL


def _loss_and_grads(model, params, batch, noise):
    """The loss and the gradient of each leaf it reaches."""
    loss = elbo.real_loss(params, model, batch, **noise)
    leaves = dict(params.named_parameters())
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {name: g for name, g in zip(leaves, grads) if g is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["hybrid", "expert"])
def test_real_loss_and_every_leafs_gradient_are_the_plain_routes(cohort, method, monkeypatch):
    model, params, batch, noise = _setup(cohort, method)
    launches = roche_real_ab4.roche_real_ab4_grad.launches
    loss, grads = _loss_and_grads(model, params, batch, noise)
    assert roche_real_ab4.roche_real_ab4_grad.launches == launches + 1
    _plain(monkeypatch)
    want_loss, want = _loss_and_grads(model, params, batch, noise)
    assert roche_real_ab4.roche_real_ab4_grad.launches == launches + 1  # the plain route launches nothing
    assert torch.isfinite(loss) and _rel(loss, want_loss) < LOSS_RTOL
    ode = [k for k in want if k.startswith("decoder.ode.")]
    assert len(ode) == (14 if method == "hybrid" else 11) and "decoder.ode.kel" in ode
    assert grads.keys() == want.keys()
    for name, g in want.items():
        assert torch.isfinite(grads[name]).all(), name
        assert _rel(grads[name], g) < GRAD_RTOL, name


@pytest.mark.cuda
def test_two_backward_passes_agree_bit_for_bit(cohort):
    model, params, batch, _ = _setup(cohort, "hybrid")
    y0, actions, ode, ts = _decode_inputs(model, params, batch)
    y0.requires_grad_(True)
    leaves = roche_real_ab4.field_leaves(ode)
    g = torch.randn(ts.shape[0], B, y0.shape[1], generator=torch.Generator().manual_seed(9)).cuda()
    runs = []
    for _ in range(2):
        out = roche_real_ab4.roche_real_ab4_grad(y0, actions, ode, ts, N_SUB)
        runs.append((out, *torch.autograd.grad((out * g).sum(), (y0, *leaves))))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_a_captured_step_replays_the_eager_call_and_counts_its_rows(cohort):
    """The training step's loss and gradients and a validation's decode, captured into CUDA graphs inside
    `roche_real_ab4.counting`: each replay gives the eager call's numbers bit for bit and adds its rows, all of them
    solved by the kernels."""
    model, params, batch, noise = _setup(cohort, "hybrid")
    leaves = [p for p in params.parameters()]
    rows = torch.zeros(2, dtype=torch.int64, device="cuda")

    def step():
        loss = elbo.real_loss(params, model, batch, **noise)
        return (loss, *(g for g in torch.autograd.grad(loss, leaves, allow_unused=True) if g is not None))

    def validate():
        with torch.no_grad():
            return (elbo.real_loss(params, model, batch, **noise),)

    for fn in (step, validate):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream), roche_real_ab4.counting(rows):
            eager = [t.clone() for t in fn()]
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        launches = (roche_real_ab4.roche_real_ab4.launches, roche_real_ab4.roche_real_ab4_grad.launches)
        with torch.cuda.graph(graph), roche_real_ab4.counting(rows):
            static = fn()
        counted = (roche_real_ab4.roche_real_ab4.launches, roche_real_ab4.roche_real_ab4_grad.launches)
        assert [b - a for a, b in zip(launches, counted)] == ([0, 1] if fn is step else [1, 0])
        rows.zero_()
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(static, eager))
        assert rows.tolist() == [3 * B, 3 * B]
        rows.zero_()


@pytest.mark.cuda
@pytest.mark.parametrize("D, hidden", [(build.AB4_DIMS[-1], build.AB4_HIDDEN[-1]), (5, build.AB4_HIDDEN[0])])
def test_the_widths_at_the_ranges_edges_are_the_plain_routes_and_do_not_spill(cohort, D, hidden):
    """The widest state and hidden width the route takes, and the narrowest GRU and hidden width: the trajectory and
    the gradients of y0 and every leaf against the plain solve's autograd on the card, and registers without spills
    in both kernels."""
    ode = init_roche_real_field(torch.Generator().manual_seed(7), D, hidden, device="cuda")
    leaves = roche_real_ab4.field_leaves(ode)
    actions = cohort.get_split("train", B, 0)["actions"].cuda().contiguous()
    ts = torch.arange(23, 97, dtype=torch.float32, device="cuda")  # the cell's grid
    y0 = (0.5 * torch.randn(B, D, generator=torch.Generator().manual_seed(8))).cuda().requires_grad_()
    g = torch.randn(ts.shape[0], B, D, generator=torch.Generator().manual_seed(9)).cuda()

    def run(fn):
        out = fn(y0, actions, ode, ts, N_SUB)
        return (out.detach(), *torch.autograd.grad((out * g).sum(), (y0, *leaves)))

    got, want = run(roche_real_ab4.roche_real_ab4_grad), run(roche_real_ab4.roche_real_ab4_reference)
    assert torch.isfinite(got[0]).all() and _rel(got[0], want[0]) < TRAJ_RTOL
    for i, (a, b) in enumerate(zip(got[1:], want[1:])):
        assert torch.isfinite(a).all() and _rel(a, b) < GRAD_RTOL, i
    for backward_kernel in (False, True):
        assert roche_real_ab4.kernel_info(D, hidden, backward_kernel)["local_bytes"] == 0, backward_kernel
