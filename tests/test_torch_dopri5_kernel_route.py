"""Which decodes the per-row DOPRI5 kernel takes, and what surrounds it, on the CPU.

`decoders._kernel_route` decides from what the decoder observes. The kernel
runs only on a CUDA state, so these tests let the CPU stand for a kernel
device (`KERNEL_DEVICES`) to show where the route is taken, and keep the CPU
out of it to show that a CPU state never takes it. Taken on the CPU, the
route reaches `roche_dopri5_per_row`'s plain version, so the decode it gives
is the plain solver's. The kernel itself is held to the plain solver on the
card (tests/test_torch_cuda_dopri5_kernel.py, and with gradients
tests/test_torch_cuda_dopri5_grad_kernel.py).
"""

import pytest
import torch

from hybridode_torch.fields import DoseContext, init_neural_field, init_roche_field, roche_field
from hybridode_torch.models import decoders
from hybridode_torch.models.decoders import SimDecoderSpec
from hybridode_torch.ops import build, roche_dopri5
from hybridode_torch.solvers import odeint_dopri5

B = 5
SPEC = SimDecoderSpec(obs_dim=20, latent_dim=6, action_dim=1, t_max=14, step_size=1, per_sample_control=True,
                      max_steps=256)

ROUTES = {
    "per_patient_dopri5": (dict(), {}, "dopri5"),
    "expert_only": (dict(latent_dim=4), {}, "dopri5"),
    "latent_8": (dict(latent_dim=8), {}, "dopri5"),
    "grad_mode_on_nothing_requires_grad": (dict(), dict(grad=True, frozen=True), "dopri5"),
    "rk4": (dict(method="rk4"), {}, "rk4"),
    "grad": (dict(), dict(grad=True), "dopri5_grad"),
    "init_requires_grad": (dict(), dict(grad=True, frozen=True, init_grad=True), "dopri5_grad"),
    "vmap": (dict(), dict(vmap=True), None),
    "use_adjoint": (dict(use_adjoint=True), {}, None),
    "lockstep": (dict(per_sample_control=False), {}, None),
    "ablate": (dict(ablate=True), {}, None),
    "neural_field": (dict(roche=False), {}, None),
    "latent_9": (dict(latent_dim=9), {}, "dopri5"),
    "latent_10": (dict(latent_dim=10), {}, "dopri5"),
    "latent_11": (dict(latent_dim=11), {}, "dopri5"),
    "latent_12": (dict(latent_dim=12), {}, "dopri5"),
    "latent_13": (dict(latent_dim=13), {}, None),
    "rk4_latent_9": (dict(method="rk4", latent_dim=9), {}, "rk4"),
    "rk4_latent_10": (dict(method="rk4", latent_dim=10), {}, "rk4"),
    "rk4_latent_11": (dict(method="rk4", latent_dim=11), {}, "rk4"),
    "rk4_latent_12": (dict(method="rk4", latent_dim=12), {}, "rk4"),
    "rk4_latent_13": (dict(method="rk4", latent_dim=13), {}, None),
    "two_doses": (dict(), dict(doses=2), None),
    "cpu_state": (dict(), dict(cpu_is_no_kernel_device=True), None),
    "euler": (dict(method="euler"), {}, None),
    "grad_expert_only": (dict(latent_dim=4), dict(grad=True, frozen=True, init_grad=True), "dopri5_grad"),
    "grad_latent_8": (dict(latent_dim=8), dict(grad=True), "dopri5_grad"),
    "grad_latent_12": (dict(latent_dim=12), dict(grad=True), "dopri5_grad"),
    "grad_latent_13": (dict(latent_dim=13), dict(grad=True), None),
    "grad_train_expert": (dict(), dict(grad=True, train_expert=True), None),
    "grad_ablate": (dict(ablate=True), dict(grad=True), None),
    "grad_vmap": (dict(), dict(grad=True, vmap=True), None),
    "grad_func_grad": (dict(), dict(grad=True, func_grad=True), None),
    "grad_use_adjoint": (dict(use_adjoint=True), dict(grad=True), None),
    "grad_lockstep": (dict(per_sample_control=False), dict(grad=True), None),
    "grad_rk4": (dict(method="rk4"), dict(grad=True), None),
    "grad_two_doses": (dict(), dict(grad=True, doses=2), None),
    "grad_neural_field": (dict(roche=False), dict(grad=True), None),
    "grad_cpu_state": (dict(), dict(grad=True, cpu_is_no_kernel_device=True), None),
}


def _field(spec):
    gen = torch.Generator().manual_seed(0)
    if spec.roche:
        return init_roche_field(gen, spec.latent_dim, ablate=spec.ablate, device="cpu")
    return init_neural_field(gen, spec.latent_dim, device="cpu")


def _ctx(doses=1):
    times = torch.tensor([[0.0], [2.0], [4.0], [1e30], [7.0]]).repeat(1, doses)
    return DoseContext(times=times, amounts=torch.linspace(0.5, 2.0, B))


@pytest.mark.parametrize("name", list(ROUTES))
def test_kernel_route_is_taken_only_where_the_kernel_computes_the_decode(name, monkeypatch):
    changes, how, want = ROUTES[name]
    if not how.get("cpu_is_no_kernel_device"):
        monkeypatch.setattr(decoders, "KERNEL_DEVICES", ("cpu",))
    spec = SPEC._replace(**changes)
    params = _field(spec)
    if how.get("frozen"):
        params.requires_grad_(False)
    if how.get("train_expert"):
        params["expert"].requires_grad_(True)
    init = torch.rand(B, spec.latent_dim, generator=torch.Generator().manual_seed(1))
    if how.get("init_grad"):
        init.requires_grad_(True)
    ctx = _ctx(how.get("doses", 1))
    with torch.set_grad_enabled(how.get("grad", False)):
        if how.get("vmap"):
            routes = []

            def lane(y):
                routes.append(decoders._kernel_route(spec, params, y, ctx))
                return y

            torch.func.vmap(lane)(init[None])
            (got,) = routes
        elif how.get("func_grad"):
            routes = []

            def loss(y):
                routes.append(decoders._kernel_route(spec, params, y, ctx))
                return y.sum()

            torch.func.grad(loss)(init)
            (got,) = routes
        else:
            got = decoders._kernel_route(spec, params, init, ctx)
    assert got == want


def test_the_kernel_route_decodes_what_the_plain_solver_decodes(monkeypatch):
    """`sim_decoder_apply` through the kernel route (on the CPU: the kernel wrapper's plain version) and through the
    plain per-row solver give the same decode; the route calls the wrapper once, with the spec's tolerances."""
    gen = torch.Generator().manual_seed(2)
    params = {"ode": init_roche_field(gen, 6, device="cpu"),
              "output": {"w": torch.randn(6, 20, generator=gen) * 0.3, "b": torch.zeros(20)}}
    spec = SPEC._replace(rtol=1e-6, atol=1e-7, max_steps=128)
    init = torch.exp(0.3 * torch.randn(B, 6, generator=gen)) / 10
    actions = torch.zeros(15, B, 1)
    actions[torch.tensor([0, 2, 4, 7, 9]), torch.arange(B), 0] = torch.tensor([1.0, 0.5, 2.0, 0.0, 1.5])
    calls = []

    def wrapper(*args, **kw):
        calls.append(kw)
        return roche_dopri5.roche_dopri5_per_row(*args, **kw)

    with torch.no_grad():
        want_x, want_h = decoders.sim_decoder_apply(params, spec, init, actions)
        monkeypatch.setattr(decoders, "KERNEL_DEVICES", ("cpu",))
        monkeypatch.setattr(decoders, "roche_dopri5_per_row", wrapper)
        got_x, got_h = decoders.sim_decoder_apply(params, spec, init, actions)
    assert calls == [dict(rtol=1e-6, atol=1e-7, max_steps=128)]
    assert torch.equal(got_h, want_h) and torch.equal(got_x, want_x)
    assert torch.isfinite(got_h).all()


@pytest.mark.parametrize("latent_dim", [4, 6])
def test_the_grad_route_decodes_and_differentiates_what_the_plain_solver_does(latent_dim, monkeypatch):
    """With gradients needed, `sim_decoder_apply` takes the "dopri5_grad" route (on the CPU: the grad wrapper's plain
    version, the plain solver with autograd), calls it once with the spec's tolerances, names it on the `decode` span,
    and gives the plain per-row solver's decode and gradients for the initial state and every trained leaf."""
    from hybridode_torch.utils import logging as tracing

    gen = torch.Generator().manual_seed(5)
    spec = SPEC._replace(latent_dim=latent_dim, rtol=1e-6, atol=1e-7, max_steps=128)
    params = {"ode": init_roche_field(gen, latent_dim, device="cpu"),
              "output": {"w": torch.randn(latent_dim, 20, generator=gen) * 0.3, "b": torch.zeros(20)}}
    init = (torch.exp(0.3 * torch.randn(B, latent_dim, generator=gen)) / 10).requires_grad_(True)
    actions = torch.zeros(15, B, 1)
    actions[torch.tensor([0, 2, 4, 7, 9]), torch.arange(B), 0] = torch.tensor([1.0, 0.5, 2.0, 0.0, 1.5])
    leaves = [init] + [p for p in params["ode"].parameters() if p.requires_grad]
    calls = []

    def wrapper(*args, **kw):
        calls.append(kw)
        return roche_dopri5.roche_dopri5_per_row_grad(*args, **kw)

    def decode():
        with tracing.span("decode"):
            x, h = decoders.sim_decoder_apply(params, spec, init, actions)
        return x, h, torch.autograd.grad(x.square().sum(), leaves), tracing.RECORDER.last("decode").fields["route"]

    want_x, want_h, want_g, want_route = decode()
    monkeypatch.setattr(decoders, "KERNEL_DEVICES", ("cpu",))
    monkeypatch.setattr(decoders, "roche_dopri5_per_row_grad", wrapper)
    got_x, got_h, got_g, got_route = decode()
    assert (want_route, got_route) == ("plain", "dopri5_grad")
    assert calls == [dict(rtol=1e-6, atol=1e-7, max_steps=128)]
    assert torch.equal(got_h, want_h) and torch.equal(got_x, want_x) and torch.isfinite(got_h).all()
    assert len(got_g) == len(leaves) == (1 if latent_dim == 4 else 3)
    for got, want in zip(got_g, want_g):
        assert torch.equal(got, want) and bool(got.abs().sum() > 0)


@pytest.mark.parametrize("max_steps", [1, 64, 65])
def test_trial_budget_is_the_plain_solvers(max_steps):
    """A row that does not finish within its budget (from states of 3, some 150 trial steps) takes
    `trial_budget(max_steps)` trial steps in the plain solver: chunks of 64."""
    params = init_roche_field(torch.Generator().manual_seed(0), 6, device="cpu")
    y0 = torch.full((2, 6), 3.0)
    ctx = DoseContext(times=torch.tensor([[1.0], [3.0]]), amounts=torch.tensor([1.0, 2.0]))
    with torch.no_grad():
        ys, stats = odeint_dopri5(roche_field, y0, torch.arange(15.0), (params, ctx), rtol=1e-7, atol=1e-8,
                                  max_steps=max_steps, per_row=True)
    assert not bool(stats.success.any())
    assert stats.n_steps.tolist() == [roche_dopri5.trial_budget(max_steps)] * 2
    assert torch.isnan(ys[-1]).all()


def test_a_changed_header_changes_the_build_target(tmp_path, monkeypatch):
    """`build._target` names a library by its source, the headers it includes from `csrc/` (followed into their own
    includes) and the flags: a changed header is rebuilt; a header no source includes changes nothing."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "c.cuh").write_text("// c\n")
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    first = build._target("k")[1]
    assert build._target("k")[1] == first
    (tmp_path / "c.cuh").write_text("// c, changed\n")
    assert build._target("k")[1] == first
    (tmp_path / "b.cuh").write_text("// b, changed\n")
    second = build._target("k")[1]
    assert second != first
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    assert build._target("k")[1] not in (first, second)


def test_a_per_width_source_builds_one_library_a_width():
    """`roche_dopri5` compiles once a state width, its macro set to the width: each width is a library of its own,
    named by it; `roche_rk4` compiles once, with the plain flags."""
    libs = [build._target("roche_dopri5", D)[1] for D in build.WIDTHS]
    assert len(set(libs)) == len(build.WIDTHS) == 9
    assert all(f"roche_dopri5_d{D}-" in lib for D, lib in zip(build.WIDTHS, libs))
    assert "-DROCHE_DOPRI5_DIM=6" in build._target("roche_dopri5", 6)[2]
    assert build._target("roche_rk4")[2] == build.NVCC_FLAGS
    assert build.TARGETS == (("roche_rk4", None), *(("roche_dopri5", D) for D in build.WIDTHS))

