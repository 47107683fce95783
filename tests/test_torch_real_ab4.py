"""The real track's explicit-Adams kernels' plain recurrences and their route, on the CPU.

`ops/roche_real_ab4.py` holds the kernel pair's forward and backward
recurrence in plain PyTorch (`solve_recurrence`, `backward_recurrence`): the
same substeps in the same order and the same discrete adjoint as
`csrc/roche_real_ab4.cu`. In float64 they are held here to `odeint_fixed` and
to autograd through it, for every leaf of `roche_real_field`, on the
benchmark cell's grid (hours 23 ... 96, two substeps an hour) with doses
whose `t >= j` boundaries the solve crosses. `ops/contract.py`
`real_ab4_kernel` decides which decodes take the kernels; the CPU stands for
a kernel device (`contract.KERNEL_DEVICES`) to show where the route is taken,
and the route's CPU path is the plain recurrence. The kernels themselves are
held to the plain route on the card (tests/test_torch_cuda_real_ab4_kernel.py).
"""

import pytest
import torch

from hybridode_torch.fields import (
    init_neural_real_2nd_field,
    init_neural_real_field,
    init_roche_real_field,
    neural_real_2nd_field,
    neural_real_field,
    roche_real_field,
)
from hybridode_torch.models import decoders
from hybridode_torch.models.decoders import RealDecoderSpec
from hybridode_torch.ops import build, contract, roche_real_ab4
from hybridode_torch.ops.roche_real_ab4 import GRU_LEAVES, MLP_LEAVES, RATE_LEAVES

B, H, TA = 4, 48, 97
N_SUB = 2  # the cell's ode_step_div
TOL = 1e-11  # float64: the recurrences against odeint_fixed and its autograd, relative, in norm


def _ode(D, dtype=torch.float64, seed=0):
    return init_roche_real_field(torch.Generator().manual_seed(seed), D, H, dtype=dtype, device="cpu")


def _actions(dtype=torch.float64):
    """Doses before the grid's start (active from its first substep), at hours inside it (each row's boundary
    crossed by the solve, by AB4 substeps and, at hour 24, by the RK4 bootstrap's stages), and at hour 97 (never
    reached)."""
    a = torch.zeros(TA, B, 1, dtype=dtype)
    for b in range(B):
        a[9 + b, b, 0] = 0.5 + b  # hour 10 + b
        a[23 + 13 * b, b, 0] = 1.0 + 0.25 * b  # hour 24 + 13 b
    a[TA - 1, :, 0] = 3.0
    a[60, 1, 0] = 2.0
    return a


def _grid(dtype=torch.float64):
    return torch.arange(23, 97, dtype=dtype)  # RealDecoderSpec(t0=24, t_max=97).ts


def _rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm())


@pytest.mark.parametrize("D", [20, 4])
def test_the_forward_recurrence_is_odeint_fixed(D):
    """`solve_recurrence` gives `odeint_fixed`'s explicit-Adams solve, and records the state at the start of each
    substep: y0 first, each grid point's output at its interval's first substep."""
    ode = _ode(D)
    y0 = 0.5 * torch.randn(B, D, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    with torch.no_grad():
        ref = roche_real_ab4.roche_real_ab4_reference(y0, _actions(), ode, _grid(), N_SUB)
        out, record = roche_real_ab4.solve_recurrence(y0, _actions(), roche_real_ab4.field_leaves(ode), _grid(), N_SUB,
                                                      record=True)
    assert out.shape == ref.shape == (74, B, D) and record.shape == (B, 73 * N_SUB, D)
    assert _rel(out, ref) < TOL
    assert torch.equal(record[:, 0], y0)
    assert torch.equal(record[:, N_SUB :: N_SUB], out[1:-1].transpose(0, 1))
    assert torch.equal(roche_real_ab4.roche_real_ab4(y0, _actions(), ode, _grid(), N_SUB), out)


@pytest.mark.parametrize("D", [20, 4])
def test_the_backward_recurrence_is_autograd_through_odeint_fixed(D):
    """The discrete adjoint (`roche_real_ab4_grad` on CPU tensors: `backward_recurrence` over the recorded
    substeps) gives autograd's gradients through `odeint_fixed` for y0 and every leaf of the field."""
    ode = _ode(D)
    leaves = roche_real_ab4.field_leaves(ode)
    names = MLP_LEAVES + RATE_LEAVES + (GRU_LEAVES if D > 4 else ())
    assert len(leaves) == len(names) == sum(1 for _ in ode.parameters())
    y0 = (0.5 * torch.randn(B, D, generator=torch.Generator().manual_seed(1), dtype=torch.float64)).requires_grad_()
    g = torch.randn(74, B, D, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    ref = roche_real_ab4.roche_real_ab4_reference(y0, _actions(), ode, _grid(), N_SUB)
    want = torch.autograd.grad((ref * g).sum(), (y0, *leaves))
    out = roche_real_ab4.roche_real_ab4_grad(y0, _actions(), ode, _grid(), N_SUB)
    got = torch.autograd.grad((out * g).sum(), (y0, *leaves))
    assert _rel(out, ref) < TOL
    for name, a, b in zip(("y0",) + names, got, want):
        assert a.shape == b.shape, name
        assert _rel(a, b) < TOL, name


def _real_field(kind, D, dtype=torch.float32, hidden=H):
    gen = torch.Generator().manual_seed(0)
    if kind == "neural":
        return neural_real_field, init_neural_real_field(gen, D, 1, H, dtype=dtype, device="cpu")
    if kind == "2nd":
        return neural_real_2nd_field, init_neural_real_2nd_field(gen, D, 1, H, dtype=dtype, device="cpu")
    return roche_real_field, init_roche_real_field(gen, D, hidden, dtype=dtype, device="cpu")


# name: (field kind, D, method, how) -> the route. `how`: grad (grad mode on), frozen (no leaf requires grad),
# init_grad, rank3 (a per-interval (N, B, D) state), vmap / func_grad (inside a torch.func transform), float64,
# cpu_is_no_kernel_device (the CPU left out of KERNEL_DEVICES), hidden (the MLPs' hidden width, else H).
AB4_ROUTES = {
    "hybrid": ("hybrid", 20, "explicit_adams", {}, "ab4"),
    "hybrid_grad": ("hybrid", 20, "explicit_adams", dict(grad=True), "ab4_grad"),
    "hybrid_grad_mode_on_nothing_requires_grad": ("hybrid", 20, "explicit_adams", dict(grad=True, frozen=True), "ab4"),
    "hybrid_init_requires_grad": ("hybrid", 20, "explicit_adams", dict(grad=True, frozen=True, init_grad=True),
                                  "ab4_grad"),
    "expert": ("hybrid", 4, "explicit_adams", {}, "ab4"),
    "expert_grad": ("hybrid", 4, "explicit_adams", dict(grad=True), "ab4_grad"),
    "rank3_per_interval": ("hybrid", 20, "explicit_adams", dict(rank3=True), None),
    "rank3_grad": ("hybrid", 20, "explicit_adams", dict(grad=True, rank3=True), None),
    "rk4": ("hybrid", 20, "rk4", dict(grad=True), None),
    "midpoint": ("hybrid", 20, "midpoint", {}, None),
    "dopri5": ("hybrid", 20, "dopri5", {}, None),
    "neural_field": ("neural", 20, "explicit_adams", dict(grad=True), None),
    "2nd_field": ("2nd", 20, "explicit_adams", dict(grad=True), None),
    "vmap_restarts": ("hybrid", 20, "explicit_adams", dict(vmap=True), None),
    "vmap_restarts_grad": ("hybrid", 20, "explicit_adams", dict(grad=True, vmap=True), None),
    "func_grad": ("hybrid", 20, "explicit_adams", dict(grad=True, func_grad=True), None),
    "cpu_state": ("hybrid", 20, "explicit_adams", dict(cpu_is_no_kernel_device=True), None),
    "cpu_state_grad": ("hybrid", 20, "explicit_adams", dict(grad=True, cpu_is_no_kernel_device=True), None),
    "float64": ("hybrid", 20, "explicit_adams", dict(float64=True), None),
    "latent_12": ("hybrid", 12, "explicit_adams", dict(grad=True), "ab4_grad"),
    "latent_32_widest": ("hybrid", 32, "explicit_adams", dict(grad=True), "ab4_grad"),
    "latent_33_too_wide": ("hybrid", 33, "explicit_adams", dict(grad=True), None),
    "hidden_1_narrowest": ("hybrid", 20, "explicit_adams", dict(grad=True, hidden=1), "ab4_grad"),
    "hidden_64_widest": ("hybrid", 20, "explicit_adams", dict(hidden=64), "ab4"),
    "hidden_65_too_wide": ("hybrid", 20, "explicit_adams", dict(hidden=65), None),
}


@pytest.mark.parametrize("name", list(AB4_ROUTES))
def test_ab4_route_is_taken_only_where_the_kernels_compute_the_decode(name, monkeypatch):
    kind, D, method, how, want = AB4_ROUTES[name]
    if not how.get("cpu_is_no_kernel_device"):
        monkeypatch.setattr(contract, "KERNEL_DEVICES", ("cpu",))
    dtype = torch.float64 if how.get("float64") else torch.float32
    field, ode = _real_field(kind, D, dtype, how.get("hidden", H))
    if how.get("frozen"):
        ode.requires_grad_(False)
    init = torch.rand(*((3,) if how.get("rank3") else ()), B, D, dtype=dtype)
    if how.get("init_grad"):
        init.requires_grad_(True)
    routes = []
    with torch.set_grad_enabled(how.get("grad", False)):
        if how.get("vmap"):
            torch.func.vmap(lambda y: routes.append(contract.real_ab4_kernel(field, method, ode, y)) or y)(init[None])
        elif how.get("func_grad"):
            torch.func.grad(lambda y: routes.append(contract.real_ab4_kernel(field, method, ode, y)) or y.sum())(init)
        else:
            routes.append(contract.real_ab4_kernel(field, method, ode, init))
    assert routes == [want]


@pytest.mark.parametrize("D", [20, 4])
def test_the_decoder_takes_the_route_and_counts_its_rows(D, monkeypatch):
    """`real_decoder_apply` on the route (the CPU standing for a kernel device: its path is the plain recurrence)
    decodes as the plain solver does, in grad mode and out of it; a plain-route decode inside
    `roche_real_ab4.counting` adds its rows to the decoded rows and none to the kernel's."""
    spec = RealDecoderSpec(obs_dim=28, latent_dim=D, action_dim=1, static_dim=11, hidden_dim=H, t_max=97,
                           step_size=1.0, t0=24, ode_step_size=1.0 / N_SUB, ode_type="hybrid" if D > 4 else "expert")
    params = decoders.init_real_decoder(torch.Generator().manual_seed(0), spec, device="cpu")
    init = 0.5 * torch.randn(B, D, generator=torch.Generator().manual_seed(1))
    actions, statics = _actions(torch.float32), torch.zeros(TA, B, 11)
    plain_x, plain_h = decoders.real_decoder_apply(params, spec, init, actions, statics)
    rows = torch.zeros(2, dtype=torch.int64)
    with roche_real_ab4.counting(rows), torch.no_grad():
        decoders.real_decoder_apply(params, spec, init, actions, statics)
    assert rows.tolist() == [0, B]

    calls = []
    for name in ("roche_real_ab4", "roche_real_ab4_grad"):
        fn = getattr(roche_real_ab4, name)
        monkeypatch.setattr(roche_real_ab4, name, lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    monkeypatch.setattr(contract, "KERNEL_DEVICES", ("cpu",))
    x, h = decoders.real_decoder_apply(params, spec, init, actions, statics)
    with torch.no_grad():
        x_ng, h_ng = decoders.real_decoder_apply(params, spec, init, actions, statics)
    assert calls == ["roche_real_ab4_grad", "roche_real_ab4"]
    assert h.requires_grad and not h_ng.requires_grad
    for a, b in ((h, plain_h), (x, plain_x), (h_ng, plain_h), (x_ng, plain_x)):
        assert _rel(a.detach(), b.detach()) < 1e-5


@pytest.mark.parametrize("transform", ["vmap", "grad"])
def test_a_plain_decode_under_torch_func_counts_nothing(transform):
    """A `torch.func` transform (the vmapped restarts' gradients and validations) may write no tensor from outside:
    a plain-route decode there leaves the open count as it was and raises nothing."""
    spec = RealDecoderSpec(obs_dim=28, latent_dim=20, action_dim=1, static_dim=11, hidden_dim=H, t_max=97,
                           step_size=1.0, t0=24, ode_step_size=1.0 / N_SUB, ode_type="hybrid")
    params = decoders.init_real_decoder(torch.Generator().manual_seed(0), spec, device="cpu")
    init = 0.5 * torch.randn(B, 20, generator=torch.Generator().manual_seed(1))
    actions, statics = _actions(torch.float32), torch.zeros(TA, B, 11)

    def loss(y):
        return decoders.real_decoder_apply(params, spec, y, actions, statics)[0].sum()

    rows = torch.zeros(2, dtype=torch.int64)
    with roche_real_ab4.counting(rows):
        out = torch.func.vmap(loss)(init[None]) if transform == "vmap" else torch.func.grad(loss)(init)
    assert torch.isfinite(out).all() and rows.tolist() == [0, 0]


def test_the_real_ab4_source_builds_one_library_a_width_pair():
    """`roche_real_ab4` compiles once a (state, hidden) width pair, both macros set: one library each, named by both,
    built on first use (none among `TARGETS`), for every pair of `AB4_DIMS` and `AB4_HIDDEN`."""
    widths = [(20, 48), (4, 48), (32, 64), (4, 1)]
    libs = [build._target("roche_real_ab4", w) for w in widths]
    assert len({lib for _, lib, _ in libs}) == len(widths)
    for (D, Hw), (_, lib, flags) in zip(widths, libs):
        assert D in build.AB4_DIMS and Hw in build.AB4_HIDDEN
        assert f"roche_real_ab4_d{D}_h{Hw}-" in lib
        assert flags[-2:] == (f"-DROCHE_REAL_AB4_DIM={D}", f"-DROCHE_REAL_AB4_HIDDEN={Hw}")
    assert (build.AB4_DIMS[0], build.AB4_DIMS[-1], build.AB4_HIDDEN[0], build.AB4_HIDDEN[-1]) == (4, 32, 1, 64)
    assert not any(name == "roche_real_ab4" for name, _ in build.TARGETS)
