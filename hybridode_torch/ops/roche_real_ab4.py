"""The real track's explicit-Adams solve of `roche_real_field`, with and without gradients: CUDA kernels and plain
versions.

The kernels (`csrc/roche_real_ab4.cu`) replace no TPU kernel. They compute
`odeint_fixed(roche_real_field, y0, ts, (params, CumDoseContext(actions)),
method="explicit_adams", n_substeps=n)` for a (B, D) state: RK4 on the first
three substeps, AB4 after, in the order `odeint_fixed` takes them. Eager, or
as a CUDA graph, that solve is some 40 small kernels a field evaluation
forward and twice that backward, ~155 evaluations a decode at two substeps an
hour; here it is one launch forward and one backward. `contract.real_ab4_kernel`
routes a decode to them.

`roche_real_ab4` is the solve without gradients, one launch; on CPU tensors it
runs the plain recurrence `solve_recurrence`. `roche_real_ab4_grad` is the
same solve with gradients for y0 and every leaf of the field (the rate
constants and the GRU included), one `torch.autograd.Function`: its forward
also records the state at the start of each substep, (B, N, D) floats for N
substeps; its backward runs the discrete adjoint of the recorded substeps in
reverse (`backward_recurrence`), each field evaluation recomputed from its
recorded state, and sums the rows' partial parameter gradients in PyTorch's
fixed order of a reduction (no float atomics: two backward passes agree bit
for bit). The gradients are the plain solver's, discretize-then-optimize: equal,
to rounding, to autograd through `odeint_fixed`. On CPU tensors both run the
plain recurrences, the kernels' arithmetic in PyTorch. Each CUDA forward launch
adds one to `roche_real_ab4.launches` or to `roche_real_ab4_grad.launches`.

A decode inside `counting(rows)` adds its rows to `rows`, a (2,) int64 device
tensor: the kernel adds them to both entries (rows it solved, rows decoded) on
the device, and a decode on the plain route calls `count_plain`, which adds
them to the second (outside `torch.func` transforms, where nothing is
counted). The fused loop's graphs hold one such tensor each.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..fields import CumDoseContext, roche_real_field
from ..solvers import tableaus
from ..solvers.fixed_step import odeint_fixed
from . import build

# The field's leaves in the kernels' packed order: the two MLPs (first layer w (in, H), b (H,); second layer w (H, 1),
# b (1,)), the three rate constants, then the GRU's three (D-4, D-4) weights when D > 4.
MLP_LEAVES = tuple(f"{net}.{i}.{k}" for net in ("dx1_net", "dx2_net") for i in (0, 1) for k in ("w", "b"))
RATE_LEAVES = ("k_immunity", "kel", "kel2")
GRU_LEAVES = ("lin_hr.w", "lin_hz.w", "lin_hh.w")
EXPERT_DIM = 4

_ROWS = None  # the open (2,) int64 count of `counting`: [rows the kernel solved, rows decoded]
# The argument types of the two launch functions of a library (one a (D, H) pair).
_SOLVE_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BACKWARD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


@contextlib.contextmanager
def counting(rows: torch.Tensor):
    """Every decode of the real field inside adds its rows to `rows` (2,) int64, on the device (module docstring)."""
    global _ROWS
    outer, _ROWS = _ROWS, rows
    try:
        yield rows
    finally:
        _ROWS = outer


def count_plain(n_rows: int) -> None:
    """A decode of `n_rows` rows on the plain route: add them to the decoded rows of the open count, if any. Not
    inside a `torch.func` transform (`--restart_mode vmap`), which may write no tensor from outside: nothing is
    counted there."""
    if _ROWS is not None and torch._C._functorch.maybe_current_level() is None:
        _ROWS[1].add_(n_rows)


def field_leaves(ode) -> tuple:
    """The field's leaves (`roche_real_field`'s params) in the kernels' packed order."""
    names = MLP_LEAVES + RATE_LEAVES + (GRU_LEAVES if "lin_hr" in ode else ())
    return tuple(_leaf(ode, name) for name in names)


def _leaf(tree, name):
    for key in name.split("."):
        tree = tree[int(key)] if key.isdigit() else tree[key]
    return tree


def _params(leaves) -> dict:
    """The leaves as `roche_real_field`'s params."""
    mlp = {}
    for name, leaf in zip(MLP_LEAVES, leaves):
        net, i, k = name.split(".")
        mlp.setdefault(net, [{}, {}])[int(i)][k] = leaf
    p = dict(mlp, **dict(zip(RATE_LEAVES, leaves[8:11])))
    p.update({name.split(".")[0]: {"w": leaf} for name, leaf in zip(GRU_LEAVES, leaves[11:])})
    return p


def roche_real_ab4_reference(y0, actions, ode, ts, n_substeps: int):
    """Plain PyTorch version: `odeint_fixed(roche_real_field, method="explicit_adams")` on the same inputs."""
    return odeint_fixed(roche_real_field, y0, ts, (ode, CumDoseContext(actions=actions)), method="explicit_adams",
                        n_substeps=n_substeps)


def roche_real_ab4(y0, actions, ode, ts, n_substeps: int):
    """The explicit-Adams solve of `roche_real_field` from each row of `y0`, without gradients -> (T, B, D).

    Args:
      y0: (B, D) initial latents (4 expert states + a D-4 wide GRU), D in `build.AB4_DIMS` and the field's hidden
        width in `build.AB4_HIDDEN` on CUDA.
      actions: (Ta, B, A) the whole action sequence (the depot's doses at hours 1 ... Ta).
      ode: the field's parameter tree (`init_roche_real_field`).
      ts: (T,) output grid, each interval split into `n_substeps` equal substeps.
    """
    leaves = field_leaves(ode)
    if y0.device.type == "cpu":
        return solve_recurrence(y0, actions, leaves, ts, n_substeps)[0]
    out, _ = _solve(y0, actions, leaves, ts, n_substeps, record=False)
    roche_real_ab4.launches += 1
    return out


roche_real_ab4.launches = 0


def roche_real_ab4_grad(y0, actions, ode, ts, n_substeps: int):
    """`roche_real_ab4` with gradients for `y0` and every leaf of `ode`: one recording launch forward, one launch
    backward on CUDA; the plain recurrences on CPU tensors."""
    return _RealAB4Grad.apply(y0, actions, ts, int(n_substeps), *field_leaves(ode))


roche_real_ab4_grad.launches = 0


class _RealAB4Grad(torch.autograd.Function):
    """The recording solve forward, the discrete adjoint of its substeps backward."""

    @staticmethod
    def forward(ctx, y0, actions, ts, n_substeps, *leaves):
        if y0.device.type == "cpu":
            out, record = solve_recurrence(y0, actions, leaves, ts, n_substeps, record=True)
        else:
            out, record = _solve(y0, actions, leaves, ts, n_substeps, record=True)
            roche_real_ab4_grad.launches += 1
        ctx.n_substeps = n_substeps
        ctx.save_for_backward(actions, ts, record, *leaves)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        actions, ts, record, *leaves = ctx.saved_tensors
        run = backward_recurrence if record.device.type == "cpu" else backward
        dy0, dleaves = run(actions, leaves, ts, ctx.n_substeps, record, g_out)
        return dy0, None, None, None, *dleaves


# ---- The kernels ------------------------------------------------------------------------------------------------


def _check(y0, actions, leaves, ts, n_substeps) -> tuple[int, int, int]:
    """Raise unless the kernels take these arguments -> (D, H, number of substeps)."""
    if y0.dim() != 2 or actions.dim() != 3 or ts.dim() != 1:
        raise ValueError(f"y0 (B, D), actions (Ta, B, A) and ts (T,), got {tuple(y0.shape)}, "
                         f"{tuple(actions.shape)}, {tuple(ts.shape)}")
    B, D = y0.shape
    H = leaves[0].shape[-1]
    if D not in build.AB4_DIMS or H not in build.AB4_HIDDEN:
        raise ValueError(f"the kernels take {build.AB4_DIMS[0]} <= D <= {build.AB4_DIMS[-1]} states and "
                         f"{build.AB4_HIDDEN[0]} <= H <= {build.AB4_HIDDEN[-1]} hidden units, got {(D, H)}")
    if B < 1 or actions.shape[1] != B or ts.shape[0] < 2 or int(n_substeps) < 1:
        raise ValueError(f"B={B} rows, actions {tuple(actions.shape)}, {ts.shape[0]} grid points, "
                         f"{n_substeps} substeps")
    for name, t in (("actions", actions), ("ts", ts), *zip(MLP_LEAVES + RATE_LEAVES + GRU_LEAVES, leaves)):
        if t.device != y0.device or t.dtype != torch.float32 or y0.dtype != torch.float32:
            raise TypeError(f"y0 and {name} must be float32 on one device, got {y0.dtype} on {y0.device} and "
                            f"{t.dtype} on {t.device}")
    if actions.requires_grad or ts.requires_grad:
        raise RuntimeError("actions and ts get no gradient from the kernels")
    return D, H, (ts.shape[0] - 1) * int(n_substeps)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _solve(y0, actions, leaves, ts, n_substeps, record: bool):
    """One forward launch, recording or not -> (out (T, B, D), record (B, N, D) or None)."""
    D, H, N = _check(y0, actions, leaves, ts, n_substeps)
    B, T = y0.shape[0], ts.shape[0]
    y0, actions, ts = y0.detach().contiguous(), actions.detach().contiguous(), ts.detach().contiguous()
    weights = torch.cat([leaf.detach().reshape(-1) for leaf in leaves])
    out = torch.empty((T, B, D), dtype=torch.float32, device=y0.device)
    steps = torch.empty((B, N, D), dtype=torch.float32, device=y0.device) if record else None
    launch = build.c_function(build.load("roche_real_ab4", (D, H)), "roche_real_ab4_launch", _SOLVE_ARGS)
    launch(y0.data_ptr(), actions.data_ptr(), weights.data_ptr(), ts.data_ptr(), out.data_ptr(),
           None if steps is None else steps.data_ptr(), None if _ROWS is None else _ROWS.data_ptr(), B, D, H,
           actions.shape[0], actions.shape[2], T, int(n_substeps), _stream(y0.device))
    return out, steps


def recorded_solve(y0, actions, ode, ts, n_substeps: int):
    """The recording forward launch alone, on CUDA tensors -> (ys (T, B, D), record (B, N, D)): `record[b, n]` is
    row b's state at the start of substep n. `ys` are `roche_real_ab4`'s bit for bit."""
    return _solve(y0, actions, field_leaves(ode), ts, n_substeps, record=True)


def backward(actions, leaves, ts, n_substeps, record, g_out):
    """The backward launch: (dy0, the leaves' gradients) of a recorded solve whose output has gradient `g_out`. The
    rows' partial gradients are summed in PyTorch's fixed order of a reduction."""
    B, N, D = record.shape
    H, T = leaves[0].shape[-1], ts.shape[0]
    g_out = g_out.to(torch.float32).contiguous()
    if g_out.shape != (T, B, D):
        raise ValueError(f"the output's gradient has shape {tuple(g_out.shape)}, not {(T, B, D)}")
    weights = torch.cat([leaf.detach().reshape(-1) for leaf in leaves])
    dy0 = torch.empty((B, D), dtype=torch.float32, device=record.device)
    dparams = torch.empty((B, weights.numel()), dtype=torch.float32, device=record.device)
    launch = build.c_function(build.load("roche_real_ab4", (D, H)), "roche_real_ab4_backward_launch", _BACKWARD_ARGS)
    launch(actions.data_ptr(), weights.data_ptr(), ts.data_ptr(), record.data_ptr(), g_out.data_ptr(),
           dy0.data_ptr(), dparams.data_ptr(), B, D, H, actions.shape[0], actions.shape[2], T, int(n_substeps),
           _stream(record.device))
    total, dleaves, at = dparams.sum(dim=0), [], 0
    for leaf in leaves:
        dleaves.append(total[at : at + leaf.numel()].reshape(leaf.shape))
        at += leaf.numel()
    return dy0, dleaves


def kernel_info(D: int, H: int, backward_kernel: bool = False) -> dict:
    """Registers and local (spill) bytes a thread of the built (D, H) forward or backward kernel."""
    return build.kernel_info(build.load("roche_real_ab4", (D, H)), "roche_real_ab4_kernel_info", int(backward_kernel),
                             D, H)


# ---- The plain recurrences: the kernels' arithmetic in PyTorch -------------------------------------------------


def _grid(ts, n_substeps):
    """-> [(n, t, dt)] for every substep n, with t and dt as `odeint_fixed` forms them (0-d tensors)."""
    steps, n = [], 0
    for i in range(ts.shape[0] - 1):
        dt = (ts[i + 1] - ts[i]) / n_substeps
        for s in range(n_substeps):
            steps.append((n, ts[i] + dt * s, dt))
            n += 1
    return steps


def _field(t, y, p, actions):
    """`roche_real_field` with what its vector-Jacobian product needs -> (f (B, D), cache)."""
    x = y[:, :3]
    h1 = torch.tanh(x @ p["dx1_net"][0]["w"] + p["dx1_net"][0]["b"])
    h2 = torch.tanh(x[:, :2] @ p["dx2_net"][0]["w"] + p["dx2_net"][0]["b"])
    f0 = torch.tanh(h1 @ p["dx1_net"][1]["w"] + p["dx1_net"][1]["b"])[:, 0]
    f1 = torch.tanh(h2 @ p["dx2_net"][1]["w"] + p["dx2_net"][1]["b"])[:, 0]
    hours = torch.arange(1, actions.shape[0] + 1, dtype=y.dtype, device=y.device)[:, None, None]
    delta = hours - t
    terms = torch.where(t >= hours, actions * torch.exp(p["kel"] * delta), torch.zeros((), dtype=y.dtype))
    dose, ddose = terms.sum(dim=(0, 2)), (terms * delta).sum(dim=(0, 2))  # the depot and its derivative in kel
    f = [f0, f1, y[:, 1] * p["k_immunity"], p["kel"] * dose - p["kel2"] * y[:, 3]]
    cache = dict(h1=h1, h2=h2, f0=f0, f1=f1, dose=dose, ddose=ddose)
    if "lin_hr" in p:
        h = y[:, EXPERT_DIM:]
        r = torch.sigmoid(h @ p["lin_hr"]["w"])
        z = torch.sigmoid(h @ p["lin_hz"]["w"])
        u = torch.tanh((r * h) @ p["lin_hh"]["w"])
        cache.update(r=r, z=z, u=u)
        return torch.cat([torch.stack(f, dim=-1), (1 - z) * (u - h)], dim=-1), cache
    return torch.stack(f, dim=-1), cache


def _field_vjp(t, y, c, p, actions, grads: dict):
    """c J(y) of `roche_real_field` at (t, y), and c's products with its derivatives in the leaves, summed over the
    rows, added to `grads` (keyed as `MLP_LEAVES` + `RATE_LEAVES` + `GRU_LEAVES`) -> the state's cotangent (B, D)."""
    _, k = _field(t, y, p, actions)
    x = y[:, :3]
    ax = torch.zeros_like(y)
    for net, width, col in (("dx1_net", 3, 0), ("dx2_net", 2, 1)):
        hid = k["h1"] if net == "dx1_net" else k["h2"]
        go = c[:, col] * (1 - k["f0" if col == 0 else "f1"] ** 2)  # (B,)
        grads[f"{net}.1.w"] += (hid * go[:, None]).sum(0)[:, None]
        grads[f"{net}.1.b"] += go.sum(0, keepdim=True)
        gpre = go[:, None] * p[net][1]["w"][:, 0] * (1 - hid * hid)  # (B, H)
        grads[f"{net}.0.w"] += x[:, :width].T @ gpre
        grads[f"{net}.0.b"] += gpre.sum(0)
        ax[:, :width] += gpre @ p[net][0]["w"].T
    ax[:, 1] += c[:, 2] * p["k_immunity"]
    ax[:, 3] -= c[:, 3] * p["kel2"]
    grads["k_immunity"] += (c[:, 2] * y[:, 1]).sum()
    grads["kel"] += (c[:, 3] * (k["dose"] + p["kel"] * k["ddose"])).sum()
    grads["kel2"] -= (c[:, 3] * y[:, 3]).sum()
    if "lin_hr" in p:
        h, ch, r, z, u = y[:, EXPERT_DIM:], c[:, EXPERT_DIM:], k["r"], k["z"], k["u"]
        gpu = ch * (1 - z) * (1 - u * u)
        grads["lin_hh.w"] += (r * h).T @ gpu
        grh = gpu @ p["lin_hh"]["w"].T
        gpr = grh * h * r * (1 - r)
        gpz = -ch * (u - h) * z * (1 - z)
        grads["lin_hr.w"] += h.T @ gpr
        grads["lin_hz.w"] += h.T @ gpz
        ax[:, EXPERT_DIM:] += (-ch * (1 - z) + grh * r + gpr @ p["lin_hr"]["w"].T + gpz @ p["lin_hz"]["w"].T)
    return ax


def _rk4(t, y, dt, k1, p, actions):
    """RK4's stage states and stages from k1 = f(t, y), as `odeint_fixed`'s `_rk_step` forms them."""
    C, A, _ = tableaus.FIXED_TABLEAUS["rk4"]
    ys, ks = [y], [k1]
    for i in (1, 2, 3):
        ys.append(y + dt * (ks[i - 1] * float(A[i][i - 1])))
        ks.append(_field(t + float(C[i]) * dt, ys[i], p, actions)[0])
    return ys, ks


def solve_recurrence(y0, actions, leaves, ts, n_substeps: int, record: bool = False):
    """The forward kernel's recurrence in PyTorch -> (out (T, B, D), record (B, N, D) of the state at the start of
    each substep, or None)."""
    p, ab = _params(leaves), [float(c) for c in tableaus.AB4_COEFFS]
    B = tableaus.FIXED_TABLEAUS["rk4"][2]
    y, hist, outs, states = y0, [], [y0], []
    for n, t, dt in _grid(ts, n_substeps):
        states.append(y)
        f = _field(t, y, p, actions)[0]
        hist = [f] + hist[:3]
        if n >= 3:
            y = y + dt * sum(c * h for c, h in zip(ab, hist))
        else:
            _, ks = _rk4(t, y, dt, f, p, actions)
            y = y + dt * sum(k * float(b) for k, b in zip(ks, B))
        if (n + 1) % n_substeps == 0:
            outs.append(y)
    return torch.stack(outs), torch.stack(states, dim=1) if record else None


def backward_recurrence(actions, leaves, ts, n_substeps: int, record, g_out):
    """The backward kernel's recurrence in PyTorch: the discrete adjoint of `solve_recurrence`'s substeps, walked in
    reverse from their recorded states -> (dy0, the leaves' gradients)."""
    p, ab = _params(leaves), [float(c) for c in tableaus.AB4_COEFFS]
    C, A, B = tableaus.FIXED_TABLEAUS["rk4"]
    names = MLP_LEAVES + RATE_LEAVES + GRU_LEAVES
    grads = {name: torch.zeros_like(leaf) for name, leaf in zip(names, leaves)}
    a = torch.zeros_like(record[:, 0])
    pending = [torch.zeros_like(a) for _ in range(4)]  # the cotangents of f_n, f_{n-1}, f_{n-2}, f_{n-3}
    for n, t, dt in reversed(_grid(ts, n_substeps)):
        if (n + 1) % n_substeps == 0:
            a = a + g_out[(n + 1) // n_substeps]
        y = record[:, n]
        if n >= 3:  # y_{n+1} = y_n + dt sum_q AB4[q] f_{n-q}
            pending = [b + dt * c * a for b, c in zip(pending, ab)]
            a = a + _field_vjp(t, y, pending[0], p, actions, grads)
        else:  # y_{n+1} = y_n + dt sum_i B[i] k_i, k_1 = f_n, whose AB4 cotangent is pending[0]
            ys, ks = _rk4(t, y, dt, _field(t, y, p, actions)[0], p, actions)
            a_next, gy = a, None
            for i in (3, 2, 1):
                gk = dt * float(B[i]) * a_next + (0 if gy is None else dt * float(A[i + 1][i]) * gy)
                gy = _field_vjp(t + float(C[i]) * dt, ys[i], gk, p, actions, grads)
                a = a + gy
            gk1 = dt * float(B[0]) * a_next + dt * float(A[1][0]) * gy + pending[0]
            a = a + _field_vjp(t, y, gk1, p, actions, grads)
        pending = pending[1:] + [torch.zeros_like(a)]
    return a + g_out[0], [grads[name] for name in names[: len(leaves)]]
