"""The Roche kernels' contract (`roche_rk4`, `roche_dopri5`): which decode a kernel computes (`roche_kernel`, from
what it observes, with no switch), and the arguments both take (`check`) and their plain versions solve."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ROCHE_PARAM_NAMES
from ..fields import FROZEN_KEYS, DoseContext
from .build import WIDTHS

KERNEL_DEVICES = ("cuda",)  # the device types the kernels run on
MAX_GRID = 8192  # ts is staged in the block's shared memory (48 KB without opt-in)


def roche_kernel(solve: Optional[str], ode, init, ctx) -> Optional[str]:
    """The kernel that computes a decode, or None.

    `solve` is the decode the decoder asks of the Roche field without ablation: "dopri5" (per-patient DOPRI5 off the
    adjoint solver), "rk4", or None. A kernel takes it on a state of a width in `WIDTHS` with one dose a row, on a
    device of `KERNEL_DEVICES` and outside any `torch.func` transform (the kernels read raw device pointers): where
    no gradient is needed, the kernel of `solve`; where one is, "dopri5_grad" for a per-patient DOPRI5 decode whose
    frozen leaves (`FROZEN_KEYS`, the expert constants) need none, else None.
    """
    takes = (solve is not None and init.shape[-1] in WIDTHS and ctx.times.shape[-1] == 1
             and init.device.type in KERNEL_DEVICES and not torch._C._functorch.is_functorch_wrapped_tensor(init)
             and torch._C._functorch.maybe_current_level() is None)
    if not takes:
        return None
    if not torch.is_grad_enabled() or not (init.requires_grad or any(p.requires_grad for p in ode.parameters())):
        return solve
    frozen = [p for name, p in ode.named_parameters() if name.partition(".")[0] in FROZEN_KEYS]
    return "dopri5_grad" if solve == "dopri5" and not any(p.requires_grad for p in frozen) else None


def decode_inputs(ode, init, ctx, ts) -> tuple:
    """A decode's arguments as both kernels take them: (y0, times, amounts, expert_params, ml_w, ml_b, ts)."""
    ml = ode["ml_net"][0] if "ml_net" in ode else {"w": None, "b": None}
    y0, times, amounts = init.contiguous(), ctx.times[:, 0].contiguous(), ctx.amounts.contiguous()
    return y0, times, amounts, ode["expert"], ml["w"], ml["b"], ts


def field_args(times, amounts, expert_params, ml_w, ml_b) -> tuple:
    """The Roche field's (params, DoseContext) that the kernels' arguments stand for: what the plain versions solve."""
    params = {"expert": {name: expert_params[name] for name in ROCHE_PARAM_NAMES}}
    if ml_w is not None:
        params["ml_net"] = [{"w": ml_w, "b": ml_b}]
    return params, DoseContext(times=times[:, None], amounts=amounts)


def constants(expert_params, y0) -> torch.Tensor:
    """The 13 expert constants (13,), in `ROCHE_PARAM_NAMES`' order, for a launch on `y0`'s device: a CUDA one."""
    if y0.device.type != "cuda":
        raise ValueError(f"the Roche kernels run on CUDA or CPU tensors, not {y0.device}")
    return torch.stack([expert_params[name].reshape(()) for name in ROCHE_PARAM_NAMES])


def check(y0, times, amounts, params, ml_w, ml_b, ts) -> tuple[int, int, int]:
    """Raise unless the arguments are ones both kernels take (`params` the stacked constants) -> (B, D, T)."""
    if y0.dim() != 2:
        raise ValueError(f"y0 must be (B, D), got {tuple(y0.shape)}")
    B, D = y0.shape
    if D not in WIDTHS:
        raise ValueError(f"the kernels take {WIDTHS[0]} <= D <= {WIDTHS[-1]} latent states, got D={D}")
    if B < 1:
        raise ValueError("empty batch")
    ml_dim = D - 4
    if (ml_w is None) != (ml_dim == 0) or (ml_b is None) != (ml_dim == 0):
        raise ValueError(f"D={D} needs ml_w (D, {ml_dim}) and ml_b ({ml_dim},) exactly when D > 4")
    T = ts.shape[0] if ts.dim() == 1 else -1
    if not 1 <= T <= MAX_GRID:
        raise ValueError(f"ts must be (T,) with 1 <= T <= {MAX_GRID}, got {tuple(ts.shape)}")
    shapes = {"y0": (y0, (B, D)), "ts": (ts, (T,)), "times": (times, (B,)), "amounts": (amounts, (B,)),
              "expert_params": (params, (13,))}
    if ml_dim:
        shapes.update(ml_w=(ml_w, (D, ml_dim)), ml_b=(ml_b, (ml_dim,)))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != y0.device:
            raise ValueError(f"{name} is on {t.device}, y0 on {y0.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{name} requires grad: the kernel is forward-only, call it under torch.no_grad()")
    return B, D, T
