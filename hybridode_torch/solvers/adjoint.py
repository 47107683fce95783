"""DOPRI5 whose backward replays only the accepted steps.

Counterpart of `odeint_dopri5_adjoint` in hybridode/solvers/adjoint.py:195
(`_integrate_record` :54, `_fwd` / `_bwd` :147-189, `_warn_record_overflow`
:235). The gradients are the discretize-then-optimize gradients of
`odeint_dopri5`, computed another way:

* forward, without gradient: the port's own DOPRI5 trial steps
  (`dopri5.trial_step`), stopping once every row has finished or spent
  `max_steps` trial steps, as JAX's `while_loop` stops. Each accepted step
  of a row whose record count is under `max_record` is kept as (t, h_eff,
  t_new, y);
* backward: the records in reverse. Each one recomputes its step from `y`,
  first stage included (`dopri5.replay_step`), and one `torch.autograd.grad`
  pulls the cotangent of the step's end state and of the grid points it
  filled back to its start state and to the field's parameters. Rejected
  trial steps are never replayed.

The step sizes are constants of the backward, as they are for
`odeint_dopri5` (its controller runs without gradient). The grid `ts` gets
no gradient.

Both controller granularities: `per_row=False` (lockstep, one controller for
the whole state) and `per_row=True` (one per row, the counterpart of JAX's
`vmap` of one solve per patient). Per row, the records sit in slot-indexed
buffers of shape (R, *rows, ...), slot j of a row being its (j+1)-th
recorded step, R the largest record count; slot j's one vector-Jacobian
product covers every row that has a record there, and the cotangents of the
other rows are masked to zero.

The field's parameters reach the backward as the tensors of `args` that
require grad (tensors, and the parameters of any `nn.Module` in the tree,
such as a `ParamTree`); frozen leaves and the dose context get no gradient.

Under `torch.func.vmap` (JAX's vmap of its `custom_vjp`, the batched
restarts of hybridode/inference/fused.py:385) the solver's `vmap` rule
solves the lanes one after the other, each as the plain solve of that lane's
state and tensors (`args` seen as nests of dicts), and stacks the results.
So each lane takes its own solve's steps and gets its gradients by
construction; the solves read the host as the plain one does (they run
outside the vmap), and the overflow warning comes once a call when any lane
overflowed.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

import torch

from .dopri5 import Dopri5Stats, finish, integrate, replay_step, start


def _flatten(tree):
    """-> (the distinct tensors of `tree` in a fixed order, `build`): `build(tensors)` is the tree with `tensors` in
    their places. An `nn.Module` becomes the nest of dicts (lists for a `ModuleList`) of its parameters, buffers
    and submodules, which the fields read as they read a `ParamTree`."""
    tensors, index = [], {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            i = index.setdefault(id(x), len(tensors))
            if i == len(tensors):
                tensors.append(x)
            return lambda ts: ts[i]
        if isinstance(x, torch.nn.ModuleList):
            x = list(x)
        elif isinstance(x, torch.nn.Module):
            x = {k: v for part in (x._parameters, x._buffers, x._modules) for k, v in part.items() if v is not None}
        if isinstance(x, dict):
            parts = {k: walk(v) for k, v in x.items()}
            return lambda ts: {k: p(ts) for k, p in parts.items()}
        if isinstance(x, (list, tuple)):
            parts = [walk(v) for v in x]
            if hasattr(x, "_fields"):  # a NamedTuple such as the dose context
                return lambda ts: type(x)(*(p(ts) for p in parts))
            return lambda ts: type(x)(p(ts) for p in parts)
        return lambda ts: x

    return tensors, walk(tree)


class _Static:
    """What a solve's `_Adjoint` carries besides its tensors: the field and its `args`, the solver's settings,
    whether grad mode was on (a solve records its steps only then, and only when a tensor needs a gradient), and
    whether the solve warns of a record overflow itself (a lane of a vmapped call leaves that to the call).
    `saved` hands the forward's records to `setup_context`."""

    def __init__(self, field, args, build, config, record: bool, warn: bool = True):
        self.field, self.args, self.build, self.config = field, args, build, config
        self.record, self.warn, self.saved = record, warn, None


def _warn_record_overflow(config, recorded_all):
    if config["max_record"] < config["max_steps"] and not bool(recorded_all.all()):
        warnings.warn(
            "odeint_dopri5_adjoint: a solve accepted more steps than max_record; the backward pass leaves the "
            "overflow steps out of the gradients (stats.recorded_all=False). Raise max_record (it defaults to "
            "max_steps, which can never truncate).",
            RuntimeWarning,
            stacklevel=2,
        )


def _forward(static: _Static, y0, tensors):
    """The recording solve, without gradient -> (solve, ys, stats, records or None).

    Records are (t, h_eff, t_new, y, valid), each stacked over R slots;
    `valid` (per row only) marks the slots a row has filled.
    """
    c = static.config
    per_row, max_record = c["per_row"], c["max_record"]
    record = static.record and (y0.requires_grad or any(x.requires_grad for x in tensors))
    with torch.no_grad():
        s, carry = start(static.field, y0, c["ts"], static.args, c["rtol"], c["atol"], c["barriers"], per_row)
        steps = []
        carry = integrate(s, carry, c["max_steps"], budget=c["max_steps"],
                          on_step=steps.append if record else None)
        out, stats = finish(s, carry)
        n_acc = carry[6]
        n_rec = torch.clamp(n_acc, max=max_record)  # every accepted step is recorded until the buffer is full
        recorded_all = n_rec == n_acc
        stats = stats._replace(recorded_all=recorded_all[..., 0] if per_row else recorded_all)
        if static.warn:
            _warn_record_overflow(c, stats.recorded_all)
        if not record:
            return s, out, stats, None
        n_slots = int(n_rec.max()) if steps else 0
        if n_slots == 0:
            return s, out, stats, (None,) * 5
        t, h, t_new, y, take = (torch.stack(x) for x in zip(*steps))  # (N, *rows[, D]) over the N trial steps run
        # Trial steps in record order: a row's recorded steps first, each row's own sequence.
        order = torch.argsort((~take).to(torch.int8), dim=0, stable=True)[:n_slots]

        def slot(x):
            index = order.reshape(order.shape + (1,) * (x.ndim - order.ndim))
            return torch.gather(x, 0, index.expand((n_slots,) + x.shape[1:]))

        valid = None
        if per_row:
            valid = torch.arange(n_slots, device=y0.device).reshape((-1,) + (1,) * n_rec.ndim) < n_rec
        return s, out, stats, (slot(t), slot(h), slot(t_new), slot(y), valid)


class _Adjoint(torch.autograd.Function):
    """(static, y0, *tensors of args) -> (ys, n_steps, n_accepted, success, recorded_all).

    Under `torch.func.vmap` (the batched restarts) its `vmap` rule applies the
    plain `_Adjoint` to each lane's slices in turn and stacks the outputs, so
    each lane takes the steps and gets the gradients of its solve alone.
    """

    @staticmethod
    def forward(static, y0, *tensors):
        s, out, stats, records = _forward(static, y0, tensors)
        static.saved = s, records
        return out, stats.n_steps, stats.n_accepted, stats.success, stats.recorded_all

    @staticmethod
    def setup_context(ctx, inputs, output):
        static = inputs[0]
        ctx.solve, ctx.records = static.saved
        static.saved = None
        ctx.save_for_backward(*inputs[2:])
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, out_bar, *_):
        if ctx.records is None:
            raise RuntimeError("odeint_dopri5_adjoint: this solve recorded no step for a backward pass")
        s, tensors = ctx.solve, ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        leaves = [x for x, n in zip(tensors, need) if n]
        rec_t, rec_h, rec_tn, rec_y, valid = ctx.records
        y_bar = torch.zeros_like(out_bar[0])
        leaf_bars = [torch.zeros_like(x) for x in leaves]
        zero = torch.zeros((), dtype=out_bar.dtype, device=out_bar.device)
        n_slots = 0 if rec_t is None else rec_t.shape[0]
        for j in reversed(range(n_slots)):
            t_i, h_i = rec_t[j], rec_h[j]
            fill = (s.ts_b > t_i) & (s.ts_b <= rec_tn[j])
            y_ct = y_bar
            if valid is not None:  # rows without a record in this slot contribute nothing
                fill = fill & valid[j]
                y_ct = torch.where(valid[j], y_bar, zero)
            with torch.enable_grad():
                y_i = rec_y[j].detach().requires_grad_()
                y1, dense = replay_step(s, t_i, y_i, h_i)
                grads = torch.autograd.grad((y1, dense), (y_i, *leaves), (y_ct, torch.where(fill, out_bar, zero)),
                                            allow_unused=True)
            y_bar = grads[0] if valid is None else torch.where(valid[j], grads[0], y_bar)
            for acc, g in zip(leaf_bars, grads[1:]):
                if g is not None:
                    acc += g
        bars = iter(leaf_bars)
        # ys[0] is y0 itself.
        return (None, y_bar + out_bar[0], *(next(bars) if n else None for n in need))

    @staticmethod
    def vmap(info, in_dims, static, y0, *tensors):
        for name in ("ts", "barriers"):
            x = static.config[name]
            if torch.is_tensor(x) and torch._C._functorch.is_functorch_wrapped_tensor(x):
                raise NotImplementedError(f"odeint_dopri5_adjoint under torch.func.vmap with a batched {name}")

        def lane(x, d, r):
            return x if d is None else x.select(d, r)

        outs = []
        for r in range(info.batch_size):
            mine = [lane(x, d, r) for x, d in zip(tensors, in_dims[2:])]
            solo = _Static(static.field, static.build(mine), static.build, static.config, static.record, warn=False)
            outs.append(_Adjoint.apply(solo, lane(y0, in_dims[1], r), *mine))
        out = tuple(torch.stack(x) for x in zip(*outs))
        _warn_record_overflow(static.config, out[-1])
        return out, (0,) * len(out)


def odeint_dopri5_adjoint(
    field,
    y0: torch.Tensor,
    ts,
    args: Any = None,
    *,
    rtol: float = 1e-7,
    atol: float = 1e-8,
    max_steps: int = 256,
    max_record: Optional[int] = None,
    barriers=None,
    per_row: bool = False,
):
    """Drop-in for `odeint_dopri5` whose backward replays the accepted steps only -> (ys, stats).

    `max_record` bounds the accepted steps kept for the backward pass (per
    row with `per_row=True`); it defaults to `max_steps`, which can never
    truncate. A solve that accepts more leaves the overflow steps out of its
    gradients and reports `stats.recorded_all` False; with `max_record <
    max_steps` such a solve also raises a RuntimeWarning naming
    `max_record` (one host read a solve). When no gradient is needed (grad
    mode off, or neither `y0` nor any tensor of `args` requires grad) nothing
    is recorded, and the stats are the same. Under `torch.func.vmap` each lane
    is a solve of its own (the module docstring).
    """
    if max_record is None:
        max_record = max_steps
    config = dict(ts=ts, rtol=rtol, atol=atol, max_steps=max_steps, max_record=max_record, barriers=barriers,
                  per_row=per_row)
    tensors, build = _flatten(args)
    static = _Static(field, args, build, config, record=torch.is_grad_enabled())
    out, n_steps, n_acc, success, recorded_all = _Adjoint.apply(static, y0, *tensors)
    return out, Dopri5Stats(n_steps=n_steps, n_accepted=n_acc, success=success, recorded_all=recorded_all)
