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

The field's parameters reach the backward as the leaves of `args` that
require grad (tensors, and the parameters of any `nn.Module` in the tree,
such as a `ParamTree`); frozen leaves and the dose context get no gradient.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

import torch

from .dopri5 import Dopri5Stats, finish, integrate, replay_step, start


def _grad_leaves(tree) -> list:
    """The tensors of `tree` that require grad, each once, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        found = [tree] if tree.requires_grad else []
    elif isinstance(tree, torch.nn.Module):
        found = [p for p in tree.parameters() if p.requires_grad]
    elif isinstance(tree, dict):
        found = [x for v in tree.values() for x in _grad_leaves(v)]
    elif isinstance(tree, (list, tuple)):
        found = [x for v in tree for x in _grad_leaves(v)]
    else:
        found = []
    return list({id(x): x for x in found}.values())


def _forward(field, y0, ts, args, rtol, atol, max_steps, max_record, barriers, per_row, record):
    """The recording solve, without gradient -> (solve, ys, stats, records or None).

    Records are (t, h_eff, t_new, y, valid), each stacked over R slots;
    `valid` (per row only) marks the slots a row has filled.
    """
    with torch.no_grad():
        s, carry = start(field, y0, ts, args, rtol, atol, barriers, per_row)
        steps = []
        carry = integrate(s, carry, max_steps, budget=max_steps, on_step=steps.append if record else None)
        out, stats = finish(s, carry)
        n_acc = carry[6]
        n_rec = torch.clamp(n_acc, max=max_record)  # every accepted step is recorded until the buffer is full
        recorded_all = n_rec == n_acc
        stats = stats._replace(recorded_all=recorded_all[..., 0] if per_row else recorded_all)
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
    @staticmethod
    def forward(ctx, config, y0, *leaves):
        s, out, stats, records = _forward(y0=y0, record=True, **config)
        ctx.solve, ctx.records = s, records
        ctx.save_for_backward(*leaves)
        flags = (stats.n_steps, stats.n_accepted, stats.success, stats.recorded_all)
        ctx.mark_non_differentiable(*flags)
        return (out, *flags)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, out_bar, *_):
        s, leaves = ctx.solve, ctx.saved_tensors
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
        # ys[0] is y0 itself.
        return (None, y_bar + out_bar[0], *leaf_bars)


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
    mode off, or neither `y0` nor any leaf of `args` requires grad) nothing
    is recorded, and the stats are the same.
    """
    if max_record is None:
        max_record = max_steps
    config = dict(field=field, ts=ts, args=args, rtol=rtol, atol=atol, max_steps=max_steps, max_record=max_record,
                  barriers=barriers, per_row=per_row)
    leaves = _grad_leaves(args)
    if torch.is_grad_enabled() and (y0.requires_grad or leaves):
        out, n_steps, n_acc, success, recorded_all = _Adjoint.apply(config, y0, *leaves)
        stats = Dopri5Stats(n_steps=n_steps, n_accepted=n_acc, success=success, recorded_all=recorded_all)
    else:
        _, out, stats, _ = _forward(y0=y0, record=False, **config)
    if max_record < max_steps and not bool(stats.recorded_all.all()):
        warnings.warn(
            "odeint_dopri5_adjoint: a solve accepted more steps than max_record; the backward pass leaves the "
            "overflow steps out of the gradients (stats.recorded_all=False). Raise max_record (it defaults to "
            "max_steps, which can never truncate).",
            RuntimeWarning,
            stacklevel=2,
        )
    return out, stats
