#!/usr/bin/env python3
"""How far a lockstep DOPRI5 solve of the Roche field moves when only the order of its batch changes.

    python3 lockstep_order_study.py [--patients 8] [--orders 3] [--device cpu|cuda] [--out RESULT.json]

One controller serves the whole batch through the RMS error norm over every
element, so permuting the patients changes nothing but the order of that
sum, and with it the last bits of the norm. The dose jumps of the forcing
make the step sequence sensitive to those bits. For each tolerance (the
CLI's rtol 1e-7 / atol 1e-8, and rtol 1e-10 / atol 1e-12) the script solves
the first `--patients` training patients of data_s123 in float64 with the
adjoint solver (the field's seed-0 initialisation, initial states as
`tests/test_torch_cuda_lockstep.py` draws them), once in their order and
once for each of `--orders` random permutations, and prints one JSON object:
the trial and accepted steps of each solve, and for each permutation the
largest absolute difference of the trajectory and the largest relative
differences of the gradients of sum(ys[1:]**2) with respect to y0 and to the
ml remainder's weights. JAX-free.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from hybridode_torch.data import SyntheticCohort
from hybridode_torch.fields import doses_from_actions, init_roche_field, roche_field
from hybridode_torch.solvers import odeint_dopri5_adjoint

COHORT = os.path.join("data_s123", "datafile_dose_exp.pkl")
TOLERANCES = ((1e-7, 1e-8), (1e-10, 1e-12))


def solve(y0, ctx, params, perm, rtol, atol):
    """The permuted batch's solve, its results put back in the original order."""
    params.zero_grad(set_to_none=True)
    y = y0[perm].clone().requires_grad_()
    ys, st = odeint_dopri5_adjoint(roche_field, y, torch.arange(15.0, dtype=torch.float64, device=y0.device),
                                   (params, type(ctx)(ctx.times[perm], ctx.amounts[perm])), rtol=rtol, atol=atol,
                                   max_steps=4096)
    (ys[1:] ** 2).sum().backward()
    inv = torch.argsort(perm)
    grads = {n: p.grad.clone() for n, p in params.named_parameters() if p.grad is not None}
    return ys.detach()[:, inv], y.grad[inv], grads, int(st.n_steps), int(st.n_accepted)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--patients", type=int, default=8)
    parser.add_argument("--orders", type=int, default=3)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    B, device = args.patients, torch.device(args.device)
    cohort = SyntheticCohort.load(COHORT, device="cpu")
    ctx = doses_from_actions(cohort.get_split("train", B, 0)["actions"].double(), 1.0)
    ctx = type(ctx)(*(x.to(device) for x in ctx))
    gen = torch.Generator().manual_seed(0)
    params = init_roche_field(gen, 6, device="cpu").to(device=device, dtype=torch.float64)
    y0 = (torch.exp(0.3 * torch.randn(B, 6, generator=gen, dtype=torch.float64)) / 10).to(device)

    def rel(a, b):
        return ((a - b).abs() / (b.abs() + 1e-12)).max().item()

    result = dict(device=args.device, patients=B, tolerances=[])
    for rtol, atol in TOLERANCES:
        ys, gy, grads, trial, acc = solve(y0, ctx, params, torch.arange(B, device=device), rtol, atol)
        row = dict(rtol=rtol, atol=atol, trial_steps=trial, accepted_steps=acc, permutations=[])
        for seed in range(args.orders):
            perm = torch.randperm(B, generator=torch.Generator().manual_seed(seed)).to(device)
            ys_p, gy_p, grads_p, trial_p, acc_p = solve(y0, ctx, params, perm, rtol, atol)
            row["permutations"].append(dict(
                trial_steps=trial_p, accepted_steps=acc_p, ys_max_abs_diff=(ys_p - ys).abs().max().item(),
                grad_y0_max_rel_diff=rel(gy_p, gy), grad_ml_max_rel_diff=max(rel(grads_p[n], grads[n]) for n in grads)))
        result["tolerances"].append(row)
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
