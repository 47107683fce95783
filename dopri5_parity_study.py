#!/usr/bin/env python3
"""Why float32 DOPRI5 step counts differ between hybridode (JAX) and hybridode_torch, on the CPU.

    JAX_PLATFORMS=cpu python3 dopri5_parity_study.py [--patients 32] [--out RESULT.json]

Prints one JSON object with:

* `xla_fma_share`: of 1e5 random float32 triples chosen so that the product
  cancels against `c`, the share for which jitted `a * b + c` equals the fused
  multiply-add (one rounding) rather than PyTorch's product-then-sum;
* `tanh_equal_share`, `exp_equal_share`: of 1e4 normal float32 inputs, the
  share where XLA's jitted tanh / exp equal PyTorch's bit for bit;
* for float64 and float32, per-row DOPRI5 solves of the Roche field (the
  field's seed-0 initialisation) for the first `--patients` training patients
  of data_s123 at the CLI's settings (max_steps 256, rtol 1e-7, atol 1e-8),
  JAX's `vmap` of one solve a patient against the port's `per_row=True`:
  per-row differences of accepted and trial steps (JAX minus port), and
  each package's largest absolute error against a float64 port solve at
  rtol 1e-12.

A study of both packages: it imports JAX, which the port itself never does.
"""

from __future__ import annotations

import argparse
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from hybridode.data import SyntheticCohort as JSyntheticCohort  # noqa: E402
from hybridode.fields import DoseContext as JDoseContext  # noqa: E402
from hybridode.fields import doses_from_actions as j_doses_from_actions  # noqa: E402
from hybridode.fields import init_roche_field as j_init_roche_field  # noqa: E402
from hybridode.fields import roche_field as j_roche_field  # noqa: E402
from hybridode.solvers import odeint_dopri5 as j_odeint_dopri5  # noqa: E402
from hybridode_torch.convert import params_from_jax  # noqa: E402
from hybridode_torch.fields import DoseContext, roche_field  # noqa: E402
from hybridode_torch.solvers import odeint_dopri5  # noqa: E402

COHORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_s123", "datafile_dose_exp.pkl")
TS = np.arange(15, dtype=np.float32)


def rounding(rng):
    a, b = (rng.rand(100_000).astype(np.float32) for _ in range(2))
    c = -(a.astype(np.float64) * b).astype(np.float32)  # the product cancels: its rounding shows
    got = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    fma = (a.astype(np.float64) * b + c).astype(np.float32)
    x = rng.randn(10_000).astype(np.float32)
    share = lambda j, t: float(np.mean(np.asarray(jax.jit(j)(x)) == t(torch.from_numpy(x)).numpy()))  # noqa: E731
    return dict(xla_fma_share=float(np.mean(got == fma)), tanh_equal_share=share(jnp.tanh, torch.tanh),
                exp_equal_share=share(jnp.exp, torch.exp))


def solves(n):
    jc = JSyntheticCohort.load(COHORT)
    ctx = j_doses_from_actions(jc.get_split("train", n, 0)["actions"], 1.0)
    times, amounts = np.array(ctx.times), np.array(ctx.amounts)
    y0 = (np.exp(0.3 * np.random.RandomState(0).randn(n, 6)) / 10).astype(np.float32)
    jparams = j_init_roche_field(jax.random.PRNGKey(0), 6)

    def port(dtype, **kw):
        cast = lambda a: torch.as_tensor(np.asarray(a)).to(dtype)  # noqa: E731
        with torch.no_grad():
            ys, st = odeint_dopri5(roche_field, cast(y0), cast(TS), (params_from_jax(jparams, device="cpu").to(dtype),
                                                                     DoseContext(cast(times), cast(amounts))),
                                   per_row=True, **kw)
        return ys.numpy(), st.n_accepted.numpy(), st.n_steps.numpy()

    def jax_solve(dtype):
        cast = lambda a: jnp.asarray(np.asarray(a), dtype)  # noqa: E731
        p = jax.tree_util.tree_map(cast, jparams)

        def one(z, t, a):
            return j_odeint_dopri5(j_roche_field, z, cast(TS), (p, JDoseContext(t, a)), max_steps=256)

        ys, st = jax.jit(jax.vmap(one, out_axes=(1, 0)))(cast(y0), cast(times), cast(amounts))
        return np.asarray(ys), np.asarray(st.n_accepted), np.asarray(st.n_steps)

    truth = port(torch.float64, max_steps=20000, rtol=1e-12, atol=1e-14)[0]
    out = {}
    for name, jdt, tdt in (("float64", jnp.float64, torch.float64), ("float32", jnp.float32, torch.float32)):
        with jax.enable_x64(jdt == jnp.float64):
            j = jax_solve(jdt)
        t = port(tdt, max_steps=256)
        out[name] = dict(accepted_diff=(j[1] - t[1]).tolist(), trial_diff=(j[2] - t[2]).tolist(),
                         trial_jax=j[2].tolist(),
                         max_trial_rel_diff=float(np.max(np.abs(j[2] - t[2]) / j[2])),
                         err_jax=float(np.max(np.abs(j[0] - truth))), err_port=float(np.max(np.abs(t[0] - truth))))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--patients", type=int, default=32)
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    result = dict(rounding(np.random.RandomState(0)), patients=args.patients, **solves(args.patients))
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
