"""Real-data (ICU cohort) CLI: train and evaluate one of six models on the cohort's t0-forecast.

    python -m hybridode_torch.cli.run_real --method hybrid --niters 1500 --data_path data_real/

Counterpart of hybridode/cli/run_real.py: the same flags and the same stdout
(the training loop's `Iter NNNN | Total Loss ... | Train Loss ...`, `Time:`
and `Overall best loss:` lines, then one `rmse_x,<t1>,<rmse>,<sd>` line for
each horizon t1 in {30, 36, 48, 96}), and the same `<path><model name>eval.pkl`
dict of numpy arrays. The cohort is split into train / val 100 / test 1000,
t0 = 24 hours condition the forecast, the masked MSE trains every parameter
with Adam (lr 0.01, batch 100, sequential batches, validation every 100
iterations, early stop after 10 validations without gain).

It runs on the GPU; `--device c` asks for the CPU. The weights come from a
CPU `torch.Generator` seeded with `--seed`, so a CPU run and a GPU run from one
seed start from the same weights and see the same batches.
"""

from __future__ import annotations

import argparse
import pickle
import time

import numpy as np
import torch

from .. import resolve_device
from ..data import RealCohort, make_real_standin
from ..eval.metrics import bootstrap_rmse
from ..inference import init_vi, load_checkpoint, variational_training_loop
from ..inference.elbo import decode, encode
from ..utils.logging import JSONLLogger
from . import common

T0 = 24


def horizon_report(x, x_hat, mask, t0):
    """Masked RMSE over [t0, t1) for t1 in t0 + {6, 12, 24, 72}, printed as CSV; -> [(t1, rmse, sd)].

    numpy inputs; `sd` is a bootstrap over patients drawn from the global
    `np.random`, as the reference does.
    """
    out = []
    for t1 in (t0 + 6, t0 + 12, t0 + 24, t0 + 24 * 3):
        num = np.sum((x[t0:t1] - x_hat[: t1 - t0]) ** 2 * mask[t0:t1], axis=(0, 2))
        den = np.sum(mask[t0:t1], axis=(0, 2))
        a = num / den
        a = a[~np.isnan(a)]
        rmse = float(np.sqrt(np.mean(a)))
        rmse_sd = bootstrap_rmse(a)
        print("rmse_x,{:.4f},{:.4f},{:.4f}".format(t1, rmse, rmse_sd))
        out.append((t1, rmse, rmse_sd))
    return out


@torch.no_grad()
def predict_test(params, model, data, t0):
    """Encode [0, t0) of [x, a, statics] to the posterior mean and decode the forecast x_hat (T - t0, B, D)."""
    x, a, mask, s = data["measurements"], data["actions"], data["masks"], data["statics"]
    a_in = torch.cat([a, s], dim=-1)
    mu, _ = encode(params, model, x[:t0], a_in[:t0], mask[:t0])
    x_hat, _ = decode(params, model, mu, data)
    return x_hat


def write_eval(path: str, x, x_hat, mask, name, model_path):
    eval_dict = {"x": x, "x_hat": x_hat, "mask": mask, "name": name, "model_path": model_path}
    with open(path, "wb") as f:
        pickle.dump(eval_dict, f)


def run(
    seed=666,
    train_sample_size=None,
    method="hybrid",
    ode_method="explicit_adams",
    niters=1500,
    ode_step_div=1,
    encoder_output_dim=20,
    encoder_latent_ratio=1.2,
    weight=False,
    eval_only=False,
    data_path="data/",
    standin=False,
    batch_size=100,
    val_size=100,
    test_size=1000,
    standin_kwargs=None,
    model_dir="model/",
    curve_path=None,
    device=None,
    *,
    test_freq=100,
    events_path=None,
):
    """Train (or load with `eval_only`) and evaluate; -> (params, model, the horizon report).

    `test_freq` and `events_path` keep the CLI's values by default; the event
    log gets the training loop's records and a `predict_test` record with its
    seconds (the test fold's forecast, read back to the host).
    """
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)

    if standin:
        make_real_standin(data_path, data_type="5", **(standin_kwargs or {}))
    dg = RealCohort(data_path=data_path, data_type="5", latent_dim=10, val_size=val_size, test_size=test_size,
                    device=device)
    dg.split_sample()
    if train_sample_size is not None:
        dg.set_train_size(train_sample_size)

    model = common.build_real_model(
        method, dg.obs_dim, dg.action_dim, dg.static_dim, dg.t_max, dg.step_size,
        encoder_output_dim=encoder_output_dim, encoder_latent_ratio=encoder_latent_ratio,
        ode_method=ode_method, ode_step_div=ode_step_div, t0=T0, weight=weight,
    )
    path = model_dir if train_sample_size is None else model_dir + str(train_sample_size)

    params = init_vi(generator, model, device=device)
    if not eval_only:
        params, _, _ = variational_training_loop(
            niters=niters, data_generator=dg, model=model, params=params, batch_size=batch_size,
            lr=0.01, test_freq=test_freq, generator=generator, path=path, best_on_disk=1e9,
            early_stop=10, shuffle=False, train_expert=True, curve_path=curve_path, events_path=events_path,
        )
    else:
        params, _, best_loss = load_checkpoint(path, model.model_name, device)
        print("Overall best loss: {:.6f}".format(best_loss))

    data = dg.data_test
    t = time.perf_counter()
    x_hat = predict_test(params, model, data, T0).cpu().numpy()
    events = JSONLLogger(events_path)
    events.log("predict_test", seconds=time.perf_counter() - t, patients=int(data["measurements"].shape[1]))
    events.close()

    x, mask = data["measurements"].cpu().numpy(), data["masks"].cpu().numpy()
    write_eval(path + model.model_name + "eval.pkl", x, x_hat, mask, model.model_name, path)
    return params, model, horizon_report(x, x_hat, mask, T0)


def main(argv=None):
    parser = argparse.ArgumentParser("Real data")
    parser.add_argument("--method", choices=["neural", "hybrid", "tlstm", "gruode", "2nd", "expert"],
                        default="neural", type=str)
    parser.add_argument("--device", choices=["0", "1", "c"], default="1", type=str,
                        help="c: run on the CPU; 0 or 1: run on the GPU")
    parser.add_argument("--seed", default=666, type=int)
    parser.add_argument("--ode_method", default="explicit_adams", type=str)
    parser.add_argument("--ode_step_div", default=1, type=int)
    parser.add_argument("--encoder_output_dim", default=20, type=int)
    parser.add_argument("--encoder_latent_ratio", default=1.2, type=float)
    parser.add_argument("--weight", default="n", type=str)
    parser.add_argument("--niters", default=1500, type=int)
    parser.add_argument("--sample", default=None, type=int)
    parser.add_argument("--eval_only", default=False, type=bool)
    parser.add_argument("--data_path", default="data/", type=str)
    parser.add_argument("--standin", default="n", type=str)
    parser.add_argument("--curve_path", default=None, type=str,
                        help="write iter,val_loss,train_loss CSV for this run")
    args = parser.parse_args(argv)

    run(
        seed=args.seed, niters=args.niters, train_sample_size=args.sample, method=args.method,
        ode_method=args.ode_method, ode_step_div=args.ode_step_div,
        encoder_output_dim=args.encoder_output_dim, encoder_latent_ratio=args.encoder_latent_ratio,
        weight=args.weight == "y", eval_only=args.eval_only, data_path=args.data_path,
        standin=args.standin == "y", curve_path=args.curve_path,
        device="cpu" if args.device == "c" else "cuda",
    )


if __name__ == "__main__":
    main()
