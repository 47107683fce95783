"""Real-data NNLS ensemble of a trained expert model and a trained gruode model.

    python -m hybridode_torch.cli.run_real_ensemble --init_path model/ --data_path data_real/

Counterpart of hybridode/cli/run_real_ensemble.py: both members load their
checkpoints from `--init_path` (the expert with 4 latents, the gruode with
`--encoder_output_dim`), one NNLS weight pair per step past t0 is learned on
the val fold, and the test fold's blended forecast is scored with the four
`rmse_x,<t1>,<rmse>,<sd>` lines and written to `<init_path>ensembleeval.pkl`.

Reference quirks kept: the expert member decodes with [a, s] as its action
array (`--expert_actions_quirk y`, the default), so its depot kernel sums the
statics as doses; the weights are learned from the FULL val sequence encoded,
not from [0, t0).

It runs on the GPU; `--device c` asks for the CPU.
"""

from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..data import RealCohort, make_real_standin
from ..ensembles.nnls import nnls2
from ..inference import init_vi, load_checkpoint
from ..inference.elbo import decode, encode
from . import common
from .run_real import T0, horizon_report, write_eval


def init_and_load(dg, encoder_output_dim, encoder_latent_ratio, ode_step_div, method, ode_method, init_path,
                  generator, t0=T0, device=None):
    """-> (params, model): random weights from `generator`, replaced by `init_path`'s checkpoint when given."""
    model = common.build_real_model(
        method, dg.obs_dim, dg.action_dim, dg.static_dim, dg.t_max, dg.step_size,
        encoder_output_dim=encoder_output_dim, encoder_latent_ratio=encoder_latent_ratio,
        ode_method=ode_method, ode_step_div=ode_step_div, t0=t0,
    )
    params = init_vi(generator, model, device=device)
    if init_path is not None:
        params, _, _ = load_checkpoint(init_path, model.model_name, device)
    return params, model


@torch.no_grad()
def _predict(params, model, data, t0, expert_quirk: bool):
    """Encode [0, t0) to the posterior mean and decode; with `expert_quirk` the decoder's actions are [a, s]."""
    x, a, mask, s = data["measurements"], data["actions"], data["masks"], data["statics"]
    a_in = torch.cat([a, s], dim=-1)
    mu, _ = encode(params, model, x[:t0], a_in[:t0], mask[:t0])
    dec_batch = dict(data)
    if expert_quirk:
        dec_batch["actions"] = a_in
    x_hat, _ = decode(params, model, mu, dec_batch)
    return x_hat


def run(seed=666, train_sample_size=None, ode_method="explicit_adams", ode_step_div=1, encoder_output_dim=20,
        encoder_latent_ratio=1.2, init_path="model/", data_path="data/", standin=False, expert_actions_quirk=True,
        device=None):
    """-> the horizon report [(t1, rmse, sd)] of the blended test forecast."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)

    if standin:
        make_real_standin(data_path, data_type="5")
    dg = RealCohort(data_path=data_path, data_type="5", latent_dim=10, val_size=100, test_size=1000, device=device)
    dg.split_sample()
    if train_sample_size is not None:
        dg.set_train_size(train_sample_size)
        init_path = init_path + str(train_sample_size)

    params_e, model_e = init_and_load(dg, 4, encoder_latent_ratio, ode_step_div, "expert", ode_method, init_path,
                                      generator, T0, device)
    params_m, model_m = init_and_load(dg, encoder_output_dim, encoder_latent_ratio, ode_step_div, "gruode",
                                      ode_method, init_path, generator, T0, device)

    # Weights from the val fold, the FULL sequence encoded.
    val = dg.data_val
    T_val = val["measurements"].shape[0]
    x_hat_e = _predict(params_e, model_e, val, T_val, expert_quirk=expert_actions_quirk)
    x_hat_m = _predict(params_m, model_m, val, T_val, expert_quirk=False)

    x_post = val["measurements"][T0:]  # (T', B, D)
    Tp, B, D = x_post.shape
    w1, w2 = nnls2(x_hat_e[:Tp].reshape(Tp, B * D), x_hat_m[:Tp].reshape(Tp, B * D), x_post.reshape(Tp, B * D))
    weights_e = w1[:, None, None].expand(Tp, 1, D)
    weights_m = w2[:, None, None].expand(Tp, 1, D)
    print("Ensemble weights learned.")

    data = dg.data_test
    x_hat1 = _predict(params_e, model_e, data, T0, expert_quirk=expert_actions_quirk)
    x_hat2 = _predict(params_m, model_m, data, T0, expert_quirk=False)
    x_hat = (x_hat1 * weights_e + x_hat2 * weights_m).cpu().numpy()

    x, mask = data["measurements"].cpu().numpy(), data["masks"].cpu().numpy()
    write_eval(init_path + "ensemble" + "eval.pkl", x, x_hat, mask, "ensemble", None)
    return horizon_report(x, x_hat, mask, T0)


def main(argv=None):
    parser = argparse.ArgumentParser("Real data ensemble")
    parser.add_argument("--method", choices=["ensemble"], default="ensemble", type=str)
    parser.add_argument("--device", choices=["0", "1", "c"], default="1", type=str,
                        help="c: run on the CPU; 0 or 1: run on the GPU")
    parser.add_argument("--seed", default=666, type=int)
    parser.add_argument("--ode_method", default="explicit_adams", type=str)
    parser.add_argument("--ode_step_div", default=1, type=int)
    parser.add_argument("--encoder_output_dim", default=20, type=int)
    parser.add_argument("--encoder_latent_ratio", default=1.2, type=float)
    parser.add_argument("--weight", default="n", type=str)
    parser.add_argument("--niters", default=1500, type=int)
    parser.add_argument("--init_path", default="model/", type=str)
    parser.add_argument("--sample", default=None, type=int)
    parser.add_argument("--data_path", default="data/", type=str)
    parser.add_argument("--standin", default="n", type=str)
    parser.add_argument("--expert_actions_quirk", choices=["y", "n"], default="y", type=str,
                        help="y (reference parity): the expert member decodes with [a, s] concatenated as its "
                             "action array; n: plain dose actions")
    args = parser.parse_args(argv)

    run(seed=args.seed, train_sample_size=args.sample, ode_method=args.ode_method,
        ode_step_div=args.ode_step_div, encoder_output_dim=args.encoder_output_dim,
        encoder_latent_ratio=args.encoder_latent_ratio, init_path=args.init_path,
        data_path=args.data_path, standin=args.standin == "y",
        expert_actions_quirk=args.expert_actions_quirk == "y",
        device="cpu" if args.device == "c" else "cuda")


if __name__ == "__main__":
    main()
