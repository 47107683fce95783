"""Multi-rank data-parallel dryrun (counterpart of hybridode/parallel/dryrun.py).

    python -m hybridode_torch.parallel.dryrun N --device c

starts N gloo ranks on the CPU (`launch`; without `--device c`, N NCCL ranks,
one a GPU: N above the visible GPUs raises the mesh error) and runs, at dryrun shapes, the sections of the
JAX package's 8-device dryrun, each printing its OK line:
the DP step of the pinned flagship (the dim-8 hybrid, JAX's `flagship`), the
2-D (data x mc) evaluation against the single-process `_eval_chunk`, the
real-track and flow DP steps, the 2-D flow evaluation, the fused DP restart
against the host DP loop, and the restart x data batched experiment (2 x
N/2 ranks, 1 x 1 at N=1; the 2-D evaluations need an even N); then
`dryrun_multichip(N): loss=... OK`. A failed check raises in its rank, and
the command exits non-zero.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import sys
import tempfile

import numpy as np
import torch

# Tolerances of the JAX dryrun: the sharded evaluation against the single-process chunk, fused DP against host DP.
EVAL_RTOL, EVAL_ATOL, FUSED_RTOL = 2e-4, 2e-6, 1e-5


def _say(text: str) -> None:
    print(text, flush=True)


def flagship(max_steps: int = 256, rtol: float = 1e-7, atol: float = 1e-8, mc_size: int = 8, device="cpu"):
    """The flagship model, the hybrid LHM on the dim-8 cohort's shapes, and its parameters from seed 0."""
    from ..cli.common import build_sim_model
    from ..config import dim8_config
    from ..inference import init_vi

    model = build_sim_model("hybrid", dim8_config, elbo=True, max_steps=max_steps, mc_size=mc_size, rtol=rtol,
                            atol=atol)
    return model, init_vi(torch.Generator().manual_seed(0), model, device=device)


def _pin(params, mean: bool = True) -> None:
    """Pin the posterior to the physical regime (z0 ~ 0.01, a tiny variance): random heads put the latents at
    O(0.1-1), where the expert dynamics blow up over the 14-unit horizon (JAX's dryrun.py:147-149)."""
    enc = params["encoder"]
    with torch.no_grad():
        if mean:
            enc["lin"]["w"].zero_()
            enc["lin"]["b"].fill_(-2.3)
        enc["log_var"]["w"].zero_()
        enc["log_var"]["b"].fill_(-5.0)


def fake_batch(model, B: int, T: int = 15, seed: int = 1, device="cpu") -> dict:
    g = torch.Generator().manual_seed(seed)
    spec = model.decoder_spec
    actions = torch.zeros(T, B, 1)
    actions[3, :, 0] = 1.5
    batch = {
        "measurements": torch.randn((T, B, spec.obs_dim), generator=g),
        "actions": actions,
        "masks": (torch.rand((T, B, spec.obs_dim), generator=g) > 0.5).float(),
        "latents": torch.randn((T, B, spec.latent_dim), generator=g).abs() * 0.01,
    }
    return {k: v.to(device) for k, v in batch.items()}


def real_flagship(device="cpu"):
    """Tiny real-track hybrid (learned dx1/dx2 and the CT-GRU remainder, explicit Adams), JAX's `real_flagship`."""
    from ..cli.common import build_real_model
    from ..inference import init_vi

    model = build_real_model("hybrid", obs_dim=6, action_dim=1, static_dim=3, t_max=12, step_size=1.0,
                             encoder_output_dim=5, encoder_latent_ratio=1.0, ode_method="explicit_adams",
                             ode_step_div=1, t0=4)
    return model, init_vi(torch.Generator().manual_seed(10), model, device=device)


def fake_real_batch(model, B: int, T: int = 12, seed: int = 11, device="cpu") -> dict:
    g = torch.Generator().manual_seed(seed)
    spec = model.decoder_spec
    actions = torch.zeros(T, B, spec.action_dim)
    actions[2, :, 0] = 1.0
    batch = {
        "measurements": 0.1 * torch.randn((T, B, spec.obs_dim), generator=g),
        "actions": actions,
        "masks": (torch.rand((T, B, spec.obs_dim), generator=g) > 0.4).float(),
        "statics": torch.randn((1, B, spec.static_dim), generator=g).expand(T, B, spec.static_dim).contiguous(),
    }
    return {k: v.to(device) for k, v in batch.items()}


def _dp_step(model, params, batch, mesh, seed: int) -> float:
    from ..inference import make_optimizer
    from .mesh import make_dp_train_step

    step = make_dp_train_step(model, make_optimizer(0.01, params), mesh)
    return float(step(params, batch, torch.Generator().manual_seed(seed)))


def _eval_parity(model, params, batch, n: int, seed: int) -> None:
    """The 2-D (n/2 x 2) sharded chunk against `_eval_chunk` on the same draws."""
    from ..eval.metrics import _eval_chunk, draw_chunk_noise
    from .eval import make_sharded_eval_chunk
    from .mesh import make_mesh_2d

    t0, mc_itr, expert_dim = 5, 4, 4
    x = batch["measurements"]
    noise = draw_chunk_noise(model, mc_itr, x.shape[1], torch.Generator().manual_seed(seed), x.device)
    got = make_sharded_eval_chunk(model, make_mesh_2d(n // 2, 2), t0, mc_itr, expert_dim)(params, batch, *noise)
    want = _eval_chunk(params, model, batch, t0, expert_dim, *noise)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=EVAL_RTOL, atol=EVAL_ATOL)


class _Cohort:
    """A fixed batch as a cohort: the first 2/3 of its patients train, the rest validate."""

    def __init__(self, full: dict, n_train: int):
        self.full, self.train_size = full, n_train
        self.val_size = full["measurements"].shape[1] - n_train

    def _fold(self, fold):
        lo, hi = (self.train_size, self.train_size + self.val_size) if fold == "val" else (0, self.train_size)
        return {k: v[:, lo:hi] for k, v in self.full.items()}

    def get_mini_batch(self, fold, batch_size, rng):
        idx = torch.as_tensor(rng.choice(self.train_size, batch_size, replace=False),
                              device=self.full["measurements"].device)
        return {k: v.index_select(1, idx) for k, v in self.full.items()}

    def get_split(self, fold, batch_size, chunk):
        data = self._fold(fold)
        return {k: v[:, chunk * batch_size:(chunk + 1) * batch_size] for k, v in data.items()}


def run(n: int, workdir: str, device="cpu") -> float:
    """Every section on this rank of a world of `n` on `device`, checkpoints under `workdir` (one directory for
    every rank: rank 0 writes, all read); -> the flagship DP step's loss."""
    from ..cli.common import build_sim_model, restart_generators
    from ..config import dim8_config
    from ..inference import fused, init_vi, variational_training_loop
    from .launch import is_writer
    from .mesh import make_mesh

    say = _say if is_writer() else (lambda text: None)
    # Loose tolerances keep the trial-step budget small while the solve still finishes (~44 accepted steps).
    model, params = flagship(max_steps=192, rtol=1e-4, atol=1e-6, device=device)
    _pin(params)
    params0 = copy.deepcopy(params)
    mesh = make_mesh(n)
    batch = fake_batch(model, 2 * n, device=device)  # T must be the decoder's grid, t_max + 1 = 15
    loss = _dp_step(model, params, batch, mesh, seed=3)
    if not np.isfinite(loss):
        raise AssertionError("DP train step produced a non-finite loss")

    if n % 2 == 0:
        _eval_parity(model, params, batch, n, seed=4)
        say(f"dryrun 2D mesh ({n // 2}x2 data x mc) eval parity OK")

    model_r, params_r = real_flagship(device)
    loss_r = _dp_step(model_r, params_r, fake_real_batch(model_r, 2 * n, device=device), mesh, seed=5)
    if not np.isfinite(loss_r):
        raise AssertionError("real-track DP train step produced a non-finite loss")
    say(f"dryrun real-track DP step: loss={loss_r:.4f} OK")

    model_f = build_sim_model("hybrid", dataclasses.replace(dim8_config, obs_dim=10), elbo=True, max_steps=192,
                              rtol=1e-4, atol=1e-6, flow=True, num_flows=2, mc_size=2)
    params_f = init_vi(torch.Generator().manual_seed(12), model_f, device=device)
    _pin(params_f, mean=False)  # the flow's mu head feeds exp(z - 5): a zero bias is already ~0.007
    batch_f = fake_batch(model_f, 2 * n, device=device)
    loss_f = _dp_step(model_f, params_f, batch_f, mesh, seed=6)
    if not np.isfinite(loss_f):
        raise AssertionError("flow DP train step produced a non-finite loss")
    say(f"dryrun flow DP step: loss={loss_f:.4f} OK")
    if n % 2 == 0:
        _eval_parity(model_f, params_f, batch_f, n, seed=13)
        say("dryrun 2D mesh flow eval parity OK")

    # The fused DP restart against the host DP loop, on the same index and noise streams.
    cohort = _Cohort(fake_batch(model, 3 * n, seed=20, device=device), 2 * n)
    best = {}
    for mode, fused_ in (("host", False), ("fused", True)):
        _, best[mode], _ = variational_training_loop(
            niters=4, data_generator=cohort, model=model, params=copy.deepcopy(params0), batch_size=n, lr=0.01,
            test_freq=2, generator=torch.Generator().manual_seed(21), path=f"{workdir}/{mode}_", early_stop=10,
            verbose=False, mesh=mesh, fused=fused_)
    if not np.isfinite(best["fused"]):
        raise AssertionError("fused-DP restart produced a non-finite best loss")
    np.testing.assert_allclose(best["fused"], best["host"], rtol=FUSED_RTOL)
    say(f"dryrun fused-DP whole-restart parity: best={best['fused']:.4f} OK")

    # Two restart lanes over the first mesh axis, no collective between them, each lane data-parallel over the
    # second; every lane starts from the pinned parameters (random inits blow up on these shapes).
    lanes = 2 if n > 1 else 1
    dp = n // 2 if n % 2 == 0 else 1
    main = torch.Generator().manual_seed(22)
    _, best_exp, _ = fused._experiment_loop(
        niters=2, data_generator=cohort, model=model, restart_generators=[restart_generators(main) for _ in range(2)],
        batch_size=n, lr=0.01, test_freq=1, best_on_disk=1e9, early_stop=10, path=f"{workdir}/exp_", shuffle=False,
        train_fold="train", train_expert=False, verbose=False, curve_path=None, events_path=None,
        val_criterion="elbo", val_t0=5, device=device, restart_devices=lanes, dp_devices=dp, mesh=None,
        init_params=[params0, params0])
    if is_writer() and not np.isfinite(best_exp):  # rank 0 is in the mesh; a rank outside it trained nothing
        raise AssertionError(f"restart x data experiment produced a non-finite best loss {best_exp}")
    say(f"dryrun {lanes}x{dp} restart-x-data batched experiment: best={best_exp:.4f} OK")
    return loss


def main(argv=None) -> int:
    from .. import resolve_device
    from .launch import launch
    from .mesh import require_devices

    parser = argparse.ArgumentParser("python -m hybridode_torch.parallel.dryrun")
    parser.add_argument("n", nargs="?", default=8, type=int, help="ranks")
    parser.add_argument("--device", choices=["0", "1", "c"], default="1", type=str,
                        help="c: gloo ranks on the CPU; 0 or 1: NCCL ranks, one a GPU")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device("cpu" if args.device == "c" else "cuda")
    if device.type == "cuda":
        require_devices(args.n, f"{args.n}-device 'data'", torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as workdir:
        loss = launch(run, args.n, args.n, workdir, str(device), device=device)
    _say(f"dryrun_multichip({args.n}): loss={loss:.4f} OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
