"""Simulation-study CLI: train and evaluate expert / neural / hybrid LHM models.

    python -m hybridode_torch.cli.run_simulation --method hybrid --restart 1 --arg_itr 4 \
        --data_path data_s123/datafile_dose_exp.pkl --path model/v_

Counterpart of hybridode/cli/run_simulation.py: the same flags and the same
stdout (`Training with N samples`, the `Iter NNNN | Total Loss ... | Train
Loss ...` lines, `Time:`, `Overall best loss:` and the 4-line CSV of
`evaluate`), the n_restart loop with a best-on-disk shared across restarts,
frozen expert constants, then `evaluate` at t0.

It runs on the GPU; `--device c` asks for the CPU (the JAX package keeps the
flag for interface parity and ignores it). All noise comes from one CPU
`torch.Generator` seeded with `--seed`: each restart draws from it the seeds
of its own init and train generators (`common.restart_generators`, JAX's
`host_split(key, 3)`), and the final evaluation draws from it, so a CPU run
and a GPU run from one seed see the same weights and the same noise, and
`--restart_mode vmap` (every restart in one batched program,
`inference/fused.py`) selects the checkpoint that `seq` selects.

Training runs the fused loop (on the GPU its step and validation as CUDA
graphs) unless HYBRIDODE_FUSED=0 asks for the host loop.

`--step_control lockstep` gives the Roche decoder one DOPRI5 controller for
the whole batch, on the adjoint solver (`solvers/adjoint.py`).

Parallelism (`hybridode_torch/parallel/`, one process per rank: gloo ranks
with `--device c`, one NCCL rank a GPU on CUDA): `--dp N` trains each restart
data-parallel over N ranks; `--restart_mode shard` spreads the batched
restarts over `--restart_devices` ranks (default: one a restart), each lane
data-parallel over `--dp`; `--eval_mesh DPxMC` evaluates on a (patients x
MC samples) mesh. The run starts the larger of its training and evaluation
meshes; a mesh takes the first ranks and the others wait; rank 0 prints and
writes. A mesh larger than the visible GPUs raises; nothing runs two ranks on
one GPU or moves to the CPU. `--restart_mode vmap` and `shard` compose with
`--step_control lockstep`: each lane keeps its own controller
(`solvers/adjoint.py`).
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from .. import resolve_device
from ..config import EvalConfig, OptimConfig
from ..data import SyntheticCohort
from ..eval import evaluate
from ..parallel.eval import evaluate_sharded
from ..inference import init_vi, load_checkpoint, variational_training_loop
from ..parallel.launch import is_writer
from ..utils.logging import JSONLLogger
from . import common

SCORE_NAMES = ("rmse_z0", "rmse_z0_sd", "cprs_z0", "rmse_x", "rmse_x_sd", "cprs_x")


def run(
    seed: int,
    elbo: bool,
    eval_only: bool,
    init_path: str | None,
    data_path: str,
    sample: int,
    data_config,
    model_method: str,
    path: str,
    optim_config: OptimConfig,
    eval_config: EvalConfig,
    encoder_output_dim=None,
    ablate: bool = False,
    arg_itr: int | None = None,
    val_criterion: str = "forecast",
    curve_path: str | None = None,
    events_path: str | None = None,
    dp_devices: int | None = None,
    eval_mesh: tuple[int, int] | None = None,
    lockstep: bool = False,
    restart_mode: str = "seq",
    restart_devices: int | None = None,
    device=None,
):
    """Train n_restart times, then evaluate; -> (params, model, the six numbers of `evaluate`).

    `dp_devices`, `restart_mode="shard"` with `restart_devices` (default
    n_restart) and `eval_mesh` (n_data, n_mc) as the CLI's flags: called
    outside a world, a run that needs more than one rank starts them and
    returns rank 0's result.
    """
    kwargs = dict(locals())
    device = resolve_device(device)
    world = common.check_parallel_flags(restart_mode=restart_mode, n_restart=optim_config.n_restart,
                                        dp_devices=dp_devices, restart_devices=restart_devices, eval_mesh=eval_mesh,
                                        batch_size=optim_config.batch_size, init_path=init_path, eval_only=eval_only,
                                        device=device)
    if world > 1 and not dist.is_initialized():
        return common.launch_run(run, kwargs, world, device)
    generator = torch.Generator().manual_seed(seed)

    dg = SyntheticCohort.load(data_path, device=device)
    if not eval_only:
        dg.set_train_size(sample)
    print("Training with {} samples".format(sample))

    model = common.build_sim_model(
        model_method,
        data_config,
        encoder_output_dim=encoder_output_dim,
        elbo=elbo,
        ode_method=optim_config.ode_method,
        ablate=ablate,
        lockstep=lockstep,
    )

    niters = optim_config.niters if arg_itr is None else arg_itr
    params, scores = fit_and_evaluate(model, dg, generator, eval_only=eval_only, init_path=init_path, niters=niters,
                                      path=path, optim_config=optim_config, eval_config=eval_config,
                                      val_criterion=val_criterion, curve_path=curve_path, events_path=events_path,
                                      device=device, restart_mode=restart_mode, dp_devices=dp_devices,
                                      restart_devices=restart_devices, eval_mesh=eval_mesh)
    return params, model, scores


def fit_and_evaluate(model, dg, generator, *, eval_only, init_path, niters, path, optim_config, eval_config,
                     val_criterion, curve_path, events_path, device, restart_mode="seq", dp_devices=None,
                     restart_devices=None, eval_mesh=None):
    """The restart loop and the final evaluation shared by the simulation CLIs; -> (params, scores).

    Each restart draws the seeds of its init and train generators from
    `generator` (`common.restart_generators`); the best-on-disk is shared
    across restarts. `restart_mode="vmap"` trains every restart at once
    (`common.run_batched_experiment`) from the same draws, `"shard"` spreads
    them over a (restart, data) mesh. With `eval_only` the checkpoint at
    `path` is loaded and scored instead. The final evaluation draws from
    `generator`, over a (data, mc) mesh with `eval_mesh`; the event log gets
    an `evaluate` record with its seconds and scores.

    In a world of ranks every rank calls this. The training mesh takes the
    first ranks, and only they train (rank 0 alone when there is no mesh).
    Then every rank waits for the others without a collective (`wait_idle`),
    and a rank that did not train reads the checkpoint rank 0 wrote; every
    rank takes rank 0's generator, so the evaluation draws as one process.
    """
    from ..parallel.launch import rank, wait_idle, world_size
    from ..parallel.mesh import make_mesh, make_mesh_2d, member

    best_on_disk = 1e9
    params = None
    n_restart = optim_config.n_restart
    dp = dp_devices or 1
    lanes = (restart_devices or n_restart) if restart_mode == "shard" else 1
    mesh = None
    if not eval_only and lanes * dp > 1:  # every rank of the world makes the mesh: making it is collective
        mesh = make_mesh_2d(lanes, dp, ("restart", "data")) if restart_mode == "shard" else make_mesh(dp)
    trains = not eval_only and (member(mesh) if mesh is not None else rank() == 0)
    if trains and restart_mode in ("vmap", "shard"):
        params, best_on_disk = common.run_batched_experiment(
            generator, model, dg, n_restart=n_restart, niters=niters, batch_size=optim_config.batch_size,
            lr=optim_config.lr, test_freq=optim_config.test_freq, path=path, best_on_disk=best_on_disk,
            early_stop=optim_config.early_stop, shuffle=optim_config.shuffle, val_criterion=val_criterion,
            val_t0=eval_config.t0, curve_path=curve_path, events_path=events_path, device=device, mesh=mesh)
    elif trains:
        for _ in range(n_restart):
            gen_init, gen_train = common.restart_generators(generator)
            params = init_vi(gen_init, model, device=device)
            if init_path is not None:
                params, _, _ = load_checkpoint(init_path, model.model_name, device)
            params, best_on_disk, _ = variational_training_loop(
                niters=niters, data_generator=dg, model=model, params=params, batch_size=optim_config.batch_size,
                lr=optim_config.lr, test_freq=optim_config.test_freq, generator=gen_train, path=path,
                best_on_disk=best_on_disk, early_stop=optim_config.early_stop, shuffle=optim_config.shuffle,
                val_criterion=val_criterion, val_t0=eval_config.t0,
                # The curve and event logs keep the LAST restart's trajectory.
                curve_path=curve_path, events_path=events_path, mesh=mesh,
            )

    if eval_only:
        if n_restart:
            common.restart_generators(generator)  # the draws of a training run's first restart
        params, _, best_loss = load_checkpoint(path, model.model_name, device)
        if is_writer():
            print("Overall best loss: {:.6f}".format(best_loss))
    elif world_size() > 1:
        wait_idle("trained")
        if not trains:
            params = load_checkpoint(path, model.model_name, device)[0]
        state = [generator.get_state()]
        dist.broadcast_object_list(state, src=0)
        generator.set_state(state[0])

    t = time.perf_counter()
    scores = None
    if eval_mesh is not None:
        mesh = make_mesh_2d(*eval_mesh)
        if member(mesh):
            scores = evaluate_sharded(params, model, dg, optim_config.batch_size, eval_config.t0, mesh,
                                      generator=generator, device=device)
    elif is_writer():
        scores = evaluate(params, model, dg, optim_config.batch_size, eval_config.t0, generator=generator,
                          device=device)
    if is_writer():
        events = JSONLLogger(events_path)
        events.log("evaluate", seconds=time.perf_counter() - t, **dict(zip(SCORE_NAMES, scores)))
        events.close()
    return params, scores


def build_parser():
    parser = argparse.ArgumentParser("PKPD simulation")
    parser.add_argument("--method", choices=["expert", "neural", "hybrid"], default="hybrid", type=str)
    parser.add_argument("--device", choices=["0", "1", "c"], default="1", type=str,
                        help="c: run on the CPU; 0 or 1: run on the GPU")
    parser.add_argument("--seed", default=666, type=int)
    parser.add_argument("--sample", default=1000, type=int)
    parser.add_argument("--path", default=None, type=str)
    parser.add_argument("--restart", default=3, type=int)
    parser.add_argument("--arg_itr", default=None, type=int)
    parser.add_argument("--eval", default="n", type=str)
    parser.add_argument("--elbo", default="y", type=str)
    parser.add_argument("--init", default=None, type=str)
    parser.add_argument("--batch_size", default=50, type=int)
    parser.add_argument("--t0", default=5, type=int)
    parser.add_argument("--lr", default=0.01, type=float)
    parser.add_argument("--data_config", default=None, type=str)
    parser.add_argument("--encoder_output_dim", default=None, type=int)
    parser.add_argument("--data_path", default="data/datafile_dose_exp.pkl", type=str)
    parser.add_argument("--ablate", default=False, type=bool)
    # "forecast" selects checkpoints on the t0-forecast error (the test
    # figure of merit); "elbo" is the reference's full-sequence val loss.
    parser.add_argument("--val_criterion", choices=["forecast", "elbo"], default="forecast", type=str)
    parser.add_argument("--curve_path", default=None, type=str,
                        help="write iter,val_loss,train_loss CSV (exp_lhm.csv format)")
    parser.add_argument("--events_path", default=None, type=str, help="append JSONL training events")
    parser.add_argument("--step_control", choices=["per_sample", "lockstep"], default="per_sample", type=str,
                        help="adaptive step controller granularity: per-sample (default) or lockstep (one "
                             "controller for the batch, on the adjoint solver)")
    add_parallel_flags(parser)
    return parser


def add_parallel_flags(parser) -> None:
    """`--dp`, `--restart_mode`, `--restart_devices` and `--eval_mesh`, shared with run_simulation_flow."""
    parser.add_argument("--dp", default=0, type=int, help="data-parallel device count (0/1 = single device)")
    parser.add_argument("--restart_mode", choices=["seq", "vmap", "shard"], default="seq", type=str,
                        help="seq: one restart after another; vmap: every restart in one batched program; shard: "
                             "vmap with the restarts spread over ranks (no collective between restarts)")
    parser.add_argument("--restart_devices", default=0, type=int,
                        help="device count for --restart_mode=shard (default n_restart)")
    parser.add_argument("--eval_mesh", default=None, type=str,
                        help="'DPxMC' (e.g. 4x2): evaluate on a 2-D patients-x-MC device mesh")


def parse_eval_mesh(text):
    return tuple(int(x) for x in text.split("x")) if text else None


def main(argv=None):
    args = build_parser().parse_args(argv)
    data_config = common.resolve_data_config(args.data_config, args.sample)
    optim_config = OptimConfig(shuffle=False, n_restart=args.restart, batch_size=args.batch_size, lr=args.lr)
    run(
        seed=args.seed,
        elbo=args.elbo == "y",
        eval_only=args.eval == "y",
        init_path=args.init,
        data_path=args.data_path,
        sample=args.sample,
        data_config=data_config,
        model_method=args.method,
        path=args.path,
        optim_config=optim_config,
        eval_config=EvalConfig(t0=args.t0),
        encoder_output_dim=args.encoder_output_dim,
        ablate=args.ablate,
        arg_itr=args.arg_itr,
        val_criterion=args.val_criterion,
        curve_path=args.curve_path,
        events_path=args.events_path,
        dp_devices=args.dp if args.dp > 1 else None,
        eval_mesh=parse_eval_mesh(args.eval_mesh),
        lockstep=args.step_control == "lockstep",
        restart_mode=args.restart_mode,
        restart_devices=args.restart_devices or None,
        device="cpu" if args.device == "c" else "cuda",
    )


if __name__ == "__main__":
    main()
