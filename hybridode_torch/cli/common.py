"""Shared CLI plumbing (counterpart of `resolve_data_config`, `build_sim_model`, `build_real_model` and
`run_batched_experiment`, hybridode/cli/common.py:30-200).

Same signatures and the same spec values as the JAX package. Where JAX
splits a key, the port draws seeds from one CPU `torch.Generator`
(`restart_generators`). Where JAX sees every device from one process, the
port starts one process per rank: `check_parallel_flags` sizes the world a
simulation run needs (the larger of its training and its evaluation mesh)
and refuses what cannot run before anything is started or written.
"""

from __future__ import annotations

import torch

from ..config import DataConfig, dim8_config, dim12_config
from ..inference.elbo import VIModel
from ..models.decoders import RealBenchmarkSpec, RealDecoderSpec, SimDecoderSpec
from ..models.encoders import EncoderLSTMRealSpec, EncoderLSTMSpec, EncoderPlanarLSTMSpec


def resolve_data_config(name: str | None, sample: int) -> DataConfig:
    if name == "dim8":
        return dim8_config
    if name == "dim12":
        return dim12_config
    return DataConfig(n_sample=sample)


def build_sim_model(
    method: str,
    data_config: DataConfig,
    encoder_output_dim: int | None = None,
    elbo: bool = True,
    ode_method: str = "dopri5",
    ablate: bool = False,
    mc_size: int = 100,
    max_steps: int | None = None,
    rtol: float = 1e-7,
    atol: float = 1e-8,
    flow: bool = False,
    num_flows: int = 4,
    lockstep: bool = False,
) -> VIModel:
    """expert / neural / hybrid -> VIModel.

    expert: 4 encoder latents, Roche field, Exponential prior, positivity
    normalisation. neural: full latents, black-box field, analytic-normal KL,
    no normalisation. hybrid: full latents, Roche+ml field, Exponential prior.
    With `flow` the encoder carries `num_flows` amortised planar flows
    (`kind="flow"`, the LHM-NF posterior).
    """
    obs = data_config.obs_dim
    act = data_config.action_dim
    neural = method == "neural"
    if encoder_output_dim is None:
        encoder_output_dim = 4 if method == "expert" else data_config.latent_dim

    normalize = not neural
    prior = None if neural else "exponential"
    roche = not neural
    if max_steps is None:
        # Roche fields: per-patient control (~112 accepted steps per patient
        # at most, plus rejections); the smooth neural field solves in
        # lockstep in ~25 steps and keeps the generous budget.
        max_steps = (4096 if lockstep else 256) if roche else 512

    hidden = int(obs * 2.0)  # encoder_latent_ratio=2.0
    if flow:
        enc = EncoderPlanarLSTMSpec(obs + act, hidden, encoder_output_dim, num_flows=num_flows, normalize=normalize)
    else:
        enc = EncoderLSTMSpec(obs + act, hidden, encoder_output_dim, normalize=normalize)
    dec = SimDecoderSpec(
        obs,
        encoder_output_dim,
        act,
        t_max=data_config.t_max,
        step_size=data_config.step_size,
        roche=roche,
        ablate=ablate,
        method=ode_method,
        max_steps=max_steps,
        rtol=rtol,
        atol=atol,
        per_sample_control=roche and not lockstep,
        use_adjoint=roche and lockstep,
        max_record=1024 if (roche and lockstep) else None,
    )
    return VIModel(kind="flow" if flow else "sim", encoder_spec=enc, decoder_spec=dec, elbo=elbo, prior=prior,
                   mc_size=mc_size)


def build_real_model(
    method: str,
    obs_dim: int,
    action_dim: int,
    static_dim: int,
    t_max: int,
    step_size: float,
    encoder_output_dim: int = 20,
    encoder_latent_ratio: float = 1.2,
    ode_method: str = "explicit_adams",
    ode_step_div: int = 1,
    t0: int = 24,
    weight: bool = False,
) -> VIModel:
    """neural / hybrid / expert / 2nd (ODE decoders) or tlstm / gruode (discrete) -> VIModel with the masked MSE."""
    input_dim = obs_dim + action_dim + static_dim + 1
    enc = EncoderLSTMRealSpec(input_dim, int(input_dim * encoder_latent_ratio), encoder_output_dim, reverse=False)

    hidden_dim = int((obs_dim + action_dim + static_dim) * encoder_latent_ratio)
    if method in ("hybrid", "neural", "2nd", "expert"):
        dec = RealDecoderSpec(obs_dim, encoder_output_dim, action_dim, static_dim, hidden_dim, t_max=t_max,
                              step_size=step_size, t0=t0, method=ode_method, ode_step_size=step_size / ode_step_div,
                              ode_type=method)
    else:
        dec = RealBenchmarkSpec(obs_dim, encoder_output_dim, action_dim, static_dim, hidden_dim, t_max=t_max,
                                step_size=step_size, t0=t0, ode_type=method)
    return VIModel(kind="real", encoder_spec=enc, decoder_spec=dec, elbo=False, t0=t0, weight=weight)


def restart_generators(generator: torch.Generator) -> tuple[torch.Generator, torch.Generator]:
    """One restart's (init, train) generators, seeded by two draws from `generator`.

    The counterpart of JAX's `key, k_init, k_train = host_split(key, 3)`: the
    sequential and the batched restart loops draw them alike, so both give
    each restart the same weights, batches and noise.
    """
    seeds = (int(torch.randint(0, 2**62, (), generator=generator)) for _ in range(2))
    return tuple(torch.Generator().manual_seed(s) for s in seeds)


def run_batched_experiment(generator, model, dg, *, n_restart, niters, batch_size, lr, test_freq, path, best_on_disk,
                           early_stop, shuffle, val_criterion, val_t0, curve_path, events_path, device, mesh=None):
    """All restarts as one batched program (`--restart_mode vmap`, or `shard` over a (restart, data) `mesh`);
    -> (params, best_on_disk).

    Draws the sequential loop's restart generators, draw for draw, then runs
    `fused_experiment_loop`. Shared by run_simulation and run_simulation_flow.
    """
    from ..inference.fused import fused_experiment_loop

    pairs = [restart_generators(generator) for _ in range(n_restart)]
    params, best_on_disk, _ = fused_experiment_loop(
        niters=niters, data_generator=dg, model=model, restart_generators=pairs, batch_size=batch_size, lr=lr,
        test_freq=test_freq, path=path, best_on_disk=best_on_disk, early_stop=early_stop, shuffle=shuffle,
        val_criterion=val_criterion, val_t0=val_t0, curve_path=curve_path, events_path=events_path, device=device,
        mesh=mesh)
    return params, best_on_disk


def check_parallel_flags(*, restart_mode, n_restart, dp_devices, restart_devices, eval_mesh, batch_size,
                         init_path, eval_only, device, mc_itr=50) -> int:
    """Refuse what `--dp`, `--restart_mode`, `--restart_devices` and `--eval_mesh` cannot run, with the JAX
    package's messages; -> the ranks the run needs: the larger of its training mesh and its evaluation mesh.

    On CUDA every rank takes a GPU of its own, so a mesh larger than the
    visible GPUs raises JAX's mesh error; on the CPU ranks are gloo processes.
    """
    from ..parallel.eval import check_sharded_eval
    from ..parallel.mesh import require_devices

    if restart_mode != "seq":
        if dp_devices and restart_mode != "shard":
            raise ValueError("--restart_mode=vmap does not compose with --dp; use --restart_mode=shard with --dp "
                             "for a 2-D restart x data mesh")
        if init_path is not None and not eval_only:
            raise ValueError("--restart_mode=vmap/shard does not support --init warm starts; use the default "
                             "--restart_mode=seq")
    dp = dp_devices or 1
    if batch_size % dp:
        raise ValueError(f"batch_size {batch_size} not divisible by dp_devices {dp}")
    if restart_mode == "shard" and not eval_only:
        r = restart_devices or n_restart
        if r > 1 and n_restart % r:
            raise ValueError(f"n_restart {n_restart} not divisible by restart_devices {r}")
        train, what = r * dp, f"{r}x{dp} ('restart', 'data')"
    else:
        train, what = (1, "") if eval_only else (dp, f"{dp}-device 'data'")
    evaluation = 1
    if eval_mesh is not None:
        check_sharded_eval(mc_itr, batch_size, *eval_mesh)
        evaluation = eval_mesh[0] * eval_mesh[1]
    if torch.device(device).type == "cuda":
        gpus = torch.cuda.device_count()
        require_devices(train, what, gpus)
        if eval_mesh is not None:
            require_devices(evaluation, f"{eval_mesh[0]}x{eval_mesh[1]} ('data', 'mc')", gpus)
    return max(train, evaluation)


def _call(fn, kwargs):
    return fn(**kwargs)


def launch_run(run, kwargs: dict, world: int, device, timeout: float | None = None):
    """`run(**kwargs)` on every rank of a new world of `world` ranks (`parallel.launch`, which raises
    `TimeoutError` after `timeout` seconds); -> rank 0's result."""
    from ..parallel.launch import launch

    return launch(_call, world, run, dict(kwargs, device=str(device)), device=device, timeout=timeout)
