"""Adam training with the reference's restart, early-stop and best-on-disk rules.

Counterpart of `make_optimizer`, `make_train_step`, `make_eval_loss` and the
host loop of `variational_training_loop` in hybridode/inference/train.py.

* The optimizer is `torch.optim.Adam` over the parameters that require a
  gradient. The 13 expert constants and the ablation thetas are built with
  `requires_grad=False`, which is what the JAX package's label tree does with
  `optax.set_to_zero()` (`param_labels`, train.py:31-46): they never change.
  `train_expert=True` unfreezes them. optax's and PyTorch's Adam compute the
  same update, `lr * m_hat / (sqrt(v_hat) + eps)`, eps outside the root.
* As in the JAX package (train.py:144-165), `variational_training_loop`
  runs a restart by default as the fused loop (`inference/fused.py`: the
  loop's state on the device, one host read per validation window, on CUDA
  the step and the validation as CUDA graphs), which its tests hold equal to
  this host loop. `fused=False` or `HYBRIDODE_FUSED=0` keeps the host loop,
  which checkpoints on every improvement.
* Data parallelism (`dp_devices` above 1, or a 1-D "data" `mesh`) runs either
  loop with the batch's patients split over the ranks of the mesh
  (`parallel/mesh.py`; JAX's train.py:170-192 and fused.py): the global
  batch's noise sliced by rows, one all-reduce of the gradients and the loss
  a step, every rank taking the same decisions from the reduced losses, rank
  0 alone writing checkpoints and logs.
* Solver failure maps to finite-loss gates: a non-finite training loss ends
  the restart, a non-finite validation chunk adds 1e9.

Each iteration of the host loop reads its loss on the host once (the finite
gate), its one device sync per step. Its event log gets a `step` record per
iteration with its seconds, beside the JAX package's `val` and `done`.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable

import numpy as np
import torch

from ..fields.roche import FROZEN_KEYS
from ..utils.logging import CSVCurveLogger, JSONLLogger
from . import checkpoint as ckpt
from .elbo import VIModel, forecast_loss, loss_fn


def unfreeze_expert(params) -> None:
    """Let the frozen expert leaves of `params` train (`train_expert=True`)."""
    frozen = tuple(f"decoder.ode.{k}" for k in FROZEN_KEYS)
    for name, p in params.named_parameters():
        if name.startswith(frozen):
            p.requires_grad_(True)


def make_optimizer(lr: float, params, train_expert: bool = False) -> torch.optim.Adam:
    """Adam over the trainable leaves; with `train_expert` the frozen expert leaves train too."""
    if train_expert:
        unfreeze_expert(params)
    return torch.optim.Adam([p for p in params.parameters() if p.requires_grad], lr=lr)


def train_step(params, optimizer: torch.optim.Optimizer, model: VIModel, batch, generator) -> torch.Tensor:
    """One Adam step on `loss_fn`; returns the loss (on the device, detached)."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(params, model, batch, generator)
    loss.backward()
    optimizer.step()
    return loss.detach()


def make_eval_loss(model: VIModel, val_criterion: str = "elbo", val_t0: int = 5) -> Callable:
    """(params, batch, generator) -> validation loss, without gradient."""

    @torch.no_grad()
    def eval_loss(params, batch, generator):
        if val_criterion == "forecast":
            return forecast_loss(params, model, batch, val_t0)
        return loss_fn(params, model, batch, generator)

    return eval_loss


def check_dp_divisibility(n: int, train_width: int, val_width: int) -> None:
    """The widths a data-parallel loop splits over `n` ranks (JAX's fused.py:129-139 messages)."""
    if train_width % n:
        raise ValueError(f"train mini-batch width {train_width} not divisible by dp_devices {n}")
    if val_width % n:
        raise ValueError(f"validation chunk width {val_width} not divisible by dp_devices {n}")


def reload_best(path: str, model_name: str, params, best_on_disk: float, device, mesh=None):
    """-> (the best checkpoint at `path` on `device`, its loss); when none was written, `params` is saved there
    first (itr 0, `best_on_disk`).

    With a `mesh`, rank 0 alone writes and every rank of the mesh reads after
    its write; they all take the same branch, since the file's presence is
    looked up between two barriers.
    """
    from ..parallel.launch import is_writer
    from ..parallel.mesh import barrier

    full = path + model_name
    barrier(mesh)
    missing = not os.path.exists(full)
    barrier(mesh)
    if missing:
        if is_writer():
            ckpt.save_checkpoint(path, model_name, params, 0, best_on_disk)
        barrier(mesh)
    best_params, _, best_on_disk = ckpt.load_checkpoint(path, model_name, device)
    return best_params, best_on_disk


def variational_training_loop(
    niters: int,
    data_generator: Any,
    model: VIModel,
    params,
    batch_size: int,
    lr: float,
    test_freq: int,
    generator: torch.Generator,
    best_on_disk: float = 1e9,
    early_stop: int = 5,
    path: str = "model/",
    shuffle: bool = True,
    train_fold: str = "train",
    train_expert: bool = False,
    verbose: bool = True,
    curve_path: str | None = None,
    events_path: str | None = None,
    val_criterion: str = "elbo",
    val_t0: int = 5,
    dp_devices: int | None = None,
    fused: bool | None = None,
    mesh=None,
):
    """Train `params` in place; return (best params reloaded from disk, best_on_disk, wall seconds).

    `params` and the cohort's tensors live on one device. All noise (the
    ELBO's draws and the seed of the numpy mini-batch RNG) comes from the CPU
    `generator`. Checkpoints go to `path + model.model_name` whenever
    validation beats `best_on_disk`, the best across restarts; the best
    checkpoint is reloaded at the end, or the current parameters are saved if
    none was written.

    `fused`: None runs the fused loop (`inference/fused.py`) unless
    `HYBRIDODE_FUSED=0`, for a cohort with `_fold` (every cohort of the
    port), as the JAX package does; it checkpoints once at the end of the
    restart (and every `HYBRIDODE_FLUSH_EVERY`-th window). False runs this
    host loop.

    `dp_devices` above 1 trains data-parallel over a 1-D "data" mesh of the
    first `dp_devices` ranks of the world (`parallel.make_mesh`), `mesh` over
    a mesh already made (of one rank too); every rank of the mesh calls this
    with the same arguments (with `dp_devices`, every rank of the world, since
    making the mesh is collective: ranks outside it return at once). The
    train and validation widths must divide the mesh's size.
    """
    from ..parallel.launch import is_writer
    from ..parallel.mesh import make_mesh, member

    if mesh is None and dp_devices is not None and dp_devices > 1:
        mesh = make_mesh(dp_devices)
    if mesh is not None and not member(mesh):
        return params, best_on_disk, 0.0
    if fused is None:
        fused = os.environ.get("HYBRIDODE_FUSED", "1") != "0"
    if fused and hasattr(data_generator, "_fold"):
        from .fused import fused_training_loop

        return fused_training_loop(
            niters=niters, data_generator=data_generator, model=model, params=params, batch_size=batch_size,
            lr=lr, test_freq=test_freq, generator=generator, best_on_disk=best_on_disk, early_stop=early_stop,
            path=path, shuffle=shuffle, train_fold=train_fold, train_expert=train_expert, verbose=verbose,
            curve_path=curve_path, events_path=events_path, val_criterion=val_criterion, val_t0=val_t0, mesh=mesh)
    device = next(params.parameters()).device
    optimizer = make_optimizer(lr, params, train_expert)
    if mesh is None:
        eval_loss = make_eval_loss(model, val_criterion, val_t0)

        def step(batch):
            return train_step(params, optimizer, model, batch, generator)
    else:
        from ..parallel.mesh import make_dp_eval_loss, make_dp_train_step

        n = mesh.size()
        check_dp_divisibility(n, batch_size, min(batch_size, data_generator.val_size))
        dp_step = make_dp_train_step(model, optimizer, mesh)
        eval_loss = make_dp_eval_loss(model, mesh, val_criterion=val_criterion, val_t0=val_t0)

        def step(batch):
            return dp_step(params, batch, generator)

    writer = is_writer()
    verbose = verbose and writer

    best_loss = 1e9
    early_stop_counter = 0
    fold_size = data_generator.train_size if train_fold == "train" else data_generator.val_size
    train_chunk = max(1, fold_size // batch_size)
    val_chunks = max(1, data_generator.val_size // batch_size)

    curve = CSVCurveLogger(curve_path if writer else None)
    events = JSONLLogger(events_path if writer else None)
    try:
        rng = np.random.RandomState(int(torch.randint(0, 2**31 - 1, (), generator=generator)))
        start = time.time()

        for itr in range(1, niters + 1):
            with events.span("step", itr=itr) as step_span:
                if shuffle:
                    batch = data_generator.get_mini_batch(train_fold, batch_size, rng)
                else:
                    batch = data_generator.get_split(train_fold, batch_size, itr % train_chunk)
                loss = float(step(batch))
                step_span.fields["train_loss"] = loss

            if not np.isfinite(loss):
                if verbose:
                    print("non-finite training loss; stopping this restart")
                break

            if itr % test_freq == 0:
                total_loss = 0.0
                for chunk in range(val_chunks):
                    vbatch = data_generator.get_split("val", batch_size, chunk)
                    chunk_loss = float(eval_loss(params, vbatch, generator))
                    total_loss += chunk_loss if np.isfinite(chunk_loss) else 1e9
                if verbose:
                    print("Iter {:04d} | Total Loss {:.6f} | Train Loss {:.6f}".format(itr, total_loss, loss))
                curve.log(itr, total_loss, loss)
                events.log("val", itr=itr, val_loss=total_loss, train_loss=loss)
                if total_loss < best_loss:
                    best_loss = total_loss
                    early_stop_counter = 0
                else:
                    early_stop_counter += 1

                if total_loss < best_on_disk:
                    best_on_disk = total_loss
                    if writer:
                        ckpt.save_checkpoint(path, model.model_name, params, itr, best_on_disk)

            if early_stop_counter >= early_stop:
                break

        wall = time.time() - start
        events.log("done", wall=wall, best_on_disk=float(best_on_disk))
    finally:
        curve.close()
        events.close()

    best_params, best_on_disk = reload_best(path, model.model_name, params, best_on_disk, device, mesh)
    if verbose:
        print("Time: {}".format(wall))
        print("Overall best loss: {:.6f}".format(best_on_disk))
    return best_params, best_on_disk, wall
