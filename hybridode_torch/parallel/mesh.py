"""Data parallelism over a device mesh of ranks (counterpart of hybridode/parallel/mesh.py).

The reference is single-device; its natural scaling axis is the patient
(batch) axis of the time-major (T, B, D) tensors, so the parallel layer is
1-D batch data parallelism, as in the JAX package:

* parameters and optimizer state are replicated, every rank holds the
  global batch and works on its block of dim 1 (`shard_batch`);
* the per-rank loss is sum/B_local, so its mean over ranks is the global
  sum/B exactly; gradients are averaged (JAX's `pmean`, mesh.py:56-91);
* all gradients and the loss go through ONE preallocated flat buffer and one
  all-reduce a step (`FlatMean`), which a captured CUDA graph can hold;
* noise: JAX folds the axis index into each shard's key (mesh.py:66), so its
  DP noise is not its single-device noise. Here every rank draws the global
  batch's noise from the identical CPU generator and takes its own rows
  (`block`), so DP training equals single-process training, noise included.

A mesh is a `DeviceMesh` over the first ranks of the world (`launch.py`);
ranks outside it get no coordinate and wait. Every rank of the world calls
`make_mesh` / `make_mesh_2d`, which are collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..inference.elbo import VIModel, _fixed_point_draw, draw_loss_noise, forecast_loss_terms, loss_fn
from .launch import world_size


def require_devices(n: int, what: str, available: int) -> None:
    """JAX's mesh error, for a mesh of `n` devices (`what` names its shape) where `available` exist."""
    if n > available:
        raise ValueError(f"requested a {what} mesh but only {available} devices are available")


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _warm(mesh) -> None:
    """One eager collective on every group of the mesh this rank belongs to: NCCL makes a communicator at its
    first collective, which must not happen inside a capture."""
    if mesh.get_coordinate() is None or _device_type() != "cuda":
        return
    for name in mesh.mesh_dim_names:
        dist.all_reduce(torch.zeros(1, device="cuda"), group=mesh.get_group(name))
    torch.cuda.synchronize()


def _mesh(shape: tuple, names: tuple, what: str):
    n = 1
    for s in shape:
        n *= s
    require_devices(n, what, world_size())
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: run under parallel.launch or call parallel.init_world")
    mesh = init_device_mesh(_device_type(), shape, mesh_dim_names=names)
    _warm(mesh)
    return mesh


def make_mesh(n_devices: int | None = None, axis_name: str = "data"):
    """1-D mesh over the first `n_devices` ranks of the world (all of them when None)."""
    n = world_size() if n_devices is None else int(n_devices)
    return _mesh((n,), (axis_name,), f"{n}-device '{axis_name}'")


def make_mesh_2d(n_a: int, n_b: int, axis_names=("data", "mc")):
    """2-D mesh over the first n_a * n_b ranks (default axes (data, mc); (restart, data) for the experiment)."""
    return _mesh((n_a, n_b), tuple(axis_names), f"{n_a}x{n_b} {tuple(axis_names)}")


def member(mesh) -> bool:
    return mesh.get_coordinate() is not None


def axis(mesh, name: str):
    """-> (process group, this rank's index, size) of the mesh axis `name`."""
    dim = mesh.mesh_dim_names.index(name)
    return mesh.get_group(name), mesh.get_local_rank(name), mesh.shape[dim]


def block(t: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    """Block `index` of `n` equal blocks of `t` along `dim` (a view)."""
    b = t.shape[dim] // n
    return t.narrow(dim, index * b, b)


def shard_batch(batch: dict, mesh, axis_name: str = "data") -> dict:
    """This rank's block of the batch axis (dim 1 of the time-major (T, B, D) tensors)."""
    _, i, n = axis(mesh, axis_name)
    width = next(iter(batch.values())).shape[1]
    if width % n:
        raise ValueError(f"a batch of {width} does not split over the {n} ranks of the '{axis_name}' axis")
    return {k: block(v, 1, i, n) for k, v in batch.items()}


def shard_noise(noise, mesh, axis_name: str = "data"):
    """This rank's rows of the global batch's noise: the batch axis is dim -2 of every draw ((B, D),
    (mc, B, D), and the same with leading iteration, window or lane axes)."""
    _, i, n = axis(mesh, axis_name)
    return tuple(None if t is None else block(t, -2, i, n) for t in noise)


def forecast_terms(params, model: VIModel, local: dict, t0: int, mesh=None, axis_name: str = "data"):
    """`forecast_loss_terms` (stacked) of this rank's block `local`; under a `mesh` the flow's fixed point draw
    is this rank's rows of the global batch's draw, so that the summed terms are the single-process terms."""
    eps_point = None
    if model.kind == "flow" and mesh is not None:
        _, i, n = axis(mesh, axis_name)
        x = local["measurements"]
        shape = (x.shape[1] * n, model.encoder_spec.output_dim)
        eps_point = block(_fixed_point_draw(shape, x.dtype, x.device), 0, i, n)
    return torch.stack(forecast_loss_terms(params, model, local, t0, eps_point=eps_point))


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over `group`; counts its calls (`all_reduce_sum.calls`)."""
    all_reduce_sum.calls += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


all_reduce_sum.calls = 0


def all_gather_rows(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The `n` ranks' `t` concatenated along dim 0 in rank order (JAX's tiled `all_gather`)."""
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def barrier(mesh=None) -> None:
    """Wait for every rank of `mesh`: one all-reduce along each of its axes in turn (after the first axis a
    rank knows its row arrived, after the second that every row did). Nothing without a mesh.

    The host waits too: an NCCL all-reduce returns at once, its kernel queued,
    so on CUDA the device is synchronised before this returns. Without it two
    ranks read the file system on either side of rank 0's write and took
    different branches of `reload_best`, one collective apart: the next
    collective never completed (the two-world check on four H100s).
    """
    if mesh is None:
        return
    on = "cuda" if _device_type() == "cuda" else "cpu"
    for name in mesh.mesh_dim_names:
        dist.all_reduce(torch.zeros(1, device=on), group=mesh.get_group(name))
    if on == "cuda":
        torch.cuda.synchronize()


def replicate(tree, group=None, src: int = 0):
    """Broadcast the parameter tree `tree` in place from rank `src` of `group` (of the world when None), every
    parameter, frozen ones included, through one flat buffer; -> `tree`."""
    src = dist.get_global_rank(group, src) if group is not None else src
    leaves = list(tree.parameters())
    with torch.no_grad():
        flat = torch.cat([p.detach().reshape(-1) for p in leaves])
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        for p in leaves:
            p.copy_(flat[offset:offset + p.numel()].view_as(p))
            offset += p.numel()
    return tree


class FlatMean:
    """The mean over a group of a fixed list of float32 tensors, through one preallocated flat buffer.

    `__call__(tensors)` copies them into the buffer, makes one all-reduce
    (sum) and one division by the group's size (JAX's `pmean`: psum, then
    divide), and returns views of the buffer shaped as the inputs, valid
    until the next call. The buffer's address never changes, as a CUDA graph
    that holds the all-reduce needs. `None` entries (unused leaves) stay
    `None` and take no room.
    """

    def __init__(self, like, group, n: int):
        self.group, self.n = group, n
        self.present = [t is not None for t in like]
        kept = [t for t in like if t is not None]
        if any(t.dtype != torch.float32 for t in kept):
            raise TypeError("FlatMean reduces float32 tensors")
        self.flat = torch.zeros(sum(t.numel() for t in kept), dtype=torch.float32, device=kept[0].device)
        self.views, offset = [], 0
        for t in kept:
            self.views.append(self.flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()

    def __call__(self, tensors):
        with torch.no_grad():
            kept = [t for t in tensors if t is not None]
            for v, t in zip(self.views, kept):
                v.copy_(t)
            all_reduce_sum(self.flat, self.group)
            self.flat.div_(self.n)
        views = iter(self.views)
        return [next(views) if p else None for p in self.present]


def make_dp_train_step(model: VIModel, optimizer: torch.optim.Optimizer, mesh, axis_name: str = "data"):
    """DP training step `step(params, batch, generator) -> loss` (on the device), params updated in place.

    `batch` is the global batch, held whole by every rank; each rank draws
    the global batch's noise from `generator` (all ranks' generators in one
    state) and takes its block of both. The loss is the mean of the ranks'
    losses, which equals the single-process loss of the global batch; the
    gradients are averaged the same way, then `optimizer` steps.
    """
    group, _, n = axis(mesh, axis_name)
    leaves = [p for g in optimizer.param_groups for p in g["params"]]
    reducer = None

    def step(params, batch, generator):
        nonlocal reducer
        noise = draw_loss_noise(model, batch["measurements"].shape[1], generator, batch["measurements"].device)
        eps, eps_kl = shard_noise(noise, mesh, axis_name)
        loss = loss_fn(params, model, shard_batch(batch, mesh, axis_name), eps=eps, eps_kl=eps_kl)
        local = [loss.detach()] + list(torch.autograd.grad(loss, leaves, allow_unused=True))
        reducer = reducer or FlatMean(local, group, n)
        loss, *grads = reducer(local)
        for p, g in zip(leaves, grads):
            p.grad = g
        optimizer.step()
        return loss.clone()

    return step


def make_dp_eval_loss(model: VIModel, mesh, axis_name: str = "data", val_criterion: str = "elbo", val_t0: int = 5):
    """Replicated parameters, sharded batch: `eval_loss(params, batch, generator)` -> the global loss (0-d).

    `elbo`: the mean of the ranks' losses, each on its rows of the global
    noise (JAX's `make_dp_eval_loss`). `forecast`: the masked squared-error
    sums and mask counts are summed over the ranks and divided once, never a
    mean of per-rank ratios (JAX's fused.py:166-171).
    """
    group, _, n = axis(mesh, axis_name)

    @torch.no_grad()
    def eval_loss(params, batch, generator):
        local = shard_batch(batch, mesh, axis_name)
        if val_criterion == "forecast":
            num, den = all_reduce_sum(forecast_terms(params, model, local, val_t0, mesh, axis_name), group)
            return num / torch.clamp(den, min=1.0)
        noise = draw_loss_noise(model, batch["measurements"].shape[1], generator, batch["measurements"].device)
        eps, eps_kl = shard_noise(noise, mesh, axis_name)
        return all_reduce_sum(loss_fn(params, model, local, eps=eps, eps_kl=eps_kl).reshape(1), group)[0] / n

    return eval_loss
