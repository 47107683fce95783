"""The weights of a run, drawn from its seed on the device, and their copy into the program's parameters."""

from __future__ import annotations

import torch

from ..reference import model as ref


def make(cfg: dict, seed: int, device) -> dict:
    """name -> float32 tensor on `device`: every trainable leaf uniform in its bound, from one draw of a generator
    on the device seeded with `seed`; the expert's constants at their published values."""
    leaves, consts = ref.layout(cfg)
    sizes = [torch.Size(shape).numel() for shape, _ in leaves.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32).mul_(2).sub_(1)
    out, lo = {}, 0
    for (name, (shape, bound)), n in zip(leaves.items(), sizes):
        out[name] = flat[lo:lo + n].reshape(shape) * bound
        lo += n
    for name, value in consts.items():
        out[name] = torch.tensor(value, dtype=torch.float32, device=device)
    return out


@torch.no_grad()
def load_into(params, weights: dict) -> None:
    """Copy `weights` into the program's parameter module, leaf by leaf by name; raises unless the names and
    shapes are exactly the benchmark's."""
    named = dict(params.named_parameters())
    if set(named) != set(weights):
        raise ValueError(f"the program's parameters differ from the benchmark's layout: "
                         f"{sorted(set(named) ^ set(weights))}")
    for name, p in named.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: the program has shape {tuple(p.shape)}, the benchmark "
                             f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])
