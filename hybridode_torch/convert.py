"""Parameters between the JAX package's pytrees and the port's `ParamTree`s.

A JAX parameter tree (nested dicts and lists of arrays, as `init_vi` or
`load_checkpoint` give it) maps onto the port name for name: both packages
keep linear weights `(in, out)` and LSTM gates i, f, g, o, so no array is
transposed or reordered. The 13 expert constants and the ablation thetas come
out with `requires_grad=False`, as the JAX optimizer mask freezes them; the
real track's trees have no such key, and every leaf, the 0-d rate constants
too, trains.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn as torch_nn

from . import resolve_device
from .fields.roche import FROZEN_KEYS
from .models.nn import ParamTree


def params_from_jax(tree: dict, device=None) -> ParamTree:
    """A JAX parameter tree of numpy (or array-like) leaves -> ParamTree on `device`."""
    return ParamTree(_to_tensors(tree), frozen_keys=FROZEN_KEYS).to(resolve_device(device))


def _to_tensors(tree):
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def params_to_jax(params: ParamTree) -> dict:
    """ParamTree -> the JAX package's tree layout, with numpy leaves on the host."""
    tree = {}
    for key in params.keys():
        value = params[key]
        if isinstance(value, ParamTree):
            tree[key] = params_to_jax(value)
        elif isinstance(value, torch_nn.ModuleList):
            tree[key] = [params_to_jax(v) for v in value]
        else:
            tree[key] = value.detach().cpu().numpy()
    return tree
