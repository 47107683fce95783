"""Parameter trees and the minimal NN primitives (counterpart of hybridode/models/nn.py).

Parameters live in a `ParamTree`: an `nn.Module` that mirrors the JAX
package's parameter pytree key for key (dicts become submodules, lists
`nn.ModuleList`s, arrays `nn.Parameter`s). So `named_parameters()` yields
the JAX tree's paths ("decoder.ode.ml_net.0.w"), the plain functions below
index parameters exactly as the JAX functions do (`p["w"]`), and
`.to(device)`, `.parameters()` and `state_dict()` work as for any module.

Layouts are the JAX package's: linear weights are `(in, out)` with
`y = x @ w`; LSTM gates are stacked i, f, g, o. Initialisers draw PyTorch's
default uniform bounds (1/sqrt(fan_in) for linears, 1/sqrt(hidden) for the
LSTM) from a CPU `torch.Generator`, so one seed gives the same weights
whichever device they are moved to.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..config import DTYPE


class ParamTree(nn.Module):
    """A JAX-style parameter pytree held as a module.

    Leaves under a key in `frozen_keys` (and everything below such a key)
    get `requires_grad=False`.
    """

    def __init__(self, tree: dict, frozen_keys: Sequence[str] = (), frozen: bool = False):
        super().__init__()
        for key, value in tree.items():
            f = frozen or key in frozen_keys
            if isinstance(value, nn.Module):
                self.add_module(key, value)
            elif isinstance(value, dict):
                self.add_module(key, ParamTree(value, frozen_keys, f))
            elif isinstance(value, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v, frozen_keys, f) for v in value))
            else:
                self.register_parameter(key, nn.Parameter(torch.as_tensor(value), requires_grad=not f))

    def __getitem__(self, key):
        if key not in self:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules

    def keys(self):
        return list(self._parameters) + list(self._modules)


def _uniform(generator, shape, bound, dtype=DTYPE):
    return torch.empty(shape, dtype=dtype).uniform_(-bound, bound, generator=generator)


# --- Linear ---------------------------------------------------------------------


def linear_init(generator, in_dim: int, out_dim: int, bias: bool = True, dtype=DTYPE) -> dict:
    bound = 1.0 / math.sqrt(in_dim)
    p = {"w": _uniform(generator, (in_dim, out_dim), bound, dtype)}
    if bias:
        p["b"] = _uniform(generator, (out_dim,), bound, dtype)
    return p


def linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# --- MLP (sequence of Linear + activation) ----------------------------------------


def mlp_init(generator, dims: Sequence[int], bias: bool = True, dtype=DTYPE) -> list:
    return [linear_init(generator, dims[i], dims[i + 1], bias=bias, dtype=dtype) for i in range(len(dims) - 1)]


def mlp(params, x, activation=torch.tanh, final_activation=None):
    """Apply Linear/act/.../Linear[/final_act]."""
    n = len(params)
    for i, p in enumerate(params):
        x = linear(p, x)
        if i < n - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


# --- LSTM -----------------------------------------------------------------------


def lstm_init(generator, in_dim: int, hidden_dim: int, dtype=DTYPE) -> dict:
    bound = 1.0 / math.sqrt(hidden_dim)
    return {
        "w_ih": _uniform(generator, (in_dim, 4 * hidden_dim), bound, dtype),
        "w_hh": _uniform(generator, (hidden_dim, 4 * hidden_dim), bound, dtype),
        "b_ih": _uniform(generator, (4 * hidden_dim,), bound, dtype),
        "b_hh": _uniform(generator, (4 * hidden_dim,), bound, dtype),
    }


def lstm_cell(p, x, state):
    """One LSTM step: x (B, in), state ((B, H), (B, H)) -> (h, (h, c))."""
    h, c = state
    gates = x @ p["w_ih"] + h @ p["w_hh"] + p["b_ih"] + p["b_hh"]
    i, f, g, o = gates.chunk(4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c = f * c + i * g
    h = o * torch.tanh(c)
    return h, (h, c)


def lstm_scan(p, xs, hidden_dim: int, reverse: bool = False, return_all: bool = False):
    """Run an LSTM over a (T, B, in) sequence with a Python loop over T.

    Deliberately not `nn.LSTM`: cuDNN would put a library kernel on the path.
    With reverse=True the sequence is consumed from t=T-1 down to 0 and the
    returned "final" output is the one produced at t=0.
    """
    T, B = xs.shape[0], xs.shape[1]
    state = (xs.new_zeros((B, hidden_dim)), xs.new_zeros((B, hidden_dim)))
    hs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hs[t], state = lstm_cell(p, xs[t], state)
    if return_all:
        return torch.stack(hs)  # (T, B, H)
    return hs[0] if reverse else hs[-1]


def elu(x):
    return torch.nn.functional.elu(x)
