"""The networks that the reference's model families share, and their parameters' layout.

Layout of the parameters: a flat dict of name -> tensor. Linear weights are
(in, out) with y = x @ w + b; LSTM gates are stacked i, f, g, o along the
output axis of `w_ih` (in, 4H) and `w_hh` (H, 4H). A layout entry is
name -> (shape, uniform bound), the bound PyTorch's default initialisation
(1/sqrt(fan_in) for a linear, 1/sqrt(hidden) for an LSTM).
"""

from __future__ import annotations

import math

import torch


def lstm_layout(prefix, n_in, hidden):
    bound = 1.0 / math.sqrt(hidden)
    return {f"{prefix}.w_ih": ((n_in, 4 * hidden), bound), f"{prefix}.w_hh": ((hidden, 4 * hidden), bound),
            f"{prefix}.b_ih": ((4 * hidden,), bound), f"{prefix}.b_hh": ((4 * hidden,), bound)}


def linear_layout(prefix, n_in, n_out, bias=True):
    bound = 1.0 / math.sqrt(n_in)
    out = {f"{prefix}.w": ((n_in, n_out), bound)}
    if bias:
        out[f"{prefix}.b"] = ((n_out,), bound)
    return out


def mlp_layout(prefix, dims):
    out = {}
    for i in range(len(dims) - 1):
        out.update(linear_layout(f"{prefix}.{i}", dims[i], dims[i + 1]))
    return out


def linear(p, prefix, x):
    y = x @ p[f"{prefix}.w"]
    b = p.get(f"{prefix}.b")
    return y if b is None else y + b


def mlp(p, prefix, x, n, act=torch.tanh, final=None):
    for i in range(n):
        x = linear(p, f"{prefix}.{i}", x)
        if i < n - 1:
            x = act(x)
        elif final is not None:
            x = final(x)
    return x


def lstm(p, prefix, xs, reverse=False):
    """-> the hidden states (T, B, H) in time order, the LSTM run from the last step down when `reverse`."""
    w_ih, w_hh, b = p[f"{prefix}.w_ih"], p[f"{prefix}.w_hh"], p[f"{prefix}.b_ih"] + p[f"{prefix}.b_hh"]
    hidden = w_hh.shape[0]
    h = c = xs.new_zeros((xs.shape[1], hidden))
    out = [None] * xs.shape[0]
    for t in (range(xs.shape[0] - 1, -1, -1) if reverse else range(xs.shape[0])):
        i, f, g, o = (xs[t] @ w_ih + h @ w_hh + b).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return torch.stack(out)
