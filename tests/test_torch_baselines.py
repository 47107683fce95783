"""Port vs JAX: the LSTMBaseline (models/encoders.py `lstm_baseline_*`) on the CPU.

JAX's parameters go through the port's conversion (`convert.params_from_jax`)
and back; non-square widths throughout (input 5 + 1 + 2 = 8, hidden 7,
output 5), so an (in, out) against (out, in) or a gate-order mistake cannot
hide. The forward pass, the masked next-step loss and its gradient against
`jax.grad`, with a mask that drops entries: rtol 1e-5, atol 1e-6 for the
outputs and the loss (tests/test_torch_nn.py's tolerance: XLA and PyTorch
sum their matrix products in other orders), rtol 1e-4, atol 1e-6 for the
gradients (that rounding carried back through 6 LSTM steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hybridode.models import encoders as j_encoders
from hybridode_torch.convert import params_from_jax, params_to_jax
from hybridode_torch.models import encoders

T, B, OBS, ACT, STAT, HIDDEN = 6, 4, 5, 1, 2, 7
RTOL, ATOL, GRAD_RTOL = 1e-5, 1e-6, 1e-4


def _batch():
    rng = np.random.RandomState(0)
    return {"measurements": rng.randn(T, B, OBS).astype(np.float32),
            "actions": (rng.rand(T, B, ACT) * 0.5).astype(np.float32),
            "masks": (rng.rand(T, B, OBS) < 0.6).astype(np.float32),
            "statics": np.broadcast_to(rng.randn(1, B, STAT), (T, B, STAT)).astype(np.float32)}


def _case():
    spec = encoders.LSTMBaselineSpec(OBS + ACT + STAT, HIDDEN, OBS)
    j_spec = j_encoders.LSTMBaselineSpec(OBS + ACT + STAT, HIDDEN, OBS)
    jp = j_encoders.init_lstm_baseline(jax.random.PRNGKey(0), j_spec)
    return spec, j_spec, jp, params_from_jax(jp, device="cpu")


def test_spec_and_init_have_jaxs_layout():
    spec, j_spec, jp, p = _case()
    assert spec == tuple(j_spec) and spec.model_name == "LSTMBaseline"
    mine = encoders.init_lstm_baseline(torch.Generator().manual_seed(0), spec, device="cpu")
    want = {k: np.asarray(v).shape for k, v in jax.tree_util.tree_leaves_with_path(jp)}
    got = {k: v.shape for k, v in jax.tree_util.tree_leaves_with_path(params_to_jax(mine))}
    assert got == want
    assert all(x.requires_grad for x in p.parameters())  # every leaf trains: no frozen key


def test_forward_and_loss_match_jax():
    spec, j_spec, jp, p = _case()
    batch = _batch()
    a_in = np.concatenate([batch["actions"], batch["statics"]], -1)
    want = j_encoders.lstm_baseline_apply(jp, j_spec, jnp.asarray(batch["measurements"]), jnp.asarray(a_in),
                                          jnp.asarray(batch["masks"]))
    with torch.no_grad():
        got = encoders.lstm_baseline_apply(p, spec, torch.from_numpy(batch["measurements"]), torch.from_numpy(a_in),
                                           torch.from_numpy(batch["masks"]))
        loss = encoders.lstm_baseline_loss(p, spec, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (T, B, OBS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    j_loss = j_encoders.lstm_baseline_loss(jp, j_spec, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)


def test_gradient_matches_jax():
    spec, j_spec, jp, p = _case()
    batch = _batch()
    want = jax.grad(j_encoders.lstm_baseline_loss)(jp, j_spec, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = encoders.lstm_baseline_loss(p, spec, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    grads = {n: x.grad for n, x in p.named_parameters()}
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(want)}
    assert sorted(flat) == sorted(grads)
    for name, g in grads.items():
        assert float(g.abs().sum()) > 0, name
        np.testing.assert_allclose(g.numpy(), flat[name], rtol=GRAD_RTOL, atol=ATOL, err_msg=name)
