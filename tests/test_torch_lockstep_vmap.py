"""The lockstep adjoint under `torch.func.vmap` (the batched restarts) and `--restart_mode vmap|shard --step_control
lockstep`, on the CPU.

Under vmap each lane is a lockstep solve of its own (`solvers/adjoint.py`'s
`vmap` rule runs the plain solve on each lane's state and tensors in turn and
stacks the results). What must hold:

* float64, the hybrid Roche field of the CLI's cohort (6 patients a lane,
  three lanes of other parameters and doses, lockstep and per row): each
  lane takes its own solve's trial and accepted steps, and its trajectory
  and gradients (y0 and every trainable leaf) are that solve's within rtol
  1e-10 (the lanes' loss is summed outside the vmap, as the batched
  restarts take it); a lane that overflows its record warns once a call;
* float64 against JAX's `jax.vmap` of its own lockstep adjoint solve (the
  nonlinear field of tests/test_torch_adjoint.py, a rate and a forcing
  per lane): the same step counts, gradients within that file's rtol 1e-6;
* float32, `run_simulation.run` of the lockstep hybrid on a small
  JAX-generated cohort, 2 restarts of 2 iterations with forecast validation
  after each: `--restart_mode vmap` against `seq`, the first validation of
  each restart within rtol 1e-4 (tests/test_torch_adjoint.py's lockstep CLI
  tolerance: the vmapped encoder sums its matrix products in another order,
  and a lockstep step sequence follows such bits), the same validation
  iterations and checkpoint iteration, the best loss within rtol 1e-4;
  `--restart_mode shard` over 2 gloo ranks (one lane a rank) against vmap:
  the best loss within rtol 1e-5 and the same checkpoint iteration.
"""

import copy
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridode.config import RocheConfig as JRocheConfig
from hybridode.data import SyntheticCohort as JSyntheticCohort
from hybridode.solvers import odeint_dopri5_adjoint as j_odeint_dopri5_adjoint
from hybridode_torch.cli import run_simulation
from hybridode_torch.config import DataConfig, EvalConfig, OptimConfig
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.fields import DoseContext, doses_from_actions, init_roche_field, roche_field
from hybridode_torch.inference import load_checkpoint
from hybridode_torch.solvers import odeint_dopri5_adjoint

COHORT = os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl")
R, B, LATENT = 3, 6, 6
LANE_RTOL, JAX_RTOL, RUN_RTOL, SHARD_RTOL = 1e-10, 1e-6, 1e-4, 1e-5


def _lanes(dtype=torch.float64):
    """Three lanes: the Roche hybrid field at three random inits (their ml remainders and, on lanes 1 and 2, rates
    moved by 5 %), the initial latents and doses of three blocks of 6 patients of data_s123."""
    c = SyntheticCohort.load(COHORT, device="cpu")
    odes, ctxs, y0 = [], [], []
    for r in range(R):
        ode = init_roche_field(torch.Generator().manual_seed(r), LATENT, device="cpu").to(dtype)
        with torch.no_grad():
            for p in ode["expert"].parameters():
                p.mul_(1.0 + 0.05 * r)
        batch = c.get_split("train", B, r * B)
        ctx = doses_from_actions(batch["actions"].to(dtype), 1.0)
        odes.append(ode)
        ctxs.append(ctx)
        y0.append(torch.rand(B, LATENT, generator=torch.Generator().manual_seed(10 + r), dtype=dtype) * 2)
    return odes, ctxs, torch.stack(y0)


def _loss(ys):
    return (ys[1:] ** 2).sum() + ys[-1].sum()


SOLVE = dict(rtol=1e-7, atol=1e-8, max_steps=4096)


def _solo(ode, ctx, y0, per_row, **kw):
    y = y0.clone().requires_grad_()
    ys, st = odeint_dopri5_adjoint(roche_field, y, torch.arange(15, dtype=y0.dtype), (ode, ctx), per_row=per_row,
                                   **(SOLVE | kw))
    leaves = [p for p in ode.parameters() if p.requires_grad]
    grads = torch.autograd.grad(_loss(ys), [y] + leaves)
    return ys.detach(), st, grads


class _Lane(torch.nn.Module):
    def __init__(self, ode, per_row, kw):
        super().__init__()
        self.ode, self.per_row, self.kw = ode, per_row, kw

    def forward(self, y, times, amounts):
        ys, st = odeint_dopri5_adjoint(roche_field, y, torch.arange(15, dtype=y.dtype),
                                       (self.ode, DoseContext(times, amounts)), per_row=self.per_row,
                                       **(SOLVE | self.kw))
        return ys, _loss(ys), st.n_steps, st.n_accepted, st.recorded_all


def _vmapped(odes, ctxs, y0, per_row, **kw):
    stacked, _ = torch.func.stack_module_state(odes)
    base = _Lane(copy.deepcopy(odes[0]).to("meta"), per_row, kw)
    names = [n for n, p in odes[0].named_parameters() if p.requires_grad]

    def lane(params, y, times, amounts):
        return torch.func.functional_call(base, {"ode." + n: p for n, p in params.items()}, (y, times, amounts))

    y = y0.clone().requires_grad_()
    times, amounts = torch.stack([c.times for c in ctxs]), torch.stack([c.amounts for c in ctxs])
    ys, loss, n_steps, n_acc, recorded = torch.func.vmap(lane)(stacked, y, times, amounts)
    grads = torch.autograd.grad(loss.sum(), [y] + [stacked[n] for n in names])
    return ys.detach(), n_steps, n_acc, recorded, grads


@pytest.mark.parametrize("per_row", [False, True], ids=["lockstep", "per_row"])
def test_each_lane_takes_its_own_solves_steps_and_gradients(per_row):
    odes, ctxs, y0 = _lanes()
    ys, n_steps, n_acc, recorded, grads = _vmapped(odes, ctxs, y0, per_row)
    for r in range(R):
        want_ys, st, want = _solo(odes[r], ctxs[r], y0[r], per_row)
        assert torch.equal(n_steps[r], st.n_steps) and torch.equal(n_acc[r], st.n_accepted), r
        assert bool(recorded[r].all())
        np.testing.assert_allclose(ys[r].numpy(), want_ys.numpy(), rtol=LANE_RTOL,
                                   atol=LANE_RTOL * float(want_ys.abs().max()))
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g[r].numpy(), w.numpy(), rtol=LANE_RTOL, atol=LANE_RTOL * float(w.abs().max()))
    if not per_row:  # the lanes end at other trial counts, each at its own
        assert len(set(n_steps.tolist())) > 1


def test_a_lane_that_overflows_its_record_warns_once_a_call():
    """max_record 64 < the accepted steps of two of the lanes: one RuntimeWarning for the call, recorded_all False
    on those lanes, as their own solves report it."""
    odes, ctxs, y0 = _lanes()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        _, _, n_acc, recorded, _ = _vmapped(odes, ctxs, y0, False, max_record=64)
    assert [w.category for w in seen if "max_record" in str(w.message)] == [RuntimeWarning]
    assert recorded.tolist() == (n_acc <= 64).tolist() and not bool(recorded.all())
    for r in range(R):
        with pytest.warns(RuntimeWarning, match="max_record") if n_acc[r] > 64 else warnings.catch_warnings():
            _, st, _ = _solo(odes[r], ctxs[r], y0[r], False, max_record=64)
        assert bool(st.recorded_all) == bool(recorded[r])


def test_vmapped_lockstep_matches_jax_vmap_of_its_adjoint():
    """dy/dt = -lam y + w sin(t) y^2 on 2 rows a lane, lam and w per lane: jax.vmap of JAX's lockstep adjoint
    solve against torch.func.vmap of the port's; the same trial and accepted steps a lane, gradients of the
    summed loss with respect to y0, lam and w within rtol 1e-6."""
    ts = np.linspace(0.0, 3.0, 7)
    y0 = np.array([[[0.3, 0.8], [0.5, 0.1]], [[0.9, 0.2], [0.4, 0.4]], [[0.1, 0.6], [0.7, 0.3]]])
    lam, w = np.array([0.9, 0.5, 1.4]), np.array([0.2, 0.7, 0.4])

    def loss_of(ys):
        return (ys[1:] ** 2).sum() + (ys[3] * 0.5).sum()

    with jax.enable_x64(True):
        def j_lane(y, k, v):
            ys, st = j_odeint_dopri5_adjoint(lambda t, y, a: -a[0] * y + a[1] * jnp.sin(t) * y**2, y,
                                             jnp.asarray(ts), (k, v), rtol=1e-8, atol=1e-10, max_steps=512)
            return loss_of(ys), (st.n_steps, st.n_accepted)

        def j_total(y, k, v):
            loss, counts = jax.vmap(j_lane)(y, k, v)
            return loss.sum(), counts

        (_, j_counts), want = jax.value_and_grad(j_total, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(y0), jnp.asarray(lam), jnp.asarray(w))

    def lane(y, k, v):
        ys, st = odeint_dopri5_adjoint(lambda t, y, a: -a[0] * y + a[1] * torch.sin(t) * y**2, y, torch.tensor(ts),
                                       (k, v), rtol=1e-8, atol=1e-10, max_steps=512)
        return loss_of(ys), st.n_steps, st.n_accepted

    y, k, v = (torch.tensor(x, requires_grad=True) for x in (y0, lam, w))
    loss, n_steps, n_acc = torch.func.vmap(lane)(y, k, v)
    loss.sum().backward()
    assert n_steps.tolist() == np.asarray(j_counts[0]).tolist()
    assert n_acc.tolist() == np.asarray(j_counts[1]).tolist()
    assert len(set(n_steps.tolist())) > 1
    for got, ref in zip((y.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=JAX_RTOL)


# --- the CLI: vmap and shard against seq -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    """32 patients (16 train, 8 val, 8 test), obs 8, latent 6, generated by the JAX package."""
    dg = JSyntheticCohort(n_sample=32, obs_dim=8, t_max=14, step_size=1, roche_config=JRocheConfig(kel=1),
                          output_sigma=0.2, dose_max=10, latent_dim=6, sparsity=0.5, output_sparsity=0.5,
                          p_remove=0.5, val_size=8, test_size=8, rng=np.random.RandomState(7))
    dg.generate_data()
    dg.split_sample()
    path = str(tmp_path_factory.mktemp("data") / "cohort.pkl")
    dg.save(path)
    return path


@pytest.fixture(scope="module")
def runs(small_data, tmp_path_factory):
    """`run_simulation.run` of the lockstep hybrid, 2 restarts of 2 iterations, under seq, vmap and shard (2 gloo
    ranks) -> {mode: (the event log's val records, the checkpoint's (itr, best loss), the scores)}."""
    tmp = tmp_path_factory.mktemp("runs")
    out = {}
    for mode in ("seq", "vmap", "shard"):
        path, events = str(tmp / mode) + "_", str(tmp / f"{mode}.jsonl")
        _, model, scores = run_simulation.run(
            seed=3, elbo=True, eval_only=False, init_path=None, data_path=small_data, sample=24,
            data_config=DataConfig(obs_dim=8, latent_dim=6), model_method="hybrid", path=path,
            optim_config=OptimConfig(shuffle=False, n_restart=2, batch_size=8, niters=2, test_freq=1, early_stop=10),
            eval_config=EvalConfig(t0=5), events_path=events, lockstep=True, restart_mode=mode, device="cpu")
        val = [json.loads(ln) for ln in open(events)]
        val = [(r.get("restart"), r["itr"], r["val_loss"]) for r in val if r["event"] == "val"]
        _, itr, best = load_checkpoint(path, model.model_name, "cpu")
        out[mode] = (val, (itr, best), scores, model)
    return out


def test_lockstep_restarts_under_vmap_match_the_sequential_chain(runs):
    seq_val, (seq_itr, seq_best), _, model = runs["seq"]
    val, (itr, best), scores, _ = runs["vmap"]
    assert model.decoder_spec.use_adjoint and not model.decoder_spec.per_sample_control
    # seq logs each restart's validations in turn; vmap tags them with their lane.
    assert [(r, i) for r, i, _ in val] == [(0, 1), (0, 2), (1, 1), (1, 2)]
    seq_by_restart = [seq_val[:2], seq_val[2:]]
    for r in range(2):
        got = [v for lane, _, v in val if lane == r]
        want = [v for _, _, v in seq_by_restart[r]]
        np.testing.assert_allclose(got[0], want[0], rtol=RUN_RTOL)  # the first validation of each restart
        assert np.isfinite(got).all()
    assert itr == seq_itr
    np.testing.assert_allclose(best, seq_best, rtol=RUN_RTOL)
    assert np.isfinite(scores).all()


def test_lockstep_restarts_shard_over_two_gloo_ranks(runs):
    shard_val, (shard_itr, shard_best), scores, _ = runs["shard"]
    val, (itr, best), _, _ = runs["vmap"]
    assert [(r, i) for r, i, _ in shard_val] == [(r, i) for r, i, _ in val]
    np.testing.assert_allclose([v for *_, v in shard_val], [v for *_, v in val], rtol=SHARD_RTOL)
    assert shard_itr == itr
    np.testing.assert_allclose(shard_best, best, rtol=SHARD_RTOL)
    assert np.isfinite(scores).all()
