"""The port's fused loop (inference/fused.py) against the port's host loop, against JAX's fused program, and the
batched restarts (`--restart_mode vmap`) against the sequential chain, on the CPU.

Models are tiny: the hybrid on a 48-patient cohort that the JAX package
generates (obs 8, latent 6, as tests/test_torch_train.py makes it), with the
per-patient DOPRI5 of the CLI where the case is the main path and RK4 at a
quarter step elsewhere (the same loop, a cheaper decode); the real hybrid on
data_real/ at two explicit-Adams steps an hour. Tolerances, as JAX's own
tests hold its fused program to its host loop (tests/test_inference.py):
curves rtol 2e-5 / atol 1e-6, the best loss rtol 1e-5, parameters rtol 1e-4 /
atol 1e-6. On the CPU the two loops run the same operations in the same
order, so they agree far inside that. Against JAX: the tolerances of
test_training_loop_matches_jax_host_loop (rtol 1e-3, atol 1e-4 on the
parameters, float32 DOPRI5 solves whose step sequences may differ). The
batched restarts sum their matrix products in another order than R
separate ones: the same tolerances as fused against host.
"""

import itertools
import json
import os

import jax
import numpy as np
import pytest
import torch

from hybridode.cli.common import build_sim_model as j_build_sim_model
from hybridode.config import DataConfig as JDataConfig
from hybridode.config import RocheConfig as JRocheConfig
from hybridode.data import SyntheticCohort as JSyntheticCohort
from hybridode.inference import init_vi as j_init_vi
from hybridode.inference.fused import fused_training_loop as j_fused_training_loop
from hybridode_torch.cli import common, run_simulation
from hybridode_torch.cli.common import build_real_model, build_sim_model, restart_generators
from hybridode_torch.config import DataConfig, EvalConfig, OptimConfig
from hybridode_torch.convert import params_from_jax, params_to_jax
from hybridode_torch.data import RealCohort, SyntheticCohort
from hybridode_torch.fields import doses_from_actions, roche_field
from hybridode_torch.inference import elbo, fused, load_checkpoint, train, variational_training_loop
from hybridode_torch.models import priors
from hybridode_torch.solvers import dopri5

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
DC = DataConfig(obs_dim=8, latent_dim=6)
CURVE_RTOL, CURVE_ATOL, BEST_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-5, 1e-6, 1e-5, 1e-4, 1e-6


@pytest.fixture(scope="module")
def small_cohort(tmp_path_factory):
    """48 patients (24 train / 8 val / 16 test), obs 8, written by the JAX package."""
    dg = JSyntheticCohort(
        n_sample=48, obs_dim=8, t_max=14, step_size=1, roche_config=JRocheConfig(kel=1),
        output_sigma=0.2, dose_max=10, latent_dim=6, sparsity=0.5, output_sparsity=0.5,
        p_remove=0.5, val_size=8, test_size=16, rng=np.random.RandomState(666),
    )
    dg.generate_data()
    dg.split_sample()
    path = str(tmp_path_factory.mktemp("cohort") / "cohort.pkl")
    dg.save(path)
    return path


def _rk4(model):
    return model._replace(decoder_spec=model.decoder_spec._replace(method="rk4", ode_step_size=0.25))


def _sim(flow=False, rk4=True, elbo_=True):
    m = build_sim_model("hybrid", DC, flow=flow, mc_size=5, elbo=elbo_)
    return _rk4(m) if rk4 else m


def _real_cohort():
    c = RealCohort(os.path.join(ROOT, "data_real"), val_size=16, test_size=1000, device="cpu")
    c.split_sample()
    c.set_train_size(32)
    return c


def _train(tmp_path, name, model, cohort, fused_, seed=0, generator=None, **kw):
    """One restart from a seeded init; -> (returned best params, best, final params, curve, generator, stdout
    events)."""
    params = elbo.init_vi(torch.Generator().manual_seed(seed), model, device="cpu")
    gen = generator if generator is not None else torch.Generator().manual_seed(seed + 1)
    events = str(tmp_path / f"{name}.jsonl")
    args = dict(niters=4, batch_size=8, lr=0.01, test_freq=2, early_stop=10, shuffle=False, val_criterion="forecast",
                verbose=True) | kw
    best, best_on_disk, _ = variational_training_loop(data_generator=cohort, model=model, params=params,
                                                      generator=gen, path=str(tmp_path / name) + "_",
                                                      events_path=events, fused=fused_, **args)
    recs = [json.loads(ln) for ln in open(events)]
    curve = np.asarray([(r["itr"], r["val_loss"], r["train_loss"]) for r in recs if r["event"] == "val"]).reshape(-1, 3)
    return best, best_on_disk, params, curve, gen, recs


def _assert_params(a, b, equal_nan=False):
    for (k, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(x, y, rtol=PARAM_RTOL, atol=PARAM_ATOL, equal_nan=equal_nan, msg=k)


def _assert_same_run(host, got):
    assert got[3].shape == host[3].shape and np.isfinite(got[3]).all()
    np.testing.assert_allclose(got[3], host[3], rtol=CURVE_RTOL, atol=CURVE_ATOL)
    np.testing.assert_allclose(got[1], host[1], rtol=BEST_RTOL)
    _assert_params(got[0], host[0])  # the best, reloaded from disk
    _assert_params(got[2], host[2], equal_nan=True)  # the final parameters
    assert torch.equal(torch.randn(3, generator=got[4]), torch.randn(3, generator=host[4]))  # the next draw


def _real_model(c):
    return build_real_model("hybrid", c.obs_dim, c.action_dim, c.static_dim, c.t_max, c.step_size, ode_step_div=2)


CASES = {  # -> (model of a cohort, the cohort's kind, the loop's arguments)
    # The main path: per-patient DOPRI5, random mini-batches, the full-sequence ELBO as the validation loss.
    "shuffle_elbo": (lambda c: _sim(rk4=False), "sim", dict(shuffle=True, val_criterion="elbo", niters=2,
                                                            test_freq=1)),
    # The residual CLI's way: sequential chunks of the val fold.
    "sequential_val_fold": (lambda c: _sim(), "sim", dict(train_fold="val", niters=6)),
    # The trailing step past the last validation moves the final parameters, never the best.
    "trailing_steps": (lambda c: _sim(), "sim", dict(niters=5)),
    "flow": (lambda c: _sim(flow=True), "sim", dict(val_criterion="elbo")),
    # The real CLI's way: every leaf trains, the masked MSE validates.
    "real": (_real_model, "real", dict(batch_size=16, train_expert=True, val_criterion="elbo")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_loop_matches_the_host_loop(small_cohort, tmp_path, case, capsys):
    model_of, kind, kw = CASES[case]

    def cohort_of():
        return _real_cohort() if kind == "real" else SyntheticCohort.load(small_cohort, device="cpu")

    model = model_of(cohort_of())
    host = _train(tmp_path, "host", model, cohort_of(), False, **kw)
    host_out = capsys.readouterr().out
    got = _train(tmp_path, "fused", model, cohort_of(), True, **kw)
    out = capsys.readouterr().out
    _assert_same_run(host, got)
    iters, tf = kw.get("niters", 4), kw.get("test_freq", 2)
    np.testing.assert_array_equal(got[3][:, 0], np.arange(tf, iters + 1, tf))
    # The stdout contract, replayed from the buffers.
    assert [ln[:9] for ln in out.splitlines() if ln.startswith("Iter")] == \
        [ln[:9] for ln in host_out.splitlines() if ln.startswith("Iter")]
    assert out.splitlines()[-1] == host_out.splitlines()[-1]  # Overall best loss: ...
    events = got[5]
    assert [r["window"] for r in events if r["event"] == "window"] == list(range(1, iters // tf + 1))
    assert [r["captured"] for r in events if r["event"] == "done"] == [False]  # no graph on the CPU
    if case == "trailing_steps":
        assert [r["itr"] for r in events if r["event"] == "tail"] == [5]
        assert not all(torch.equal(a, b) for a, b in zip(got[0].parameters(), got[2].parameters()))


def test_early_stop_and_the_non_finite_gate(small_cohort, tmp_path, monkeypatch, capsys):
    """lr=0 and early_stop=1: the second validation does not improve on the first, so the restart stops after
    iteration 4 with curve rows at 2 and 4 only. Then a scripted non-finite training loss at iteration 4 (a
    validation iteration) freezes the restart: its update is applied, no validation follows, and the
    generator keeps that iteration's training draws but not its validation draws."""
    cohort = SyntheticCohort.load(small_cohort, device="cpu")
    host = _train(tmp_path, "host", _sim(), cohort, False, niters=10, lr=0.0, early_stop=1)
    got = _train(tmp_path, "fused", _sim(), cohort, True, niters=10, lr=0.0, early_stop=1)
    np.testing.assert_array_equal(got[3][:, 0], [2, 4])
    _assert_same_run(host, got)
    assert [r["window"] for r in got[5] if r["event"] == "window"] == [1, 2]
    capsys.readouterr()

    runs = {}
    for fused_ in (False, True):
        real, calls = elbo.loss_fn, itertools.count()

        def scripted(*a, **k):
            loss = real(*a, **k)
            training = torch.is_grad_enabled()  # the validation runs without gradient
            return loss * float("nan") if training and next(calls) == 3 else loss

        monkeypatch.setattr(fused, "loss_fn", scripted)
        monkeypatch.setattr(train, "loss_fn", scripted)
        runs[fused_] = _train(tmp_path, f"nf{fused_}", _sim(), cohort, fused_, niters=6, val_criterion="elbo")
        monkeypatch.undo()
        out = capsys.readouterr().out
        assert "non-finite training loss; stopping this restart" in out
    host, got = runs[False], runs[True]
    np.testing.assert_array_equal(got[3][:, 0], [2])
    assert torch.isnan(next(got[2].parameters())).all()  # iteration 4's update applied its NaN gradient
    np.testing.assert_allclose(got[3], host[3], rtol=CURVE_RTOL, atol=CURVE_ATOL)
    _assert_params(got[0], host[0])
    _assert_params(got[2], host[2], equal_nan=True)
    # The dying iteration drew its training noise and no validation noise.
    assert torch.equal(torch.randn(3, generator=got[4]), torch.randn(3, generator=host[4]))


def test_flush_every_window_changes_nothing_but_writes_the_best(small_cohort, tmp_path):
    """flush_every=1 against off: the sink is called at each of the 3 windows' reads, writes the best when it
    improves, and the parameters, final and best, are bit-identical."""
    cohort = SyntheticCohort.load(small_cohort, device="cpu")
    runs = {}
    for every in (0, 1):
        params = elbo.init_vi(torch.Generator().manual_seed(0), _sim(), device="cpu")
        runs[every] = params, fused.fused_training_loop(
            niters=6, data_generator=cohort, model=_sim(), params=params, batch_size=8, lr=0.01, test_freq=2,
            generator=torch.Generator().manual_seed(1), early_stop=10, path=str(tmp_path / f"flush{every}_"),
            shuffle=False, verbose=False, val_criterion="forecast", flush_every=every)
        if every == 0:
            assert fused._LAST_FLUSH_SINK is None
    sink = fused._LAST_FLUSH_SINK
    (p_off, off), (p_on, on) = runs[0], runs[1]
    assert sink.calls == 3 and 1 <= sink.writes <= 3 and sink.written_od == on[1] == off[1]
    for a, b in zip(list(on[0].parameters()) + list(p_on.parameters()), list(off[0].parameters()) +
                    list(p_off.parameters())):
        assert torch.equal(a, b)


def test_generator_is_left_where_the_host_loop_leaves_it(small_cohort, tmp_path):
    """Validation noise is drawn (`val_criterion="elbo"`); the restart early-stops at its second validation."""
    cohort = SyntheticCohort.load(small_cohort, device="cpu")
    kw = dict(niters=8, lr=0.0, early_stop=1, val_criterion="elbo", shuffle=True)
    host = _train(tmp_path, "host", _sim(), cohort, False, **kw)
    got = _train(tmp_path, "fused", _sim(), cohort, True, **kw)
    assert len(got[3]) < 4  # stopped early
    _assert_same_run(host, got)


def _first_batch_solve():
    c = SyntheticCohort.load(os.path.join(ROOT, "data_s123", "datafile_dose_exp.pkl"), device="cpu")
    model = build_sim_model("hybrid", DataConfig())
    params = elbo.init_vi(torch.Generator().manual_seed(0), model, device="cpu")
    batch = c.get_split("train", 4, 0)
    mu, log_var = elbo.encode(params, model, batch["measurements"], batch["actions"], batch["masks"])
    z = priors.gaussian_reparameterize(mu, log_var, torch.randn(mu.shape, generator=torch.Generator().manual_seed(2)))
    spec, steps = model.decoder_spec, []
    s, carry = dopri5.start(roche_field, z, spec.ts, (params["decoder"]["ode"],
                            doses_from_actions(batch["actions"], spec.step_size)), spec.rtol, spec.atol, per_row=True)
    ys, stats = dopri5.finish(s, dopri5.integrate(s, carry, spec.max_steps, on_step=steps.append))
    ys.sum().backward()
    return ys.detach(), stats, len(steps), {k: p.grad for k, p in params.named_parameters() if p.grad is not None}


def test_read_free_dopri5_equals_early_exit():
    """The whole budget of 256 trial steps with no host read gives the early-exit solve bit for bit, per row,
    with its trial and accepted counts, and the same gradients."""
    ys, st, run, grads = _first_batch_solve()
    with dopri5.full_budget():
        ys_f, st_f, run_f, grads_f = _first_batch_solve()
    assert run < run_f == 256 and bool(st.success.all())
    assert torch.equal(ys, ys_f)
    for a, b in zip(st, st_f):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert grads.keys() == grads_f.keys() and all(torch.equal(grads[k], grads_f[k]) for k in grads)
    assert _first_batch_solve()[2] == run  # the mode ends with its block


def test_fused_loop_matches_jax_fused_program(small_cohort, tmp_path):
    """elbo=False (no noise, so the two RNGs do not matter), shuffle=False, forecast validation every 2 of 6; RK4
    at a quarter step in both packages (JAX compiles the restart as one program)."""
    jm = _rk4(j_build_sim_model("hybrid", JDataConfig(obs_dim=8, latent_dim=6), elbo=False))
    m = _rk4(build_sim_model("hybrid", DC, elbo=False))
    jparams = j_init_vi(jax.random.PRNGKey(0), jm)
    params = params_from_jax(jparams, device="cpu")
    kw = dict(niters=6, batch_size=8, lr=0.01, test_freq=2, shuffle=False, val_criterion="forecast", val_t0=5,
              early_stop=10, verbose=False)
    j_out = j_fused_training_loop(data_generator=JSyntheticCohort.load(small_cohort), model=jm, params=jparams,
                                  key=jax.random.PRNGKey(0), path=str(tmp_path / "jax_"),
                                  events_path=str(tmp_path / "jax.jsonl"), **kw)
    out = fused.fused_training_loop(data_generator=SyntheticCohort.load(small_cohort, device="cpu"), model=m,
                                    params=params, generator=torch.Generator().manual_seed(0),
                                    path=str(tmp_path / "port_"), events_path=str(tmp_path / "port.jsonl"), **kw)

    def curve(name):
        recs = [json.loads(ln) for ln in open(tmp_path / f"{name}.jsonl")]
        return np.asarray([(r["itr"], r["val_loss"], r["train_loss"]) for r in recs if r["event"] == "val"])

    j_curve, got = curve("jax"), curve("port")
    assert got.shape == (3, 3) and np.isfinite(got).all()  # n_vals
    np.testing.assert_array_equal(got[:, 0], j_curve[:, 0])
    np.testing.assert_allclose(got, j_curve, rtol=1e-3)
    np.testing.assert_allclose(out[1], j_out[1], rtol=1e-3)
    want = dict(_leaves(j_out[0]))
    for k, v in _leaves(params_to_jax(out[0])):
        np.testing.assert_allclose(v, want[k], rtol=1e-3, atol=1e-4, err_msg=k)
    itr = load_checkpoint(str(tmp_path / "port_"), m.model_name, "cpu")[1]
    from hybridode.inference import load_checkpoint as j_load_checkpoint

    assert itr == j_load_checkpoint(str(tmp_path / "jax_"), jm.model_name)[1]  # best_itr


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def test_vmap_matches_the_sequential_chain_of_fused_restarts(small_cohort, tmp_path):
    """Three restarts of random mini-batches with the ELBO as the validation loss (noise in every lane)."""
    model = _sim()
    main = torch.Generator().manual_seed(7)
    pairs = [restart_generators(main) for _ in range(3)]
    states = [(a.get_state(), b.get_state()) for a, b in pairs]
    kw = dict(niters=5, batch_size=8, lr=0.01, test_freq=2, early_stop=10, shuffle=True, val_criterion="elbo",
              verbose=False)
    got, best, _ = fused.fused_experiment_loop(data_generator=SyntheticCohort.load(small_cohort, device="cpu"),
                                               model=model, restart_generators=pairs, path=str(tmp_path / "vmap_"),
                                               device="cpu", curve_path=str(tmp_path / "vmap.csv"), **kw)
    seq_best, seq_gens = 1e9, []
    for s_init, s_train in states:
        g_init, g_train = torch.Generator(), torch.Generator()
        g_init.set_state(s_init)
        g_train.set_state(s_train)
        seq, seq_best, _ = fused.fused_training_loop(
            data_generator=SyntheticCohort.load(small_cohort, device="cpu"), model=model,
            params=elbo.init_vi(g_init, model, device="cpu"), generator=g_train, path=str(tmp_path / "seq_"),
            best_on_disk=seq_best, curve_path=str(tmp_path / "seq.csv"), **kw)
        seq_gens.append(g_train)
    np.testing.assert_allclose(best, seq_best, rtol=BEST_RTOL)
    _assert_params(got, seq)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "vmap.csv", delimiter=","),
                               np.loadtxt(tmp_path / "seq.csv", delimiter=","), rtol=CURVE_RTOL, atol=CURVE_ATOL)
    assert load_checkpoint(str(tmp_path / "vmap_"), model.model_name, "cpu")[1] == \
        load_checkpoint(str(tmp_path / "seq_"), model.model_name, "cpu")[1]
    for (_, g), s in zip(pairs, seq_gens):
        assert torch.equal(torch.randn(3, generator=g), torch.randn(3, generator=s))


def test_run_simulation_vmap_selects_the_checkpoint_of_seq(small_cohort, tmp_path, monkeypatch, capsys):
    """`--restart_mode vmap` against `seq` from one seed, three restarts of which one dies: the same best loss and
    checkpoint, the same evaluation draws after it (the point metrics agree)."""
    build = common.build_sim_model
    monkeypatch.setattr(common, "build_sim_model", lambda *a, **k: _rk4(build(*a, **k)))
    runs = {}
    for mode in ("seq", "vmap"):
        path = str(tmp_path / mode) + "_"
        _, model, scores = run_simulation.run(
            seed=3, elbo=True, eval_only=False, init_path=None, data_path=small_cohort, sample=40, data_config=DC,
            model_method="hybrid", path=path, optim_config=OptimConfig(shuffle=False, n_restart=3, batch_size=8,
                                                                       niters=4, test_freq=2, early_stop=10),
            eval_config=EvalConfig(t0=5), device="cpu", restart_mode=mode)
        out = capsys.readouterr().out
        runs[mode] = (load_checkpoint(path, model.model_name, "cpu"), scores, out)
    (seq_params, seq_itr, seq_best), seq_scores, seq_out = runs["seq"]
    (params, itr, best), scores, out = runs["vmap"]
    np.testing.assert_allclose(best, seq_best, rtol=BEST_RTOL)
    assert itr == seq_itr
    _assert_params(params, seq_params)
    for i in (0, 3):  # rmse_z0, rmse_x: posterior-mean decodes
        np.testing.assert_allclose(scores[i], seq_scores[i], rtol=1e-4)
    # The same restarts validate, and the same one dies on a non-finite loss (its solve at this step size).
    for text in ("Iter", "non-finite"):
        assert [ln[:9] for ln in out.splitlines() if ln.startswith(text)] == \
            [ln[:9] for ln in seq_out.splitlines() if ln.startswith(text)]
    assert "non-finite training loss; stopping this restart" in out
    assert out.splitlines()[0] == seq_out.splitlines()[0] == "Training with 40 samples"
    with pytest.raises(ValueError, match="--init"):
        run_simulation.run(seed=3, elbo=True, eval_only=False, init_path=str(tmp_path / "seq_"),
                           data_path=small_cohort, sample=40, data_config=DC, model_method="hybrid",
                           path=str(tmp_path / "x_"), optim_config=OptimConfig(n_restart=2),
                           eval_config=EvalConfig(t0=5), device="cpu", restart_mode="vmap")


def test_device_adam_is_torch_adam_and_freezes_lanes_that_are_not_alive():
    """`_Adam` makes torch.optim.Adam's single-tensor update bit for bit on the CPU (its bias corrections in
    float64); from the third step on lane 1's flag is off: it keeps its parameters and moments, the others step
    on as torch's Adam does."""
    rng = np.random.RandomState(0)
    w0 = torch.from_numpy(rng.randn(3, 4, 5).astype(np.float32))
    ref, mine = torch.nn.Parameter(w0.clone()), w0.clone()
    opt, adam = torch.optim.Adam([ref], lr=0.01), fused._Adam([mine], 0.01)
    alive = torch.tensor([True, False, True]).reshape(3, 1, 1)
    for t in range(6):
        g = torch.from_numpy(rng.randn(3, 4, 5).astype(np.float32) * 10.0 ** -t)  # small late gradients: eps matters
        ref.grad = g.clone()
        opt.step()
        adam.step([g], lambda p: alive if t >= 2 else torch.tensor(True))
        if t == 1:
            assert torch.equal(mine, ref.detach())
            kept = [x[1].clone() for x in (mine, adam.m[0], adam.v[0])]
    for lane in (0, 2):
        assert torch.equal(mine[lane], ref.detach()[lane])
        assert torch.equal(adam.m[0][lane], opt.state[ref]["exp_avg"][lane])
    assert all(torch.equal(x[1], k) for x, k in zip((mine, adam.m[0], adam.v[0]), kept))
    assert not torch.equal(mine[1], ref.detach()[1])
