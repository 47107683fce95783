"""Forecast cells: a closed loop of one caller, each request one `evaluate` of a chunk of the test fold.

A request names a chunk of `patients_per_request` test patients, the seed of
the torch generator from which `evaluate` draws its Monte-Carlo noise, and
the seed of numpy's global generator, from which it draws its bootstrap.
The chunks come in rounds, each round a permutation drawn from the run's
seed. Set-up ends in blocks of requests (the mix's `settle`) repeated until
a block's time settles. Latency is the host's clock around the call, which ends in its read of
the scores. Once the window has closed, a sample of its requests drawn from
the seed is recomputed by the reference.
"""

from __future__ import annotations

import copy
import gc
import itertools
import json
import time

import numpy as np
import torch

from ..harness import compare, port, settle, trace, weights
from ..reference import cohort as ref_cohort
from ..reference import scores as ref_scores

SCORES = ("rmse_z0", "rmse_z0_sd", "cprs_z0", "rmse_x", "rmse_x_sd", "cprs_x")


def _chunks(data, n: int) -> list:
    """The test fold as views of `n` patients each, the program's cohort object with one chunk as its test fold."""
    views = []
    for c in range(data.test_size // n):
        view = copy.copy(data)
        view.data_test = {k: v[:, c * n:(c + 1) * n] for k, v in data.data_test.items()}
        view.test_size = n
        views.append(view)
    return views


class Requests:
    """The run's requests, drawn from its seed: (chunk, noise seed, numpy seed)."""

    def __init__(self, seed: int, n_chunks: int):
        self.rng = np.random.default_rng(seed)
        self.n_chunks, self.round = n_chunks, []

    def next(self):
        if not self.round:
            self.round = list(self.rng.permutation(self.n_chunks))
        return int(self.round.pop(0)), int(self.rng.integers(0, 2**62)), int(self.rng.integers(0, 2**32))


def run(spec, seed: int, seconds: float, traced: bool, device, root: str, work: str, t_process: float) -> dict:
    from hybridode_torch.eval import evaluate

    cfg, mix = spec.config, spec.mix
    n, mc, t0 = mix["patients_per_request"], mix["mc_itr"], mix["t0"]
    data = port.cohort(cfg, root, device)
    vi = port.model(cfg, mix)
    w0 = weights.make(cfg, seed, device)
    params = port.params(vi, w0, device)
    views = _chunks(data, n)
    requests = Requests(seed, len(views))

    def call(chunk, noise_seed, np_seed):
        np.random.seed(np_seed)
        t = time.perf_counter()
        out = evaluate(params, vi, views[chunk], n, t0, mc_itr=mc, generator=torch.Generator().manual_seed(noise_seed),
                       verbose=False, device=device)
        return out, time.perf_counter() - t

    warm = itertools.count()

    def block():  # the chunks in turn, as many requests as the settling rule's unit holds
        for i in itertools.islice(warm, mix["settle"]["requests"]):
            call(i % len(views), i, i)

    settled = settle.settle(block, mix["settle"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    done = []
    t_window = time.perf_counter()
    setup_s = time.time() - t_process
    while time.perf_counter() - t_window < seconds:
        req = requests.next()
        out, latency = call(*req)
        done.append((req, out, latency))
    window_s = time.perf_counter() - t_window
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    latencies = [d[2] for d in done]
    # A forecast whose scores are not finite (a decode that diverged) failed its user, whatever the reference says,
    # and its patients are not counted as forecast.
    failed = sum(1 for d in done if not np.all(np.isfinite(d[1])))
    rec = dict(window_s=window_s, setup_s=setup_s, settle_s=settled, attempted=len(done),
               memory_peak_bytes=memory_peak, failed=failed, requests=len(done),
               forecast_patients_per_s=(len(done) - failed) * n / window_s,
               forecast_p95_ms=float(np.percentile(latencies, 95)) * 1e3 if latencies else float("nan"))
    if traced:
        rec["trace"] = trace.profile(lambda: [call(*requests.next()) for _ in range(mix["traced_requests"])],
                                     device)
        rec["trace"]["requests"] = mix["traced_requests"]

    sample = np.random.default_rng([seed, 1]).choice(len(done), size=min(mix["checked_requests"], len(done)),
                                                     replace=False)
    checked = [done[i] for i in sorted(sample)]
    del params, data, views
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rec["values"], rec["reference_trials"] = _compare(cfg, mix, checked, w0, root, device)
    return rec


def reference(cfg, mix, request, w0, test, device, dtype=torch.float64, rows=None):
    """The reference's six numbers of `request` (chunk, noise seed, numpy seed) and its decodes' trial steps;
    `rows` keeps only the chunk's first patients (a fault: half of the batch left out)."""
    chunk, noise_seed, np_seed = request
    n, mc = mix["patients_per_request"], mix["mc_itr"]
    keep = rows or n
    batch = {k: torch.as_tensor(v[:, chunk * n:chunk * n + keep], device=device, dtype=dtype) for k, v in test.items()}
    eps = torch.randn((mc, n, cfg["latent_dim"]), generator=torch.Generator().manual_seed(noise_seed))[:, :keep]
    params = {k: v.to(dtype) for k, v in w0.items()}
    return ref_scores.forecast(cfg, mix, params, batch, mix["t0"], eps.to(device=device, dtype=dtype), np_seed)


def score_gap(got, want: dict) -> float:
    """The worst relative gap over the six numbers."""
    return max(compare.rel_gap(float(g), want[k]) for k, g in zip(SCORES, got))


def _compare(cfg, mix, checked, w0, root, device):
    """The reference's scores of the checked requests -> ({"scores": worst relative gap}, mean trial steps a
    decoded row or None)."""
    test = ref_cohort.load(cfg, root)["test"]
    worst, trials = 0.0, []
    for request, got, _ in checked:
        want, tr = reference(cfg, mix, request, w0, test, device)
        worst = max(worst, score_gap(got, want))
        if tr is not None:
            trials.append(tr.double().mean().item())
    return {"scores": worst}, (float(np.mean(trials)) if trials else None)


def calibrate(spec, seeds, n_control, device, root, work, seconds) -> dict:
    """The readings of `benchmark/calibrate.py` (its docstring): a short run a seed, and the TF32 control, half
    of each request's patients left out and another chunk's answer on its checked requests."""
    cfg, mix = spec.config, spec.mix
    test = ref_cohort.load(cfg, root)["test"]
    n_chunks = cfg["cohort"]["test"] // mix["patients_per_request"]
    out = {"program": [], "control": [], "half_batch": [], "other_chunk": []}
    for i, seed in enumerate(seeds):
        t = time.time()
        rec = run(spec, seed, seconds, False, device, root, work, time.time())
        out["program"].append(dict(seed=seed, scores=rec["values"]["scores"], requests=rec["requests"],
                                   seconds=time.time() - t))
        if i < n_control:
            w0 = weights.make(cfg, seed, device)
            requests = Requests(seed, n_chunks)
            gaps = {"control": 0.0, "half_batch": 0.0, "other_chunk": 0.0}
            for _ in range(mix["checked_requests"]):
                req = requests.next()
                want, _ = reference(cfg, mix, req, w0, test, device)
                with compare.tf32():
                    low, _ = reference(cfg, mix, req, w0, test, device, dtype=torch.float32)
                half, _ = reference(cfg, mix, req, w0, test, device, rows=mix["patients_per_request"] // 2)
                other, _ = reference(cfg, mix, ((req[0] + 1) % n_chunks,) + req[1:], w0, test, device)
                for name, got in (("control", low), ("half_batch", half), ("other_chunk", other)):
                    gaps[name] = max(gaps[name], score_gap([got[k] for k in SCORES], want))
            for name, v in gaps.items():
                out[name].append(dict(seed=seed, scores=v))
        print(json.dumps({k: v[-1] for k, v in out.items() if v and v[-1]["seed"] == seed}), flush=True)
    return out
