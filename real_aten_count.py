#!/usr/bin/env python3
"""ATen calls of the real track's training iteration and test forecast, per method, on the CPU.

    python3 real_aten_count.py

One training iteration (forward, backward, Adam) and one `predict_test`,
counted with chip_smoke.py's dispatch-mode counter on the CLI's grid (T 97,
t0 24: 73 hourly intervals of explicit Adams for the ODE decoders). The count
depends on the grid and the model's structure, not on the widths or the
batch, so a narrow model on 4 patients counts what the full-width model on
100 makes; on the GPU nearly every call launches a kernel, so it predicts the
launches a step makes. No time is measured here.
"""

from __future__ import annotations

import json

import torch

from chip_smoke import _aten_counter
from hybridode_torch.cli.common import build_real_model
from hybridode_torch.cli.run_real import predict_test
from hybridode_torch.inference import init_vi, make_optimizer, train_step

T, B, OBS, STATICS = 97, 4, 6, 3


def main():
    g = torch.Generator().manual_seed(0)
    batch = dict(measurements=torch.randn(T, B, OBS, generator=g), actions=torch.rand(T, B, 1, generator=g),
                 masks=(torch.rand(T, B, OBS, generator=g) < 0.3).float(),
                 statics=torch.randn(1, B, STATICS, generator=g).expand(T, B, STATICS), latents=torch.zeros(T, B, 10))
    for method in ("hybrid", "neural", "2nd", "expert", "tlstm", "gruode"):
        model = build_real_model(method, OBS, 1, STATICS, T, 1.0, encoder_output_dim=4 if method == "expert" else 8)
        params = init_vi(g, model, device="cpu")
        optimizer = make_optimizer(0.01, params, train_expert=True)
        train_step(params, optimizer, model, batch, g)  # Adam's state exists from the second step on
        with _aten_counter() as step:
            train_step(params, optimizer, model, batch, g)
        with _aten_counter() as forecast:
            predict_test(params, model, batch, 24)
        print(json.dumps(dict(method=method, train_step_aten_calls=step.calls, predict_test_aten_calls=forecast.calls)))


if __name__ == "__main__":
    main()
