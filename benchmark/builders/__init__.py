"""How the program under test is built for each configuration kind: `builders/<kind>.py`, found by name.

A builder gives `cohort(cfg, root, device)` (the program's own cohort
object of the configuration's file) and `model(cfg, method)` (the program's
model, built by its CLI's builder with the configuration's method, solver
and step control; `method` may replace the decoder's solve), and may give
`window_probe(params, vi, data, rows, eps)` (what a training window reads of
the program after it has closed).
"""
