"""The generators of the traffic mixes: `generators/<kind>.py`, found by the `kind` of a mix's file.

A generator gives `run(spec, seed, seconds, trace, device, root, work,
t_process)`, which sets the program up, drives it for the window and
returns the run's record: `setup_s`, `window_s`, `attempted`, `failed`,
`memory_peak_bytes`, the cell's end-to-end metrics under their names,
`values` (each number compared with the reference) and what the per-layer
metrics' readers read.
"""
