#!/usr/bin/env python3
"""SASS counts and device time of the roche_rk4 kernel against another build of it, on one GPU.

    python3 roche_rk4_study.py [--baseline OTHER.cu] [--out RESULT.json]

Builds the kernel (`hybridode_torch/ops/csrc/roche_rk4.cu`) and, with
`--baseline`, another source with the same C entry point (an earlier design,
written out with `git show REV:hybridode_torch/ops/csrc/roche_rk4.cu`), one
nvcc each, started together, with the flags of `ops/build.py`. Then it prints
one JSON line each:

- `env`: the card's name, power limit and maximum SM clock.
- `sass`, per build, for the D=6 kernel (`cuobjdump -sass`): its instruction
  count and, for each innermost loop of more than 100 instructions (the RK4
  step loop, one per Hill path), its instructions, its field evaluations (one
  IEEE division each, counted by its FCHK) and the longest register
  dependency chain through one pass of its body, in instructions and in
  cycles at the latencies ASSUMED in `LATENCY` (not measured). Branches inside
  the body (slow paths of powf and the division) are read as taken, so both
  are upper bounds for one pass. `chain_floor_ms` is (T-1) * n_sub * 4
  evaluations times the chain's cycles per evaluation at the maximum clock.
- `time`, per build and case: device time (`chip_smoke.queued_ms`) at
  evaluate's shape (B=2550, D=6) with the cohort's Hill exponents (2.0) and
  with 1.7, after a check against the plain version (chip_smoke's tolerance);
  rounds in turns over the builds, forward then backward, median; and the
  cycles per field evaluation that time makes at the maximum clock.

A build other than the repo's is launched through the same wrapper, by
handing its library to `roche_rk4_trajectory` in place of the built one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from unittest import mock

from chip_smoke import ATOL, COHORT, N_SUB, RTOL, T_GRID, kernel_inputs, nvidia_smi, queued_ms

CASES = [(2550, 6, None), (2550, 6, 1.7)]  # (B, D, Hill exponent or None for the cohort's 2.0)
ROUNDS = 6
EVALUATIONS = (T_GRID - 1) * N_SUB * 4
# Assumed issue-to-use latencies in cycles (Hopper, dependent instructions); 4 for every other opcode.
LATENCY = {"MUFU": 18, "SHFL": 24, "LDS": 24, "LDC": 24, "LDG": 200, "LDL": 30, "I2F": 12, "F2I": 12, "FRND": 12}
NO_DEST = ("ST", "BRA", "EXIT", "BAR", "CALL", "RET", "NOP", "WARPSYNC", "BSYNC", "RED", "JMP")
TWO_DESTS = ("FSETP", "ISETP", "DSETP", "HSETP2", "SHFL", "PSETP")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_REG = re.compile(r"\b(U?R\d+|U?P\d)\b")


def build_libraries(baseline: str | None) -> dict[str, str]:
    """name -> built library: "kernel" (the repo's source) and, if given, "baseline"."""
    from hybridode_torch.ops import build

    proc = None
    if baseline:
        out = os.path.join(build.BUILD_DIR, "study", "roche_rk4-baseline.so")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", out, os.path.abspath(baseline)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    paths = {"kernel": build.build_all(("roche_rk4",))["roche_rk4"].path}
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"baseline: nvcc exited {proc.returncode}\n{log}")
        paths["baseline"] = out
    return paths


def _functions(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """Function name -> [(address, opcode, operands)] from cuobjdump -sass text."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), (m.group(2) or "") + " " + m.group(4)))
    return funcs


def _chain(body) -> tuple[int, int]:
    """Longest register dependency chain through one pass: (instructions, cycles at LATENCY).

    A write that may not happen (predicated, or between a forward branch and its
    target) keeps the register's earlier chain where that is longer: either value may be read.
    """
    depth, ready = {}, {}
    cond_until = -1
    for addr, op, operands in body:
        guard, _, rest = operands.partition(" ")
        args = [a.strip() for a in rest.split(",")]
        base = op.split(".")[0]
        n_dest = 0 if base.startswith(NO_DEST) else 2 if base.startswith(TWO_DESTS) else 1
        srcs = _REG.findall(guard) + [r for a in args[n_dest:] for r in _REG.findall(a)]
        dests = [r for a in args[:n_dest] for r in _REG.findall(a)]
        d = 1 + max((depth.get(r, 0) for r in srcs), default=0)
        c = next((v for k, v in LATENCY.items() if base.startswith(k)), 4) + max(
            (ready.get(r, 0) for r in srcs), default=0)
        maybe = bool(guard) or addr < cond_until
        for r in dests:
            depth[r] = max(d, depth.get(r, 0)) if maybe else d
            ready[r] = max(c, ready.get(r, 0)) if maybe else c
        target = re.search(r"0x([0-9a-f]+)", rest) if base in ("BRA", "BSSY") else None
        if target and int(target.group(1), 16) > addr:
            cond_until = max(cond_until, int(target.group(1), 16))
    return max(depth.values(), default=0), max(ready.values(), default=0)


def sass_report(lib: str, mhz: float, D: int = 6) -> dict:
    from hybridode_torch.ops import build

    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300, check=True).stdout
    name, insns = next((n, v) for n, v in _functions(sass).items() if "roche_rk4_kernel" in n and f"ILi{D}E" in n)
    index = {a: i for i, (a, _, _) in enumerate(insns)}
    loops = []
    for i, (a, op, operands) in enumerate(insns):
        m = re.search(r"0x([0-9a-f]+)", operands) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) <= a and int(m.group(1), 16) in index:
            loops.append((index[int(m.group(1), 16)], i))
    inner = [(s, e) for s, e in loops if not any(s <= s2 and e2 <= e and (s2, e2) != (s, e) for s2, e2 in loops)]
    report = []
    for s, e in sorted(inner):
        body = insns[s:e + 1]
        evals = sum(op.startswith("FCHK") for _, op, _ in body)
        if len(body) <= 100 or not evals:
            continue
        chain_insns, chain_cycles = _chain(body)
        report.append(dict(instructions=len(body), evaluations=evals, chain_instructions=chain_insns,
                           chain_cycles=chain_cycles, mufu=sum(op.startswith("MUFU") for _, op, _ in body),
                           instructions_per_evaluation=len(body) / evals,
                           chain_cycles_per_evaluation=chain_cycles / evals,
                           chain_floor_ms=EVALUATIONS * chain_cycles / evals / (mhz * 1e3)))
    return dict(function=name, D=D, instructions=len(insns), step_loops=report)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", default=None, help="another roche_rk4 .cu with the same C entry point")
    parser.add_argument("--out", default=None, help="also write every line into this JSON file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("roche_rk4_study: no CUDA device", file=sys.stderr)
        return 1

    from hybridode_torch.data import SyntheticCohort
    from hybridode_torch.ops import build, roche_rk4

    lines = []

    def emit(kind, **row):
        lines.append(dict(kind=kind, **row))
        print(f"{kind} " + json.dumps(row), flush=True)

    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    emit("env", nvidia_smi=nvidia_smi(), clocks_max_sm_mhz=mhz, device=torch.cuda.get_device_name(0))
    paths = build_libraries(args.baseline)
    for name, path in paths.items():
        emit("sass", build=name, **sass_report(path, mhz))

    libs = {name: ctypes.CDLL(path) for name, path in paths.items()}
    use = lambda name: mock.patch.object(build, "load", lambda _: libs[name])  # noqa: E731
    cohort = SyntheticCohort.load(COHORT, device="cuda")
    gen = torch.Generator().manual_seed(0)
    cases = {case: kernel_inputs(*case[:2], cohort, gen, case[2]) for case in CASES}
    times = {(name, case): [] for name in libs for case in cases}
    with torch.no_grad():
        for case, inp in cases.items():
            want = roche_rk4.roche_rk4_trajectory_reference(**inp)
            for name in libs:
                with use(name):
                    got = roche_rk4.roche_rk4_trajectory(**inp)
                torch.cuda.synchronize()
                err = (got - want).abs()
                if not (bool(torch.isfinite(got).all()) and bool((err <= ATOL + RTOL * want.abs()).all())):
                    raise SystemExit(f"{name} disagrees with the plain version at {case} "
                                     f"(max abs err {err.max().item()}, rtol={RTOL} atol={ATOL})")
        for r in range(ROUNDS):
            for name in list(libs) if r % 2 == 0 else list(libs)[::-1]:
                with use(name):
                    for case, inp in cases.items():
                        times[(name, case)].append(queued_ms(lambda: roche_rk4.roche_rk4_trajectory(**inp)))
    for (name, (B, D, hill)), runs in times.items():
        ms = statistics.median(runs)
        emit("time", build=name, B=B, D=D, hill=hill or 2.0, device_ms=ms, runs_ms=runs,
             cycles_per_evaluation=ms * mhz * 1e3 / EVALUATIONS)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
