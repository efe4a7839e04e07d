"""The readings that a cell's limits are set from (not run by the benchmark).

    python3 dfl_bench/readings.py --workload <cell> --seeds <n> ... \
        [--control <n> ...] [--faults <n> ...] [--out <file.json>]

For each ``--seeds`` seed: the cell's inputs, the runner, one call of its
grid as the window makes it (call 0 of that seed), then the plain
reference on the rows the harness would draw for a one-call window, and
the numbers compared (`harness.compare`): the program's readings.

For each ``--control`` seed: the control, the reference put in the
program's place and computed in TF32 (matmuls and cuDNN convolutions),
against the float32 reference on the same rows: the control's readings.

For each ``--faults`` seed: the sound program's reading, then the same
call with each fault of `faults.FAULTS` but ``altered`` planted in the
port, against the same reference run.

A limit lies above every sound reading and below the smallest reading of
the control (where it is three times the sound ones or more) and of each
fault (where it is ten times or more).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

import torch

if __package__ in (None, ""):
    ROOT = Path(__file__).resolve().parent.parent
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

from dfl_bench import faults, harness, traffic  # noqa: E402


def by_round(got: dict, want: dict, test_count: int,
             floor: float) -> list[dict]:
    """The numbers compared, round by round, beside the reference's mean
    and least train loss of that round."""
    rounds = next(iter(want.values()))["loss"].shape[0]
    out = []
    for t in range(rounds):
        cut = lambda rows: {r: {k: v[t:t + 1] for k, v in d.items()}  # noqa
                            for r, d in rows.items()}
        out.append({**harness.compare(cut(got), cut(want), test_count,
                                      floor),
                    "ref_loss": float(sum(d["loss"][t].mean()
                                          for d in want.values())
                                      / len(want)),
                    "ref_loss_min": float(min(d["loss"][t].min()
                                              for d in want.values()))})
    return out


def _losses(got: dict, want: dict) -> dict:
    """Each row's losses, client by client, on both sides."""
    return {r: {"got": got[r]["loss"].tolist(),
                "want": want[r]["loss"].tolist()} for r in want}


def _program_call(c, inputs, seeds, device, fault=None):
    """One call of the cell's grid, under ``fault`` if given: (acc and
    loss, seconds, peak bytes)."""
    with faults.planted(fault) if fault else contextlib.nullcontext():
        program = harness.Program(c, inputs, device)
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with faults.planted(fault) if fault else contextlib.nullcontext():
        got = program.run(seeds)
    torch.cuda.synchronize(device)
    call_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    del program
    gc.collect()
    torch.cuda.empty_cache()
    return got, call_s, peak


def program_reading(c: harness.Cell, seed: int, device,
                    planted=()) -> list[dict]:
    """The sound program's numbers on ``seed``, then each planted fault's,
    against one reference run."""
    inputs = harness.make_inputs(c, seed, device)
    seeds = traffic.call_seeds(seed, 0, c.cell["seeds_per_point"])
    _, rows = harness.sample(c, seed, 1)
    calls = [(None, *_program_call(c, inputs, seeds, device))]
    t1 = time.perf_counter()
    want = harness.reference_rows(c, inputs, seeds, rows, device)
    reference_s = time.perf_counter() - t1
    calls += [(f, *_program_call(c, inputs, seeds, device, f))
              for f in planted]
    floor = c.cell.get("loss_floor", 0.0)
    out = []
    for fault, got, call_s, peak in calls:
        got_rows = {r: {k: v[r] for k, v in got.items()} for r in rows}
        out.append({"seed": seed, "fault": fault, "rows": rows,
                    "call_s": call_s, "reference_s": reference_s,
                    "peak_bytes": peak,
                    **harness.compare(got_rows, want, inputs.test_count,
                                      floor),
                    "by_round": by_round(got_rows, want, inputs.test_count,
                                         floor),
                    "losses": _losses(got_rows, want)})
    return out


def control_reading(c: harness.Cell, seed: int, device) -> dict:
    inputs = harness.make_inputs(c, seed, device)
    seeds = traffic.call_seeds(seed, 0, c.cell["seeds_per_point"])
    _, rows = harness.sample(c, seed, 1)
    low = harness.reference_rows(c, inputs, seeds, rows, device, tf32=True)
    want = harness.reference_rows(c, inputs, seeds, rows, device)
    floor = c.cell.get("loss_floor", 0.0)
    return {"seed": seed, "rows": rows,
            **harness.compare(low, want, inputs.test_count, floor),
            "by_round": by_round(low, want, inputs.test_count, floor),
            "losses": _losses(low, want)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--faults", type=int, nargs="*", default=[],
                    help="seeds on which every fault of faults.FAULTS but "
                         "'altered' is planted and read")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import resolve_device

    device = torch.device("cuda", 0)
    resolve_device(device)
    c = harness.load_cell(args.workload)
    out = {"workload": c.name, "device": torch.cuda.get_device_name(device),
           "program": [], "control": []}
    planted = [f for f in faults.FAULTS if f != "altered"]
    for seed in dict.fromkeys(args.seeds + args.faults):
        for rec in program_reading(c, seed, device,
                                   planted if seed in args.faults else ()):
            out["program"].append(rec)
            print("program", json.dumps(rec), flush=True)
    for seed in args.control:
        out["control"].append(control_reading(c, seed, device))
        print("control", json.dumps(out["control"][-1]), flush=True)
    sides = [("sound", [r for r in out["program"] if r["fault"] is None]),
             ("control", out["control"])] + [
        (f, [r for r in out["program"] if r["fault"] == f]) for f in planted]
    for side, recs in sides:
        for key in harness.NUMBERS:
            vals = [r[key] for r in recs]
            if vals:
                print(f"{side} {key}: min {min(vals)!r} max {max(vals)!r} "
                      f"over {len(vals)} seeds; limit "
                      f"{c.cell['limits'].get(key)!r}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
