"""The port's phase spans in a trace: the device's idle time inside named
ranges, by phase, and the share of the busy time that the phases' kernels
cover.

The program opens one `record_function` range per phase while a profiler
records (`repro_torch.launch.tracker.span`): ``dfl:prepare``,
``dfl:init``, ``dfl:draws``, ``dfl:local_train``, ``dfl:exchange``,
``dfl:eval`` and ``dfl:fetch``, all on the thread that calls
`GridRunner.run`, none inside another.  An idle gap of the device is
placed in the phases whose ranges it overlaps, time by time.

    python3 -m dfl_bench.spans dfl_bench/out/<cell>.trace.json

prints, for the traced call (the ``dfl:call`` range), the idle time in
each phase and outside every phase, the share of ``busy_us`` covered by
the kernels launched in a phase other than ``dfl:prepare`` (which moves
small tables to the card), and the idle time by the host operation each
gap begins under, by phase.
"""
from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict

from .devtrace import Trace, union

PHASES = ("dfl:prepare", "dfl:init", "dfl:draws", "dfl:local_train",
          "dfl:exchange", "dfl:eval", "dfl:fetch")


def idle_intervals(trace: Trace) -> list[tuple[float, float]]:
    """The gaps of the window in which no device operation ran."""
    lo, hi = trace.window
    out, t = [], lo
    for a, b in trace.busy_intervals():
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def overlap_us(xs, ys) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_us(trace: Trace, names) -> float:
    """Idle device time of the window inside any range of ``names``."""
    ranges = union(r for name in names for r in trace.ranges.get(name, ()))
    return overlap_us(idle_intervals(trace), ranges)


def idle_us(trace: Trace) -> float:
    return trace.window_us - trace.busy_us


def covered_share(trace: Trace, names) -> float | None:
    """The busy time in which a kernel launched in ``names`` ran, over
    ``busy_us`` (None where nothing ran on the device)."""
    if trace.busy_us <= 0:
        return None
    ops = {op for name in names for op in trace.launched_in(name)}
    return Trace.span_us(ops) / trace.busy_us


def idle_by_op(trace: Trace, floor_us: float = 1e3) -> dict:
    """Idle time (s) by the innermost host operation open on the calling
    thread where each gap begins (the name `Trace.idle_gaps` gives it),
    split by the phases the gap overlaps ("-": none); operations whose
    gaps sum under ``floor_us`` left out."""
    spans = sorted((a, b, name) for name in PHASES
                   for a, b in union(trace.ranges.get(name, ())))
    ends = [b for _, b, _ in spans]
    total: dict[str, dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    stack, i = [], 0
    for a, b in idle_intervals(trace):
        while i < len(trace.host) and trace.host[i].ts <= a:
            op = trace.host[i]
            while stack and stack[-1].end <= op.ts:
                stack.pop()
            stack.append(op)
            i += 1
        while stack and stack[-1].end <= a:
            stack.pop()
        by_phase = total[stack[-1].name if stack else "python"]
        rest = b - a
        j = bisect.bisect_right(ends, a)
        while j < len(spans) and spans[j][0] < b:
            part = min(b, spans[j][1]) - max(a, spans[j][0])
            by_phase[spans[j][2]] += part
            rest -= part
            j += 1
        by_phase["-"] += max(0.0, rest)
    return {op: {ph: us / 1e6 for ph, us in phases.items() if us > 0}
            for op, phases in sorted(total.items(),
                                     key=lambda kv: -sum(kv[1].values()))
            if sum(phases.values()) >= floor_us}


def report(trace: Trace) -> dict:
    idle = {name: idle_in_us(trace, (name,)) / 1e6 for name in PHASES}
    return {"window_s": trace.window_us / 1e6,
            "busy_s": trace.busy_us / 1e6,
            "idle_s": idle_us(trace) / 1e6,
            "idle_by_phase_s": idle,
            "idle_outside_phases_s": (idle_us(trace)
                                      - idle_in_us(trace, PHASES)) / 1e6,
            "covered": covered_share(trace, PHASES[1:]),
            "idle_by_op_s": idle_by_op(trace)}


if __name__ == "__main__":
    for path in sys.argv[1:]:
        print(path, json.dumps(report(Trace.load(path, "dfl:call"))))
