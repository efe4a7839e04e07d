"""Reading a `torch.profiler` Chrome trace (the Kineto JSON export).

A `Trace` holds the device operations (kernels, copies, sets), the host
time each was launched at (its CUDA runtime or driver call, joined by the
correlation id), the `record_function` ranges (the program's phase
spans and the benchmark's ``dfl:call``), and the host
operations of the thread that ran the traced call.  Times are in
microseconds, as the export writes them.

  * `launched_in(name)` — the device operations launched while a range of
    that name was open on any thread (local training's backward runs on
    the autograd engine's thread while the calling thread waits inside the
    range).
  * `busy_us` / `window_us` — the union of device intervals inside the
    traced call's window, and the window's length.
  * `top_ops` / `idle_gaps` — the device operations that took most time,
    and the idle gaps summed by the innermost host operation that was open
    on the calling thread when each began.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict

_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
_LAUNCH_CATS = {"cuda_runtime", "cuda_driver", "runtime", "driver"}
_HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
              "python_function"}


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    ts: float
    dur: float
    launch: float | None = None   # host time of the launching call

    @property
    def end(self) -> float:
        return self.ts + self.dur


def union(intervals) -> list[tuple[float, float]]:
    """Merge (start, end) intervals."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


class Trace:
    def __init__(self, events: list[dict], call_range: str):
        launches = {}
        device, ranges, host = [], defaultdict(list), defaultdict(list)
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = str(ev.get("cat", "")).lower()
            args = ev.get("args") or {}
            if cat in _LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = float(ev["ts"])
            if cat in _DEVICE_CATS:
                device.append(ev)
            elif cat == "user_annotation":
                ranges[ev["name"]].append((float(ev["ts"]),
                                           float(ev["ts"]) + float(ev["dur"])))
            if cat in _HOST_CATS:
                host[ev.get("tid")].append(
                    Op(ev["name"], float(ev["ts"]), float(ev["dur"])))
        self.ops = sorted(
            (Op(ev["name"], float(ev["ts"]), float(ev["dur"]),
                launches.get((ev.get("args") or {}).get("correlation")))
             for ev in device), key=lambda op: op.ts)
        self.ranges = {k: sorted(v) for k, v in ranges.items()}
        calls = self.ranges.get(call_range)
        if not calls:
            raise ValueError(f"the trace has no {call_range!r} range")
        start = calls[0][0]
        end = max([calls[-1][1]] + [op.end for op in self.ops
                                    if op.ts >= start])
        self.window = (start, end)
        call_tid = next(ev.get("tid") for ev in events
                        if ev.get("cat") == "user_annotation"
                        and ev.get("name") == call_range)
        self.host = sorted(host.get(call_tid, []), key=lambda op: op.ts)

    @classmethod
    def load(cls, path, call_range: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"], call_range)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list[tuple[float, float]]:
        lo, hi = self.window
        return union((max(op.ts, lo), min(op.end, hi)) for op in self.ops
                     if op.end > lo and op.ts < hi)

    @property
    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    @staticmethod
    def span_us(ops) -> float:
        """The time in which any of ``ops`` ran (overlaps counted once)."""
        return sum(b - a for a, b in union((op.ts, op.end) for op in ops))

    def launched_in(self, name: str) -> list[Op]:
        """Device operations launched inside any range called ``name``."""
        spans = union(self.ranges.get(name, ()))
        starts = [a for a, _ in spans]
        out = []
        for op in self.ops:
            if op.launch is None:
                continue
            i = bisect.bisect_right(starts, op.launch) - 1
            if i >= 0 and op.launch <= spans[i][1]:
                out.append(op)
        return out

    def top_ops(self, count: int = 10) -> list[list]:
        total: dict[str, float] = defaultdict(float)
        for op in self.ops:
            total[op.name] += op.dur
        best = sorted(total.items(), key=lambda kv: -kv[1])[:count]
        return [[name, us / 1e6] for name, us in best]

    def idle_gaps(self, count: int = 10) -> list[list]:
        """Idle device time by the innermost host operation open on the
        calling thread at each gap's start ("python" where none was)."""
        lo, hi = self.window
        busy = self.busy_intervals()
        gaps, t = [], lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        total: dict[str, float] = defaultdict(float)
        stack: list[Op] = []
        i = 0
        for a, b in gaps:
            while i < len(self.host) and self.host[i].ts <= a:
                op = self.host[i]
                while stack and stack[-1].end <= op.ts:
                    stack.pop()
                stack.append(op)
                i += 1
            while stack and stack[-1].end <= a:
                stack.pop()
            total[stack[-1].name if stack else "python"] += b - a
        best = sorted(total.items(), key=lambda kv: -kv[1])[:count]
        return [[name, us / 1e6] for name, us in best]
