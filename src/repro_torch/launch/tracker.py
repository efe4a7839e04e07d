"""Pluggable metrics trackers (port of the reference package's
`launch/tracker.py`).

The grid program cache (`repro_torch.fl.scenarios.ProgramCache`) and the
grid runner record their telemetry through this abstraction: counters
(cache hits / misses / evictions), gauges, and observation series (batch
fill ratio, latencies) from which p50 / p99 summaries are derived.

Hot-path contract: every recording method is plain host-side bookkeeping
on Python numbers.  Callers convert before recording (never a tensor, so
recording a metric cannot force a device sync); aggregation (percentiles,
means) happens at `snapshot()` time, off the hot path.

Public API
----------
  Tracker           the interface: count / gauge / observe / scoped
  NullTracker       no-op (the default for callers that don't measure)
  StatsTracker      thread-safe in-memory aggregation + snapshot()
  CompositeTracker  fan-out to several trackers
  span              a named profiler range, opened only under a profiler
  spanned           a decorator: the whole function in one `span`

`Tracker.scoped(prefix)` returns a view that prepends ``prefix/`` to
every metric name: one shared `StatsTracker` can hold several tenants'
series side by side (``tenant/<name>/latency_s`` ...).

Spans: `span(name)` opens a `torch.profiler.record_function` range while
a profiler records and is a no-op otherwise (one flag check).  Kineto
records the range on the clock of the device's kernels and copies, so a
trace places every device operation, and every idle gap, in the span
that launched or held it.  The round loop's phases open ``dfl:prepare``,
``dfl:init``, ``dfl:draws``, ``dfl:local_train``, ``dfl:exchange``,
``dfl:eval`` and ``dfl:fetch`` (`fl.simulator`, `fl.scenarios`).
"""
from __future__ import annotations

import contextlib
import functools
import threading
from collections import deque
from typing import Iterable

import numpy as np
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager: a ``name`` range in the profiler's trace while
    one records, else nothing."""
    if _profiler_enabled():
        return record_function(name)
    return _NO_SPAN


def spanned(name: str):
    """A decorator: each call of the function runs in `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class Tracker:
    """Metrics sink interface.

    ``count`` accumulates a monotonically increasing counter, ``gauge``
    overwrites a point-in-time value, ``observe`` appends one sample to a
    distribution series (latencies, fill ratios).  All three take plain
    Python numbers — callers convert BEFORE recording, never the tracker.
    """

    def count(self, name: str, n: int = 1) -> None:
        raise NotImplementedError

    def gauge(self, name: str, value: float) -> None:
        raise NotImplementedError

    def observe(self, name: str, value: float) -> None:
        raise NotImplementedError

    def scoped(self, prefix: str) -> "Tracker":
        """A view of this tracker with ``prefix/`` prepended to every
        metric name (per-tenant / per-stream attribution)."""
        return _PrefixTracker(self, prefix)


class NullTracker(Tracker):
    """Discards everything (zero overhead, the default sink)."""

    def count(self, name: str, n: int = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def observe(self, name: str, value: float) -> None:
        pass

    def scoped(self, prefix: str) -> "Tracker":
        return self                     # nothing to attribute to


class _PrefixTracker(Tracker):
    """Name-prefixing view over another tracker (see `Tracker.scoped`)."""

    def __init__(self, inner: Tracker, prefix: str):
        self._inner = inner
        self._prefix = prefix

    def count(self, name: str, n: int = 1) -> None:
        self._inner.count(f"{self._prefix}/{name}", n)

    def gauge(self, name: str, value: float) -> None:
        self._inner.gauge(f"{self._prefix}/{name}", value)

    def observe(self, name: str, value: float) -> None:
        self._inner.observe(f"{self._prefix}/{name}", value)

    def scoped(self, prefix: str) -> Tracker:
        return _PrefixTracker(self._inner, f"{self._prefix}/{prefix}")


class StatsTracker(Tracker):
    """Thread-safe in-memory aggregation.

    Observation series keep the most recent ``max_samples`` values (a
    bounded deque, so a long-lived server cannot leak through its own
    telemetry); counters and gauges are plain dicts.  `snapshot()` returns
    a flat ``{name: value}`` dict with ``<series>_p50`` / ``_p99`` /
    ``_mean`` / ``_count`` / ``_max`` summaries.
    """

    def __init__(self, max_samples: int = 65536):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._series: dict[str, deque] = {}
        self._max_samples = max_samples

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            if name not in self._series:
                self._series[name] = deque(maxlen=self._max_samples)
            self._series[name].append(float(value))

    def reset(self) -> None:
        """Drop all recorded state (e.g. between a priming phase and a
        measured steady-state phase of a benchmark)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._series.clear()

    # -- read side (off the hot path) ---------------------------------

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def samples(self, name: str) -> list[float]:
        with self._lock:
            return list(self._series.get(name, ()))

    def percentile(self, name: str, q: float) -> float:
        """The q-th percentile (0..100) of an observation series (NaN if
        the series is empty)."""
        vals = self.samples(name)
        if not vals:
            return float("nan")
        return float(np.percentile(np.asarray(vals), q))

    def snapshot(self) -> dict[str, float]:
        """Flat dict of every counter, gauge, and series summary."""
        with self._lock:
            out: dict[str, float] = dict(self._counters)
            out.update(self._gauges)
            series = {k: list(v) for k, v in self._series.items()}
        for name, vals in series.items():
            arr = np.asarray(vals, np.float64)
            out[f"{name}_count"] = len(vals)
            out[f"{name}_mean"] = float(arr.mean())
            out[f"{name}_p50"] = float(np.percentile(arr, 50))
            out[f"{name}_p99"] = float(np.percentile(arr, 99))
            out[f"{name}_max"] = float(arr.max())
        return out


class CompositeTracker(Tracker):
    """Fan one recording stream out to several sinks."""

    def __init__(self, trackers: Iterable[Tracker]):
        self._trackers = tuple(trackers)

    def count(self, name: str, n: int = 1) -> None:
        for t in self._trackers:
            t.count(name, n)

    def gauge(self, name: str, value: float) -> None:
        for t in self._trackers:
            t.gauge(name, value)

    def observe(self, name: str, value: float) -> None:
        for t in self._trackers:
            t.observe(name, value)
