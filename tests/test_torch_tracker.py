"""The port's `launch/tracker.py`, held to the reference's own tests.

The reference's ten tracker tests, mirrored on `repro_torch.launch.tracker`:
counters are exact under contention from several threads, snapshots taken
while writers run are internally consistent and monotone, series stay
bounded, `CompositeTracker` delivers each event to each sink exactly once,
`scoped()` prefixes without collisions, and the read side's edge cases
(empty percentile, reset) behave as in the reference.
"""
import threading

import numpy as np
import pytest

from repro_torch.launch import tracker as tr

_N_THREADS = 8
_N_OPS = 500


def _hammer(t: tr.Tracker, thread_id: int) -> None:
    for i in range(_N_OPS):
        t.count("hits")
        t.count("bytes", 10)
        t.gauge("depth", float(thread_id))
        t.observe("latency_s", 0.001 * (i % 50))


def test_counts_exact_under_contention():
    t = tr.StatsTracker()
    threads = [threading.Thread(target=_hammer, args=(t, k))
               for k in range(_N_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    snap = t.snapshot()
    assert snap["hits"] == _N_THREADS * _N_OPS
    assert snap["bytes"] == _N_THREADS * _N_OPS * 10
    # The gauge holds exactly one of the written values.
    assert snap["depth"] in set(map(float, range(_N_THREADS)))
    assert snap["latency_s_count"] == _N_THREADS * _N_OPS
    assert snap["latency_s_max"] == pytest.approx(0.049)


def test_snapshots_consistent_and_monotone_under_writers():
    """snapshot() taken WHILE writers hammer: derived series summaries are
    internally consistent and counters never move backwards."""
    t = tr.StatsTracker()
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            t.count("hits")
            t.observe("latency_s", 0.5)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for th in threads:
        th.start()
    try:
        prev_hits, prev_n = 0.0, 0.0
        for _ in range(200):
            snap = t.snapshot()
            hits = snap.get("hits", 0.0)
            n = snap.get("latency_s_count", 0.0)
            assert hits >= prev_hits, "counter moved backwards"
            assert n >= prev_n, "series count moved backwards"
            prev_hits, prev_n = hits, n
            if n:
                # Every sample is 0.5: any torn read would break these.
                assert snap["latency_s_mean"] == 0.5
                assert snap["latency_s_p50"] == 0.5
                assert snap["latency_s_p99"] == 0.5
                assert snap["latency_s_max"] == 0.5
    finally:
        stop.set()
        for th in threads:
            th.join()


def test_series_bounded_by_max_samples():
    t = tr.StatsTracker(max_samples=16)
    for i in range(100):
        t.observe("s", float(i))
    vals = t.samples("s")
    assert vals == [float(i) for i in range(84, 100)]
    assert t.snapshot()["s_count"] == 16


def test_composite_propagates_exactly_once():
    """Each event reaches each sink exactly once — under concurrent
    recording through the composite."""
    a, b = tr.StatsTracker(), tr.StatsTracker()
    comp = tr.CompositeTracker([a, b])
    threads = [threading.Thread(target=_hammer, args=(comp, k))
               for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for sink in (a, b):
        snap = sink.snapshot()
        assert snap["hits"] == 4 * _N_OPS
        assert snap["bytes"] == 4 * _N_OPS * 10
        assert snap["latency_s_count"] == 4 * _N_OPS


def test_composite_includes_null_without_effect():
    comp = tr.CompositeTracker([tr.NullTracker(), s := tr.StatsTracker()])
    comp.count("x", 3)
    comp.observe("y", 1.0)
    assert s.counter("x") == 3
    assert s.samples("y") == [1.0]


def test_scoped_prefixes_and_composes():
    t = tr.StatsTracker()
    alice = t.scoped("tenant/alice")
    alice.count("requests")
    alice.observe("latency_s", 0.25)
    alice.gauge("depth", 2.0)
    nested = alice.scoped("shard0")
    nested.count("requests")
    snap = t.snapshot()
    assert snap["tenant/alice/requests"] == 1
    assert snap["tenant/alice/shard0/requests"] == 1
    assert snap["tenant/alice/latency_s_p50"] == 0.25
    assert snap["tenant/alice/depth"] == 2.0
    # Scoping never bleeds into the root namespace.
    assert "requests" not in snap


def test_scoped_views_share_one_sink_thread_safely():
    """Concurrent writers through DISTINCT scoped views of one tracker:
    per-tenant attribution stays exact."""
    t = tr.StatsTracker()
    views = [t.scoped(f"tenant/t{k}") for k in range(_N_THREADS)]
    threads = [threading.Thread(target=_hammer, args=(v, k))
               for k, v in enumerate(views)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    snap = t.snapshot()
    for k in range(_N_THREADS):
        assert snap[f"tenant/t{k}/hits"] == _N_OPS
        assert snap[f"tenant/t{k}/latency_s_count"] == _N_OPS


def test_null_tracker_scoped_is_noop():
    n = tr.NullTracker()
    assert n.scoped("x") is n
    n.scoped("x").count("y")            # must not raise


def test_percentile_empty_series_is_nan():
    t = tr.StatsTracker()
    assert np.isnan(t.percentile("nothing", 99))


def test_reset_clears_all_state():
    t = tr.StatsTracker()
    t.count("a")
    t.gauge("b", 1.0)
    t.observe("c", 2.0)
    t.reset()
    assert t.snapshot() == {}
