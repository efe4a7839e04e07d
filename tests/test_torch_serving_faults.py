"""Fault-injection and stress tier of the port's serving engine (CPU).

The port of tests/test_serving_faults.py and tests/test_serving_stress.py.
tests/_torch_serving_faults.py poisons or stalls chosen dispatches; a
stall is held by an event until the test has made the state it wants
(a request expired, a batch coalesced and cancelled, a stop begun), so no
expectation rests on a sleep being long enough.  The server's survival
guarantees: a poisoned dispatch fails only its own batch, a stalled
dispatch trips per-request deadlines via the reaper (not the wedged
dispatcher), a cancelled request is re-sliced out of its coalesced batch
before touching the device, both stop flavors leave no future
forever-pending, and under seeded random interleavings of submit / cancel
/ stop across threads every accepted future terminates.

Delivered rows are held to the port's contract: the same bits as the
replayed dispatch (`GridRunner.run` of the grid the probe recorded, at its
padding) and within 1e-5 (accuracies equal) of `run_grid` of the request
alone.
"""
import threading
import time
from concurrent.futures import CancelledError, wait

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (fixes the thread count)
from _torch_serving_faults import install  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.fl import scenarios, simulator  # noqa: E402
from repro_torch.launch import serving  # noqa: E402
from repro_torch.models import smallnets  # noqa: E402

_PACKET_BITS = 32 * 64
TOL = 1e-5
WAIT_S = 60.0          # bound of every wait on a thread or a state
_TERMINAL = (serving.ServerStopped, serving.DeadlineExceeded)


def _init(g):
    return smallnets.init_mlp_clf(g, d_in=32, d_hidden=16)


@pytest.fixture(scope="module")
def toy():
    data = synthetic.fed_image_classification(n_clients=3,
                                              samples_per_client=20, seed=0)
    nets = [
        topology.make_network(
            topology.TABLE_II_COORDS[:3], edge_density=d,
            packet_len_bits=_PACKET_BITS, n_clients=3, tx_power_dbm=17.0,
        )
        for d in (0.6, 0.8)
    ]
    return data, nets, _init, smallnets.apply_mlp_clf


def _cfg(**kw):
    kw.setdefault("n_rounds", 2)
    kw.setdefault("local_epochs", 1)
    kw.setdefault("seg_len", 64)
    kw.setdefault("agg_impl", "kernel")
    return simulator.SimConfig(**kw)


def _server(toy, cfg=None, **serve_kw):
    data, _nets, init, apply_fn = toy
    return serving.ScenarioServer(
        init, apply_fn, data, cfg or _cfg(),
        serve=serving.ServeConfig(**serve_kw), device="cpu")


def _grid(net, proto="ra", label="g", seed=0):
    return scenarios.ScenarioGrid.product(
        networks=[(label, net)], protocols=[(proto, "ra_normalized")],
        seeds=[seed],
    )


def _wait_until(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


def _hard_stop_then_release(server, release, futures):
    """Hard-stop ``server`` while a dispatch is held by ``release``; set
    it once the stop has failed ``futures``, so the held dispatch returns
    into an aborted server (and the stop's join need not time out)."""
    t = threading.Thread(target=server.stop, kwargs=dict(drain=False))
    t.start()
    _wait_until(lambda: all(f.done() for f in futures),
                "the hard stop to fail every pending future")
    release.set()
    t.join(WAIT_S)
    assert not t.is_alive()


def _check(toy, probe, fut, grid, cfg=None):
    """A delivered request against the contract (see the module)."""
    data, _nets, init, apply_fn = toy
    got = fut.result(timeout=WAIT_S)
    assert got.labels == grid.labels
    runner = scenarios.GridRunner(init, apply_fn, data, cfg or _cfg(),
                                  device="cpu")
    for g, pad in probe.ran:
        if grid.labels[0] in g.labels:
            i = g.labels.index(grid.labels[0])
            rows = runner.run(g, pad_to=pad, validate=False)
            np.testing.assert_array_equal(got.loss, rows.loss[i:i + 1])
            np.testing.assert_array_equal(got.acc, rows.acc[i:i + 1])
            break
    else:
        raise AssertionError(f"no dispatch ran {grid.labels}")
    alone = scenarios.run_grid(init, apply_fn, data, grid, cfg or _cfg(),
                               device="cpu")
    np.testing.assert_array_equal(got.acc, alone.acc)
    np.testing.assert_allclose(got.loss, alone.loss, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.bias, alone.bias, atol=TOL, rtol=0,
                               equal_nan=True)


def test_poisoned_dispatch_fails_only_the_poisoned_request(toy):
    """Coalesced dispatch 0 raises: each member is retried INDIVIDUALLY —
    the request whose solo retry also raises fails, its innocent neighbor
    is served; the next submit is served normally."""
    data, nets, init, apply_fn = toy
    boom = RuntimeError("injected dispatch failure")
    server = _server(toy, max_batch=2, max_delay_s=30.0)
    # Call 0 is the coalesced [a, b] batch; call 1 is a's solo retry
    # (poisoned again -> a truly fails); call 2 is b's solo retry
    # (clean -> b is served); call 3 is c.
    probe = install(server, raise_on={0: boom, 1: boom})
    gb, gc = _grid(nets[1], label="b"), _grid(nets[0], label="c")
    with server:
        fa = server.submit(_grid(nets[0], "ra", "a"))
        fb = server.submit(gb)
        with pytest.raises(RuntimeError, match="injected"):
            fa.result(timeout=WAIT_S)
        fb.result(timeout=WAIT_S)
        fc = server.submit(gc, priority=1)
        fc.result(timeout=WAIT_S)
    _check(toy, probe, fb, gb)
    _check(toy, probe, fc, gc)
    assert probe.calls == 4
    assert probe.rows == [2, 1, 1, 1]
    snap = server.tracker.snapshot()
    assert snap["serve/dispatch_errors"] == 1
    assert snap["serve/dispatch_retries"] == 2
    assert snap["serve/requests"] == 3


def test_single_request_dispatch_failure_is_not_retried(toy):
    """A poisoned dispatch with ONE member has no innocent neighbors:
    the failure propagates without a retry dispatch."""
    data, nets, init, apply_fn = toy
    server = _server(toy, max_batch=1, max_delay_s=0.01)
    probe = install(server, raise_on={0: RuntimeError("injected solo")})
    with server:
        fa = server.submit(_grid(nets[0], "ra", "a"))
        with pytest.raises(RuntimeError, match="injected solo"):
            fa.result(timeout=WAIT_S)
    assert probe.calls == 1
    snap = server.tracker.snapshot()
    assert snap["serve/dispatch_errors"] == 1
    assert snap.get("serve/dispatch_retries", 0) == 0


def test_deadline_race_between_dispatch_and_delivery_is_discarded(toy):
    """A request whose deadline expires AFTER the dispatcher's liveness
    re-slice but BEFORE its dispatch returns is failed by the reaper with
    `DeadlineExceeded`; the computed result is discarded
    (`serve/results_discarded`), never delivered twice."""
    data, nets, init, apply_fn = toy
    server = _server(toy, max_batch=4, max_delay_s=0.01)
    server.warmup(_grid(nets[0], label="a"))
    release = threading.Event()
    probe = install(server, stall_on={0: release})
    try:
        with server:
            fa = server.submit(_grid(nets[0], "ra", "a"), deadline_s=0.3)
            # The reaper fires while the dispatch is still held.
            with pytest.raises(serving.DeadlineExceeded):
                fa.result(timeout=WAIT_S)
            assert probe.stalled.is_set() and not release.is_set()
            release.set()
            fb = server.submit(_grid(nets[0], "ra", "b"))
            assert fb.result(timeout=WAIT_S) is not None
    finally:
        release.set()
    # The expired request WAS dispatched (the race is post-re-slice) ...
    assert probe.calls == 2
    assert probe.rows[0] == 1
    snap = server.tracker.snapshot()
    assert snap["serve/deadline_exceeded"] == 1
    # ... and its late result was discarded, not delivered.
    assert snap["serve/results_discarded"] == 1


def test_stalled_dispatch_trips_deadlines_without_wedging(toy):
    """While dispatch 0 stalls, queued requests' deadlines still fire
    (reaper thread), their rows never reach the device, and the batcher
    keeps serving afterwards."""
    data, nets, init, apply_fn = toy
    server = _server(toy, max_batch=8, max_delay_s=0.01)
    server.warmup(_grid(nets[0], label="warm"))
    release = threading.Event()
    probe = install(server, stall_on={0: release})
    try:
        with server:
            fa = server.submit(_grid(nets[0], "ra", "a"))
            assert probe.stalled.wait(WAIT_S)  # A is in the dispatcher
            fb = server.submit(_grid(nets[0], "ra", "b"), deadline_s=0.3)
            fc = server.submit(_grid(nets[0], "ra", "c"), deadline_s=0.3)
            with pytest.raises(serving.DeadlineExceeded):
                fb.result(timeout=WAIT_S)
            with pytest.raises(serving.DeadlineExceeded):
                fc.result(timeout=WAIT_S)
            assert not release.is_set()        # fired DURING the stall
            release.set()
            assert fa.result(timeout=WAIT_S) is not None
            fd = server.submit(_grid(nets[0], "ra", "d"))
            assert fd.result(timeout=WAIT_S) is not None
    finally:
        release.set()
    # Only A and D ever touched the runner: the expired batch was skipped
    # wholesale by the dispatcher's liveness check.
    assert probe.calls == 2
    snap = server.tracker.snapshot()
    assert snap["serve/deadline_exceeded"] == 2


def test_cancel_before_dispatch_reslices_coalesced_batch(toy):
    """Cancelling one request of a coalesced pending batch drops exactly
    its rows (ScenarioGrid.take re-slice); the surviving request is
    delivered within the contract."""
    data, nets, init, apply_fn = toy
    keep = _grid(nets[1], "ra", "keep")
    server = _server(toy, max_batch=2, max_delay_s=30.0)
    release = threading.Event()
    probe = install(server, stall_on={0: release})
    try:
        with server:
            fa = server.submit(_grid(nets[0], "ra", "a"), priority=1)
            assert probe.stalled.wait(WAIT_S)  # A is in the dispatcher
            f_cancel = server.submit(_grid(nets[0], "ra", "cancel-me"))
            f_keep = server.submit(keep)
            # Both requests are provably inside one prepared _Dispatch
            # (max_batch reached; the dispatcher is still held), THEN
            # cancel: the drop must happen at dispatch time, by re-slice.
            _wait_until(lambda: server._dispatches.qsize() == 1,
                        "the coalesced batch to be queued")
            assert f_cancel.cancel()           # still pending: cancel wins
            release.set()
            f_keep.result(timeout=WAIT_S)
            assert fa.result(timeout=WAIT_S) is not None
            with pytest.raises(CancelledError):
                f_cancel.result(timeout=1)
    finally:
        release.set()
    _check(toy, probe, f_keep, keep)
    # The coalesced 2-row batch was re-sliced to 1 surviving row.
    assert probe.calls == 2
    assert probe.rows[-1] == 1
    assert probe.labels[-1] == ["keep/ra+ra_normalized"]
    snap = server.tracker.snapshot()
    assert snap["serve/dropped_before_dispatch"] == 1


def test_submit_input_hardening(toy):
    """Malformed scheduling inputs fail at submit with NAMED errors —
    never undefined scheduler behavior (a NaN priority would poison every
    queue-ordering comparison; a zero deadline is born expired)."""
    data, nets, init, apply_fn = toy
    server = _server(toy, tenant_weights={"alice": 2.0})
    g = _grid(nets[0], "ra", "v")
    with server:
        for bad_deadline in (0.0, -1.0, float("nan"), float("inf")):
            with pytest.raises(serving.InvalidRequest):
                server.submit(g, deadline_s=bad_deadline)
        for bad_priority in (float("nan"), 1.5, "high"):
            with pytest.raises(serving.InvalidRequest):
                server.submit(g, priority=bad_priority)
        with pytest.raises(serving.UnknownTenant):
            server.submit(g, tenant="mallory")
        assert server.submit(g, tenant="alice").result(timeout=WAIT_S)
        assert server.submit(g).result(timeout=WAIT_S)
    assert server.tracker.snapshot()["serve/requests"] == 2
    for bad in ({"a": float("nan")}, {"a": 0.0}, {"a": -1.0}):
        with pytest.raises(ValueError):
            serving.ServeConfig(tenant_weights=bad)


def test_hard_stop_fails_all_pending_futures(toy):
    """stop(drain=False): queued, coalesced, and in-flight requests all
    fail with ServerStopped immediately; new submits are rejected."""
    data, nets, init, apply_fn = toy
    server = _server(toy, max_batch=1, max_delay_s=0.01)
    release = threading.Event()
    probe = install(server, stall_on={0: release})
    server.start()
    try:
        f_inflight = server.submit(_grid(nets[0], "ra", "a"))
        assert probe.stalled.wait(WAIT_S)      # A is executing (held)
        f_queued = [server.submit(_grid(nets[0], "ra", f"q{i}"))
                    for i in range(3)]
        t0 = time.monotonic()
        _hard_stop_then_release(server, release, [f_inflight, *f_queued])
        for f in [f_inflight, *f_queued]:
            with pytest.raises(serving.ServerStopped):
                f.result(timeout=1)
        assert time.monotonic() - t0 < 5.0
        with pytest.raises(serving.ServerStopped):
            server.submit(_grid(nets[0], "ra", "late"))
    finally:
        release.set()
        server.stop(drain=False)
    snap = server.tracker.snapshot()
    assert snap["serve/stopped_requests"] == 4
    assert probe.calls == 1


def test_drain_stop_serves_everything_accepted(toy):
    """stop(drain=True): every accepted request resolves with a result,
    within the contract."""
    data, nets, init, apply_fn = toy
    reqs = [_grid(nets[i % 2], "ra", f"r{i}", seed=i) for i in range(4)]
    server = _server(toy, max_batch=2, max_delay_s=0.05)
    probe = install(server)
    server.start()
    try:
        futs = [server.submit(g) for g in reqs]
        server.stop()                     # drain default
    finally:
        server.stop(drain=False)
    for f, g in zip(futs, reqs):
        assert f.done()
        _check(toy, probe, f, g)
    server.stop()                         # idempotent


def test_submit_stop_race_never_leaves_pending_futures(toy):
    """Threads racing submit against stop: every accepted future
    terminates (result or ServerStopped) — none is left pending."""
    data, nets, init, apply_fn = toy
    grid = _grid(nets[0], label="race")
    for trial, drain in enumerate((True, False, True, False)):
        server = _server(toy, max_batch=4, max_delay_s=0.005)
        server.warmup(grid)
        server.start()
        futures, rejected = [], []
        stop_now = threading.Event()

        def submitter():
            while not stop_now.is_set():
                try:
                    futures.append(server.submit(grid))
                except serving.ServerStopped:
                    rejected.append(1)
                    return

        threads = [threading.Thread(target=submitter) for _ in range(3)]
        try:
            for t in threads:
                t.start()
            _wait_until(lambda: len(futures) >= 2 * (trial + 1),
                        "submits to land")
            server.stop(drain=drain)
        finally:
            stop_now.set()
            server.stop(drain=False)
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        done, not_done = wait(futures, timeout=WAIT_S)
        assert not not_done, f"{len(not_done)} futures never terminated"
        for f in done:
            exc = f.exception(timeout=0)
            assert exc is None or isinstance(exc, serving.ServerStopped)


# ---------------------------------------------------------------------
# Stress: seeded random interleavings (tests/test_serving_stress.py)
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def stress_toy(toy):
    data, nets, init, apply_fn = toy
    net = topology.make_network(
        topology.TABLE_II_COORDS[:3], edge_density=0.7,
        packet_len_bits=_PACKET_BITS, n_clients=3, tx_power_dbm=17.0,
    )
    grids = [
        scenarios.ScenarioGrid.product(
            networks=[("net", net)], protocols=[("ra", "ra_normalized")],
            seeds=[s],
        )
        for s in range(4)
    ]
    return data, init, apply_fn, _cfg(n_rounds=1), grids


@pytest.mark.parametrize("seed", [11, 23, 37])
def test_random_interleavings_every_future_terminates(stress_toy, seed):
    """One randomized interleaving a seed: build + warm a server, race 3
    submit/cancel threads against a stop at a random point, then assert
    every accepted future terminated in an allowed state."""
    data, init, apply_fn, cfg, grids = stress_toy
    rng = np.random.default_rng(seed)
    tenants = ("alice", "bob")
    server = serving.ScenarioServer(
        init, apply_fn, data, cfg,
        serve=serving.ServeConfig(
            max_batch=int(rng.integers(1, 5)),
            max_delay_s=float(rng.uniform(0.0, 0.02)),
            tenant_weights={"alice": 3.0, "bob": 1.0},
        ),
        device="cpu",
    )
    server.warmup(grids[0])
    server.start()
    futures: list = []
    fut_lock = threading.Lock()
    rejected = threading.Event()

    def worker(wseed: int) -> None:
        wrng = np.random.default_rng(wseed)
        for _ in range(12):
            op = wrng.random()
            try:
                if op < 0.7:             # submit (mixed priority/SLA/tenant)
                    f = server.submit(
                        grids[int(wrng.integers(0, len(grids)))],
                        priority=int(wrng.random() < 0.3),
                        deadline_s=(float(wrng.uniform(0.005, 0.5))
                                    if wrng.random() < 0.3 else None),
                        tenant=tenants[int(wrng.integers(0, 2))],
                    )
                    with fut_lock:
                        futures.append(f)
                else:                    # cancel a random earlier future
                    with fut_lock:
                        pick = (futures[int(wrng.integers(0, len(futures)))]
                                if futures else None)
                    if pick is not None:
                        pick.cancel()
            except serving.ServerStopped:
                rejected.set()
                return
            if wrng.random() < 0.5:
                time.sleep(float(wrng.uniform(0.0, 0.003)))

    threads = [threading.Thread(target=worker,
                                args=(int(rng.integers(2**31)),))
               for _ in range(3)]
    drain = bool(rng.integers(0, 2))
    try:
        for t in threads:
            t.start()
        time.sleep(float(rng.uniform(0.0, 0.15)))  # the random stop point
        server.stop(drain=drain)
    finally:
        server.stop(drain=False)
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive(), "worker thread deadlocked"

    done, not_done = wait(futures, timeout=WAIT_S)
    assert not not_done, (
        f"{len(not_done)} accepted futures never terminated "
        f"(seed={seed}, drain={drain})"
    )
    for f in done:
        if f.cancelled():
            continue
        exc = f.exception(timeout=0)
        if exc is None:
            assert len(f.result(timeout=0).labels) == 1
        else:
            assert isinstance(exc, _TERMINAL), (
                f"unexpected terminal state {type(exc).__name__}: {exc} "
                f"(seed={seed}, drain={drain})"
            )


def test_cancel_storm_no_deadlock(stress_toy):
    """Cancel every future immediately after submit, from the submitting
    threads, while the server runs: nothing wedges, the server still
    serves a fresh request afterwards."""
    data, init, apply_fn, cfg, grids = stress_toy
    server = serving.ScenarioServer(
        init, apply_fn, data, cfg,
        serve=serving.ServeConfig(max_batch=4, max_delay_s=0.005),
        device="cpu",
    )
    server.warmup(grids[0])
    futures: list = []
    lock = threading.Lock()

    def storm():
        for _ in range(20):
            try:
                f = server.submit(grids[0])
            except serving.ServerStopped:
                return
            f.cancel()
            with lock:
                futures.append(f)

    with server:
        threads = [threading.Thread(target=storm) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        survivor = server.submit(grids[1])
        assert survivor.result(timeout=WAIT_S) is not None
    done, not_done = wait(futures, timeout=WAIT_S)
    assert not not_done
    for f in done:
        if not f.cancelled():
            exc = f.exception(timeout=0)
            assert exc is None or isinstance(exc, _TERMINAL)


def test_expired_deadline_terminates_even_while_idle(stress_toy):
    """A deadline fires from the reaper with no other traffic and its
    dispatch held: the SLA does not depend on traffic, nor on the
    dispatch returning, to be enforced.  (The near-deadline window ships
    the request at half its slack, so the dispatch is held here: on the
    CPU the toy dispatch would otherwise beat a 50 ms deadline.)"""
    data, init, apply_fn, cfg, grids = stress_toy
    server = serving.ScenarioServer(
        init, apply_fn, data, cfg,
        serve=serving.ServeConfig(max_batch=8, max_delay_s=30.0),
        device="cpu",
    )
    release = threading.Event()
    probe = install(server, stall_on={0: release})
    try:
        with server:
            f = server.submit(grids[0], deadline_s=0.05)
            with pytest.raises(serving.DeadlineExceeded):
                f.result(timeout=10.0)
            assert probe.stalled.is_set() and not release.is_set()
            release.set()
    finally:
        release.set()
    assert server.tracker.snapshot()["serve/results_discarded"] == 1
