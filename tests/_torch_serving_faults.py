"""Fault injection for the port's serving tier (tests/test_torch_serving*.py,
tests/test_torch_router.py, chip_smoke.py phases 17 and 24).

The port's copy of tests/_serving_faults.py, on `repro_torch`.
`install(server, ...)` wraps the server's `GridRunner.run` so the Nth
dispatch (0-based, counted per `run` call) raises a planted exception or
stalls before running — the two failure modes the server must survive: a
poisoned dispatch fails only its own batch's futures, a stalled dispatch
trips per-request deadlines via the reaper thread without wedging the
batcher.  A stall is a number of seconds, or a `threading.Event` that
holds the dispatch until it is set: with an event, a test decides when
the stall ends (after a kill, a cancel, a deadline) instead of racing a
sleep.  ``probe.stalled`` is set as a stall begins, so a test can wait
for "the dispatcher is inside the stall" instead of sleeping for it.

The wrapper also records, per call, the number of grid rows actually
dispatched — the observable for "a cancelled/expired request never
occupies device time" (the dispatcher's re-slice drops its rows) — and
the grids whose run returned (``probe.ran``, with the ``pad_to`` they ran
at), from which a caller reconstructs the kernel launches they made.

    probe = install(server, raise_on={1: RuntimeError("boom")},
                    stall_on={0: 0.5})
    ...
    assert probe.calls == 3
    assert probe.rows == [2, 1, 2]     # dispatch 1 re-sliced to 1 row

Install BEFORE `server.start()`: the wrapper swaps an instance attribute
on the runner, which is not synchronized with the dispatcher thread.
Over ranks, install on the leader: its runner fans each run out to the
followers, so a planted raise or stall comes before anything is sent.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Mapping

from repro_torch.launch import serving

# The longest an event stall holds a dispatch: a test that never sets its
# event fails instead of leaving a dispatcher thread behind.
STALL_LIMIT_S = 300.0


@dataclasses.dataclass
class DispatchProbe:
    """Call log + fault plan for one wrapped `GridRunner.run`."""

    raise_on: dict
    stall_on: dict
    calls: int = 0
    rows: list = dataclasses.field(default_factory=list)
    labels: list = dataclasses.field(default_factory=list)
    ran: list = dataclasses.field(default_factory=list)   # (grid, pad_to)
    stalled: threading.Event = dataclasses.field(
        default_factory=threading.Event)


def install(server, *, raise_on: Mapping[int, Exception] | None = None,
            stall_on: Mapping[int, float] | None = None) -> DispatchProbe:
    """Wrap ``server.runner.run`` with the given fault plan.

    Args:
      server: a `repro_torch.launch.serving.ScenarioServer` (not yet
        started).
      raise_on: dispatch index -> exception instance to raise INSTEAD of
        running that dispatch.
      stall_on: dispatch index -> seconds to sleep, or a
        `threading.Event` to wait for (at most `STALL_LIMIT_S`), BEFORE
        running that dispatch (simulates a slow/hung device program;
        combines with ``raise_on`` — stall first, then raise).

    Returns the `DispatchProbe` recording every call.
    """
    if getattr(server, "_started", False):
        raise RuntimeError("install fault injection before server.start()")
    probe = DispatchProbe(raise_on=dict(raise_on or {}),
                          stall_on=dict(stall_on or {}))
    runner = server.runner
    orig_run = runner.run

    def run_with_faults(grid, **kwargs):
        i = probe.calls
        probe.calls += 1
        probe.rows.append(len(grid))
        probe.labels.append(list(grid.labels))
        if i in probe.stall_on:
            probe.stalled.set()
            stall = probe.stall_on[i]
            if isinstance(stall, threading.Event):
                if not stall.wait(STALL_LIMIT_S):
                    raise RuntimeError(f"dispatch {i}: stall never released")
            else:
                time.sleep(stall)
        if i in probe.raise_on:
            raise probe.raise_on[i]
        res = orig_run(grid, **kwargs)
        probe.ran.append((grid, kwargs.get("pad_to")))
        return res

    runner.run = run_with_faults
    return probe


# ----------------------------------------------------------------------
# Router chaos: faults at the Replica transport boundary.
# ----------------------------------------------------------------------

class ChaosReplica:
    """A `router.Replica` wrapper that injects transport-level faults.

    Where `install` poisons dispatches INSIDE one server, this breaks
    the link BETWEEN the router and a replica — the failure modes a
    multi-replica deployment must route around (DESIGN.md §14).  Modes
    are switchable mid-run (that is the point):

      * ``kill()`` — submits raise `ServerStopped`, pings fail.  The
        inner server keeps running: requests already inside it still
        resolve (the router must win/lose the exactly-once race, not
        deadlock).
      * ``stall()`` — submits are swallowed: the caller gets a Future
        that never resolves (pings still succeed — the sneaky failure
        where health checks pass while work hangs; only the router's
        attempt timeout catches it).
      * ``slow(seconds)`` — submits pass through but results are
        delivered ``seconds`` late, or, given a `threading.Event`, once it
        is set (late enough → timeout + retry, and the eventual result
        must lose the resolution race, not deliver twice).
      * ``flap(period_s)`` — alternates alive/dead every ``period_s``
        (alive first), driven by the wall clock.
      * ``revive()`` — back to normal; still-pending stalled futures are
        cancelled.

    Wrap BEFORE handing the replica to `ScenarioRouter` (the router
    snapshots its replica dict at construction).
    """

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self._lock = threading.Lock()
        self._mode = "ok"
        self._slow_s = 0.0
        self._flap_period = 0.0
        self._flap_t0 = 0.0
        self._stalled: list[Future] = []
        self.submits = 0
        self.rejected = 0

    # -- fault plan ----------------------------------------------------

    def kill(self) -> None:
        with self._lock:
            self._mode = "killed"

    def stall(self) -> None:
        with self._lock:
            self._mode = "stalled"

    def slow(self, seconds) -> None:
        with self._lock:
            self._mode = "slow"
            self._slow_s = (seconds if isinstance(seconds, threading.Event)
                            else float(seconds))

    def flap(self, period_s: float) -> None:
        with self._lock:
            self._mode = "flapping"
            self._flap_period = float(period_s)
            self._flap_t0 = time.monotonic()

    def revive(self) -> None:
        with self._lock:
            self._mode = "ok"
            stalled, self._stalled = self._stalled, []
        for f in stalled:
            f.cancel()

    def _dead_now(self) -> bool:
        with self._lock:
            if self._mode == "killed":
                return True
            if self._mode == "flapping":
                phase = (time.monotonic() - self._flap_t0)
                return int(phase / self._flap_period) % 2 == 1
            return False

    # -- Replica protocol ----------------------------------------------

    def submit(self, grid, *, priority=0, deadline_s=None,
               tenant=serving.DEFAULT_TENANT) -> Future:
        self.submits += 1
        if self._dead_now():
            self.rejected += 1
            raise serving.ServerStopped(f"{self.name}: chaos-killed")
        with self._lock:
            mode, slow_s = self._mode, self._slow_s
        if mode == "stalled":
            f = Future()                 # never resolves; router's
            with self._lock:             # attempt timeout must save us
                self._stalled.append(f)
            return f
        inner_f = self.inner.submit(grid, priority=priority,
                                    deadline_s=deadline_s, tenant=tenant)
        if mode != "slow" or (not isinstance(slow_s, threading.Event)
                              and slow_s <= 0):
            return inner_f
        proxy = Future()

        def _deliver(f: Future) -> None:
            def copy():
                if f.cancelled():
                    proxy.cancel()
                    return
                if not proxy.set_running_or_notify_cancel():
                    return               # router cancelled the proxy
                exc = f.exception()
                if exc is not None:
                    proxy.set_exception(exc)
                else:
                    proxy.set_result(f.result())
            if isinstance(slow_s, threading.Event):
                t = threading.Thread(target=lambda: (
                    slow_s.wait(STALL_LIMIT_S), copy()), daemon=True)
            else:
                t = threading.Timer(slow_s, copy)
                t.daemon = True
            t.start()

        inner_f.add_done_callback(_deliver)
        return proxy

    def ping(self) -> bool:
        if self._dead_now():
            return False
        # Stalled/slow replicas ping fine — the dispute is settled by
        # attempt timeouts, not the heartbeat.
        return self.inner.ping()

    def warmup(self, *grids) -> int:
        return self.inner.warmup(*grids)

    def start(self) -> None:
        self.inner.start()

    def stop(self, *, drain: bool = True) -> None:
        self.revive()
        self.inner.stop(drain=drain)


def kill_replica(replica, release: threading.Event,
                 timeout: float = 60.0) -> None:
    """Kill a replica whose server holds a dispatch on ``release`` (its
    `install` plan stalls that dispatch on the event and then raises).

    ``replica`` is a `ChaosReplica` (its transport goes down too: submits
    raise, pings fail) or a plain `router.InProcessReplica`.  The server is
    hard-stopped, failing every request inside it, so the router must fail
    them over; a stopped server also refuses submits and fails its health
    check.  The held dispatch is let go once the stop has set the server's
    abort flag, so it returns into an aborted server (and the stop's
    thread joins need not time out)."""
    if isinstance(replica, ChaosReplica):
        replica.kill()
        server = replica.inner.server
    else:
        server = replica.server
    stopper = threading.Thread(target=server.stop, kwargs=dict(drain=False))
    stopper.start()
    deadline = time.monotonic() + timeout
    while not server._abort:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{replica.name}: the hard stop never began")
        time.sleep(0.002)
    release.set()
    stopper.join(timeout)
    if stopper.is_alive():
        raise TimeoutError(f"{replica.name}: the hard stop did not finish")
