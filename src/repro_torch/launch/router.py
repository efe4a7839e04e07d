"""Fault-tolerant multi-replica serving front-end.

Port of the reference package's `launch/router.py`.  A single
`ScenarioServer` is a single point of failure.  The paper's core move —
compensate for lossy links at the aggregation layer instead of assuming a
clean channel — applies one layer up too: the serving tier should keep
delivering correct results while individual replicas die, stall, or flap.
`ScenarioRouter` is that layer: a front-end that spreads `submit()`
traffic over N `ScenarioServer` replicas behind a small `Replica`
transport protocol (in-process replicas today; a multi-process transport
slots in behind the same protocol later).  `ScenarioRouter.in_process`
builds N servers on the one card: each has its own queue, threads and
program cache, and their dispatches share the card's default stream.
With ``devices=`` naming several ranks every replica serves over the same
ranks (`launch.serving`: each server a private mesh of them): every rank
of the default group calls `in_process` with the same arguments, the
mesh's leader gets the router (its ring, breakers and heartbeats live
there only), and every other rank gets a `FollowerRouter` over the
replicas' follower servers, built in the same order.  Replicas over
disjoint rank sets are not built (nor in the reference, which leaves
them to a multi-process transport).

  * **Consistent hashing keeps caches warm** — requests route by the
    grid's hoist/group signature (`grid_signature`: the dispatch
    partition + the hoisted/mapped field pattern + per-scenario leaf
    shapes — the same facts that key `ProgramCache`), so a given program
    family always lands on the same replica and each replica's bounded
    program LRU stays warm.  The ring uses virtual nodes; a replica's
    death only remaps ITS arc.
  * **Health checks + circuit breakers** — a heartbeat thread pings
    every replica; each replica has a `CircuitBreaker`: CLOSED routes
    normally, ``breaker_failures`` consecutive failures/timeouts OPEN it
    (no traffic), after ``breaker_cooldown_s`` it goes HALF_OPEN and
    admits exactly one probe (the next routed request, or a successful
    heartbeat) — success re-closes it, failure re-opens it.
  * **Retry / backoff / failover** — a failed or timed-out attempt is
    retried on the next replica in the key's ring walk with exponential
    backoff plus jitter (``backoff_base_s * 2^k``, capped, times
    ``1 + jitter * U[0,1)``), up to ``max_attempts``.  Delivery is
    EXACTLY-ONCE: every outcome path races through the serving tier's
    `_try_resolve` state machine, so a request that already delivered
    can never deliver twice — late results from a timed-out attempt, a
    hedge loser, or a replica that recovered mid-retry are discarded
    (``router/results_discarded``).  Replicas run the same programs, so a
    delivered result does not depend on which replica (or attempt) served
    it, up to the serving tier's contract: the same bits as the replica's
    `GridRunner.run` of the coalesced grid it dispatched, and within
    float32 tolerance of `run_grid` of the request alone (see
    `launch.serving`; the reference promises bit-identity, the port does
    not).
  * **Hedging** — with ``hedge_slack_frac`` set, a request whose
    deadline is nearly spent launches a second attempt on another
    replica; the first result wins the `_try_resolve` race.
  * **Global tenant quotas** — ``tenant_quotas`` bounds OUTSTANDING
    scenarios per tenant across all replicas (router-level admission,
    not per process): exceeding it raises `QuotaExceeded` at submit.
  * **Cross-replica stop / drain** — ``stop(drain=True)`` waits for
    every accepted request (failover retries included) then drains each
    replica; ``stop(drain=False)`` fails everything outstanding with
    `ServerStopped` immediately.  `drain_replica(name)` removes one
    replica from routing, waits out its in-flight attempts, and
    drain-stops it while the survivors keep serving — planned failover.

    router = ScenarioRouter.in_process(
        init, apply_fn, data, cfg, n_replicas=2,
        serve=ServeConfig(max_batch=4),
        route=RouterConfig(max_attempts=3, heartbeat_s=0.1),
    )                                   # the card; device="cpu" for the CPU
    with router:
        router.warmup(pool_grids)
        fut = router.submit(grid, deadline_s=2.0, tenant="teamA")
        res = fut.result()          # survives any single replica's death

Termination guarantee: every accepted future terminates — with a result,
`DeadlineExceeded`, `ServerStopped`, a cancel-ack, or the final
attempt's error — because attempts are bounded (``max_attempts``), every
attempt is bounded in time (``attempt_timeout_s``), and backoff delays
are clipped to the request's remaining deadline.  The chaos tests
(tests/test_torch_router.py with tests/_torch_serving_faults.py) kill,
stall, slow, and flap replicas mid-run and assert exactly this, plus the
contract above for every delivered result.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import heapq
import math
import threading
import time
from concurrent.futures import Future, wait
from typing import Callable, Mapping, Protocol, Sequence

import numpy as np
import torch

from ..fl import scenarios, simulator
from . import serving
from . import tracker as launch_tracker
from .serving import (DEFAULT_TENANT, DeadlineExceeded, ServeConfig,
                      ServerStopped, _ack_cancel, _try_resolve)


class QuotaExceeded(RuntimeError):
    """The tenant's global outstanding-scenario quota
    (`RouterConfig.tenant_quotas`) is full.  Raised synchronously by
    `ScenarioRouter.submit`; back off and resubmit once earlier requests
    resolve."""


class NoHealthyReplica(RuntimeError):
    """No replica's circuit breaker admits traffic for this request.

    Set as a request's exception only after retries/backoff are
    exhausted without any breaker re-closing — the router keeps retrying
    through half-open probes first."""


class ReplicaTimeout(TimeoutError):
    """One attempt exceeded `RouterConfig.attempt_timeout_s`.  Feeds the
    replica's circuit breaker like a failure; the request itself is
    retried elsewhere (clients only ever see this as the terminal error
    when every attempt timed out)."""


class Replica(Protocol):
    """Transport protocol between the router and one serving replica.

    In-process replicas (`InProcessReplica`) satisfy it by delegating to
    a `ScenarioServer`; a multi-process backend satisfies the same five
    methods over its wire of choice.  Contract: `submit` either raises
    synchronously (validation, stopped) or returns a Future that the
    replica eventually resolves; `ping` must return promptly (transports
    enforce their own wire timeouts) — the router turns slow REQUESTS
    into breaker signals via `attempt_timeout_s`, not slow pings.
    """

    name: str

    def submit(self, grid: scenarios.ScenarioGrid, *, priority: int = 0,
               deadline_s: float | None = None,
               tenant: str = DEFAULT_TENANT) -> Future: ...

    def ping(self) -> bool: ...

    def warmup(self, *grids: scenarios.ScenarioGrid) -> int: ...

    def start(self) -> None: ...

    def stop(self, *, drain: bool = True) -> None: ...


class FollowerRouter:
    """`ScenarioRouter.in_process(devices=)` on a rank that is not the
    replicas' leader: their follower servers (or, outside the mesh, their
    idle servers).

    `start` starts every replica's command loop; `stop` and
    `drain_replica` return once the leader has released that replica's
    followers (its router's `stop` / `drain_replica`, or the replica's own
    stop); `warmup` builds here what the leader's router builds there (the
    same ring); `submit` / `serve` raise `serving.NotLeader`."""

    def __init__(self, replicas: Sequence["InProcessReplica"],
                 route: "RouterConfig"):
        self._replicas = {r.name: r for r in replicas}
        self._ring = _HashRing(list(self._replicas), vnodes=route.vnodes)

    @property
    def replicas(self) -> Mapping[str, "InProcessReplica"]:
        return dict(self._replicas)

    def start(self) -> "FollowerRouter":
        for r in self._replicas.values():
            r.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        for r in self._replicas.values():
            r.stop(drain=drain)

    def drain_replica(self, name: str, *, timeout: float | None = None
                      ) -> None:
        self._replicas[name].stop()

    def warmup(self, grids: Sequence[scenarios.ScenarioGrid], *,
               fanout: int = 2) -> int:
        return _warm(self._ring, self._replicas, grids, fanout)

    def submit(self, grid: scenarios.ScenarioGrid, **_kw) -> Future:
        return next(iter(self._replicas.values())).submit(grid)

    def serve(self, grids: Sequence[scenarios.ScenarioGrid]) -> list:
        return [self.submit(g) for g in grids]

    def __enter__(self) -> "FollowerRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class InProcessReplica:
    """A `Replica` wrapping one in-process `ScenarioServer`.

    The process boundary is the `Replica` protocol, not this class: the
    router never reaches past it (tests inject chaos by wrapping it),
    so swapping in a socket-backed transport changes nothing above.
    """

    def __init__(self, name: str, server: serving.ScenarioServer):
        self.name = name
        self.server = server

    def submit(self, grid: scenarios.ScenarioGrid, *, priority: int = 0,
               deadline_s: float | None = None,
               tenant: str = DEFAULT_TENANT) -> Future:
        return self.server.submit(grid, priority=priority,
                                  deadline_s=deadline_s, tenant=tenant)

    def ping(self) -> bool:
        return self.server.healthy()

    def warmup(self, *grids: scenarios.ScenarioGrid) -> int:
        return self.server.warmup(*grids)

    def start(self) -> None:
        if not self.server._started:
            self.server.start()

    def stop(self, *, drain: bool = True) -> None:
        self.server.stop(drain=drain)


# ----------------------------------------------------------------------
# Routing key: the grid's hoist/group signature.
# ----------------------------------------------------------------------

def grid_signature(grid: scenarios.ScenarioGrid) -> str:
    """The cache-affinity routing key of a grid (host-only, no device
    work).

    Two grids share a signature exactly when they exercise the same
    program family: same dispatch partition, same hoisted-vs-mapped field
    pattern (`_batch_uniform` on each leaf — what `_hoist_uniform` will
    decide at dispatch time), and same per-scenario leaf shapes/dtypes
    (batch axis excluded, so request SIZE does not scatter a family across
    replicas — bucket padding already normalizes sizes).  Routing by this
    signature keeps each replica's `ProgramCache` warm: a family always
    lands on the same replica.

    The dispatch partition is the port's, on purpose: every discrete id of
    `simulator.BATCH_IDS` (protocol, mode, aggregator, codec, policy) that
    the grid carries, since `GridRunner` splits a grid by all of them (its
    round branches on each in Python).  The reference keys only (protocol,
    mode), which would send a family the port's runner splits to one
    replica under one key while its programs are cached as two.
    """
    s = grid.scenarios
    present = [name for name in simulator.BATCH_IDS
               if getattr(s, name) is not None]
    columns = [np.asarray(getattr(s, name)).ravel() for name in present]
    groups = sorted({tuple(int(c[i]) for c in columns)
                     for i in range(len(grid))})
    fields = []
    for name, leaf in s._asdict().items():
        if leaf is None:
            fields.append((name, None))
            continue
        arr = np.asarray(leaf)
        mapped = name == "seed" or not scenarios._batch_uniform(arr)
        fields.append((name, "mapped" if mapped else "hoisted",
                       tuple(arr.shape[1:]), str(arr.dtype)))
    return repr((groups, tuple(fields)))


def _stable_hash(key: str) -> int:
    """Process-independent 64-bit hash (python's `hash` is salted per
    process — useless for a ring that must agree across restarts)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big"
    )


class _HashRing:
    """Consistent-hash ring with virtual nodes.

    `preference(key)` walks the ring clockwise from the key's point and
    returns every replica once, in encounter order — position 0 is the
    primary, the rest the failover order.  Adding/removing one replica
    only remaps the arcs it owns (~1/N of keys), so a replica death does
    not reshuffle every other replica's warm cache.
    """

    def __init__(self, names: Sequence[str], vnodes: int = 64):
        if not names:
            raise ValueError("hash ring needs at least one replica")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {sorted(names)}")
        self._points = sorted(
            (_stable_hash(f"{n}#{i}"), n)
            for n in names for i in range(vnodes)
        )

    def preference(self, key: str) -> list[str]:
        h = _stable_hash(key)
        idx = bisect.bisect_left(self._points, (h, ""))
        seen: set[str] = set()
        order: list[str] = []
        n_pts = len(self._points)
        for j in range(n_pts):
            _, name = self._points[(idx + j) % n_pts]
            if name not in seen:
                seen.add(name)
                order.append(name)
        return order


def _warm(ring: _HashRing, replicas: Mapping[str, Replica],
          grids: Sequence[scenarios.ScenarioGrid], fanout: int) -> int:
    """`ScenarioRouter.warmup`: each grid on its first ``fanout`` replicas
    in ring order; the programs built."""
    built = 0
    for g in grids:
        for name in ring.preference(grid_signature(g))[:max(1, fanout)]:
            built += replicas[name].warmup(g)
    return built


# ----------------------------------------------------------------------
# Circuit breaker.
# ----------------------------------------------------------------------

class CircuitBreaker:
    """Per-replica circuit breaker (DESIGN.md §14).

    CLOSED: traffic flows; each failure/timeout bumps a consecutive
    counter (any success resets it).  At ``failures`` consecutive
    failures the breaker OPENs: `allow` refuses all traffic for
    ``cooldown_s``.  After the cooldown it is HALF_OPEN: exactly one
    probe is admitted (the first `allow` call, or a successful
    heartbeat ping) — probe success re-CLOSEs, probe failure re-OPENs
    for another cooldown.  Thread-safe; time is injected by the caller
    so tests can drive transitions deterministically.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failures: int = 3, cooldown_s: float = 0.5,
                 on_open: Callable[[], None] | None = None):
        if failures < 1:
            raise ValueError(f"failures must be >= 1, got {failures}")
        self._lock = threading.Lock()
        self._failures = failures
        self._cooldown_s = cooldown_s
        self._consecutive = 0
        self._state = self.CLOSED
        self._open_until = 0.0
        self._probing = False
        self._on_open = on_open

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self, now: float | None = None) -> bool:
        """May a request be routed here now?  The transition out of OPEN
        happens HERE: the first `allow` past the cooldown flips to
        HALF_OPEN and admits that one caller as the probe."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if now < self._open_until:
                    return False
                self._state = self.HALF_OPEN
                self._probing = True
                return True
            # HALF_OPEN: one probe at a time.
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._state = self.CLOSED
            self._probing = False

    def record_failure(self, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        opened = False
        with self._lock:
            self._consecutive += 1
            trip = (self._state == self.HALF_OPEN
                    or self._consecutive >= self._failures)
            if trip:
                opened = self._state != self.OPEN
                self._state = self.OPEN
                self._open_until = now + self._cooldown_s
                self._probing = False
        if opened and self._on_open is not None:
            self._on_open()

    def on_ping(self, ok: bool, now: float | None = None) -> None:
        """Feed a heartbeat result.  A failed ping counts like a request
        failure.  A successful ping is the half-open probe when the
        breaker is past its cooldown (it re-closes); while CLOSED it is
        deliberately NOT a success — heartbeats must not mask a replica
        whose pings succeed while its dispatches fail."""
        now = time.monotonic() if now is None else now
        if not ok:
            self.record_failure(now)
            return
        with self._lock:
            if self._state == self.HALF_OPEN or (
                self._state == self.OPEN and now >= self._open_until
            ):
                self._state = self.CLOSED
                self._consecutive = 0
                self._probing = False


# ----------------------------------------------------------------------
# Deadline/backoff timer.
# ----------------------------------------------------------------------

class _TimerThread:
    """One thread, one heap: runs scheduled callbacks at their due time.

    Carries every time-based edge of the router — retry backoffs,
    per-attempt timeouts, hedge triggers, request deadlines — so the
    router needs no thread-per-request.  Callbacks must be short and
    non-blocking (they hand real work to `_try_resolve` / replica
    submits); a callback that raises is counted, never fatal.
    """

    def __init__(self, on_error: Callable[[BaseException], None]):
        self._cv = threading.Condition()
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self._closed = False
        self._on_error = on_error
        self._thread = threading.Thread(
            target=self._loop, name="scenario-router-timer", daemon=True
        )
        self._thread.start()

    def call_at(self, when: float, fn: Callable[[], None]) -> None:
        with self._cv:
            if self._closed:
                return                  # shutdown: drops are safe — every
                                        # outstanding future is swept by stop()
            heapq.heappush(self._heap, (when, self._seq, fn))
            self._seq += 1
            self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._closed:
                        return
                    now = time.monotonic()
                    if self._heap and self._heap[0][0] <= now:
                        _, _, fn = heapq.heappop(self._heap)
                        break
                    if self._heap:
                        self._cv.wait(self._heap[0][0] - now)
                    else:
                        self._cv.wait()
            try:
                fn()
            except BaseException as e:   # noqa: BLE001 — timer must survive
                self._on_error(e)


# ----------------------------------------------------------------------
# The router.
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Router knobs (DESIGN.md §14).

    ``vnodes`` is the virtual-node count per replica on the hash ring;
    ``heartbeat_s`` the health-check period; ``breaker_failures`` /
    ``breaker_cooldown_s`` parameterize each replica's `CircuitBreaker`;
    ``max_attempts`` bounds tries per request (1 = no retry);
    ``attempt_timeout_s`` bounds one attempt's wall clock before the
    router treats it as failed and retries elsewhere (None = only the
    request deadline bounds it — every request then needs a deadline for
    the termination guarantee to hold); ``backoff_base_s`` /
    ``backoff_cap_s`` / ``jitter`` shape the retry delay
    ``min(cap, base * 2^k) * (1 + jitter * U[0,1))``;
    ``hedge_slack_frac`` (None = off) launches a second attempt on
    another replica once a deadlined request's remaining slack falls
    below this fraction of its total budget; ``tenant_quotas`` caps
    OUTSTANDING scenarios per tenant across all replicas (global
    admission — unlisted tenants are unlimited); ``seed`` makes the
    backoff jitter reproducible.
    """

    vnodes: int = 64
    heartbeat_s: float = 0.05
    breaker_failures: int = 3
    breaker_cooldown_s: float = 0.5
    max_attempts: int = 3
    attempt_timeout_s: float | None = 10.0
    backoff_base_s: float = 0.02
    backoff_cap_s: float = 1.0
    jitter: float = 0.5
    hedge_slack_frac: float | None = None
    tenant_quotas: Mapping[str, int] | None = None
    seed: int = 0

    def __post_init__(self):
        if self.vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {self.vnodes}")
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.hedge_slack_frac is not None and not (
            0.0 < self.hedge_slack_frac < 1.0
        ):
            raise ValueError(
                f"hedge_slack_frac must be in (0, 1), got "
                f"{self.hedge_slack_frac}"
            )
        if self.tenant_quotas is not None and any(
            q < 1 for q in self.tenant_quotas.values()
        ):
            raise ValueError(
                f"tenant_quotas must be >= 1, got {self.tenant_quotas}"
            )


@dataclasses.dataclass
class _RouterRequest:
    grid: scenarios.ScenarioGrid
    future: Future
    key: str
    t_submit: float
    priority: int
    deadline: float | None              # absolute time.monotonic()
    tenant: str
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    attempts: int = 0
    hedged: bool = False
    tried: set = dataclasses.field(default_factory=set)
    inflight: dict = dataclasses.field(default_factory=dict)  # name -> Future


class ScenarioRouter:
    """Spread scenario-serving traffic over N replicas, fault-tolerantly.

    See the module docstring for semantics.  Construct with prebuilt
    replicas (anything satisfying `Replica`), or use `in_process` to
    build N `ScenarioServer`-backed replicas in one call.

    Lifecycle mirrors `ScenarioServer`: `start()` starts the replicas
    (where the transport supports it) and the heartbeat/timer threads;
    `stop(drain=)` stops routing and the replicas; context-manager use
    drains.  `submit` is thread-safe.
    """

    def __init__(
        self,
        replicas: Sequence[Replica],
        *,
        route: RouterConfig = RouterConfig(),
        tracker: launch_tracker.Tracker | None = None,
    ):
        if not replicas:
            raise ValueError("ScenarioRouter needs at least one replica")
        self.cfg = route
        self.tracker = (launch_tracker.StatsTracker()
                        if tracker is None else tracker)
        self._replicas: dict[str, Replica] = {r.name: r for r in replicas}
        if len(self._replicas) != len(replicas):
            raise ValueError(
                f"duplicate replica names: {[r.name for r in replicas]}"
            )
        self._ring = _HashRing(list(self._replicas), vnodes=route.vnodes)
        self._breakers = {
            name: CircuitBreaker(
                route.breaker_failures, route.breaker_cooldown_s,
                on_open=lambda n=name: self._on_breaker_open(n),
            )
            for name in self._replicas
        }
        # Deterministic jitter: numpy Generator, seeded.
        self._rng = np.random.default_rng(route.seed)
        self._rng_lock = threading.Lock()
        self._lifecycle = threading.Lock()
        self._stop_lock = threading.Lock()
        self._started = False
        self._stopped = False
        self._stop_complete = False
        self._timer: _TimerThread | None = None
        self._hb_exit = threading.Event()
        self._heartbeat: threading.Thread | None = None
        # Outstanding-request registry (drain + hard-stop sweep) and the
        # global per-tenant quota ledger.
        self._reg_lock = threading.Lock()
        self._outstanding: dict[int, _RouterRequest] = {}
        self._quota_used: dict[str, int] = {}
        self._draining: set[str] = set()
        self._drain_cv = threading.Condition(self._reg_lock)

    # -- construction helpers -----------------------------------------

    @staticmethod
    def in_process(
        init_fn: Callable,
        apply_fn: Callable,
        data,
        cfg: simulator.SimConfig,
        *,
        n_replicas: int = 2,
        serve: ServeConfig = ServeConfig(),
        route: RouterConfig = RouterConfig(),
        tracker: launch_tracker.Tracker | None = None,
        device: str | torch.device | None = None,
        devices=None,
    ) -> "ScenarioRouter | FollowerRouter":
        """A router over ``n_replicas`` in-process `ScenarioServer`s.

        Every replica gets its own server (own queue, own threads, own
        `ProgramCache`) bound to the same model/data/config — the
        in-process stand-in for N server processes.  ``device`` (default:
        the CUDA card) and ``devices`` are passed to every replica, so all
        of them run on that one device, or over the same ranks (module
        docstring): then the leader rank gets the router and every other
        rank a `FollowerRouter`.
        """
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        replicas = [
            InProcessReplica(
                f"replica{i}",
                serving.ScenarioServer(
                    init_fn, apply_fn, data, cfg, serve=serve,
                    device=device, devices=devices,
                ),
            )
            for i in range(n_replicas)
        ]
        if not replicas[0].server.is_leader:
            return FollowerRouter(replicas, route)
        return ScenarioRouter(replicas, route=route, tracker=tracker)

    @property
    def replicas(self) -> Mapping[str, Replica]:
        return dict(self._replicas)

    def breaker(self, name: str) -> CircuitBreaker:
        return self._breakers[name]

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "ScenarioRouter":
        if self._started:
            raise RuntimeError("router already started")
        self._started = True
        for r in self._replicas.values():
            r.start()
        self._timer = _TimerThread(
            on_error=lambda e: self.tracker.count("router/timer_errors")
        )
        self._heartbeat = threading.Thread(
            target=self._heartbeat_loop, name="scenario-router-heartbeat",
            daemon=True,
        )
        self._heartbeat.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        """Stop the router and its replicas.

        ``drain=True``: new submits are rejected, every outstanding
        request runs to termination (failover retries and hedges
        included — a request mid-failover completes on a survivor), then
        each replica is drain-stopped.  ``drain=False``: everything
        outstanding fails with `ServerStopped` now, in-flight replica
        futures are cancelled best-effort, replicas are hard-stopped.
        Idempotent; the stopped-check in `submit` shares ``_lifecycle``
        with the flag flip, so an accepted future always terminates.
        """
        with self._stop_lock:
            if self._stop_complete:
                return
            with self._lifecycle:
                already = self._stopped
                self._stopped = True
            if not self._started:
                self._stop_complete = True
                return
            if already:
                return
            if drain:
                with self._reg_lock:
                    pending = [r.future for r in self._outstanding.values()]
                # Bounded only by the per-request termination guarantee
                # (attempt timeouts x max_attempts, deadlines).
                wait(pending)
            else:
                with self._reg_lock:
                    reqs = list(self._outstanding.values())
                for req in reqs:
                    if _try_resolve(req.future,
                                    exc=ServerStopped("router stopped")):
                        self.tracker.count("router/stopped_requests")
                    with req.lock:
                        inflight = list(req.inflight.values())
                    for rf in inflight:
                        rf.cancel()
            for r in self._replicas.values():
                try:
                    r.stop(drain=drain)
                except Exception:
                    self.tracker.count("router/replica_stop_errors")
            self._hb_exit.set()
            if self._heartbeat is not None:
                self._heartbeat.join(timeout=5.0)
            if self._timer is not None:
                self._timer.close()
            self._stop_complete = True

    def __enter__(self) -> "ScenarioRouter":
        return self.start() if not self._started else self

    def __exit__(self, *exc) -> None:
        self.stop()

    def drain_replica(self, name: str, *, timeout: float | None = 30.0
                      ) -> None:
        """Planned failover: remove ``name`` from routing, wait out its
        in-flight attempts, then drain-stop it.

        New and retried requests immediately route around it (survivors
        take over its hash arcs); requests already submitted to it finish
        normally.  Raises KeyError for an unknown replica and
        TimeoutError if its in-flight attempts do not clear in
        ``timeout`` seconds (the replica is left out of routing either
        way).
        """
        replica = self._replicas[name]
        with self._reg_lock:
            self._draining.add(name)
        self.tracker.count("router/drains")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._drain_cv:
            while any(
                name in r.inflight for r in self._outstanding.values()
            ):
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"replica {name!r} still has in-flight requests "
                        f"after {timeout}s"
                    )
                self._drain_cv.wait(remaining)
        replica.stop(drain=True)

    # -- client API ---------------------------------------------------

    def warmup(self, grids: Sequence[scenarios.ScenarioGrid], *,
               fanout: int = 2) -> int:
        """Warm each grid's program family on its primary replica AND its
        first ``fanout - 1`` failover targets (so the replicas a dead
        primary's traffic lands on are warm too).  Returns total programs
        built.  Call before `start()` for in-process replicas (their
        program caches are not synchronized with their dispatch
        threads)."""
        return _warm(self._ring, self._replicas, grids, fanout)

    def submit(self, grid: scenarios.ScenarioGrid, *,
               priority: int = 0,
               deadline_s: float | None = None,
               tenant: str = DEFAULT_TENANT) -> Future:
        """Route one request; returns a Future[GridResult].

        The first attempt happens synchronously, so replica-side
        admission errors (`AdmissionError`, `InvalidRequest`) surface
        here like a direct `ScenarioServer.submit` — they are caller
        bugs, never retried.  Replica faults (stopped, timeout, dispatch
        errors) are retried per `RouterConfig`.  `QuotaExceeded` /
        `ServerStopped` are raised synchronously for a full tenant quota
        / a stopped router.
        """
        if deadline_s is not None and (
            not math.isfinite(deadline_s) or not deadline_s > 0
        ):
            # Same named error as ScenarioServer.submit — the router acts
            # on the deadline (timers, hedging) before any replica sees it.
            raise serving.InvalidRequest(
                f"deadline_s must be a positive finite number of seconds, "
                f"got {deadline_s!r}"
            )
        now = time.monotonic()
        cost = len(grid)
        with self._lifecycle:
            if not self._started or self._stopped:
                raise ServerStopped(
                    "router is not accepting requests (start() it / not "
                    "after stop())"
                )
            quota = (None if self.cfg.tenant_quotas is None
                     else self.cfg.tenant_quotas.get(tenant))
            with self._reg_lock:
                if quota is not None:
                    used = self._quota_used.get(tenant, 0)
                    if used + cost > quota:
                        self.tracker.count("router/quota_rejected")
                        raise QuotaExceeded(
                            f"tenant {tenant!r} has {used} scenarios "
                            f"outstanding; +{cost} exceeds its global "
                            f"quota of {quota}"
                        )
                    self._quota_used[tenant] = used + cost
                req = _RouterRequest(
                    grid=grid, future=Future(), key=grid_signature(grid),
                    t_submit=now, priority=priority,
                    deadline=(None if deadline_s is None
                              else now + deadline_s),
                    tenant=tenant,
                )
                self._outstanding[id(req)] = req
        req.future.add_done_callback(
            lambda _f, key=id(req), r=req: self._on_client_done(key, r)
        )
        self.tracker.count("router/requests")
        self.tracker.count("router/scenarios", cost)
        self.tracker.scoped(f"tenant/{tenant}").count("requests")
        try:
            self._attempt(req, deadline_s=deadline_s, sync=True)
        except BaseException:
            # Synchronous rejection (admission/validation): the future is
            # dead weight — resolve it so the registry/quota release runs.
            _try_resolve(req.future, exc=ServerStopped("never accepted"))
            raise
        if req.deadline is not None:
            self._timer.call_at(
                req.deadline, lambda: self._on_deadline(req)
            )
        if (self.cfg.hedge_slack_frac is not None
                and req.deadline is not None):
            hedge_at = req.deadline - self.cfg.hedge_slack_frac * (
                req.deadline - req.t_submit
            )
            self._timer.call_at(hedge_at, lambda: self._on_hedge(req))
        return req.future

    def serve(self, grids: Sequence[scenarios.ScenarioGrid]
              ) -> list[scenarios.GridResult]:
        """Submit all and wait, in order (synchronous convenience)."""
        futures = [self.submit(g) for g in grids]
        return [f.result() for f in futures]

    # -- internals ----------------------------------------------------

    def _on_breaker_open(self, name: str) -> None:
        self.tracker.count("router/breaker_opens")
        self.tracker.count(f"router/replica/{name}/breaker_opens")

    def _on_client_done(self, key: int, req: _RouterRequest) -> None:
        """Exactly-once cleanup for every terminal path: release the
        tenant quota, drop the registry entry, cancel sibling attempts,
        ack a client-side cancel."""
        with self._reg_lock:
            self._outstanding.pop(key, None)
            if self.cfg.tenant_quotas is not None and (
                self.cfg.tenant_quotas.get(req.tenant) is not None
            ):
                used = self._quota_used.get(req.tenant, 0)
                self._quota_used[req.tenant] = max(0, used - len(req.grid))
            self._drain_cv.notify_all()
        with req.lock:
            inflight = list(req.inflight.values())
        for rf in inflight:
            rf.cancel()                 # free replica capacity, best effort
        _ack_cancel(req.future)

    def _remaining_deadline_s(self, req: _RouterRequest,
                              now: float) -> float | None:
        if req.deadline is None:
            return None
        return max(1e-3, req.deadline - now)

    def _pick(self, req: _RouterRequest) -> str | None:
        """The best replica for this request now: ring order, breakers
        consulted, replicas already carrying an attempt for this request
        and draining replicas excluded; untried replicas preferred, but a
        recovered already-tried one beats nothing."""
        now = time.monotonic()
        with self._reg_lock:
            draining = set(self._draining)
        with req.lock:
            inflight = set(req.inflight)
            tried = set(req.tried)
        order = [n for n in self._ring.preference(req.key)
                 if n not in inflight and n not in draining]
        for name in order:
            if name not in tried and self._breakers[name].allow(now):
                return name
        for name in order:
            if name in tried and self._breakers[name].allow(now):
                return name
        return None

    def _attempt(self, req: _RouterRequest, *,
                 deadline_s: float | None = None,
                 sync: bool = False, hedge: bool = False) -> None:
        """Launch one attempt (the synchronous first, an async retry, or
        a hedge) on the best available replica and wire its outcome."""
        if req.future.done():
            return
        now = time.monotonic()
        if req.deadline is not None and now >= req.deadline:
            self._resolve_deadline(req)
            return
        name = self._pick(req)
        if name is None:
            # A failed pick still consumes an attempt: without this, a
            # deadline-less request could retry forever against a fleet
            # of open breakers, breaking the termination guarantee.
            with req.lock:
                req.attempts += 1
            self.tracker.count("router/no_healthy_replica")
            self._fail_or_retry(
                req,
                NoHealthyReplica(
                    f"no replica accepts traffic (breakers: "
                    f"{ {n: b.state for n, b in self._breakers.items()} })"
                ),
            )
            return
        with req.lock:
            req.attempts += 1
            req.tried.add(name)
        self.tracker.count("router/attempts")
        if hedge:
            self.tracker.count("router/hedges")
        try:
            rf = self._replicas[name].submit(
                req.grid, priority=req.priority,
                deadline_s=(deadline_s if sync
                            else self._remaining_deadline_s(req, now)),
                tenant=req.tenant,
            )
        except (scenarios.AdmissionError, serving.InvalidRequest):
            if sync:
                raise                   # caller bug: surface at submit()
            # A replica disagreed about validity mid-retry (should not
            # happen with homogeneous replicas): terminal, not retried.
            self.tracker.count("router/replica_errors")
            exc = ServerStopped("replica rejected request during failover")
            _try_resolve(req.future, exc=exc)
            return
        except Exception as e:
            # Transport/liveness fault (e.g. ServerStopped from a dead
            # replica): breaker signal + failover.
            self._breakers[name].record_failure(now)
            self.tracker.count("router/replica_errors")
            self._fail_or_retry(req, e, failed=name)
            return
        with req.lock:
            req.inflight[name] = rf
        if self.cfg.attempt_timeout_s is not None:
            self._timer.call_at(
                now + self.cfg.attempt_timeout_s,
                lambda: self._on_attempt_timeout(req, name, rf),
            )
        rf.add_done_callback(
            lambda f: self._on_replica_done(req, name, f)
        )

    def _on_replica_done(self, req: _RouterRequest, name: str,
                         rf: Future) -> None:
        with req.lock:
            if req.inflight.get(name) is rf:
                del req.inflight[name]
        with self._drain_cv:
            self._drain_cv.notify_all()
        if rf.cancelled():
            self.tracker.count("router/attempts_cancelled")
            if req.future.done() or getattr(rf, "_router_cancelled", False):
                return                  # our own cancel (timeout handler /
                                        # client-done sweep owns the retry)
            # Someone on the REPLICA side cancelled our attempt: a
            # replica fault like any other — fail over, or the request
            # would hang until its timeout/deadline.
            self._breakers[name].record_failure()
            self._fail_or_retry(
                req,
                ServerStopped(f"replica {name!r} cancelled the attempt"),
                failed=name,
            )
            return
        now = time.monotonic()
        exc = rf.exception()
        if exc is None:
            self._breakers[name].record_success()
            if _try_resolve(req.future, result=rf.result()):
                latency = now - req.t_submit
                self.tracker.observe("router/latency_s", latency)
                self.tracker.scoped(f"tenant/{req.tenant}").observe(
                    "latency_s", latency
                )
                self.tracker.count(f"router/replica/{name}/served")
            else:
                # Hedge loser / late success after a timeout retry / a
                # deadline that fired first: exactly-once delivery means
                # this result is discarded, never double-delivered.
                self.tracker.count("router/results_discarded")
        elif isinstance(exc, DeadlineExceeded):
            # The replica's reaper enforced the SLA — a verdict on the
            # REQUEST, not a fault of the replica.  Terminal.
            if _try_resolve(req.future, exc=exc):
                self.tracker.count("router/deadline_exceeded")
        else:
            self._breakers[name].record_failure(now)
            self.tracker.count("router/replica_errors")
            self._fail_or_retry(req, exc, failed=name)

    def _on_attempt_timeout(self, req: _RouterRequest, name: str,
                            rf: Future) -> None:
        if rf.done() or req.future.done():
            return
        self._breakers[name].record_failure()
        self.tracker.count("router/timeouts")
        rf._router_cancelled = True     # our cancel: the retry below owns
        rf.cancel()                     # recovery.  Cancelling drops it
        # from the replica's queue if not yet dispatched; a dispatched one
        # resolves late and loses the _try_resolve race.
        self._fail_or_retry(
            req,
            ReplicaTimeout(
                f"attempt on {name!r} exceeded "
                f"{self.cfg.attempt_timeout_s}s"
            ),
            failed=name,
        )

    def _fail_or_retry(self, req: _RouterRequest, exc: BaseException,
                       failed: str | None = None) -> None:
        """Retry with exponential backoff + jitter, or make ``exc`` the
        request's terminal outcome when attempts/deadline are spent."""
        if req.future.done():
            return
        now = time.monotonic()
        with req.lock:
            attempts = req.attempts
        if attempts >= self.cfg.max_attempts:
            if _try_resolve(req.future, exc=exc):
                self.tracker.count("router/failed_requests")
            return
        delay = min(self.cfg.backoff_cap_s,
                    self.cfg.backoff_base_s * (2 ** max(0, attempts - 1)))
        with self._rng_lock:
            delay *= 1.0 + self.cfg.jitter * float(self._rng.random())
        if req.deadline is not None:
            # Clip into the remaining budget; a budget already spent
            # makes the failure terminal now rather than racing the
            # deadline timer with a doomed retry.
            if now + delay >= req.deadline:
                delay = max(0.0, req.deadline - now - 1e-3)
                if delay <= 0:
                    if _try_resolve(req.future, exc=exc):
                        self.tracker.count("router/failed_requests")
                    return
        self.tracker.count("router/retries")
        if failed is not None:
            self.tracker.count(f"router/replica/{failed}/failovers")
        self._timer.call_at(now + delay, lambda: self._attempt(req))

    def _resolve_deadline(self, req: _RouterRequest) -> None:
        if _try_resolve(req.future, exc=DeadlineExceeded(
            f"deadline exceeded after "
            f"{time.monotonic() - req.t_submit:.3f}s at the router "
            f"(labels {req.grid.labels[:3]})"
        )):
            self.tracker.count("router/deadline_exceeded")
            self.tracker.scoped(f"tenant/{req.tenant}").count(
                "deadline_exceeded"
            )

    def _on_deadline(self, req: _RouterRequest) -> None:
        """Router-level deadline enforcement: fires even when the owning
        replica is stalled or dead (its own reaper may be gone with it)."""
        if req.future.done():
            return
        self._resolve_deadline(req)

    def _on_hedge(self, req: _RouterRequest) -> None:
        """Near-deadline hedge: if the request is still unresolved with
        an attempt in flight, race a second replica for it."""
        if req.future.done() or req.hedged:
            return
        req.hedged = True
        self._attempt(req, hedge=True)

    def _heartbeat_loop(self) -> None:
        while not self._hb_exit.wait(self.cfg.heartbeat_s):
            for name, replica in self._replicas.items():
                try:
                    ok = bool(replica.ping())
                except Exception:
                    ok = False
                self._breakers[name].on_ping(ok)
                self.tracker.gauge(
                    f"router/replica/{name}/healthy", float(ok)
                )
            self.tracker.gauge(
                "router/healthy_replicas",
                sum(1 for b in self._breakers.values()
                    if b.state != CircuitBreaker.OPEN),
            )
