"""Streaming scenario-serving engine: SLA-aware continuous batching.

Port of the reference package's `launch/serving.py`.  A
`ScenarioServer` accepts scenario-grid requests on a queue and returns
futures; behind the queue, a batcher thread coalesces compatible requests
into one grid (via `ScenarioGrid.concat`), and a dispatch thread runs the
coalesced batch through a warm `GridRunner`: the grid is split into groups
sharing every discrete id (`simulator.BATCH_IDS`), each group padded to a
declared bucket size, its program served from a bounded LRU cache.  The
two threads form a double-buffered pipeline: host-side admission +
coalescing + padding for batch k+1 overlaps device compute for batch k.

On the card each round of a dispatched group launches K1 (`ra_aggregate`)
once, from the dispatcher thread: `kernels.ops` builds the kernel once
whatever thread first needs it and counts launches under a lock.  Several
servers in one process (a router's in-process replicas) share the card's
default stream, so their kernels run one after another on it.

The server is:

  * **SLA-aware** — ``submit(grid, priority=, deadline_s=)``: the
    request queue is priority-ordered with a weighted-fair share across
    tenants; a positive-priority or near-deadline request never waits
    out the full ``max_delay_s`` coalescing window, and an expired
    request resolves its future with `DeadlineExceeded` instead of
    occupying device time (a dedicated reaper thread enforces deadlines
    even while the dispatcher is stalled inside a dispatch).
  * **Cancellable** — `Future.cancel()` before dispatch removes the
    request from its pending batch (the dispatcher re-slices the
    coalesced grid via `ScenarioGrid.take`); a cancel that loses the
    race just has its result discarded.
  * **Stoppable with defined semantics** — ``stop(drain=True)`` serves
    everything already accepted, ``stop(drain=False)`` fails every
    pending future with `ServerStopped`; closing the queue is atomic
    with rejecting new submits, so a submit racing a stop is either
    served (drain) or failed — never left forever-pending.
  * **Multi-tenant** — ``submit(..., tenant=)`` attributes requests,
    scenarios, and latency per tenant through `Tracker.scoped`, and
    ``ServeConfig.tenant_weights`` sets the fair-share weights.

    server = ScenarioServer(init, apply_fn, data, cfg,
                            serve=ServeConfig(max_batch=4))   # the card
    with server:
        server.warmup(pool_grid)           # build declared shapes
        fut = server.submit(request_grid, priority=1, deadline_s=2.0,
                            tenant="teamA")
        res = fut.result()

Correctness contract (the port's; the reference promises bit-identity to
a direct `run_grid`, which the port does not): a served request's rows are
the same bits as its rows of `GridRunner.run` of the same coalesced,
padded grid on the same device (fillers are dropped on unpad; each row
has its own generator).  Against `run_grid` of the request alone they
agree within float32 tolerance, not bit for bit: a row run in a group of
G and the same scenario run alone sum in another order (1e-5 in loss and
bias on the CPU, every accuracy equal; on the H100 within 1e-4 in loss
and one test sample in accuracy).

Request admission is validated synchronously in `submit`
(`GridRunner.validate`): a malformed request raises an actionable
`AdmissionError` naming its offending scenarios, and the warm server
keeps serving everyone else.  A dispatch that fails at runtime fails
only its own batch's futures and leaves the server serving; that covers
errors raised in Python.  A fault on the device (a CUDA error) is sticky:
it poisons the process's CUDA context for every thread, so no later
dispatch of this or any other server in the process can succeed.
Telemetry flows through the pluggable `launch.tracker` API — pure
host-side bookkeeping, no device syncs on the hot path; results come back
as numpy arrays, whose copy to the host is a dispatch's one device sync.

Serving over ranks.  ``devices=`` naming several ranks (what
`fl.scenarios.GridRunner` takes: a count, a list of ranks, or ``(spec,
model_shards)`` for the ``('grid', 'model')`` mesh) spreads every
dispatch over a mesh of `torch.distributed` ranks, one process each
(`launch.mesh.spawn`).  The reference drives its mesh from one
controller; here every rank of the default group constructs the server,
in the same order, since building its process groups is collective:

  * the mesh's first rank (grid row 0, model shard 0) is the **leader**:
    it alone runs the fair queue, the batcher, the dispatcher and the
    reaper, and takes `submit` / `serve`;
  * every other rank of the mesh is a **follower**: `start` runs one
    thread that carries out the leader's commands in the leader's order
    (run this grid at this ``pad_to``, stop), and `submit` raises
    `NotLeader`, naming the leader;
  * a rank outside the mesh builds the server with the others; its
    `start` / `stop` do nothing.

The fan-out sits inside the runner call the dispatcher makes: the
leader's runner (`_FanOutRunner`) sends each ``run`` to the followers as
one broadcast on the mesh's command group and then makes it, so every
rank runs its share of the same padded groups (`GridRunner.run` over the
mesh) and gets the whole result; a per-request retry fans out too.
`warmup` runs no collective: every rank calls it with the same grids, as
it constructs the server, and builds its own programs.  Each server takes
a private mesh (groups of its own, `launch.mesh.grid_mesh(private=True)`),
so a router's replicas over the same ranks dispatch side by side.  When
the dispatcher exits (its stop, either drain mode), it sends the stop: a
follower's `stop` returns once that arrives, after everything accepted
was served (``drain=True``) or after the dispatch in flight, if any,
finished its collectives (``drain=False``).  A rank whose share raises,
a model shard alone included, fails that dispatch on every rank with
`launch.mesh.RankFailed` (`launch.mesh.gather_or_raise`), so only that
batch's futures fail; a model group whose collective failed (a peer left
inside it, held until `launch.mesh.MODEL_GROUP_TIMEOUT`) breaks the mesh,
and the leader refuses every later dispatch with
`launch.mesh.MeshBroken`, fanning out nothing.  Served rows over ranks
are the bits of `GridRunner.run` of the dispatched grid over the same
mesh.

CLI demo (synthetic open-loop arrival process):

  PYTHONPATH=src python -m repro_torch.launch.serving --requests 16 --rate 50
  PYTHONPATH=src python -m repro_torch.launch.serving --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serving --device cpu --devices 2
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..data.synthetic import FederatedDataset
from ..fl import scenarios, simulator
from . import mesh as launch_mesh
from . import tracker as launch_tracker

# Queue sentinel: tells the batcher / dispatcher threads to exit.
_SHUTDOWN = object()

DEFAULT_TENANT = "default"


class DeadlineExceeded(TimeoutError):
    """A request's ``deadline_s`` elapsed before its result was ready.

    Set as the future's exception by the server's reaper thread; the
    request is dropped from any not-yet-running dispatch so it never
    occupies device time (DESIGN.md §12)."""


class ServerStopped(RuntimeError):
    """The server was stopped before this request could be served.

    Raised synchronously by `submit` on a stopped server, and set as the
    exception of every pending future on a hard stop
    (``stop(drain=False)``)."""


class InvalidRequest(ValueError):
    """A `submit` argument is malformed (non-positive or non-finite
    ``deadline_s``, NaN / non-integer ``priority``).

    Raised synchronously at submit time, so malformed scheduling inputs
    fail with a named error instead of producing undefined scheduler
    behavior (a NaN priority poisons every queue-ordering comparison; a
    zero deadline is expired before it is ever registered)."""


class NotLeader(RuntimeError):
    """`submit` / `serve` on a rank that is not its server's leader (a
    follower, or a rank outside the server's mesh): requests go to the
    leader rank, which the message names."""


class UnknownTenant(InvalidRequest):
    """The submitted ``tenant`` is not declared in
    ``ServeConfig.tenant_weights`` while the server runs with an explicit
    tenant roster.  Only raised when ``tenant_weights`` is set — a server
    without declared weights accepts any tenant name at weight 1.0.  The
    default tenant is always accepted."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-engine knobs (DESIGN.md §11–§12).

    ``max_batch`` caps how many scenarios one coalesced dispatch carries;
    ``batch_buckets`` declares the warm padded batch sizes (each
    dispatch group pads to the smallest bucket that fits, so the family of
    built programs and of shapes the card sees stays bounded); ``max_delay_s`` is how long the
    batcher waits for more requests after the first arrives (the classic
    throughput/latency knob of continuous batching — cut short for
    positive-priority and near-deadline requests, see
    `ScenarioServer.submit`); ``pipeline_depth`` is the number of coalesced
    batches in flight (2 = double buffering: batching/admission for batch
    k+1 overlaps compute for batch k); ``max_cached_programs`` bounds the
    runner's program LRU; ``strict_packet_check`` makes the
    PER-packet vs codec-segment mismatch an admission ERROR instead of a
    one-time warning; ``tenant_weights`` maps tenant name -> weighted-fair
    share.  Declaring weights makes the roster authoritative: a submit
    under a tenant name that is neither listed nor the default raises
    `UnknownTenant` instead of silently scheduling at an undeclared
    weight.  Without declared weights every tenant weighs 1.0.
    """

    max_batch: int = 8
    batch_buckets: tuple[int, ...] = (1, 2, 4, 8)
    max_delay_s: float = 0.002
    pipeline_depth: int = 2
    max_cached_programs: int | None = 16
    strict_packet_check: bool = True
    tenant_weights: Mapping[str, float] | None = None

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.pipeline_depth < 2:
            raise ValueError(
                f"pipeline_depth must be >= 2 (one batch computing + at "
                f"least one being prepared), got {self.pipeline_depth}"
            )
        if self.batch_buckets and max(self.batch_buckets) < self.max_batch:
            raise ValueError(
                f"largest batch bucket {max(self.batch_buckets)} is smaller "
                f"than max_batch={self.max_batch}: a full coalesced batch "
                "would never fit a warm shape"
            )
        if self.tenant_weights is not None and any(
            not (w > 0) or not math.isfinite(w)
            for w in self.tenant_weights.values()
        ):
            # NB: `not (w > 0)` (rather than `w <= 0`) also catches NaN —
            # a NaN weight would make every stride-scheduler comparison
            # undefined.
            raise ValueError(
                f"tenant_weights must be positive and finite, got "
                f"{self.tenant_weights}"
            )


@dataclasses.dataclass
class _Request:
    grid: scenarios.ScenarioGrid
    future: Future
    t_submit: float
    priority: int = 0
    deadline: float | None = None       # absolute time.monotonic()
    tenant: str = DEFAULT_TENANT

    @property
    def cost(self) -> int:
        return len(self.grid)


@dataclasses.dataclass
class _Dispatch:
    """One prepared dispatch: a coalesced grid plus the per-request row
    slices needed to split the stacked result back out."""

    grid: scenarios.ScenarioGrid
    requests: list[_Request]
    slices: list[tuple[int, int]]


def _try_resolve(fut: Future, *, result=None, exc: BaseException | None = None
                 ) -> bool:
    """Resolve a future, losing gracefully: a future already resolved by a
    racing path (cancel, deadline reaper, hard stop) is left untouched.

    This is the whole cancellation/deadline state machine (DESIGN.md §12):
    every path that finishes a request — dispatcher result, dispatcher
    error, reaper deadline, hard-stop sweep, client `Future.cancel()` —
    races to resolve the future exactly once; losers return False and the
    caller discards its outcome.
    """
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
        return True
    except InvalidStateError:
        _ack_cancel(fut)
        return False


def _ack_cancel(fut: Future) -> None:
    """Complete the Future cancellation protocol on the server side.

    A bare `Future` cancelled by its caller sits in CANCELLED until an
    executor acknowledges via `set_running_or_notify_cancel()`, which
    flips it to CANCELLED_AND_NOTIFIED — the state `concurrent.futures.
    wait()` / `as_completed()` treat as done.  The server is that
    executor: every path that observes (and drops) a cancelled request
    acknowledges it here, so a cancelled future is always wait()-able.
    """
    if fut.cancelled():
        try:
            fut.set_running_or_notify_cancel()
        except RuntimeError:
            pass                        # a racing path already acknowledged


class _FairQueue:
    """Priority + weighted-fair request queue (condition-protected).

    Requests live in per-(tenant, priority-class) FIFO deques.  `pop`
    picks among the class heads by (priority DESC, tenant virtual time
    ASC, submit time ASC): strict priority wins first — across tenants
    AND within one (a hot request is never stuck behind its own tenant's
    best-effort backlog); within a priority level, tenants share dispatch
    slots in proportion to their weights via stride scheduling (a
    tenant's virtual time advances by scenarios/weight per pop, and an
    idle tenant re-joins at the active minimum so it cannot bank credit
    while away).  FIFO order within a (tenant, priority) class is
    preserved.

    `close(drain=True)` lets `pop` hand out everything already queued and
    then return the shutdown sentinel; `close(drain=False)` clears the
    queue and returns the dropped requests to the caller (hard stop).
    """

    def __init__(self, weights: Mapping[str, float] | None = None):
        self._cv = threading.Condition()
        # Keyed per (tenant, priority class): priority reorders WITHIN a
        # tenant too — a hot request is never stuck behind its own
        # tenant's best-effort backlog.  FIFO holds within each class.
        self._deques: dict[tuple[str, int], deque[_Request]] = {}
        self._vtime: dict[str, float] = {}
        self._weights = dict(weights or {})
        self._closed = False

    @property
    def depth(self) -> int:
        with self._cv:
            return sum(len(d) for d in self._deques.values())

    def put(self, req: _Request) -> None:
        with self._cv:
            if self._closed:
                raise ServerStopped("request queue is closed")
            if not any(d for (t, _), d in self._deques.items()
                       if t == req.tenant):
                # (Re-)joining tenant starts at the busy minimum: no
                # credit accumulates while idle.
                floor = min(
                    (self._vtime.get(t, 0.0)
                     for (t, _), d in self._deques.items()
                     if d and t != req.tenant),
                    default=0.0,
                )
                self._vtime[req.tenant] = max(
                    self._vtime.get(req.tenant, 0.0), floor
                )
            key = (req.tenant, req.priority)
            dq = self._deques.get(key)
            if dq is None:
                dq = self._deques[key] = deque()
            dq.append(req)
            self._cv.notify()

    def _pop_locked(self) -> _Request | None:
        best_key, best_class = None, None
        for (tenant, prio), dq in self._deques.items():
            if not dq:
                continue
            head = dq[0]
            key = (-prio, self._vtime.get(tenant, 0.0), head.t_submit)
            if best_key is None or key < best_key:
                best_key, best_class = key, (tenant, prio)
        if best_class is None:
            return None
        req = self._deques[best_class].popleft()
        tenant = best_class[0]
        w = self._weights.get(tenant, 1.0)
        self._vtime[tenant] = (
            self._vtime.get(tenant, 0.0) + req.cost / w
        )
        return req

    def pop(self, timeout: float | None = None):
        """The next request, ``None`` on timeout, or the shutdown sentinel
        once closed and drained."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                req = self._pop_locked()
                if req is not None:
                    return req
                if self._closed:
                    return _SHUTDOWN
                if deadline is None:
                    self._cv.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cv.wait(remaining)

    def close(self, *, drain: bool) -> list[_Request]:
        with self._cv:
            self._closed = True
            dropped: list[_Request] = []
            if not drain:
                for dq in self._deques.values():
                    dropped.extend(dq)
                    dq.clear()
            self._cv.notify_all()
            return dropped


def _slice_result(res: scenarios.GridResult, a: int, b: int,
                  labels: list[str]) -> scenarios.GridResult:
    """Rows [a, b) of a stacked result, relabeled with the REQUEST's own
    labels (coalescing may have disambiguated collisions across requests;
    each caller gets its grid's labels back untouched)."""
    return scenarios.GridResult(
        acc=res.acc[a:b],
        loss=res.loss[a:b],
        bias=res.bias[a:b],
        labels=list(labels),
        selected=None if res.selected is None else res.selected[a:b],
    )


class _FanOutRunner(scenarios.GridRunner):
    """The leader's runner over ranks: `run` first sends the same call to
    the server's followers, then makes it here; `release` sends the stop,
    once.  After the release, or the server's hard stop, a run raises
    `ServerStopped` instead of fanning out."""

    def __init__(self, *args, aborted: Callable[[], bool], **kwargs):
        super().__init__(*args, **kwargs)
        self._aborted = aborted
        self._lock = threading.Lock()
        self._released = False

    def release(self) -> None:
        """Send the followers the stop (once)."""
        with self._lock:
            if self._released:
                return
            self._released = True
            launch_mesh.broadcast_command(self.sharding, ("stop",))

    def run(self, grid: scenarios.ScenarioGrid, *, pad_to=None,
            validate: bool = True) -> scenarios.GridResult:
        with self._lock:
            if self._aborted():
                raise ServerStopped("server stopped")
            if self._released:
                raise ServerStopped("the server's followers were released")
            self.sharding.check()     # a broken model group: refuse
            launch_mesh.broadcast_command(
                self.sharding, ("run", grid, pad_to, validate))
        return super().run(grid, pad_to=pad_to, validate=validate)


class ScenarioServer:
    """Continuously batching scenario-serving engine over a warm GridRunner.

    Args:
      init_fn / apply_fn / data / cfg: the `GridRunner` binding (model,
        dataset, static simulation knobs).  ``cfg`` is validated eagerly —
        e.g. an ``eval_every`` that does not divide ``n_rounds`` fails
        HERE, at construction, not inside a warm dispatch
        (`simulator.validate_eval_schedule`).
      serve: `ServeConfig` engine knobs.
      tracker: metrics sink; defaults to a fresh `StatsTracker` exposed as
        ``self.tracker`` (pass `NullTracker()` to disable).
      device: where every dispatch runs (default: the CUDA card, or over
        ranks the device `launch.mesh.spawn` gave this rank; raises
        without one).  Pass ``"cpu"`` for the plain path.
      devices: None or one device, or the ranks to serve over (module
        docstring; every rank of the default group constructs the server,
        in the same order).  Without a process group several ranks raise
        the mesh's ValueError, as `fl.scenarios.run_grid` does.

    Lifecycle: `start()` spawns the batcher + dispatcher + deadline-reaper
    threads; `stop(drain=True)` serves everything already accepted and
    joins them, `stop(drain=False)` fails pending futures with
    `ServerStopped` (also available as a context manager, which drains).
    `submit` is thread-safe and non-blocking apart from admission
    validation.  Over ranks, ``role`` is ``"leader"``, ``"follower"`` or
    ``"outside"`` (``"single"`` on one device), and a follower's
    ``released_at`` is the `time.time` its loop received the stop.
    """

    def __init__(
        self,
        init_fn: Callable,
        apply_fn: Callable,
        data: FederatedDataset,
        cfg: simulator.SimConfig,
        *,
        serve: ServeConfig = ServeConfig(),
        tracker: launch_tracker.Tracker | None = None,
        device: str | torch.device | None = None,
        devices=None,
    ):
        self.cfg = serve
        self.tracker = (launch_tracker.StatsTracker()
                        if tracker is None else tracker)
        self.mesh = None
        place = dict(device=device, devices=devices)
        self.role = "single"
        if not scenarios.names_one_device(devices):
            dev = resolve_device(device if device is not None
                                 else launch_mesh.rank_device())
            self.mesh = scenarios._resolve_grid_mesh(devices, None, dev,
                                                     private=True)
            place = dict(device=dev, sharding=self.mesh)
            self.role = ("outside" if self.mesh.coords is None else
                         "leader" if self.mesh.rank == self.mesh.leader
                         else "follower")
        if self.role == "leader":
            place["aborted"] = lambda: self._abort
        # Fail actionably NOW on static-config errors (eval_every etc.) —
        # GridRunner construction builds the sim and validates them.
        self.runner = (_FanOutRunner if self.role == "leader"
                       else scenarios.GridRunner)(
            init_fn, apply_fn, data, cfg,
            tracker=self.tracker,
            max_cached_programs=serve.max_cached_programs,
            **place,
        )
        self._follower: threading.Thread | None = None
        self.released_at: float | None = None
        self._pending = _FairQueue(serve.tenant_weights)
        # The double buffer: at most pipeline_depth batches in flight
        # (pipeline_depth - 1 queue slots + the one the dispatcher is
        # executing); a full queue backpressures the BATCHER, never
        # `submit` (the request queue is unbounded — open-loop admission).
        self._dispatches: queue.Queue = queue.Queue(
            maxsize=serve.pipeline_depth - 1
        )
        self._batcher: threading.Thread | None = None
        self._dispatcher: threading.Thread | None = None
        self._reaper: threading.Thread | None = None
        # _lifecycle makes "accept a request" atomic with "close the
        # queue": submit holds it from the stopped-check through the
        # enqueue, stop holds it to flip _stopped — so an accepted request
        # is always visible to the drain/abort path (never forever-pending).
        self._lifecycle = threading.Lock()
        self._stop_lock = threading.Lock()
        self._started = False
        self._stopped = False
        self._stop_complete = False
        self._abort = False             # hard stop: fail instead of serve
        # Live-request registry: every accepted, unresolved request.  The
        # reaper thread sleeps until the earliest registered deadline; the
        # hard-stop sweep fails everything registered.
        self._live_cv = threading.Condition()
        self._live_reqs: dict[int, _Request] = {}
        self._reap_exit = False

    # -- lifecycle ----------------------------------------------------

    @property
    def is_leader(self) -> bool:
        """Whether this rank takes the server's requests (always, on one
        device)."""
        return self.role in ("single", "leader")

    def start(self) -> "ScenarioServer":
        if self._started:
            raise RuntimeError("server already started")
        self._started = True
        if self.role == "follower":
            self._follower = threading.Thread(
                target=self._follow, name="scenario-server-follower",
                daemon=True,
            )
            self._follower.start()
        if not self.is_leader:
            return self
        self._batcher = threading.Thread(
            target=self._batch_loop, name="scenario-server-batcher",
            daemon=True,
        )
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="scenario-server-dispatcher",
            daemon=True,
        )
        self._reaper = threading.Thread(
            target=self._reap_loop, name="scenario-server-reaper",
            daemon=True,
        )
        self._batcher.start()
        self._dispatcher.start()
        self._reaper.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        """Stop the server.

        ``drain=True`` (default, and the context-manager exit): every
        request accepted before the stop completes normally — queued
        requests are batched and dispatched, in-flight dispatches finish,
        futures resolve with results — then the worker threads join.

        ``drain=False`` (hard stop): every pending future — queued,
        coalesced, or in-flight — fails with `ServerStopped` immediately,
        so no caller blocks on an abandoned request.  A dispatch
        already executing cannot be interrupted; its result is discarded
        when it returns, and `stop` joins the workers with a bounded
        timeout rather than waiting it out (the threads are daemons and
        exit as soon as the dispatch returns).

        Closing the queue is atomic with rejecting new submits (the
        shared ``_lifecycle`` lock): a `submit` racing this call either
        completed its enqueue — and is drained or failed like any other
        pending request — or observes the stopped flag and raises
        `ServerStopped`.  Calling `stop` again is a no-op.

        Over ranks the leader's stop decides (``drain`` is the leader's);
        a follower's returns once the leader's stop has reached it (a
        follower never started carries out the leader's commands here
        until then), and a rank outside the mesh returns at once.
        """
        with self._stop_lock:           # serialize concurrent stops
            if self._stop_complete:
                return
            with self._lifecycle:
                already = self._stopped
                self._stopped = True
            if self.role == "follower":
                if self._follower is None:
                    self._follow()
                else:
                    self._follower.join()
            if not self.is_leader:
                self._stop_complete = True
                return
            if not self._started:
                self._release_followers()
                self._stop_complete = True
                return
            if already:
                return
            if not drain:
                self._abort = True
            dropped = self._pending.close(drain=drain)
            for r in dropped:
                if _try_resolve(r.future,
                                exc=ServerStopped("server stopped")):
                    self.tracker.count("serve/stopped_requests")
            if not drain:
                # Fail EVERYTHING still pending (coalesced batches, the
                # in-flight dispatch): callers unblock now; late results
                # lose the _try_resolve race and are discarded.
                with self._live_cv:
                    live = list(self._live_reqs.values())
                for r in live:
                    if _try_resolve(r.future,
                                    exc=ServerStopped("server stopped")):
                        self.tracker.count("serve/stopped_requests")
            join_timeout = None if drain else 5.0
            self._batcher.join(join_timeout)
            self._dispatcher.join(join_timeout)
            with self._live_cv:
                self._reap_exit = True
                self._live_cv.notify_all()
            self._reaper.join(join_timeout)
            self._stop_complete = True

    def __enter__(self) -> "ScenarioServer":
        return self.start() if not self._started else self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API ---------------------------------------------------

    def healthy(self) -> bool:
        """Liveness probe for a fronting router (DESIGN.md §14): True iff
        the server is accepting traffic and its worker threads (batcher,
        dispatcher, reaper) are alive.  Pure host-side checks — safe to
        call from a heartbeat loop at high frequency."""
        return bool(
            self._started and not self._stopped
            and self._batcher is not None and self._batcher.is_alive()
            and self._dispatcher is not None and self._dispatcher.is_alive()
            and self._reaper is not None and self._reaper.is_alive()
        )

    def warmup(self, *grids: scenarios.ScenarioGrid) -> int:
        """Build the programs the declared grids would dispatch (their
        groups at their padded bucket sizes; on the card this builds K1)
        before opening for traffic.  Returns the number of programs built.

        Warm the shapes you expect to DISPATCH: for a coalescing server
        that is representative coalesced batches
        (``ScenarioGrid.concat(*request_mix)``), not individual requests —
        a coalesced batch maps fields (protocol, topology) that a
        single-request grid hoists, which is a different program.  Call
        before `start()` (the program cache is not synchronized with the
        dispatch thread).  Over ranks every rank calls it with the same
        grids and builds its own programs (none outside the mesh)."""
        if self._started:
            raise RuntimeError("warmup() must run before start()")
        return sum(
            self.runner.warmup(g, pad_to=self.cfg.batch_buckets)
            for g in grids
        )

    def submit(self, grid: scenarios.ScenarioGrid, *,
               priority: int = 0,
               deadline_s: float | None = None,
               tenant: str = DEFAULT_TENANT) -> Future:
        """Enqueue one scenario-grid request; returns a Future[GridResult].

        Args:
          priority: scheduling class.  0 (default) is best-effort;
            any positive priority is served before lower classes AND
            skips the coalescing delay window — its batch dispatches as
            soon as it is popped (whatever coalesced alongside rides
            along).
          deadline_s: SLA, in seconds from now.  A request still
            unresolved when the deadline passes fails with
            `DeadlineExceeded` and is dropped from any not-yet-running
            dispatch; a near-deadline request also shrinks the coalescing
            window so it is never held for longer than half its
            remaining slack.
          tenant: request-stream name for weighted-fair scheduling
            (`ServeConfig.tenant_weights`) and per-tenant telemetry
            (``tenant/<name>/...`` via `Tracker.scoped`).

        Admission validation happens HERE, synchronously: a malformed
        request raises `scenarios.AdmissionError` (naming its offending
        scenarios) without ever touching the serving threads — one bad
        request cannot kill a warm server.  Malformed scheduling inputs
        (non-positive/non-finite deadline, NaN priority, a tenant outside
        a declared roster) raise `InvalidRequest` / `UnknownTenant`
        instead of producing undefined scheduler behavior.  A stopped (or
        never-started) server raises `ServerStopped`; the stopped-check
        is atomic with the enqueue, so an accepted future ALWAYS
        terminates.  On a rank that is not the leader it raises
        `NotLeader`.
        """
        if not self.is_leader:
            raise NotLeader(
                f"rank {self.mesh.rank} does not take requests: submit to "
                f"rank {self.mesh.leader}, the leader of this server's "
                f"mesh {self.mesh.ranks.tolist()}")
        if len(grid) == 0:
            raise scenarios.AdmissionError("grid rejected: empty request")
        self.runner.validate(
            grid, strict_packet=self.cfg.strict_packet_check
        )
        if deadline_s is not None and (
            not math.isfinite(deadline_s) or not deadline_s > 0
        ):
            raise InvalidRequest(
                f"deadline_s must be a positive finite number of seconds, "
                f"got {deadline_s!r} (a non-positive deadline is expired "
                f"before it can be registered)"
            )
        try:
            prio = float(priority)
        except (TypeError, ValueError):
            raise InvalidRequest(
                f"priority must be an integer, got {priority!r}"
            ) from None
        if not math.isfinite(prio) or prio != int(prio):
            raise InvalidRequest(
                f"priority must be a finite integer, got {priority!r} "
                f"(a NaN priority poisons every queue-ordering comparison)"
            )
        priority = int(prio)
        if (self.cfg.tenant_weights is not None
                and tenant != DEFAULT_TENANT
                and tenant not in self.cfg.tenant_weights):
            raise UnknownTenant(
                f"tenant {tenant!r} is not declared in "
                f"ServeConfig.tenant_weights "
                f"{sorted(self.cfg.tenant_weights)} — declare its "
                f"fair-share weight or submit under the default tenant"
            )
        now = time.monotonic()
        req = _Request(
            grid=grid, future=Future(), t_submit=now, priority=priority,
            deadline=None if deadline_s is None else now + deadline_s,
            tenant=tenant,
        )
        with self._lifecycle:
            if not self._started or self._stopped:
                raise ServerStopped(
                    "server is not accepting requests (start() it / not "
                    "after stop())"
                )
            self._register(req)
            self._pending.put(req)
        self.tracker.count("serve/requests")
        self.tracker.count("serve/scenarios", len(grid))
        self.tracker.gauge("serve/queue_depth", self._pending.depth)
        scoped = self.tracker.scoped(f"tenant/{tenant}")
        scoped.count("requests")
        scoped.count("scenarios", len(grid))
        return req.future

    def serve(self, grids: Sequence[scenarios.ScenarioGrid]
              ) -> list[scenarios.GridResult]:
        """Submit a sequence of requests and wait for all results (in
        submission order) — the synchronous convenience wrapper."""
        futures = [self.submit(g) for g in grids]
        return [f.result() for f in futures]

    # -- live-request registry + deadline reaper ----------------------

    def _register(self, req: _Request) -> None:
        with self._live_cv:
            self._live_reqs[id(req)] = req
            if req.deadline is not None:
                self._live_cv.notify_all()      # reaper re-plans its sleep
        # Any resolution path (result, error, cancel, deadline, stop)
        # unregisters exactly once, via the future's done callback.
        req.future.add_done_callback(
            lambda _f, key=id(req): self._unregister(key)
        )

    def _unregister(self, key: int) -> None:
        with self._live_cv:
            self._live_reqs.pop(key, None)

    def _reap_loop(self) -> None:
        """Fail futures whose deadline passed — independently of the
        batcher/dispatcher, so a stalled dispatch cannot postpone an SLA
        (the expired request's rows are later dropped by the dispatcher's
        re-slice, or the whole finished result is discarded)."""
        while True:
            with self._live_cv:
                if self._reap_exit:
                    return
                now = time.monotonic()
                expired = [r for r in self._live_reqs.values()
                           if r.deadline is not None and r.deadline <= now]
                if not expired:
                    nxt = min(
                        (r.deadline for r in self._live_reqs.values()
                         if r.deadline is not None),
                        default=None,
                    )
                    self._live_cv.wait(
                        None if nxt is None else max(nxt - now, 0.0)
                    )
                    continue
            for r in expired:           # resolve OUTSIDE the registry lock
                if _try_resolve(r.future, exc=DeadlineExceeded(
                    f"deadline exceeded after "
                    f"{time.monotonic() - r.t_submit:.3f}s "
                    f"(labels {r.grid.labels[:3]})"
                )):
                    self.tracker.count("serve/deadline_exceeded")
                    self.tracker.scoped(f"tenant/{r.tenant}").count(
                        "deadline_exceeded"
                    )

    # -- batcher thread: queue -> coalesce ----------------------------

    def _window_s(self, req: _Request) -> float:
        """How long this request is willing to wait for co-batching:
        ``max_delay_s``, cut to zero for positive priority and to half
        the remaining slack for near-deadline requests."""
        if req.priority > 0:
            return 0.0
        w = self.cfg.max_delay_s
        if req.deadline is not None:
            w = min(w, max(0.0, 0.5 * (req.deadline - time.monotonic())))
        return w

    def _batch_loop(self) -> None:
        carry: _Request | None = None
        while True:
            req = carry if carry is not None else self._pending.pop()
            carry = None
            if req is _SHUTDOWN:
                self._put_dispatch(_SHUTDOWN)
                return
            if req.future.done():       # cancelled / expired while queued
                _ack_cancel(req.future)
                self.tracker.count("serve/dropped_before_batch")
                continue
            batch = [req]
            n = req.cost
            shutdown_after = False
            deadline = time.monotonic() + self._window_s(req)
            while n < self.cfg.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                nxt = self._pending.pop(timeout=timeout)
                if nxt is None:
                    break
                if nxt is _SHUTDOWN:
                    shutdown_after = True
                    break
                if nxt.future.done():
                    _ack_cancel(nxt.future)
                    self.tracker.count("serve/dropped_before_batch")
                    continue
                if n + nxt.cost > self.cfg.max_batch:
                    carry = nxt        # opens the NEXT batch
                    break
                batch.append(nxt)
                n += nxt.cost
                # An urgent/near-deadline arrival shrinks the window for
                # the whole batch (it ships when they ship).
                deadline = min(
                    deadline, time.monotonic() + self._window_s(nxt)
                )
            self._enqueue_dispatches(batch)
            if shutdown_after:
                self._put_dispatch(_SHUTDOWN)
                return

    def _put_dispatch(self, item) -> None:
        """Blocking put with abort awareness: a hard stop unwedges a
        batcher backpressured by a stalled dispatcher."""
        while True:
            if self._abort and item is not _SHUTDOWN:
                # Pending futures were failed by stop()'s live sweep;
                # already-cancelled ones left the live registry at cancel
                # time, so acknowledge them here before discarding.
                for r in item.requests:
                    _ack_cancel(r.future)
                return
            try:
                self._dispatches.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def _enqueue_dispatches(self, batch: list[_Request]) -> None:
        """Coalesce a batch of requests into one grid (slices remembered
        per request) and hand it to the dispatch thread.

        `ScenarioGrid.concat` re-pads node counts and time axes, fills
        missing participation/policy fields neutrally, and disambiguates
        colliding labels — so heterogeneous requests still share one
        dispatch.  Requests concat CANNOT merge (e.g. with/without
        per-client local_epochs, or incommensurable schedule lengths)
        fall back to one dispatch each, counted as
        ``serve/coalesce_fallback``.
        """
        if len(batch) == 1:
            grids = [batch[0].grid]
            groups = [batch]
        else:
            try:
                grids = [scenarios.ScenarioGrid.concat(
                    *(r.grid for r in batch))]
                groups = [batch]
            except ValueError:
                self.tracker.count("serve/coalesce_fallback")
                grids = [r.grid for r in batch]
                groups = [[r] for r in batch]
        for grid, reqs in zip(grids, groups):
            slices, start = [], 0
            for r in reqs:
                slices.append((start, start + len(r.grid)))
                start += len(r.grid)
            self.tracker.count("serve/dispatches")
            self.tracker.observe("serve/coalesced_scenarios", len(grid))
            self._put_dispatch(_Dispatch(grid, list(reqs), slices))

    # -- dispatch thread: re-slice -> pad -> dispatch -> unpad --------

    def _release_followers(self) -> None:
        """Over ranks: send the followers the stop (once)."""
        if self.role != "leader":
            return
        try:
            self.runner.release()
        except Exception:            # a follower or the group is gone
            self.tracker.count("serve/fanout_errors")

    # Grad mode is per thread and on in a new one: the dispatches build no
    # autograd graph, as they would not on the main thread.
    @torch.no_grad()
    def _follow(self) -> None:
        """A follower's loop: the leader's commands, in its order, until
        its stop (or until the command group fails: the leader is gone)."""
        while True:
            try:
                command = launch_mesh.broadcast_command(self.mesh)
            except Exception:
                self.tracker.count("serve/leader_lost")
                return
            if command[0] == "stop":
                self.released_at = time.time()
                return
            _, grid, pad_to, validate = command
            try:
                self.runner.run(grid, pad_to=pad_to, validate=validate)
            except Exception:        # every rank of the mesh raised it
                self.tracker.count("serve/dispatch_errors")

    @torch.no_grad()
    def _dispatch_loop(self) -> None:
        try:
            self._dispatch_until_shutdown()
        finally:
            self._release_followers()

    def _dispatch_until_shutdown(self) -> None:
        while True:
            d = self._dispatches.get()
            if d is _SHUTDOWN:
                return
            # Drop requests resolved since coalescing (cancelled, expired,
            # failed by a hard stop): re-slice the coalesced grid to the
            # surviving rows so dead requests never occupy device time.
            live = [(r, s) for r, s in zip(d.requests, d.slices)
                    if not r.future.done()]
            dropped = len(d.requests) - len(live)
            if dropped:
                for r, _ in zip(d.requests, d.slices):
                    if r.future.done():
                        _ack_cancel(r.future)
                self.tracker.count("serve/dropped_before_dispatch", dropped)
            if not live:
                continue
            if self._abort:
                for r, _ in live:
                    _try_resolve(r.future,
                                 exc=ServerStopped("server stopped"))
                continue
            if dropped:
                rows = np.concatenate(
                    [np.arange(a, b) for _, (a, b) in live]
                )
                grid = d.grid.take(rows)
                slices, start = [], 0
                reqs = []
                for r, (a, b) in live:
                    reqs.append(r)
                    slices.append((start, start + (b - a)))
                    start += b - a
            else:
                grid, reqs, slices = d.grid, d.requests, d.slices
            t0 = time.monotonic()
            try:
                # Admission already validated per request; grouping +
                # bucket padding + program-cache lookup happen inside the
                # warm runner.  Its copy of the result to host numpy is
                # the device sync (result materialization, not telemetry).
                res = self.runner.run(
                    grid, pad_to=self.cfg.batch_buckets, validate=False,
                )
            except Exception as e:   # keep serving: fail THIS batch only
                self.tracker.count("serve/dispatch_errors")
                self._retry_individually(reqs, e)
                continue
            now = time.monotonic()
            self.tracker.observe("serve/dispatch_s", now - t0)
            for r, (a, b) in zip(reqs, slices):
                delivered = _try_resolve(
                    r.future,
                    result=_slice_result(res, a, b, r.grid.labels),
                )
                if delivered:
                    self.tracker.observe("serve/latency_s", now - r.t_submit)
                    self.tracker.scoped(f"tenant/{r.tenant}").observe(
                        "latency_s", now - r.t_submit
                    )
                else:
                    # Lost the race to a cancel / deadline / hard stop
                    # that fired mid-dispatch: result discarded.
                    self.tracker.count("serve/results_discarded")

    def _retry_individually(self, reqs: list[_Request],
                            exc: BaseException) -> None:
        """A coalesced dispatch raised: shrink the blast radius.

        One poisoned request must not fail innocent neighbors that only
        shared its batch, so each surviving request is re-dispatched
        ALONE, with one bounded retry (``serve/dispatch_retries``): the
        poisoned one fails with its own error, the rest get their
        results.  A single-request dispatch has no neighbors to protect —
        it just fails with the error (no retry: re-running the same
        poison alone would double device time for the same outcome).
        """
        if len(reqs) == 1:
            _try_resolve(reqs[0].future, exc=exc)
            return
        for r in reqs:
            if r.future.done():         # cancelled/expired mid-failure
                _ack_cancel(r.future)
                continue
            if self._abort:
                _try_resolve(r.future, exc=ServerStopped("server stopped"))
                continue
            self.tracker.count("serve/dispatch_retries")
            t0 = time.monotonic()
            try:
                res = self.runner.run(
                    r.grid, pad_to=self.cfg.batch_buckets, validate=False,
                )
            except Exception as e2:
                _try_resolve(r.future, exc=e2)
                continue
            now = time.monotonic()
            self.tracker.observe("serve/dispatch_s", now - t0)
            if _try_resolve(
                r.future,
                result=_slice_result(res, 0, len(r.grid), r.grid.labels),
            ):
                self.tracker.observe("serve/latency_s", now - r.t_submit)
                self.tracker.scoped(f"tenant/{r.tenant}").observe(
                    "latency_s", now - r.t_submit
                )
            else:
                self.tracker.count("serve/results_discarded")


# ---------------------------------------------------------------------
# CLI demo: a tiny standalone server fed by a synthetic open-loop
# arrival process.
# ---------------------------------------------------------------------

def _demo_setup(n_clients: int, samples: int, seed: int):
    from ..core import topology
    from ..data import synthetic
    from ..models import smallnets

    data = synthetic.fed_image_classification(
        n_clients=n_clients, samples_per_client=samples, seed=seed
    )
    coords = topology.TABLE_II_COORDS[:n_clients]
    nets = [
        # packet_len_bits matches the demo cfg's 64-float32 segments, so
        # the channel is self-consistent and strict admission passes.
        (f"net{i}", topology.make_network(
            coords, edge_density=d, n_clients=n_clients, tx_power_dbm=17.0,
            packet_len_bits=32 * 64,
        ))
        for i, d in enumerate((0.4, 0.6, 0.8))
    ]
    init = lambda g: smallnets.init_mlp_clf(g, d_in=32, d_hidden=16)  # noqa: E731
    return data, nets, init, smallnets.apply_mlp_clf


def _demo(args: argparse.Namespace, devices, say: Callable[[str], None]
          ) -> None:
    """The demo on one device (``devices`` None) or on this rank of a
    spawned mesh; the leader reports through ``say``."""
    data, nets, init, apply_fn = _demo_setup(args.clients, 20, args.seed)
    cfg = simulator.SimConfig(n_rounds=args.rounds, local_epochs=2,
                              seg_len=64)
    pool = [
        scenarios.ScenarioGrid.product(
            networks=[(lbl, net)], protocols=[(proto, "ra_normalized")],
            seeds=[args.seed],
        )
        for lbl, net in nets
        for proto in ("ra", "aayg")
    ]
    server = ScenarioServer(
        init, apply_fn, data, cfg,
        serve=ServeConfig(max_batch=args.max_batch),
        device=args.device,
        devices=devices,
    )
    # Warm both the single-request shapes and a representative coalesced
    # mix (coalescing maps fields a lone request hoists).
    built = server.warmup(*pool, scenarios.ScenarioGrid.concat(*pool))
    where = (f"{server.runner.sim.device}" if server.mesh is None else
             f"{server.runner.sim.device} x {server.mesh.shape} ranks "
             f"(rank {server.mesh.leader} leads)")
    if server.is_leader:
        say(f"warmup: {built} program(s) built on {where}")

    rng = np.random.default_rng(args.seed)
    t0 = time.monotonic()
    with server:
        if not server.is_leader:        # followers: serve until the stop
            return
        futures = []
        for i in range(args.requests):
            time.sleep(rng.exponential(1.0 / args.rate))
            futures.append(server.submit(
                pool[i % len(pool)],
                priority=int(rng.random() < 0.25),
                tenant=f"tenant{i % 2}",
            ))
        results = [f.result() for f in futures]
    dt = time.monotonic() - t0

    snap = server.tracker.snapshot()
    say(f"served {len(results)} requests in {dt:.2f}s "
        f"({len(results) / dt:.1f} req/s)")
    for k in ("serve/latency_s_p50", "serve/latency_s_p99",
              "serve/coalesced_scenarios_mean", "grid/batch_fill_mean",
              "tenant/tenant0/latency_s_p50", "tenant/tenant1/latency_s_p50",
              "cache/hit", "cache/miss", "cache/evict"):
        if k in snap:
            say(f"  {k} = {snap[k]:.4g}")


def _demo_rank(rank: int, args: argparse.Namespace) -> list[str]:
    """One spawned rank of ``--devices k``: the leader's report lines."""
    lines: list[str] = []
    _demo(args, args.devices, lines.append)
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="mean arrival rate (requests/sec, Poisson)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to spread dispatches over (0 or 1: one "
                         "process; k > 1 spawns k ranks over gloo, the "
                         "first of which leads)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the plain path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.devices <= 1:
        _demo(args, None, lambda line: print(line, flush=True))
        return
    # By module name, so the spawned ranks find it when this runs as
    # __main__.
    from . import serving
    ranks = launch_mesh.spawn(serving._demo_rank, args.devices,
                              device=args.device, args=(args,))
    for line in ranks[0]:
        print(line)


if __name__ == "__main__":
    main()
