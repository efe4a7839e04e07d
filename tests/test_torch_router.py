"""PyTorch port vs the JAX reference: the multi-replica router (CPU).

The port of tests/test_router.py.  Units against the reference, exactly:
`_HashRing.preference` for the same replica names and keys (both hash
with hashlib), `CircuitBreaker` transitions under an explicit clock step
for step, `RouterConfig`'s validation messages, and `grid_signature`
(grids the reference puts in one family and that share every
`simulator.BATCH_IDS` id share one in the port; the port also splits by
codec, aggregator and policy, as its `GridRunner` does).  Then chaos
through tests/_torch_serving_faults.ChaosReplica: a replica killed while
it holds a dispatch (held by an event until the kill, so a request is
certain to meet the dead replica), a flapping replica, stalled and slow
transports, quotas, stops and drains; and two replicas dispatching at
once (released together from held dispatches) against the same
coalesced grids run one at a time.

Every delivered result is held to the port's contract: the same bits as a
replay of a dispatch that ran it (`GridRunner.run` of the grid a probe
recorded, at its padding), and within 1e-5 (accuracies equal) of
`run_grid` of the request alone.
"""
import threading
import time
from concurrent.futures import wait

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (fixes the thread count)
from _torch_serving_faults import ChaosReplica, install, kill_replica  # noqa: E402,E501
from repro.core import topology as jtopology  # noqa: E402
from repro.fl import scenarios as jscenarios  # noqa: E402
from repro.launch import router as jrouter  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.fl import scenarios, simulator  # noqa: E402
from repro_torch.launch import router, serving  # noqa: E402
from repro_torch.models import smallnets  # noqa: E402

_PACKET_BITS = 32 * 64
TOL = 1e-5
WAIT_S = 120.0
_NETS = ((0.6, 17.0), (0.8, 17.0), (0.8, 11.0))


def _init(g):
    return smallnets.init_mlp_clf(g, d_in=32, d_hidden=16)


def _nets(module):
    # The third net's weaker radios give it other link_eps values (at 3
    # clients the two density variants coincide).
    return [module.make_network(module.TABLE_II_COORDS[:3], edge_density=d,
                                packet_len_bits=_PACKET_BITS, n_clients=3,
                                tx_power_dbm=tx)
            for d, tx in _NETS]


@pytest.fixture(scope="module")
def toy():
    data = synthetic.fed_image_classification(n_clients=3,
                                              samples_per_client=20, seed=0)
    return data, _nets(topology), _init, smallnets.apply_mlp_clf


def _cfg(**kw):
    kw.setdefault("n_rounds", 2)
    kw.setdefault("local_epochs", 1)
    kw.setdefault("seg_len", 64)
    kw.setdefault("agg_impl", "kernel")
    return simulator.SimConfig(**kw)


def _grid(net, proto="ra", label="g", seed=0, module=scenarios, **kw):
    return module.ScenarioGrid.product(
        networks=[(label, net)], protocols=[(proto, "ra_normalized")],
        seeds=[seed], **kw)


def _mk_router(toy, n=3, *, serve_kw=None, route_kw=None, plans=None):
    """n chaos-wrapped in-process replicas on the CPU behind one router
    (not yet started), each server with a fault probe (``plans``: replica
    index -> `install` keywords)."""
    data, nets, init, apply_fn = toy
    cfg = _cfg()
    serve_kw = dict(serve_kw or {})
    serve_kw.setdefault("max_batch", 4)
    serve_kw.setdefault("max_delay_s", 0.02)
    chaos, probes = [], {}
    for i in range(n):
        server = serving.ScenarioServer(
            init, apply_fn, data, cfg,
            serve=serving.ServeConfig(**serve_kw), device="cpu")
        probes[f"replica{i}"] = install(server, **(plans or {}).get(i, {}))
        chaos.append(ChaosReplica(router.InProcessReplica(f"replica{i}",
                                                          server)))
    rt = router.ScenarioRouter(
        chaos, route=router.RouterConfig(**dict(route_kw or {})))
    return rt, chaos, probes


def _primary(rt, grid) -> str:
    return rt._ring.preference(router.grid_signature(grid))[0]


def _check(toy, probes, got, grid):
    """A delivered result against the contract (see the module)."""
    data, _nets, init, apply_fn = toy
    assert got.labels == grid.labels
    runner = scenarios.GridRunner(init, apply_fn, data, _cfg(), device="cpu")
    ran = [(g, pad) for p in probes.values() for g, pad in p.ran
           if grid.labels[0] in g.labels]
    assert ran, f"no dispatch ran {grid.labels}"
    matches = []
    for g, pad in ran:
        i = g.labels.index(grid.labels[0])
        rows = runner.run(g, pad_to=pad, validate=False)
        matches.append(np.array_equal(got.loss, rows.loss[i:i + 1])
                       and np.array_equal(got.acc, rows.acc[i:i + 1]))
    assert any(matches), "delivered rows match no dispatch that ran them"
    alone = scenarios.run_grid(init, apply_fn, data, grid, _cfg(),
                               device="cpu")
    np.testing.assert_array_equal(got.acc, alone.acc)
    np.testing.assert_allclose(got.loss, alone.loss, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.bias, alone.bias, atol=TOL, rtol=0,
                               equal_nan=True)


# ----------------------------------------------------------------------
# Units: ring, breaker, signature, config — against the reference.
# ----------------------------------------------------------------------

def test_hash_ring_covers_remaps_minimally_and_equals_the_reference():
    names = [f"r{i}" for i in range(5)]
    ring = router._HashRing(names, vnodes=64)
    jring = jrouter._HashRing(names, vnodes=64)
    keys = [f"key-{i}" for i in range(300)]
    prefs = {k: ring.preference(k) for k in keys}
    for k, order in prefs.items():
        assert sorted(order) == sorted(names)          # full failover order
        assert order == ring.preference(k) == jring.preference(k)
    smaller = router._HashRing([n for n in names if n != "r2"], vnodes=64)
    for k in keys:
        if prefs[k][0] != "r2":
            assert smaller.preference(k)[0] == prefs[k][0]
        else:
            assert smaller.preference(k)[0] == prefs[k][1]
    for vnodes in (1, 7):
        a = router._HashRing(["replica0", "replica1", "replica2"], vnodes)
        b = jrouter._HashRing(["replica0", "replica1", "replica2"], vnodes)
        assert all(a.preference(k) == b.preference(k) for k in keys)
    with pytest.raises(ValueError):
        router._HashRing([])
    with pytest.raises(ValueError):
        router._HashRing(["a", "a"])


def test_circuit_breaker_state_machine():
    b = router.CircuitBreaker(failures=3, cooldown_s=1.0)
    assert b.state == b.CLOSED and b.allow(now=0.0)
    b.record_failure(now=0.0)
    b.record_failure(now=0.0)
    b.record_success()                     # success resets the streak
    b.record_failure(now=1.0)
    b.record_failure(now=1.0)
    assert b.state == b.CLOSED
    b.record_failure(now=1.0)              # third consecutive: trips
    assert b.state == b.OPEN
    assert not b.allow(now=1.5)            # cooling down
    assert b.allow(now=2.5)                # half-open: THE probe
    assert b.state == b.HALF_OPEN
    assert not b.allow(now=2.5)            # one probe at a time
    b.record_failure(now=2.5)              # probe failed: re-open
    assert b.state == b.OPEN
    assert not b.allow(now=3.0)
    assert b.allow(now=4.0)                # next probe window
    b.record_success()
    assert b.state == b.CLOSED and b.allow(now=4.0)


def test_circuit_breaker_heartbeat_semantics():
    b = router.CircuitBreaker(failures=2, cooldown_s=1.0)
    b.on_ping(False, now=0.0)
    b.on_ping(False, now=0.0)              # failed pings trip it
    assert b.state == b.OPEN
    b.on_ping(True, now=0.5)               # still cooling: no effect
    assert b.state == b.OPEN
    b.on_ping(True, now=1.5)               # past cooldown: ping re-closes
    assert b.state == b.CLOSED
    b.record_failure(now=2.0)
    b.on_ping(True, now=2.0)
    b.record_failure(now=2.0)
    assert b.state == b.OPEN


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_circuit_breaker_transitions_equal_the_reference(seed):
    """A random script of allow / success / failure / ping calls at an
    explicit, advancing clock: the port's breaker and the reference's
    return the same values and pass through the same states, step for
    step, and open the same number of times."""
    rng = np.random.default_rng(seed)
    opens = [0, 0]
    pair = [router.CircuitBreaker(2, 0.5, on_open=lambda: opens.__setitem__(
                0, opens[0] + 1)),
            jrouter.CircuitBreaker(2, 0.5, on_open=lambda: opens.__setitem__(
                1, opens[1] + 1))]
    now = 0.0
    states = set()
    for _ in range(400):
        now += float(rng.choice([0.0, 0.1, 0.3, 0.7]))
        op = int(rng.integers(0, 5))
        out = []
        for b in pair:
            if op == 0:
                out.append(b.allow(now=now))
            elif op == 1:
                out.append(b.record_success())
            elif op == 2:
                out.append(b.record_failure(now=now))
            else:
                out.append(b.on_ping(op == 3, now=now))
        assert out[0] == out[1]
        assert pair[0].state == pair[1].state
        states.add(pair[0].state)
    assert opens[0] == opens[1] > 0
    assert states == {"closed", "open", "half_open"}


def test_router_config_validation_messages_equal_the_reference():
    for bad in (
        dict(vnodes=0), dict(max_attempts=0), dict(jitter=1.5),
        dict(jitter=-0.1), dict(hedge_slack_frac=0.0),
        dict(hedge_slack_frac=1.0), dict(tenant_quotas={"t": 0}),
    ):
        with pytest.raises(ValueError) as got:
            router.RouterConfig(**bad)
        with pytest.raises(ValueError) as want:
            jrouter.RouterConfig(**bad)
        assert str(got.value) == str(want.value)
    assert (router.RouterConfig().__dict__ == jrouter.RouterConfig().__dict__)


def test_grid_signature_families(toy):
    data, nets, init, apply_fn = toy
    a = router.grid_signature(_grid(nets[0], "ra", "a", seed=0))
    # Same program family: different seed, label, topology values.
    assert router.grid_signature(_grid(nets[0], "ra", "x", seed=7)) == a
    assert router.grid_signature(_grid(nets[1], "ra", "y", seed=0)) == a
    # Different protocol: different dispatch group, different family.
    assert router.grid_signature(_grid(nets[0], "aayg", "z")) != a
    # A merely WIDER batch (only seed mapped) stays in the same family.
    seeds = scenarios.ScenarioGrid.product(
        networks=[("w", nets[0])], protocols=[("ra", "ra_normalized")],
        seeds=[0, 1, 2],
    )
    assert router.grid_signature(seeds) == a
    # A coalesced batch over DIFFERENT topologies maps the link field a
    # 1-row grid hoists: different program, different signature.
    two = scenarios.ScenarioGrid.concat(
        _grid(nets[0], "ra", "p", seed=0), _grid(nets[2], "ra", "q", seed=1)
    )
    assert router.grid_signature(two) != a


def test_grid_signature_keys_the_ports_dispatch_partition(toy):
    """Grids the reference puts in one family share one in the port when
    they share every BATCH_IDS id; grids that differ only in a codec or
    aggregator id (one family for the reference, two dispatch groups for
    the port's runner) get two."""
    data, nets, init, apply_fn = toy
    jnets = _nets(jtopology)
    variants = [dict(seed=0), dict(seed=5), dict(seed=0, aggregator=1),
                dict(seed=0, codecs=[("k", "topk", 0.5)]),
                dict(seed=2, codecs=[("k", "topk", 0.25)]),
                dict(seed=0, codecs=[("q", "quant", 0.5)])]
    for proto in ("ra", "cfl"):
        rows = []
        for v in variants:
            tg = _grid(nets[0], proto, "g", **v)
            jg = _grid(jnets[0], proto, "g", module=jscenarios, **v)
            ids = tuple(None if getattr(tg.scenarios, n) is None
                        else tuple(np.asarray(getattr(tg.scenarios, n)))
                        for n in simulator.BATCH_IDS)
            rows.append((router.grid_signature(tg),
                         jrouter.grid_signature(jg), ids))
        for ts, js, ids in rows:
            for ts2, js2, ids2 in rows:
                if js == js2 and ids == ids2:
                    assert ts == ts2
                if ids != ids2:
                    assert ts != ts2
        # The reference folds top-k and quant (same shapes) into one
        # family; the port splits them.
        assert rows[3][1] == rows[5][1] and rows[3][0] != rows[5][0]


def test_in_process_router_takes_one_device(toy):
    data, nets, init, apply_fn = toy
    rt = router.ScenarioRouter.in_process(init, apply_fn, data, _cfg(),
                                          n_replicas=2, device="cpu")
    assert sorted(rt.replicas) == ["replica0", "replica1"]
    for rep in rt.replicas.values():
        assert rep.server.runner.sim.device == torch.device("cpu")
    # Over ranks (tests/test_torch_serving_ranks.py) it needs a process
    # group: without one the mesh's own error, as `run_grid` raises.
    with pytest.raises(ValueError, match="launch.mesh.spawn"):
        router.ScenarioRouter.in_process(init, apply_fn, data, _cfg(),
                                         device="cpu", devices=2)


# ----------------------------------------------------------------------
# Integration: routing, failover, chaos.
# ----------------------------------------------------------------------

def test_router_cache_affinity_and_contract(toy):
    data, nets, init, apply_fn = toy
    rt, chaos, probes = _mk_router(toy, n=3)
    pool = [_grid(nets[i % 2], "ra", f"g{i}", seed=i) for i in range(4)]
    rt.warmup(pool, fanout=1)
    try:
        with rt:
            futs = [rt.submit(g) for g in pool]
            got = [f.result(timeout=WAIT_S) for f in futs]
    finally:
        rt.stop(drain=False)
    for r, g in zip(got, pool):
        _check(toy, probes, r, g)
    # One program family -> one replica (cache affinity), no retries.
    assert sorted(c.submits for c in chaos) == [0, 0, 4]
    snap = rt.tracker.snapshot()
    assert snap["router/requests"] == 4
    assert snap["router/attempts"] == 4
    assert snap.get("router/retries", 0) == 0


def test_two_replicas_dispatching_at_once_match_one_at_a_time(toy):
    """Two replicas hold their first dispatch until both are inside it,
    then run together (two dispatcher threads, each inside its own vmap,
    K1 through its custom operator's vmap rule): every delivered row is
    the same bits as its coalesced grid run again alone, one at a time."""
    data, nets, init, apply_fn = toy
    names = ["replica0", "replica1"]
    ring = router._HashRing(names, vnodes=64)
    fams = {}
    for proto in ("ra", "aayg", "cfl"):
        for mode in ("ra_normalized", "substitution"):
            g = scenarios.ScenarioGrid.product(
                networks=[("n", nets[0])], protocols=[(proto, mode)])
            fams.setdefault(ring.preference(router.grid_signature(g))[0],
                            (proto, mode))
    assert sorted(fams) == names, "every family hashed to one replica"
    release = threading.Event()
    rt, chaos, probes = _mk_router(
        toy, n=2, serve_kw=dict(max_batch=2, max_delay_s=30.0),
        plans={0: dict(stall_on={0: release}),
               1: dict(stall_on={0: release})})
    pool = [scenarios.ScenarioGrid.product(
                networks=[(f"{name}-{i}", nets[i])],
                protocols=[fams[name]], seeds=[i])
            for name in names for i in range(2)]
    rt.warmup(pool, fanout=1)
    try:
        with rt:
            futs = [rt.submit(g) for g in pool]
            for p in probes.values():
                assert p.stalled.wait(WAIT_S)
            release.set()
            got = [f.result(timeout=WAIT_S) for f in futs]
    finally:
        release.set()
        rt.stop(drain=False)
    runner = scenarios.GridRunner(init, apply_fn, data, _cfg(), device="cpu")
    for name in names:
        (g, pad), = probes[name].ran
        assert len(g) == 2
        alone = runner.run(g, pad_to=pad, validate=False)
        for r, req in zip(got, pool):
            if req.labels[0] in g.labels:
                i = g.labels.index(req.labels[0])
                np.testing.assert_array_equal(r.loss, alone.loss[i:i + 1])
                np.testing.assert_array_equal(r.acc, alone.acc[i:i + 1])
                assert np.array_equal(r.bias, alone.bias[i:i + 1],
                                      equal_nan=True)
    for r, g in zip(got, pool):
        _check(toy, probes, r, g)


def test_replica_killed_mid_run_fails_over(toy):
    """The chaos headline: the loaded replica holds its first dispatch
    until it is killed (transport down, server hard-stopped), so the
    requests inside it must fail over; everything delivers within the
    contract; the dead replica's breaker opens."""
    data, nets, init, apply_fn = toy
    pool = [_grid(nets[i % 2], "ra", f"k{i}", seed=i) for i in range(6)]
    ring = router._HashRing([f"replica{i}" for i in range(3)],
                            vnodes=router.RouterConfig().vnodes)
    victim_i = int(ring.preference(router.grid_signature(pool[0]))[0][-1])
    release = threading.Event()
    rt, chaos, probes = _mk_router(toy, n=3, route_kw=dict(
        max_attempts=4, backoff_base_s=0.01, breaker_cooldown_s=0.3,
        heartbeat_s=0.05, attempt_timeout_s=60.0,
    ), plans={victim_i: dict(stall_on={0: release},
                             raise_on={0: RuntimeError("replica killed")})})
    victim = f"replica{victim_i}"
    rt.warmup(pool, fanout=3)              # survivors are warm too
    try:
        with rt:
            futs = [rt.submit(g) for g in pool[:3]]
            assert probes[victim].stalled.wait(WAIT_S)
            kill_replica(next(c for c in chaos if c.name == victim), release)
            futs += [rt.submit(g) for g in pool[3:]]
            got = [f.result(timeout=WAIT_S) for f in futs]
            deadline = time.monotonic() + 30.0
            while (rt.breaker(victim).state != router.CircuitBreaker.OPEN
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert rt.breaker(victim).state == router.CircuitBreaker.OPEN
    finally:
        release.set()
        rt.stop(drain=False)
    for r, g in zip(got, pool):
        _check(toy, probes, r, g)
    assert probes[victim].ran == []        # the victim delivered nothing
    snap = rt.tracker.snapshot()
    assert snap["router/requests"] == 6
    assert snap["router/breaker_opens"] >= 1
    assert snap["router/retries"] >= 1     # a request met the dead replica


def test_flapping_replica_exactly_once_delivery(toy):
    """One replica flaps (kill/revive loop) while traffic flows: every
    future terminates, each is delivered exactly once, within the
    contract (late/duplicate results are discarded, never delivered)."""
    data, nets, init, apply_fn = toy
    rt, chaos, probes = _mk_router(toy, n=3, route_kw=dict(
        max_attempts=5, backoff_base_s=0.01, breaker_cooldown_s=0.1,
        heartbeat_s=0.03, attempt_timeout_s=60.0,
    ))
    pool = [_grid(nets[i % 2], "ra", f"f{i}", seed=i) for i in range(8)]
    rt.warmup(pool, fanout=3)
    flapper = next(c for c in chaos if c.name == _primary(rt, pool[0]))
    stop_flap = threading.Event()

    def flap_loop():
        while not stop_flap.is_set():
            flapper.kill()
            stop_flap.wait(0.08)
            flapper.revive()
            stop_flap.wait(0.08)

    t = threading.Thread(target=flap_loop, daemon=True)
    deliveries = [0] * len(pool)
    try:
        with rt:
            t.start()
            futs = []
            for i, g in enumerate(pool):
                f = rt.submit(g)
                f.add_done_callback(lambda _f, i=i: deliveries.__setitem__(
                    i, deliveries[i] + 1))
                futs.append(f)
                time.sleep(0.03)
            done, not_done = wait(futs, timeout=WAIT_S)
            stop_flap.set()
            t.join(timeout=10)
            assert not not_done, f"{len(not_done)} futures never terminated"
            got = [f.result() for f in futs]
    finally:
        stop_flap.set()
        rt.stop(drain=False)
    assert not t.is_alive()
    assert deliveries == [1] * len(pool)
    for r, g in zip(got, pool):
        _check(toy, probes, r, g)
    assert rt.tracker.snapshot()["router/requests"] == 8


def test_stalled_transport_times_out_and_retries(toy):
    """A stalled transport (pings pass, submits hang) is caught by the
    attempt timeout, retried on a survivor, and the request delivers."""
    data, nets, init, apply_fn = toy
    rt, chaos, probes = _mk_router(toy, n=2, route_kw=dict(
        max_attempts=3, attempt_timeout_s=0.3, backoff_base_s=0.01,
    ))
    g = _grid(nets[0], "ra", "s0")
    rt.warmup([g], fanout=2)
    victim = next(c for c in chaos if c.name == _primary(rt, g))
    other = next(c for c in chaos if c.name != victim.name)
    try:
        with rt:
            victim.stall()
            got = rt.submit(g).result(timeout=WAIT_S)
    finally:
        rt.stop(drain=False)
    _check(toy, probes, got, g)
    assert victim.submits == 1 and other.submits == 1
    snap = rt.tracker.snapshot()
    assert snap["router/timeouts"] >= 1
    assert snap["router/retries"] >= 1


def test_slow_transport_hedges_near_deadline(toy):
    """A slow-but-alive replica holds its result until released: the
    hedge fires at half the deadline, the secondary wins the resolution
    race, and the slow result, let go afterwards, is discarded (or its
    attempt was cancelled) — delivered exactly once."""
    data, nets, init, apply_fn = toy
    rt, chaos, probes = _mk_router(toy, n=2, route_kw=dict(
        max_attempts=2, attempt_timeout_s=None, hedge_slack_frac=0.5,
    ))
    g = _grid(nets[0], "ra", "h0")
    rt.warmup([g], fanout=2)
    victim = next(c for c in chaos if c.name == _primary(rt, g))
    late = threading.Event()
    deliveries = []
    try:
        with rt:
            victim.slow(late)
            f = rt.submit(g, deadline_s=4.0)
            f.add_done_callback(lambda _f: deliveries.append(1))
            got = f.result(timeout=WAIT_S)     # the hedge delivered it
            late.set()
            _wait = time.monotonic() + 30.0
            snap = rt.tracker.snapshot()
            while (snap.get("router/results_discarded", 0)
                   + snap.get("router/attempts_cancelled", 0) < 1
                   and time.monotonic() < _wait):
                time.sleep(0.01)
                snap = rt.tracker.snapshot()
    finally:
        late.set()
        rt.stop(drain=False)
    _check(toy, probes, got, g)
    assert deliveries == [1]
    snap = rt.tracker.snapshot()
    assert snap["router/hedges"] == 1
    assert (snap.get("router/results_discarded", 0)
            + snap.get("router/attempts_cancelled", 0)) >= 1


def test_router_deadline_fires_while_all_replicas_stalled(toy):
    """With every transport stalled, the ROUTER's own deadline timer
    fails the request with `DeadlineExceeded` — no dependence on any
    replica's reaper being alive."""
    data, nets, init, apply_fn = toy
    rt, chaos, probes = _mk_router(toy, n=2, route_kw=dict(
        max_attempts=2, attempt_timeout_s=30.0,
    ))
    g = _grid(nets[0], "ra", "d0")
    try:
        with rt:
            for c in chaos:
                c.stall()
            t0 = time.monotonic()
            f = rt.submit(g, deadline_s=0.4)
            with pytest.raises(serving.DeadlineExceeded):
                f.result(timeout=10.0)
            assert time.monotonic() - t0 < 10.0
            for c in chaos:
                c.revive()
    finally:
        rt.stop(drain=False)
    assert rt.tracker.snapshot()["router/deadline_exceeded"] == 1


def test_global_tenant_quota_spans_replicas(toy):
    """Quota counts OUTSTANDING scenarios across all replicas: reserved
    at submit, released when the client future terminates."""
    data, nets, init, apply_fn = toy
    rt, chaos, probes = _mk_router(toy, n=2, route_kw=dict(
        max_attempts=2, attempt_timeout_s=30.0,
        tenant_quotas={"capped": 1},
    ))
    g = _grid(nets[0], "ra", "q0")
    rt.warmup([g], fanout=2)
    try:
        with rt:
            for c in chaos:
                c.stall()                # park the first request in flight
            f1 = rt.submit(g, tenant="capped")
            with pytest.raises(router.QuotaExceeded):
                rt.submit(_grid(nets[0], "ra", "q1"), tenant="capped")
            # Other tenants are not throttled by it.
            g2 = _grid(nets[0], "ra", "q2")
            f_other = rt.submit(g2)
            for c in chaos:
                c.revive()               # stalled futures cancelled ->
            r1 = f1.result(timeout=WAIT_S)   # the retry delivers
            r2 = f_other.result(timeout=WAIT_S)
            # Quota released on termination: submit admits again.
            g3 = _grid(nets[0], "ra", "q3")
            r3 = rt.submit(g3, tenant="capped").result(timeout=WAIT_S)
    finally:
        rt.stop(drain=False)
    for r, gg in ((r1, g), (r2, g2), (r3, g3)):
        _check(toy, probes, r, gg)
    assert rt.tracker.snapshot()["router/quota_rejected"] == 1


def test_router_input_hardening(toy):
    data, nets, init, apply_fn = toy
    rt, chaos, probes = _mk_router(
        toy, n=2, serve_kw=dict(tenant_weights={"alice": 2.0}),
    )
    g = _grid(nets[0], "ra", "v0")
    try:
        with rt:
            with pytest.raises(serving.InvalidRequest):
                rt.submit(g, deadline_s=0.0)
            with pytest.raises(serving.InvalidRequest):
                rt.submit(g, deadline_s=float("nan"))
            with pytest.raises(serving.InvalidRequest):
                rt.submit(g, priority=float("nan"))
            with pytest.raises(serving.UnknownTenant):
                rt.submit(g, tenant="mallory")
            with pytest.raises(scenarios.AdmissionError):
                rt.submit(g.take([]))
    finally:
        rt.stop(drain=False)
    # None of the rejects leaked registry entries or quota.
    assert not rt._outstanding
    assert rt.tracker.snapshot().get("router/stopped_requests", 0) == 0


def test_stop_drain_serves_everything_then_hard_stop_rejects(toy):
    data, nets, init, apply_fn = toy
    rt, chaos, probes = _mk_router(toy, n=2)
    pool = [_grid(nets[i % 2], "ra", f"t{i}", seed=i) for i in range(4)]
    rt.warmup(pool, fanout=2)
    rt.start()
    try:
        futs = [rt.submit(g) for g in pool]
        rt.stop()                        # drain default
        for f in futs:
            assert f.done()
        with pytest.raises(serving.ServerStopped):
            rt.submit(pool[0])
        rt.stop()                        # idempotent
    finally:
        rt.stop(drain=False)
    for f, g in zip(futs, pool):
        _check(toy, probes, f.result(), g)

    # Hard stop: parked requests fail with ServerStopped immediately.
    rt2, chaos2, _ = _mk_router(toy, n=2, route_kw=dict(
        attempt_timeout_s=30.0,
    ))
    rt2.start()
    try:
        for c in chaos2:
            c.stall()
        parked = [rt2.submit(g) for g in pool[:2]]
        t0 = time.monotonic()
        rt2.stop(drain=False)
        for f in parked:
            with pytest.raises(serving.ServerStopped):
                f.result(timeout=1)
        assert time.monotonic() - t0 < 10.0
    finally:
        rt2.stop(drain=False)
    assert rt2.tracker.snapshot()["router/stopped_requests"] == 2


def test_drain_replica_planned_failover(toy):
    """drain_replica removes one replica from routing and stops it while
    the survivors keep serving its program families."""
    data, nets, init, apply_fn = toy
    rt, chaos, probes = _mk_router(toy, n=3)
    g = _grid(nets[0], "ra", "p0")
    rt.warmup([g], fanout=3)
    victim = _primary(rt, g)
    rep = next(c for c in chaos if c.name == victim)
    try:
        with rt:
            first = rt.submit(g).result(timeout=WAIT_S)
            assert rep.submits == 1
            rt.drain_replica(victim)
            assert rep.inner.server._stopped
            second = rt.submit(g).result(timeout=WAIT_S)
            assert rep.submits == 1      # the drained replica sees no more
            with pytest.raises(KeyError):
                rt.drain_replica("no-such-replica")
    finally:
        rt.stop(drain=False)
    _check(toy, probes, first, g)
    _check(toy, probes, second, g)
    assert rt.tracker.snapshot()["router/drains"] == 1
