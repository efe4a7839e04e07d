"""PyTorch port vs the JAX reference: the scenario-serving tier on the CPU.

The port of tests/test_serving.py without its multi-device tests, on the
reference tests' toy (3 clients, 20 samples, a 32-16 MLP, 64-value
segments, 3 rounds of 2 local epochs), K1 through its custom operator
(``agg_impl="kernel"``: on the CPU the operator runs the plain version,
under the grid's vmap through its vmap rule).

The port's result contract (not the reference's bit-identity): a served
request's rows are the same bits as its rows of `GridRunner.run` of the
coalesced, padded grid the server dispatched (recorded by the fault
helper's probe), and within 1e-5 in loss and bias, with every accuracy
equal, of `run_grid` of the request alone.
"""
import dataclasses
import time
from concurrent.futures import Future

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (fixes the thread count)
from _torch_serving_faults import install  # noqa: E402
from repro.launch import serving as jserving  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.fl import scenarios, simulator  # noqa: E402
from repro_torch.launch import serving, tracker  # noqa: E402
from repro_torch.models import smallnets  # noqa: E402

# Packet length consistent with seg_len=64 float32 segments so the
# server's strict admission check passes by default.
_PACKET_BITS = 32 * 64
TOL = 1e-5


def _init(g):
    return smallnets.init_mlp_clf(g, d_in=32, d_hidden=16)


def _setup(n_clients=3):
    data = synthetic.fed_image_classification(
        n_clients=n_clients, samples_per_client=20, seed=0
    )
    coords = topology.TABLE_II_COORDS[:n_clients]
    nets = [
        topology.make_network(
            coords, edge_density=d, packet_len_bits=_PACKET_BITS,
            n_clients=n_clients, tx_power_dbm=tx,
        )
        # The third net's weaker radios give it other link_eps values (at
        # 3 clients the two density variants coincide).
        for d, tx in ((0.6, 17.0), (0.8, 17.0), (0.8, 11.0))
    ]
    return data, nets, _init, smallnets.apply_mlp_clf


@pytest.fixture(scope="module")
def toy():
    return _setup()


def _cfg(**kw):
    kw.setdefault("n_rounds", 3)
    kw.setdefault("local_epochs", 2)
    kw.setdefault("seg_len", 64)
    kw.setdefault("agg_impl", "kernel")
    return simulator.SimConfig(**kw)


def _server(toy, cfg=None, **serve_kw):
    data, _nets, init, apply_fn = toy
    return serving.ScenarioServer(
        init, apply_fn, data, cfg or _cfg(),
        serve=serving.ServeConfig(**serve_kw), device="cpu")


def _grid(net, proto="ra", label="g", seed=0, mode="ra_normalized"):
    return scenarios.ScenarioGrid.product(
        networks=[(label, net)], protocols=[(proto, mode)], seeds=[seed],
    )


def _run_grid(toy, grid, cfg=None):
    data, _nets, init, apply_fn = toy
    return scenarios.run_grid(init, apply_fn, data, grid, cfg or _cfg(),
                              device="cpu")


def _assert_bits(got: scenarios.GridResult, want: scenarios.GridResult):
    np.testing.assert_array_equal(got.acc, want.acc)
    np.testing.assert_array_equal(got.loss, want.loss)
    # bias is NaN for non-R&A rows; NaN == NaN is intended.
    assert np.array_equal(got.bias, want.bias, equal_nan=True)


def _assert_close(got: scenarios.GridResult, want: scenarios.GridResult):
    """The request-alone contract: loss and bias within 1e-5, accuracies
    equal."""
    np.testing.assert_array_equal(got.acc, want.acc)
    np.testing.assert_allclose(got.loss, want.loss, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.bias, want.bias, atol=TOL, rtol=0,
                               equal_nan=True)


def _replayed(toy, probe, cfg=None):
    """Each dispatch the probe saw, rerun by a fresh runner on the CPU at
    the same padding: (grid, result) in dispatch order."""
    data, _nets, init, apply_fn = toy
    runner = scenarios.GridRunner(init, apply_fn, data, cfg or _cfg(),
                                  device="cpu")
    return [(g, runner.run(g, pad_to=pad, validate=False))
            for g, pad in probe.ran]


def _rows_of(replayed, labels):
    """The replayed rows of one request (its labels in a dispatch)."""
    for grid, res in replayed:
        if labels[0] in grid.labels:
            i = grid.labels.index(labels[0])
            return serving._slice_result(res, i, i + len(labels), labels)
    raise AssertionError(f"no dispatch carried {labels}")


# ---------------------------------------------------------------------
# Admission validation
# ---------------------------------------------------------------------

def test_bad_eval_every_fails_at_server_construction(toy):
    with pytest.raises(ValueError, match="eval_every"):
        _server(toy, _cfg(n_rounds=3, eval_every=2))


def test_admission_rejects_malformed_grid_and_keeps_serving(toy):
    data, nets, init, apply_fn = toy
    good = _grid(nets[0], label="ok")
    bad = _grid(nets[0], label="broken")
    bad = dataclasses.replace(
        bad,
        scenarios=bad.scenarios._replace(
            protocol_id=np.asarray([99], np.int32)),
    )
    empty = good.take([])
    with _server(toy) as server:
        with pytest.raises(scenarios.AdmissionError,
                           match=r"protocol_id.*'broken"):
            server.submit(bad)
        with pytest.raises(scenarios.AdmissionError, match="empty"):
            server.submit(empty)
        res = server.submit(good).result(timeout=300)
    assert res.labels == good.labels     # warm server survived the reject


def test_strict_packet_mismatch_is_an_admission_error(toy):
    mismatched_net = topology.make_network(
        topology.TABLE_II_COORDS[:3], edge_density=0.8,
        packet_len_bits=25_000, n_clients=3, tx_power_dbm=17.0,
    )
    with _server(toy) as server:
        with pytest.raises(scenarios.AdmissionError, match="packet"):
            server.submit(_grid(mismatched_net))


def test_grid_runner_validate_raises_out_of_range_lr(toy):
    data, nets, init, apply_fn = toy
    g = _grid(nets[0], label="nan-lr")
    g = dataclasses.replace(
        g, scenarios=g.scenarios._replace(
            lr=np.asarray([np.nan], np.float32)),
    )
    runner = scenarios.GridRunner(init, apply_fn, data, _cfg(), device="cpu")
    with pytest.raises(scenarios.AdmissionError, match=r"lr.*'nan-lr"):
        runner.validate(g)


def test_multi_device_serving_raises_queue1_item8(toy):
    """Serving over ranks (tests/test_torch_serving_ranks.py) needs a
    process group: without one ``devices=2`` raises the mesh's own error,
    as `run_grid` does, and devices name ranks, not devices."""
    data, nets, init, apply_fn = toy
    with pytest.raises(ValueError, match="launch.mesh.spawn"):
        serving.ScenarioServer(init, apply_fn, data, _cfg(), device="cpu",
                               devices=2)
    with pytest.raises(ValueError, match="names ranks"):
        serving.ScenarioServer(init, apply_fn, data, _cfg(), device="cpu",
                               devices=["cpu", "cpu"])


def test_cli_devices_spawns_ranks_and_serves_the_demo(capsys):
    """The CLI's ``--devices 2`` spawns two ranks and serves its demo over
    them, rank 0 leading."""
    serving.main(["--device", "cpu", "--devices", "2", "--requests", "4",
                  "--rounds", "1", "--clients", "3"])
    out = capsys.readouterr().out
    assert "x {'grid': 2} ranks (rank 0 leads)" in out
    assert "served 4 requests" in out


# ---------------------------------------------------------------------
# Served rows: the dispatched grid's bits, the request alone's values
# ---------------------------------------------------------------------

def test_coalesced_mixed_protocol_serving(toy):
    """Back-to-back requests (mixed protocols, distinct topologies)
    coalesce into ONE dispatch: each served row is the same bits as the
    replayed coalesced, padded grid's, and matches its request's own
    run_grid within the contract; the dispatcher builds no autograd
    graph."""
    data, nets, init, apply_fn = toy
    requests = [
        _grid(nets[0], "ra", "r0"),
        _grid(nets[1], "aayg", "r1"),
        _grid(nets[2], "ra", "r2", mode="substitution"),
    ]
    refs = [_run_grid(toy, g) for g in requests]
    server = _server(toy, max_batch=3, max_delay_s=30.0)
    grad_modes = []
    orig = server.runner.run

    def run_recording_grad_mode(grid, **kw):
        grad_modes.append(torch.is_grad_enabled())
        return orig(grid, **kw)

    server.runner.run = run_recording_grad_mode
    probe = install(server)
    with server:
        got = server.serve(requests)
    assert grad_modes == [False]
    replayed = _replayed(toy, probe)
    assert len(replayed) == 1 and len(replayed[0][0]) == 3
    assert probe.ran[0][1] == serving.ServeConfig().batch_buckets
    for g, r, req in zip(got, refs, requests):
        assert g.labels == r.labels == req.labels
        _assert_bits(g, _rows_of(replayed, req.labels))
        _assert_close(g, r)
    snap = server.tracker.snapshot()
    assert snap["serve/dispatches"] == 1          # genuinely coalesced
    assert snap["serve/requests"] == 3


def test_partial_batch_bucket_padding(toy):
    """A 3-scenario group padded to a 4-bucket with routing-neutral
    filler returns its rows within the contract of the unpadded run (the
    padded batch sums in another order), and the same bits as the same
    padded run again."""
    data, nets, init, apply_fn = toy
    cfg = _cfg()
    grid = scenarios.ScenarioGrid.concat(
        _grid(nets[0], "ra", "a"), _grid(nets[1], "ra", "b"),
        _grid(nets[2], "ra", "c", seed=4),
    )
    runner = scenarios.GridRunner(init, apply_fn, data, cfg, device="cpu")
    want = runner.run(grid)                       # unpadded reference
    tr = tracker.StatsTracker()
    padded_runner = scenarios.GridRunner(init, apply_fn, data, cfg,
                                         tracker=tr, device="cpu")
    got = padded_runner.run(grid, pad_to=(4,))
    _assert_close(got, want)
    _assert_bits(padded_runner.run(grid, pad_to=(4,)), got)
    fills = tr.samples("grid/batch_fill")
    assert fills == [0.75, 0.75]                  # the group really padded


def test_serving_across_cache_eviction_rewarm_cycle(toy):
    """max_cached_programs=1 forces evict/rebuild between alternating
    shapes; results are the same bits as an unbounded-cache runner's."""
    data, nets, init, apply_fn = toy
    cfg = _cfg()
    small = _grid(nets[0], "ra", "small")
    big = scenarios.ScenarioGrid.concat(_grid(nets[0], "ra", "x"),
                                        _grid(nets[1], "ra", "y"))
    ref = scenarios.GridRunner(init, apply_fn, data, cfg, device="cpu")
    want = [ref.run(small), ref.run(big), ref.run(small)]

    tr = tracker.StatsTracker()
    bounded = scenarios.GridRunner(init, apply_fn, data, cfg, device="cpu",
                                   tracker=tr, max_cached_programs=1)
    got = [bounded.run(small), bounded.run(big), bounded.run(small)]
    for g, w in zip(got, want):
        _assert_bits(g, w)
    assert bounded.programs.evictions >= 2        # small->big->small
    assert tr.counter("cache/evict") == bounded.programs.evictions
    assert bounded.programs.stats["programs"] == 1


def test_warmup_builds_dispatch_shapes(toy):
    data, nets, init, apply_fn = toy
    reqs = [_grid(nets[0], "ra", "w0"), _grid(nets[1], "aayg", "w1")]
    server = _server(toy, max_batch=1)
    assert server.warmup(*reqs) >= 1
    misses_before = server.runner.programs.misses
    with server:
        got = server.serve(reqs)
    assert server.runner.programs.misses == misses_before  # all warm
    assert [g.labels for g in got] == [r.labels for r in reqs]
    with pytest.raises(RuntimeError, match="start"):
        server.warmup(reqs[0])                    # post-start is an error
    with pytest.raises(RuntimeError, match="not accepting"):
        server.submit(reqs[0])                    # stopped server rejects


def test_take_selects_rows_and_labels(toy):
    data, nets, init, apply_fn = toy
    grid = scenarios.ScenarioGrid.concat(
        _grid(nets[0], "ra", "a"), _grid(nets[1], "aayg", "b"),
        _grid(nets[0], "ra", "c", seed=7),
    )
    sub = grid.take([2, 0])
    assert sub.labels == [grid.labels[2], grid.labels[0]]
    assert len(sub) == 2
    for name in grid.scenarios._fields:
        whole = getattr(grid.scenarios, name)
        part = getattr(sub.scenarios, name)
        if whole is None:
            assert part is None
            continue
        np.testing.assert_array_equal(part, np.asarray(whole)[[2, 0]])
    with pytest.raises(ValueError, match="1-D"):
        grid.take(np.zeros((2, 2), np.intp))
    # A taken sub-grid is a first-class grid: it runs, within the contract
    # of the matching rows of the full grid's result.
    cfg = _cfg(n_rounds=2, local_epochs=1)
    whole_res = _run_grid(toy, grid, cfg)
    part_res = _run_grid(toy, sub, cfg)
    np.testing.assert_array_equal(part_res.acc, whole_res.acc[[2, 0]])
    np.testing.assert_allclose(part_res.loss, whole_res.loss[[2, 0]],
                               atol=TOL, rtol=0)


# ---------------------------------------------------------------------
# Priority / SLA scheduling
# ---------------------------------------------------------------------

def test_priority_request_skips_delay_window(toy):
    """With a 30 s coalescing window, a priority request dispatches at
    once; a best-effort request submitted alone would sit out the whole
    window (and time out here)."""
    data, nets, init, apply_fn = toy
    grid = _grid(nets[0], label="hot")
    server = _server(toy, _cfg(n_rounds=2, local_epochs=1), max_batch=8,
                     max_delay_s=30.0)
    server.warmup(grid)
    with server:
        t0 = time.monotonic()
        res = server.submit(grid, priority=1).result(timeout=25)
        elapsed = time.monotonic() - t0
    assert res.labels == grid.labels
    assert elapsed < 15, f"priority request waited {elapsed:.2f}s"


def test_near_deadline_request_shrinks_window(toy):
    """A best-effort request whose SLA is far tighter than max_delay_s is
    dispatched within half its slack, not held for the 30 s window."""
    data, nets, init, apply_fn = toy
    grid = _grid(nets[0], label="sla")
    server = _server(toy, _cfg(n_rounds=2, local_epochs=1), max_batch=8,
                     max_delay_s=30.0)
    server.warmup(grid)
    with server:
        t0 = time.monotonic()
        res = server.submit(grid, deadline_s=6.0).result(timeout=25)
        elapsed = time.monotonic() - t0
    assert res.labels == grid.labels
    assert 2.5 < elapsed < 6.0, f"near-deadline request took {elapsed:.2f}s"


# ---------------------------------------------------------------------
# _FairQueue scheduling units (no dispatch)
# ---------------------------------------------------------------------

def _req(cost=1, priority=0, tenant="default", t=0.0, module=serving):
    # cost == len(grid); a plain list stands in for a ScenarioGrid here.
    return module._Request(grid=[None] * cost, future=Future(),
                           t_submit=t, priority=priority, tenant=tenant)


def test_fair_queue_priority_before_fifo():
    q = serving._FairQueue()
    lo = [_req(t=i) for i in range(3)]
    hi = _req(priority=2, t=10.0)
    for r in lo:
        q.put(r)
    q.put(hi)                            # submitted LAST, served FIRST
    assert q.pop(timeout=1) is hi
    assert [q.pop(timeout=1) for _ in range(3)] == lo   # FIFO after that
    assert q.depth == 0


def test_fair_queue_weighted_shares():
    """3:1 tenant weights -> ~3:1 dispatch shares while both are backlogged
    (stride scheduling), FIFO preserved within each tenant."""
    q = serving._FairQueue({"gold": 3.0, "bronze": 1.0})
    gold = [_req(tenant="gold", t=i) for i in range(30)]
    bronze = [_req(tenant="bronze", t=i) for i in range(30)]
    for g, b in zip(gold, bronze):
        q.put(g)
        q.put(b)
    first20 = [q.pop(timeout=1) for _ in range(20)]
    n_gold = sum(1 for r in first20 if r.tenant == "gold")
    assert 13 <= n_gold <= 17, f"gold got {n_gold}/20, expected ~15"
    for tenant in ("gold", "bronze"):
        served = [r for r in first20 if r.tenant == tenant]
        assert served == sorted(served, key=lambda r: r.t_submit)


def test_fair_queue_idle_tenant_banks_no_credit():
    """A tenant idle while another drains the queue re-joins at the busy
    minimum: it does NOT get a catch-up burst that starves the incumbent."""
    q = serving._FairQueue({"a": 1.0, "b": 1.0})
    for i in range(10):                  # only "a" is active
        q.put(_req(tenant="a", t=i))
    for _ in range(10):
        assert q.pop(timeout=1).tenant == "a"
    for i in range(10):
        q.put(_req(tenant="a", t=10 + i))
        q.put(_req(tenant="b", t=10 + i))
    first8 = [q.pop(timeout=1) for _ in range(8)]
    n_b = sum(1 for r in first8 if r.tenant == "b")
    assert 3 <= n_b <= 5, (
        f"idle tenant took {n_b}/8 after re-joining — banked credit"
    )


def test_fair_queue_close_drain_and_shutdown_sentinel():
    q = serving._FairQueue()
    reqs = [_req(t=i) for i in range(3)]
    for r in reqs:
        q.put(r)
    assert q.close(drain=True) == []
    assert [q.pop(timeout=1) for _ in range(3)] == reqs
    assert q.pop(timeout=1) is serving._SHUTDOWN    # drained + closed
    with pytest.raises(serving.ServerStopped):
        q.put(_req())


def test_fair_queue_close_no_drain_returns_dropped():
    q = serving._FairQueue()
    reqs = [_req(t=i) for i in range(3)]
    for r in reqs:
        q.put(r)
    dropped = q.close(drain=False)
    assert sorted(dropped, key=id) == sorted(reqs, key=id)
    assert q.pop(timeout=1) is serving._SHUTDOWN


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fair_queue_order_equals_the_reference(seed):
    """The same random sequence of put / pop / close calls (tenants,
    weights, priorities, costs, submit times) on the port's and the
    reference's `_FairQueue` hands out the same requests in the same
    order, exactly."""
    rng = np.random.default_rng(seed)
    weights = {"gold": 3.0, "silver": 1.5, "bronze": 1.0}
    queues = [serving._FairQueue(weights), jserving._FairQueue(weights)]
    orders = [[], []]
    ids = [{}, {}]
    for step in range(200):
        op = rng.random()
        if op < 0.55:
            kw = dict(cost=int(rng.integers(1, 5)),
                      priority=int(rng.integers(0, 3)),
                      tenant=str(rng.choice(["gold", "silver", "bronze",
                                             "default"])),
                      t=float(rng.integers(0, 50)))
            for q, m, table, mod in zip(queues, orders, ids,
                                        (serving, jserving)):
                r = _req(module=mod, **kw)
                table[id(r)] = step
                q.put(r)
        else:
            for q, m, table in zip(queues, orders, ids):
                r = q.pop(timeout=0.001)
                m.append(None if r is None else table[id(r)])
    drain = bool(rng.integers(0, 2))
    dropped = [sorted(ids[i][id(r)] for r in q.close(drain=drain))
               for i, q in enumerate(queues)]
    assert dropped[0] == dropped[1]
    for q, m, table in zip(queues, orders, ids):
        while (r := q.pop(timeout=0.001)) not in (None, serving._SHUTDOWN,
                                                  jserving._SHUTDOWN):
            m.append(table[id(r)])
    assert orders[0] == orders[1]
    assert sum(x is not None for x in orders[0]) > 20
