"""The round's phase spans (`launch.tracker.span`) and the sample-pass
counter (`fl.simulator.SAMPLE_PASSES`) of the port, on a tiny grid on the
CPU under `torch.profiler`.

* Each phase's span opens as often as the round loop runs the phase.
* With the benchmark's ranges open as well (as its harness opens them: one
  around each call of the gradient `torch.func.grad` binds, one around
  each `protocols.dispatch_round_seg` call), the program's
  ``dfl:local_train`` and ``dfl:exchange`` hold the same aten operators,
  name for name and count for count, as those ranges.
* With no profiler recording, no range is entered.
* The counter adds G x epochs x rounds x N x (largest shard) rows computed
  and G x epochs x rounds x (sum of the shards) own samples.
"""
import collections
import json
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core import protocols, topology
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.fl import scenarios, simulator
from repro_torch.launch import tracker
from repro_torch.models import smallnets

SIZES = [2, 3, 5]
N = len(SIZES)
EPOCHS, ROUNDS = 2, 2
PROTOCOLS = [("ra", "ra_normalized"), ("aayg", "ra_normalized"),
             ("cfl", "ra_normalized")]
SEEDS = [0, 1]
GROUPS = len(PROTOCOLS)


def _init(gen):
    return smallnets.init_mlp_clf(gen, d_in=6, d_hidden=4)


def _data() -> FederatedDataset:
    rng = np.random.default_rng(0)
    return FederatedDataset(
        [rng.normal(size=(s, 6)).astype(np.float32) for s in SIZES],
        [rng.integers(0, 10, size=s).astype(np.int32) for s in SIZES],
        rng.normal(size=(4, 6)).astype(np.float32),
        rng.integers(0, 10, size=4).astype(np.int32))


def _runner() -> scenarios.GridRunner:
    cfg = simulator.SimConfig(seg_len=64, local_epochs=EPOCHS,
                              n_rounds=ROUNDS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return scenarios.GridRunner(_init, smallnets.apply_mlp_clf, _data(),
                                    cfg, device="cpu")


def _grid() -> scenarios.ScenarioGrid:
    net = topology.make_network(
        topology.TABLE_II_COORDS[:N], edge_density=0.8,
        packet_len_bits=2048, n_clients=N, tx_power_dbm=17.0)
    return scenarios.ScenarioGrid.product(
        networks=[("net", net)], protocols=PROTOCOLS, seeds=SEEDS,
        lrs=[0.1], aggregator=1)


def _run(runner, grid, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return runner.run(grid, **kw)


def _traced(fn, tmp_path) -> tuple[dict, list]:
    """Run ``fn`` under the profiler: (ranges by name, aten operators),
    each as (start, end[, name]) in microseconds."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges, ops = collections.defaultdict(list), []
    for ev in json.loads(path.read_text())["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        end = ev["ts"] + ev["dur"]
        if ev.get("cat") == "user_annotation":
            ranges[ev["name"]].append((ev["ts"], end))
        elif ev.get("cat") == "cpu_op" and ev["name"].startswith("aten::"):
            ops.append((ev["ts"], end, ev["name"]))
    return ranges, ops


def test_each_phase_opens_its_span_per_step(tmp_path):
    runner, grid = _runner(), _grid()
    _run(runner, grid)                        # build the programs first
    ranges, _ = _traced(lambda: _run(runner, grid), tmp_path)
    chunks = ROUNDS          # eval_every 1: one evaluation a round
    assert {k: len(v) for k, v in ranges.items()
            if k.startswith("dfl:")} == {
        # Admission, then each group's batching, its program lookup and
        # its `prepare_batch`.
        "dfl:prepare": 1 + 3 * GROUPS,
        "dfl:init": GROUPS,
        "dfl:draws": GROUPS * ROUNDS,
        "dfl:local_train": GROUPS * ROUNDS * EPOCHS,
        "dfl:exchange": GROUPS * ROUNDS,
        "dfl:eval": GROUPS * chunks,
        # Each group's copy to the host and its rows' split, then the
        # rows' reassembly.
        "dfl:fetch": 2 * GROUPS + 1}


def test_scalar_path_opens_the_round_spans(tmp_path):
    runner, grid = _runner(), _grid()
    ranges, _ = _traced(lambda: runner.sim.run_scenario(grid.scenario(0)),
                        tmp_path)
    assert {k: len(v) for k, v in ranges.items()} == {
        "dfl:init": 1, "dfl:draws": ROUNDS,
        "dfl:local_train": ROUNDS * EPOCHS, "dfl:exchange": ROUNDS,
        "dfl:eval": ROUNDS, "dfl:fetch": 1}


def _bench_ranges(monkeypatch):
    """The benchmark's own ranges, renamed ``bench:``: one around each call
    of a gradient that `torch.func.grad` binds (a simulator binds its
    gradient when it is built) and one around each
    `protocols.dispatch_round_seg` call."""
    grad, dispatch = torch.func.grad, protocols.dispatch_round_seg

    def ranged_grad(fn, *args, **kwargs):
        inner = grad(fn, *args, **kwargs)

        def call(*a, **k):
            with record_function("bench:local_train"):
                return inner(*a, **k)
        return call

    def ranged_dispatch(*args, **kwargs):
        with record_function("bench:exchange"):
            return dispatch(*args, **kwargs)

    monkeypatch.setattr(torch.func, "grad", ranged_grad)
    monkeypatch.setattr(protocols, "dispatch_round_seg", ranged_dispatch)


def test_spans_hold_the_benchmarks_operators(tmp_path, monkeypatch):
    _bench_ranges(monkeypatch)
    runner, grid = _runner(), _grid()
    _run(runner, grid)
    ranges, ops = _traced(lambda: _run(runner, grid), tmp_path)

    def inside(name):
        return collections.Counter(
            op for start, end, op in ops
            if any(a <= start and end <= b for a, b in ranges[name]))

    for phase in ("local_train", "exchange"):
        mine, theirs = inside(f"dfl:{phase}"), inside(f"bench:{phase}")
        assert len(ranges[f"dfl:{phase}"]) == len(ranges[f"bench:{phase}"])
        assert sum(theirs.values()) > 0, phase
        assert mine == theirs, phase


def test_no_range_without_a_profiler(monkeypatch):
    entered = []

    def counting(name):
        entered.append(name)
        return orig(name)

    orig = tracker.record_function
    monkeypatch.setattr(tracker, "record_function", counting)
    runner, grid = _runner(), _grid()
    _run(runner, grid)
    runner.sim.run_scenario(grid.scenario(0))
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _run(runner, grid.take([0]))
    assert "dfl:local_train" in entered


@pytest.mark.parametrize("path", ["grid", "padded", "sequential"])
def test_sample_pass_counter(path):
    runner, grid = _runner(), _grid()
    before = dict(simulator.SAMPLE_PASSES)
    if path == "sequential":
        runner.run_sequential(grid)
        scenarios_run = len(grid)
    elif path == "padded":
        # Each group of 2 padded to 4 rows: the filler rows train too.
        _run(runner, grid, pad_to=4)
        scenarios_run = 4 * GROUPS
    else:
        _run(runner, grid)
        scenarios_run = len(grid)
    got = {k: v - before.get(k, 0)
           for k, v in simulator.SAMPLE_PASSES.items()}
    per_scenario = EPOCHS * ROUNDS
    assert got == {"computed": scenarios_run * per_scenario * N * max(SIZES),
                   "own": scenarios_run * per_scenario * sum(SIZES)}
