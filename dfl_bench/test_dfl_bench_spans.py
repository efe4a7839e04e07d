"""The readers of the program's phase spans and sample counter
(`eval_ms`, `train_idle_pct`, `host_idle_pct`, `padding_pct`) and
`spans.py`'s split of the idle time, on a hand-made Kineto trace."""
import functools

import numpy as np
import pytest
import torch

from dfl_bench import harness, spans, traffic
from dfl_bench.devtrace import Trace

MAIN, ENGINE = 100, 200


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _op(cat, name, ts, dur, corr, launch_ts, tid=MAIN,
        call=("cudaLaunchKernel", 1)):
    return [_x("cuda_runtime", call[0], launch_ts, call[1], tid,
               correlation=corr),
            _x(cat, name, ts, dur, 7, correlation=corr)]


def events():
    # The call, 0..100 us, one phase after another on the main thread.
    # Device intervals: local training 20..30 (launched from the main
    # thread) and 35..40 (from the autograd engine's); K1 47..52; the
    # evaluation 58..68 and 68..72 (the second launched from the engine's
    # thread); the copy to the host 78..80; an update launched outside
    # every phase 92..94; the host waits in the copy's call until 81.
    # Idle: prepare 0..8, init 8..12, draws 12..15,
    # local training 15..20 + 30..35 + 40..45, the exchange 45..47 +
    # 52..55, the evaluation 55..58 + 72..75, fetch 75..78 + 80..90,
    # outside 90..92 + 94..100.
    ev = [_x("user_annotation", "dfl:call", 0, 100)]
    for name, start, end in (("dfl:prepare", 0, 8), ("dfl:init", 8, 12),
                             ("dfl:draws", 12, 15),
                             ("dfl:local_train", 15, 45),
                             ("dfl:exchange", 45, 55), ("dfl:eval", 55, 75),
                             ("dfl:fetch", 75, 90)):
        ev.append(_x("user_annotation", name, start, end - start))
    ev += _op("kernel", "conv_fwd", 20, 10, 1, 16)
    ev += _op("kernel", "conv_dgrad", 35, 5, 2, 31, tid=ENGINE)
    ev += _op("kernel", "void ra_reg_kernel<float, 10>", 47, 5, 3, 46)
    ev += _op("kernel", "eval_fwd", 58, 10, 4, 56)
    ev += _op("kernel", "eval_loss", 68, 4, 5, 60, tid=ENGINE)
    ev += _op("gpu_memcpy", "Memcpy DtoH", 78, 2, 6, 76,
              call=("cudaMemcpyAsync", 5))
    ev += _op("kernel", "update", 92, 2, 7, 91)
    return ev


IDLE = {"dfl:prepare": 8, "dfl:init": 4, "dfl:draws": 3,
        "dfl:local_train": 15, "dfl:exchange": 5, "dfl:eval": 6,
        "dfl:fetch": 13}
OUTSIDE = 8


@pytest.fixture
def trace():
    return Trace(events(), "dfl:call")


def _ctx(trace):
    return harness.TraceContext(trace=trace, scenario_rounds=2, flops=1e6,
                                k1_launches={}, peak_flops=None,
                                peak_bytes_per_s=None, value_bytes=4)


def _read(name, ctx):
    return harness.metric_reader(name)(ctx)


def test_idle_time_splits_by_phase(trace):
    idle = 100 - trace.busy_us
    assert trace.busy_us == 38
    assert {n: spans.idle_in_us(trace, (n,)) for n in spans.PHASES} == IDLE
    assert spans.idle_in_us(trace, spans.PHASES) == idle - OUTSIDE
    rep = spans.report(trace)
    assert rep["idle_outside_phases_s"] == pytest.approx(OUTSIDE / 1e6)
    assert rep["idle_s"] == pytest.approx(sum(IDLE.values()) / 1e6
                                          + OUTSIDE / 1e6)
    # Every kernel but the update was launched in a phase.
    assert rep["covered"] == pytest.approx(36 / 38)


def test_idle_by_host_operation_and_phase(trace):
    got = spans.idle_by_op(trace, floor_us=0)
    # A gap is named where it begins and split where it runs: the first
    # runs from prepare into local training; the one after the copy begins
    # in its call and runs out of fetch; the one from 40 runs from local
    # training into the exchange; the last begins outside every phase.
    assert got["dfl:prepare"] == pytest.approx(
        {"dfl:prepare": 8e-6, "dfl:init": 4e-6, "dfl:draws": 3e-6,
         "dfl:local_train": 5e-6})
    assert got["cudaMemcpyAsync"] == pytest.approx(
        {"dfl:fetch": 10e-6, "-": 2e-6})
    assert got["dfl:local_train"] == pytest.approx(
        {"dfl:local_train": 10e-6, "dfl:exchange": 2e-6})
    assert got["dfl:call"] == pytest.approx({"-": 6e-6})
    assert sum(sum(v.values()) for v in got.values()) == pytest.approx(
        62e-6)
    assert spans.idle_by_op(trace) == {}      # every name under 1 ms


def test_eval_ms_reads_the_kernels_launched_in_the_evaluation(trace):
    # Both evaluation kernels, the engine thread's too: 58..72 over two
    # scenario-rounds.
    assert [op.name for op in trace.launched_in("dfl:eval")] == [
        "eval_fwd", "eval_loss"]
    assert _read("eval_ms", _ctx(trace)) == pytest.approx(14 / 1e3 / 2)


def test_idle_shares_split_the_device_idle_share(trace):
    ctx = _ctx(trace)
    train = _read("train_idle_pct", ctx)
    host = _read("host_idle_pct", ctx)
    device = _read("device_idle_pct", ctx)
    assert train == pytest.approx(15.0)
    # Everything idle outside local training, the exchange and the
    # evaluation: prepare, init, draws, fetch and outside every phase.
    assert host == pytest.approx(8 + 4 + 3 + 13 + OUTSIDE)
    assert device == pytest.approx(62.0)
    assert train + host <= device
    # The rest is the exchange's and the evaluation's idle time.
    assert device - train - host == pytest.approx(5 + 6)


def test_readers_read_nothing_without_the_programs_spans():
    # A program that opens no phase span of its own: only the benchmark's
    # ``dfl:call`` range is in its trace, and the benchmark opens no range
    # of a phase in the program's place.
    ev = [e for e in events() if e["name"] not in spans.PHASES]
    ctx = _ctx(Trace(ev, "dfl:call"))
    for name in ("eval_ms", "host_idle_pct", "train_idle_pct",
                 "local_train_ms", "layout_pct", "exchange_ms"):
        assert _read(name, ctx) is None, name
    assert _read("device_idle_pct", ctx) == pytest.approx(62.0)


@functools.lru_cache(maxsize=None)
def _counted(cell_name: str, seed: int) -> tuple[list[int], dict]:
    """The program's sample count over one round of a small model fed the
    shard sizes the cell deals on ``seed``."""
    from repro_torch.core import protocols
    from repro_torch.data.synthetic import FederatedDataset
    from repro_torch.fl import simulator
    from repro_torch.models import smallnets

    cell = harness.load_json(harness.find("cells", cell_name))
    n = cell["clients"]
    sizes = traffic.client_sizes(cell["samples_per_client"], n, seed)
    rng = np.random.default_rng(seed)
    data = FederatedDataset(
        [rng.normal(size=(s, 4)).astype(np.float32) for s in sizes],
        [rng.integers(0, 3, size=s).astype(np.int32) for s in sizes],
        rng.normal(size=(2, 4)).astype(np.float32),
        np.zeros(2, np.int32))
    sim = simulator.build_sim(
        functools.partial(smallnets.init_mlp_clf, d_in=4, d_hidden=4,
                          n_classes=3),
        smallnets.apply_mlp_clf, data, seg_len=64,
        local_epochs=cell["local_epochs"], n_rounds=1, device="cpu")
    before = dict(simulator.SAMPLE_PASSES)
    sim.run_scenario(simulator.Scenario(
        link_eps=torch.ones(n, n), seed=seed,
        protocol_id=protocols.PROTOCOL_IDS["none"],
        mode_id=protocols.MODE_IDS["ra_normalized"], aggregator=0, lr=0.1))
    return sizes, {k: v - before.get(k, 0)
                   for k, v in simulator.SAMPLE_PASSES.items()}


@pytest.mark.parametrize("cell", harness.names("cells"))
def test_padding_pct_is_the_shards_padding(cell, trace, monkeypatch):
    from repro_torch.fl import simulator

    seed = 2 ** 31 + 7
    sizes, counts = _counted(cell, seed)
    monkeypatch.setattr(simulator, "SAMPLE_PASSES", counts)
    want = 100.0 * (1 - sum(sizes) / (len(sizes) * max(sizes)))
    assert _read("padding_pct", _ctx(trace)) == pytest.approx(want,
                                                              abs=1e-9)
    # No count, or nothing run on the device: nothing to read.
    monkeypatch.setattr(simulator, "SAMPLE_PASSES", {})
    assert _read("padding_pct", _ctx(trace)) is None
    monkeypatch.setattr(simulator, "SAMPLE_PASSES", counts)
    bare = [e for e in events() if e["cat"] == "user_annotation"]
    assert _read("padding_pct", _ctx(Trace(bare, "dfl:call"))) is None
