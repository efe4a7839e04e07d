"""The trace reader and each per-layer reader on a hand-made Kineto trace,
and K1's byte bound from launch shapes."""
import json

import pytest

from dfl_bench import harness
from dfl_bench.devtrace import Trace, union

MAIN, ENGINE = 100, 200


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _kernel(name, ts, dur, corr, launch_ts, tid=MAIN):
    return [_x("cuda_runtime", "cudaLaunchKernel", launch_ts, 1, tid,
               correlation=corr),
            _x("kernel", name, ts, dur, 7, correlation=corr)]


def events():
    # The call: 0..100 us on the main thread.  Local training's range
    # 10..40 launches a forward kernel from the main thread and a backward
    # one from the autograd engine's thread; the exchange 50..60 launches
    # K1; a copy at 70 is launched outside every range.
    ev = [_x("user_annotation", "dfl:call", 0, 100),
          _x("user_annotation", "dfl:local_train", 10, 30),
          _x("cpu_op", "aten::conv", 11, 5),
          _x("user_annotation", "dfl:exchange", 50, 10),
          _x("cpu_op", "aten::item", 80, 15),
          _x("gpu_user_annotation", "dfl:local_train", 12, 20, 7)]
    ev += _kernel("conv_fwd", 12, 10, 1, 11)
    ev += _kernel("nchwToNhwcKernel", 22, 5, 2, 20, tid=ENGINE)
    ev += _kernel("void ra_reg_kernel<float, 10>", 52, 4, 3, 51)
    ev += _kernel("direct_copy_kernel", 70, 6, 4, 65)
    ev.append(_x("gpu_memset", "Memset", 26, 2, 7, correlation=9))
    return ev


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events()}))
    return Trace.load(path, "dfl:call")


def test_union_and_busy(trace):
    assert union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert trace.window == (0, 100)
    assert trace.busy_us == 10 + 5 + 2 + 4 + 6 - 1   # conv 12-22, 22-27
    assert [op.name for op in trace.launched_in("dfl:local_train")] == [
        "conv_fwd", "nchwToNhwcKernel"]
    assert [op.name for op in trace.launched_in("dfl:exchange")] == [
        "void ra_reg_kernel<float, 10>"]
    assert trace.launched_in("no-such-range") == []


def test_breakdown(trace):
    assert trace.top_ops(2) == [["conv_fwd", 10e-6],
                                ["direct_copy_kernel", 6e-6]]
    gaps = dict(trace.idle_gaps())
    # Idle 0..12 and 76..100 begin in the call's range alone, 28..52 in
    # local training's, 56..70 in the exchange's.
    assert gaps == pytest.approx({"dfl:call": 36e-6,
                                  "dfl:local_train": 24e-6,
                                  "dfl:exchange": 14e-6})


def _ctx(trace, **over):
    kw = dict(trace=trace, scenario_rounds=2, flops=1e6,
              k1_launches={(1, 10, 2, 8): 1}, peak_flops=1e12,
              peak_bytes_per_s=1e9, value_bytes=4)
    kw.update(over)
    return harness.TraceContext(**kw)


def test_readers(trace):
    read = {n: harness.metric_reader(n)(_ctx(trace))
            for n in harness.names("metrics")}
    assert read["local_train_ms"] == pytest.approx(15 / 1e3 / 2)
    assert read["exchange_ms"] == pytest.approx(4 / 1e3 / 2)
    assert read["layout_pct"] == pytest.approx(100 * 5 / 15)
    assert read["device_idle_pct"] == pytest.approx(100 - 26)
    assert read["step_mfu"] == pytest.approx(100 * 1e6 / 100e-6 / 1e12)
    moved = 2 * 10 * 2 * 8 * 4 + 10 * 10 * 2 + 40
    assert read["k1_roofline_pct"] == pytest.approx(
        100 * moved / 1e9 / 4e-6)


def test_readers_find_nothing_and_say_so(trace):
    bare = _ctx(trace, k1_launches={}, peak_flops=None,
                peak_bytes_per_s=None)
    assert harness.metric_reader("k1_roofline_pct")(bare) is None
    assert harness.metric_reader("step_mfu")(bare) is None
    empty = Trace([_x("user_annotation", "dfl:call", 0, 10)], "dfl:call")
    for name in harness.names("metrics"):
        assert harness.metric_reader(name)(_ctx(empty)) is None, name


def test_k1_bytes():
    from importlib import util

    spec = util.spec_from_file_location(
        "k1", harness.find("metrics", "k1_roofline_pct"))
    k1 = util.module_from_spec(spec)
    spec.loader.exec_module(k1)
    # grid12's launch: B = 4 scenarios, 10 clients, 802 segments of 1,024
    # float32 values: w read and written once, a bool mask, p shared.
    assert k1.launch_bytes(4, 10, 802, 1024, 4) == (
        2 * 4 * 10 * 802 * 1024 * 4 + 4 * 100 * 802 + 40)
