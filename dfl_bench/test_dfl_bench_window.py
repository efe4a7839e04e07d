"""A whole run on the CPU at a small size: set-up, the window's calls, the
traced call, the reference and the comparison; the device numbers are
refused there, not faked.  And the result line's keys and order."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from dfl_bench import harness, testing

CPU = torch.device("cpu")


@pytest.mark.parametrize("kind", ["char", "image", "tokens"])
def test_cpu_run_is_correct_and_refuses_device_numbers(kind):
    c = testing.tiny_cell(kind)
    run = harness.run_cell(c, seed=2 ** 33 + 1, seconds=0.3, trace=False,
                           device=CPU, t_start=0.0)
    assert run.calls >= 1 and run.correct
    assert run.scenario_rounds == run.calls * 12 * 2
    assert set(run.checks) == set(c.cell["limits"])
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.result_line(run)
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.end_to_end(run)


def test_cpu_traced_run_reads_nothing_from_the_device():
    c = testing.tiny_cell("char", rounds_per_call=1)
    c.per_layer = [{"name": n, "unit": "%"} for n in harness.names("metrics")]
    run = harness.run_cell(c, seed=3, seconds=0.0, trace=True, device=CPU,
                           t_start=0.0)
    assert run.correct and run.calls == 1
    assert run.trace.trace.ops == [] and run.trace.k1_launches == {}
    for name in harness.names("metrics"):
        assert harness.metric_reader(name)(run.trace) is None


def test_result_line_keys(monkeypatch):
    c = harness.load_cell("charrnn.grid12")
    run = harness.Run(c, torch.device("cuda", 0), 12.5, 10.25, 4, 144,
                      1.5e14, 25 * 2 ** 30, {"loss_rel": 1e-7,
                                             "acc_flips": 0.0},
                      0, (False, False))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *_: "NVIDIA H100 80GB HBM3")
    line = harness.result_line(run)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "tf32", "checks"]
    assert line["correct"] and line["attempted"] == 48
    assert list(line["metrics"]) == [m["name"] for m in c.end_to_end]
    assert line["metrics"]["scenario_rounds_per_s"] == {
        "value": 144 / 10.25, "unit": "rounds/s"}
    assert line["metrics"]["peak_mem_gib"]["value"] == 25.0
    assert line["device"] == {"platform": "gpu",
                              "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 25 * 2 ** 30}
    assert line["checks"]["loss_rel"] == {
        "value": 1e-7, "limit": c.cell["limits"]["loss_rel"]}
    json.dumps(line)
    # TF32 on, or a number past its limit, is not correct.
    assert not harness.Run(**{**run.__dict__, "tf32": (True, False)}).correct
    assert not harness.Run(**{**run.__dict__, "checks": {
        "loss_rel": 1.0, "acc_flips": 0.0}}).correct


def test_cli_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
         "resnet56.ra", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_compare_counts_flips_over_rows_rounds_and_clients():
    # Two rows of two rounds by three clients over 100 test tokens: one
    # prediction flipped in row 0, and three clients of row 1 off by 1, 2
    # and 1 in its second round.
    want = {r: {"loss": np.full((2, 3), 4.5, np.float32),
                "acc": np.full((2, 3), 0.25, np.float32)} for r in (0, 1)}
    got = {r: {k: v.copy() for k, v in d.items()} for r, d in want.items()}
    got[0]["acc"][0, 1] += 0.01
    got[1]["acc"][1] += np.float32([0.01, -0.02, 0.01])
    numbers = harness.compare(got, want, 100)
    assert numbers["acc_diff"] == 2.0 and numbers["acc_flips"] == 5.0
    assert numbers["loss_rel"] == 0.0
    assert harness.compare(want, want, 100)["acc_flips"] == 0.0
