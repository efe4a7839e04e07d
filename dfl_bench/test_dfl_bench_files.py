"""BENCHMARK.json against the contract the harness is held to, discovery
of configurations, cells and metrics by name, each configuration's leaves
against the port's, and the import isolation of the benchmark's code."""
import ast
import json
import re
from pathlib import Path

import pytest
import torch

from dfl_bench import harness, reference

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = sorted(harness.BENCH_DIR.rglob("*.py"))


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["dfl_bench"]
    assert BENCH["command"] == ["python3", "dfl_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    for entry in (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                  + BENCH["per_layer"]):
        assert NAME.match(entry["name"]), entry["name"]
    for metric in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in (
            "lower", "higher")
    for metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    names = [e["name"] for e in BENCH["end_to_end"]]
    assert "setup_s" in names and set(names) <= set(harness.END_TO_END)
    for metric in BENCH["per_layer"]:
        assert metric["moves"] in names
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")


def test_every_name_is_found_by_name():
    cells = [w["name"] for w in BENCH["workloads"]]
    assert harness.names("cells") == sorted(cells)
    assert harness.names("configs") == sorted(c["name"]
                                              for c in BENCH["configs"])
    assert harness.names("metrics") == sorted(m["name"]
                                              for m in BENCH["per_layer"])
    for w in BENCH["workloads"]:
        c = harness.load_cell(w["name"])
        assert c.cell["name"] == w["name"] and w["chips"] == 1
        assert [m["name"] for m in c.end_to_end] == [
            m["name"] for m in BENCH["end_to_end"]]
        assert c.per_layer, w["name"]
        for metric in c.per_layer:
            assert callable(harness.metric_reader(metric["name"]))
    for config in BENCH["configs"]:
        path = harness.ROOT / config["file"]
        assert path == harness.find("configs", config["name"])
        assert harness.load_json(path)["reduced"] == config["reduced"]
    with pytest.raises(FileNotFoundError):
        harness.find("cells", "no-such-cell")


@pytest.mark.parametrize("name", harness.names("configs"))
def test_reference_layout_is_the_ports(name):
    from repro_torch.models import registry

    config = harness.load_json(harness.find("configs", name))
    model = config["model"]
    ports = registry.sim_model(model["sim_model"]).init_fn(
        torch.Generator().manual_seed(0), **model["init"])
    mine = reference.model(config["reference"]).layout(model["init"])
    assert [(n, tuple(s)) for n, s, *_ in mine] == [
        (n, tuple(t.shape)) for n, t in ports.items()]
    # The scales and offsets are the port's init's: compare each leaf's
    # spread, and its mean within five standard errors of the offset (a
    # leaf of ones: mean 1, spread 0).
    for n, _, std, *rest in mine:
        leaf = ports[n].double()
        got = float(leaf.std()) if leaf.numel() > 1 else 0.0
        assert (got == 0.0) if std == 0.0 else abs(got / std - 1) < 0.2, n
        offset = rest[0] if rest else 0.0
        assert abs(float(leaf.mean()) - offset) <= (
            5 * std / leaf.numel() ** 0.5 + 1e-6), n


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            found.add(str(node.args[0].value).split(".")[0])
    return found


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(harness.BENCH_DIR))
                              for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    # Whole top-level names: the port, repro_torch, begins with "repro".
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}
    # Nothing reads the JAX package's benchmark scripts or results.
    if path.name != Path(__file__).name:
        assert not re.search(r"benchmarks/|BENCH_\w*\.json",
                             path.read_text())


def test_reference_imports_nothing_of_the_port():
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        assert "repro_torch" not in _imports(path), path.name
        assert "dfl_bench" not in _imports(path), path.name


def test_forbidden_modules_are_compared_whole(monkeypatch):
    import sys
    import types

    # Other test files of this process may have loaded the JAX package.
    for name in [m for m in sys.modules
                 if m.split(".")[0] in harness.FORBIDDEN_MODULES]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "reprox", types.ModuleType("reprox"))
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert harness.loaded_forbidden() == ["repro"]
