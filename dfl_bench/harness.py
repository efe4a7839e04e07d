"""One run of one cell of the port's benchmark: set-up, the measured
window, the per-layer trace, and the comparison with the plain reference.

Every cell drives `repro_torch.fl.scenarios.GridRunner.run` over its grid:
each call is a sweep of ``rounds_per_call`` rounds from fresh weights, and
calls repeat, each with new scenario seeds (`traffic.call_seeds`), until
``--seconds`` have passed; the window closes at the end of the call that
crosses it.  Set-up (imports, the card, K1's library, data, the runner and
one warm-up call of the same grid) ends where the first timed call starts.

With ``--trace 1`` the window's first call (``dfl:call``) runs under
`torch.profiler`, where the program opens its own phase spans
(``dfl:local_train``, ``dfl:exchange``, ``dfl:eval``...); its Chrome
trace, written under ``dfl_bench/out/``, feeds the per-layer readers in
``dfl_bench/metrics/``.

After the window (and after the peak memory is read and the runner freed),
one call drawn from the seed is compared, one scenario of each protocol
drawn from the seed, with the plain reference (`reference.sweep`) run from
the same data, link matrices, weights and scenario seeds.

Files are found by name: the cell ``dfl_bench/cells/<workload>.json``, its
configuration ``dfl_bench/configs/<config>.json``, each per-layer metric's
reader ``dfl_bench/metrics/<name>.py``; `BENCHMARK.json` says which
metrics a cell reports.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import flops as flop_count
from . import reference, traffic
from .devtrace import Trace
from .reference import sweep

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
OUT_DIR = BENCH_DIR / "out"
# Top-level modules that may not be loaded in the process that prints a
# result (compared whole: the port's name begins with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
END_TO_END = ("scenario_rounds_per_s", "mfu", "peak_mem_gib", "setup_s")
# The numbers `compare` reads (a cell's limits choose among them).
NUMBERS = ("loss_rel", "loss_rel_med", "acc_diff", "acc_flips")
GIB = 2 ** 30


# ---------------------------------------------------------------------------
# Finding files by name.
# ---------------------------------------------------------------------------
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(kind: str, name: str, root: Path = BENCH_DIR) -> Path:
    """The data file (``kind`` configs / cells) or reader (metrics) of
    ``name``."""
    suffix = ".py" if kind == "metrics" else ".json"
    path = root / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return path


def metric_reader(name: str, root: Path = BENCH_DIR):
    """The ``read(ctx)`` function of per-layer metric ``name``."""
    path = find("metrics", name, root)
    spec = importlib.util.spec_from_file_location(
        f"dfl_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def names(kind: str, root: Path = BENCH_DIR) -> list[str]:
    """Every configuration, cell or metric the folder holds, by name."""
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(p.name[:-len(suffix)] for p in (root / kind).glob(
        f"*{suffix}") if not p.name.startswith("_"))


@dataclasses.dataclass
class Cell:
    """A workload as the run needs it: its cell file, its configuration,
    and its entries of `BENCHMARK.json`."""

    workload: dict
    cell: dict
    config: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_cell(workload: str, *, bench_path: Path = ROOT / "BENCHMARK.json",
              root: Path = BENCH_DIR) -> Cell:
    bench = load_json(bench_path)
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload named {workload!r} in {bench_path.name}")
    wl = entries[0]
    cell = load_json(find("cells", workload, root))
    config = load_json(find("configs", wl["config"], root))
    if (cell["config"], cell["traffic"]) != (wl["config"], wl["traffic"]):
        raise ValueError(f"cell {workload!r} names {cell['config']!r} / "
                         f"{cell['traffic']!r}; {bench_path.name} names "
                         f"{wl['config']!r} / {wl['traffic']!r}")

    def mine(metric):
        return workload in metric.get("workloads", (workload,))

    return Cell(wl, cell, config,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


# ---------------------------------------------------------------------------
# Inputs, from the seed.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Inputs:
    """Everything both sides are handed: host copies of the data, the
    link matrix of each network point, and the initial weights."""

    sizes: list[int]
    train_x: list[np.ndarray]
    train_y: list[np.ndarray]
    test_x: np.ndarray
    test_y: np.ndarray
    links: list[tuple[str, traffic.Link]]
    weights: traffic.Weights
    layout: list

    @property
    def test_count(self) -> int:
        """Test predictions a client's accuracy is taken over."""
        return int(self.test_y.size)

    @property
    def test_samples(self) -> int:
        """Test images or sequences a client's evaluation runs on."""
        return len(self.test_x)


def make_inputs(c: Cell, seed: int, device: torch.device) -> Inputs:
    cell, config = c.cell, c.config
    sizes = traffic.client_sizes(cell["samples_per_client"], cell["clients"],
                                 seed)
    data = traffic.make_data(config["data"], sizes, seed, device)
    host = lambda t: t.cpu().numpy()     # noqa: E731
    net = cell["network"]
    links = [(f"p{dbm:g}", traffic.network(
        net["coords"], edge_density=net["edge_density"],
        packet_len_bits=net["packet_len_bits"], tx_power_dbm=dbm))
        for dbm in net["tx_power_dbm"]]
    layout = reference.model(config["reference"]).layout(
        config["model"]["init"])
    return Inputs(sizes, [host(x) for x in data.train_x],
                  [host(y) for y in data.train_y], host(data.test_x),
                  host(data.test_y), links,
                  traffic.Weights(scaled(layout, config.get("init_scales")),
                                  seed, device), layout)


def scaled(layout: list, scales: dict | None) -> list:
    """The layout with each leaf's init std times the configuration's
    ``init_scales`` entry for the last dotted part of its name (1 where
    none is given); a leaf's constant offset, its entry's fourth element
    where it has one, is carried as it is."""
    scales = scales or {}
    return [(name, shape, std * scales.get(name.rsplit(".", 1)[-1], 1.0),
             *rest) for name, shape, std, *rest in layout]


def grid_rows(cell: dict, seeds: list[int]) -> list[tuple[int, int, int]]:
    """(network point, protocol, seed) of each grid row, in the order of
    `ScenarioGrid.product` (networks, then protocols, then seeds)."""
    return [(i, j, s) for i in range(len(cell["network"]["tx_power_dbm"]))
            for j in range(len(cell["protocols"])) for s in seeds]


def scenarios_per_call(cell: dict) -> int:
    return (len(cell["network"]["tx_power_dbm"]) * len(cell["protocols"])
            * cell["seeds_per_point"])


# ---------------------------------------------------------------------------
# The program under test.
# ---------------------------------------------------------------------------
class Program:
    """`GridRunner` bound to the cell's model, data and statics."""

    def __init__(self, c: Cell, inputs: Inputs, device: torch.device, *,
                 rounds: int | None = None):
        from repro_torch.core import topology
        from repro_torch.data.synthetic import FederatedDataset
        from repro_torch.fl import scenarios, simulator
        from repro_torch.models import registry

        cell, model = c.cell, c.config["model"]
        sim_model = registry.sim_model(model["sim_model"])
        like = sim_model.init_fn(torch.Generator().manual_seed(0),
                                 **model["init"])
        mine = [(n, tuple(s)) for n, s, *_ in inputs.layout]
        theirs = [(n, tuple(t.shape)) for n, t in like.items()]
        if mine != theirs:
            raise RuntimeError(
                f"the port's {model['sim_model']} leaves differ from the "
                f"reference layout: {theirs[:4]}... vs {mine[:4]}...")
        self._scenarios = scenarios
        self.cell = cell
        self.networks = [
            (label, topology.Network(
                coords=torch.from_numpy(link.coords).to(torch.float32),
                adjacency=torch.from_numpy(link.adjacency),
                link_eps=link.link_eps, n_clients=cell["clients"],
                packet_len_bits=link.packet_len_bits,
                tx_power_dbm=link.tx_power_dbm))
            for label, link in inputs.links]
        data = FederatedDataset(inputs.train_x, inputs.train_y,
                                inputs.test_x, inputs.test_y)
        cfg = simulator.SimConfig(
            seg_len=cell["seg_len"], local_epochs=cell["local_epochs"],
            n_rounds=rounds or cell["rounds_per_call"],
            aayg_mixes=cell["aayg_mixes"],
            eval_every=1)
        weights = inputs.weights
        self.runner = scenarios.GridRunner(
            lambda gen: weights(gen.initial_seed()), sim_model.apply_fn,
            data, cfg, device=device)

    def grid(self, seeds: list[int]):
        return self._scenarios.ScenarioGrid.product(
            networks=self.networks,
            protocols=[tuple(p) for p in self.cell["protocols"]],
            seeds=seeds, lrs=[self.cell["lr"]],
            aggregator=self.cell["aggregator"])

    def run(self, seeds: list[int]) -> dict[str, np.ndarray]:
        res = self.runner.run(self.grid(seeds))
        return {"acc": np.asarray(res.acc), "loss": np.asarray(res.loss)}


# ---------------------------------------------------------------------------
# The reference and the comparison.
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def float32_products(tf32: bool):
    """Matmuls and cuDNN convolutions in float32 (or, for the control, in
    TF32) while open."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def sample(c: Cell, seed: int, calls: int) -> tuple[int, list[int]]:
    """The call compared and, of each protocol, the one row of it
    compared; both drawn from the seed."""
    rng = traffic.sample_rng(seed)
    call = int(rng.integers(calls))
    rows = grid_rows(c.cell, list(range(c.cell["seeds_per_point"])))
    picked = []
    for j in range(len(c.cell["protocols"])):
        mine = [r for r, (_, jj, _) in enumerate(rows) if jj == j]
        picked.append(int(mine[rng.integers(len(mine))]))
    return call, picked


def reference_rows(c: Cell, inputs: Inputs, seeds: list[int],
                   rows: list[int], device: torch.device, *,
                   tf32: bool = False) -> dict[int, dict[str, np.ndarray]]:
    """The reference's acc and loss (rounds, N) of each row of a call."""
    cell = c.cell
    model = reference.model(c.config["reference"])
    shards = sweep.tile_shards(
        [torch.from_numpy(x).to(device) for x in inputs.train_x],
        [torch.from_numpy(y).to(device) for y in inputs.train_y],
        torch.from_numpy(inputs.test_x).to(device),
        torch.from_numpy(inputs.test_y).to(device))
    layout = grid_rows(cell, seeds)
    out = {}
    with float32_products(tf32):
        for r in rows:
            i, j, seed = layout[r]
            protocol, mode = cell["protocols"][j]
            res = sweep.run_scenario(
                model, inputs.weights(seed), shards,
                inputs.links[i][1].link_eps,
                seed=seed, protocol=protocol, mode=mode,
                aggregator=cell["aggregator"], lr=cell["lr"],
                epochs=cell["local_epochs"], rounds=cell["rounds_per_call"],
                seg_len=cell["seg_len"], mixes=cell["aayg_mixes"])
            out[r] = {k: v.numpy() for k, v in res.items()}
    return out


def _gap(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want|; 0 where both sides are not finite (a run that diverged
    on both), infinite where one side alone is."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    both = ~np.isfinite(got) & ~np.isfinite(want)
    with np.errstate(invalid="ignore", over="ignore"):
        gap = np.abs(got - want)
    return np.where(both, 0.0, np.nan_to_num(gap, nan=np.inf, posinf=np.inf))


def compare(got: dict[int, dict], want: dict[int, dict],
            test_count: int, loss_floor: float = 0.0) -> dict[str, float]:
    """Every number a cell may compare, widest over the rows, the clients
    and the rounds.

    ``loss_rel``: each client's train-loss gap over its reference loss, or
    over ``loss_floor`` where that is larger (a loss near zero reads its
    margins' rounding).  ``loss_rel_med``: the median client's
    ``loss_rel`` of a row and round (one client whose trajectory is
    sensitive does not move it; a change to every client's arithmetic
    does).  ``acc_diff``: the gap in right test predictions, widest over
    the clients.  ``acc_flips``: those gaps summed over every row, round
    and client (rounding flips a near-tied prediction now and then; a
    lower precision flips some in most client-rounds).  A cell's
    ``limits`` name the numbers it holds its runs to."""
    out = dict.fromkeys(NUMBERS, 0.0)
    for r, ref in want.items():
        loss = _gap(got[r]["loss"], ref["loss"])
        scale = np.abs(ref["loss"].astype(np.float64))
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = np.where(loss == 0, 0.0, loss / np.maximum(
                scale, max(loss_floor, 1e-30)))
        acc = _gap(np.rint(got[r]["acc"] * test_count),
                   np.rint(ref["acc"] * test_count))
        med = np.median(np.nan_to_num(rel, nan=np.inf), axis=-1)
        for name, gap in (("loss_rel", rel), ("loss_rel_med", med),
                          ("acc_diff", acc)):
            out[name] = max(out[name], float(np.nan_to_num(
                gap, nan=np.inf).max()))
        out["acc_flips"] += float(np.nan_to_num(acc, nan=np.inf).sum())
    return out


# ---------------------------------------------------------------------------
# A run.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TraceContext:
    """What a per-layer reader gets: the traced call's trace and counts."""

    trace: Trace
    scenario_rounds: int
    flops: float
    k1_launches: dict
    peak_flops: float | None       # None off the card
    peak_bytes_per_s: float | None
    value_bytes: int


@dataclasses.dataclass
class Run:
    cell: Cell
    device: torch.device
    setup_s: float
    window_s: float
    calls: int
    scenario_rounds: int
    flops: float
    memory_peak_bytes: int | None
    checks: dict[str, float]
    failed: int
    tf32: tuple[bool, bool]
    trace: TraceContext | None = None

    @property
    def correct(self) -> bool:
        limits = self.cell.cell["limits"]
        return (self.failed == 0
                and all(self.checks[k] <= limits[k] for k in limits)
                and not any(self.tf32))

    def limits(self) -> dict[str, dict[str, float]]:
        return {k: {"value": v, "limit": self.cell.cell["limits"][k]}
                for k, v in self.checks.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _k1_shapes() -> dict:
    from repro_torch.kernels import ra_aggregate

    return dict(ra_aggregate.SHAPE_LAUNCHES)


def run_cell(c: Cell, *, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> Run:
    """Set up, warm up, measure for ``seconds``, then compare."""
    cell, config = c.cell, c.config
    marks = [("card", time.perf_counter())]
    inputs = make_inputs(c, seed, device)
    marks.append(("inputs", time.perf_counter()))
    program = Program(c, inputs, device)
    marks.append(("runner", time.perf_counter()))
    per_call = scenarios_per_call(cell)
    # The warm-up: one round of the same grid through a runner bound alike
    # (every shape of a call; its later rounds repeat the first's).  The
    # profiler's first use in a process is slow: a traced run warms it too.
    warm = Program(c, inputs, device, rounds=1)
    with _profiler(device) if trace else contextlib.nullcontext():
        warm.run(traffic.call_seeds(seed, -1, cell["seeds_per_point"]))
        _sync(device)
    del warm
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start

    results, traced, ends = [], None, []
    t0 = time.perf_counter()
    while True:
        k = len(results)
        seeds = traffic.call_seeds(seed, k, cell["seeds_per_point"])
        if trace and k == 0:
            traced = _traced_call(program, seeds, c, device)
            results.append((seeds, traced[0]))
        else:
            results.append((seeds, program.run(seeds)))
        _sync(device)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    window_s = ends[-1]
    steps = [(name, t - prev) for (name, t), (_, prev)
             in zip(marks, [("start", t_start)] + marks)]
    print("dfl_bench: calls end at " + " ".join(f"{t:.4f}" for t in ends)
          + f" s; set-up {setup_s:.4f} s ("
          + ", ".join(f"{n} {d:.3f}" for n, d in steps) + ")",
          file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    # TF32 exists on the card alone.
    tf32 = ((torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
            if device.type == "cuda" else (False, False))
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    per_round = flop_count.scenario_round_flops(
        flop_count.forward_flops(config), inputs.sizes,
        cell["local_epochs"], inputs.test_samples)
    scenario_rounds = len(results) * per_call * cell["rounds_per_call"]
    call, rows = sample(c, seed, len(results))
    seeds, got = results[call]
    want = reference_rows(c, inputs, seeds, rows, device)
    got_rows = {r: {k: v[r] for k, v in got.items()} for r in rows}
    limits = cell["limits"]
    floor = cell.get("loss_floor", 0.0)
    numbers = compare(got_rows, want, inputs.test_count, floor)
    checks = {k: numbers[k] for k in limits}
    failed = sum(any(compare({r: got_rows[r]}, {r: want[r]},
                             inputs.test_count, floor)[k] > limits[k]
                     for k in limits) for r in rows)
    context = None
    if traced is not None:
        _, path, shapes = traced
        card = (flop_count.peaks(torch.cuda.get_device_name(device))
                if device.type == "cuda" else {"flops": {}})
        context = TraceContext(
            Trace.load(path, "dfl:call"), per_call * cell["rounds_per_call"],
            per_round * per_call * cell["rounds_per_call"], shapes,
            card["flops"].get(config["precision"]),
            card.get("hbm_bytes_per_s"),
            torch.empty((), dtype=getattr(torch, config["precision"]))
            .element_size())
    return Run(c, device, setup_s, window_s, len(results), scenario_rounds,
               per_round * scenario_rounds, peak, checks, failed, tf32,
               context)


def _profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _traced_call(program: Program, seeds, c: Cell, device: torch.device):
    """One call under the profiler: (results, trace path, K1 launches by
    shape)."""
    from torch.profiler import record_function

    before = _k1_shapes()
    _sync(device)
    with _profiler(device) as prof:
        with record_function("dfl:call"):
            out = program.run(seeds)
        _sync(device)
    after = _k1_shapes()
    shapes = {s: n - before.get(s, 0) for s, n in after.items()
              if n > before.get(s, 0)}
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / f"{c.name}.trace.json"
    prof.export_chrome_trace(str(path))
    return out, path, shapes


# ---------------------------------------------------------------------------
# The result line.
# ---------------------------------------------------------------------------
def device_record(run: Run) -> dict:
    """``device`` of the result line; refused off the card, where no
    device number exists."""
    if run.device.type != "cuda":
        raise RuntimeError("device metrics need a CUDA device: a CPU run "
                           "gives no device number")
    rec = {"platform": "gpu",
           "kind": torch.cuda.get_device_name(run.device),
           "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace is not None:
        rec["busy_s"] = run.trace.trace.busy_us / 1e6
        rec["window_s"] = run.trace.trace.window_us / 1e6
    return rec


def end_to_end(run: Run) -> dict[str, float]:
    """The cell's end-to-end values, by name."""
    device_record(run)      # refuses a CPU run
    card = flop_count.peaks(torch.cuda.get_device_name(run.device))
    peak = card["flops"][run.cell.config["precision"]]
    return {"scenario_rounds_per_s": run.scenario_rounds / run.window_s,
            "mfu": 100.0 * run.flops / run.window_s / peak,
            "peak_mem_gib": run.memory_peak_bytes / GIB,
            "setup_s": run.setup_s}


def result_line(run: Run) -> dict:
    if run.trace is None:
        values = end_to_end(run)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in run.cell.end_to_end}
    else:
        metrics = {}
        for m in run.cell.per_layer:
            value = metric_reader(m["name"])(run.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": run.correct,
            "attempted": run.calls * scenarios_per_call(run.cell.cell),
            "failed": run.failed, "metrics": metrics,
            "device": device_record(run)}
    if run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace.trace.top_ops(),
                             "idle_gaps": run.trace.trace.idle_gaps()}
    line["tf32"] = {"matmul": run.tf32[0], "cudnn": run.tf32[1]}
    line["checks"] = run.limits()
    return line


def loaded_forbidden() -> list[str]:
    """Forbidden top-level modules present in `sys.modules`."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN_MODULES))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    c = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("dfl_bench: no CUDA device; no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < c.workload["chips"]:
        print(f"dfl_bench: {c.name} needs {c.workload['chips']} cards, "
              f"{torch.cuda.device_count()} found; no result",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    from repro_torch import resolve_device   # TF32 off, as every entry point
    resolve_device(device)
    run = run_cell(c, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device=device, t_start=t_start)
    line = result_line(run)
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"dfl_bench: the run loaded {forbidden}; no result",
              file=sys.stderr)
        return 3
    if any(run.tf32):
        print(f"dfl_bench: TF32 was on (matmul, cudnn) = {run.tf32}",
              file=sys.stderr)
    for name, rec in line["checks"].items():
        print(f"check {name} {rec['value']!r} limit {rec['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0
