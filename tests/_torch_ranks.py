"""Rank bodies for the port's multi-rank tests (tests/test_torch_dfl_step.py,
tests/test_torch_mesh.py, tests/test_torch_model_shards.py).

`repro_torch.launch.mesh.spawn` starts one process per rank, each running
one of these module-level functions on gloo CPU ranks (or ranks sharing
the card, in tests/test_torch_cuda.py); the child imports this module by
name, so it imports neither JAX nor the reference package.  Each function
returns picklable host values for the parent to hold against the
reference.
"""
import dataclasses
import os
import tempfile
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint
from repro_torch.core import dfl_step, topology
from repro_torch.data import synthetic
from repro_torch.fl import scenarios, simulator
from repro_torch.launch import mesh
from repro_torch.models import smallnets

COMMS = ("all_to_all", "reduce_scatter", "psum")
POLICIES = ("loss", "grad_norm")


# ---------------------------------------------------------------------------
# core/dfl_step
# ---------------------------------------------------------------------------
def _moving_step(state, batch):
    """The reference test's local step: client i moves by 0.01 * i a step
    (its update norm rises with i) while its loss signal falls with i."""
    moved = {k: v + 0.01 * state["loss"] for k, v in state["params"].items()}
    return dict(state, params=moved), {"loss": 7.0 - state["loss"]}


def dfl_exchange_rank(rank: int, inp: dict, device: str = "cpu") -> dict:
    """Every `ra_exchange` case (3 comms x with / without the
    participation mask) and one `make_dfl_train_step` round per policy
    (2 local steps of `_moving_step`), this rank's rows."""
    dev = torch.device(device)

    def t(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    mine = {k: t(inp[k][rank]) for k in ("w", "b")}
    p, rho, u, mask = t(inp["p"]), t(inp["rho"]), t(inp["u"]), t(inp["mask"])
    seg_len = int(inp["seg_len"])
    out = {"input": {k: v.cpu().numpy() for k, v in mine.items()}}
    mesh.reset_counters()
    for comm in COMMS:
        for mname, part in (("none", None), ("mask", mask)):
            got = dfl_step.ra_exchange(mine, p, rho, seg_len=seg_len,
                                       comm=comm, participation=part, u=u)
            out[f"exchange/{comm}/{mname}"] = {
                k: v.cpu().numpy() for k, v in got.items()}
            out[f"dtypes/{comm}/{mname}"] = {k: str(v.dtype)
                                             for k, v in got.items()}
    out["wire_bytes"] = dict(mesh.WIRE_BYTES)
    for policy in POLICIES:
        fn = dfl_step.make_dfl_train_step(
            _moving_step, p=p, seg_len=seg_len, n_local_steps=2,
            selection_policy=policy, select_frac=0.5)
        state = {"params": dict(mine),
                 "loss": torch.tensor(float(rank), device=dev)}
        new, metrics = fn(state, None, rho, u=u)
        out[f"dfl/{policy}"] = {k: v.cpu().numpy()
                                for k, v in new["params"].items()}
        trained = _moving_step(_moving_step(state, None)[0], None)[0]
        out[f"moved/{policy}"] = {k: v.cpu().numpy()
                                  for k, v in trained["params"].items()}
        out[f"metrics/{policy}"] = metrics["loss"].cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# launch/mesh
# ---------------------------------------------------------------------------
def mesh_builders_rank(rank: int) -> dict:
    """The builders, their errors and fingerprints, coordinates, the
    shrunk mesh and `gather_along`'s order, on 4 CPU ranks."""
    out = {}
    m1 = mesh.grid_mesh(4, device="cpu")
    m2 = mesh.grid_model_mesh(None, model_shards=2, device="cpu")
    m21 = mesh.grid_model_mesh(4, model_shards=1, device="cpu")
    again = mesh.grid_model_mesh(4, model_shards=2, device="cpu")
    shuffled = mesh.grid_model_mesh([3, 1, 2, 0], model_shards=2,
                                    device="cpu")
    sub = mesh.grid_mesh([1, 2], device="cpu")
    out["axes"] = (m1.axis_names, m2.axis_names)
    out["shapes"] = (m1.shape, m2.shape, m21.shape)
    out["coords"] = (m1.coords, m2.coords, shuffled.coords, sub.coords)
    out["same_object"] = again is m2
    fps = [mesh.mesh_fingerprint(m) for m in (m1, m2, m21, shuffled, sub)]
    out["fingerprints_distinct"] = len(set(fps)) == len(fps)
    out["fingerprint_stable"] = mesh.mesh_fingerprint(again) == fps[1]
    errors = {}
    for name, call in (
            ("model_shards=0",
             lambda: mesh.grid_model_mesh(4, model_shards=0, device="cpu")),
            ("3 % 2", lambda: mesh.grid_model_mesh(3, model_shards=2,
                                                   device="cpu")),
            ("5 > world", lambda: mesh.grid_mesh(5, device="cpu"))):
        try:
            call()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    shrunk = m2.first_rows(1)
    out["shrunk"] = (shrunk.shape, shrunk.coords,
                     mesh.mesh_fingerprint(shrunk) != fps[1])
    # gather_along in coordinate order, whatever the ranks' order.
    group, fiber = shuffled.axis_group(mesh.MODEL_AXIS)
    me = torch.full((2, 1, 3), float(rank))
    out["gathered"] = mesh.gather_along(me, 1, group, fiber)[0, :, 0].tolist()
    out["fiber"] = fiber
    out["sub_member"] = sub.group is not None
    return out


def failing_rank(rank: int) -> None:
    """Rank 1 raises; the parent must see its exception."""
    if rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    dist.barrier()


# ---------------------------------------------------------------------------
# build_sim(model_shards) / run_grid / run_resumable
# ---------------------------------------------------------------------------
N = 4
STATICS = dict(seg_len=64, local_epochs=2, n_rounds=3)


def toy(weights: dict | None = None, link_eps: np.ndarray | None = None):
    """The tests' toy: 4 clients of 20 samples, a 32-8-8-10 MLP (S = 7
    segments of 64), Table II's first 4 nodes (``link_eps``: the
    reference network's links); ``init_fn`` hands out the given weights by
    seed, or draws them."""
    data = synthetic.fed_image_classification(n_clients=N,
                                              samples_per_client=20)
    net = topology.make_network(
        topology.TABLE_II_COORDS[:N], edge_density=0.8,
        packet_len_bits=20_000, n_clients=N, tx_power_dbm=17.0)
    if link_eps is not None:
        net = dataclasses.replace(net, link_eps=torch.from_numpy(link_eps))

    def init_fn(g):
        if weights is not None:
            return {k: torch.from_numpy(v)
                    for k, v in weights[g.initial_seed()].items()}
        return smallnets.init_mlp_clf(g, d_in=32, d_hidden=8)

    return data, net, init_fn


SCENARIOS = {
    "ra_codec_loss": (dict(protocol="ra"), dict(
        sampling_policy="loss", select_frac=0.5, codec="quant",
        compress_ratio=0.5)),
    "aayg": (dict(protocol="aayg", mode="substitution"), {}),
    "cfl": (dict(protocol="cfl", cfl_aggregator=1), {}),
    "ra_part": (dict(protocol="ra"), dict(
        participation=np.array([1, 0, 1, 1], np.float32))),
}


def scenario_of(module, net, name: str):
    """A scenario the sharded runs replay (`SCENARIOS`: R&A with the quant
    codec and the `loss` policy, AaYG with substitution, C-FL at
    aggregator 1, R&A with a participation mask), built by ``module``'s
    `make_scenario` (the port's simulator or the reference's)."""
    cfg_kw, kw = SCENARIOS[name]
    cfg = module.SimConfig(seed=3, **STATICS, **cfg_kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return module.make_scenario(net, cfg, **kw)


def _sim(init_fn, data, dm, m, device):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return simulator.build_sim(
            init_fn, smallnets.apply_mlp_clf, data, agg_impl="kernel",
            device=device, model_shards=dm, mesh=m, **STATICS)


def replay_rank(rank: int, dm: int, weights: dict, link_eps: np.ndarray,
                draws: dict, device: str = "cpu") -> dict:
    """Each scenario of ``draws`` through a ``model_shards=dm`` sim (every
    rank one shard), chunk by chunk with the given round draws
    (``draws[name] = (u list, u_codec list or None)``), and then through
    `run_scenario` with its own draws; returns the full rows after every
    chunk, the metrics, the window's shape and `run_scenario`'s
    metrics."""
    data, net, init_fn = toy(weights, link_eps)
    m = mesh.grid_model_mesh(None, model_shards=dm, device=device)
    sim = _sim(init_fn, data, dm, m, device)
    out = {"l_local": sim.local_segments, "n_segments": sim.n_segments}
    for name, (us, ucs) in draws.items():
        sc = scenario_of(simulator, net, name).prepare()
        state = sim.init_scan(sc)
        rows, mets = [], []
        for c in range(sim.n_chunks):
            state, met = sim.advance_chunk(
                state, sc, u=[torch.from_numpy(us[c])],
                u_codec=None if ucs is None else [torch.from_numpy(ucs[c])])
            rows.append(sim.full_rows(state["w"]).cpu().numpy())
            mets.append({k: v.cpu().numpy() for k, v in met.items()})
        run = sim.run_scenario(sc)
        out[name] = {"rows": rows, "metrics": mets,
                     "window": tuple(state["w"].shape),
                     "run": {k: v.numpy() for k, v in run.items()}}
    return out


def grid_and_resume_rank(rank: int, ckpt_dir: str,
                         device: str = "cpu") -> dict:
    """On 4 ranks: a grid over a (2, 2) mesh (``devices=(None, 2)`` and
    ``sharding=``), a (2, 1) mesh and the 1-D mesh of all four, the
    closed-loop `policy_grid_of` over the (2, 2) mesh, and
    `run_resumable` on a (1, 2) mesh of ranks 0 and 1 — unbroken, stopped
    after one chunk and resumed, and resumed from a checkpoint that a
    single process wrote after one chunk (``ckpt_dir/single``)."""
    from repro_torch.kernels import ops

    data, net, init_fn = toy()
    grid = grid_of(net)
    cfg = simulator.SimConfig(agg_impl="kernel", **STATICS)
    out = {"k1": {}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runs = {str(spec): dict(devices=spec)
                for spec in ((None, 2), (2, 1), [0, 1, 2, 3])}
        runs["sharding"] = dict(sharding=mesh.grid_model_mesh(
            None, model_shards=2, device=device))
        for name, kw in runs.items():
            ops.LAUNCHES["ra_aggregate"] = 0
            res = scenarios.run_grid(init_fn, smallnets.apply_mlp_clf, data,
                                     grid, cfg, device=device, **kw)
            out["k1"][name] = ops.LAUNCHES["ra_aggregate"]
            out[name] = (None if res is None else
                         (res.labels, res.acc, res.loss, res.bias))
        ops.LAUNCHES["ra_aggregate"] = 0
        res = scenarios.run_grid(init_fn, smallnets.apply_mlp_clf, data,
                                 policy_grid_of(net), cfg, device=device,
                                 devices=(None, 2))
        out["k1"]["policy"] = ops.LAUNCHES["ra_aggregate"]
        out["policy"] = (res.labels, res.acc, res.loss, res.bias,
                         res.selected)
        pair = mesh.grid_model_mesh([0, 1], model_shards=2, device=device)
    if pair.coords is None:
        return out
    sim = _sim(init_fn, data, 2, pair, device)
    sc = scenario_of(simulator, net, "ra_codec_loss")
    mine = os.path.join(ckpt_dir, "ranks")
    out["unbroken"] = checkpoint.run_resumable(
        sim, sc, ckpt_dir=os.path.join(ckpt_dir, "unbroken"), mesh=pair)
    assert checkpoint.run_resumable(sim, sc, ckpt_dir=mine, stop_after=1,
                                    mesh=pair) is None
    out["resumed"] = checkpoint.run_resumable(sim, sc, ckpt_dir=mine,
                                              mesh=pair)
    out["from_single"] = checkpoint.run_resumable(
        sim, sc, ckpt_dir=os.path.join(ckpt_dir, "single"), mesh=pair)
    # A checkpoint of these ranks after one chunk, for a single process.
    assert checkpoint.run_resumable(
        sim, sc, ckpt_dir=os.path.join(ckpt_dir, "to_single"),
        stop_after=1, mesh=pair) is None
    for name, call in (
            ("no_mesh", lambda: checkpoint.run_resumable(
                sim, sc, ckpt_dir=tempfile.mkdtemp())),
            ("round_step", lambda: sim.round_step(
                {"params": {}}, scenario_of(simulator, net, "cfl")))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def grid_of(net):
    """Six scenarios in three dispatch groups of two seeds (R&A, AaYG,
    C-FL), so a (2, .) mesh gives each grid row one scenario a group."""
    return scenarios.ScenarioGrid.product(
        networks=[("n", net)],
        protocols=[("ra", "ra_normalized"), ("aayg", "substitution"),
                   ("cfl", "ra_normalized")],
        seeds=[0, 1], aggregator=1)


def policy_grid_of(net):
    """Six closed-loop R&A scenarios: the `loss` and `grad_norm` policies
    at select_frac 0.5 x three seeds, one dispatch group a policy (each
    padded to four rows on a 2-row mesh)."""
    return scenarios.ScenarioGrid.product(
        networks=[("n", net)], protocols=[("ra", "ra_normalized")],
        seeds=[0, 1, 2],
        sampling_policies=[("loss", "loss", 0.5), ("gn", "grad_norm", 0.5)])
