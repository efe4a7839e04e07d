"""Rank bodies for the port's multi-rank tests (tests/test_torch_dfl_step.py,
tests/test_torch_mesh.py, tests/test_torch_model_shards.py,
tests/test_torch_serving_ranks.py).

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
import threading
import time
import warnings
from concurrent.futures import CancelledError, wait

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
    shrunk mesh and `gather_along`'s order, on 4 CPU ranks; then grid runs
    whose share raises on one rank (`_contained_fault`): rank 1's over the
    1-D mesh, and rank 3's alone, mid-run, over the (2, 2) mesh."""
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
    out["contained"] = {
        "grid": _contained_fault([0, 1, 2, 3], lambda: _raise_in_share(
            [1], "rank 1's share raised")),
        "grid_model": _contained_fault(([0, 1, 2, 3], 2), lambda:
                                       _raise_in_gather(3, at=2))}
    return out


def _raise_in_share(ranks, what: str = "planted in a share", calls: int = 1,
                    sleep_s: float = 0.0):
    """On the ranks ``ranks``: the next ``calls`` shares of a multi-rank
    grid run (`scenarios._take_rows`, inside the share, before any
    collective) raise RuntimeError(``what``), or with ``sleep_s`` sleep
    that long first and then run."""
    if dist.get_rank() not in ranks:
        return
    orig = scenarios._take_rows
    left = [calls]

    def take_rows(*args):
        if left[0] > 0:
            left[0] -= 1
            if sleep_s:
                time.sleep(sleep_s)
            else:
                raise RuntimeError(what)
        return orig(*args)

    scenarios._take_rows = take_rows


def _raise_in_gather(rank: int, at: int) -> None:
    """On ``rank``: its ``at``-th `launch.mesh.gather_along` from now (the
    model group's all-gather of a sharded sim's rows) raises
    RuntimeError before it reaches the collective, once."""
    if dist.get_rank() != rank:
        return
    orig = mesh.gather_along
    calls = [0]

    def gather_along(*args):
        calls[0] += 1
        if calls[0] == at:
            mesh.gather_along = orig
            raise RuntimeError(f"rank {rank} failed mid-run")
        return orig(*args)

    mesh.gather_along = gather_along


def _contained_fault(devices, plant) -> dict:
    """`GridRunner.run` of `grid_of` over the mesh ``devices`` names with
    the fault ``plant`` sets up: every rank's error, then a second run of
    the same grid."""
    data, net, init_fn = toy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runner = scenarios.GridRunner(
            init_fn, smallnets.apply_mlp_clf, data,
            simulator.SimConfig(agg_impl="kernel", **STATICS),
            device="cpu", devices=devices)
        plant()
        try:
            runner.run(grid_of(net))
            error = None
        except mesh.RankFailed as e:
            error = (type(e).__name__, str(e), e.rank)
        res = runner.run(grid_of(net))
    return {"error": error, "again": (res.labels, res.acc, res.loss)}


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


# ---------------------------------------------------------------------------
# launch/serving and launch/router over ranks
# ---------------------------------------------------------------------------
SERVE_STATICS = dict(n_rounds=2, local_epochs=1, seg_len=64)
SERVE_SPECS = {"grid": [0, 1, 2, 3], "grid_model": ([0, 1, 2, 3], 2)}
SERVE_WAIT_S = 120.0


def serving_toy(weights: dict | None = None):
    """The reference's serving toy (tests/test_serving.py `_setup`): 3
    clients of 20 samples, a 32-16 MLP, two Table II networks of 2,048-bit
    packets at edge densities 0.6 and 0.8; ``init_fn`` hands out the given
    weights by seed, or draws them."""
    data = synthetic.fed_image_classification(n_clients=3,
                                              samples_per_client=20, seed=0)
    nets = [topology.make_network(
        topology.TABLE_II_COORDS[:3], edge_density=d, packet_len_bits=32 * 64,
        n_clients=3, tx_power_dbm=17.0) for d in (0.6, 0.8)]

    def init_fn(g):
        if weights is not None:
            return {k: torch.from_numpy(v)
                    for k, v in weights[g.initial_seed()].items()}
        return smallnets.init_mlp_clf(g, d_in=32, d_hidden=16)

    cfg = simulator.SimConfig(agg_impl="kernel", **SERVE_STATICS)
    return data, nets, init_fn, cfg


def sure_links(link_eps: np.ndarray) -> np.ndarray:
    """Delivery probabilities rounded to 0 or 1: the channel's draws then
    decide nothing, so two packages drawing differently agree."""
    return (np.asarray(link_eps) > 0.5).astype(np.float32)


def serving_requests(nets, sure: bool = False) -> list:
    """The reference's `_serving_shard_check` requests (R&A, AaYG, R&A at
    seed 3, on two networks); ``sure``: on the networks' `sure_links`."""
    if sure:
        nets = [dataclasses.replace(n, link_eps=torch.from_numpy(
            sure_links(n.link_eps))) for n in nets]
    return [scenarios.ScenarioGrid.product(
        networks=[(lbl, net)], protocols=[(proto, "ra_normalized")],
        seeds=[seed])
        for net, proto, lbl, seed in ((nets[0], "ra", "r0", 0),
                                      (nets[1], "aayg", "r1", 0),
                                      (nets[1], "ra", "r2", 3))]


def _rows(res) -> tuple:
    return (res.labels, res.acc, res.loss, res.bias)


def _drawn_metrics(runner, grid, draws) -> dict:
    """``grid``'s dispatch groups through the sim `GridRunner.run` runs on
    this rank of ``runner``'s mesh (on a 2-D mesh a model shard of it),
    each scenario fed its round draws ``draws[label]`` (one array a
    chunk); every grid row runs every group.  Per label, each chunk's
    metrics."""
    sim = runner._sim_for(runner._mesh(scenarios._INHERIT, None))
    out = {}
    for idx in runner._index_groups(grid):
        axes, args = scenarios._hoist_uniform(grid.take(idx).scenarios)
        sb = sim.prepare_batch(args, axes)
        state = sim.init_scan_batch(sb)
        labels = [grid.labels[i] for i in idx]
        mets = []
        for c in range(sim.n_chunks):
            state, m = sim.advance_chunk_batch(state, sb, u=[
                [torch.from_numpy(draws[lbl][c])] for lbl in labels])
            mets.append({k: v.cpu().numpy() for k, v in m.items()})
        for j, lbl in enumerate(labels):
            out[lbl] = [{k: v[j] for k, v in m.items()} for m in mets]
    return out


def _share_from_leader(server, obj):
    """``obj`` from the leader of ``server``'s mesh on every rank of the
    default group."""
    box = [obj]
    dist.broadcast_object_list(box, src=server.mesh.leader)
    return box[0]


def _serve_parity(spec, toy_, draws) -> dict:
    """The reference's three requests, then the same on sure links, each
    set coalesced into one dispatch (max_batch 3), over ``spec``'s ranks
    after every rank's warmup of both coalesced grids; every rank then
    replays the dispatched grids over a mesh of the same ranks, and the
    first with the reference's round draws (`_drawn_metrics`)."""
    from _torch_serving_faults import install
    from repro_torch.launch import serving

    data, nets, init_fn, cfg = toy_
    sets = {"lossy": serving_requests(nets),
            "sure": serving_requests(nets, sure=True)}
    server = serving.ScenarioServer(
        init_fn, smallnets.apply_mlp_clf, data, cfg, device="cpu",
        devices=spec, serve=serving.ServeConfig(max_batch=3,
                                                max_delay_s=30.0))
    out = {"role": server.role}
    built = server.warmup(*(scenarios.ScenarioGrid.concat(*reqs)
                            for reqs in sets.values()))
    probe = install(server) if server.is_leader else None
    with server:
        if server.is_leader:
            for name, reqs in sets.items():
                out[name] = [_rows(r) for r in server.serve(reqs)]
        else:
            try:
                server.submit(sets["lossy"][0])
            except serving.NotLeader as e:
                out["not_leader"] = str(e)
    out["released_at"] = server.released_at
    out["built"] = built
    out["cache"] = dict(server.runner.programs.stats)
    ran = _share_from_leader(server, None if probe is None else probe.ran)
    out["dispatches"] = [(g.labels, pad) for g, pad in ran]
    replay = scenarios.GridRunner(init_fn, smallnets.apply_mlp_clf, data,
                                  cfg, device="cpu", devices=spec)
    out["replayed"] = [_rows(replay.run(g, pad_to=pad, validate=False))
                       for g, pad in ran]
    out["drawn"] = _drawn_metrics(replay, ran[0][0], draws)
    return out


def _serve_router(toy_) -> dict:
    """Two replicas over the (2, 2) mesh; the owner of the first request's
    family holds a dispatch and is killed after the first delivery (as
    chip_smoke.py's phase 17 does)."""
    from _torch_serving_faults import install, kill_replica
    from repro_torch.launch import router, serving

    data, nets, init_fn, cfg = toy_
    requests = serving_requests(nets) + [
        scenarios.ScenarioGrid.product(
            networks=[(f"s{seed}", nets[seed % 2])],
            protocols=[(proto, "ra_normalized")], seeds=[seed])
        for seed, proto in ((5, "ra"), (6, "aayg"), (7, "ra"))]
    serve_cfg = serving.ServeConfig(max_batch=2, batch_buckets=(2,),
                                    max_delay_s=0.05)
    rt = router.ScenarioRouter.in_process(
        init_fn, smallnets.apply_mlp_clf, data, cfg, n_replicas=2,
        serve=serve_cfg, device="cpu", devices=SERVE_SPECS["grid_model"],
        route=router.RouterConfig(max_attempts=4, backoff_base_s=0.01,
                                  breaker_cooldown_s=0.3, heartbeat_s=0.05,
                                  attempt_timeout_s=SERVE_WAIT_S))
    out = {"kind": type(rt).__name__}
    if isinstance(rt, router.FollowerRouter):
        rt.warmup(requests)
        with rt:
            pass
        out["released_at"] = {n: r.server.released_at
                              for n, r in rt.replicas.items()}
        return out
    victim = rt._ring.preference(router.grid_signature(requests[0]))[0]
    owned = sum(rt._ring.preference(router.grid_signature(r))[0] == victim
                for r in requests)
    hold_at = 1 if owned > serve_cfg.max_batch else 0
    release = threading.Event()
    probes = {}
    for name, rep in rt.replicas.items():
        plan = ({} if name != victim else dict(
            stall_on={hold_at: release},
            raise_on={hold_at: RuntimeError(f"{name} killed")}))
        probes[name] = install(rep.server, **plan)
    rt.warmup(requests)
    delivered = threading.Event()
    try:
        rt.start()
        futures = [rt.submit(r, tenant=f"t{i % 2}")
                   for i, r in enumerate(requests)]
        for f in futures:
            f.add_done_callback(lambda _f: delivered.set())
        assert delivered.wait(SERVE_WAIT_S)
        assert probes[victim].stalled.wait(SERVE_WAIT_S)
        kill_replica(rt.replicas[victim], release)
        out["killed_at"] = time.time()
        results = [f.result(timeout=SERVE_WAIT_S) for f in futures]
        out["stopping_at"] = time.time()
    finally:
        release.set()
        rt.stop(drain=False)
    snap = rt.tracker.snapshot()
    out.update(victim=victim, rows=[_rows(r) for r in results],
               requests=[r.labels for r in requests],
               counters={k: v for k, v in snap.items()
                         if k.startswith("router/")},
               served={n: snap.get(f"router/replica/{n}/served", 0)
                       for n in probes},
               ran={n: [g.labels for g, _ in p.ran]
                    for n, p in probes.items()})
    return out


def _serve_faults(spec, fault_rank, toy_) -> dict:
    """One request a dispatch (padded to 4 rows, so every rank of ``spec``
    runs a share): dispatch 0 raises on the leader before it fans out, the
    next raises inside the share of ``fault_rank`` alone (on the (2, 2)
    mesh its model peer waits for it in their first all-gather), the
    third is served."""
    from _torch_serving_faults import install
    from repro_torch.launch import serving

    data, nets, init_fn, cfg = toy_
    server = serving.ScenarioServer(
        init_fn, smallnets.apply_mlp_clf, data, cfg, device="cpu",
        devices=spec, serve=serving.ServeConfig(max_batch=1,
                                                batch_buckets=(4,)))
    out = {}
    if server.is_leader:
        install(server, raise_on={0: RuntimeError("planted on the leader")})
    _raise_in_share([fault_rank], f"rank {fault_rank}'s share raised")
    with server:
        if server.is_leader:
            outcomes = []
            for req in serving_requests(nets):
                try:
                    outcomes.append(("ok", _rows(
                        server.submit(req).result(timeout=SERVE_WAIT_S))))
                except Exception as e:
                    outcomes.append((type(e).__name__, str(e)))
            out["outcomes"] = outcomes
            out["errors"] = server.tracker.snapshot().get(
                "serve/dispatch_errors", 0)
    out["released_at"] = server.released_at
    if server.role == "follower":
        out["errors"] = server.tracker.snapshot().get(
            "serve/dispatch_errors", 0)
    return out


def _serve_stop(drain: bool, toy_) -> dict:
    """Three requests, one a dispatch, over the ('grid',) mesh of 4, and a
    stop while the first dispatch is in flight: with ``drain`` it is held
    on the leader before its fan-out (released once the stop began); a
    hard stop comes while rank 1's share of it sleeps inside the
    collectives' span."""
    from _torch_serving_faults import install
    from repro_torch.launch import serving

    data, nets, init_fn, cfg = toy_
    server = serving.ScenarioServer(
        init_fn, smallnets.apply_mlp_clf, data, cfg, device="cpu",
        devices=SERVE_SPECS["grid"],
        serve=serving.ServeConfig(max_batch=1, batch_buckets=(4,)))
    out = {}
    hold = threading.Event()
    probe = None
    if server.is_leader:
        probe = install(server, stall_on={0: hold} if drain else {})
    if not drain:
        _raise_in_share([1], sleep_s=2.0)
    server.start()
    if server.is_leader:
        futures = [server.submit(r) for r in serving_requests(nets)]
        began = time.monotonic()
        while probe.calls == 0:              # the first dispatch began
            assert time.monotonic() - began < SERVE_WAIT_S
            time.sleep(0.005)
        stopper = threading.Thread(target=server.stop,
                                   kwargs=dict(drain=drain))
        stopper.start()
        while not server._stopped:
            time.sleep(0.002)
        hold.set()
        stopper.join(SERVE_WAIT_S)
        out["stop_returned"] = not stopper.is_alive()
        done, pending = wait(futures, timeout=SERVE_WAIT_S)
        out["pending"] = len(pending)
        out["outcomes"] = [
            "ok" if f.exception() is None else type(f.exception()).__name__
            for f in futures]
        server._dispatcher.join(SERVE_WAIT_S)
        out["dispatched"] = probe.calls
    else:
        server.stop()
    out["released_at"] = server.released_at
    return out


def _serve_stress(seed: int, toy_) -> dict:
    """tests/test_serving_stress.py's property on one seed, over ranks 0
    and 1 (ranks 2 and 3 build the server and stay outside its mesh): a
    warmup before start, 3 threads racing 12 submits / cancels each
    against a stop in either drain mode."""
    from repro_torch.launch import serving

    data, nets, init_fn, _cfg = toy_
    cfg = simulator.SimConfig(agg_impl="kernel", n_rounds=1, local_epochs=1,
                              seg_len=64)
    net = topology.make_network(
        topology.TABLE_II_COORDS[:3], edge_density=0.7,
        packet_len_bits=32 * 64, n_clients=3, tx_power_dbm=17.0)
    grids = [scenarios.ScenarioGrid.product(
        networks=[("net", net)], protocols=[("ra", "ra_normalized")],
        seeds=[s]) for s in range(4)]
    rng = np.random.default_rng(seed)
    server = serving.ScenarioServer(
        init_fn, smallnets.apply_mlp_clf, data, cfg, device="cpu",
        devices=[0, 1], serve=serving.ServeConfig(
            max_batch=int(rng.integers(1, 5)),
            max_delay_s=float(rng.uniform(0.0, 0.02)),
            tenant_weights={"alice": 3.0, "bob": 1.0}))
    out = {"role": server.role}
    server.warmup(grids[0])
    server.start()
    if not server.is_leader:
        server.stop()
        out["released_at"] = server.released_at
        if server.role == "outside":
            try:
                server.submit(grids[0])
            except serving.NotLeader as e:
                out["not_leader"] = str(e)
        return out
    futures, lock = [], threading.Lock()

    def worker(wseed: int) -> None:
        wrng = np.random.default_rng(wseed)
        for _ in range(12):
            try:
                if wrng.random() < 0.7:
                    f = server.submit(
                        grids[int(wrng.integers(0, len(grids)))],
                        priority=int(wrng.random() < 0.3),
                        deadline_s=(float(wrng.uniform(0.005, 0.5))
                                    if wrng.random() < 0.3 else None),
                        tenant=("alice", "bob")[int(wrng.integers(0, 2))])
                    with lock:
                        futures.append(f)
                else:
                    with lock:
                        pick = (futures[int(wrng.integers(0, len(futures)))]
                                if futures else None)
                    if pick is not None:
                        pick.cancel()
            except serving.ServerStopped:
                return
            if wrng.random() < 0.5:
                time.sleep(float(wrng.uniform(0.0, 0.003)))

    threads = [threading.Thread(target=worker,
                                args=(int(rng.integers(2**31)),))
               for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(float(rng.uniform(0.0, 0.15)))
    out["drain"] = bool(rng.integers(0, 2))
    server.stop(drain=out["drain"])
    for t in threads:
        t.join(timeout=60)
    out["workers_alive"] = sum(t.is_alive() for t in threads)
    done, pending = wait(futures, timeout=SERVE_WAIT_S)
    out["accepted"], out["pending"] = len(futures), len(pending)
    states = []
    for f in done:
        try:
            f.result()
            states.append("result")
        except CancelledError:
            states.append("cancelled")
        except (serving.ServerStopped, serving.DeadlineExceeded) as e:
            states.append(type(e).__name__)
        except Exception as e:              # not a terminal state
            states.append(f"unexpected {type(e).__name__}: {e}")
    out["states"] = states
    return out


def serving_rank(rank: int, weights: dict, draws: dict) -> dict:
    """The serving tier over 4 CPU ranks, part by part (each part's server
    built by every rank in the same order): parity over the ('grid',)
    mesh and the (2, 2) mesh (``draws``: the reference's round draws of
    the three requests, by label), the router, faults on each mesh, both
    stops with a dispatch in flight, and one stress interleaving over 2
    ranks."""
    toy_ = serving_toy(weights)
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, spec in SERVE_SPECS.items():
            out[f"parity/{name}"] = _serve_parity(spec, toy_, draws)
        out["router"] = _serve_router(toy_)
        out["faults/grid"] = _serve_faults(SERVE_SPECS["grid"], 2, toy_)
        out["faults/grid_model"] = _serve_faults(SERVE_SPECS["grid_model"],
                                                 2, toy_)
        out["stop/drain"] = _serve_stop(True, toy_)
        out["stop/hard"] = _serve_stop(False, toy_)
        out["stress"] = _serve_stress(0, toy_)
    return out


def _leave_all_gather(rank: int) -> None:
    """On ``rank``: its next all-gather raises instead of entering the
    collective (once), after the status exchange before it has passed, so
    its model peer is left inside the all-gather."""
    if dist.get_rank() != rank:
        return
    orig = dist.all_gather_into_tensor

    def leave(*args, **kwargs):
        dist.all_gather_into_tensor = orig
        raise RuntimeError(f"rank {rank} left the all-gather")

    dist.all_gather_into_tensor = leave


def model_group_timeout_rank(rank: int, timeout_s: float) -> dict:
    """A fault inside a model group's all-gather on the (2, 2) mesh: rank 2
    leaves it while rank 3 is inside.  First a `GridRunner` over a private
    mesh whose model groups time out after ``timeout_s`` (the per-mesh
    override): each rank's error and seconds, then its next run; then a
    `ScenarioServer` over the same ranks, its mesh built with the module's
    `MODEL_GROUP_TIMEOUT` set to ``timeout_s``: two requests, one a
    dispatch."""
    import datetime

    from repro_torch.launch import serving

    bound = datetime.timedelta(seconds=timeout_s)
    data, nets, init_fn, cfg = serving_toy()
    grid = scenarios.ScenarioGrid.concat(*serving_requests(nets))
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runner = scenarios.GridRunner(
            init_fn, smallnets.apply_mlp_clf, data, cfg, device="cpu",
            sharding=mesh.grid_model_mesh([0, 1, 2, 3], model_shards=2,
                                          device="cpu", private=True,
                                          model_timeout=bound))
        _leave_all_gather(2)
        began = time.monotonic()
        try:
            runner.run(grid)
            out["fault"] = None
        except mesh.RankFailed as e:
            out["fault"] = (type(e).__name__, e.rank, e.group_broken)
        out["fault_s"] = time.monotonic() - began
        try:
            runner.run(grid)
            out["again"] = None
        except mesh.MeshBroken as e:
            out["again"] = str(e)

        mesh.MODEL_GROUP_TIMEOUT = bound
        server = serving.ScenarioServer(
            init_fn, smallnets.apply_mlp_clf, data, cfg, device="cpu",
            devices=SERVE_SPECS["grid_model"],
            serve=serving.ServeConfig(max_batch=1, batch_buckets=(4,)))
        _leave_all_gather(2)
        with server:
            if server.is_leader:
                outcomes = []
                for req in serving_requests(nets)[:2]:
                    try:
                        server.submit(req).result(timeout=SERVE_WAIT_S)
                        outcomes.append(("ok", None))
                    except Exception as e:
                        outcomes.append((type(e).__name__, str(e)))
                out["served"] = outcomes
        out["dispatch_errors"] = server.tracker.snapshot().get(
            "serve/dispatch_errors", 0)
    return out


def serving_card_rank(rank: int) -> dict:
    """A server over ranks 0 and 1 sharing the card (the rank's device,
    `spawn`'s): the reference's three requests coalesced into one
    dispatch padded to 4 rows; the leader's rows and dispatch log, and
    each rank's K1 launches by (B, N, L, K)."""
    from _torch_serving_faults import install
    from repro_torch.kernels import ops, ra_aggregate
    from repro_torch.launch import serving

    data, nets, init_fn, cfg = serving_toy()
    requests = serving_requests(nets)
    server = serving.ScenarioServer(
        init_fn, smallnets.apply_mlp_clf, data, cfg, devices=[0, 1],
        serve=serving.ServeConfig(max_batch=3, batch_buckets=(4,),
                                  max_delay_s=30.0))
    server.warmup(scenarios.ScenarioGrid.concat(*requests))
    probe = install(server) if server.is_leader else None
    ops.LAUNCHES["ra_aggregate"] = 0
    ra_aggregate.SHAPE_LAUNCHES.clear()
    out = {"device": str(server.runner.sim.device)}
    with server:
        if server.is_leader:
            out["rows"] = [_rows(r) for r in server.serve(requests)]
    torch.cuda.synchronize()
    out["k1_by_shape"] = dict(ra_aggregate.SHAPE_LAUNCHES)
    if probe is not None:
        out["ran"] = probe.ran
    return out
