"""PyTorch port vs the JAX reference: the scenario-grid engine.

* Grid construction (`ScenarioGrid.product` / `concat` / `take`) and the
  engine's helpers against the reference's on the same inputs: ids, labels
  and masks exactly, floats within 1e-6.
* `validate_grid`: the same `AdmissionError` text on each bad grid.
* The batched round, fed the reference's draws and initial weights, against
  the reference's `advance_chunk` replayed scenario by scenario: segment
  rows and per-client train losses within 1e-4, test accuracy within one
  test sample, bias within 1e-4 relative, selected masks exactly.  The
  port is given the reference's routed ``rho`` (the two packages' float32
  routing may differ in the last bits, and a mask draw must not fall into
  that gap).
* One tiny grid on a perfect channel (every mask all ones whatever the
  draws) against the reference's own `run_grid`, within 1e-4.
* The port's `run_grid` against its own `run_sequential` (the same draws
  and weights, one scenario at a time), within 1e-5.
* K1 under `torch.func.vmap`, single and nested, against the rank-4 call
  (the plain version on the CPU; the card's kernel in test_torch_cuda.py).
"""
import dataclasses
import functools
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import codec_uniforms, round_uniforms  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.fl import scenarios as jscenarios  # noqa: E402
from repro.fl import simulator as jsimulator  # noqa: E402
from repro.models import smallnets as jsmall  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.fl import scenarios, simulator  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import tracker  # noqa: E402
from repro_torch.models import smallnets  # noqa: E402

N = 4
STATICS = dict(seg_len=64, local_epochs=2, n_rounds=3)
ALL_PROTOCOLS = [("ra", "ra_normalized"), ("ra", "substitution"),
                 ("aayg", "ra_normalized"), ("aayg", "substitution"),
                 ("cfl", "ra_normalized"), ("cfl", "substitution"),
                 ("ideal_cfl", "ra_normalized"), ("none", "ra_normalized")]
SCHED_PART = np.array([[1, 1, 0, 1], [0, 1, 1, 1], [1, 0, 1, 0]], np.float32)


def _jinit(key):
    return jsmall.init_mlp_clf(key, d_in=32, d_hidden=8)


def _tinit(g):
    return smallnets.init_mlp_clf(g, d_in=32, d_hidden=8)


@functools.lru_cache(maxsize=None)
def _setup():
    """Data in both packages, the reference's networks (4 clients; one with
    3 routing-only nodes more) and the port's with equal link matrices."""
    kw = dict(n_clients=N, samples_per_client=20)
    jdata = jsynthetic.fed_image_classification(**kw)
    tdata = synthetic.fed_image_classification(**kw)
    jsmall_net = jtopology.make_network(
        jtopology.TABLE_II_COORDS[:N], edge_density=0.8,
        packet_len_bits=20_000, n_clients=N, tx_power_dbm=17.0)
    jbig_net = jtopology.make_network(
        np.concatenate([jtopology.TABLE_II_COORDS[:N],
                        jtopology.TABLE_II_COORDS[6:9]]),
        edge_density=0.4, packet_len_bits=20_000, n_clients=N,
        tx_power_dbm=17.0)
    pairs = []
    for jnet in (jsmall_net, jbig_net):
        tnet = topology.make_network(
            np.asarray(jnet.coords, np.float64), edge_density=0.5,
            packet_len_bits=20_000, n_clients=N, tx_power_dbm=17.0)
        pairs.append((jnet, dataclasses.replace(
            tnet, adjacency=torch.from_numpy(np.array(jnet.adjacency)),
            link_eps=torch.from_numpy(np.array(jnet.link_eps)))))
    return jdata, tdata, pairs


def _weights_by_seed(seeds):
    """The reference's initial weights per seed, in the port's layout, and
    a port ``init_fn`` that hands them out by its generator's seed."""
    w = {s: interop.params_from_jax(jax.tree.map(
        np.asarray, _jinit(jax.random.PRNGKey(s)))) for s in seeds}
    return lambda g: w[g.initial_seed()]


def _grids(kind, epochs=True):
    """(reference grid, port grid) built from the same axes (the dynamic
    one with per-client epochs unless ``epochs`` is False)."""
    _jd, _td, pairs = _setup()
    (js, ts), (jb, tb) = pairs
    if kind == "static":
        kw = dict(protocols=ALL_PROTOCOLS, seeds=[0, 1], lrs=[0.05, 0.1],
                  aggregator=1)
        return (jscenarios.ScenarioGrid.product(
                    networks=[("small", js), ("big", jb)], **kw),
                scenarios.ScenarioGrid.product(
                    networks=[("small", ts), ("big", tb)], **kw))
    sched = jtopology.markov_link_schedule(js, 3, p_drop=0.4, seed=1)
    kw = dict(schedules=[("markov", sched)],
              participation=[("part", SCHED_PART)],
              sampling_policies=[("loss", "loss", 0.5)],
              codecs=[("topk", "topk", 0.5)], seeds=[0, 2], lrs=[0.1],
              local_epochs=(np.array([1, 2, 2, 0], np.int32) if epochs
                            else None), aggregator=1)
    return (jscenarios.ScenarioGrid.product(networks=[("big", jb)], **kw),
            scenarios.ScenarioGrid.product(networks=[("big", tb)], **kw))


def _assert_leaves_match(jgrid, tgrid):
    assert tgrid.labels == jgrid.labels
    assert tgrid.packet_len_bits == jgrid.packet_len_bits
    for name in simulator.Scenario._fields:
        a, b = getattr(jgrid.scenarios, name), getattr(tgrid.scenarios, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert isinstance(getattr(tgrid.scenarios, name), np.ndarray), name
        assert (a.shape, a.dtype) == (b.shape, b.dtype), name
        if a.dtype.kind == "f" and name not in ("participation",):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_product_take_and_concat_leaves_match(kind):
    jgrid, tgrid = _grids(kind)
    _assert_leaves_match(jgrid, tgrid)
    idx = [3, 0, len(jgrid) - 1]
    _assert_leaves_match(jgrid.take(idx), tgrid.take(idx))
    if kind == "static":   # static + dynamic: V, T, masks, policy, codec
        other_j, other_t = _grids("dynamic", epochs=False)
        _assert_leaves_match(jscenarios.ScenarioGrid.concat(jgrid, other_j),
                             scenarios.ScenarioGrid.concat(tgrid, other_t))
    one = tgrid.scenario(1)
    assert isinstance(one.protocol_id, int) and isinstance(one.lr, float)
    assert torch.is_tensor(one.link_eps) and one.rho is None


def test_concat_relays_with_ideal_row_pads_v_and_dedupes():
    kw = dict(edge_density=0.15, tx_power_dbm=17.0, packet_len_bits=32768)
    grids = []
    for pkg, sc in ((jtopology, jscenarios), (topology, scenarios)):
        ideal = sc.ScenarioGrid.product(
            networks=[("standard", pkg.paper_network(packet_len_bits=32768))],
            protocols=[("ideal_cfl", "ra_normalized")])
        relays = sc.ScenarioGrid.product(networks=[
            (f"R{r}", pkg.paper_network_with_relays(r, **kw))
            for r in (0, 7, 14, 28)])
        grids.append(sc.ScenarioGrid.concat(ideal, relays, relays.take([0])))
    jg, tg = grids
    assert tg.scenarios.link_eps.shape == (6, 38, 38)
    assert tg.labels[1] == "R0/ra+ra_normalized#0"
    _assert_leaves_match(jg, tg)


def test_product_and_concat_reject_as_the_reference_does():
    _jd, _td, pairs = _setup()
    (js, ts), _ = pairs
    cases = [
        dict(networks=[("a", "net"), ("a", "net")]),
        dict(),
        dict(networks=[("a", "net")], sampling_policies=[("x", "random", .5)]),
        dict(networks=[("a", "net")], sampling_policies=[("x", "loss", 0.)]),
        dict(networks=[("a", "net")], sampling_policies=[]),
        dict(networks=[("a", "net")], codecs=[("x", "zip", .5)]),
        dict(networks=[("a", "net")], codecs=[("x", "topk", 1.5)]),
        dict(networks=[("a", "net")], participation=[("x", None)]),
        dict(networks=[("a", "net")], schedules=[("s", np.ones((3, 4)))]),
        dict(networks=[("a", "net")], schedules=[
            ("s", np.ones((2, 4, 4))), ("t", np.ones((3, 4, 4)))]),
    ]
    for kw in cases:
        msgs = []
        for sc, net in ((jscenarios, js), (scenarios, ts)):
            kwn = {k: ([(l, net if v == "net" else v) for l, v in val]
                       if k == "networks" else val) for k, val in kw.items()}
            with pytest.raises(ValueError) as err:
                sc.ScenarioGrid.product(**kwn)
            msgs.append(str(err.value))
        assert msgs[1] == msgs[0]
    msgs = []
    for sc, net in ((jscenarios, js), (scenarios, ts)):
        plain = sc.ScenarioGrid.product(networks=[("a", net)])
        hetero = sc.ScenarioGrid.product(networks=[("b", net)],
                                         local_epochs=[1, 2, 1, 1])
        with pytest.raises(ValueError) as err:
            sc.ScenarioGrid.concat(plain, hetero)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


def _bad_grids(grid, mod):
    """The reference's rejection list (`validate_grid`, one case per check)
    applied to ``grid`` of package ``mod``: (name, bad grid, kwargs)."""
    s = grid.scenarios
    g = len(grid)

    def with_(**fields):
        return mod.ScenarioGrid(scenarios=s._replace(**fields),
                                labels=list(grid.labels),
                                packet_len_bits=grid.packet_len_bits)

    le = np.array(s.link_eps)
    nan_le, big_le = le.copy(), le.copy()
    nan_le[1, 0, 1] = np.nan
    big_le[2:, 0, 1] = 1.5
    pid = np.array(s.protocol_id)
    pid[0] = 9
    mid = np.array(s.mode_id)
    mid[1] = -1
    lr = np.array(s.lr)
    lr[3] = np.inf
    part = np.ones((g, 3, N), np.float32)
    part_bad = part.copy()
    part_bad[2, 1, 0] = 2.0
    ep = np.ones((g, N), np.int32)
    ep_bad = ep.copy()
    ep_bad[:5, 1] = -1
    ones_i = np.zeros(g, np.int32)
    ones_f = np.full(g, 0.5, np.float32)
    return [
        ("rank", with_(link_eps=le[0]), {}),
        ("rows", with_(link_eps=le[:-1]), {}),
        ("square", with_(link_eps=le[:, :, :-1]), {}),
        ("finite", with_(link_eps=nan_le), {}),
        ("range", with_(link_eps=big_le), {}),
        ("protocol_shape", with_(protocol_id=pid[:, None]), {}),
        ("protocol", with_(protocol_id=pid), {}),
        ("mode", with_(mode_id=mid), {}),
        ("lr", with_(lr=lr), {}),
        ("part_rank", with_(participation=part[..., None]), {}),
        ("part_clients", with_(participation=part), dict(n_clients=N + 1)),
        ("part_range", with_(participation=part_bad), {}),
        ("epochs_clients", with_(local_epochs=ep), dict(n_clients=N + 2)),
        ("epochs_negative", with_(local_epochs=ep_bad), {}),
        ("policy", with_(policy_id=ones_i + 7, select_frac=ones_f), {}),
        ("frac", with_(policy_id=ones_i, select_frac=ones_f * 0), {}),
        ("codec", with_(codec_id=ones_i - 1, compress_ratio=ones_f), {}),
        ("ratio", with_(codec_id=ones_i, compress_ratio=ones_f + 1), {}),
        ("duplicate", mod.ScenarioGrid(
            scenarios=s, labels=[grid.labels[0]] * g,
            packet_len_bits=grid.packet_len_bits), {}),
        ("packet", grid, dict(seg_len=512, strict_packet=True)),
    ]


def test_validate_grid_rejects_with_the_reference_text():
    jgrid, tgrid = _grids("static")
    jbad, tbad = _bad_grids(jgrid, jscenarios), _bad_grids(tgrid, scenarios)
    for (name, jg, kw), (_n, tg, _k) in zip(jbad, tbad):
        with pytest.raises(jscenarios.AdmissionError) as want:
            jscenarios.validate_grid(jg, **kw)
        with pytest.raises(scenarios.AdmissionError) as got:
            scenarios.validate_grid(tg, **kw)
        assert isinstance(got.value, ValueError)
        assert str(got.value) == str(want.value), name
    scenarios.validate_grid(tgrid, n_clients=N, seg_len=625,
                            strict_packet=True)


def test_engine_helpers_match():
    for g, pad_to in ((3, None), (3, 4), (5, (2, 4)), (9, [4, 2]), (1, 1)):
        assert scenarios._bucket_target(g, pad_to) == \
            jscenarios._bucket_target(g, pad_to)
    for bad in (0, (3, -1), ()):
        with pytest.raises(ValueError) as want:
            jscenarios._bucket_target(3, bad)
        with pytest.raises(ValueError) as got:
            scenarios._bucket_target(3, bad)
        assert str(got.value) == str(want.value)
    jgrid, tgrid = _grids("dynamic")
    for grid_j, grid_t in ((jgrid, tgrid), _grids("static")):
        for rows in ([0, 1], [0], list(range(len(grid_t)))):
            ja, jargs = jscenarios._hoist_uniform(grid_j.take(rows).scenarios)
            ta, targs = scenarios._hoist_uniform(grid_t.take(rows).scenarios)
            assert ta == ja
            for name in simulator.Scenario._fields:
                a, b = getattr(jargs, name), getattr(targs, name)
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                               rtol=1e-6, atol=0)
            assert scenarios._aval_sig(grid_t.take(rows).scenarios) == \
                jscenarios._aval_sig(grid_j.take(rows).scenarios)
        for target in (len(grid_t), len(grid_t) + 3):
            jp = jscenarios._pad_scenario_batch(grid_j.scenarios, target)
            tp = scenarios._pad_scenario_batch(grid_t.scenarios, target)
            _assert_leaves_match(
                jscenarios.ScenarioGrid(jp, [""] * target),
                scenarios.ScenarioGrid(tp, [""] * target))
            assert not np.asarray(tp.link_eps)[len(grid_t):].any()
    one_net = _grids("static")[1].take([0, 1, 2, 3]).scenarios
    le = np.array(one_net.link_eps)
    le[:, 0, 1] = np.nan                    # the same NaN in every row
    axes, _ = scenarios._hoist_uniform(one_net._replace(link_eps=le))
    assert axes.link_eps is None and axes.seed == 0
    le[0, 0, 1] = 0.5                       # rows now differ
    axes, _ = scenarios._hoist_uniform(one_net._replace(link_eps=le))
    assert axes.link_eps == 0
    labels = ["a", "b", "a", "c", "a", "b"]
    assert scenarios._dedupe_labels(labels) == \
        jscenarios._dedupe_labels(labels)
    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    np.testing.assert_array_equal(scenarios._tile_schedule(arr, 6, "x"),
                                  jscenarios._tile_schedule(arr, 6, "x"))
    np.testing.assert_array_equal(scenarios._pad_link_eps(arr[:, :3, :3], 5),
                                  jscenarios._pad_link_eps(arr[:, :3, :3], 5))
    np.testing.assert_array_equal(
        scenarios._normalize_participation(arr[:, :1], 4, 3),
        jscenarios._normalize_participation(arr[:, :1], 4, 3))
    for fn, args in ((scenarios._tile_schedule, (arr, 3, "x")),
                     (scenarios._normalize_participation, (arr, 4, 4))):
        with pytest.raises(ValueError):
            fn(*args)


def _replay(kind):
    """Every dispatch group of a grid through `advance_chunk_batch`, fed
    the reference's draws and weights, against the reference's jitted
    `advance_chunk` scenario by scenario."""
    jdata, tdata, _pairs = _setup()
    jgrid, tgrid = _grids(kind)
    cfg = simulator.SimConfig(agg_impl="kernel", **STATICS)
    with warnings.catch_warnings():   # 20,000-bit PER vs 64-value segments
        warnings.simplefilter("ignore")
        jsim = jsimulator.build_sim(_jinit, jsmall.apply_mlp_clf, jdata,
                                    agg_impl="jnp", **STATICS)
        runner = scenarios.GridRunner(
            _weights_by_seed(set(np.asarray(tgrid.scenarios.seed).tolist())),
            smallnets.apply_mlp_clf, tdata, cfg, device="cpu")
    sim = runner.sim
    n, s_total, test_n = N, sim.n_segments, len(tdata.test_y)
    assert s_total == jsim.n_segments
    jscs = [jgrid.scenario(i).prepare() for i in range(len(jgrid))]
    rho = np.stack([np.asarray(sc.rho) for sc in jscs])
    advance = jax.jit(jsim.advance_chunk)
    groups = runner._index_groups(tgrid)
    assert len(groups) == len({(int(sc.protocol_id), int(sc.mode_id))
                               for sc in jscs})
    for idx in groups:
        sub = tgrid.take(idx).scenarios._replace(rho=rho[idx])
        axes, args = scenarios._hoist_uniform(sub)
        sb = sim.prepare_batch(args, axes)
        assert "rho" in sb.mapped
        tstate = sim.init_scan_batch(sb)
        jstates = [jsim.init_scan(jscs[i]) for i in idx]
        protocol = next(k for k, v in simulator.protocols.PROTOCOL_IDS.items()
                        if v == sb.scenario.protocol_id)
        for c in range(STATICS["n_rounds"]):
            us, ucs, jms = [], [], []
            for j, i in enumerate(idx):
                _key, k_round = jax.random.split(jstates[j]["key"])
                us.append([round_uniforms(protocol, k_round, n, s_total)])
                ucs.append([codec_uniforms(k_round, n, s_total,
                                           STATICS["seg_len"])])
                jstates[j], jm = advance(jstates[j], jscs[i], c)
                jms.append(jm)
            tstate, tm = sim.advance_chunk_batch(tstate, sb, u=us,
                                                 u_codec=ucs)
            for j, jm in enumerate(jms):
                label = f"{tgrid.labels[idx[j]]} round {c}"
                np.testing.assert_allclose(
                    tstate["w"][j].numpy(), np.asarray(jstates[j]["w"]),
                    atol=1e-4, rtol=0, err_msg=label)
                np.testing.assert_allclose(tm["loss"][j].numpy(),
                                           np.asarray(jm["loss"]),
                                           atol=1e-4, rtol=0, err_msg=label)
                gap = np.abs(tm["acc"][j].numpy() - np.asarray(jm["acc"]))
                assert gap.max() <= 1.0 / test_n + 1e-6, label
                np.testing.assert_allclose(tm["bias"][j].numpy(),
                                           np.atleast_1d(jm["bias"]),
                                           rtol=1e-4, equal_nan=True,
                                           err_msg=label)
                if "selected" in jm:
                    np.testing.assert_array_equal(
                        tm["selected"][j].numpy(),
                        np.atleast_2d(np.asarray(jm["selected"])),
                        err_msg=label)
                    np.testing.assert_allclose(
                        tstate["sig"].loss[j].numpy(),
                        np.asarray(jstates[j]["sig"].loss), atol=1e-4,
                        err_msg=label)


def test_static_grid_all_protocols_mixed_v_match_reference_rounds():
    """Both modes of R&A, AaYG and C-FL, ideal C-FL and "none", two
    networks of 4 and 7 nodes padded to 7, two seeds, two step sizes."""
    _replay("static")


def test_dynamic_grid_matches_reference_rounds():
    """A Markov link schedule, a participation schedule, per-client epochs
    (one client at 0), top-k 0.5 and the `loss` policy at 0.5."""
    _replay("dynamic")


def test_perfect_channel_grid_matches_reference_run_grid():
    """Every link delivers (link_eps 1 off the diagonal), so every mask is
    all ones whatever the draws, and the reference's own `run_grid` and the
    port's agree from the same weights."""
    jdata, tdata, _pairs = _setup()
    coords = jtopology.TABLE_II_COORDS[:N]
    perfect = np.ones((N, N), np.float32) - np.eye(N, dtype=np.float32)
    jnet = dataclasses.replace(jtopology.make_network(coords),
                               link_eps=jnp.asarray(perfect),
                               packet_len_bits=None)
    tnet = dataclasses.replace(topology.make_network(coords),
                               link_eps=torch.from_numpy(perfect),
                               packet_len_bits=None)
    kw = dict(protocols=[("ra", "ra_normalized"), ("aayg", "substitution"),
                         ("cfl", "ra_normalized"),
                         ("ideal_cfl", "ra_normalized"),
                         ("none", "ra_normalized")],
              seeds=[0, 1], aggregator=2)
    want = jscenarios.run_grid(
        _jinit, jsmall.apply_mlp_clf, jdata,
        jscenarios.ScenarioGrid.product(networks=[("p", jnet)], **kw),
        jsimulator.SimConfig(**STATICS))
    got = scenarios.run_grid(
        _weights_by_seed([0, 1]), smallnets.apply_mlp_clf, tdata,
        scenarios.ScenarioGrid.product(networks=[("p", tnet)], **kw),
        simulator.SimConfig(agg_impl="kernel", **STATICS), device="cpu")
    assert got.labels == want.labels
    np.testing.assert_allclose(got.loss, want.loss, atol=1e-4, rtol=0)
    assert np.abs(got.acc - want.acc).max() <= 1.0 / len(tdata.test_y) + 1e-6
    np.testing.assert_allclose(got.bias, want.bias, atol=1e-4,
                               equal_nan=True)


def test_run_grid_matches_own_run_sequential_and_runner_api():
    """The grid engine against one scenario at a time (same draws, same
    weights), plus the runner's cache, padding, tracker and device rule."""
    _jd, tdata, pairs = _setup()
    (_js, ts), (_jb, tb) = pairs
    sched = topology.fading_per_schedule(ts, 3, seed=3)
    grid = scenarios.ScenarioGrid.concat(
        scenarios.ScenarioGrid.product(
            networks=[("small", ts), ("big", tb)],
            protocols=[("ra", "ra_normalized"), ("aayg", "substitution"),
                       ("cfl", "ra_normalized")],
            seeds=[0, 5], lrs=[0.05, 0.1], aggregator=1),
        scenarios.ScenarioGrid.product(
            schedules=[("fade", sched)], seeds=[1, 2], aggregator=1,
            codecs=[("quant", "quant", 0.25)]))
    stats = tracker.StatsTracker()
    cfg = simulator.SimConfig(agg_impl="kernel", **STATICS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runner = scenarios.GridRunner(_tinit, smallnets.apply_mlp_clf, tdata,
                                      cfg, device="cpu", tracker=stats,
                                      max_cached_programs=2)
    assert runner.warmup(grid) == 2
    assert runner.warmup(grid) == 0
    batched = runner.run(grid)
    seq = runner.run_sequential(grid)
    assert batched.labels == grid.labels and len(batched) == len(grid)
    for key in ("acc", "loss", "bias"):
        np.testing.assert_allclose(getattr(batched, key), getattr(seq, key),
                                   atol=1e-5, rtol=0, equal_nan=True,
                                   err_msg=key)
    assert batched.selected is None
    assert batched.acc.shape == (len(grid), 3, N)
    assert batched.bias.shape == (len(grid), 3)
    np.testing.assert_array_equal(
        batched.result(grid.labels[3]).loss_per_client, batched.loss[3])
    padded = runner.run(grid, pad_to=(3, 8))
    for key in ("acc", "loss"):
        np.testing.assert_allclose(getattr(padded, key),
                                   getattr(batched, key), atol=1e-5, rtol=0)
    snap = stats.snapshot()
    assert snap["cache/miss"] >= 3 and snap["cache/evict"] >= 1
    assert runner.programs.stats["programs"] <= 2
    assert 0 < snap["grid/batch_fill_mean"] < 1
    # More than one rank needs a process group of that size (none here);
    # a multi-rank grid names ranks, not devices; sharding= takes a mesh.
    for bad, err, match in (
            (dict(devices=2), ValueError, "launch.mesh.spawn"),
            (dict(devices=(4, 2)), ValueError, "init_process_group"),
            (dict(devices=["cpu", "cpu"]), ValueError, "names ranks"),
            (dict(sharding="mesh"), TypeError, "launch.mesh.Mesh")):
        with pytest.raises(err, match=match):
            runner.run(grid.take([0]), **bad)
    runner.run(grid.take([0]), devices=["cpu"])
    with pytest.raises(scenarios.AdmissionError, match="duplicate"):
        runner.run(scenarios.ScenarioGrid(
            scenarios=grid.take([0, 1]).scenarios, labels=["x", "x"]))


def _k1_inputs(seed, a=2, b=3, n=4, l=5, k=8):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(a, b, n, l, k, generator=g)
    p = torch.rand(n, generator=g) + 0.1
    e = torch.rand(a, b, n, n, l, generator=g) < 0.6
    tx = torch.rand(a, b, n, l, generator=g) < 0.5
    return w, p / p.sum(), e, tx


@pytest.mark.parametrize("mode", ["ra_normalized", "substitution"])
def test_k1_under_vmap_single_and_nested_equals_rank4_call(mode):
    w, p, e, tx = _k1_inputs(0)
    a, b, n, l, k = w.shape
    flat = dict(p=p, mode=mode, device="cpu")

    def k1(w_, e_, tx_=None, p_=p):
        return ops.ra_aggregate(w_, p_, e_, tx=tx_, mode=mode, device="cpu")

    for with_tx in (False, True):
        t4 = tx.reshape(a * b, n, l) if with_tx else None
        want = ops.ra_aggregate(w.reshape(a * b, n, l, k), p,
                                e.reshape(a * b, n, n, l), tx=t4,
                                mode=flat["mode"], device="cpu")
        txs = tx if with_tx else None
        single = torch.func.vmap(k1, in_dims=(0, 0, 0 if with_tx else None))(
            w[0], e[0], None if txs is None else txs[0])
        nested = torch.func.vmap(torch.func.vmap(
            k1, in_dims=(0, 0, 0 if with_tx else None)),
            in_dims=(0, 0, 0 if with_tx else None))(w, e, txs)
        rank4 = torch.func.vmap(k1, in_dims=(0, 0, 0 if with_tx else None))(
            w, e, txs)
        assert torch.equal(single, want[:b])
        assert torch.equal(nested.reshape(want.shape), want)
        assert torch.equal(rank4.reshape(want.shape), want)
    # A vmapped mask laid out with the batch last (a strided view), a
    # shared transmit mask, per-entry weights.
    strided = torch.func.vmap(k1, in_dims=(0, 3))(
        w[0], e[0].permute(1, 2, 3, 0))
    assert torch.equal(strided, ops.ra_aggregate(w[0], p, e[0], mode=mode,
                                                 device="cpu"))
    shared = torch.func.vmap(lambda w_, e_: k1(w_, e_, tx[0, 0]))(w[0], e[0])
    plain = (ref.ra_aggregate_ref if mode == "ra_normalized"
             else ref.ra_substitution_ref)
    assert torch.equal(shared, plain(w[0], p.expand(b, n), e[0],
                                     tx[0, 0].expand(b, n, l)))
    ps = torch.rand(b, n) + 0.1
    per_p = torch.func.vmap(lambda w_, e_, p_: k1(w_, e_, None, p_))(
        w[0], e[0], ps)
    assert torch.equal(per_p, ops.ra_aggregate(w[0], ps, e[0], mode=mode,
                                               device="cpu"))


@pytest.mark.parametrize("optimizer", [None, "adamw"], ids=["gd", "adamw"])
def test_batched_knobs_match_run_sequential(optimizer):
    """Fields that vary inside a group stay batched under the vmap: the
    select fraction and compress ratio of one policy / codec, step sizes,
    participation masks (static and per round) and per-client epochs; every
    policy and codec, and local AdamW.  Rows and the selected masks equal
    `run_sequential`'s (1e-5; masks exactly)."""
    _jd, tdata, pairs = _setup()
    (_js, ts), _ = pairs
    part = [("static", np.array([1, 1, 0, 1], np.float32)),
            ("sched", SCHED_PART)]
    grid = scenarios.ScenarioGrid.concat(
        scenarios.ScenarioGrid.product(
            networks=[("n", ts)], participation=part,
            sampling_policies=[("l3", "loss", 0.3), ("l6", "loss", 0.6),
                               ("b5", "budget", 0.5), ("b8", "budget", 0.8),
                               ("g", "grad_norm", 0.5),
                               ("w", "bandwidth", 0.5)],
            codecs=[("t3", "topk", 0.3), ("t7", "topk", 0.7),
                    ("q2", "quant", 0.25), ("q5", "quant", 0.5)],
            local_epochs=[1, 2, 0, 2], aggregator=1),
        scenarios.ScenarioGrid.product(
            networks=[("n", ts)], participation=part,
            protocols=[("cfl", "substitution"), ("aayg", "substitution"),
                       ("ideal_cfl", "ra_normalized")],
            codecs=[("q2", "quant", 0.25), ("q5", "quant", 0.5)],
            lrs=[0.05, 0.2], local_epochs=[2, 1, 1, 2], aggregator=2))
    cfg = simulator.SimConfig(agg_impl="kernel", local_optimizer=optimizer,
                              **STATICS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runner = scenarios.GridRunner(_tinit, smallnets.apply_mlp_clf, tdata,
                                      cfg, device="cpu")
        batched, seq = runner.run(grid), runner.run_sequential(grid)
    assert max(len(g) for g in runner._index_groups(grid)) == 8
    for key in ("acc", "loss", "bias"):
        np.testing.assert_allclose(getattr(batched, key), getattr(seq, key),
                                   atol=1e-5, rtol=0, equal_nan=True,
                                   err_msg=key)
    np.testing.assert_array_equal(batched.selected, seq.selected)
    assert batched.selected_frac.shape == (len(grid), 3)


def test_batched_round_runs_one_convolution_and_one_k1_call_per_site():
    """A round of G scenarios runs the operators a round of one runs, no
    more: under the vmap over scenarios, each of the CNN's convolutions (one
    a client, the CNN training one client at a time) is one grouped
    convolution over the G scenarios (its weight G times as wide) and K1
    one call of B = G, counted below the vmap by a dispatch mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            if "convolution" in name or "ra_aggregate" in name:
                self.calls.append((name, tuple(args[0].shape),
                                   tuple(args[1].shape)))
            return func(*args, **(kwargs or {}))

    kw = dict(n_clients=3, d=64, samples_per_client=10, test_size=20)
    data = synthetic.fed_image_classification(**kw)
    data = dataclasses.replace(
        data, train_x=[x.reshape(-1, 8, 8, 1) for x in data.train_x],
        test_x=data.test_x.reshape(-1, 8, 8, 1))
    net = topology.make_network(topology.TABLE_II_COORDS[:3],
                                packet_len_bits=2048)
    init = functools.partial(smallnets.init_cnn, in_hw=(8, 8), c1=4, c2=8,
                             fc=16)
    sim = simulator.build_sim(init, smallnets.apply_cnn, data, seg_len=64,
                              local_epochs=2, n_rounds=1, agg_impl="kernel",
                              device="cpu")
    counts = {}
    for g in (1, 4):
        grid = scenarios.ScenarioGrid.product(
            networks=[("n", net)], seeds=range(g), aggregator=0)
        axes, args = scenarios._hoist_uniform(grid.scenarios)
        sb = sim.prepare_batch(args, axes)
        state = sim.init_scan_batch(sb)
        with Count() as mode:
            sim.advance_chunk_batch(state, sb)
        counts[g] = mode.calls
    assert [c[0] for c in counts[4]] == [c[0] for c in counts[1]]
    k1 = [c for c in counts[4] if "ra_aggregate" in c[0]]
    assert [c[1][0] for c in k1] == [4]                 # one call, B = 4
    for (name, _x, w1), (_n, _x4, w4) in zip(counts[1], counts[4]):
        if name.startswith("aten.convolution.default"):
            assert w4[0] == 4 * w1[0], (w1, w4)         # G x the channels
