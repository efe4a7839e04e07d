"""PyTorch port vs the JAX reference: the serving tier over ranks (CPU).

`ScenarioServer(devices=)` and `ScenarioRouter.in_process(devices=)` over
4 gloo CPU ranks spawned by `launch.mesh.spawn` (one spawn for the whole
file; the rank bodies are `tests/_torch_ranks.serving_rank`'s parts, run
by every rank in the same order), on the reference's serving toy
(tests/test_serving.py: 3 clients, a 32-16 MLP, 2 rounds of 1 epoch).
The initial weights are the reference's, by seed.

* Parity: the reference's `_serving_shard_check` requests (R&A, AaYG and
  R&A at seed 3, coalesced into one dispatch) over the ('grid',) mesh of
  4 and the (2, 2) ('grid', 'model') mesh: the same bits as every rank's
  replay of the dispatched grid over the same ranks, as the port's
  single-process server and as `run_grid` of each request alone; on
  links made certain (so the two packages' draws decide nothing), within
  1e-5 in loss and bias, with the same count of correct test samples, of
  the reference's `run_grid`.  On the lossy links, the dispatched grid
  run on every rank's share of the mesh (a model shard of it on the
  (2, 2) mesh) with the reference's round draws fed in is held to the
  reference's rounds in the same way.
* Each rank's warmup before `start` builds the same programs, and the
  dispatches then build none.
* A follower's, or an outside rank's, `submit` raises `NotLeader` naming
  the leader.
* The router: two replicas over the (2, 2) mesh, the owner of the first
  request's family killed while it holds a dispatch: every request
  delivered once, rows as `run_grid` alone, and the killed replica's
  followers leave their loop before the survivor's.
* Faults: a raise on the leader before the fan-out, then one inside
  rank 2's share alone (on the (2, 2) mesh its model peer, rank 3, waits
  for it), each fail only their request; the third is served.
* Stops with a dispatch in flight: drain serves everything accepted, a
  hard stop fails it; every follower returns.
* One seeded interleaving of tests/test_serving_stress.py's property over
  ranks 0 and 1.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (fixes the thread count)
import _torch_ranks  # noqa: E402
from _torch_parity import round_uniforms  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.fl import scenarios as jscenarios  # noqa: E402
from repro.fl import simulator as jsimulator  # noqa: E402
from repro.models import smallnets as jsmall  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.fl import scenarios  # noqa: E402
from repro_torch.launch import mesh, serving  # noqa: E402
from repro_torch.models import smallnets  # noqa: E402

TOL = 1e-5
SEEDS = (0, 1, 2, 3, 5, 6, 7)
SPECS = tuple(_torch_ranks.SERVE_SPECS)


@functools.lru_cache(maxsize=None)
def _weights() -> dict:
    """The reference's initial weights per seed, as numpy."""
    return {s: {k: v.numpy() for k, v in interop.params_from_jax(
        jax.tree.map(np.asarray, jsmall.init_mlp_clf(
            jax.random.PRNGKey(s), d_in=32, d_hidden=16))).items()}
        for s in SEEDS}


def _jinit(key):
    return jsmall.init_mlp_clf(key, d_in=32, d_hidden=16)


def _jgrid(jnets):
    """The three requests on the reference's networks, as one grid."""
    return jscenarios.ScenarioGrid.concat(*(
        jscenarios.ScenarioGrid.product(
            networks=[(lbl, jnets[i])], protocols=[(proto, "ra_normalized")],
            seeds=[seed])
        for i, proto, lbl, seed in ((0, "ra", "r0", 0), (1, "aayg", "r1", 0),
                                    (1, "ra", "r2", 3))))


def _jdata():
    return jsynthetic.fed_image_classification(n_clients=3,
                                               samples_per_client=20, seed=0)


@functools.lru_cache(maxsize=None)
def _reference_lossy():
    """The reference's rounds of the three requests on the lossy links
    (its jitted `advance_chunk`, scenario by scenario): each round's
    uniforms (`round_uniforms` of the round key) and each chunk's
    metrics, by label."""
    jnets = [jtopology.make_network(
        jtopology.TABLE_II_COORDS[:3], edge_density=d,
        packet_len_bits=32 * 64, n_clients=3, tx_power_dbm=17.0)
        for d in (0.6, 0.8)]
    grid = _jgrid(jnets)
    jsim = jsimulator.build_sim(_jinit, jsmall.apply_mlp_clf, _jdata(),
                                agg_impl="jnp", **_torch_ranks.SERVE_STATICS)
    advance = jax.jit(jsim.advance_chunk)
    protocols = {"r0": "ra", "r1": "aayg", "r2": "ra"}
    draws, want = {}, {}
    for i, label in enumerate(grid.labels):
        jsc = grid.scenario(i).prepare()
        state = jsim.init_scan(jsc)
        draws[label], want[label] = [], []
        for c in range(jsim.n_chunks):
            _key, k_round = jax.random.split(state["key"])
            draws[label].append(round_uniforms(
                protocols[label[:2]], k_round, 3, jsim.n_segments).numpy())
            state, met = advance(state, jsc, c)
            want[label].append({k: np.asarray(v) for k, v in met.items()})
    return draws, want


@functools.lru_cache(maxsize=None)
def _ranks() -> list:
    return mesh.spawn(_torch_ranks.serving_rank, 4,
                      args=(_weights(), _reference_lossy()[0]),
                      device="cpu", timeout=240)


@functools.lru_cache(maxsize=None)
def _single() -> dict:
    """The port in one process on the same requests: the single-process
    server and `run_grid` of each request alone."""
    data, nets, init_fn, cfg = _torch_ranks.serving_toy(_weights())
    out = {}
    for name, sure in (("lossy", False), ("sure", True)):
        reqs = _torch_ranks.serving_requests(nets, sure=sure)
        server = serving.ScenarioServer(
            init_fn, smallnets.apply_mlp_clf, data, cfg, device="cpu",
            serve=serving.ServeConfig(max_batch=3, max_delay_s=30.0))
        with server:
            out[f"server/{name}"] = server.serve(reqs)
        out[f"alone/{name}"] = [scenarios.run_grid(
            init_fn, smallnets.apply_mlp_clf, data, g, cfg, device="cpu")
            for g in reqs]
    return out


def _alone(grid):
    data, _nets, init_fn, cfg = _torch_ranks.serving_toy(_weights())
    return scenarios.run_grid(init_fn, smallnets.apply_mlp_clf, data, grid,
                              cfg, device="cpu")


def _assert_bits(got, want):
    labels, acc, loss, bias = got
    assert labels == want.labels
    np.testing.assert_array_equal(acc, want.acc)
    np.testing.assert_array_equal(loss, want.loss)
    assert np.array_equal(bias, want.bias, equal_nan=True)


def _assert_close(got, want, test_n):
    """Loss and bias within 1e-5; the same count of correct test samples
    (the packages round the accuracy's division differently)."""
    labels, acc, loss, bias = got
    assert labels == list(want.labels)
    np.testing.assert_array_equal(np.rint(acc * test_n),
                                  np.rint(np.asarray(want.acc) * test_n))
    np.testing.assert_allclose(loss, np.asarray(want.loss), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(bias, np.asarray(want.bias), atol=TOL,
                               rtol=0, equal_nan=True)


@functools.lru_cache(maxsize=None)
def _reference_sure():
    """The reference's `run_grid` of the three requests on the same
    networks with the links made certain, from the same weights."""
    data, nets, _init, _cfg = _torch_ranks.serving_toy()
    jnets = [dataclasses.replace(jtopology.make_network(
        jtopology.TABLE_II_COORDS[:3], edge_density=d,
        packet_len_bits=32 * 64, n_clients=3, tx_power_dbm=17.0),
        link_eps=jnp.asarray(_torch_ranks.sure_links(net.link_eps)))
        for d, net in zip((0.6, 0.8), nets)]
    return jscenarios.run_grid(
        _jinit, jsmall.apply_mlp_clf, _jdata(), _jgrid(jnets),
        jsimulator.SimConfig(**_torch_ranks.SERVE_STATICS))


@pytest.mark.parametrize("spec", SPECS)
def test_served_rows_over_ranks_are_the_single_process_bits(spec):
    single = _single()
    ranks = _ranks()
    lead = ranks[0][f"parity/{spec}"]
    assert lead["role"] == "leader"
    # One coalesced dispatch a set, at the server's buckets.
    assert [len(labels) for labels, _pad in lead["dispatches"]] == [3, 3]
    for i, name in enumerate(("lossy", "sure")):
        rows = lead["replayed"][i]
        for r, out in enumerate(ranks):         # every rank's replay
            for a, b in zip(out[f"parity/{spec}"]["replayed"][i], rows):
                np.testing.assert_array_equal(a, b, err_msg=f"rank {r}")
        for j, got in enumerate(lead[name]):
            labels, acc, loss, bias = got
            assert np.array_equal(loss, rows[2][j:j + 1])
            assert np.array_equal(acc, rows[1][j:j + 1])
            assert np.array_equal(bias, rows[3][j:j + 1], equal_nan=True)
            _assert_bits(got, single[f"server/{name}"][j])
            _assert_bits(got, single[f"alone/{name}"][j])


@pytest.mark.parametrize("spec", SPECS)
def test_served_rows_over_ranks_match_the_reference_run_grid(spec):
    want = _reference_sure()
    lead = _ranks()[0][f"parity/{spec}"]
    test_n = len(_torch_ranks.serving_toy()[0].test_y)
    for got in lead["sure"]:
        i = list(want.labels).index(got[0][0])
        _assert_close(got, scenarios.GridResult(
            acc=np.asarray(want.acc)[i:i + 1],
            loss=np.asarray(want.loss)[i:i + 1],
            bias=np.asarray(want.bias)[i:i + 1],
            labels=[want.labels[i]], selected=None), test_n)


@pytest.mark.parametrize("spec", SPECS)
def test_lossy_rows_over_ranks_match_the_reference_on_its_draws(spec):
    """The lossy set's dispatched grid on every rank of the mesh, each
    scenario fed the reference's round draws, against the reference's
    rounds: loss and bias within 1e-5, the same count of correct test
    samples, every chunk (the served rows are this path's bits on the
    port's own draws: the test above)."""
    _draws, want = _reference_lossy()
    test_n = len(_torch_ranks.serving_toy()[0].test_y)
    for r, out in enumerate(_ranks()):
        drawn = out[f"parity/{spec}"]["drawn"]
        assert sorted(drawn) == sorted(want)
        for label, chunks in drawn.items():
            for c, (got, met) in enumerate(zip(chunks, want[label])):
                msg = f"rank {r} {label} chunk {c}"
                np.testing.assert_allclose(got["loss"], met["loss"],
                                           atol=TOL, rtol=0, err_msg=msg)
                np.testing.assert_allclose(
                    got["bias"], np.atleast_1d(met["bias"]), atol=TOL,
                    rtol=0, equal_nan=True, err_msg=msg)
                np.testing.assert_array_equal(
                    np.rint(got["acc"] * test_n),
                    np.rint(np.asarray(met["acc"]) * test_n), err_msg=msg)


@pytest.mark.parametrize("spec", SPECS)
def test_warmup_builds_the_programs_on_every_rank(spec):
    """Every rank's warmup of the two coalesced grids (the same call on
    each, no collective) builds the same programs there, and every
    dispatch then finds them warm."""
    ranks = _ranks()
    for r, out in enumerate(ranks):
        built = out[f"parity/{spec}"]["built"]
        assert built == 2, (r, built)           # an R&A and an AaYG group
        cache = out[f"parity/{spec}"]["cache"]
        # 2 warmups x 2 groups, then 2 dispatches x 2 groups: all but the
        # first warmup's 2 are hits.
        assert cache["misses"] == built and cache["hits"] == 6, (r, cache)


def test_followers_and_outside_ranks_refuse_submits():
    ranks = _ranks()
    for spec in SPECS:
        for r in (1, 2, 3):
            out = ranks[r][f"parity/{spec}"]
            assert out["role"] == "follower"
            assert out["released_at"] is not None
            assert out["not_leader"].startswith(
                f"rank {r} does not take requests: submit to rank 0")
    for r in (2, 3):                             # outside the [0, 1] mesh
        out = ranks[r]["stress"]
        assert out["role"] == "outside" and out["released_at"] is None
        assert "submit to rank 0" in out["not_leader"]


def test_router_over_ranks_survives_a_killed_replica():
    ranks = _ranks()
    lead = ranks[0]["router"]
    assert lead["kind"] == "ScenarioRouter"
    c = lead["counters"]
    assert c["router/requests"] == 6 and sum(lead["served"].values()) == 6
    assert c.get("router/retries", 0) >= 1
    data, nets, _init, _cfg = _torch_ranks.serving_toy()
    for labels, got in zip(lead["requests"], lead["rows"]):
        assert got[0] == labels
    reqs = _torch_ranks.serving_requests(nets) + [
        scenarios.ScenarioGrid.product(
            networks=[(f"s{seed}", nets[seed % 2])],
            protocols=[(proto, "ra_normalized")], seeds=[seed])
        for seed, proto in ((5, "ra"), (6, "aayg"), (7, "ra"))]
    for req, got in zip(reqs, lead["rows"]):
        _assert_bits(got, _alone(req))
    victim = lead["victim"]
    survivor = ({"replica0", "replica1"} - {victim}).pop()
    for r in (1, 2, 3):
        out = ranks[r]["router"]
        assert out["kind"] == "FollowerRouter"
        rel = out["released_at"]
        # The killed replica's followers left their loop at its stop,
        # before the router's stop released the survivor's.
        assert rel[victim] is not None and rel[survivor] is not None
        assert rel[victim] < rel[survivor] and rel[victim] < lead[
            "stopping_at"]


@pytest.mark.parametrize("spec", SPECS)
def test_a_fault_on_any_rank_fails_only_its_batch(spec):
    ranks = _ranks()
    lead = ranks[0][f"faults/{spec}"]
    (k0, m0), (k1, m1), (k2, rows) = lead["outcomes"]
    assert (k0, m0) == ("RuntimeError", "planted on the leader")
    assert k1 == "RankFailed"
    assert m1 == "rank 2 failed: RuntimeError: rank 2's share raised"
    assert k2 == "ok"
    _data, nets, _init, _cfg = _torch_ranks.serving_toy()
    _assert_bits(rows, _alone(_torch_ranks.serving_requests(nets)[2]))
    assert lead["errors"] == 2
    for r in (1, 2, 3):                  # each saw the share's error only
        out = ranks[r][f"faults/{spec}"]
        assert out["errors"] == 1 and out["released_at"] is not None


@pytest.mark.parametrize("mode", ["drain", "hard"])
def test_stop_with_a_dispatch_in_flight_releases_every_follower(mode):
    ranks = _ranks()
    lead = ranks[0][f"stop/{mode}"]
    assert lead["stop_returned"] and lead["pending"] == 0
    if mode == "drain":
        assert lead["outcomes"] == ["ok"] * 3 and lead["dispatched"] == 3
    else:
        # Failed at once; the dispatch in flight finished its collectives
        # and the two behind it never fanned out.
        assert lead["outcomes"] == ["ServerStopped"] * 3
        assert lead["dispatched"] == 1
    for r in (1, 2, 3):
        assert ranks[r][f"stop/{mode}"]["released_at"] is not None


def test_stress_interleaving_over_two_ranks():
    ranks = _ranks()
    lead = ranks[0]["stress"]
    assert lead["role"] == "leader" and lead["workers_alive"] == 0
    assert lead["accepted"] > 0 and lead["pending"] == 0
    allowed = {"result", "cancelled", "ServerStopped", "DeadlineExceeded"}
    assert set(lead["states"]) <= allowed, lead["states"]
    assert ranks[1]["stress"]["role"] == "follower"
    assert ranks[1]["stress"]["released_at"] is not None
