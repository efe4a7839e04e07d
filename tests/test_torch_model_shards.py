"""PyTorch port vs the JAX reference: model-axis sharding over gloo ranks.

* `build_sim(model_shards=2)` on 2 ranks and ``model_shards=3`` on 3
  (S = 7 segments: neither divides it), each rank one shard: fed the
  reference's draws and weights chunk by chunk, the gathered full rows and
  the metrics match the reference's single-device `advance_chunk` (rows
  and losses 1e-4, accuracy within one test sample, the `loss` policy's
  selections exactly), for R&A with the quant codec and the `loss`
  policy, AaYG, C-FL and R&A under a participation mask; `run_scenario`
  with the port's own draws matches the port's ``model_shards=1`` run.
* `run_grid` over a (2, 2) ('grid', 'model') mesh of 4 ranks (by
  ``devices=`` and by ``sharding=``), a (2, 1) mesh and the 1-D mesh of
  all four equals the single-device `run_grid` (trajectories 1e-5,
  accuracy within one test sample) on every rank of the mesh.
* `run_resumable(mesh=)` on a (1, 2) mesh: stopped after one chunk and
  resumed, bit for bit the unbroken run; a checkpoint written by the two
  ranks finishes in a single process, and one written by a single
  process finishes on the two ranks, both equal to the unbroken run.
"""
import functools
import os
import tempfile
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import _torch_ranks  # noqa: E402
from _torch_parity import codec_uniforms, round_uniforms  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.fl import simulator as jsimulator  # noqa: E402
from repro.models import smallnets as jsmall  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import checkpoint  # noqa: E402
from repro_torch.fl import scenarios, simulator  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import smallnets  # noqa: E402

N = _torch_ranks.N
STATICS = _torch_ranks.STATICS
PROTOCOL = {"ra_codec_loss": "ra", "aayg": "aayg", "cfl": "cfl",
            "ra_part": "ra"}


def _jinit(key):
    return jsmall.init_mlp_clf(key, d_in=32, d_hidden=8)


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's weights, links, per-round draws and its
    `advance_chunk` rows and metrics for every scenario."""
    jdata = jsynthetic.fed_image_classification(n_clients=N,
                                                samples_per_client=20)
    jnet = jtopology.make_network(
        jtopology.TABLE_II_COORDS[:N], edge_density=0.8,
        packet_len_bits=20_000, n_clients=N, tx_power_dbm=17.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsim = jsimulator.build_sim(_jinit, jsmall.apply_mlp_clf, jdata,
                                    agg_impl="jnp", **STATICS)
    advance = jax.jit(jsim.advance_chunk)
    s, k = jsim.n_segments, STATICS["seg_len"]
    # build_sim reads the leaf shapes from seed 0; the scenarios use 3.
    weights = {seed: {n: np.asarray(v) for n, v in interop.params_from_jax(
        jax.tree.map(np.asarray, _jinit(jax.random.PRNGKey(seed)))).items()}
               for seed in (0, 3)}
    draws, want = {}, {}
    for name, protocol in PROTOCOL.items():
        jsc = _torch_ranks.scenario_of(jsimulator, jnet, name).prepare()
        state = jsim.init_scan(jsc)
        us, ucs, rows, mets = [], [], [], []
        for c in range(jsim.n_chunks):
            _key, k_round = jax.random.split(state["key"])
            us.append(round_uniforms(protocol, k_round, N, s).numpy())
            ucs.append(codec_uniforms(k_round, N, s, k).numpy())
            state, met = advance(state, jsc, c)
            rows.append(np.asarray(state["w"]))
            mets.append({key: np.asarray(v) for key, v in met.items()})
        codec = jsc.codec_id is not None
        draws[name] = (us, ucs if codec else None)
        want[name] = (rows, mets)
    return weights, np.array(jnet.link_eps), draws, want, s, len(jdata.test_y)


@functools.lru_cache(maxsize=None)
def _replays(dm: int):
    weights, link_eps, draws, _want, _s, _t = _reference()
    return mesh.spawn(_torch_ranks.replay_rank, dm,
                      args=(dm, weights, link_eps, draws), device="cpu",
                      timeout=240)


@pytest.mark.parametrize("name", list(PROTOCOL))
@pytest.mark.parametrize("dm", [2, 3])
def test_sharded_sim_matches_reference_rounds(dm, name):
    _w, _le, _d, want, s, test_n = _reference()
    rows, mets = want[name]
    l_local = -(-s // dm)
    assert s % dm
    for r, out in enumerate(_replays(dm)):
        assert (out["n_segments"], out["l_local"]) == (s, l_local)
        got = out[name]
        assert got["window"] == (N, l_local, STATICS["seg_len"])
        for c, (row, met) in enumerate(zip(rows, mets)):
            label = f"rank {r} chunk {c}"
            np.testing.assert_allclose(got["rows"][c], row, atol=1e-4,
                                       rtol=0, err_msg=label)
            m = got["metrics"][c]
            np.testing.assert_allclose(m["loss"], met["loss"], atol=1e-4,
                                       rtol=0, err_msg=label)
            assert np.abs(m["acc"] - met["acc"]).max() <= 1 / test_n + 1e-6
            np.testing.assert_allclose(m["bias"], np.atleast_1d(met["bias"]),
                                       rtol=1e-4, equal_nan=True,
                                       err_msg=label)
            if "selected" in met:
                np.testing.assert_array_equal(
                    m["selected"], np.atleast_2d(met["selected"]))


@pytest.mark.parametrize("dm", [2, 3])
def test_sharded_run_scenario_matches_one_shard(dm):
    """`run_scenario` with the port's own draws: every shard's metrics
    equal the ``model_shards=1`` run's (on the CPU the same bits)."""
    weights, link_eps, _d, _want, _s, _t = _reference()
    data, net, init_fn = _torch_ranks.toy(weights, link_eps)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim = simulator.build_sim(init_fn, smallnets.apply_mlp_clf, data,
                                  agg_impl="kernel", device="cpu", **STATICS)
    for name in PROTOCOL:
        want = sim.run_scenario(_torch_ranks.scenario_of(simulator, net,
                                                         name))
        for r, out in enumerate(_replays(dm)):
            for key, v in want.items():
                np.testing.assert_allclose(out[name]["run"][key], v.numpy(),
                                           atol=1e-6, rtol=0, equal_nan=True,
                                           err_msg=f"{name} rank {r} {key}")


@functools.lru_cache(maxsize=None)
def _grid_and_resume():
    """The single-process side (the unsharded grid, an unbroken
    `run_resumable`, a checkpoint after one chunk), 4 ranks, and the
    single process resuming the ranks' one-chunk checkpoint."""
    data, net, init_fn = _torch_ranks.toy()
    cfg = simulator.SimConfig(agg_impl="kernel", **STATICS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        grid = scenarios.run_grid(init_fn, smallnets.apply_mlp_clf, data,
                                  _torch_ranks.grid_of(net), cfg,
                                  device="cpu")
        policy = scenarios.run_grid(init_fn, smallnets.apply_mlp_clf, data,
                                    _torch_ranks.policy_grid_of(net), cfg,
                                    device="cpu")
        sim = simulator.build_sim(init_fn, smallnets.apply_mlp_clf, data,
                                  agg_impl="kernel", device="cpu", **STATICS)
    sc = _torch_ranks.scenario_of(simulator, net, "ra_codec_loss")
    with tempfile.TemporaryDirectory() as d:
        unbroken = checkpoint.run_resumable(sim, sc,
                                            ckpt_dir=os.path.join(d, "one"))
        assert checkpoint.run_resumable(
            sim, sc, ckpt_dir=os.path.join(d, "single"),
            stop_after=1) is None
        ranks = mesh.spawn(_torch_ranks.grid_and_resume_rank, 4, args=(d,),
                           device="cpu", timeout=300)
        assert checkpoint.latest_step(os.path.join(d, "to_single")) == 0
        finished = checkpoint.run_resumable(
            sim, sc, ckpt_dir=os.path.join(d, "to_single"))
    return grid, unbroken, ranks, finished, len(data.test_y), policy


@pytest.mark.parametrize("spec", ["(None, 2)", "sharding", "(2, 1)",
                                  "[0, 1, 2, 3]"])
def test_run_grid_over_meshes_matches_one_device(spec):
    want, _u, ranks, _f, test_n, _p = _grid_and_resume()
    for r, out in enumerate(ranks):
        got = out[spec]
        if spec == "(2, 1)" and r >= 2:      # outside the (2, 1) mesh
            assert got is None
            continue
        labels, acc, loss, bias = got
        assert labels == want.labels
        np.testing.assert_allclose(loss, want.loss, atol=1e-5, rtol=0)
        np.testing.assert_allclose(bias, want.bias, atol=1e-5, rtol=0,
                                   equal_nan=True)
        assert np.abs(acc - want.acc).max() <= 1 / test_n + 1e-6


def test_closed_loop_grid_over_a_model_sharded_mesh():
    """A selection-policy group through `run_grid` on the (2, 2) mesh: the
    closed loop reads each client's full-row signal, so every rank's
    selection and trajectories equal the single-device grid's."""
    _g, _u, ranks, _f, test_n, want = _grid_and_resume()
    assert want.selected is not None
    for r, out in enumerate(ranks):
        labels, acc, loss, bias, selected = out["policy"]
        assert labels == want.labels
        np.testing.assert_array_equal(selected, want.selected,
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(loss, want.loss, atol=1e-5, rtol=0)
        np.testing.assert_allclose(bias, want.bias, atol=1e-5, rtol=0,
                                   equal_nan=True)
        assert np.abs(acc - want.acc).max() <= 1 / test_n + 1e-6


def test_run_resumable_on_a_mesh_resumes_and_crosses_topologies():
    _g, unbroken, ranks, finished, _t, _p = _grid_and_resume()
    for r in (0, 1):
        out = ranks[r]
        assert "needs a mesh with a 'model' axis" in out["no_mesh"]
        assert "unsharded pytree-state API" in out["round_step"]
        for key, v in out["unbroken"].items():
            np.testing.assert_array_equal(out["resumed"][key], v,
                                          err_msg=key)
            for other in (out["from_single"], unbroken, finished):
                np.testing.assert_allclose(other[key], v, atol=1e-6,
                                           rtol=0, err_msg=key)
    assert "unbroken" not in ranks[2] and "unbroken" not in ranks[3]
