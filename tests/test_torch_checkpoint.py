"""PyTorch port vs the JAX reference: checkpointing and the resumable loop.

* The tree layer (`save` / `restore` / `latest_step`): the reference's
  tests (tests/test_substrates.py) on trees of tensors, and every torn
  write raising `CorruptCheckpoint` with the reference's message, word for
  word (paths aside).
* `run_resumable` on the CPU, bit for bit: an uninterrupted run, a run
  interrupted after one chunk and resumed, and a resume of a finished run
  against `SimPrograms.run_scenario`, for an R&A scenario, a closed-loop
  (`loss` policy) one and ``eval_every = 3``; the generator comes back in
  the state it was saved in.
* Against the reference's `run_resumable` on the same configuration: the
  same metric keys, shapes and dtypes, and the same ``step`` recorded.
"""
import json
import os
import tempfile
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (fixes the thread count)
from repro.checkpoint import checkpoint as jcheckpoint  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.fl import simulator as jsimulator  # noqa: E402
from repro.models import smallnets as jsmall  # noqa: E402
from repro_torch.checkpoint import checkpoint  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.fl import simulator  # noqa: E402
from repro_torch.models import smallnets  # noqa: E402

# The reference tests' toy: 3 clients, 20 samples, a 32-16 MLP, 64-value
# segments, 2 local epochs.  (rounds, eval_every, make_scenario keywords)
RUNS = {
    "ra": (3, 1, {}),
    "closed_loop": (4, 2, dict(sampling_policy="loss", select_frac=0.67)),
    "eval_every3": (6, 3, {}),
}


def _tinit(g):
    return smallnets.init_mlp_clf(g, d_in=32, d_hidden=16)


def _net(module):
    return module.make_network(
        module.TABLE_II_COORDS[:3], edge_density=0.8,
        packet_len_bits=32 * 64, n_clients=3, tx_power_dbm=17.0)


def _sim_and_scenario(name):
    rounds, every, kw = RUNS[name]
    data = synthetic.fed_image_classification(n_clients=3,
                                              samples_per_client=20, seed=0)
    sim = simulator.build_sim(_tinit, smallnets.apply_mlp_clf, data,
                              seg_len=64, local_epochs=2, n_rounds=rounds,
                              eval_every=every, device="cpu")
    cfg = simulator.SimConfig(n_rounds=rounds, seg_len=64, local_epochs=2,
                              eval_every=every, seed=3)
    return sim, simulator.make_scenario(_net(topology), cfg, **kw), cfg


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn(4, 5, generator=g),
            "b": {"c": torch.arange(7), "d": torch.tensor(3.5),
                  "e": np.arange(3, dtype=np.int32)},
            "f": (torch.ones(2, dtype=torch.bool), 2.5)}


def _leaves(tree):
    return [leaf for _, leaf in checkpoint._flatten(tree)]


def test_checkpoint_roundtrip():
    tree = _tree()
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, tree, step=42)
        like = {"a": torch.zeros(4, 5),
                "b": {"c": torch.zeros(7, dtype=torch.int64),
                      "d": torch.tensor(0.0),
                      "e": np.zeros(3, np.int32)},
                "f": (torch.zeros(2, dtype=torch.bool), 0.0)}
        back = checkpoint.restore(d, like)
        assert checkpoint.latest_step(d) == 42
        man = json.load(open(os.path.join(d, "manifest.json")))
    assert man["keys"] == ["['a']", "['b']['c']", "['b']['d']", "['b']['e']",
                           "['f'][0]", "['f'][1]"]
    assert man["dtypes"] == ["float32", "int64", "float32", "int32", "bool",
                             "float64"]
    assert isinstance(back["b"]["e"], np.ndarray)
    assert isinstance(back["f"], tuple) and back["f"][1] == 2.5
    for x, y in zip(_leaves(tree), _leaves(back)):
        assert type(x) is type(y)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_roundtrip_bfloat16_and_namedtuple():
    """A bfloat16 tensor comes back bit for bit (stored as its 16-bit
    pattern); a NamedTuple (the selection signals) keeps its type."""
    sig = simulator.selection.SelectionSignals(
        loss=torch.tensor([0.5, 1.5]), upd_norm=torch.tensor([np.inf, 2.0]))
    w = torch.randn(3, 4, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, {"w": w, "sig": sig})
        man = json.load(open(os.path.join(d, "manifest.json")))
        back = checkpoint.restore(d, {"w": torch.zeros(3, 4,
                                                       dtype=torch.bfloat16),
                                      "sig": sig._replace(
                                          loss=torch.zeros(2),
                                          upd_norm=torch.zeros(2))})
    assert man["keys"] == ["['sig'].loss", "['sig'].upd_norm", "['w']"]
    assert man["dtypes"][2] == "bfloat16"
    assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))
    assert type(back["sig"]) is type(sig)
    assert torch.equal(back["sig"].upd_norm, sig.upd_norm)


def test_checkpoint_shape_mismatch_raises():
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, {"a": torch.zeros(2, 2)})
        with pytest.raises(ValueError, match=r"shape mismatch at \['a'\]"):
            checkpoint.restore(d, {"a": torch.zeros(3, 3)})
        with pytest.raises(ValueError, match="1 leaves, target has 2"):
            checkpoint.restore(d, {"a": torch.zeros(2, 2),
                                   "b": torch.zeros(1)})


def test_checkpoint_dtype_mismatch_raises_unless_cast():
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, {"a": torch.arange(4, dtype=torch.float32)})
        want = {"a": torch.zeros(4, dtype=torch.bfloat16)}
        with pytest.raises(ValueError, match="dtype mismatch"):
            checkpoint.restore(d, want)
        back = checkpoint.restore(d, want, cast=True)
        assert back["a"].dtype == torch.bfloat16
        np.testing.assert_array_equal(back["a"].float().numpy(),
                                      np.arange(4, dtype=np.float32))
    # The same message as the reference's, for the same mismatch.
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as dj:
        checkpoint.save(d, {"a": torch.arange(4, dtype=torch.float32)})
        jcheckpoint.save(dj, {"a": jnp.arange(4, dtype=jnp.float32)})
        with pytest.raises(ValueError) as got:
            checkpoint.restore(d, {"a": torch.zeros(4, dtype=torch.bfloat16)})
        with pytest.raises(ValueError) as want_msg:
            jcheckpoint.restore(dj, {"a": jnp.zeros(4, jnp.bfloat16)})
    assert str(got.value) == str(want_msg.value)


def test_checkpoint_latest_step_disambiguates():
    """No checkpoint at all raises; a stepless checkpoint returns None."""
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            checkpoint.latest_step(d)
        checkpoint.save(d, {"a": torch.zeros(2)})
        assert checkpoint.latest_step(d) is None
        checkpoint.save(d, {"a": torch.zeros(2)}, step=7)
        assert checkpoint.latest_step(d) == 7


def test_checkpoint_save_is_atomic_no_partial_files():
    """`save` stages in a temp dir and `os.replace`s into place: after a
    save the directory holds exactly the two final files (no temp
    leftovers), and an overwriting save fully replaces BOTH of them."""
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, {"a": torch.zeros(3)}, step=1)
        assert sorted(os.listdir(d)) == ["arrays.npz", "manifest.json"]
        checkpoint.save(d, {"a": torch.ones(3)}, step=2)
        assert sorted(os.listdir(d)) == ["arrays.npz", "manifest.json"]
        back = checkpoint.restore(d, {"a": torch.zeros(3)})
        np.testing.assert_array_equal(back["a"].numpy(), np.ones(3))
        assert checkpoint.latest_step(d) == 2


def _tear(module, d, tree, bump, kind):
    """Leave one torn state in ``d`` (as tests/test_substrates.py does)."""
    module.save(d, tree, step=3)
    if kind == "no_arrays":
        os.unlink(os.path.join(d, "arrays.npz"))
    elif kind == "save_id":
        old = open(os.path.join(d, "manifest.json")).read()
        module.save(d, bump(tree), step=4)
        with open(os.path.join(d, "manifest.json"), "w") as f:
            f.write(old)
    else:
        man_path = os.path.join(d, "manifest.json")
        man = json.load(open(man_path))
        man["keys"].append("['extra']")
        json.dump(man, open(man_path, "w"))


@pytest.mark.parametrize("kind,match", [("no_arrays", "no arrays"),
                                        ("save_id", "save_id"),
                                        ("count", "arrays")])
def test_checkpoint_torn_write_raises_the_reference_message(kind, match):
    """The three torn states a crash can leave: manifest without payload,
    payload/manifest from different saves, wrong array count — each is a
    named `CorruptCheckpoint` with the reference's message, and
    `latest_step` refuses to resume it."""
    tree = {"a": torch.arange(4.0), "b": torch.zeros(2, 2)}
    jtree = {"a": jnp.arange(4.0), "b": jnp.zeros((2, 2))}
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as dj:
        _tear(checkpoint, d, tree, lambda t: {k: v + 1 for k, v in t.items()},
              kind)
        _tear(jcheckpoint, dj, jtree, lambda t: jax.tree.map(
            lambda x: x + 1, t), kind)
        with pytest.raises(checkpoint.CorruptCheckpoint, match=match) as got:
            checkpoint.restore(d, {k: torch.zeros_like(v)
                                   for k, v in tree.items()})
        with pytest.raises(checkpoint.CorruptCheckpoint):
            checkpoint.latest_step(d)
        with pytest.raises(jcheckpoint.CorruptCheckpoint) as want:
            jcheckpoint.restore(dj, jax.tree.map(jnp.zeros_like, jtree))
        ids = [json.load(open(os.path.join(x, "manifest.json")))["save_id"]
               for x in (d, dj)]
        npz = [str(np.load(os.path.join(x, "arrays.npz"))["__save_id__"])
               if kind == "save_id" else None for x in (d, dj)]
    mine = str(got.value).replace(repr(d), "<path>")
    theirs = str(want.value).replace(repr(dj), "<path>")
    for a, b in ((ids[0], ids[1]), (npz[0], npz[1])):
        if a is not None:
            mine = mine.replace(a, "<id>")
            theirs = theirs.replace(b, "<id>")
    assert mine == theirs


# ----------------------------------------------------------------------
# run_resumable
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(RUNS))
def test_resumable_matches_run_scenario_bit_for_bit(name):
    """Uninterrupted, interrupted after one chunk and resumed, and a
    resume of the finished run (replays nothing): each equals
    `run_scenario` bit for bit."""
    sim, sc, _cfg = _sim_and_scenario(name)
    ref = sim.run_scenario(sc)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        full = checkpoint.run_resumable(sim, sc, ckpt_dir=d1)
        assert checkpoint.run_resumable(sim, sc, ckpt_dir=d2,
                                        stop_after=1) is None
        assert checkpoint.latest_step(d2) == 0
        resumed = checkpoint.run_resumable(sim, sc, ckpt_dir=d2)
        assert checkpoint.latest_step(d2) == sim.n_chunks - 1
        again = checkpoint.run_resumable(sim, sc, ckpt_dir=d2)
    assert sorted(full) == sorted(ref)
    for k in ref:
        for got in (full, resumed, again):
            assert isinstance(got[k], np.ndarray)
            np.testing.assert_array_equal(got[k], ref[k].numpy(), err_msg=k)


def test_resumable_save_every_and_torn_checkpoint_restart():
    """``save_every = 2`` over 3 chunks saves after chunks 1 and 2; an
    interruption past the last save recomputes from it; a torn
    checkpoint restarts from round 0; all equal `run_scenario`."""
    sim, sc, _cfg = _sim_and_scenario("ra")
    ref = sim.run_scenario(sc)
    with tempfile.TemporaryDirectory() as d:
        assert checkpoint.run_resumable(sim, sc, ckpt_dir=d, save_every=2,
                                        stop_after=1) is None
        with pytest.raises(FileNotFoundError):
            checkpoint.latest_step(d)          # chunk 0 is not a save point
        assert checkpoint.run_resumable(sim, sc, ckpt_dir=d, save_every=2,
                                        stop_after=2) is None
        assert checkpoint.latest_step(d) == 1
        resumed = checkpoint.run_resumable(sim, sc, ckpt_dir=d, save_every=2)
        os.unlink(os.path.join(d, "arrays.npz"))
        restarted = checkpoint.run_resumable(sim, sc, ckpt_dir=d)
        fresh = checkpoint.run_resumable(sim, sc, ckpt_dir=d, resume=False)
    for got in (resumed, restarted, fresh):
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k].numpy(), err_msg=k)
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        checkpoint.run_resumable(sim, sc, ckpt_dir="unused", mesh="mesh")


def test_resumable_restores_the_generator_state():
    """The checkpoint after chunk 0 holds the generator as the
    uninterrupted run leaves it; restored into a fresh generator it
    draws the same numbers."""
    sim, sc, _cfg = _sim_and_scenario("closed_loop")
    scp = sc.prepare()
    state = sim.init_scan(scp)
    state, _row = sim.advance_chunk(state, scp)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.run_resumable(sim, sc, ckpt_dir=d, stop_after=1)
        like = {"state": checkpoint._saved_state(sim.init_scan(scp)),
                "metrics": {k: np.zeros((1,) + v.shape, v.dtype)
                            for k, v in checkpoint._row_like(sim,
                                                             True).items()},
                "round_idx": np.int32(0)}
        payload = checkpoint.restore(d, like)
    assert int(payload["round_idx"]) == sim.eval_every
    live = checkpoint._live_state(payload["state"], sim.device)
    assert live["t"] == state["t"] == sim.eval_every
    assert torch.equal(live["gen"].get_state(), state["gen"].get_state())
    assert torch.equal(live["w"], state["w"])
    for a, b in zip(live["sig"], state["sig"]):
        assert torch.equal(a, b)
    assert torch.equal(torch.rand(5, generator=live["gen"]),
                       torch.rand(5, generator=state["gen"]))


@pytest.mark.parametrize("name", ["ra", "closed_loop"])
def test_resumable_metrics_match_the_reference_layout(name):
    """The reference's `run_resumable` on the same configuration: the same
    metric keys, shapes and dtypes, and the same steps recorded."""
    rounds, every, kw = RUNS[name]
    jdata = jsynthetic.fed_image_classification(n_clients=3,
                                                samples_per_client=20,
                                                seed=0)
    jsim = jsimulator.build_sim(
        lambda k: jsmall.init_mlp_clf(k, d_in=32, d_hidden=16),
        jsmall.apply_mlp_clf, jdata, seg_len=64, local_epochs=2,
        n_rounds=rounds, eval_every=every)
    jcfg = jsimulator.SimConfig(n_rounds=rounds, seg_len=64, local_epochs=2,
                                eval_every=every, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsc = jsimulator.make_scenario(_net(jtopology), jcfg, **kw)
    sim, sc, _cfg = _sim_and_scenario(name)
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as dj:
        assert checkpoint.run_resumable(sim, sc, ckpt_dir=d,
                                        stop_after=1) is None
        assert jcheckpoint.run_resumable(jsim, jsc, ckpt_dir=dj,
                                         stop_after=1) is None
        assert checkpoint.latest_step(d) == jcheckpoint.latest_step(dj) == 0
        got = checkpoint.run_resumable(sim, sc, ckpt_dir=d)
        want = jcheckpoint.run_resumable(jsim, jsc, ckpt_dir=dj)
        assert (checkpoint.latest_step(d) == jcheckpoint.latest_step(dj)
                == sim.n_chunks - 1)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, k
        assert got[k].dtype == np.asarray(want[k]).dtype, k
