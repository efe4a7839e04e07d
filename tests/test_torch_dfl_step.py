"""PyTorch port vs the JAX reference: `core.dfl_step` over 8 gloo ranks.

* `ra_exchange` for comm in {all_to_all, reduce_scatter, psum}, without
  and with the participation mask [1, 0, 1, 1, 0, 1, 1, 1], on 8 CPU ranks
  (`launch.mesh.spawn`), against the reference's `ra_exchange` under
  `shard_map` over 8 forced host devices (a JAX subprocess; the mesh is
  built with `jax.sharding.Mesh`), and against the segment-level round
  (the reference's `ra_round_seg` and the port's `ra_round_seg`) fed the
  same draws: within 1e-5, sampled-out ranks bit for bit their own.
* `make_dfl_train_step` with the `loss` and `grad_norm` policies, as the
  reference's tests/test_selection.py builds it: client i moves by about
  i while its loss falls with i, so the policies select opposite halves;
  both match the reference's round, and the two exchanges differ.
"""
import functools
import os
import subprocess
import sys
import tempfile
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (fixes the thread count)
import _torch_ranks  # noqa: E402
from repro_torch.core import dfl_step, protocols  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402

N = 8
SEG_LEN = 6                      # 30 parameters -> 5 segments
MASK = np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32)
MASKS = {"none": None, "mask": MASK}

_ORACLE = textwrap.dedent("""
    import inspect, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from repro.core import dfl_step, protocols

    nocheck = ({"check_vma": False}
               if "check_vma" in inspect.signature(shard_map).parameters
               else {"check_rep": False})
    inp = dict(np.load(sys.argv[1]))
    n, seg_len = 8, int(inp["seg_len"])
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("clients",))
    params = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
    p, rho = jnp.asarray(inp["p"]), jnp.asarray(inp["rho"])
    key = jax.random.PRNGKey(int(inp["key"]))
    mask = jnp.asarray(inp["mask"])
    w_seg, spec, m_params = protocols._to_segments(params, seg_len)
    res = {"u": np.asarray(jax.random.uniform(key, (n, n, w_seg.shape[1])))}
    for mname, part in (("none", None), ("mask", mask)):
        out, _ = protocols.ra_round_seg(w_seg, p, rho, key, jnp.asarray(0),
                                        part)
        for k, v in protocols._from_segments(out, spec, m_params).items():
            res[f"round/{mname}/{k}"] = np.asarray(v)

    def local_step(state, batch):
        moved = jax.tree.map(lambda x: x + 0.01 * state["loss"],
                             state["params"])
        return dict(state, params=moved), {"loss": 7.0 - state["loss"]}

    rounds = {pol: dfl_step.make_dfl_train_step(
                  local_step, axis="clients", p=p, seg_len=seg_len,
                  n_local_steps=2, selection_policy=pol, select_frac=0.5)
              for pol in ("loss", "grad_norm")}

    def everything(st, p, rho, k, pt, loss):
        mine = jax.tree.map(lambda x: x[0], st)
        outs = {}
        for comm in ("all_to_all", "reduce_scatter", "psum"):
            for mname, part in (("none", None), ("mask", pt)):
                o = dfl_step.ra_exchange(mine, p, rho, k, axis="clients",
                                         seg_len=seg_len, comm=comm,
                                         participation=part)
                for name, v in o.items():
                    outs[f"exchange/{comm}/{mname}/{name}"] = v[None]
        for pol, fn in rounds.items():
            s2, _ = fn({"params": mine, "loss": loss[0]}, None, rho, k)
            for name, v in s2["params"].items():
                outs[f"dfl/{pol}/{name}"] = v[None]
        return outs

    names = ([f"exchange/{c}/{m}/{k}"
              for c in ("all_to_all", "reduce_scatter", "psum")
              for m in ("none", "mask") for k in ("b", "w")]
             + [f"dfl/{pol}/{k}" for pol in ("loss", "grad_norm")
                for k in ("b", "w")])
    leaf = {"w": P("clients"), "b": P("clients")}
    got = jax.jit(shard_map(
        everything, mesh=mesh,
        in_specs=(leaf, P(), P(), P(), P(), P("clients")),
        out_specs={nm: P("clients") for nm in names}, **nocheck))(
            params, p, rho, key, mask, jnp.arange(n, dtype=jnp.float32))
    res.update({k: np.asarray(v) for k, v in got.items()})
    np.savez(sys.argv[2], **res)
    print("ORACLE_OK")
""")


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    logits = rng.normal(size=N)
    return dict(w=rng.normal(size=(N, 4, 6)).astype(np.float32),
                b=rng.normal(size=(N, 6)).astype(np.float32),
                p=(np.exp(logits) / np.exp(logits).sum()).astype(np.float32),
                rho=rng.uniform(0.3, 0.95, (N, N)).astype(np.float32),
                key=42, mask=MASK, seg_len=SEG_LEN)


@functools.lru_cache(maxsize=None)
def _runs():
    """(inputs, the reference's outputs, every rank's outputs): one JAX
    subprocess with 8 host devices, one spawn of 8 gloo ranks."""
    inp = _inputs()
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "in.npz"), **inp)
        env = dict(os.environ, PYTHONPATH=os.path.join(
            os.path.dirname(__file__), "..", "src"))
        out = subprocess.run(
            [sys.executable, "-c", _ORACLE, os.path.join(d, "in.npz"),
             os.path.join(d, "out.npz")],
            capture_output=True, text=True, env=env, timeout=300)
        assert "ORACLE_OK" in out.stdout, out.stdout + out.stderr
        ref = dict(np.load(os.path.join(d, "out.npz")))
    inp["u"] = ref["u"]
    ranks = mesh.spawn(_torch_ranks.dfl_exchange_rank, N, args=(inp,),
                       device="cpu", timeout=240)
    return inp, ref, ranks


@pytest.mark.parametrize("mname", ["none", "mask"])
@pytest.mark.parametrize("comm", _torch_ranks.COMMS)
def test_ra_exchange_matches_reference_shard_map(comm, mname):
    inp, ref, ranks = _runs()
    part = MASKS[mname]
    # The port's own segment-level round on the same draws.
    stacked = {k: torch.from_numpy(inp[k]) for k in ("b", "w")}
    w_seg, spec, m_params = protocols._to_segments(stacked, SEG_LEN)
    out, _e = protocols.ra_round_seg(
        w_seg, torch.from_numpy(inp["p"]), torch.from_numpy(inp["rho"]), 0,
        None if part is None else torch.from_numpy(part),
        u=torch.from_numpy(inp["u"]))
    port_round = protocols._from_segments(out, spec, m_params)
    for r in range(N):
        got = ranks[r][f"exchange/{comm}/{mname}"]
        assert list(got) == ["w", "b"]        # the caller's key order
        assert ranks[r][f"dtypes/{comm}/{mname}"] == {"w": "torch.float32",
                                                      "b": "torch.float32"}
        for k in ("w", "b"):
            for want in (ref[f"exchange/{comm}/{mname}/{k}"][r],
                         ref[f"round/{mname}/{k}"][r],
                         port_round[k][r].numpy()):
                np.testing.assert_allclose(got[k], want, atol=1e-5, rtol=0,
                                           err_msg=f"rank {r} {k}")
            if part is not None and part[r] == 0:
                np.testing.assert_array_equal(got[k], inp[k][r])
            else:
                assert not np.array_equal(got[k], inp[k][r])


def test_ra_exchange_collective_bytes_and_errors():
    """Each rank hands every comm its (N, L, K) float32 contributions, twice
    (without and with the mask); the selection all-gathers 2 floats a
    policy round.  A comm or group size the exchange does not know
    raises."""
    _inp, _ref, ranks = _runs()
    contrib = N * 5 * SEG_LEN * 4
    for r in range(N):
        assert ranks[r]["wire_bytes"] == {
            "all_to_all": 2 * contrib, "reduce_scatter": 2 * contrib,
            "all_reduce": 2 * contrib, "all_gather": 0}
    with pytest.raises(ValueError, match="unknown comm mode"):
        dfl_step.ra_exchange({"w": torch.zeros(3)}, torch.ones(2),
                             torch.ones(2, 2), seg_len=2, comm="ring")


@pytest.mark.parametrize("policy", _torch_ranks.POLICIES)
def test_dfl_train_step_selects_as_the_reference(policy):
    inp, ref, ranks = _runs()
    # loss signal 7 - i falls with i, the update norm rises with i.
    kept = set(range(4, 8)) if policy == "loss" else set(range(4))
    for r in range(N):
        got = ranks[r][f"dfl/{policy}"]
        moved = ranks[r][f"moved/{policy}"]
        np.testing.assert_array_equal(ranks[r][f"metrics/{policy}"],
                                      np.full(2, 7.0 - r, np.float32))
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], ref[f"dfl/{policy}/{k}"][r],
                                       atol=1e-5, rtol=0,
                                       err_msg=f"rank {r} {k}")
            assert np.array_equal(got[k], moved[k]) == (r in kept), (r, k)
    assert not np.allclose(ranks[0]["dfl/loss"]["w"],
                           ranks[0]["dfl/grad_norm"]["w"])
