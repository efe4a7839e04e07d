"""PyTorch port vs the JAX reference: model-axis windows, the protocols'
``seg_total`` / ``seg_start``, and `launch.mesh`.

* `errors.local_slice` equals the reference's for every window that holds
  a real segment (the straddling one included), S divisible and not
  divisible by the shard count.
* R&A, AaYG and C-FL run window by window (``seg_total`` / ``seg_start``,
  the reference's draws at the full width): each window equals the
  reference's sharded round (1e-5), the W windows concatenated equal the
  port's unsharded round (1e-6), and R&A returns the full mask, equal to
  the reference's.
* The mesh builders on 4 gloo ranks: the reference's errors
  (tests/test_mesh2d.py), coordinates, fingerprints that tell meshes
  apart, the shrunk mesh, `gather_along`'s order; a call naming several
  ranks in a process with no process group raises naming
  `launch.mesh.spawn`; `spawn` raises the first failing rank's exception;
  a grid run whose share raises on one rank (rank 1 of the 1-D mesh, or
  one model shard alone, mid-run, on the (2, 2) mesh) raises `RankFailed`
  naming it on every rank, and the next run is served.
* A rank that leaves its model group's all-gather while its peer is inside
  it (rank 2 of the (2, 2) mesh, after the status exchange): with the
  private mesh's model groups bounded to a few seconds, every rank raises
  `RankFailed` naming rank 2 once the bound has passed, the mesh is broken
  and its next run raises `MeshBroken`; a server over the same ranks fails
  that dispatch with `RankFailed` and refuses the next one with
  `MeshBroken`, and the whole spawn returns within the bounds and 30 s.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_ranks  # noqa: E402
from _torch_parity import round_uniforms  # noqa: E402
from repro.core import errors as jerrors  # noqa: E402
from repro.core import protocols as jprot  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro_torch.core import errors, protocols  # noqa: E402
from repro_torch.fl import simulator  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import smallnets  # noqa: E402

N = 6


@pytest.mark.parametrize("s,shards", [(12, 3), (12, 4), (10, 3), (10, 4),
                                      (7, 2), (5, 4)])
def test_local_slice_matches_reference(s, shards):
    full = np.random.default_rng(s).normal(size=(3, 4, s)).astype(np.float32)
    n_local = -(-s // shards)
    for coord in range(shards):
        start = coord * n_local
        if start >= s:               # a window of padding only
            continue
        got = errors.local_slice(torch.from_numpy(full), n_local, start)
        want = jerrors.local_slice(jnp.asarray(full), n_local, start)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        real = min(n_local, s - start)
        np.testing.assert_array_equal(got[..., :real].numpy(),
                                      full[..., start:start + real])
        assert not got[..., real:].any()     # past S: zeros, not shifted
    mask = errors.local_slice(torch.ones(2, s, dtype=torch.bool), n_local,
                              (shards - 1) * n_local)
    assert mask.dtype == torch.bool and mask.shape == (2, n_local)


@functools.lru_cache(maxsize=None)
def _setup(seed=0, s=7, k=5):
    rng = np.random.default_rng(seed)
    net = jtopology.make_network(jtopology.TABLE_II_COORDS[:N],
                                 packet_len_bits=20_000, n_clients=N,
                                 tx_power_dbm=17.0)
    link_eps = np.array(net.link_eps)
    rho = np.array(jrouting.e2e_success(jnp.asarray(link_eps))[0])
    w = rng.normal(size=(N, s, k)).astype(np.float32)
    p = rng.dirichlet(np.ones(N)).astype(np.float32)
    part = np.array([1, 1, 0, 1, 0, 1], np.float32)
    tx = rng.uniform(size=(N, s)) > 0.3
    return w, p, rho, link_eps, part, tx


def _windows(fn, w, shards, **kw):
    """``fn`` on each of the ``shards`` windows of ``w``'s segment axis."""
    s = w.shape[1]
    n_local = -(-s // shards)
    padded = torch.nn.functional.pad(w, (0, 0, 0, n_local * shards - s))
    return [fn(padded[:, c * n_local:(c + 1) * n_local], seg_total=s,
               seg_start=c * n_local, **kw) for c in range(shards)]


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("protocol", ["ra", "aayg", "cfl"])
def test_sharded_rounds_match_reference_and_unsharded(protocol, shards):
    w, p, rho, link_eps, part, tx = _setup()
    s = w.shape[1]
    key = jax.random.PRNGKey(7)
    u = round_uniforms(protocol, key, N, s, n_mixes=2)
    tw, tp, trho, tle = (torch.from_numpy(x) for x in (w, p, rho, link_eps))
    tpart, ttx = torch.from_numpy(part), torch.from_numpy(tx)
    mode = 1 if protocol == "cfl" else 0
    if protocol == "ra":
        def port(x, **kw):
            return protocols.ra_round_seg(x, tp, trho, mode, tpart,
                                          tx_mask=ttx, u=u,
                                          agg_impl="kernel", **kw)

        def ref(x, **kw):
            return jprot.ra_round_seg(x, p, rho, key, jnp.asarray(mode),
                                      part, tx_mask=tx, agg_impl="jnp",
                                      **kw)
    elif protocol == "aayg":
        def port(x, **kw):
            return protocols.aayg_round_seg(x, tp, tle, mode, n_mixes=2,
                                            participation=tpart, tx_mask=ttx,
                                            u=u, agg_impl="kernel", **kw)

        def ref(x, **kw):
            return jprot.aayg_round_seg(x, p, link_eps, key,
                                        jnp.asarray(mode), n_mixes=2,
                                        participation=part, tx_mask=tx,
                                        agg_impl="jnp", **kw)
    else:
        def port(x, **kw):
            return protocols.cfl_round_seg(x, tp, trho, mode, 2, tpart,
                                           tx_mask=ttx, u=u, **kw)

        def ref(x, **kw):
            return jprot.cfl_round_seg(x, p, rho, key, jnp.asarray(mode),
                                       jnp.asarray(2), part, tx_mask=tx,
                                       **kw)
    whole = port(tw)
    got = _windows(port, tw, shards)
    want = _windows(lambda x, **kw: ref(jnp.asarray(x.numpy()), **kw), tw,
                    shards)
    if protocol == "ra":
        for out, e in got:             # every shard returns the full mask
            np.testing.assert_array_equal(e.numpy(), whole[1].numpy())
            np.testing.assert_array_equal(e.numpy(), np.asarray(want[0][1]))
        whole, got, want = whole[0], [g[0] for g in got], [r[0] for r in want]
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0)
    joined = torch.cat(got, dim=1)[:, :s]
    np.testing.assert_allclose(joined.numpy(), whole.numpy(), atol=1e-6,
                               rtol=0)
    assert not torch.cat(got, dim=1)[:, s:].any()


def test_sharded_dispatch_keeps_full_width_masks():
    """`dispatch_round_seg` on a window: the R&A mask and the all-ones
    mask of the other protocols come back at the full (N, N, S); the
    bias diagnostic is the unsharded one."""
    w, p, rho, link_eps, _part, _tx = _setup()
    s = w.shape[1]
    tw, tp, trho, tle = (torch.from_numpy(x) for x in (w, p, rho, link_eps))
    u = torch.rand((N, N, s), generator=torch.Generator().manual_seed(1))
    _o, e_full, b_full = protocols.dispatch_round_seg(
        tw, tp, trho, tle, 0, 0, 1, u=u)
    for pid in (0, 1, 2, 3, 4):
        draw = {0: u, 1: u[None], 2: u[:2, :, :]}.get(pid)
        outs = _windows(lambda x, **kw: protocols.dispatch_round_seg(
            x, tp, trho, tle, pid, 0, 1, u=draw, **kw), tw, 2)
        for _out, e, bias in outs:
            assert tuple(e.shape) == (N, N, s)
            if pid == 0:
                np.testing.assert_array_equal(e.numpy(), e_full.numpy())
                np.testing.assert_allclose(bias.item(), b_full.item(),
                                           rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _builders():
    return mesh.spawn(_torch_ranks.mesh_builders_rank, 4, device="cpu",
                      timeout=120)


def test_mesh_builders_errors_and_fingerprints():
    """tests/test_mesh2d.py's builder checks, rank by rank."""
    for r, out in enumerate(_builders()):
        assert out["axes"] == (("grid",), ("grid", "model"))
        assert out["shapes"] == ({"grid": 4}, {"grid": 2, "model": 2},
                                 {"grid": 4, "model": 1})
        assert out["coords"][:2] == ({"grid": r},
                                     {"grid": r // 2, "model": r % 2})
        assert out["same_object"] and out["fingerprint_stable"]
        assert out["fingerprints_distinct"]
        errs = out["errors"]
        assert "model_shards=0 must be >= 1" in errs["model_shards=0"]
        assert "do not factor into model_shards=2" in errs["3 % 2"]
        assert "launch.mesh.spawn" in errs["5 > world"]
        assert "default process group has 4" in errs["5 > world"]


def test_mesh_coordinates_shrink_and_gather_order():
    order = [3, 1, 2, 0]
    for r, out in enumerate(_builders()):
        pos = order.index(r)
        assert out["coords"][2] == {"grid": pos // 2, "model": pos % 2}
        assert out["coords"][3] == ({"grid": [1, 2].index(r)}
                                    if r in (1, 2) else None)
        assert out["sub_member"] == (r in (1, 2))
        shape, coords, differs = out["shrunk"]
        assert shape == {"grid": 1, "model": 2} and differs
        assert coords == ({"grid": 0, "model": r} if r < 2 else None)
        fiber = order[2 * (pos // 2):2 * (pos // 2) + 2]
        assert out["fiber"] == fiber
        # Gathered in model-coordinate order: each rank's chunk is its id.
        assert out["gathered"] == [float(x) for x in fiber]


@pytest.mark.parametrize("case, rank, what", [
    ("grid", 1, "rank 1's share raised"),
    ("grid_model", 3, "rank 3 failed mid-run")])
def test_a_share_that_raises_fails_the_grid_on_every_rank(case, rank, what):
    """`GridRunner.run` over 4 ranks with one rank's share raising: on the
    1-D mesh rank 1's first share; on the (2, 2) mesh rank 3 alone, at its
    second all-gather of the model group, while its peer, rank 2, waits
    for it there.  Every rank raises `RankFailed` naming the failed rank
    instead of waiting, and the mesh serves the next run, the same on
    every rank."""
    ranks = _builders()
    again = ranks[0]["contained"][case]["again"]
    for r, out in enumerate(ranks):
        kind, msg, failed = out["contained"][case]["error"]
        assert (kind, failed) == ("RankFailed", rank)
        assert msg == f"rank {rank} failed: RuntimeError: {what}"
        labels, acc, loss = out["contained"][case]["again"]
        assert labels == again[0] and len(labels) == 6
        np.testing.assert_array_equal(loss, again[2], err_msg=f"rank {r}")
        np.testing.assert_array_equal(acc, again[1], err_msg=f"rank {r}")


def test_multi_rank_calls_need_a_process_group():
    with pytest.raises(ValueError, match="launch.mesh.spawn"):
        mesh.grid_mesh(3, device="cpu")
    with pytest.raises(ValueError, match="init_process_group"):
        mesh.grid_model_mesh(4, model_shards=2, device="cpu")
    with pytest.raises(ValueError, match="model_shards=2 needs a mesh"):
        data, _net, init_fn = _torch_ranks.toy()
        simulator.build_sim(init_fn, smallnets.apply_mlp_clf, data,
                            device="cpu", model_shards=2,
                            **_torch_ranks.STATICS)
    with pytest.raises(ValueError, match="model_shards=0 must be >= 1"):
        simulator.build_sim(init_fn, smallnets.apply_mlp_clf, data,
                            device="cpu", model_shards=0,
                            **_torch_ranks.STATICS)


def test_spawn_defaults_to_the_card(monkeypatch):
    """With no ``device`` the ranks run on the card, as every entry point
    does; without one, `spawn` raises before it starts a process."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.spawn(_torch_ranks.failing_rank, 2, timeout=60)


def test_spawn_reraises_a_rank_failure():
    """Rank 1 raises; rank 0 then loses its peer in a barrier.  The parent
    raises the first failure, rank 1's, with its traceback."""
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 failed first.*"
                       r"rank 1 failed on purpose"):
        mesh.spawn(_torch_ranks.failing_rank, 2, device="cpu", timeout=60)


MODEL_TIMEOUT_S = 3.0


def test_model_group_fault_is_bounded():
    import time

    began = time.monotonic()
    outs = mesh.spawn(_torch_ranks.model_group_timeout_rank, 4,
                      device="cpu", args=(MODEL_TIMEOUT_S,), timeout=300.0)
    elapsed = time.monotonic() - began
    # two faults, each held for one bound, and 30 s for all the rest
    assert elapsed < 2 * MODEL_TIMEOUT_S + 30.0, elapsed
    for rank, out in enumerate(outs):
        assert out["fault"] == ("RankFailed", 2, True), (rank, out)
        assert "broken" in out["again"] and "rank 2 failed" in out["again"]
    # rank 3 waited inside the all-gather until its bound
    assert outs[3]["fault_s"] >= MODEL_TIMEOUT_S
    (k1, m1), (k2, m2) = outs[0]["served"]
    assert k1 == "RankFailed" and m1.startswith("rank 2 failed")
    assert k2 == "MeshBroken" and "not reused" in m2
    # the followers ran the first dispatch only; the second never fanned out
    assert [o["dispatch_errors"] for o in outs[1:]] == [1, 1, 1]
