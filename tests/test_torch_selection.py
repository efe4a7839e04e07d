"""PyTorch port vs the JAX reference: client selection and the Section-IV
route admission, on the same numpy-seeded inputs.

Masks, counts, ranks and admission orders must be exactly equal; float32
values (admission scores, budget ratios, update norms) within 1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import routing as jrouting  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro_torch.core import routing, selection  # noqa: E402

N = 10


def _t(x):
    return torch.from_numpy(np.array(x))


def _table2(seed):
    net = jtopology.make_network(jtopology.TABLE_II_COORDS,
                                 packet_len_bits=100_000, tx_power_dbm=17.0)
    rho = np.array(jrouting.e2e_success(net.link_eps)[0])
    rng = np.random.default_rng(seed)
    p = (rng.random(N) + 0.1).astype(np.float32)
    return (p / p.sum()).astype(np.float32), rho


def _signals(seed):
    rng = np.random.default_rng(seed)
    loss = rng.uniform(0.5, 2.5, N).astype(np.float32)
    upd = rng.uniform(0.01, 1.0, N).astype(np.float32)
    upd[[1, 6]] = np.inf              # never trained: optimistic +inf
    loss[4] = loss[2]                 # a tie: the lower index wins
    return loss, upd


@pytest.mark.parametrize("frac", [0.3, 0.5, 1.0])
@pytest.mark.parametrize("policy", sorted(selection.POLICY_IDS))
def test_select_clients_matches_reference(policy, frac):
    p, rho = _table2(0)
    loss, upd = _signals(1)
    base = np.ones(N, np.float32)
    base[[3, 8]] = 0.0                # unavailable this round
    pid = selection.POLICY_IDS[policy]
    want = np.asarray(jsel.select_clients(
        jnp.asarray(pid), jnp.asarray(base),
        jsel.SelectionSignals(jnp.asarray(loss), jnp.asarray(upd)),
        jnp.asarray(p), jnp.asarray(rho), jnp.asarray(frac, jnp.float32)))
    got = selection.select_clients(
        pid, _t(base), selection.SelectionSignals(_t(loss), _t(upd)),
        _t(p), _t(rho), frac)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[[3, 8]].any()
    if policy != "uniform":
        assert int(got.sum()) <= int(selection.select_count(frac, N))


@pytest.mark.parametrize("frac", [0.25, 0.55, 1.0])
def test_budget_allocation_and_ratio_match_reference(frac):
    p, rho = _table2(2)
    base = np.ones(N, np.float32)
    base[5] = 0.0
    args_j = (jnp.asarray(base), jnp.asarray(p), jnp.asarray(rho),
              jnp.asarray(frac, jnp.float32))
    args_t = (_t(base), _t(p), _t(rho), frac)
    alloc = selection.budget_allocation(*args_t)
    np.testing.assert_allclose(alloc.numpy(), np.asarray(
        jsel.budget_allocation(*args_j)), atol=1e-6, rtol=0)
    assert float(alloc.sum()) <= frac * N + 1e-5 and float(alloc[5]) == 0.0
    for policy, pid in selection.POLICY_IDS.items():
        got = selection.budget_ratio(pid, *args_t, 0.5)
        want = np.asarray(jsel.budget_ratio(jnp.asarray(pid), *args_j,
                                            jnp.asarray(0.5, jnp.float32)))
        assert tuple(got.shape) == (N,)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0,
                                   err_msg=policy)


def test_select_count_topk_mask_and_signals():
    # The documented case: 0.3 of 50 selects 15 (a raw ceil selects 16).
    assert int(selection.select_count(0.3, 50)) == 15
    for frac in np.arange(1, 101) / 100.0:
        assert int(selection.select_count(frac, 50)) == int(
            jsel.select_count(frac, 50))
    scores = np.array([1.0, 3.0, 3.0, -np.inf, np.inf, np.inf], np.float32)
    for k in range(1, 7):
        np.testing.assert_array_equal(
            selection.topk_mask(_t(scores), k).numpy(),
            np.asarray(jsel.topk_mask(jnp.asarray(scores), k)))
    sig = selection.init_signals(_t(np.array([0.5, 1.5], np.float32)))
    jsig = jsel.init_signals(jnp.asarray([0.5, 1.5]))
    np.testing.assert_array_equal(sig.loss.numpy(), np.asarray(jsig.loss))
    np.testing.assert_array_equal(sig.upd_norm.numpy(),
                                  np.asarray(jsig.upd_norm))


def test_update_norms_match_reference():
    rng = np.random.default_rng(3)
    new = {"fc1": {"b": rng.normal(size=(4, 6)), "w": rng.normal(
        size=(4, 3, 6))}, "fc2": {"b": rng.normal(size=(4, 2))}}
    old = {"fc1": {"b": rng.normal(size=(4, 6)), "w": rng.normal(
        size=(4, 3, 6))}, "fc2": {"b": rng.normal(size=(4, 2))}}

    def flat(tree):
        return {"fc1.b": _t(tree["fc1"]["b"].astype(np.float32)),
                "fc1.w": _t(tree["fc1"]["w"].astype(np.float32)),
                "fc2.b": _t(tree["fc2"]["b"].astype(np.float32))}

    def jtree(tree):
        return {k: {kk: jnp.asarray(vv, jnp.float32) for kk, vv in v.items()}
                for k, v in tree.items()}

    got = selection.update_norms(flat(new), flat(old))
    want = np.asarray(jsel.update_norms(jtree(new), jtree(old)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("max_admitted", [None, 4])
def test_route_admission_matches_reference(max_admitted):
    p, rho = _table2(4)
    p[[2, 7]] = p[0]                  # equal weights: ties in the order
    np.testing.assert_allclose(
        routing.admission_scores(_t(p), _t(rho[:N, :N])).numpy(),
        np.asarray(jrouting.admission_scores(jnp.asarray(p),
                                             jnp.asarray(rho[:N, :N]))),
        rtol=1e-5)
    kw = dict(n_clients=N, max_admitted=max_admitted)
    assert routing.admit_homologous_routes(p, rho, **kw) == \
        jrouting.admit_homologous_routes(p, rho, **kw)
    assert routing.admit_homologous_routes(_t(p), _t(rho), **kw) == \
        jrouting.admit_homologous_routes(p, rho, **kw)
    np.testing.assert_array_equal(
        routing.admitted_rho_mask(p, rho, **kw),
        jrouting.admitted_rho_mask(p, rho, **kw))
    route = [0, 3, 5, 2]
    assert routing.route_edges(route) == jrouting.route_edges(route)
