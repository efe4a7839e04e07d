"""PyTorch port vs the JAX reference: the local optimizers.

The same numpy-seeded parameters and gradient sequence go through the
reference's `optim.optimizers` and the port's for 5 steps, over a dict of
tensors and over one stacked tensor; parameters and state within 1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import optimizers as joptim  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402

STEPS = 5
CASES = {   # name -> (optimizer, lr, keywords)
    "sgd_m0": ("sgd", 0.1, {}),
    "sgd_m0.9": ("sgd", 0.05, dict(momentum=0.9)),
    "adamw": ("adamw", 0.01, {}),
    "adamw_nodecay": ("adamw", 0.3, dict(b2=0.999, weight_decay=0.0)),
}


def _tree(rng):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_steps_match_reference(case):
    name, lr, kw = CASES[case]
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    jopt = getattr(joptim, name)(lr, **kw)
    opt = getattr(optimizers, name)(lr, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jst, tst = jopt.init(jp), opt.init(tp)
    for g in grads:
        jp, jst = jopt.update(jp, jax.tree.map(jnp.asarray, g), jst)
        tp, tst = opt.update(tp, {k: torch.from_numpy(v) for k, v in
                                  g.items()}, tst)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-5, rtol=0, err_msg=k)
    assert int(tst["step"]) == int(jst["step"]) == STEPS
    for slot in set(tst) - {"step"}:
        for k in params:
            np.testing.assert_allclose(tst[slot][k].numpy(),
                                       np.asarray(jst[slot][k]),
                                       atol=1e-5, rtol=0)
    # The same update over one tensor (how the simulator applies it to the
    # client-stacked rows) gives the same numbers as the dict.
    flat = torch.from_numpy(params["a"].copy())
    st = opt.init(flat)
    for g in grads:
        flat, st = opt.update(flat, torch.from_numpy(g["a"]), st)
    np.testing.assert_allclose(flat.numpy(), tp["a"].numpy(), atol=0,
                               rtol=0)


def test_get_and_momentum0_is_plain_gd():
    p = torch.linspace(-1, 1, 7)
    g = torch.linspace(0.5, -2, 7)
    new, st = optimizers.get("sgd", 0.05).update(p, g, {"step": torch.zeros(
        (), dtype=torch.int32)})
    assert torch.equal(new, p - 0.05 * g) and int(st["step"]) == 1
    assert isinstance(optimizers.get("adamw", 0.1), optimizers.Optimizer)
    with pytest.raises(ValueError, match="lion"):
        optimizers.get("lion", 0.1)
