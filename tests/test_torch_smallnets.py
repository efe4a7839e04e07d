"""PyTorch port vs the JAX reference: the paper's ResNet and CharRNN.

Weights come from the reference's init and cross through
`repro_torch.interop`; inputs are drawn with numpy.  Tolerances: logits,
losses and gradients within 1e-5 (float32 convolution and GEMM sums taken
in another order).  The SAME padding rule is held to XLA's exactly, and
the port's init must lay out the same leaves in the same order as the
reference's tree, since that order decides which parameters a segment
carries.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (two torch threads a test worker)
from repro.models import smallnets as jsmall  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import smallnets  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _tree(jtree):
    return interop.params_from_jax(jax.tree.map(np.asarray, jtree))


def _leaves(jtree):
    """The reference's leaves as `jax.tree_util` flattens them: names and
    shapes in leaf order."""
    paths = jax.tree_util.tree_flatten_with_path(jtree)[0]
    return [(".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(leaf.shape))
            for path, leaf in paths]


def _port_leaves(params):
    return [(k, tuple(v.shape)) for k, v in params.items()]


@pytest.mark.parametrize("size", [1, 2, 5, 7, 8, 15, 16, 32])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 2), (1, 1),
                                      (4, 2), (5, 3)])
def test_same_padding_is_xlas(size, k, stride):
    want = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert smallnets._same_pads(size, k, stride) == tuple(want)


@pytest.mark.parametrize("hw,k,stride", [((16, 16), 3, 2), ((32, 32), 3, 2),
                                         ((9, 7), 3, 2), ((8, 8), 1, 2),
                                         ((8, 8), 3, 1)])
def test_conv2d_matches_reference(hw, k, stride):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 5)).astype(np.float32)
    want = np.asarray(jsmall.conv2d(jnp.asarray(x), jnp.asarray(w),
                                    stride=stride))
    got = smallnets.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                           torch.from_numpy(w), stride=stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


@pytest.mark.parametrize("depth,width,n_classes", [(8, 4, 10), (18, 4, 10),
                                                   (56, 16, 100), (20, 3, 7)])
def test_resnet_leaves_follow_the_reference_tree(depth, width, n_classes):
    kw = dict(depth=depth, width=width, n_classes=n_classes)
    # The reference's tree by shape only (its eager init draws leaf by leaf).
    jp = jax.eval_shape(lambda: jsmall.init_resnet(jax.random.PRNGKey(0),
                                                   **kw))
    tp = smallnets.init_resnet(torch.Generator().manual_seed(0), **kw)
    assert _port_leaves(tp) == _leaves(jp)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jp)
    assert _port_leaves(_tree(zeros)) == _leaves(jp)


def test_charrnn_leaves_follow_the_reference_tree():
    jp = jax.eval_shape(lambda: jsmall.init_charrnn(jax.random.PRNGKey(0)))
    tp = smallnets.init_charrnn(torch.Generator().manual_seed(0))
    assert _port_leaves(tp) == _leaves(jp)
    assert sum(v.numel() for v in tp.values()) == 820_522
    assert list(smallnets.MODELS) == list(jsmall.MODELS)


def _loss_and_grads(jinit, japply, tapply, x, y):
    """Reference and port: logits, CE loss and its gradient at the
    reference's weights."""
    jp = jax.jit(jinit)(jax.random.PRNGKey(1))

    def jloss(p):
        return jsmall.ce_loss(japply(p, jnp.asarray(x)), jnp.asarray(y))

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(jp)
    tp = _tree(jp)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    tgrad, tval = torch.func.grad_and_value(
        lambda p: smallnets.ce_loss(tapply(p, tx), ty))(tp)
    np.testing.assert_allclose(
        tapply(tp, tx).detach().numpy(),
        np.asarray(jax.jit(japply)(jp, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(float(tval), float(jval), **TOL)
    want = _tree(jgrad)
    assert list(tgrad) == list(want)
    for name, g in want.items():
        np.testing.assert_allclose(tgrad[name].numpy(), g.numpy(), **TOL,
                                   err_msg=name)
    return tp, tx, ty


@pytest.mark.parametrize("depth,hw", [(8, 16), (18, 32)])
def test_resnet_forward_and_gradient_match_reference(depth, hw):
    rng = np.random.default_rng(depth + hw)
    x = rng.normal(size=(3, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=3).astype(np.int32)
    jinit = functools.partial(jsmall.init_resnet, depth=depth, width=4)
    _loss_and_grads(jinit, jsmall.apply_resnet, smallnets.apply_resnet, x, y)


def test_charrnn_forward_and_gradient_match_reference():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 90, size=(3, 11)).astype(np.int32)
    labels = rng.integers(0, 90, size=(3, 11)).astype(np.int32)
    jinit = functools.partial(jsmall.init_charrnn, hidden=32)
    _loss_and_grads(jinit, jsmall.apply_charrnn, smallnets.apply_charrnn,
                    tokens, labels)


@pytest.mark.parametrize("model", ["resnet", "charrnn"])
def test_vmapped_client_gradients_equal_one_by_one(model):
    """The simulator's form: `torch.func.vmap(grad)` over clients' stacked
    weights (no in-place op, no host read in the apply)."""
    rng = np.random.default_rng(3)
    if model == "resnet":
        init = functools.partial(smallnets.init_resnet, depth=8, width=4)
        x = torch.from_numpy(rng.normal(size=(2, 3, 8, 8, 3))
                             .astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 10, (2, 3)).astype(np.int32))
    else:
        init = functools.partial(smallnets.init_charrnn, hidden=16)
        x = torch.from_numpy(rng.integers(0, 90, (2, 3, 5)).astype(np.int32))
        y = torch.from_numpy(rng.integers(0, 90, (2, 3, 5)).astype(np.int32))
    apply = smallnets.MODELS[model][1]
    ps = [init(torch.Generator().manual_seed(s)) for s in (0, 1)]
    stacked = {k: torch.stack([p[k] for p in ps]) for k in ps[0]}

    def loss(p, xb, yb):
        return smallnets.ce_loss(apply(p, xb), yb)

    got = torch.func.vmap(torch.func.grad(loss))(stacked, x, y)
    for c in range(2):
        one = torch.func.grad(loss)(ps[c], x[c], y[c])
        for k in one:
            np.testing.assert_allclose(got[k][c].numpy(), one[k].numpy(),
                                       **TOL, err_msg=k)
