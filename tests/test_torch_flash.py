"""PyTorch port vs the JAX reference: K2 `flash_attention`'s plain path.

Inputs are drawn with numpy from a seed and handed to both packages.  The
reference's Pallas kernel runs as its own tests run it on the CPU (interpret
mode, through `repro.kernels.ops.flash_attention`), beside its oracle
`repro.kernels.ref.flash_attention_ref`.

Tolerances, as `tests/test_kernels.py` holds the Pallas kernel to its
oracle: 2e-5 absolute in float32 (sums in another order), 3e-2 absolute in
bfloat16 (outputs round to bfloat16, and the Pallas kernel's online softmax
rounds nothing else while the oracles round nothing at all).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (caps torch's CPU threads)
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SHAPES = [(2, 64, 4, 2, 32), (1, 128, 8, 8, 64), (2, 96, 6, 2, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(seed, b, s, h, kv, dh):
    """q (B, S, H, Dh) and k, v (B, S, KV, Dh) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, dh)).astype(np.float32),
            rng.normal(size=(b, s, kv, dh)).astype(np.float32),
            rng.normal(size=(b, s, kv, dh)).astype(np.float32))


def _both(arrays, jdt, tdt):
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    return np.array(x.float() if isinstance(x, torch.Tensor) else
                    x.astype(jnp.float32), dtype=np.float32)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k2_plain_matches_reference_and_pallas(shape, dtype, causal):
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (q, k, v) = _both(_inputs(sum(shape), *shape), jdt, tdt)
    scale = shape[-1] ** -0.5
    want_ref = jref.flash_attention_ref(jq, jk, jv, scale=scale, causal=causal)
    want_pallas = jops.flash_attention(jq, jk, jv, scale=scale, causal=causal,
                                       block_q=32, block_k=32, interpret=True)
    got_ref = ref.flash_attention_ref(q, k, v, scale=scale, causal=causal)
    got_ops = ops.flash_attention(q, k, v, scale=scale, causal=causal,
                                  device="cpu")
    b, s, h, _, dh = shape
    assert got_ops.dtype == tdt and tuple(got_ops.shape) == (b, s, h, dh)
    assert torch.equal(got_ops, got_ref)
    for got in (got_ref, got_ops):
        for want in (want_ref, want_pallas):
            np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)


def test_k2_plain_groups_query_heads_onto_kv_heads():
    """Query head h reads kv head h // G: with G = 3, repeating each kv head
    three times gives multi-head attention with the same result."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 40, 6, 2, 16))
    got = ref.flash_attention_ref(q, k, v, scale=0.25)
    rep = [t.repeat_interleave(3, dim=2) for t in (k, v)]
    np.testing.assert_allclose(
        _np(got), _np(ref.flash_attention_ref(q, *rep, scale=0.25)),
        atol=1e-6)
    # The first query row sees only the first key: its output is v_0.
    np.testing.assert_allclose(_np(got[:, 0]), _np(rep[1][:, 0]), atol=1e-6)


def test_k2_entry_point_device_rule_and_shapes(monkeypatch):
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="k must be"):
        ops.flash_attention(q, k[:, :4], v, scale=1.0, device="cpu")
    with pytest.raises(ValueError, match="v .* must match"):
        ops.flash_attention(q, k, v[..., :8], scale=1.0, device="cpu")
    with pytest.raises(ValueError, match="not a multiple"):
        ops.flash_attention(q[:, :, :3], k, v, scale=1.0, device="cpu")
    with pytest.raises(ValueError, match="q must be"):
        ops.flash_attention(q[0], k, v, scale=1.0, device="cpu")
    assert fa.HEAD_DIMS == (16, 32, 64, 128)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.flash_attention(q, k, v, scale=1.0)
    # A CPU tensor never reaches the launch: the launch refuses it.
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.launch(None, q, k, v, scale=1.0, causal=True)
