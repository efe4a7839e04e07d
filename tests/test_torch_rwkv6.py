"""PyTorch port vs the JAX reference: the rwkv6 time-mix and K3's plain path.

Inputs are drawn with numpy from a seed and handed to both packages.  The
reference's Pallas kernel runs as its own tests run it on the CPU (interpret
mode, through `repro.kernels.ops.rwkv6_scan`); weights cross through
`repro_torch.interop`.

Tolerances, as the reference's kernel tests state them: 2e-5 (absolute and
relative) in float32, 5e-2 in bfloat16 (outputs round to bfloat16, and
the two packages round inputs to float32 sums in another order); 3e-5 for
the chunk sweep; 1e-5 for the final state in float32.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (caps torch's CPU threads)
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as krwkv  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

SHAPES = [(1, 32, 1, 16), (2, 64, 2, 32), (1, 128, 4, 64), (2, 96, 3, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _inputs(seed, b, s, h, d, *, w_const=None):
    """r, k, v, w (B, S, H, D) and u (H, D) as float32 numpy arrays, drawn
    as the reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) * 0.5
               for _ in range(3))
    if w_const is None:
        w = -np.exp(rng.normal(size=(b, s, h, d)) * 0.5 - 1.0)
    else:
        w = np.full((b, s, h, d), w_const)
    u = rng.normal(size=(h, d)) * 0.3
    return r, k, v, w.astype(np.float32), u.astype(np.float32)


def _both(arrays, jdt, tdt):
    """The same values in each package: r, k, v in the model dtype, w and u
    float32."""
    r, k, v, w, u = arrays
    jx = [jnp.asarray(a).astype(jdt) for a in (r, k, v)]
    tx = [torch.from_numpy(a).to(tdt) for a in (r, k, v)]
    return (*jx, jnp.asarray(w), jnp.asarray(u)), (*tx, torch.from_numpy(w),
                                                   torch.from_numpy(u))


def _np(x):
    return np.array(x.float() if isinstance(x, torch.Tensor) else
                    x.astype(jnp.float32), dtype=np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k3_plain_matches_reference_and_pallas(shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jin, tin = _both(_inputs(sum(shape), *shape), jdt, tdt)
    want_ref = jref.rwkv6_scan_ref(*jin)
    want_pallas = jops.rwkv6_scan(*jin, chunk=32)
    got_ref = ref.rwkv6_scan_ref(*tin)
    got_ops = ops.rwkv6_scan(*tin, chunk=32, device="cpu")
    assert got_ref.dtype == tdt and tuple(got_ref.shape) == shape
    for got in (got_ref, got_ops):
        for want in (want_ref, want_pallas):
            np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("chunk", [8, 16, 32, 48, 96])
def test_rwkv6_chunked_chunk_sweep(chunk):
    jin, tin = _both(_inputs(7, 1, 96, 2, 32), jnp.float32, torch.float32)
    want_seq = jref.rwkv6_scan_ref(*jin)
    want_pallas = jops.rwkv6_scan(*jin, chunk=chunk)
    want_chunked = jssm.rwkv6_chunked(*jin, chunk=chunk)
    got = ssm.rwkv6_chunked(*tin, chunk=chunk)
    for want in (want_seq, want_pallas, want_chunked):
        np.testing.assert_allclose(_np(got), _np(want), atol=3e-5)
    np.testing.assert_allclose(_np(ops.rwkv6_scan(*tin, chunk=chunk,
                                                  device="cpu")),
                               _np(want_seq), atol=3e-5)


def test_rwkv6_at_the_decay_floor():
    """w ≡ −60/64 (the floor `_rkvwg` clamps to) over a 128-token sequence:
    the two-factor chunked form reaches exp(60) within a chunk of 64."""
    jin, tin = _both(_inputs(3, 1, 128, 2, 64, w_const=ssm.LOG_DECAY_FLOOR),
                     jnp.float32, torch.float32)
    want = jref.rwkv6_scan_ref(*jin)
    want_pallas = jops.rwkv6_scan(*jin, chunk=64)
    np.testing.assert_allclose(_np(want_pallas), _np(want), atol=2e-5)
    for got in (ref.rwkv6_scan_ref(*tin), ssm.rwkv6_chunked(*tin, chunk=64)):
        assert np.isfinite(_np(got)).all()
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s", [128, 96])
def test_rwkv6_chunked_final_state_matches_reference(s, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jin, tin = _both(_inputs(s, 2, s, 2, 32), jdt, tdt)
    want_out, want_state = jssm.rwkv6_chunked(*jin, return_state=True)
    got_out, got_state = ssm.rwkv6_chunked(*tin, return_state=True)
    _, ref_state = ref.rwkv6_scan_ref(*tin, return_state=True)
    _, ops_state = ops.rwkv6_scan(*tin, return_state=True, device="cpu")
    np.testing.assert_allclose(_np(got_out), _np(want_out), atol=tol, rtol=tol)
    assert got_state.dtype == torch.float32
    assert tuple(got_state.shape) == (2, 2, 32, 32)
    for st in (got_state, ref_state, ops_state):
        np.testing.assert_allclose(_np(st), _np(want_state), atol=1e-5,
                                   rtol=1e-5)


def _mix_params(cfg, dtype, seed=0):
    jparams = jssm.init_rwkv6(jax.random.PRNGKey(seed), cfg, dtype)
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jparams, tparams


@pytest.mark.parametrize("impl", ssm.IMPLS)
@pytest.mark.parametrize("d_model,n_heads", [(64, 2), (128, 2)])
def test_rwkv6_seq_matches_reference(d_model, n_heads, impl):
    jcfg = jssm.RWKV6Cfg(d_model=d_model, n_heads=n_heads)
    cfg = ssm.RWKV6Cfg(d_model=d_model, n_heads=n_heads)
    jparams, tparams = _mix_params(jcfg, jnp.float32)
    x = np.random.default_rng(1).normal(size=(2, 96, d_model)).astype(np.float32)
    want, want_state = jssm.rwkv6_seq(jparams, jcfg, jnp.asarray(x),
                                      return_state=True)
    got, got_state = ssm.rwkv6_seq(tparams, cfg, torch.from_numpy(x),
                                   impl=impl, return_state=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(got_state), _np(want_state), atol=1e-4,
                               rtol=1e-4)
    no_state = ssm.rwkv6_seq(tparams, cfg, torch.from_numpy(x), impl=impl)
    assert torch.equal(no_state, got)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv6_step_matches_reference(dtype):
    jdt, tdt, _ = DTYPES[dtype]
    jcfg = jssm.RWKV6Cfg(d_model=128, n_heads=2)
    cfg = ssm.RWKV6Cfg(d_model=128, n_heads=2)
    jparams, tparams = _mix_params(jcfg, jdt, seed=3)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 1, 128)).astype(np.float32)
    st = (rng.normal(size=(3, 2, 64, 64)) * 0.1).astype(np.float32)
    jx, jst = jnp.asarray(x).astype(jdt), jnp.asarray(st).astype(jdt)
    tx, tst = torch.from_numpy(x).to(tdt), torch.from_numpy(st).to(tdt)
    assert torch.equal(tst.float(), torch.from_numpy(_np(jst)))
    want, want_state = jssm.rwkv6_step(jparams, jcfg, jx, jst)
    got, got_state = ssm.rwkv6_step(tparams, cfg, tx, tst)
    assert got.dtype == tdt and got_state.dtype == tdt
    if tdt == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(_np(got_state), _np(want_state),
                                   atol=1e-5, rtol=1e-5)
    else:   # both round the same float32 math to bfloat16
        scale = float(np.abs(_np(want)).max())
        assert float(np.abs(_np(got) - _np(want)).max()) <= 3e-2 * scale
        assert _torch_parity.bf16_ulps(_np(got_state), _np(want_state),
                                       atol=1e-5) <= 1.0
    # The zero state from init gives the same step.
    z = ssm.init_rwkv6_state(3, cfg, tdt)
    assert tuple(z.shape) == (3, 2, 64, 64) and z.dtype == tdt


def test_k3_entry_point_device_rule_and_shapes(monkeypatch):
    tin = _both(_inputs(0, 1, 8, 2, 16), jnp.float32, torch.float32)[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.rwkv6_scan(*tin)
    r, k, v, w, u = tin
    with pytest.raises(ValueError, match="must match"):
        ops.rwkv6_scan(r, k[:, :4], v, w, u, device="cpu")
    with pytest.raises(ValueError, match=r"u must be \(H, D\)"):
        ops.rwkv6_scan(r, k, v, w, u[:1], device="cpu")
    with pytest.raises(ValueError, match="impl must be one of"):
        ssm.rwkv6_seq({}, ssm.RWKV6Cfg(32, 2), torch.zeros(1, 4, 32),
                      impl="pallas")


# ---------------------------------------------------------------------------
# What the CUDA launch decides in plain Python before it calls the kernel:
# the body by dtype x D, the strides it reads, and its refusals.
# ---------------------------------------------------------------------------
def _t(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("d", krwkv.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_body_by_dtype_and_head_dim(dtype, d):
    want = "chunked" if dtype == "bfloat16" and d == 64 else "token"
    assert krwkv.body(getattr(torch, dtype), d) == want
    r = _t((1, 8, 2, d), getattr(torch, dtype))
    w, u = _t((1, 8, 2, d)), _t((2, d))
    assert krwkv.check_launch(r, r, r, w, u, tile=krwkv.TILE) == want
    # The token body takes every dtype and D; the chunked body only its own.
    assert krwkv.check_launch(r, r, r, w, u, tile=krwkv.TILE,
                              which="token") == "token"
    if want == "token":
        with pytest.raises(ValueError, match="takes bfloat16 at D = 64"):
            krwkv.check_launch(r, r, r, w, u, tile=1, which="chunked")


def test_k3_kernel_strides_of_head_slices_and_size_one_axes():
    x = _t((2, 10, 6, 64), torch.bfloat16)
    assert krwkv.kernel_strides(x) == (10 * 6 * 64, 6 * 64, 64)
    assert krwkv.kernel_strides(x[:, :, 2:5]) == (10 * 6 * 64, 6 * 64, 64)
    # An axis of size 1 is never stepped along: its stride reads as D.
    one = _t((1, 10, 6, 64), torch.bfloat16)[:, :, :1]
    assert krwkv.kernel_strides(one) == (64, 6 * 64, 64)


def test_k3_launch_refusals_without_a_card():
    b, s, h, d = 1, 20, 2, 64
    r, w, u = _t((b, s, h, d), torch.bfloat16), _t((b, s, h, d)), _t((h, d))
    # A CPU tensor never reaches the launch: the launch refuses it.
    with pytest.raises(ValueError, match="one CUDA device"):
        krwkv.launch(None, r, r, r, w, u, tile=krwkv.TILE, return_state=True)
    with pytest.raises(TypeError, match="share one dtype"):
        krwkv.check_launch(r, r.float(), r, w, u, tile=krwkv.TILE)
    with pytest.raises(TypeError, match="share one dtype"):
        krwkv.check_launch(r.half(), r.half(), r.half(), w, u, tile=1)
    with pytest.raises(TypeError, match="must be float32"):
        krwkv.check_launch(r, r, r, w.bfloat16(), u, tile=krwkv.TILE)
    odd = _t((b, s, h, 48), torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 48"):
        krwkv.check_launch(odd, odd, odd, _t((b, s, h, 48)), _t((h, 48)),
                           tile=1)
    with pytest.raises(ValueError, match="contiguous in its last axis"):
        krwkv.check_launch(r, r.transpose(2, 3).contiguous().transpose(2, 3),
                           r, w, u, tile=1)
    with pytest.raises(ValueError, match="body must be one of"):
        krwkv.check_launch(r, r, r, w, u, tile=1, which="wgmma")
    # The token body's staging tile; the chunked body reads no tile.
    for tile in (0, krwkv.MAX_TILE + 1):
        with pytest.raises(ValueError, match="tile must be in"):
            krwkv.check_launch(r, r, r, w, u, tile=tile, which="token")
        assert krwkv.check_launch(r, r, r, w, u, tile=tile) == "chunked"


@pytest.mark.parametrize("which", ["r", "k", "v", "w"])
def test_k3_chunked_body_refuses_rows_the_copies_cannot_take(which):
    b, s, h, d = 2, 20, 3, 64
    ins = {"r": _t((b, s, h, d), torch.bfloat16),
           "k": _t((b, s, h, d), torch.bfloat16),
           "v": _t((b, s, h, d), torch.bfloat16), "w": _t((b, s, h, d))}
    u = _t((h, d))
    wide = _t((b, s, h, d + 8), ins[which].dtype)
    # Head slices of a wider head axis: rows stay 16-byte aligned.
    fine = dict(ins, **{which: torch.cat([ins[which]] * 2, dim=2)[:, :, 1:4]})
    assert krwkv.check_launch(*fine.values(), u, tile=1) == "chunked"
    assert krwkv.check_launch(*dict(ins, **{which: wide[..., 8:]}).values(),
                              u, tile=1) == "chunked"
    # Rows that start 8 bytes in, or an H stride 8 bytes past a multiple of
    # 16: the 16-byte copies cannot take them.
    pad = 8 // ins[which].element_size()
    narrow = _t((b, s, h, d + pad), ins[which].dtype)
    for bad in (narrow[..., pad:], narrow[..., :d]):
        with pytest.raises(ValueError, match="16-byte pieces"):
            krwkv.check_launch(*dict(ins, **{which: bad}).values(), u, tile=1)
    # The token body reads element by element and takes them.
    odd = dict(ins, **{which: narrow[..., pad:]})
    assert krwkv.check_launch(*odd.values(), u, tile=1,
                              which="token") == "token"
