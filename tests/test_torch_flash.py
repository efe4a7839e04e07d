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
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (caps torch's CPU threads)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card checks' K2 inputs)
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
    assert fa.HEAD_DIMS == (16, 32, 64, 128, 256)
    for bad in (0, -3, 2.5, True):
        with pytest.raises(ValueError, match="window must be a positive"):
            ops.flash_attention(q, k, v, scale=1.0, window=bad, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.flash_attention(q, k, v, scale=1.0)
    # A CPU tensor never reaches the launch: the launch refuses it.
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.launch(None, q, k, v, scale=1.0, causal=True)


# ---------------------------------------------------------------------------
# What the CUDA launch computes in plain Python before it calls the kernel:
# the body by dtype x D, the grid, and the TMA tensor maps.
# ---------------------------------------------------------------------------
SERVE = (8, 2048, 16, 128)   # qwen2.5-3b's prefill: B, S, H, D
GEMMA = (8, 2048, 16, 256)   # gemma-7b's prefill


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_body_by_dtype_and_head_dim(dtype, d):
    want = "wgmma" if dtype == "bfloat16" and d in (64, 128, 256) else "simt"
    assert fa.body(getattr(torch, dtype), d) == want


def test_k2_grid_is_persistent_for_the_hopper_body():
    # bf16 D = 128: 128-row work tiles, 256 threads, one block an SM.
    assert fa.grid(SERVE, torch.bfloat16, sms=132) == (132, 256, 2048, 128)
    assert fa.grid(SERVE, torch.bfloat16) == (2048, 256, 2048, 128)
    assert fa.grid((1, 200, 4, 64), torch.bfloat16, sms=132) == (8, 256, 8, 128)
    # gemma-7b's prefill (bf16 D = 256): the same work tiles and grid; its
    # blocks take work tiles in pairs, so a small launch has half as many.
    assert fa.grid(GEMMA, torch.bfloat16, sms=132) == (132, 256, 2048, 128)
    assert fa.grid((1, 333, 4, 256), torch.bfloat16, sms=132) == (6, 256, 12,
                                                                   128)
    # The first body: a block of 128 threads per 64-row work tile.
    assert fa.grid(SERVE, torch.float32, sms=132) == (4096, 128, 4096, 64)
    assert fa.grid((2, 96, 6, 32), torch.bfloat16, sms=132) == (24, 128, 24, 64)


def test_k2_tma_map_of_contiguous_and_fused_qkv_tensors():
    b, s, h, kv, d = 2, 200, 16, 2, 128
    q = torch.empty((b, s, h, d), dtype=torch.bfloat16)
    assert fa.tma_map(q) == ((d, s, h, b), (h * d * 2, d * 2, s * h * d * 2))
    # Head slices of one fused (B, S, H + 2 KV, D) projection: each map has
    # the slice's own heads and the fused tensor's byte strides.
    qkv = torch.empty((b, s, h + 2 * kv, d), dtype=torch.bfloat16)
    row = (h + 2 * kv) * d * 2
    fused = (row, d * 2, s * row)
    assert fa.tma_map(qkv[:, :, :h]) == ((d, s, h, b), fused)
    assert fa.tma_map(qkv[:, :, h:h + kv]) == ((d, s, kv, b), fused)
    assert fa.tma_map(qkv[:, :, h + kv:]) == ((d, s, kv, b), fused)
    # An axis of size 1 is never stepped along: its stride reads as D.
    one = torch.empty((1, 96, 1, 64), dtype=torch.bfloat16)[:, :, :1]
    assert fa.kernel_strides(one) == (64, 64, 64)
    assert fa.tma_map(one) == ((64, 96, 1, 1), (128, 128, 128))


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_key_tile_by_body(dtype, d):
    """The first body stages 64 keys a tile; the Hopper body 128, and 80 at
    D = 256, where two stages of 128-key K and V tiles beside Q would not
    fit in shared memory."""
    want = (64 if dtype == "float32" or d in (16, 32)
            else 80 if d == 256 else 128)
    assert fa.key_tile(getattr(torch, dtype), d) == want


def test_k2_tma_map_at_head_dim_256():
    """gemma-7b's D = 256 is read by TMA too: four 64-column panels a row,
    through the tensors' own strides; a stride-0 kv head is refused."""
    b, s, h, kv, d = 2, 200, 16, 16, 256
    q = torch.empty((b, s, h, d), dtype=torch.bfloat16)
    assert fa.tma_map(q) == ((d, s, h, b), (h * d * 2, d * 2, s * h * d * 2))
    qkv = torch.empty((b, s, h + 2 * kv, d), dtype=torch.bfloat16)
    row = (h + 2 * kv) * d * 2
    fused = (row, d * 2, s * row)
    assert fa.tma_map(qkv[:, :, :h]) == ((d, s, h, b), fused)
    assert fa.tma_map(qkv[:, :, h:h + kv]) == ((d, s, kv, b), fused)
    assert fa.tma_map(qkv[:, :, h + kv:]) == ((d, s, kv, b), fused)
    k = torch.empty((1, 64, 1, d), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA cannot take"):
        fa.tma_map(k.expand(2, 64, 4, d))
    with pytest.raises(ValueError, match="TMA cannot take"):
        fa.tma_map(k.expand(1, 64, 4, d))


class _Strided:
    """Shape and strides alone, for strides no test can allocate."""

    def __init__(self, shape, strides):
        self.shape, self._strides = shape, strides

    def stride(self, i):
        return self._strides[i]

    def element_size(self):
        return 2


def test_k2_tma_map_refuses_strides_tma_cannot_take():
    k = torch.empty((1, 64, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA cannot take"):   # broadcast
        fa.tma_map(k.expand(2, 64, 4, 64))
    with pytest.raises(ValueError, match="TMA cannot take"):   # 8-byte rows
        fa.tma_map(torch.empty((1, 8, 2, 4), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="TMA cannot take"):   # >= 2**40
        fa.tma_map(_Strided((2, 64, 4, 64), (2**39, 256, 64, 1)))
    assert fa.tma_map(_Strided((2, 64, 4, 64), (2**39 - 8, 256, 64, 1)))[1] \
        == (512, 128, 2**40 - 16)


# ---------------------------------------------------------------------------
# The card checks' K2 inputs (chip_smoke.k2_inputs).  At scale D^-0.5 randn
# logits are about N(0, 1), so no row's max ever jumps far at a later key
# tile and the Hopper body's lazy softmax never redoes one; the card tests
# and chip_smoke also draw inputs that make it, and count the tiles it
# redoes by replaying its rule on the logits.
# ---------------------------------------------------------------------------
REDO_SHAPES = [(1, 700, 16, 2, 128), (2, 520, 8, 2, 64), (1, 700, 8, 2, 256)]
KINDS = ("randn", "growth", "scale1", "negative")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", REDO_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k2_inputs_reach_the_lazy_softmax_redo(shape, kind, causal):
    b, s, h, kv, d = shape
    q, k, v, scale = chip_smoke.k2_inputs(shape, torch.bfloat16, "cpu",
                                          kind=kind, causal=causal, seed=5)
    assert q.shape == (b, s, h, d) and k.shape == v.shape == (b, s, kv, d)
    assert q.dtype == k.dtype == v.dtype == torch.bfloat16
    assert (scale < 0) == (kind == "negative")
    redos = chip_smoke.k2_lazy_redos(q, k, scale, causal)
    if kind in ("growth", "scale1"):
        assert redos >= 20
    else:
        assert redos == 0


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kind", KINDS[1:])
def test_k2_plain_matches_reference_and_pallas_where_rows_grow(kind, causal):
    """The oracle the card holds the redo path to agrees with the
    reference's, and with its Pallas kernel, on those inputs."""
    tq, tk, tv, scale = chip_smoke.k2_inputs(
        (1, 288, 4, 2, 64), torch.bfloat16, "cpu", kind=kind, causal=causal,
        seed=6)
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (tq, tk, tv))
    got = ref.flash_attention_ref(tq, tk, tv, scale=scale, causal=causal)
    for want in (
            jref.flash_attention_ref(jq, jk, jv, scale=scale, causal=causal),
            jops.flash_attention(jq, jk, jv, scale=scale, causal=causal,
                                 block_q=32, block_k=32, interpret=True)):
        np.testing.assert_allclose(_np(got), _np(want), atol=3e-2, rtol=0)


def test_k2_row_err_sees_a_fault_in_a_late_causal_row():
    """A late causal row averages hundreds of values and is small: an error
    there within the absolute 3e-2 is still a large share of the row."""
    q, k, v, scale = chip_smoke.k2_inputs((1, 700, 16, 2, 128),
                                          torch.bfloat16, "cpu", seed=7)
    want = ref.flash_attention_ref(q, k, v, scale=scale)
    tol = chip_smoke.K2_ROW_TOL[torch.bfloat16]
    assert chip_smoke.k2_row_err(want, want) == 0.0
    assert chip_smoke.k2_row_err(want.float() * (1 + 2**-8), want) < tol
    bad = want.float()
    bad[0, -1, 0, 0] += 0.02
    assert float((bad - want.float()).abs().max()) < 3e-2 < 0.1
    assert chip_smoke.k2_row_err(bad, want) > 4 * tol
