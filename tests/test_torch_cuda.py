"""The CUDA kernels K1 (`ra_aggregate`), K2 (`flash_attention`) and K3
(`rwkv6_scan`) against their plain PyTorch versions.

These tests need an NVIDIA GPU (and nvcc to build the kernel): a CUDA
kernel has no CPU mode, so elsewhere they skip with that reason.  They
import neither JAX nor the reference package, so they run on a machine
with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

K1's tolerances: 1e-5 absolute for float32 (sums in another order); for
bfloat16 one bfloat16 ulp plus that 1e-5, since both sides round float32
sums that may differ by it (where a sum cancels to near zero, 1e-5 is
many ulps of the result).  K3's are stated above its tests.
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (K2's inputs, redo count and row error)
from _torch_parity import bf16_ulps  # noqa: E402
from repro_torch.kernels import flash_attention, ops, ref, rwkv6_scan  # noqa: E402,E501
from repro_torch.models import layers, ssm  # noqa: E402

MODES = ("ra_normalized", "substitution")
CASES = {
    "rank3_bool_f32_primeL": dict(l=13),
    "rank4_perbatch_uint8_f32": dict(b=3, l=7, e_dtype="uint8"),
    "rank4_shared_f32mask": dict(b=2, l=11, shared=True, e_dtype="float32"),
    "rank3_bool_bf16": dict(l=11, w_dtype="bfloat16"),
    "rank4_shared_bool_bf16": dict(b=2, l=13, shared=True,
                                   w_dtype="bfloat16"),
    "n33_receiver_groups": dict(n=33, l=9, k=200),
    "n200_large_smem": dict(n=200, l=3, k=64),
    # The Hopper body: element-by-element loads and stores where 16-byte
    # vectors do not fit (a ragged K, w at a storage offset), both bodies'
    # edges (N = 1 and 16 in registers; 17, 64 and 100 in shared memory,
    # 100 in two passes, 200 above in two sender slabs), one segment, the
    # 12-scenario grid's layout with p / e / tx shared at batch stride 0,
    # and float32 masks per batch entry.
    "ragged_k13_f32": dict(k=13),
    "ragged_k13_bf16": dict(k=13, w_dtype="bfloat16"),
    "offset_f32": dict(b=2, k=32, offset=1),
    "offset_bf16": dict(k=64, offset=3, w_dtype="bfloat16"),
    "n1": dict(n=1, k=64),
    "n16_f32": dict(n=16, l=5, k=256),
    "n16_bf16": dict(n=16, l=5, k=256, w_dtype="bfloat16"),
    "n17_f32": dict(n=17, l=5, k=256),
    "n17_bf16": dict(n=17, l=5, k=520, w_dtype="bfloat16"),
    "n64_f32": dict(n=64, l=3, k=136),
    "n64_bf16": dict(n=64, l=3, k=128, w_dtype="bfloat16"),
    "n100_two_passes": dict(n=100, l=3, k=64),
    "l1_f32": dict(l=1, k=1024),
    "l1_bf16": dict(l=1, k=1024, w_dtype="bfloat16"),
    "grid12_shared_f32": dict(b=12, n=10, l=5, k=1024, shared=True),
    "grid12_shared_bf16": dict(b=12, n=10, l=5, k=1024, shared=True,
                               w_dtype="bfloat16"),
    "rank4_perbatch_f32mask_bf16": dict(b=3, l=7, e_dtype="float32",
                                        w_dtype="bfloat16"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, *, b=None, n=5, l=13, k=24, shared=False, e_dtype="bool",
          w_dtype="float32", with_tx=False):
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    per = () if shared else lead
    w = torch.from_numpy(rng.normal(size=lead + (n, l, k)).astype(np.float32))
    p = rng.random(per + (n,)) + 0.1
    p = torch.from_numpy((p / p.sum(-1, keepdims=True)).astype(np.float32))
    e = torch.from_numpy((rng.random(per + (n, n, l)) < 0.6).astype(e_dtype))
    tx = None
    if with_tx:
        tx = torch.from_numpy((rng.random(per + (n, l)) < 0.5).astype(e_dtype))
    return w.to(getattr(torch, w_dtype)), p, e, tx


def _on_card(w, dev, offset):
    """``w`` on the card, starting ``offset`` elements into its storage (so
    that it is not 16-byte aligned)."""
    if not offset:
        return w.to(dev)
    buf = torch.empty(w.numel() + offset, dtype=w.dtype, device=dev)
    wd = buf[offset:].view(w.shape)
    wd.copy_(w)
    assert wd.is_contiguous() and wd.data_ptr() % 16 != 0
    return wd


@pytest.mark.cuda
@pytest.mark.parametrize("with_tx", [False, True], ids=["no_tx", "tx"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_cuda_kernel_matches_plain(cuda_device, case, mode, with_tx):
    kw = dict(CASES[case])
    offset = kw.pop("offset", 0)   # applied on the card, by `_on_card`
    w, p, e, tx = _case(7, with_tx=with_tx, **kw)
    want = ops.ra_aggregate(w, p, e, tx=tx, mode=mode, device="cpu")
    before = ops.LAUNCHES["ra_aggregate"]
    got = ops.ra_aggregate(_on_card(w, cuda_device, offset),
                           p.to(cuda_device), e.to(cuda_device),
                           tx=None if tx is None else tx.to(cuda_device),
                           mode=mode)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ra_aggregate"] == before + 1
    assert got.dtype == w.dtype and got.shape == w.shape
    got, want = got.cpu().float().numpy(), want.float().numpy()
    if w.dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert bf16_ulps(got, want, atol=1e-5) <= 1.0


@pytest.mark.cuda
def test_k1_cuda_plan_names_the_body(cuda_device):
    """N <= 16 runs the register body (one warp a tile of 32 16-byte
    columns), larger N the shared-memory body (R receivers a warp, two
    column-tiles a block where they fit, sender slabs when one tile and the
    coefficients do not both fit)."""
    from repro_torch.kernels import ra_aggregate as ra

    lib = ops.load_library("ra_aggregate")
    slice_f32 = ra.plan(lib, 1, 10, 412, 1024, torch.float32)
    assert slice_f32["body"] == "register" and slice_f32["tiles"] == 412 * 8
    assert ra.plan(lib, 1, 10, 412, 1024, torch.bfloat16)["tiles"] == 412 * 4
    n33 = ra.plan(lib, 1, 33, 64, 1024, torch.float32)
    assert n33["body"] == "shared" and n33["receivers_per_warp"] == 5
    assert n33["threads"] == 2 * 7 * 32 and n33["slabs"] == 1
    assert n33["blocks"] == 64 * 8 // 2
    assert ra.plan(lib, 1, 200, 3, 64, torch.float32)["slabs"] == 2
    with pytest.raises(RuntimeError, match="CUDA error"):
        ra.plan(lib, 1, 300, 2, 8, torch.float32)


@pytest.mark.cuda
def test_k1_cuda_rejects_what_the_kernel_does_not_take(cuda_device):
    w, p, e, _ = _case(0)
    w, p, e = w.to(cuda_device), p.to(cuda_device), e.to(cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.ra_aggregate(w.half(), p, e)
    with pytest.raises(TypeError, match="bool, uint8 or float32"):
        ops.ra_aggregate(w, p, e.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ops.ra_aggregate(w.transpose(1, 2).contiguous().transpose(1, 2), p, e)
    with pytest.raises(ValueError, match="is on cpu"):
        ops.ra_aggregate(w, p.cpu(), e)
    # N whose coefficients overflow shared memory: a refused launch raises,
    # and the next launch is not blamed for it.
    big = [t.to(cuda_device) for t in _case(1, n=300, l=2, k=8)[:3]]
    with pytest.raises(RuntimeError, match="CUDA error"):
        ops.ra_aggregate(*big)
    assert ops.ra_aggregate(w, p, e).shape == w.shape


# ---------------------------------------------------------------------------
# K3 `rwkv6_scan`: the CUDA kernel against the sequential plain version, both
# on the card.  bf16 at D = 64 runs the chunked body, everything else the
# token body (`rwkv6_scan.body`); each test checks which one ran.
# Tolerances: float32 2e-5 (absolute and relative; the kernel sums in
# another order than the plain version's einsum); bfloat16 outputs one ulp
# plus 2e-5, since both round float32 values that may differ by that.  The
# final state is float32 on both sides: 2e-5.
# ---------------------------------------------------------------------------
K3_SHAPES = [(1, 32, 1, 16), (2, 64, 2, 32), (1, 128, 4, 64), (2, 96, 3, 16),
             (8, 2048, 32, 64)]


def _k3_inputs(dev, shape, dtype=torch.float32, *, seed=0, w_const=None):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.5)
               .to(dev, dtype) for _ in range(3))
    w = (np.full(shape, w_const) if w_const is not None
         else -np.exp(rng.normal(size=shape) * 0.5 - 1.0))
    u = rng.normal(size=shape[2:]) * 0.3
    return (r, k, v, torch.from_numpy(w.astype(np.float32)).to(dev),
            torch.from_numpy(u.astype(np.float32)).to(dev))


def _k3_launch(inputs, body, **kw):
    """ops.rwkv6_scan with the final state, asserting that ``body`` ran."""
    before = dict(rwkv6_scan.BODY_LAUNCHES)
    got, got_state = ops.rwkv6_scan(*inputs, return_state=True, **kw)
    torch.cuda.synchronize()
    ran = {b: n - before[b] for b, n in rwkv6_scan.BODY_LAUNCHES.items()}
    assert ran == {b: int(b == body) for b in rwkv6_scan.BODIES}, ran
    return got, got_state


def _k3_check(got, want, got_state, want_state):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if got_state is not None:
        np.testing.assert_allclose(got_state.cpu().numpy(),
                                   want_state.cpu().numpy(), atol=2e-5,
                                   rtol=2e-5)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", K3_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k3_cuda_kernel_matches_plain(cuda_device, shape, dtype):
    inputs = _k3_inputs(cuda_device, shape, getattr(torch, dtype),
                        seed=sum(shape))
    want, want_state = ref.rwkv6_scan_ref(*inputs, return_state=True)
    before = ops.LAUNCHES["rwkv6_scan"]
    got, got_state = _k3_launch(inputs, rwkv6_scan.body(inputs[0].dtype,
                                                         shape[3]))
    assert ops.LAUNCHES["rwkv6_scan"] == before + 1
    assert got.dtype == inputs[0].dtype and got.shape == inputs[0].shape
    assert got_state.dtype == torch.float32
    assert tuple(got_state.shape) == (shape[0], shape[2], shape[3], shape[3])
    got, want = _k3_check(got, want, got_state, want_state)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        assert bf16_ulps(got, want, atol=2e-5) <= 1.0


@pytest.mark.cuda
def test_k3_cuda_tiles_strides_and_decay_floor(cuda_device):
    # The token body (float32 here): its staging tile, strides and the
    # decay floor.
    r, k, v, w, u = _k3_inputs(cuda_device, (1, 96, 2, 32), seed=1)
    assert rwkv6_scan.body(r.dtype, 32) == "token"
    want = ops.rwkv6_scan(r, k, v, w, u)
    # Neither the reference's chunk nor the staging tile changes the
    # arithmetic: bit for bit.
    for chunk in (1, 8, 48, 96):
        assert torch.equal(ops.rwkv6_scan(r, k, v, w, u, chunk=chunk), want)
    lib = ops.load_library("rwkv6_scan")
    for tile in (1, 8, 16, 48, rwkv6_scan.MAX_TILE):
        got, _ = rwkv6_scan.launch(lib, r, k, v, w, u, tile=tile,
                                   return_state=False)
        assert torch.equal(got, want)
    # Inputs read through their strides: a head slice of a wider tensor.
    wide = [torch.cat([t, torch.zeros_like(t)], dim=2) for t in (r, k, v, w)]
    sliced = [t[:, :, :2] for t in wide]
    assert not sliced[0].is_contiguous()
    assert torch.equal(ops.rwkv6_scan(*sliced, u), want)
    # The decay floor of `ssm._rkvwg`, where the chunked form is at its edge.
    inputs = _k3_inputs(cuda_device, (1, 128, 4, 64), seed=2,
                        w_const=ssm.LOG_DECAY_FLOOR)
    want, want_state = ref.rwkv6_scan_ref(*inputs, return_state=True)
    got, got_state = _k3_launch(inputs, "token")
    got, want = _k3_check(got, want, got_state, want_state)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


# The chunked body (bf16, D = 64): ragged last steps of 16 tokens (S = 1, 63,
# 257, 1000), a strided head slice, and decays at the -60/64 floor, far
# below it everywhere (-5, -60) and in some steps only, drawn as
# chip_smoke.py draws them.  Its diagonal block has no data-dependent
# branch: every decay factor is a product of e^w <= 1.
K3_CHUNKED_CASES = [
    *(((2, s, 4, 64), None, "contiguous") for s in (1, 63, 257, 1000)),
    ((2, 300, 4, 64), None, "strided"),
    ((2, 256, 4, 64), -60.0 / 64.0, "contiguous"),
    ((2, 256, 4, 64), -5.0, "contiguous"),
    ((2, 256, 4, 64), -60.0, "contiguous"),
    ((2, 512, 4, 64), "mixed", "contiguous"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,w_kind,layout", K3_CHUNKED_CASES,
                         ids=lambda x: "x".join(map(str, x))
                         if isinstance(x, tuple) else str(x))
def test_k3_cuda_chunked_body_matches_plain(cuda_device, shape, w_kind,
                                            layout):
    inputs = chip_smoke.k3_inputs(shape, torch.bfloat16, cuda_device, w_kind,
                                  layout, seed=sum(shape))
    if layout == "strided":
        assert not inputs[0].is_contiguous()
    want, want_state = ref.rwkv6_scan_ref(*inputs, return_state=True)
    got, got_state = _k3_launch(inputs, "chunked")
    assert got.shape == inputs[0].shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    got, want = _k3_check(got, want, got_state, want_state)
    assert bf16_ulps(got, want, atol=2e-5) <= 1.0


@pytest.mark.cuda
def test_k3_cuda_chunked_body_ignores_chunk_and_reads_strides(cuda_device):
    r, k, v, w, u = _k3_inputs(cuda_device, (2, 200, 3, 64), torch.bfloat16,
                               seed=4)
    want = ops.rwkv6_scan(r, k, v, w, u)
    for chunk in (1, 8, 48, 96):
        assert torch.equal(ops.rwkv6_scan(r, k, v, w, u, chunk=chunk), want)
    # Head slices of wider tensors (rows 16-byte aligned): bit for bit.
    wide = [torch.cat([t, torch.zeros_like(t)], dim=2) for t in (r, k, v, w)]
    sliced = [t[:, :, 3:] for t in wide]
    assert torch.equal(ops.rwkv6_scan(*[t[:, :, :3] for t in wide], u), want)
    zero = ops.rwkv6_scan(*sliced, u)
    assert torch.equal(zero, torch.zeros_like(zero))
    # Rows that do not start on 16 bytes are refused, not read.
    odd = torch.zeros((2, 200, 3, 68), dtype=torch.bfloat16,
                      device=cuda_device)[..., :64]
    odd.copy_(r)
    with pytest.raises(ValueError, match="16-byte pieces"):
        ops.rwkv6_scan(odd, k, v, w, u)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("float32", 16), ("float32", 32),
                                     ("float32", 64), ("bfloat16", 16),
                                     ("bfloat16", 32)])
def test_k3_cuda_token_body_serves_float32_and_small_heads(cuda_device,
                                                           dtype, d):
    inputs = _k3_inputs(cuda_device, (2, 70, 3, d), getattr(torch, dtype),
                        seed=d)
    want, want_state = ref.rwkv6_scan_ref(*inputs, return_state=True)
    got, got_state = _k3_launch(inputs, "token")
    got, want = _k3_check(got, want, got_state, want_state)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        assert bf16_ulps(got, want, atol=2e-5) <= 1.0


@pytest.mark.cuda
def test_k3_cuda_bodies_agree_at_the_serving_width(cuda_device):
    # bf16 at D = 64 through both bodies (the token body named explicitly).
    inputs = _k3_inputs(cuda_device, (2, 257, 4, 64), torch.bfloat16, seed=5)
    lib = ops.load_library("rwkv6_scan")
    want, want_state = ref.rwkv6_scan_ref(*inputs, return_state=True)
    for body in rwkv6_scan.BODIES:
        got, got_state = rwkv6_scan.launch(lib, *inputs, tile=rwkv6_scan.TILE,
                                           return_state=True, which=body)
        got, ref_out = _k3_check(got, want, got_state, want_state)
        assert bf16_ulps(got, ref_out, atol=2e-5) <= 1.0


@pytest.mark.cuda
def test_k3_cuda_rejects_what_the_kernel_does_not_take(cuda_device):
    r, k, v, w, u = _k3_inputs(cuda_device, (1, 16, 2, 16))
    with pytest.raises(ValueError, match="is on cpu"):
        ops.rwkv6_scan(r, k, v, w.cpu(), u)
    with pytest.raises(TypeError, match="share one dtype"):
        ops.rwkv6_scan(r.half(), k.half(), v.half(), w, u)
    with pytest.raises(TypeError, match="must be float32"):
        ops.rwkv6_scan(r, k, v, w.bfloat16(), u)
    with pytest.raises(ValueError, match="contiguous in its last axis"):
        ops.rwkv6_scan(r, k.transpose(2, 3).contiguous().transpose(2, 3), v,
                       w, u)
    odd = _k3_inputs(cuda_device, (1, 16, 2, 48))
    with pytest.raises(ValueError, match="head dim 48"):
        ops.rwkv6_scan(*odd)
    assert ops.rwkv6_scan(r, k, v, w, u).shape == r.shape


@pytest.mark.cuda
def test_rwkv6_seq_auto_runs_the_kernel_on_the_card(cuda_device):
    cfg = ssm.RWKV6Cfg(d_model=256, n_heads=4)
    params = {n: t.to(cuda_device) for n, t in
              ssm.init_rwkv6(torch.Generator().manual_seed(0), cfg).items()}
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 96, 256)).astype(np.float32)).to(cuda_device)
    before = ops.LAUNCHES["rwkv6_scan"]
    got, got_state = ssm.rwkv6_seq(params, cfg, x, return_state=True)
    assert ops.LAUNCHES["rwkv6_scan"] == before + 1
    want, want_state = ssm.rwkv6_seq(params, cfg, x, impl="torch",
                                     return_state=True)
    assert ops.LAUNCHES["rwkv6_scan"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_state.cpu().numpy(),
                               want_state.cpu().numpy(), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# K2 `flash_attention`: the CUDA kernel against its plain version (float32
# logits and softmax), both on the card.  Tolerances as the reference's
# kernel tests hold Pallas to its oracle: 2e-5 absolute in float32 (sums in
# another order), 3e-2 absolute in bfloat16 (the kernel rounds P to bfloat16
# for the PV product, and both round the output); and, tighter in late
# causal rows, each row's error against that row's root mean square
# (chip_smoke.K2_ROW_TOL, set from the card's readings in PERF.md).
# ---------------------------------------------------------------------------
# bf16 at D = 64 or 128 runs the Hopper body (TMA, wgmma): the qwen grouping
# (G = 8) at one, two and three 128-row tiles (200 and 257 ragged: TMA
# zero-fills K/V rows past S and the store skips output rows past it), and
# more work tiles than the card has SMs (the persistent walk, with K/V tiles
# and the next Q loaded across work tiles).
K2_SHAPES = [(2, 64, 4, 2, 32), (1, 128, 8, 8, 64), (2, 96, 6, 2, 16),
             (1, 200, 4, 1, 128), (2, 33, 2, 2, 64),
             (1, 128, 16, 2, 128), (1, 200, 16, 2, 128), (1, 257, 16, 2, 128),
             (2, 96, 4, 2, 64), (3, 640, 16, 2, 128), (2, 1000, 16, 2, 64)]
K2_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# Inputs whose rows' maxima jump at later key tiles, so that the Hopper
# body's lazy softmax redoes those tiles exactly (randn inputs at scale
# D^-0.5 never make it), and a negative scale (no lazy tile at all); see
# chip_smoke.k2_inputs.
K2_REDO_CASES = [(shape, kind) for kind in ("growth", "scale1")
                 for shape in ((1, 700, 16, 2, 128), (2, 520, 8, 2, 64))] + [
    ((1, 300, 16, 2, 128), "negative"), ((2, 300, 8, 2, 64), "negative")]


def _k2_close(got, want, dtype):
    """K2's limits: absolute, and against each output row's size (late
    causal rows are small, so a fault there can hide under the absolute
    limit)."""
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=K2_TOL[dtype], rtol=0)
    assert (chip_smoke.k2_row_err(got, want)
            <= chip_smoke.K2_ROW_TOL[getattr(torch, dtype)])


def _k2_inputs(dev, shape, dtype=torch.float32, *, seed=0):
    b, s, h, kv, dh = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, s, n, dh)).astype(np.float32))
            .to(dev, dtype) for n in (h, kv, kv)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", K2_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k2_cuda_kernel_matches_plain(cuda_device, shape, dtype, causal):
    q, k, v = _k2_inputs(cuda_device, shape, getattr(torch, dtype),
                         seed=sum(shape))
    scale = shape[-1] ** -0.5
    want = ref.flash_attention_ref(q, k, v, scale=scale, causal=causal)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, scale=scale, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    _k2_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape,kind", K2_REDO_CASES,
                         ids=lambda c: c if isinstance(c, str)
                         else "x".join(map(str, c)))
def test_k2_cuda_lazy_softmax_redoes_rows_that_grow(cuda_device, shape, kind,
                                                    causal):
    """The Hopper body's exact redo (logits again with `mma.sync`, the
    exact softmax, the output rescaled) and its negative-scale path, held
    to the plain version; head slices of a fused tensor give the same bits."""
    q, k, v, scale = chip_smoke.k2_inputs(shape, torch.bfloat16, cuda_device,
                                          kind=kind, causal=causal, seed=5)
    redos = chip_smoke.k2_lazy_redos(q, k, scale, causal)
    assert (redos > 0) == (kind != "negative")
    want = ref.flash_attention_ref(q, k, v, scale=scale, causal=causal)
    got = ops.flash_attention(q, k, v, scale=scale, causal=causal)
    _k2_close(got, want, "bfloat16")
    h, kv = shape[2], shape[3]
    qkv = torch.cat([q, k, v], dim=2)             # (B, S, H + 2 KV, D)
    assert torch.equal(ops.flash_attention(
        qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:], scale=scale,
        causal=causal), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_cuda_reads_strided_head_slices(cuda_device, dtype):
    """q, k, v as head slices of wider tensors (as a fused QKV projection
    would give them): read through their strides, the same result."""
    q, k, v = _k2_inputs(cuda_device, (2, 96, 6, 2, 32), getattr(torch, dtype),
                         seed=3)
    want = ops.flash_attention(q, k, v, scale=0.2)
    qkv = torch.cat([q, k, v], dim=2)             # (B, S, H + 2 KV, D)
    qs, ks, vs = qkv[:, :, :6], qkv[:, :, 6:8], qkv[:, :, 8:]
    assert not qs.is_contiguous() and not ks.is_contiguous()
    assert torch.equal(ops.flash_attention(qs, ks, vs, scale=0.2), want)
    np.testing.assert_allclose(
        want.float().cpu().numpy(),
        ref.flash_attention_ref(q, k, v, scale=0.2).float().cpu().numpy(),
        atol=K2_TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_cuda_reads_strided_head_slices_d128(cuda_device, dtype):
    """As above at the qwen head dim: in bf16 the TMA tensor maps, built
    from the slices' strides, give the contiguous result bit for bit."""
    q, k, v = _k2_inputs(cuda_device, (2, 200, 16, 2, 128),
                         getattr(torch, dtype), seed=4)
    want = ops.flash_attention(q, k, v, scale=0.09)
    qkv = torch.cat([q, k, v], dim=2)             # (B, S, H + 2 KV, D)
    qs, ks, vs = qkv[:, :, :16], qkv[:, :, 16:18], qkv[:, :, 18:]
    assert not qs.is_contiguous() and not ks.is_contiguous()
    assert torch.equal(ops.flash_attention(qs, ks, vs, scale=0.09), want)
    np.testing.assert_allclose(
        want.float().cpu().numpy(),
        ref.flash_attention_ref(q, k, v, scale=0.09).float().cpu().numpy(),
        atol=K2_TOL[dtype], rtol=0)


@pytest.mark.cuda
def test_k2_cuda_refuses_strides_tma_cannot_take(cuda_device):
    q, k, v = _k2_inputs(cuda_device, (1, 64, 4, 1, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="TMA cannot take"):
        ops.flash_attention(q, k.expand(1, 64, 2, 64), v.expand(1, 64, 2, 64),
                            scale=1.0)
    # The first body reads a broadcast kv head through its zero stride.
    q32, k32, v32 = (t.float() for t in (q, k, v))
    got = ops.flash_attention(q32, k32.expand(1, 64, 2, 64),
                              v32.expand(1, 64, 2, 64), scale=0.125)
    want = ref.flash_attention_ref(q32, k32, v32, scale=0.125)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=K2_TOL["float32"], rtol=0)


@pytest.mark.cuda
def test_k2_cuda_rejects_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _k2_inputs(cuda_device, (1, 16, 4, 2, 32))
    with pytest.raises(ValueError, match="head dim 96"):
        ops.flash_attention(*_k2_inputs(cuda_device, (1, 16, 4, 2, 96)),
                            scale=1.0)
    with pytest.raises(TypeError, match="share one dtype"):
        ops.flash_attention(q, k.bfloat16(), v, scale=1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), k.half(), v.half(), scale=1.0)
    with pytest.raises(ValueError, match="is on cpu"):
        ops.flash_attention(q, k.cpu(), v, scale=1.0)
    with pytest.raises(ValueError, match="contiguous in its last axis"):
        ops.flash_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3),
                            v, scale=1.0)
    with pytest.raises(ValueError, match="start on 16 bytes"):
        ops.flash_attention(torch.cat([q.flatten()[:1], q.flatten()])[1:]
                            .view(q.shape), k, v, scale=1.0)
    lib = ops.load_library("flash_attention")
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention.launch(lib, q.cpu(), k.cpu(), v.cpu(), scale=1.0,
                               causal=True)
    assert ops.flash_attention(q, k, v, scale=1.0).shape == q.shape


@pytest.mark.cuda
def test_attention_auto_runs_the_kernel_on_the_card(cuda_device):
    cfg = layers.AttnCfg(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                         qkv_bias=True, rope_theta=1e6)
    params = {n: t.to(cuda_device) for n, t in layers.init_attention(
        torch.Generator().manual_seed(0), cfg).items()}
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 96, 256)).astype(np.float32)).to(cuda_device)
    before = ops.LAUNCHES["flash_attention"]
    got = layers.attention(params, cfg, x)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = layers.attention(params, cfg, x, impl="torch")
    assert ops.LAUNCHES["flash_attention"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
