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
import math
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
    "n4_f32": dict(n=4, l=9, k=1024),             # `launch.train --dfl`
    "n4_bf16": dict(n=4, l=9, k=1024, w_dtype="bfloat16"),
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
             (2, 96, 4, 2, 64), (3, 640, 16, 2, 128), (2, 1000, 16, 2, 64),
             # whisper-base's encoder (S = 1,500: a ragged last tile) and
             # decoder prefills, the VLM's (64 heads over 8), at batch 1
             (1, 1500, 8, 8, 64), (1, 416, 8, 8, 64), (1, 2048, 64, 8, 128)]
K2_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# Inputs whose rows' maxima jump at later key tiles, so that the Hopper
# body's lazy softmax redoes those tiles exactly (randn inputs at scale
# D^-0.5 never make it), and a negative scale (no lazy tile at all); see
# chip_smoke.k2_inputs.
K2_REDO_CASES = [(shape, kind) for kind in ("growth", "scale1")
                 for shape in ((1, 700, 16, 2, 128), (2, 520, 8, 2, 64),
                               (1, 700, 8, 2, 256))] + [
    ((1, 300, 16, 2, 128), "negative"), ((2, 300, 8, 2, 64), "negative"),
    ((1, 300, 8, 2, 256), "negative")]


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
def test_k2_cuda_refuses_a_broadcast_kv_at_head_dim_256(cuda_device):
    """The D = 256 Hopper body reads k and v by TMA too: a stride-0 kv head
    is refused before the launch; float32 takes it through the first
    body."""
    q, k, v = _k2_inputs(cuda_device, (1, 64, 4, 1, 256), torch.bfloat16)
    kb, vb = (t.expand(1, 64, 2, 256) for t in (k, v))
    with pytest.raises(ValueError, match="TMA cannot take"):
        ops.flash_attention(q, kb, vb.contiguous(), scale=0.0625)
    with pytest.raises(ValueError, match="TMA cannot take"):
        ops.flash_attention(q, kb.contiguous(), vb, scale=0.0625)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    got = ops.flash_attention(q32, k32.expand(1, 64, 2, 256),
                              v32.expand(1, 64, 2, 256), scale=0.0625)
    want = ref.flash_attention_ref(q32, k32, v32, scale=0.0625)
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


# Head dim 256 (gemma-7b's; the Hopper body's 80-key tiles in bf16, the
# first body in float32): a ragged S, grouped and multi-head.
K2_D256_SHAPES = [(2, 200, 4, 2, 256), (1, 333, 8, 8, 256), (1, 64, 2, 1, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", K2_D256_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k2_cuda_head_dim_256_matches_plain(cuda_device, shape, dtype,
                                            causal):
    q, k, v = _k2_inputs(cuda_device, shape, getattr(torch, dtype),
                         seed=sum(shape))
    want = ref.flash_attention_ref(q, k, v, scale=0.0625, causal=causal)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, scale=0.0625, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert flash_attention.body(q.dtype, 256) == (
        "wgmma" if dtype == "bfloat16" else "simt")
    _k2_close(got, want, dtype)


# Windows at D = 64, 128 and 256 (the Hopper body in bf16): one key, below
# one tile, not a multiple of 128, 512, and S or more.
K2_WINDOW_CASES = [(d, w) for d in (64, 128, 256)
                   for w in (1, 40, 300, 512, 700, 5000)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,window", K2_WINDOW_CASES,
                         ids=lambda c: str(c))
def test_k2_cuda_window_matches_plain(cuda_device, d, window, dtype, causal):
    """K2 under a sliding window against its plain version; a window of S
    (700) or more gives what no window gives, bit for bit."""
    q, k, v = _k2_inputs(cuda_device, (2, 700, 8, 2, d), getattr(torch, dtype),
                         seed=d + window)
    scale = d ** -0.5
    want = ref.flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                   window=window)
    got = ops.flash_attention(q, k, v, scale=scale, causal=causal,
                              window=window)
    _k2_close(got, want, dtype)
    if window >= 700:
        assert torch.equal(got, ops.flash_attention(q, k, v, scale=scale,
                                                    causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [300, 512])
def test_k2_cuda_lazy_softmax_redoes_under_a_window(cuda_device, window):
    """Rows that grow past the lazy softmax's reference max inside their
    window: the Hopper body's redo and the window's exact edge tiles
    together, held to the plain version."""
    q, k, v, scale = chip_smoke.k2_inputs(
        (1, 1100, 16, 2, 128), torch.bfloat16, cuda_device, kind="growth",
        causal=True, seed=6, window=window)
    assert chip_smoke.k2_lazy_redos(q, k, scale, True, window=window) > 0
    want = ref.flash_attention_ref(q, k, v, scale=scale, window=window)
    _k2_close(ops.flash_attention(q, k, v, scale=scale, window=window), want,
              "bfloat16")


@pytest.mark.cuda
def test_k2_cuda_window_refused_below_one(cuda_device):
    q, k, v = _k2_inputs(cuda_device, (1, 16, 4, 2, 32))
    with pytest.raises(ValueError, match="window must be a positive"):
        ops.flash_attention(q, k, v, scale=1.0, window=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "starcoder2-3b", "gemma-7b"])
def test_dense_zoo_smoke_prefill_on_the_card_matches_the_cpu(cuda_device,
                                                             arch):
    """Each new dense config's float32 smoke prefill, with and without a
    window, on the card (K2 once a layer) against the CPU's plain path."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import registry

    cfg = cfgbase.smoke_variant(cfgbase.get(arch))
    bundle = registry.build(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 150),
                           generator=torch.Generator().manual_seed(1))
    for window in (None, 37):
        want, wcache = bundle.prefill_step(params, {"tokens": tokens},
                                           window=window, device="cpu")
        before = ops.LAUNCHES["flash_attention"]
        got, cache = bundle.prefill_step(
            {k: v.to(cuda_device) for k, v in params.items()},
            {"tokens": tokens.to(cuda_device)}, window=window,
            device=cuda_device)
        assert ops.LAUNCHES["flash_attention"] == before + cfg.n_layers
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(cache["v"].cpu().numpy(),
                                   wcache["v"].numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_wrapped_decode_matches_unwrapped_on_the_card(cuda_device):
    """The float32 smoke llama3 decoding 2 W + 8 steps into a wrapped cache
    of W = 16 slots against the unwrapped windowed decode on the card, and
    the card's wrapped run against the CPU's: the same greedy ids, logits
    within 1e-4."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import registry

    cfg = cfgbase.smoke_variant(cfgbase.get("llama3-8b"))
    bundle = registry.build(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    w, n = 16, 40

    def run(dev, wrapped):
        p = {k: v.to(dev) for k, v in params.items()}
        cache = bundle.init_cache(3, n, window=w if wrapped else None,
                                  device=dev)
        tok = torch.arange(3, device=dev)[:, None] + 5
        out = []
        for a in range(n):
            kw = (dict(abs_pos=a, full_cache=a >= w) if wrapped else {})
            logits, cache = bundle.serve_step(p, cache, tok,
                                              a % w if wrapped else a,
                                              window=w, device=dev, **kw)
            out.append(logits[:, -1].cpu())
            tok = logits[:, -1].argmax(-1)[:, None]
        return torch.stack(out)

    wrapped = run(cuda_device, True)
    for other in (run(cuda_device, False), run(torch.device("cpu"), True)):
        assert torch.equal(wrapped.argmax(-1), other.argmax(-1))
        np.testing.assert_allclose(wrapped.numpy(), other.numpy(), atol=1e-4,
                                   rtol=1e-4)


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


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", ["ra", "aayg"])
def test_codec_exchange_runs_k1_transmit_mask_variant(cuda_device, protocol):
    """A top-k round's bool (N, S) transmit mask, straight from the codec,
    reaches K1's transmit-mask variant: once for R&A, once a mix for AaYG,
    and the result matches the CPU's plain path (1e-5)."""
    from repro_torch.core import compression, protocols
    from repro_torch.kernels import ra_aggregate

    rng = np.random.default_rng(0)
    n, s, k, mixes = 10, 37, 256, 2
    w = torch.from_numpy(rng.normal(size=(n, s, k)).astype(np.float32))
    p = torch.from_numpy(rng.dirichlet(np.ones(n)).astype(np.float32))
    eps = torch.from_numpy(rng.uniform(0.3, 1.0, (n, n)).astype(np.float32))
    shape = (n, n, s) if protocol == "ra" else (mixes, n, n, s)
    u = torch.from_numpy(rng.random(shape, dtype=np.float32))
    w_tx, tx = compression.encode(compression.CODEC_IDS["topk"], w, 0.3)
    assert tx.dtype == torch.bool and int(tx[0].sum()) == 12
    pid = protocols.PROTOCOL_IDS[protocol]
    before = dict(ra_aggregate.VARIANT_LAUNCHES)
    got, e_got, _ = protocols.dispatch_round_seg(
        w_tx.to(cuda_device), p.to(cuda_device), eps.to(cuda_device),
        eps.to(cuda_device), pid, 0, 6, n_mixes=mixes,
        tx_mask=tx.to(cuda_device), u=u.to(cuda_device))
    want, e_want, _ = protocols.dispatch_round_seg(
        w_tx, p, eps, eps, pid, 0, 6, n_mixes=mixes, tx_mask=tx, u=u,
        agg_impl="kernel")
    ran = {v: c - before[v] for v, c in ra_aggregate.VARIANT_LAUNCHES.items()}
    assert ran == {"plain": 0, "tx": 1 if protocol == "ra" else mixes}
    np.testing.assert_array_equal(e_got.cpu().numpy(), e_want.numpy())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)


# K1 through its vmap rule (`kernels.ops._ra_vmap_rule`): every vmapped call,
# nested or not, must be one launch of the folded batch, and match the plain
# version of the rank-4 call.
VMAP_CASES = {
    # (a, b, n, l, k): vmap over a of vmap over b (a=None: one level).
    "single": (None, 4, 10, 37, 256),
    "nested": (2, 3, 10, 37, 256),
    "nested_grid12": (3, 4, 10, 412, 1024),    # B * G = 12, the slice width
    "nested_smem": (2, 2, 20, 9, 256),         # N > 16: shared-memory body
}


@pytest.mark.cuda
@pytest.mark.parametrize("tx_kind", ["none", "shared", "batched"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(VMAP_CASES))
def test_k1_cuda_vmap_folds_into_one_launch(cuda_device, case, mode, tx_kind):
    from repro_torch.kernels import ra_aggregate

    a, b, n, l, k = VMAP_CASES[case]
    lead = (b,) if a is None else (a, b)
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=lead + (n, l, k)).astype(np.float32))
    p = torch.from_numpy(rng.dirichlet(np.ones(n)).astype(np.float32))
    e = torch.from_numpy(rng.random(lead + (n, n, l)) < 0.6)
    tx = {"none": None,
          "shared": torch.from_numpy(rng.random((n, l)) < 0.5),
          "batched": torch.from_numpy(rng.random(lead + (n, l)) < 0.5)}[tx_kind]
    flat = math.prod(lead)
    want = ops.ra_aggregate(
        w.reshape((flat, n, l, k)), p, e.reshape((flat, n, n, l)),
        tx=None if tx is None else (tx if tx.ndim == 2
                                    else tx.reshape(flat, n, l)),
        mode=mode, device="cpu")
    dev = cuda_device
    # The mask reaches the rule as a strided view: the batch axis last.
    e_dev = e.movedim(-4, -1).contiguous().to(dev)
    tx_dev = None if tx is None else tx.to(dev)

    def k1(w_, e_, tx_):
        return ops.ra_aggregate(w_, p.to(dev), e_, tx=tx_, mode=mode)

    tx_dim = 0 if tx_kind == "batched" else None
    fn = torch.func.vmap(k1, in_dims=(0, 3, tx_dim))
    if a is not None:
        fn = torch.func.vmap(fn, in_dims=(0, 0, tx_dim))
    before = ops.LAUNCHES["ra_aggregate"]
    batches = dict(ra_aggregate.BATCH_LAUNCHES)
    got = fn(w.to(dev), e_dev, tx_dev)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ra_aggregate"] == before + 1
    assert ra_aggregate.BATCH_LAUNCHES.get(flat, 0) == batches.get(flat, 0) + 1
    np.testing.assert_allclose(got.reshape(want.shape).cpu().numpy(),
                               want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_grid_runner_on_the_card_matches_run_sequential(cuda_device):
    """A small grid through `GridRunner.run` on the card: one K1 launch a
    round per R&A group, of B = the group's size, none for C-FL; every
    launch runs the transmit-mask variant, since concat gives the
    codec-free rows the `none` codec (an all-ones mask).  Rows agree with
    `run_sequential` (the same draws) within 1e-4 in loss and one test
    sample in accuracy."""
    from repro_torch.core import topology
    from repro_torch.data import synthetic
    from repro_torch.fl import scenarios, simulator
    from repro_torch.kernels import ra_aggregate
    from repro_torch.models import smallnets

    data = synthetic.fed_image_classification(n_clients=10,
                                              samples_per_client=40)
    net = topology.paper_network(packet_len_bits=8192)
    init = lambda g: smallnets.init_mlp_clf(g, d_in=32, d_hidden=16)  # noqa
    cfg = simulator.SimConfig(seg_len=256, local_epochs=2, n_rounds=3)
    grid = scenarios.ScenarioGrid.concat(
        scenarios.ScenarioGrid.product(
            networks=[("a", net), ("b", topology.paper_network_with_relays(
                5, packet_len_bits=8192))],
            protocols=[("ra", "ra_normalized"), ("cfl", "ra_normalized")],
            seeds=[0, 1]),
        scenarios.ScenarioGrid.product(
            schedules=[("m", topology.markov_link_schedule(net, 3,
                                                           p_drop=0.3))],
            codecs=[("k", "topk", 0.5)], seeds=[2, 3]))
    runner = scenarios.GridRunner(init, smallnets.apply_mlp_clf, data, cfg,
                                  device=cuda_device)
    seq = runner.run_sequential(grid)
    ops.LAUNCHES["ra_aggregate"] = 0
    for name in ra_aggregate.VARIANT_LAUNCHES:
        ra_aggregate.VARIANT_LAUNCHES[name] = 0
    ra_aggregate.BATCH_LAUNCHES.clear()
    got = runner.run(grid)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ra_aggregate"] == 6
    assert ra_aggregate.VARIANT_LAUNCHES == {"plain": 0, "tx": 6}
    assert ra_aggregate.BATCH_LAUNCHES == {4: 3, 2: 3}
    np.testing.assert_allclose(got.loss, seq.loss, atol=1e-4, rtol=0)
    assert np.abs(got.acc - seq.acc).max() <= 1.0 / len(data.test_y) + 1e-6


@pytest.mark.cuda
def test_k1_first_use_from_two_threads_builds_once_and_counts_each_launch(
        cuda_device, monkeypatch):
    """Two threads first-use K1 together (the loaded library dropped):
    the library is bound once, both threads launch, and every launch is
    counted (the counters are incremented under a lock)."""
    import threading

    from repro_torch.kernels import ra_aggregate

    monkeypatch.setattr(ops, "_LIBS", {})
    w, p, e, tx = _case(3, b=4, n=10, l=9, k=256)
    want = ops.ra_aggregate(w, p, e, mode="ra_normalized", device="cpu")
    wd, pd, ed = w.to(cuda_device), p.to(cuda_device), e.to(cuda_device)
    before = ops.LAUNCHES["ra_aggregate"]
    batches = ra_aggregate.BATCH_LAUNCHES.get(4, 0)
    barrier = threading.Barrier(2)
    outs, errors = [[], []], []

    def body(i):
        try:
            barrier.wait(60)
            for _ in range(50):
                outs[i].append(ops.ra_aggregate(wd, pd, ed,
                                                mode="ra_normalized"))
            torch.cuda.synchronize()
        except BaseException as exc:    # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
        assert not t.is_alive()
    assert not errors, errors
    assert list(ops._LIBS) == ["ra_aggregate"]
    assert ops.LAUNCHES["ra_aggregate"] == before + 100
    assert ra_aggregate.BATCH_LAUNCHES[4] == batches + 100
    for got in outs[0][:1] + outs[1][-1:]:
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-5, rtol=0)


def _serving_toy():
    from repro_torch.core import topology
    from repro_torch.data import synthetic
    from repro_torch.fl import scenarios, simulator
    from repro_torch.models import smallnets

    data = synthetic.fed_image_classification(n_clients=3,
                                              samples_per_client=20, seed=0)
    nets = [topology.make_network(topology.TABLE_II_COORDS[:3],
                                  edge_density=d, packet_len_bits=32 * 64,
                                  n_clients=3, tx_power_dbm=tx)
            for d, tx in ((0.6, 17.0), (0.8, 17.0), (0.8, 11.0))]
    cfg = simulator.SimConfig(n_rounds=3, local_epochs=2, seg_len=64)
    pool = [scenarios.ScenarioGrid.product(
                networks=[(f"n{i}", nets[i % 3])],
                protocols=[(proto, "ra_normalized")], seeds=[i])
            for i, proto in enumerate(("ra", "ra", "aayg", "ra", "aayg",
                                       "ra"))]
    init = lambda g: smallnets.init_mlp_clf(g, d_in=32, d_hidden=16)  # noqa
    return data, init, smallnets.apply_mlp_clf, cfg, pool


def _served_vs_dispatched(dev, results, pool, probes, data, init, apply_fn,
                          cfg):
    """Each served row against `GridRunner.run` of the coalesced grid its
    server dispatched, on the same card: returns whether every row is the
    same bits (printed), after holding all within 1e-4 / one sample."""
    from repro_torch.fl import scenarios

    runner = scenarios.GridRunner(init, apply_fn, data, cfg, device=dev)
    replays = [(g, runner.run(g, pad_to=pad, validate=False))
               for p in probes for g, pad in p.ran]
    bitwise = True
    for res, req in zip(results, pool):
        g, rows = next((g, r) for g, r in replays
                       if req.labels[0] in g.labels)
        i = g.labels.index(req.labels[0])
        bitwise &= bool(np.array_equal(res.loss, rows.loss[i:i + 1])
                        and np.array_equal(res.acc, rows.acc[i:i + 1]))
        np.testing.assert_allclose(res.loss, rows.loss[i:i + 1], atol=1e-4,
                                   rtol=0)
        assert np.abs(res.acc - rows.acc[i:i + 1]).max() <= (
            1.0 / len(data.test_y) + 1e-6)
    return bitwise


@pytest.mark.cuda
def test_server_and_two_replica_router_on_the_card(cuda_device):
    """The toy server and a two-replica router on the card: every served
    row against `GridRunner.run` of the same coalesced grid on the card
    (bit for bit or within 1e-4 / one test sample; which of the two is
    printed); K1 launched from the dispatcher threads, one a round per R&A
    group."""
    from _torch_serving_faults import install
    from repro_torch.launch import router, serving

    data, init, apply_fn, cfg, pool = _serving_toy()
    serve_cfg = serving.ServeConfig(max_batch=4, max_delay_s=0.05)
    server = serving.ScenarioServer(init, apply_fn, data, cfg,
                                    serve=serve_cfg, device=cuda_device)
    probe = install(server)
    before = ops.LAUNCHES["ra_aggregate"]
    with server:
        got = [f.result(timeout=600) for f in
               [server.submit(g) for g in pool]]
    assert ops.LAUNCHES["ra_aggregate"] > before
    bits = _served_vs_dispatched(cuda_device, got, pool, [probe], data, init,
                                 apply_fn, cfg)
    print(f"server rows vs the dispatched grids on the card: "
          f"{'bit for bit' if bits else 'within 1e-4'}")

    rt = router.ScenarioRouter.in_process(init, apply_fn, data, cfg,
                                          n_replicas=2, serve=serve_cfg,
                                          device=cuda_device)
    probes = [install(rep.server) for rep in rt.replicas.values()]
    try:
        with rt:
            got = [f.result(timeout=600) for f in
                   [rt.submit(g) for g in pool]]
    finally:
        rt.stop(drain=False)
    bits = _served_vs_dispatched(cuda_device, got, pool, probes, data, init,
                                 apply_fn, cfg)
    print(f"router rows vs the dispatched grids on the card: "
          f"{'bit for bit' if bits else 'within 1e-4'}")
    assert rt.tracker.snapshot()["router/requests"] == len(pool)


@pytest.mark.cuda
def test_run_resumable_round_trip_on_the_card(cuda_device, tmp_path):
    """`run_resumable` on the card, interrupted after one chunk and
    resumed: the same rows as an uninterrupted run and `run_scenario`
    within 1e-4 / one test sample (bit for bit is printed), the generator
    restored on the card."""
    from repro_torch.checkpoint import checkpoint
    from repro_torch.core import topology
    from repro_torch.fl import simulator

    data, init, apply_fn, cfg, _pool = _serving_toy()
    sim = simulator.build_sim(init, apply_fn, data, seg_len=64,
                              local_epochs=2, n_rounds=3, device=cuda_device)
    net = topology.make_network(topology.TABLE_II_COORDS[:3],
                                edge_density=0.8, packet_len_bits=32 * 64,
                                n_clients=3, tx_power_dbm=17.0)
    sc = simulator.make_scenario(net, simulator.SimConfig(
        n_rounds=3, seg_len=64, local_epochs=2, seed=3))
    ref = sim.run_scenario(sc)
    full = checkpoint.run_resumable(sim, sc, ckpt_dir=str(tmp_path / "a"))
    assert checkpoint.run_resumable(sim, sc, ckpt_dir=str(tmp_path / "b"),
                                    stop_after=1) is None
    resumed = checkpoint.run_resumable(sim, sc, ckpt_dir=str(tmp_path / "b"))
    bits = all(np.array_equal(resumed[k], full[k]) for k in full)
    print(f"resumed vs uninterrupted on the card: "
          f"{'bit for bit' if bits else 'within 1e-4'}")
    for other in (full, {k: v.numpy() for k, v in ref.items()}):
        np.testing.assert_allclose(resumed["loss"], other["loss"], atol=1e-4,
                                   rtol=0)
        assert np.abs(resumed["acc"] - other["acc"]).max() <= (
            1.0 / len(data.test_y) + 1e-6)
    state = sim.init_scan(sc.prepare().to(cuda_device))
    saved = checkpoint._saved_state(state)
    checkpoint.save(str(tmp_path / "c"), saved)
    live = checkpoint._live_state(checkpoint.restore(str(tmp_path / "c"),
                                                     saved), cuda_device)
    assert live["gen"].device.type == "cuda"
    assert torch.equal(torch.rand(4, generator=live["gen"],
                                  device=cuda_device),
                       torch.rand(4, generator=state["gen"],
                                  device=cuda_device))


# ---------------------------------------------------------------------------
# Slice 7: training and the paper's tasks
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_k2_k3_refuse_autograd_on_the_card(cuda_device):
    """K2 and K3 have no backward: under autograd or `torch.func.grad` they
    raise instead of returning an output with no ``grad_fn``."""
    chip_smoke.refuse_autograd_check(cuda_device)


@pytest.mark.cuda
def test_training_forward_launches_neither_k2_nor_k3(cuda_device):
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import registry

    for arch in ("qwen2.5-3b", "rwkv6-1.6b"):
        cfg = cfgbase.smoke_variant(cfgbase.get(arch))
        bundle = registry.build(cfg)
        state = registry.init_state(
            bundle, torch.Generator(cuda_device).manual_seed(0),
            device=cuda_device)
        before = dict(ops.LAUNCHES)
        tokens = torch.randint(0, cfg.vocab, (2, 64), device=cuda_device)
        state, m = bundle.train_step(state, {"tokens": tokens},
                                     device=cuda_device)
        assert math.isfinite(float(m["loss"]))
        assert ops.LAUNCHES == before
        # Serving the same weights still runs the kernel.
        bundle.prefill_step(state["params"], {"tokens": tokens},
                            device=cuda_device)
        kernel = "rwkv6_scan" if cfg.family == "ssm" else "flash_attention"
        assert ops.LAUNCHES[kernel] == before[kernel] + cfg.n_layers


@pytest.mark.cuda
def test_paper_tasks_reduced_match_the_cpu(cuda_device):
    """ResNet depth 8 width 4 and CharRNN hidden 32: 2 R&A rounds on the
    card and on the CPU from the same weights and uniforms (1e-4, equal
    accuracies)."""
    chip_smoke.paper_tasks_reference((torch.device("cpu"), cuda_device))


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    chip_smoke.train_step_reference((torch.device("cpu"), cuda_device))


@pytest.mark.cuda
def test_k1_launches_on_the_training_paths(cuda_device):
    """K1 launches once a `ra_round`, J times an `aayg_round`, never in
    `cfl_round` / `ideal_cfl_round`; twice in a `--dfl` run of 4 steps
    exchanging every 2; one a round of R&A and AaYG in the paper tasks,
    and one a round of the R&A group (B = 2) in the NWP grid."""
    from repro_torch.core import protocols, routing, topology
    from repro_torch.launch import train

    net = topology.paper_network(packet_len_bits=32768)
    rho = routing.e2e_success(net.link_eps)[0].to(cuda_device)
    link_eps = net.link_eps.to(cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(0)
    stacked = {"a": torch.randn((10, 3000), generator=gen,
                                device=cuda_device),
               "b": torch.randn((10, 7, 5), generator=gen,
                                device=cuda_device)}
    p = torch.full((10,), 0.1, device=cuda_device)
    runs = [
        (1, lambda: protocols.ra_round(stacked, p, rho, seg_len=1024,
                                       generator=gen)),
        (3, lambda: protocols.aayg_round(stacked, p, link_eps, seg_len=1024,
                                         n_mixes=3, generator=gen)),
        (0, lambda: protocols.cfl_round(stacked, p, rho, seg_len=1024,
                                        generator=gen)),
        (0, lambda: protocols.ideal_cfl_round(stacked, p, seg_len=1024)),
    ]
    for want, run in runs:
        before = ops.LAUNCHES["ra_aggregate"]
        run()
        assert ops.LAUNCHES["ra_aggregate"] - before == want
    out = train.main(["--dfl", "--clients", "2", "--steps", "4",
                      "--rounds-per-exchange", "2", "--batch", "2",
                      "--seq", "16"])
    assert out["k1_launches"] == 2
    total = chip_smoke.paper_tasks_phase(
        cuda_device, image_samples=8, hw=16,
        overrides={"resnet": dict(depth=8, width=4),
                   "charrnn": dict(hidden=16)},
        char_kw=dict(sequences_per_client=4, test_sequences=8, seq_len=8),
        profile=False)
    assert total == 4 * 2 * 3          # 4 tasks x (R&A + AaYG) x 3 rounds
    assert chip_smoke.nwp_grid_phase(cuda_device, sequences=8,
                                     n_rounds=2) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "dbrx-132b",
                                  "hymba-1.5b"])
def test_moe_hybrid_smoke_prefill_and_decode_on_the_card_match_the_cpu(
        cuda_device, arch):
    """Each MoE / hybrid config's float32 smoke prefill on the card (K2 once
    a layer) and 8 greedy decode steps (no K2) against the CPU's plain
    path: the same ids, logits and every cache leaf within 1e-4."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import serve
    from repro_torch.models import registry

    cfg = cfgbase.smoke_variant(cfgbase.get(arch))
    bundle_params = registry.build(cfg).init(
        torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 150),
                           generator=torch.Generator().manual_seed(1))
    kw = dict(batch=2, prompt_len=150, gen=9)
    cpu = serve.serve(cfg, **kw, device="cpu", params=bundle_params,
                      tokens=tokens)
    before = ops.LAUNCHES["flash_attention"]
    gpu = serve.serve(cfg, **kw, device=cuda_device,
                      params={k: v.to(cuda_device)
                              for k, v in bundle_params.items()},
                      tokens=tokens.to(cuda_device))
    assert gpu.prefill_launches["flash_attention"] == cfg.n_layers
    assert gpu.decode_launches["flash_attention"] == 0
    assert ops.LAUNCHES["flash_attention"] == before + cfg.n_layers
    assert torch.equal(gpu.tokens, cpu.tokens)
    np.testing.assert_allclose(gpu.prefill_logits.cpu().numpy(),
                               cpu.prefill_logits.numpy(), atol=1e-4,
                               rtol=1e-4)
    assert list(gpu.prefill_cache) == list(cpu.prefill_cache)
    for name, want in cpu.prefill_cache.items():
        np.testing.assert_allclose(gpu.prefill_cache[name].cpu().numpy(),
                                   want.numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [1.0, 0.5])
def test_moe_layer_on_the_card_matches_the_cpu(cuda_device, cf):
    """`moe_layer` at 3 groups of 512 tokens on the card against the CPU:
    the same kept selections, y and aux within 1e-5 in float32; in
    bfloat16 y keeps its dtype and aux is float32."""
    from repro_torch.models import moe

    cfg = moe.MoECfg(d_model=128, d_ff=96, n_experts=16, top_k=4,
                     capacity_factor=cf, group_size=512)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 512, 128)).astype(np.float32))
    want, waux = moe.moe_layer(params, cfg, x)
    gp = {k: v.to(cuda_device) for k, v in params.items()}
    got, aux = moe.moe_layer(gp, cfg, x.to(cuda_device))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    cap = moe._capacity(512, cfg)
    r_cpu = moe.route(params, cfg, x, cap)
    r_gpu = moe.route(gp, cfg, x.to(cuda_device), cap)
    assert torch.equal(r_gpu.idx.cpu(), r_cpu.idx)
    assert torch.equal(r_gpu.keep.cpu(), r_cpu.keep)
    assert 0 < int(r_cpu.keep.sum()) < r_cpu.keep.numel()
    y16, aux16 = moe.moe_layer({k: v.bfloat16() for k, v in gp.items()}, cfg,
                               x.to(cuda_device).bfloat16())
    assert y16.dtype == torch.bfloat16 and aux16.dtype == torch.float32
    assert bool(torch.isfinite(y16).all())


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 100, 2048])
def test_ssm_seq_and_step_on_the_card_match_the_cpu(cuda_device, s):
    """`ssm_seq` (output and final state) on the card against the CPU
    within 1e-5, and one `ssm_step` from that state."""
    cfg = ssm.SSMCfg(d_model=96, d_state=16)
    params = ssm.init_ssm(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, s, 96)).astype(np.float32))
    want, wstate = ssm.ssm_seq(params, cfg, x, return_state=True)
    gp = {k: v.to(cuda_device) for k, v in params.items()}
    got, state = ssm.ssm_seq(gp, cfg, x.to(cuda_device), return_state=True)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(state.cpu().numpy(), wstate.numpy(),
                               atol=1e-5, rtol=1e-5)
    step_x = x[:, :1]
    wo, wst = ssm.ssm_step(params, cfg, step_x, wstate)
    go, gst = ssm.ssm_step(gp, cfg, step_x.to(cuda_device), state)
    np.testing.assert_allclose(go.cpu().numpy(), wo.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(gst.cpu().numpy(), wst.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "hymba_1_5b"])
def test_nwp_sim_model_rounds_under_vmap_on_the_card(cuda_device, arch):
    """`nwp:<arch>` clients through `GridRunner.run` on the card (each
    round one vmap over the R&A group's 2 scenarios, the clients'
    gradients vmapped inside): one K1 launch a round, of B = 2; rows
    within 1e-4 of `run_sequential` on the card."""
    import warnings

    from repro_torch.core import topology
    from repro_torch.data import synthetic
    from repro_torch.fl import scenarios, simulator
    from repro_torch.kernels import ra_aggregate
    from repro_torch.models import registry

    model = registry.sim_model(f"nwp:{arch}", vocab=90)
    data = synthetic.fed_char_stream(
        n_clients=10, vocab=90, seq_len=16, sequences_per_client=8,
        test_sequences=16, iid=False, seed=0)
    cfg = simulator.SimConfig(n_rounds=2, seg_len=64, local_epochs=1, lr=0.5)
    net = topology.make_network(
        topology.TABLE_II_COORDS, edge_density=0.5, packet_len_bits=25_000,
        n_clients=10, tx_power_dbm=17.0)
    grid = scenarios.ScenarioGrid.product(
        networks=[("tab2", net)],
        protocols=[("ra", "ra_normalized"), ("none", "ra_normalized")],
        seeds=range(2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore",
                              simulator.PacketLengthMismatchWarning)
        runner = scenarios.GridRunner(model.init_fn, model.apply_fn, data,
                                      cfg, device=cuda_device)
        seq = runner.run_sequential(grid)
        ops.LAUNCHES["ra_aggregate"] = 0
        ra_aggregate.BATCH_LAUNCHES.clear()
        got = runner.run(grid)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ra_aggregate"] == 2
    assert ra_aggregate.BATCH_LAUNCHES == {2: 2}
    assert bool(np.isfinite(got.loss).all())
    np.testing.assert_allclose(got.loss, seq.loss, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_modal_smoke_prefill_on_the_card_matches_impl_torch_and_the_cpu(
        cuda_device, arch):
    """Each modal config's float32 smoke prefill with its gates set on the
    card: through K2 (whisper: 2 full encoder and 2 causal decoder
    launches; the VLM: one a self layer) against impl="torch" on the card
    and the CPU's plain path, logits and every cache leaf (k, v, xk, xv)
    within 1e-4; then 8 greedy decode steps (no K2), the same ids as the
    CPU's."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import serve
    from repro_torch.models import registry, transformer

    cfg = cfgbase.smoke_variant(cfgbase.get(arch))
    bundle = registry.build(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    chip_smoke.set_gates(params)
    tokens = torch.randint(0, cfg.vocab, (2, 150),
                           generator=torch.Generator().manual_seed(1))
    modal = torch.randn((2, transformer.modal_len(cfg), cfg.d_model),
                        generator=torch.Generator().manual_seed(2))
    kw = dict(batch=2, prompt_len=150, gen=9)
    cpu = serve.serve(cfg, **kw, device="cpu", params=params, tokens=tokens,
                      modal=modal)
    on_card = {k: v.to(cuda_device) for k, v in params.items()}
    batch = {"tokens": tokens.to(cuda_device),
             "modal_embeds": modal.to(cuda_device)}
    expected = chip_smoke.k2_per_prefill(cfg)
    before = ops.LAUNCHES["flash_attention"]
    masks = dict(flash_attention.MASK_LAUNCHES)
    got = bundle.prefill_step(on_card, batch, device=cuda_device)
    assert ops.LAUNCHES["flash_attention"] == before + sum(expected.values())
    assert {k: flash_attention.MASK_LAUNCHES[k] - masks[k]
            for k in masks} == expected
    plain = bundle.prefill_step(on_card, batch, impl="torch",
                                device=cuda_device)
    assert ops.LAUNCHES["flash_attention"] == before + sum(expected.values())
    for want in (plain, (cpu.prefill_logits, cpu.prefill_cache)):
        np.testing.assert_allclose(got[0].cpu().numpy(),
                                   want[0].cpu().numpy(), atol=1e-4,
                                   rtol=1e-4)
        assert list(got[1]) == list(want[1]) == ["k", "v", "xk", "xv"]
        for name in got[1]:
            np.testing.assert_allclose(got[1][name].cpu().numpy(),
                                       want[1][name].cpu().numpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=name)
    res = serve.serve(cfg, **kw, device=cuda_device, params=on_card,
                      tokens=batch["tokens"], modal=batch["modal_embeds"])
    assert res.decode_launches["flash_attention"] == 0
    assert torch.equal(res.tokens, cpu.tokens)


# ---------------------------------------------------------------------------
# The multi-rank path: 4 ranks sharing the card over gloo (NCCL needs a
# card per rank), spawned by `launch.mesh.spawn`; phase 24 of
# chip_smoke.py at a smaller size.
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_multi_rank_exchange_on_the_card(cuda_device):
    """`ra_exchange` on 4 CUDA ranks, each comm without and with a
    participation mask, against the single-process `ra_round_seg` (K1) on
    the card with the same draws (1e-5); sampled-out ranks keep their own
    parameters bit for bit."""
    import _torch_ranks
    from repro_torch.core import protocols
    from repro_torch.launch import mesh

    n, seg_len = 4, 6
    rng = np.random.default_rng(0)
    inp = dict(w=rng.normal(size=(n, 4, 6)).astype(np.float32),
               b=rng.normal(size=(n, 6)).astype(np.float32),
               p=rng.dirichlet(np.ones(n)).astype(np.float32),
               rho=rng.uniform(0.3, 0.95, (n, n)).astype(np.float32),
               u=rng.uniform(size=(n, n, 5)).astype(np.float32),
               mask=np.array([1, 0, 1, 1], np.float32), seg_len=seg_len)
    ranks = mesh.spawn(_torch_ranks.dfl_exchange_rank, n,
                       args=(inp, "cuda"), device="cuda", timeout=240)
    stacked = {k: torch.from_numpy(inp[k]).to(cuda_device)
               for k in ("b", "w")}
    w_seg, spec, m_params = protocols._to_segments(stacked, seg_len)
    before = ops.LAUNCHES["ra_aggregate"]
    for mname, part in (("none", None), ("mask", inp["mask"])):
        out, _e = protocols.ra_round_seg(
            w_seg, *(torch.from_numpy(inp[k]).to(cuda_device)
                     for k in ("p", "rho")), 0,
            None if part is None else torch.from_numpy(part).to(cuda_device),
            u=torch.from_numpy(inp["u"]).to(cuda_device), agg_impl="kernel")
        want = protocols._from_segments(out, spec, m_params)
        for comm in ("all_to_all", "reduce_scatter", "psum"):
            for r in range(n):
                got = ranks[r][f"exchange/{comm}/{mname}"]
                for k in ("w", "b"):
                    np.testing.assert_allclose(
                        got[k], want[k][r].cpu().numpy(), atol=1e-5, rtol=0)
                    if part is not None and part[r] == 0:
                        np.testing.assert_array_equal(got[k], inp[k][r])
    assert ops.LAUNCHES["ra_aggregate"] - before == 2


@pytest.mark.cuda
def test_multi_rank_grid_on_the_card(cuda_device):
    """A 6-scenario grid over (2, 2), (2, 1) and 1-D meshes of 4 CUDA ranks
    against the single-process `run_grid` on the card (loss 1e-4,
    accuracy within one test sample): every rank of a mesh launches K1
    once a round of its R&A and its AaYG group (C-FL launches none), each
    model shard on its window; the closed-loop `policy_grid_of` over the
    (2, 2) mesh selects as the single process does, with K1 once a round
    for each of its two groups;
    `run_resumable` on a (1, 2) mesh resumes as it ran unbroken."""
    import tempfile
    import warnings

    import _torch_ranks
    from repro_torch.fl import scenarios, simulator
    from repro_torch.launch import mesh
    from repro_torch.models import smallnets

    data, net, init_fn = _torch_ranks.toy()
    cfg = simulator.SimConfig(agg_impl="kernel", **_torch_ranks.STATICS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = scenarios.run_grid(init_fn, smallnets.apply_mlp_clf, data,
                                  _torch_ranks.grid_of(net), cfg,
                                  device=cuda_device)
        policy = scenarios.run_grid(init_fn, smallnets.apply_mlp_clf, data,
                                    _torch_ranks.policy_grid_of(net), cfg,
                                    device=cuda_device)
    with tempfile.TemporaryDirectory() as d:
        ranks = mesh.spawn(_torch_ranks.grid_and_resume_rank, 4,
                           args=(d, "cuda"), device="cuda", timeout=300)
    rounds = _torch_ranks.STATICS["n_rounds"]
    for r, out in enumerate(ranks):
        for spec in ("(None, 2)", "sharding", "(2, 1)", "[0, 1, 2, 3]"):
            if spec == "(2, 1)" and r >= 2:
                assert out[spec] is None and out["k1"][spec] == 0
                continue
            labels, acc, loss, _bias = out[spec]
            assert labels == want.labels
            np.testing.assert_allclose(loss, want.loss, atol=1e-4, rtol=0)
            assert np.abs(acc - want.acc).max() <= 1 / len(data.test_y) + 1e-6
            # On the 1-D mesh of 4 a group of 2 shrinks it to ranks 0-1.
            idle = spec == "[0, 1, 2, 3]" and r >= 2
            assert out["k1"][spec] == (0 if idle else 2 * rounds)
        labels, acc, loss, _bias, selected = out["policy"]
        assert labels == policy.labels
        np.testing.assert_array_equal(selected, policy.selected)
        np.testing.assert_allclose(loss, policy.loss, atol=1e-4, rtol=0)
        assert np.abs(acc - policy.acc).max() <= 1 / len(data.test_y) + 1e-6
        assert out["k1"]["policy"] == 2 * rounds
    for r in (0, 1):
        for key, v in ranks[r]["unbroken"].items():
            np.testing.assert_allclose(ranks[r]["resumed"][key], v,
                                       atol=1e-4, rtol=0, equal_nan=True)


@pytest.mark.cuda
def test_multi_rank_server_on_the_card(cuda_device):
    """`ScenarioServer(devices=[0, 1])` on 2 ranks sharing the card: the
    reference's three requests coalesced into one dispatch padded to 4
    rows, each grid row of the mesh running 2; the served rows against a
    single-process server on the card (loss 1e-4, accuracy within one
    test sample), and each rank's K1 launches by (B, N, L, K) equal to
    what the leader's dispatch log gives (as chip_smoke.py's phase 24
    (e) checks)."""
    import types

    import _torch_ranks
    from repro_torch.fl import scenarios
    from repro_torch.launch import mesh, serving
    from repro_torch.models import smallnets

    ranks = mesh.spawn(_torch_ranks.serving_card_rank, 2, device="cuda",
                       timeout=240)
    data, nets, init_fn, cfg = _torch_ranks.serving_toy()
    requests = _torch_ranks.serving_requests(nets)
    server = serving.ScenarioServer(
        init_fn, smallnets.apply_mlp_clf, data, cfg, device=cuda_device,
        serve=serving.ServeConfig(max_batch=3, batch_buckets=(4,),
                                  max_delay_s=30.0))
    with server:
        want = server.serve(requests)
    lead = ranks[0]
    assert lead["device"].startswith("cuda")
    for got, w in zip(lead["rows"], want):
        labels, acc, loss, _bias = got
        assert labels == w.labels
        np.testing.assert_allclose(loss, w.loss, atol=1e-4, rtol=0)
        assert np.abs(acc - w.acc).max() <= 1 / len(data.test_y) + 1e-6
    runner = scenarios.GridRunner(init_fn, smallnets.apply_mlp_clf, data,
                                  cfg, device=cuda_device)
    expected = chip_smoke._mr_expected_k1(
        runner, lead["ran"], types.SimpleNamespace(ranks=np.arange(2)), cfg,
        runner.sim.n_segments)
    assert [len(g) for g, _pad in lead["ran"]] == [3]
    for r, out in enumerate(ranks):
        assert out["k1_by_shape"] == expected[r] != {}, r


@pytest.mark.cuda
def test_card_is_the_h100_sxm_of_the_roofline_constants(cuda_device):
    """`launch.mesh`'s PEAK_FLOPS_BF16 / HBM_BW / LINK_BW are the H100 SXM
    80GB's published figures: the card must be that one (chip_smoke.py's
    phase 25 (a))."""
    chip_smoke.card_constants_check(cuda_device)
