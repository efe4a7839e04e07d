"""The CUDA kernel K1 (`ra_aggregate`) against its plain PyTorch version.

These tests need an NVIDIA GPU (and nvcc to build the kernel): a CUDA
kernel has no CPU mode, so elsewhere they skip with that reason.  They
import neither JAX nor the reference package, so they run on a machine
with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 1e-5 absolute for float32 (sums in another order); for
bfloat16 one bfloat16 ulp plus that 1e-5, since both sides round float32
sums that may differ by it (where a sum cancels to near zero, 1e-5 is
many ulps of the result).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import bf16_ulps  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

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


@pytest.mark.cuda
@pytest.mark.parametrize("with_tx", [False, True], ids=["no_tx", "tx"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_cuda_kernel_matches_plain(cuda_device, case, mode, with_tx):
    w, p, e, tx = _case(7, with_tx=with_tx, **CASES[case])
    want = ops.ra_aggregate(w, p, e, tx=tx, mode=mode, device="cpu")
    before = ops.LAUNCHES["ra_aggregate"]
    got = ops.ra_aggregate(w.to(cuda_device), p.to(cuda_device),
                           e.to(cuda_device),
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
