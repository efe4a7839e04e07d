"""Segmented model delivery under communication errors (paper Sec. III-B.2).

Port of the reference package's `core/errors.py`.  A model of M parameters
is encoded as float32 and segmented into L = ceil(M / K) packets of K
values; segment l of client m's model reaches client n error-free with
probability rho_{m,n}, an independent Bernoulli per (m, n, l) (eq. 7).

Parameters are flat ``dict[str, Tensor]``s whose iteration order is the
reference's leaf order (sorted keys, nested dicts flattened with dotted
names — see `repro_torch.interop`); that order decides which parameters
a segment holds.

Random draws: `sample_success` takes its uniforms as an optional argument
so a test can hand it the reference's draws (threefry and Philox cannot
draw the same numbers); without them it draws from ``generator``.
"""
from __future__ import annotations

import math

import torch

FLOAT_BITS = 32  # the paper encodes models as float32

Params = dict[str, torch.Tensor]


def param_count(params: Params) -> int:
    """Total number of parameters in one client's params (no leading N)."""
    return sum(int(t.numel()) for t in params.values())


def num_segments(m_params: int, seg_len: int) -> int:
    return -(-m_params // seg_len)


def dtype_bits(dtype: torch.dtype) -> int:
    """Bits per value for a model-state dtype (bf16 -> 16, f32 -> 32)."""
    return torch.empty((), dtype=dtype).element_size() * 8


def packet_len_bits(seg_len: int, bits_per_value: int = FLOAT_BITS) -> int:
    """Packet length in bits for K values of ``bits_per_value`` bits each."""
    return bits_per_value * seg_len


def stack_to_matrix(stacked: Params) -> tuple[torch.Tensor, list]:
    """Flatten client-stacked params (leaves (N, ...)) to an (N, M) matrix.

    Returns (matrix, spec) where spec = [(name, per-client shape), ...] in
    leaf order rebuilds the dict (`matrix_to_stack`).
    """
    leaves = list(stacked.values())
    n = leaves[0].shape[0]
    mat = torch.cat([leaf.reshape(n, -1) for leaf in leaves], dim=1)
    spec = [(name, tuple(leaf.shape[1:])) for name, leaf in stacked.items()]
    return mat, spec


def matrix_to_stack(mat: torch.Tensor, spec: list) -> Params:
    n = mat.shape[0]
    sizes = [math.prod(shape) for _, shape in spec]
    parts = torch.split(mat, sizes, dim=1)
    return {name: part.reshape((n,) + shape)
            for (name, shape), part in zip(spec, parts)}


def segment(mat: torch.Tensor, seg_len: int) -> torch.Tensor:
    """(N, M) -> (N, L, K), zero-padded in the final segment."""
    n, m = mat.shape
    l = num_segments(m, seg_len)
    mat = torch.nn.functional.pad(mat, (0, l * seg_len - m))
    return mat.reshape(n, l, seg_len)


def unsegment(seg: torch.Tensor, m_params: int) -> torch.Tensor:
    """(N, L, K) -> (N, M), dropping padding."""
    return seg.reshape(seg.shape[0], -1)[:, :m_params]


def local_slice(full: torch.Tensor, n_local: int,
                seg_start: int) -> torch.Tensor:
    """Slice a full-segment-axis tensor to a model shard's local window.

    ``full`` carries the global segment axis last (e.g. an (N, N, S)
    success mask sampled at the full segment count); the window is
    ``[seg_start, seg_start + n_local)``.  The axis is zero-padded by
    ``n_local`` first, so every window that holds a real segment is in
    bounds and is never shifted onto other segments.  A start past the
    padded end is clamped, as the reference's ``lax.dynamic_slice``
    clamps it: such a window holds only padding, whose values no protocol
    reads back (zero segments stay zero).
    """
    padded = torch.nn.functional.pad(full, (0, n_local))
    start = min(int(seg_start), padded.shape[-1] - n_local)
    # A copy, as the reference's slice is: K1 takes masks contiguous in
    # their trailing axes.
    return padded.narrow(-1, start, n_local).contiguous()


def sample_success(
    rho: torch.Tensor,
    n_segments: int,
    *,
    n_clients: int | None = None,
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    dtype: torch.dtype = torch.bool,
) -> torch.Tensor:
    """Sample success indicators e_{m,n,l} ~ Bernoulli(rho_{m,n}).

    Args:
      rho: (V, V) E2E packet success rates (only the client block is used).
      n_segments: L.
      n_clients: number of FL clients N (defaults to rho.shape[0]).
      u: optional (N, N, L) float32 uniforms in [0, 1); drawn from
        ``generator`` on ``rho``'s device when None.
      dtype: mask dtype — packed ``bool`` by default (1 byte/indicator);
        consumers cast to float32 once, at the aggregation boundary.

    Returns:
      e: (N, N, L) in {0, 1}.  e[n, n, :] == 1 (own model is local).
    """
    n = rho.shape[0] if n_clients is None else n_clients
    r = rho[:n, :n]
    if u is None:
        u = torch.rand((n, n, n_segments), generator=generator,
                       device=rho.device)
    e = u < r[:, :, None]
    e = e | torch.eye(n, dtype=torch.bool, device=rho.device)[:, :, None]
    return e if dtype == torch.bool else e.to(dtype)
