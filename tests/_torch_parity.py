"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

The reference and the port cannot draw the same random numbers (threefry vs
Philox), so the tests replay the reference's draws: `round_uniforms`
rebuilds, from a round key, exactly the uniforms each reference protocol
draws, in the shapes the port's ``u=`` arguments take, and
`codec_uniforms` the quantizer's (the port's ``u_codec=``).  This module imports
JAX only inside that function, so the card-only tests can use the rest on
a machine without JAX.
"""
import numpy as np
import torch

# Small, fixed thread count: the suite runs several test workers at once.
torch.set_num_threads(2)


def round_uniforms(protocol: str, key, n: int, l: int, n_mixes: int = 1):
    """The reference's uniforms for one round of ``protocol`` under ``key``
    (the round key `round_step` / `dispatch_round_seg` receives), as a
    float32 torch tensor — or None for protocols that draw nothing."""
    import jax

    if protocol == "ra":        # errors.sample_success
        u = jax.random.uniform(key, (n, n, l))
    elif protocol == "aayg":    # protocols.aayg_round_seg: one draw per mix
        keys = jax.random.split(key, n_mixes)
        u = np.stack([np.asarray(jax.random.uniform(k, (n, n, l)))
                      for k in keys])
    elif protocol == "cfl":     # protocols.cfl_round_seg: uplink, downlink
        kup, kdn = jax.random.split(key)
        u = np.stack([np.asarray(jax.random.uniform(kup, (n, l))),
                      np.asarray(jax.random.uniform(kdn, (n, l)))])
    else:               # ideal_cfl / none draw nothing
        return None
    return torch.from_numpy(np.array(u, dtype=np.float32))


def codec_uniforms(key, n: int, s: int, k: int):
    """The reference's quantizer uniforms for the round key ``key``: its
    simulator draws them from ``fold_in(key, _CODEC_KEY_TAG)`` at the
    (N, S, K) width, which the port's ``u_codec`` takes."""
    import jax

    from repro.fl.simulator import _CODEC_KEY_TAG

    u = jax.random.uniform(jax.random.fold_in(key, _CODEC_KEY_TAG),
                           (n, s, k))
    return torch.from_numpy(np.array(u, dtype=np.float32))


def bf16_ulps(got: np.ndarray, want: np.ndarray, atol: float = 0.0) -> float:
    """Largest ``|got - want| - atol`` in units of the bfloat16 spacing at
    the larger magnitude of the two (8 significant bits)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    tiny = np.finfo(np.float32).tiny
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, tiny))) - 7)
    return float(np.max((np.abs(got - want) - atol) / ulp))


def reference_dryrun():
    """The reference's `launch/dryrun.py`, imported without its import-time
    XLA_FLAGS reaching this process's JAX (initialized first) or the
    processes it starts (restored after)."""
    import os

    import jax

    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun
