"""Synthetic federated datasets (offline stand-ins for the paper's datasets).

A numpy-only copy of the reference package's generator, kept here so the
port depends on nothing of the reference: for the same arguments and seed
both produce equal arrays (tests/test_torch_network.py holds them to it).

  * `fed_image_classification` — K-class Gaussian-cluster "images", split
    into N non-i.i.d. label-skew shards (paper: one class per client).
  * `fed_char_stream` — a synthetic character-level corpus over a 90-symbol
    vocabulary generated by a random Markov chain (Shakespeare stand-in);
    i.i.d. or per-client-chain (non-i.i.d.) partitions.
  * `lm_token_stream` — token stream for LM pre-training examples.

(tests/test_torch_data.py holds the last two to the reference bit for bit.)
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FederatedDataset:
    """Per-client train/test arrays."""

    train_x: list[np.ndarray]
    train_y: list[np.ndarray]
    test_x: np.ndarray
    test_y: np.ndarray

    @property
    def n_clients(self) -> int:
        return len(self.train_x)

    def client_sizes(self) -> np.ndarray:
        return np.array([len(x) for x in self.train_x], dtype=np.float64)

    def weights(self) -> np.ndarray:
        s = self.client_sizes()
        return s / s.sum()


def fed_image_classification(
    *,
    n_clients: int = 10,
    n_classes: int = 10,
    d: int = 32,
    samples_per_client: int = 200,
    classes_per_client: int = 1,
    noise: float = 0.6,
    test_size: int = 500,
    seed: int = 0,
) -> FederatedDataset:
    """Label-skew non-iid classification (paper: 1 category per client).

    Class c has a Gaussian prototype mu_c in R^d; samples are mu_c + noise.
    Client n holds samples from `classes_per_client` classes starting at
    class (n mod n_classes) — classes_per_client=1 reproduces the paper's
    extreme one-class-per-client Fed-FashionMNIST split.
    """
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, d)).astype(np.float32)
    # Unequal client sizes so p_n differ (exercises weighted aggregation).
    sizes = rng.integers(samples_per_client // 2, samples_per_client * 3 // 2,
                         size=n_clients)

    def sample(cls, n):
        x = protos[cls] + noise * rng.normal(size=(n, d)).astype(np.float32)
        return x, np.full(n, cls, dtype=np.int32)

    train_x, train_y = [], []
    for n in range(n_clients):
        cls = [(n + j) % n_classes for j in range(classes_per_client)]
        per = int(sizes[n]) // len(cls)
        xs, ys = zip(*(sample(c, per) for c in cls))
        train_x.append(np.concatenate(xs))
        train_y.append(np.concatenate(ys))

    per = test_size // n_classes
    xs, ys = zip(*(sample(c, per) for c in range(n_classes)))
    return FederatedDataset(train_x, train_y, np.concatenate(xs), np.concatenate(ys))


def fed_char_stream(
    *,
    n_clients: int = 10,
    vocab: int = 90,
    seq_len: int = 32,
    sequences_per_client: int = 64,
    iid: bool = True,
    test_sequences: int = 256,
    seed: int = 0,
) -> FederatedDataset:
    """Markov-chain character corpus (Shakespeare stand-in).

    iid=True: all clients sample from one chain. iid=False: each client has
    its own chain (role-level non-iid of the FedProx split).
    """
    rng = np.random.default_rng(seed)

    def make_chain(r):
        t = r.gamma(0.3, size=(vocab, vocab))  # sparse-ish transitions
        return t / t.sum(1, keepdims=True)

    global_chain = make_chain(rng)

    def gen(chain, n_seq, r):
        out = np.empty((n_seq, seq_len + 1), dtype=np.int32)
        for i in range(n_seq):
            s = r.integers(vocab)
            for j in range(seq_len + 1):
                out[i, j] = s
                s = r.choice(vocab, p=chain[s])
        return out

    train_x, train_y = [], []
    for n in range(n_clients):
        r = np.random.default_rng(seed + 1 + n)
        chain = global_chain if iid else make_chain(r)
        n_seq = int(r.integers(sequences_per_client // 2,
                               sequences_per_client * 3 // 2))
        seqs = gen(chain, n_seq, r)
        train_x.append(seqs[:, :-1])
        train_y.append(seqs[:, 1:])

    r = np.random.default_rng(seed + 999)
    seqs = gen(global_chain, test_sequences, r)
    return FederatedDataset(train_x, train_y, seqs[:, :-1], seqs[:, 1:])


def lm_token_stream(*, vocab: int, n_tokens: int, seed: int = 0) -> np.ndarray:
    """Zipf-distributed token stream for LM pre-training demos."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    return rng.choice(vocab, size=n_tokens, p=probs).astype(np.int32)
