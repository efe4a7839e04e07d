"""PyTorch port vs the JAX reference: the NWP corpus, the LM token stream
and the host-side pipeline.

All of them are numpy with ``default_rng``; the port keeps its own copies,
so the arrays must be bit for bit the reference's (dtype included).  The
simulator's shard padding must carry int32 token shards (N, S) as it
carries images.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.fl import simulator as jsimulator  # noqa: E402
from repro_torch.data import pipeline, synthetic  # noqa: E402
from repro_torch.fl import simulator  # noqa: E402


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _datasets_equal(got, want):
    assert got.n_clients == want.n_clients
    for a, b in zip(got.train_x + got.train_y, want.train_x + want.train_y):
        _equal(a, b)
    _equal(got.test_x, want.test_x)
    _equal(got.test_y, want.test_y)
    np.testing.assert_array_equal(got.weights(), want.weights())


@pytest.mark.parametrize("kw", [
    dict(n_clients=3, sequences_per_client=6, test_sequences=8, seq_len=12),
    dict(n_clients=4, vocab=17, seq_len=5, sequences_per_client=4,
         test_sequences=3, iid=False, seed=3),
], ids=["iid", "noniid"])
def test_fed_char_stream_is_the_reference_bit_for_bit(kw):
    got = synthetic.fed_char_stream(**kw)
    _datasets_equal(got, jsynthetic.fed_char_stream(**kw))
    # Labels are the inputs shifted by one token.
    np.testing.assert_array_equal(got.train_x[0][:, 1:],
                                  got.train_y[0][:, :-1])


@pytest.mark.parametrize("vocab,n,seed", [(90, 1000, 0), (512, 5000, 7)])
def test_lm_token_stream_is_the_reference_bit_for_bit(vocab, n, seed):
    _equal(synthetic.lm_token_stream(vocab=vocab, n_tokens=n, seed=seed),
           jsynthetic.lm_token_stream(vocab=vocab, n_tokens=n, seed=seed))


@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_are_the_reference_bit_for_bit(drop_last):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(23, 4)).astype(np.float32)
    y = rng.integers(0, 5, size=23).astype(np.int32)
    got = list(pipeline.batches(x, y, 5, seed=3, drop_last=drop_last))
    want = list(jpipeline.batches(x, y, 5, seed=3, drop_last=drop_last))
    assert len(got) == len(want) == (4 if drop_last else 5)
    for (gx, gy), (wx, wy) in zip(got, want):
        _equal(gx, wx)
        _equal(gy, wy)


def test_client_stacked_batch_and_lm_batches_are_the_reference():
    data = synthetic.fed_char_stream(n_clients=3, sequences_per_client=4,
                                     test_sequences=2, seq_len=6)
    for bs in (2, 9):   # below and above the smallest shard (replacement)
        got = pipeline.client_stacked_batch(data.train_x, data.train_y, bs,
                                            seed=1)
        want = jpipeline.client_stacked_batch(data.train_x, data.train_y, bs,
                                              seed=1)
        for g, w in zip(got, want):
            _equal(g, w)
    stream = synthetic.lm_token_stream(vocab=50, n_tokens=400, seed=2)
    got = pipeline.lm_batches(stream, 3, 16, seed=5)
    want = jpipeline.lm_batches(stream, 3, 16, seed=5)
    for _ in range(4):
        _equal(next(got), next(want))


def test_token_shards_pad_like_the_reference():
    """int32 (n, S) token shards of unequal sizes tile to one (N, M, S)
    stack, as the reference pads them."""
    data = synthetic.fed_char_stream(n_clients=4, sequences_per_client=6,
                                     test_sequences=2, seq_len=7)
    assert len({len(x) for x in data.train_x}) > 1
    got = simulator._pad_shards(data)
    want = jsimulator._pad_shards(data)
    for g, w in zip(got, want):
        _equal(g, w)
    assert got[0].dtype == np.int32 and got[0].ndim == 3
