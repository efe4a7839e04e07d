"""The generator: the paper's networks as the port builds them, the same
set of shard sizes on every seed, inputs fixed by the seed, scenario
seeds within the port's int32 field, and the token data's chains at a
language model's vocabulary share."""
import tracemalloc

import numpy as np
import pytest
import torch

from dfl_bench import harness, testing, traffic

BIG = 2 ** 33 + 12345   # seeds run past 32 bits


@pytest.mark.parametrize("dbm", [17.0, 20.0])
def test_network_is_make_networks(dbm):
    from repro_torch.core import topology

    cell = harness.load_json(harness.find("cells", "charrnn.grid12"))
    net = cell["network"]
    mine = traffic.network(net["coords"], edge_density=net["edge_density"],
                           packet_len_bits=net["packet_len_bits"],
                           tx_power_dbm=dbm)
    ports = topology.make_network(
        topology.TABLE_II_COORDS, edge_density=net["edge_density"],
        packet_len_bits=net["packet_len_bits"], n_clients=10,
        tx_power_dbm=dbm)
    assert np.array_equal(mine.adjacency, ports.adjacency.numpy())
    assert torch.equal(mine.link_eps, ports.link_eps)


@pytest.mark.parametrize("mean", [200, 512, 1000])
def test_sizes_are_one_set_in_another_order(mean):
    sets = [traffic.client_sizes(mean, 10, s) for s in (0, 1, BIG)]
    assert len({tuple(s) for s in sets}) == 3
    assert len({tuple(sorted(s)) for s in sets}) == 1
    assert all(mean // 2 <= x < mean * 3 // 2 for x in sets[0])
    assert abs(sum(sets[0]) - 10 * mean) < 10


def test_call_seeds():
    a = traffic.call_seeds(BIG, 0, 2)
    assert a == traffic.call_seeds(BIG, 0, 2) and a[1] == a[0] + 1
    assert a != traffic.call_seeds(BIG, 1, 2) != traffic.call_seeds(
        BIG, -1, 2)
    assert all(0 <= s < 2 ** 31 for k in range(50)
               for s in traffic.call_seeds(k * 7919, k, 2))


@pytest.mark.parametrize("kind", ["char", "image", "tokens"])
def test_inputs_follow_the_seed(kind):
    c = testing.tiny_cell(kind)
    cpu = torch.device("cpu")
    one, two = (harness.make_inputs(c, BIG, cpu) for _ in range(2))
    other = harness.make_inputs(c, BIG + 1, cpu)
    for a, b in zip(one.train_x + [one.test_x], two.train_x + [two.test_x]):
        assert np.array_equal(a, b)
    assert not np.array_equal(one.test_x, other.test_x)
    assert [len(x) for x in one.train_x] == one.sizes
    data = c.config["data"]
    if kind != "image":
        assert one.train_x[0].shape[1] == data["seq_len"]
        assert one.test_x.max() < data["vocab"] and one.test_x.min() >= 0
        assert np.array_equal(one.train_x[0][:, 1:], one.train_y[0][:, :-1])
    else:
        assert one.train_x[0].shape[1:] == (data["hw"], data["hw"], 3)
        # One class a client (label skew).
        assert all(len(set(y.tolist())) == 1 for y in one.train_y)
    w = one.weights(5)
    assert torch.equal(w[one.layout[-1][0]], two.weights(5)[
        one.layout[-1][0]])


def test_classes_a_client_lie_in_blocks():
    c = testing.tiny_cell("image")
    c.config["data"]["classes_per_client"] = 2
    inputs = harness.make_inputs(c, BIG, torch.device("cpu"))
    classes = c.config["data"]["n_classes"]
    for k, (y, n) in enumerate(zip(inputs.train_y, inputs.sizes)):
        # Two contiguous blocks: its first half one class, the rest the next.
        assert y.tolist() == ([2 * k % classes] * (n // 2)
                              + [(2 * k + 1) % classes] * (n - n // 2))


def test_init_scales_multiply_the_layout_by_leaf_name():
    layout = [("stage0.0.conv1", (3, 3, 4, 4), 0.5),
              ("stage0.0.conv2", (3, 3, 4, 4), 0.5), ("stem", (3,), 2.0)]
    assert harness.scaled(layout, {"conv1": 0.25, "conv2": 0.0}) == [
        ("stage0.0.conv1", (3, 3, 4, 4), 0.125),
        ("stage0.0.conv2", (3, 3, 4, 4), 0.0), ("stem", (3,), 2.0)]
    assert harness.scaled(layout, None) == layout
    config = harness.load_json(harness.find("configs", "resnet56-cifar10"))
    w = traffic.Weights(harness.scaled(
        [("stage1.4.conv2", (3, 3, 32, 32), 0.08)], config["init_scales"]),
        3, torch.device("cpu"))(9)
    assert not w["stage1.4.conv2"].any()


# The token data at LFM2-8B-A1B's share (its config.json: 65,536 ids,
# 128,000 positions; a vocabulary sliced over the chips that share a
# layer), each parameter with its reason:
TOKENS = {
    "kind": "tokens",
    # An eighth of the 65,536 ids: the least share of a vocabulary that a
    # configuration may hold.
    "vocab": 8192,
    # Sequences of 1,024 tokens: a training context a client holds at
    # published widths beside its activations.
    "seq_len": 1024,
    # 64 successors an id: O(V x 64) a chain; the top 1 % of ids (82)
    # appear among nearly every id's successors, as text's most frequent
    # tokens follow nearly every token.
    "fanout": 64,
    # Zipf's law of word frequencies, exponent about 1: a few ids carry
    # half the tokens, which is what makes a MoE router's load uneven.
    "zipf": 1.0,
    # Peaked successor weights, as the char data's: a next-token entropy
    # of about 3.2 nats, so that the model has something to learn.
    "gamma_shape": 0.3,
    "test_sequences": 4,
}
CHAINS = 11        # 10 clients and the test set's global chain


def test_token_data_follows_the_seed():
    cpu = torch.device("cpu")
    sizes = [2] * (CHAINS - 1)
    one, two, other = (traffic.token_data(TOKENS, sizes, s, cpu)
                       for s in (BIG, BIG, BIG + 1))
    for a, b in zip(one.train_x + [one.test_x], two.train_x + [two.test_x]):
        assert torch.equal(a, b)
    assert not torch.equal(one.test_x, other.test_x)
    assert len(one.train_x) == CHAINS - 1
    assert one.test_x.shape == (TOKENS["test_sequences"], TOKENS["seq_len"])
    for x, y in zip(one.train_x, one.train_y):
        assert x.shape == (2, TOKENS["seq_len"]) and x.dtype == torch.int32
        assert torch.equal(x[:, 1:], y[:, :-1])
        assert 0 <= int(x.min()) and int(x.max()) < TOKENS["vocab"]
    # Each client's chain is its own: its sequences differ from the next's.
    assert not torch.equal(one.train_x[0], one.train_x[1])


def test_a_token_chain_holds_o_of_v_times_fanout():
    rng = np.random.default_rng(5)
    limit = TOKENS["vocab"] * TOKENS["fanout"] * 16
    tracemalloc.start()
    try:
        for _ in range(CHAINS):
            succ = cum = None
            tracemalloc.reset_peak()
            held = tracemalloc.get_traced_memory()[0]
            succ, cum = traffic.token_chain(TOKENS, rng)
            peak = tracemalloc.get_traced_memory()[1] - held
            assert peak < limit and succ.nbytes + cum.nbytes < limit
    finally:
        tracemalloc.stop()
    assert succ.shape == cum.shape == (TOKENS["vocab"], TOKENS["fanout"])
    assert np.all(np.diff(cum, axis=1) >= 0)
    assert np.allclose(cum[:, -1], 1.0)


def test_the_top_percent_of_ids_carry_the_zipf_share():
    data = traffic.token_data(TOKENS, [8] * (CHAINS - 1), BIG,
                              torch.device("cpu"))
    tokens = torch.cat([x.reshape(-1) for x in data.train_x]
                       + [data.test_x.reshape(-1)]).numpy()
    counts = np.sort(np.bincount(tokens, minlength=TOKENS["vocab"]))[::-1]
    top = TOKENS["vocab"] // 100
    law = traffic.zipf_law(TOKENS["vocab"], TOKENS["zipf"])
    # About half the tokens (0.520 under the law at V = 8,192, s = 1).
    assert abs(counts[:top].sum() / counts.sum() - law[:top].sum()) < 0.03
