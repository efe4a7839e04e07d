"""The generator: the paper's networks as the port builds them, the same
set of shard sizes on every seed, inputs fixed by the seed, and scenario
seeds within the port's int32 field."""
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


@pytest.mark.parametrize("kind", ["char", "image"])
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
    if kind == "char":
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
