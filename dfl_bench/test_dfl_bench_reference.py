"""The reference's frozen copies against the port's code they mirror, on
the CPU at small sizes: XLA's SAME padding, the ResNet and LSTM forwards,
min-E2E-PER routing, eq. 6 and the substitution baseline, and the AaYG,
C-FL and error-free exchanges fed the same uniforms.  And the reference
sweep, which writes trained rows into one buffer, against the loop that
stacked a list of them."""
import itertools

import pytest
import torch

from dfl_bench import harness, testing, traffic
from dfl_bench.reference import charrnn, exchange, resnet, sweep


@pytest.mark.parametrize("size,k,stride",
                         list(itertools.product((7, 8, 16, 31, 32),
                                                (1, 3), (1, 2))))
def test_same_pads(size, k, stride):
    from repro_torch.models import smallnets

    assert resnet.same_pads(size, k, stride) == smallnets._same_pads(
        size, k, stride)


@pytest.mark.parametrize("kind", ["resnet", "charrnn"])
def test_forward_matches_the_port(kind):
    from repro_torch.models import smallnets

    gen = torch.Generator().manual_seed(3)
    if kind == "resnet":
        params = smallnets.init_resnet(gen, depth=8, width=4, n_classes=6)
        x = torch.randn(3, 9, 9, 3, generator=gen)
        got, want = resnet.forward(params, x), smallnets.apply_resnet(
            params, x)
    else:
        params = smallnets.init_charrnn(gen, vocab=12, embed=4, hidden=8)
        x = torch.randint(12, (3, 5), generator=gen)
        got, want = charrnn.forward(params, x), smallnets.apply_charrnn(
            params, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _net(dbm):
    cell = harness.load_json(harness.find("cells", "charrnn.grid12"))
    net = cell["network"]
    return traffic.network(net["coords"], edge_density=net["edge_density"],
                           packet_len_bits=net["packet_len_bits"],
                           tx_power_dbm=dbm)


@pytest.mark.parametrize("dbm", [17.0, 20.0])
def test_route_is_the_ports_bit_for_bit(dbm):
    from repro_torch.fl import simulator

    link = _net(dbm).link_eps
    assert torch.equal(exchange.route(link), simulator.route(link))


def _segments(seed, n=5, l=7, k=6):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(n, l, k, generator=gen)
    p = torch.rand(n, generator=gen) + 0.1
    return w, p / p.sum(), gen


@pytest.mark.parametrize("mode", exchange.MODES)
def test_aggregation_rules(mode):
    from repro_torch.core import aggregation
    from repro_torch.kernels import ref

    w, p, gen = _segments(1)
    e = (torch.rand(5, 5, 7, generator=gen) < 0.6) | torch.eye(
        5, dtype=torch.bool)[:, :, None]
    got = exchange.aggregate(w, p, e, mode)
    torch.testing.assert_close(
        got, aggregation.apply_mode(aggregation.MODE_IDS[mode], w, p, e,
                                    impl="torch"))
    plain = {"ra_normalized": ref.ra_aggregate_ref,
             "substitution": ref.ra_substitution_ref}[mode]
    torch.testing.assert_close(got, plain(w[None], p[None], e[None])[0])


@pytest.mark.parametrize("protocol", exchange.PROTOCOLS)
def test_exchange_matches_dispatch(protocol):
    from repro_torch.core import protocols

    w, p, gen = _segments(2)
    link = _net(17.0).link_eps
    rho = exchange.route(link)
    shape = exchange.draw_shape(protocol, 5, 7, 3)
    u = None if shape is None else torch.rand(shape, generator=gen)
    got = exchange.exchange(w, p, rho, link, protocol, "ra_normalized", 2, u)
    want, _, _ = protocols.dispatch_round_seg(
        w, p, rho, link, protocols.PROTOCOL_IDS[protocol], 0, 2, n_mixes=3,
        u=u, agg_impl="torch")
    torch.testing.assert_close(got, want)


def _stacked_sweep(model, weights, shards, link_eps, *, seed, protocol,
                   mode, aggregator, lr, epochs, rounds, seg_len, mixes):
    """`sweep.run_scenario` as it was: each client's trained row padded
    into a list, the list stacked, the start rows held through the
    exchange."""
    dev = shards.test_x.device
    n = len(shards.xs)
    names = list(weights)
    shapes = [tuple(t.shape) for t in weights.values()]
    flat0 = torch.cat([t.reshape(-1) for t in weights.values()])
    m = flat0.numel()
    segs = -(-m // seg_len)
    w = torch.nn.functional.pad(flat0, (0, segs * seg_len - m))
    w = w.reshape(1, segs, seg_len).repeat(n, 1, 1).to(dev)
    rho = exchange.route(link_eps).to(dev)
    eps = link_eps.to(dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    shape = exchange.draw_shape(protocol, n, segs, mixes)
    accs, losses = [], []
    for _ in range(rounds):
        u = (None if shape is None
             else torch.rand(shape, generator=gen, device=dev))
        trained = []
        for c in range(n):
            row = w[c].reshape(-1)[:m]
            for _ in range(epochs):
                row = row.detach().requires_grad_(True)
                loss = sweep.ce_loss(model.forward(
                    sweep._views(row, names, shapes), shards.xs[c]),
                    shards.ys[c])
                (grad,) = torch.autograd.grad(loss, row)
                row = row.detach() - lr * grad
            trained.append(torch.nn.functional.pad(row,
                                                   (0, segs * seg_len - m)))
        w = exchange.exchange(torch.stack(trained).reshape(n, segs, seg_len),
                              shards.p, rho, eps, protocol, mode, aggregator,
                              u)
        acc, loss = [], []
        with torch.no_grad():
            for c in range(n):
                params = sweep._views(w[c].reshape(-1), names, shapes)
                pred = model.forward(params, shards.test_x).argmax(dim=-1)
                acc.append((pred == shards.test_y).to(torch.float32).mean())
                loss.append(sweep.ce_loss(model.forward(params, shards.xs[c]),
                                          shards.ys[c]))
        accs.append(torch.stack(acc))
        losses.append(torch.stack(loss))
    return {"acc": torch.stack(accs).cpu(), "loss": torch.stack(losses).cpu()}


@pytest.mark.parametrize("protocol,mode", [
    ("ra", "ra_normalized"), ("aayg", "ra_normalized"),
    ("cfl", "substitution")])
def test_the_buffered_sweep_is_the_stacked_one_bit_for_bit(protocol, mode):
    c = testing.tiny_cell("char")
    cpu = torch.device("cpu")
    inputs = harness.make_inputs(c, 2 ** 33 + 9, cpu)
    shards = sweep.tile_shards(
        [torch.from_numpy(x) for x in inputs.train_x],
        [torch.from_numpy(y) for y in inputs.train_y],
        torch.from_numpy(inputs.test_x), torch.from_numpy(inputs.test_y))
    # Two epochs over 5-value segments: a row in training is a new tensor,
    # and the last segment is padded.
    kw = dict(seed=77, protocol=protocol, mode=mode, aggregator=2, lr=0.5,
              epochs=2, rounds=3, seg_len=5, mixes=2)
    args = (charrnn, inputs.weights(77), shards, inputs.links[0][1].link_eps)
    got, want = sweep.run_scenario(*args, **kw), _stacked_sweep(*args, **kw)
    assert torch.equal(got["acc"], want["acc"])
    assert torch.equal(got["loss"], want["loss"])
