"""The reference's frozen copies against the port's code they mirror, on
the CPU at small sizes: XLA's SAME padding, the ResNet and LSTM forwards,
min-E2E-PER routing, eq. 6 and the substitution baseline, and the AaYG,
C-FL and error-free exchanges fed the same uniforms."""
import itertools

import pytest
import torch

from dfl_bench import harness, traffic
from dfl_bench.reference import charrnn, exchange, resnet


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
