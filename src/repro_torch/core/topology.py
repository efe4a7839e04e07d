"""Network topology + wireless channel model for R&A D-FL.

Port of the reference package's `core/topology.py` (paper Sections III-A /
V-A): log-distance path loss, SNR -> BER (BPSK/QPSK Q-function) -> per-link
packet success rate, the paper's exact Table-II 10-node network, the
Fig. 9 relay networks, random geometric networks, and time-varying
link schedules (Markov churn, random-waypoint mobility, shadow fading).

The channel math runs in float32, in the reference's order of operations,
so the two agree to the float32 rounding of ``exp(bits * log(1 - Q))``
(a relative gap of up to ``bits * 6e-8``); adjacency is decided in float64
numpy and is exactly equal.  Networks are small host-side descriptions:
their tensors live on the CPU and the simulator moves them to its device.

The random generators draw from ``np.random.default_rng(seed)`` in the
reference's order, so node positions, waypoints, shadowing draws and
on/off patterns are the reference's exactly; only the float32 channel
steps (path loss, bit success rate) run through this module's torch
functions.  Every schedule is a host-side (T, V, V) float32 numpy stack:
round t of the simulator uses entry t % T.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Paper constants (Section V-A).
# ---------------------------------------------------------------------------
FC_HZ = 2.5e9              # carrier frequency f_c = 2.5 GHz
BANDWIDTH_HZ = 30e6        # B = 30 MHz
TX_POWER_DBM = 20.0        # P = 20 dBm
NOISE_PSD_DBM_HZ = -174.0  # N0 = -174 dBm/Hz

# Table II: coordinates (meters) of the 10 randomly generated clients.
TABLE_II_COORDS = np.array(
    [
        [2196, 1351],
        [3637, 3127],
        [2642, 284],
        [2884, 848],
        [5254, 596],
        [1730, 1923],
        [3572, 2668],
        [4546, 5326],
        [4328, 4001],
        [2534, 5171],
    ],
    dtype=np.float64,
)

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Network:
    """A static snapshot of the network for one training round.

    Attributes:
      coords:     (V, 2) float32 node positions in meters.
      adjacency:  (V, V) bool, symmetric, no self loops.
      link_eps:   (V, V) float32 per-link packet success rate in [0, 1];
                  0 where not adjacent.
      n_clients:  the first `n_clients` nodes take part in FL.
      packet_len_bits: the packet length the PER model was evaluated at
                  (None for hand-built networks).
      tx_power_dbm: the TX power the PER model was evaluated at.
    """

    coords: torch.Tensor
    adjacency: torch.Tensor
    link_eps: torch.Tensor
    n_clients: int
    packet_len_bits: int | None = None
    tx_power_dbm: float | None = None

    @property
    def n_nodes(self) -> int:
        return int(self.coords.shape[0])


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32)


def qfunc(x: torch.Tensor) -> torch.Tensor:
    """Gaussian tail function Q(x) = 0.5 * erfc(x / sqrt(2))."""
    return 0.5 * torch.special.erfc(x / torch.sqrt(_f32(2.0)))


def pathloss_db(dist_m: torch.Tensor) -> torch.Tensor:
    """Paper's channel gain h (dB) = 20 log10(f) + 20 log10(d) + 32.4.

    The free-space form with f in MHz and d in km.
    """
    d_km = torch.clamp(dist_m, min=1.0) / 1000.0
    f_mhz = FC_HZ / 1e6
    return 20.0 * torch.log10(_f32(f_mhz)) + 20.0 * torch.log10(d_km) + 32.4


def link_snr(dist_m: torch.Tensor,
             tx_power_dbm: float = TX_POWER_DBM) -> torch.Tensor:
    """Linear SNR per link given distance (meters)."""
    noise_dbm = NOISE_PSD_DBM_HZ + 10.0 * torch.log10(_f32(BANDWIDTH_HZ))
    rx_dbm = tx_power_dbm - pathloss_db(dist_m)
    return torch.pow(_f32(10.0), (rx_dbm - noise_dbm) / 10.0)


def bit_success_rate(snr: torch.Tensor) -> torch.Tensor:
    """BPSK/QPSK: BER = Q(sqrt(2 * gamma));  eps_bit = 1 - BER."""
    return 1.0 - qfunc(torch.sqrt(2.0 * snr))


def packet_success_rate(dist_m: torch.Tensor, packet_len_bits: int,
                        tx_power_dbm: float = TX_POWER_DBM) -> torch.Tensor:
    """Per-link packet success rate eps = eps_bit ** packet_len_bits.

    Computed in log space; the clip floor is the dtype's smallest normal
    value so it survives float32.
    """
    eps_bit = bit_success_rate(link_snr(dist_m, tx_power_dbm))
    eps_bit = torch.clamp(eps_bit, torch.finfo(eps_bit.dtype).tiny, 1.0)
    return torch.exp(packet_len_bits * torch.log(eps_bit))


def _components(adj: np.ndarray) -> list[list[int]]:
    v = adj.shape[0]
    seen = np.zeros(v, dtype=bool)
    comps = []
    for s in range(v):
        if seen[s]:
            continue
        stack, comp = [s], []
        seen[s] = True
        while stack:
            u = stack.pop()
            comp.append(u)
            for w in np.nonzero(adj[u])[0]:
                if not seen[w]:
                    seen[w] = True
                    stack.append(w)
        comps.append(comp)
    return comps


def make_network(
    coords: np.ndarray,
    *,
    edge_density: float = 0.5,
    packet_len_bits: int = 25_000,
    n_clients: int | None = None,
    seed: int = 0,
    tx_power_dbm: float = TX_POWER_DBM,
) -> Network:
    """Build a connected network whose edges are the shortest node pairs.

    Keeps the ``edge_density`` fraction of closest pairs (the paper's
    connectivity density rho), then joins components through their
    shortest cross edge until the graph is connected.  The construction is
    deterministic: ``seed`` is accepted, as in the reference, and changes
    nothing.
    """
    coords = np.asarray(coords, dtype=np.float64)
    v = coords.shape[0]
    n_clients = v if n_clients is None else n_clients
    diff = coords[:, None, :] - coords[None, :, :]
    dist = np.sqrt((diff ** 2).sum(-1))

    iu = np.triu_indices(v, k=1)
    n_pairs = len(iu[0])
    n_edges = max(v - 1, int(round(edge_density * n_pairs)))
    order = np.argsort(dist[iu])
    adj = np.zeros((v, v), dtype=bool)
    sel = order[:n_edges]
    adj[iu[0][sel], iu[1][sel]] = True
    adj |= adj.T

    comps = _components(adj)
    while len(comps) > 1:
        best = (np.inf, None)
        c0 = comps[0]
        for other in comps[1:]:
            sub = dist[np.ix_(c0, other)]
            i, j = np.unravel_index(np.argmin(sub), sub.shape)
            if sub[i, j] < best[0]:
                best = (sub[i, j], (c0[i], other[j]))
        u, w = best[1]
        adj[u, w] = adj[w, u] = True
        comps = _components(adj)

    adj_t = torch.from_numpy(adj)
    eps = packet_success_rate(torch.from_numpy(dist).to(_F32),
                              packet_len_bits, tx_power_dbm)
    eps = torch.where(adj_t, eps, torch.zeros((), dtype=_F32))
    eps = eps * (1.0 - torch.eye(v, dtype=_F32))
    return Network(
        coords=torch.from_numpy(coords).to(_F32),
        adjacency=adj_t,
        link_eps=eps,
        n_clients=n_clients,
        packet_len_bits=packet_len_bits,
        tx_power_dbm=tx_power_dbm,
    )


def paper_network(edge_density: float = 0.5,
                  packet_len_bits: int = 25_000) -> Network:
    """The paper's exact 10-node network (Table II)."""
    return make_network(
        TABLE_II_COORDS,
        edge_density=edge_density,
        packet_len_bits=packet_len_bits,
        n_clients=10,
    )



def paper_network_with_relays(
    n_relays: int,
    *,
    edge_density: float = 0.5,
    packet_len_bits: int = 25_000,
    seed: int = 7,
    tx_power_dbm: float = TX_POWER_DBM,
) -> Network:
    """Fig. 9 scenario: the 10 Table-II clients + ``n_relays`` routing-only
    nodes dropped uniformly at random over twice the clients' extent."""
    rng = np.random.default_rng(seed)
    area = TABLE_II_COORDS.max(axis=0) * 2.0
    relay_coords = rng.uniform(low=0.0, high=area, size=(n_relays, 2))
    coords = np.concatenate([TABLE_II_COORDS, relay_coords], axis=0)
    return make_network(coords, edge_density=edge_density,
                        packet_len_bits=packet_len_bits, n_clients=10,
                        tx_power_dbm=tx_power_dbm)


def random_geometric_network(
    n_nodes: int,
    *,
    area_m: float = 6000.0,
    edge_density: float = 0.5,
    packet_len_bits: int = 25_000,
    n_clients: int | None = None,
    seed: int = 0,
) -> Network:
    """A fresh random geometric network (paper Section V-A generator)."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0.0, area_m, size=(n_nodes, 2))
    return make_network(coords, edge_density=edge_density,
                        packet_len_bits=packet_len_bits, n_clients=n_clients,
                        seed=seed)


def _channel_defaults(net: Network, packet_len_bits, tx_power_dbm):
    """The PER-model constants a schedule re-evaluates (the network's own
    unless given; ``is None`` tests, so an explicit 0 is honoured)."""
    if packet_len_bits is None:
        packet_len_bits = (net.packet_len_bits
                           if net.packet_len_bits is not None else 25_000)
    if tx_power_dbm is None:
        tx_power_dbm = (net.tx_power_dbm if net.tx_power_dbm is not None
                        else TX_POWER_DBM)
    return packet_len_bits, tx_power_dbm


def markov_link_schedule(
    net: Network,
    n_rounds: int,
    *,
    p_drop: float,
    p_recover: float = 0.5,
    seed: int = 0,
) -> np.ndarray:
    """Per-round link on/off churn: a 2-state Markov chain per edge.

    Every undirected edge starts ON (its static ``link_eps``) and moves
    ON -> OFF with probability ``p_drop``, OFF -> ON with ``p_recover``;
    an OFF link has eps = 0 and routing goes around it.  ``p_drop=0``
    repeats the static matrix.  Returns (n_rounds, V, V) float32.
    """
    if not 0.0 <= p_drop <= 1.0 or not 0.0 <= p_recover <= 1.0:
        raise ValueError(
            f"p_drop/p_recover must be probabilities, got {p_drop}/{p_recover}"
        )
    rng = np.random.default_rng(seed)
    base = np.asarray(net.link_eps, np.float32)
    adj = np.asarray(net.adjacency)
    v = base.shape[0]
    iu = np.triu_indices(v, k=1)
    on = np.ones(len(iu[0]), dtype=bool)
    out = np.empty((n_rounds, v, v), np.float32)
    for t in range(n_rounds):
        if t > 0:
            u = rng.random(len(on))
            on = np.where(on, u >= p_drop, u < p_recover)
        gate = np.zeros((v, v), np.float32)
        gate[iu] = on.astype(np.float32)
        gate += gate.T                      # symmetric; diagonal stays 0
        out[t] = base * gate * adj
    return out


def mobility_link_schedule(
    net: Network,
    n_rounds: int,
    *,
    step_m: float,
    seed: int = 0,
    range_m: float | None = None,
    area: tuple[float, float, float, float] | None = None,
    packet_len_bits: int | None = None,
    tx_power_dbm: float | None = None,
) -> np.ndarray:
    """Correlated per-round link qualities from random-waypoint mobility.

    Every node walks toward a uniform waypoint in ``area`` (default: the
    coordinates' bounding box), ``step_m`` meters a round, drawing a new
    waypoint on arrival; each round's link qualities come from the current
    distances through `packet_success_rate`.  Round 0 uses the network's
    own coordinates.  ``range_m=None`` keeps the static adjacency (then
    ``step_m=0`` repeats the static matrix); a float re-derives adjacency
    each round as ``distance <= range_m``.  Returns (n_rounds, V, V)
    float32.
    """
    if step_m < 0.0:
        raise ValueError(f"step_m must be >= 0, got {step_m}")
    packet_len_bits, tx_power_dbm = _channel_defaults(net, packet_len_bits,
                                                      tx_power_dbm)
    rng = np.random.default_rng(seed)
    coords = np.array(net.coords, dtype=np.float64, copy=True)
    v = coords.shape[0]
    static_adj = np.asarray(net.adjacency)
    if area is None:
        lo, hi = coords.min(axis=0), coords.max(axis=0)
    else:
        x0, y0, x1, y1 = area
        lo = np.array([x0, y0], np.float64)
        hi = np.array([x1, y1], np.float64)
    waypoints = rng.uniform(lo, hi, size=(v, 2))

    dists = np.empty((n_rounds, v, v))
    adjs = (None if range_m is None
            else np.empty((n_rounds, v, v), dtype=bool))
    for t in range(n_rounds):
        if t > 0 and step_m > 0.0:
            delta = waypoints - coords
            dist_wp = np.sqrt((delta ** 2).sum(axis=1))
            arrive = dist_wp <= step_m
            unit = np.where(dist_wp[:, None] > 0.0,
                            delta / np.maximum(dist_wp, 1e-12)[:, None], 0.0)
            coords = np.where(arrive[:, None], waypoints,
                              coords + step_m * unit)
            if arrive.any():
                waypoints[arrive] = rng.uniform(lo, hi,
                                                size=(int(arrive.sum()), 2))
        diff = coords[:, None, :] - coords[None, :, :]
        dists[t] = np.sqrt((diff ** 2).sum(-1))
        if adjs is not None:
            adjs[t] = (dists[t] <= range_m) & ~np.eye(v, dtype=bool)
    adj = (np.broadcast_to(static_adj[None], (n_rounds, v, v))
           if adjs is None else adjs)
    # The make_network chain, so a frozen walk repeats the static matrix.
    eps = packet_success_rate(torch.from_numpy(dists).to(_F32),
                              packet_len_bits, tx_power_dbm)
    eps = torch.where(torch.from_numpy(np.ascontiguousarray(adj)), eps,
                      torch.zeros((), dtype=_F32))
    eps = eps * (1.0 - torch.eye(v, dtype=_F32))
    return eps.numpy().astype(np.float32)


def fading_per_schedule(
    net: Network,
    n_rounds: int,
    *,
    shadow_sigma_db: float = 6.0,
    seed: int = 0,
    packet_len_bits: int | None = None,
    tx_power_dbm: float | None = None,
) -> np.ndarray:
    """Per-round link qualities under log-normal shadow fading.

    Each round draws an i.i.d. symmetric per-link shadowing term
    X ~ N(0, shadow_sigma_db^2) dB on the received power and re-evaluates
    SNR -> bit success -> packet success over the fixed adjacency.  The
    SNR is formed in float64 numpy, as in the reference; the bit success
    rate is this module's float32 function.  Returns (n_rounds, V, V)
    float32.
    """
    packet_len_bits, tx_power_dbm = _channel_defaults(net, packet_len_bits,
                                                      tx_power_dbm)
    rng = np.random.default_rng(seed)
    coords = np.asarray(net.coords)
    adj = np.asarray(net.adjacency, np.float32)
    v = coords.shape[0]
    diff = coords[:, None, :] - coords[None, :, :]
    dist = np.sqrt((diff ** 2).sum(-1))
    iu = np.triu_indices(v, k=1)

    shadow = np.zeros((n_rounds, v, v))
    draws = rng.normal(0.0, shadow_sigma_db, size=(n_rounds, len(iu[0])))
    shadow[:, iu[0], iu[1]] = draws
    shadow += np.transpose(shadow, (0, 2, 1))

    noise_dbm = NOISE_PSD_DBM_HZ + 10.0 * np.log10(BANDWIDTH_HZ)
    rx_dbm = tx_power_dbm - pathloss_db(torch.from_numpy(dist)).numpy()
    snr = 10.0 ** ((rx_dbm[None] + shadow - noise_dbm) / 10.0)
    eps_bit = bit_success_rate(torch.from_numpy(snr).to(_F32)).numpy()
    eps_bit = np.clip(eps_bit, np.finfo(eps_bit.dtype).tiny, 1.0)
    eps = np.exp(packet_len_bits * np.log(eps_bit))
    eps = eps * adj[None] * (1.0 - np.eye(v, dtype=np.float32))[None]
    return eps.astype(np.float32)
