"""Network topology + wireless channel model for R&A D-FL.

Port of the reference package's `core/topology.py` (paper Sections III-A /
V-A): log-distance path loss, SNR -> BER (BPSK/QPSK Q-function) -> per-link
packet success rate, and the paper's exact Table-II 10-node network.

The channel math runs in float32, in the reference's order of operations,
so the two agree to the float32 rounding of ``exp(bits * log(1 - Q))``
(a relative gap of up to ``bits * 6e-8``); adjacency is decided in float64
numpy and is exactly equal.  Networks are small host-side descriptions:
their tensors live on the CPU and the simulator moves them to its device.
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
    tx_power_dbm: float = TX_POWER_DBM,
) -> Network:
    """Build a connected network whose edges are the shortest node pairs.

    Keeps the ``edge_density`` fraction of closest pairs (the paper's
    connectivity density rho), then joins components through their
    shortest cross edge until the graph is connected.
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

