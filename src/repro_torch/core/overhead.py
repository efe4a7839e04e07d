"""Communication-overhead accounting (paper Sec. V-A.4 + Table III).

Port of the reference package's `core/overhead.py` (host-side numpy).

TDMA slot counts and total network traffic per training round for the three
protocols.  Radio transmissions are broadcast by nature: two transmissions
conflict if their (transmitter ∪ receiver) node sets intersect, so slot
assignment is greedy edge coloring of the transmission conflict graph.

  * R&A D-FL:  transmissions = one per route hop per (src, dst) client pair.
  * AaYG D-FL: every client broadcasts J times; slots = J * (d_max + 1),
               traffic = J * N broadcasts (paper's formula).
  * C-FL:      uplink hops to the aggregator + downlink hops back.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from . import routing


@dataclasses.dataclass(frozen=True)
class Overhead:
    n_slots: int            # minimum TDMA slots per round
    n_transmissions: int    # link-level transmissions per round
    traffic_mbits: float    # total network traffic per round (MBits)

    def compressed(self, factor: float) -> "Overhead":
        """The overhead after an exchange codec shrinks every payload.

        ``factor`` is the realized bits-on-air fraction in (0, 1]
        (`compression.host_factor`): traffic scales exactly, and the slot
        count scales in payload-time units — each transmission still
        occupies its slot, but the slot is ``factor`` as long, so the
        per-round airtime budget is ``ceil(n_slots * factor)`` equivalent
        full-payload slots (Table III compressed rows).  The transmission
        COUNT is unchanged: the codec shortens packets, it does not remove
        route hops.
        """
        if not 0.0 < factor <= 1.0:
            raise ValueError(f"compression factor must be in (0, 1], "
                             f"got {factor}")
        return Overhead(
            n_slots=int(np.ceil(self.n_slots * factor)),
            n_transmissions=self.n_transmissions,
            traffic_mbits=self.traffic_mbits * factor,
        )


def _greedy_slots(transmissions: list[tuple[int, int]]) -> int:
    """Greedy coloring: assign each (tx, rx) transmission the first slot in
    which no already-scheduled transmission shares a node with it.

    The input is SORTED first: greedy coloring is order-sensitive, so the
    slot count must not depend on the (route-enumeration) order callers
    happen to produce — Table-III numbers stay deterministic under any
    permutation of the same transmission set.
    """
    slots: list[set[int]] = []
    for tx, rx in sorted(transmissions):
        nodes = {tx, rx}
        for s in slots:
            if not (s & nodes):
                s.update(nodes)
                break
        else:
            slots.append(set(nodes))
    return len(slots)


def _route_transmissions(
    next_hop: np.ndarray, n_clients: int, pairs: list[tuple[int, int]]
) -> list[tuple[int, int]]:
    txs: list[tuple[int, int]] = []
    for m, n in pairs:
        route = routing.reconstruct_route(next_hop, m, n)
        for i in range(len(route) - 1):
            txs.append((route[i], route[i + 1]))
    return txs


def ra_overhead(next_hop: np.ndarray, n_clients: int, model_mbits: float,
                sources: Sequence[int] | None = None) -> Overhead:
    """R&A D-FL: every client pair exchanges along its min-PER route.

    ``sources`` restricts the scheduled route-sets to the given source
    clients (the Section-IV bandwidth-constrained variant: pass
    `routing.admit_homologous_routes(...)`); None schedules everyone.
    """
    srcs = range(n_clients) if sources is None else sources
    pairs = [
        (m, n) for m in srcs for n in range(n_clients) if m != n
    ]
    txs = _route_transmissions(np.asarray(next_hop), n_clients, pairs)
    return Overhead(
        n_slots=_greedy_slots(txs),
        n_transmissions=len(txs),
        traffic_mbits=len(txs) * model_mbits,
    )


def aayg_overhead(adjacency: np.ndarray, n_clients: int, model_mbits: float,
                  n_mixes: int) -> Overhead:
    """AaYG: J broadcast rounds; paper's slot formula J * (d_max + 1)."""
    adj = np.asarray(adjacency)[:n_clients, :n_clients]
    d_max = int(adj.sum(axis=1).max())
    n_slots = n_mixes * (d_max + 1)
    n_tx = n_mixes * n_clients  # broadcasts (each reaches all neighbors)
    return Overhead(
        n_slots=n_slots,
        n_transmissions=n_tx,
        traffic_mbits=n_tx * model_mbits,
    )


def cfl_overhead(next_hop: np.ndarray, n_clients: int, model_mbits: float,
                 aggregator: int) -> Overhead:
    """C-FL: all clients -> aggregator, then aggregator -> all clients."""
    up = [(m, aggregator) for m in range(n_clients) if m != aggregator]
    dn = [(aggregator, n) for n in range(n_clients) if n != aggregator]
    txs = _route_transmissions(np.asarray(next_hop), n_clients, up + dn)
    return Overhead(
        n_slots=_greedy_slots(txs),
        n_transmissions=len(txs),
        traffic_mbits=len(txs) * model_mbits,
    )
