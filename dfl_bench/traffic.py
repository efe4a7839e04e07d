"""The benchmark's one generator: everything a cell feeds the port, made
from ``--seed`` and the cell's and configuration's data files.

  * `client_sizes` — each client's shard size: the same evenly spaced set
    over [n/2, 3n/2) for every seed, dealt to the clients in an order drawn
    from the seed, so the padded batch (the largest shard) and the total
    work are the same on every seed.
  * `image_data` — the CIFAR stand-in (as `data/synthetic.py`
    `fed_image_classification` of the port): one Gaussian prototype per
    class plus noise, NHWC images, ``classes_per_client`` classes a client
    (label skew) in contiguous blocks, as the sort-by-label shards of
    McMahan et al.'s pathological non-i.i.d. split hold them.
  * `char_data` — the Shakespeare stand-in (as `fed_char_stream`): Markov
    chains over the vocabulary with Gamma(0.3) transition rows, one chain
    per client when non-i.i.d., the test set from a global chain.
  * `token_data` — token sequences for a language model: one sparse
    Markov chain a client over ``vocab`` ids, each id ``fanout``
    successors drawn from a Zipf law over the ids with Gamma transition
    weights (O(V x fanout) memory), so token frequencies are skewed as
    text's are; the test set from a global chain.
  * `network` — the paper's channel model (Sec. V-A; as `core/topology.py`
    `make_network`): the closest ``edge_density`` of node pairs linked,
    components joined by their shortest edge, per-link packet success
    eps = (1 - Q(sqrt(2 SNR)))^bits under free-space path loss.
  * `call_seeds` — the scenario seeds of the window's k-th call;
    `sample_rng` — the draw of the call and rows compared after it.
  * `Weights` — a model's initial leaves for a scenario seed, drawn on the
    device in one call from a generator on the run's device.

Bulk data is drawn on the run's device; the small tables (class
prototypes aside, chains, link matrices) on the host.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# Paper constants (Sec. V-A).
FC_HZ = 2.5e9
BANDWIDTH_HZ = 30e6
NOISE_PSD_DBM_HZ = -174.0

# Distinct streams drawn from one --seed.
_DATA, _ORDER, _CALL, _WEIGHTS, _SAMPLE = 1, 2, 3, 4, 5


def _seq(seed: int, *words: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *words])


def torch_seed(seed: int, *words: int) -> int:
    """A 63-bit generator seed for one stream of ``seed``."""
    hi, lo = _seq(seed, *words).generate_state(2, np.uint32)
    return ((int(hi) << 32) | int(lo)) & (2 ** 63 - 1)


def sample_rng(seed: int) -> np.random.Generator:
    """The stream that picks what a run compares after its window."""
    return np.random.default_rng(_seq(seed, _SAMPLE))


def call_seeds(seed: int, call: int, count: int) -> list[int]:
    """``count`` consecutive scenario seeds of call ``call`` (the warm-up
    is call -1), each below 2**31 as the port's int32 seed field takes."""
    base = int(_seq(seed, _CALL, call + 1).generate_state(1, np.uint32)[0])
    base %= 2 ** 31 - count
    return [base + i for i in range(count)]


def client_sizes(mean: int, clients: int, seed: int) -> list[int]:
    """The evenly spaced sizes over [mean / 2, 3 mean / 2), permuted."""
    lo, span = mean // 2, mean
    sizes = [lo + span * (2 * i + 1) // (2 * clients) for i in range(clients)]
    order = np.random.default_rng(_seq(seed, _ORDER)).permutation(clients)
    return [sizes[i] for i in order]


@dataclasses.dataclass
class Data:
    """Per-client shards and the test set, on the run's device."""

    train_x: list[torch.Tensor]
    train_y: list[torch.Tensor]
    test_x: torch.Tensor
    test_y: torch.Tensor


def image_data(spec: dict, sizes: list[int], seed: int,
               device: torch.device) -> Data:
    gen = torch.Generator(device=device).manual_seed(
        torch_seed(seed, _DATA))
    hw, ch, classes = spec["hw"], spec["channels"], spec["n_classes"]
    d = hw * hw * ch
    protos = torch.randn((classes, d), generator=gen, device=device)

    def sample(cls: int, count: int):
        x = protos[cls] + spec["noise"] * torch.randn(
            (count, d), generator=gen, device=device)
        y = torch.full((count,), cls, dtype=torch.int32, device=device)
        return x.reshape(count, hw, hw, ch), y

    per_client = spec.get("classes_per_client", 1)
    train = []
    for c, n in enumerate(sizes):
        blocks = [sample((per_client * c + k) % classes,
                         (n * (k + 1)) // per_client - (n * k) // per_client)
                  for k in range(per_client)]
        train.append((torch.cat([x for x, _ in blocks]),
                      torch.cat([y for _, y in blocks])))
    per = spec["test_size"] // classes
    test = [sample(c, per) for c in range(classes)]
    return Data([x for x, _ in train], [y for _, y in train],
                torch.cat([x for x, _ in test]),
                torch.cat([y for _, y in test]))


def char_data(spec: dict, sizes: list[int], seed: int,
              device: torch.device) -> Data:
    vocab, steps = spec["vocab"], spec["seq_len"] + 1
    rng = np.random.default_rng(_seq(seed, _DATA))

    def chain():
        t = rng.gamma(spec["gamma_shape"], size=(vocab, vocab))
        return np.cumsum(t / t.sum(1, keepdims=True), axis=1)

    glob = chain()
    chains = [glob if spec["iid"] else chain() for _ in sizes] + [glob]
    counts = list(sizes) + [spec["test_sequences"]]
    gen = torch.Generator(device=device).manual_seed(
        torch_seed(seed, _DATA))
    seqs = []
    for cum, count in zip(chains, counts):
        cum = torch.from_numpy(cum).to(device)
        tok = torch.randint(vocab, (count,), generator=gen, device=device)
        out = [tok]
        for _ in range(steps - 1):
            u = torch.rand((count, 1), generator=gen, device=device,
                           dtype=torch.float64)
            tok = torch.clamp((cum[tok] < u).sum(dim=1), max=vocab - 1)
            out.append(tok)
        seqs.append(torch.stack(out, dim=1).to(torch.int32))
    train, test = seqs[:-1], seqs[-1]
    return Data([s[:, :-1] for s in train], [s[:, 1:] for s in train],
                test[:, :-1].contiguous(), test[:, 1:].contiguous())


def zipf_law(vocab: int, exponent: float) -> np.ndarray:
    """Zipf(``exponent``) probabilities over the ids: id i (0 the most
    frequent) in proportion to (i + 1) ** -exponent."""
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -float(exponent)
    return w / w.sum()


def token_chain(spec: dict,
                rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """One sparse Markov chain over ``vocab`` ids: each id's ``fanout``
    successors (V, F) int32, drawn from the Zipf law over the ids, and
    their cumulative Gamma(``gamma_shape``) weights (V, F) float64.  The
    successors are drawn 1,024 ids at a time, so that about 12 bytes an
    entry are held at most (O(V x F), never O(V^2))."""
    vocab, fanout = spec["vocab"], spec["fanout"]
    cdf = np.cumsum(zipf_law(vocab, spec["zipf"]))
    succ = np.empty((vocab, fanout), np.int32)
    for lo in range(0, vocab, 1024):
        u = rng.random((min(1024, vocab - lo), fanout))
        succ[lo:lo + len(u)] = np.minimum(
            np.searchsorted(cdf, u, side="right"), vocab - 1)
    cum = rng.gamma(spec["gamma_shape"], size=(vocab, fanout))
    cum /= cum.sum(axis=1, keepdims=True)
    np.cumsum(cum, axis=1, out=cum)
    return succ, cum


def token_data(spec: dict, sizes: list[int], seed: int,
               device: torch.device) -> Data:
    """Token sequences for a language model: one sparse chain a client
    (`token_chain`), the test sequences from a global chain, each
    sequence's first id from the Zipf law; ``seq_len`` inputs and their
    next ids a sequence."""
    vocab, fanout, steps = spec["vocab"], spec["fanout"], spec["seq_len"] + 1
    rng = np.random.default_rng(_seq(seed, _DATA))
    counts = list(sizes) + [spec["test_sequences"]]
    succ = torch.empty((len(counts), vocab, fanout), dtype=torch.int32,
                       device=device)
    cum = torch.empty((len(counts), vocab, fanout), dtype=torch.float64,
                      device=device)
    glob = token_chain(spec, rng)
    for c in range(len(counts)):
        s, w = glob if c == len(sizes) else token_chain(spec, rng)
        succ[c], cum[c] = torch.from_numpy(s), torch.from_numpy(w)
    chain = torch.repeat_interleave(torch.arange(len(counts), device=device),
                                    torch.tensor(counts, device=device))
    gen = torch.Generator(device=device).manual_seed(
        torch_seed(seed, _DATA))
    law = torch.from_numpy(zipf_law(vocab, spec["zipf"])).to(device)
    tok = torch.multinomial(law, len(chain), replacement=True, generator=gen)
    out = [tok]
    for _ in range(steps - 1):
        u = torch.rand((len(chain), 1), generator=gen, device=device,
                       dtype=torch.float64)
        j = torch.clamp((cum[chain, tok] < u).sum(dim=1), max=fanout - 1)
        tok = succ[chain, tok, j].long()
        out.append(tok)
    seqs = torch.split(torch.stack(out, dim=1).to(torch.int32), counts)
    train, test = seqs[:-1], seqs[-1]
    return Data([s[:, :-1] for s in train], [s[:, 1:] for s in train],
                test[:, :-1].contiguous(), test[:, 1:].contiguous())


DATA_KINDS = {"image": image_data, "char": char_data, "tokens": token_data}


def make_data(spec: dict, sizes: list[int], seed: int,
              device: torch.device) -> Data:
    """The configuration's data kind (``spec["kind"]``) at these sizes."""
    if spec["kind"] not in DATA_KINDS:
        raise ValueError(f"unknown data kind {spec['kind']!r}: choose from "
                         f"{sorted(DATA_KINDS)}")
    return DATA_KINDS[spec["kind"]](spec, sizes, seed, device)


# ---------------------------------------------------------------------------
# The channel (float32, in the port's order of operations).
# ---------------------------------------------------------------------------
def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def packet_success(dist_m: torch.Tensor, bits: int,
                   tx_power_dbm: float) -> torch.Tensor:
    d_km = torch.clamp(dist_m, min=1.0) / 1000.0
    loss_db = (20.0 * torch.log10(_f32(FC_HZ / 1e6))
               + 20.0 * torch.log10(d_km) + 32.4)
    noise_dbm = NOISE_PSD_DBM_HZ + 10.0 * torch.log10(_f32(BANDWIDTH_HZ))
    snr = torch.pow(_f32(10.0), (tx_power_dbm - loss_db - noise_dbm) / 10.0)
    q = 0.5 * torch.special.erfc(torch.sqrt(2.0 * snr) / torch.sqrt(_f32(2.0)))
    bit = torch.clamp(1.0 - q, torch.finfo(torch.float32).tiny, 1.0)
    return torch.exp(bits * torch.log(bit))


def _components(adj: np.ndarray) -> list[list[int]]:
    seen, comps = np.zeros(len(adj), bool), []
    for s in range(len(adj)):
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


@dataclasses.dataclass
class Link:
    """One network point: node positions, adjacency, link success."""

    coords: np.ndarray           # (V, 2) meters
    adjacency: np.ndarray        # (V, V) bool
    link_eps: torch.Tensor       # (V, V) float32, on the CPU
    packet_len_bits: int
    tx_power_dbm: float


def network(coords, *, edge_density: float, packet_len_bits: int,
            tx_power_dbm: float) -> Link:
    coords = np.asarray(coords, np.float64)
    v = len(coords)
    dist = np.sqrt(((coords[:, None] - coords[None]) ** 2).sum(-1))
    iu = np.triu_indices(v, k=1)
    edges = max(v - 1, int(round(edge_density * len(iu[0]))))
    sel = np.argsort(dist[iu])[:edges]
    adj = np.zeros((v, v), bool)
    adj[iu[0][sel], iu[1][sel]] = True
    adj |= adj.T
    comps = _components(adj)
    while len(comps) > 1:
        best = (math.inf, None)
        for other in comps[1:]:
            sub = dist[np.ix_(comps[0], other)]
            i, j = np.unravel_index(np.argmin(sub), sub.shape)
            if sub[i, j] < best[0]:
                best = (sub[i, j], (comps[0][i], other[j]))
        a, b = best[1]
        adj[a, b] = adj[b, a] = True
        comps = _components(adj)
    eps = packet_success(torch.from_numpy(dist).to(torch.float32),
                         packet_len_bits, tx_power_dbm)
    eps = torch.where(torch.from_numpy(adj), eps, torch.zeros(()))
    eps = eps * (1.0 - torch.eye(v))
    return Link(coords, adj, eps, packet_len_bits, tx_power_dbm)


# ---------------------------------------------------------------------------
# Initial weights.
# ---------------------------------------------------------------------------
class Weights:
    """A model's initial leaves for a scenario seed: one normal draw of all
    parameters on the device, scaled leaf by leaf (a zero scale gives a
    zero leaf), plus each leaf's constant offset where a layout entry
    gives one as its fourth element (``(name, shape, 0.0, 1.0)`` is a leaf
    of ones), split into views in leaf order."""

    def __init__(self, layout, run_seed: int, device: torch.device):
        self.names = [name for name, *_ in layout]
        self.shapes = [tuple(shape) for _, shape, *_ in layout]
        sizes = torch.tensor([math.prod(shape) for shape in self.shapes])
        self.count = int(sizes.sum())
        self.scale = torch.repeat_interleave(
            torch.tensor([std for _, _, std, *_ in layout],
                         dtype=torch.float32), sizes).to(device)
        offsets = [entry[3] if len(entry) > 3 else 0.0 for entry in layout]
        # Only a layout that states an offset adds one: x + 0.0 turns the
        # -0.0 of a zero-scaled negative draw into +0.0.
        self.offset = (torch.repeat_interleave(
            torch.tensor(offsets, dtype=torch.float32), sizes).to(device)
            if any(offsets) else None)
        self.run_seed = run_seed
        self.device = device

    def __call__(self, scenario_seed: int) -> dict[str, torch.Tensor]:
        gen = torch.Generator(device=self.device).manual_seed(
            torch_seed(self.run_seed, _WEIGHTS, int(scenario_seed)))
        flat = torch.randn(self.count, generator=gen,
                           device=self.device) * self.scale
        if self.offset is not None:
            flat = flat + self.offset
        parts = torch.split(flat, [math.prod(s) for s in self.shapes])
        return {n: t.reshape(s)
                for n, t, s in zip(self.names, parts, self.shapes)}
