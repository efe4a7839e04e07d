"""PyTorch port vs the JAX reference: whole runs, statistically.

`examples/quickstart.py`'s setup (the Table-II network at 17 dBm with
100,000-bit packets, 10 clients x 80 synthetic samples, the 32-48 MLP, 3
local epochs, segments of 256, 15 rounds) runs in both packages on the
CPU, each on its own random streams: the reference through
`scenarios.run_grid` (one vmapped program over the seeds), the port
through `simulator.build_sim` / `run_scenario` seed by seed.  The two
cannot draw the same numbers (threefry vs Philox; model init from a JAX
key vs a torch generator), so their runs are held to each other as
samples: per protocol, the mean over 16 seeds of the final accuracy
(averaged over clients) may differ by at most four standard errors of
the difference, taken from the runs' own spread,

    |mean_ref - mean_port| <= 4 * sqrt(s_ref^2 / n + s_port^2 / n),

about a 1-in-2,600 chance of a false alarm for two correct samples
(Student's t, 30 degrees of freedom).  The seeds are fixed, so the test
is deterministic.
"""
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import topology as jtopology  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.fl import scenarios as jscenarios  # noqa: E402
from repro.fl import simulator as jsimulator  # noqa: E402
from repro.models import smallnets as jsmall  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.fl import simulator  # noqa: E402
from repro_torch.models import smallnets  # noqa: E402

SEEDS = tuple(range(16))
PROTOCOLS = (("ra", "ra_normalized"), ("ra", "substitution"),
             ("aayg", "ra_normalized"))
STATICS = dict(n_rounds=15, local_epochs=3, seg_len=256)
NET = dict(edge_density=0.5, packet_len_bits=100_000, n_clients=10,
           tx_power_dbm=17.0)
DATA = dict(n_clients=10, samples_per_client=80)
N_SE = 4.0

# The quickstart's channel is built for 100,000-bit packets while its
# 256-value segments are 8,192 bits; both packages warn about it, as the
# quickstart does.
pytestmark = pytest.mark.filterwarnings(
    "ignore::repro.fl.simulator.PacketLengthMismatchWarning",
    "ignore::repro_torch.fl.simulator.PacketLengthMismatchWarning")


@functools.lru_cache(maxsize=None)
def _reference_finals() -> dict:
    """{(protocol, mode): final mean accuracy per seed} from the reference."""
    net = jtopology.make_network(jtopology.TABLE_II_COORDS, **NET)
    data = jsynthetic.fed_image_classification(**DATA)
    grid = jscenarios.ScenarioGrid.product(
        networks=[("quickstart", net)], protocols=PROTOCOLS, seeds=SEEDS)
    init = functools.partial(jsmall.init_mlp_clf, d_in=32, d_hidden=48)
    res = jscenarios.run_grid(init, jsmall.apply_mlp_clf, data, grid,
                              jsimulator.SimConfig(**STATICS))
    finals = {}
    for proto, mode in PROTOCOLS:
        finals[(proto, mode)] = np.array([
            float(res.result(f"quickstart/{proto}+{mode}/s{s}").mean_acc[-1])
            for s in SEEDS])
    return finals


@functools.lru_cache(maxsize=None)
def _port_finals() -> dict:
    """The same, from the port on the CPU, each seed its own scenario."""
    net = topology.make_network(topology.TABLE_II_COORDS, **NET)
    data = synthetic.fed_image_classification(**DATA)
    init = functools.partial(smallnets.init_mlp_clf, d_in=32, d_hidden=48)
    sim = simulator.build_sim(init, smallnets.apply_mlp_clf, data,
                              device="cpu", **STATICS)
    finals = {}
    for proto, mode in PROTOCOLS:
        accs = []
        for s in SEEDS:
            cfg = simulator.SimConfig(protocol=proto, mode=mode, seed=s,
                                      **STATICS)
            m = sim.run_scenario(simulator.make_scenario(net, cfg))
            accs.append(float(simulator.metrics_to_result(m).mean_acc[-1]))
        finals[(proto, mode)] = np.array(accs)
    return finals


@pytest.mark.parametrize("protocol", PROTOCOLS, ids=lambda pm: "+".join(pm))
def test_final_accuracy_matches_reference_over_seeds(protocol):
    ref, port = _reference_finals()[protocol], _port_finals()[protocol]
    n = len(SEEDS)
    assert ref.shape == port.shape == (n,)
    assert np.isfinite(ref).all() and np.isfinite(port).all()
    # Each package's seeds must give different runs, or the bound below
    # (built from their spread) would say nothing.
    s_ref, s_port = ref.std(ddof=1), port.std(ddof=1)
    assert s_ref > 0 and s_port > 0
    gap = abs(ref.mean() - port.mean())
    bound = N_SE * math.sqrt(s_ref ** 2 / n + s_port ** 2 / n)
    assert gap <= bound, (
        f"{protocol}: mean final accuracy {ref.mean():.4f} (reference) vs "
        f"{port.mean():.4f} (port), gap {gap:.4f} > {N_SE:g} standard "
        f"errors = {bound:.4f} (SD {s_ref:.4f} / {s_port:.4f}, n = {n})")
