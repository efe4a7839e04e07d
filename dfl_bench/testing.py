"""Small cells for the CPU tests of the harness (not benchmark cells).

The widths are cut so that a whole run, program and reference, takes a
second or two on the CPU; the limits are the real cells' (a run on the
CPU reads far below them).
"""
from __future__ import annotations

from . import harness

COORDS = [[2196, 1351], [3637, 3127], [2642, 284], [2884, 848],
          [5254, 596], [1730, 1923]]
PROTOCOLS = [["ra", "ra_normalized"], ["aayg", "ra_normalized"],
             ["cfl", "ra_normalized"]]


def tiny_cell(kind: str = "char", **cell_overrides) -> harness.Cell:
    """A 6-client, 12-scenario cell of a small CharRNN (on ``char`` or
    ``tokens`` data) or ResNet (``image``)."""
    if kind in ("char", "tokens"):
        data = ({"kind": "char", "vocab": 12, "seq_len": 6, "iid": False,
                 "gamma_shape": 0.3, "test_sequences": 8}
                if kind == "char" else
                {"kind": "tokens", "vocab": 12, "seq_len": 6, "fanout": 4,
                 "zipf": 1.0, "gamma_shape": 0.3, "test_sequences": 8})
        config = {"name": f"tiny-{kind}",
                  "model": {"sim_model": "charrnn",
                            "init": {"vocab": 12, "embed": 4, "hidden": 8}},
                  "reference": "charrnn", "data": data,
                  "precision": "float32", "forward_flops_per_sample": 1}
        lr, epochs, real = 0.5, 1, "charrnn.grid12"
    else:
        config = {"name": "tiny-image",
                  "model": {"sim_model": "resnet",
                            "init": {"depth": 8, "width": 4, "in_ch": 3,
                                     "n_classes": 6}},
                  "reference": "resnet",
                  "data": {"kind": "image", "hw": 8, "channels": 3,
                           "n_classes": 6, "noise": 0.6, "test_size": 12},
                  "precision": "float32", "forward_flops_per_sample": 1}
        lr, epochs, real = 1e-2, 2, "resnet56.grid12"
    real = harness.load_json(harness.find("cells", real))
    cell = {"name": f"tiny-{kind}", "config": config["name"], "traffic": "t",
            "clients": 6, "samples_per_client": 6,
            "network": {"coords": COORDS, "edge_density": 0.5,
                        "packet_len_bits": 2048,
                        "tx_power_dbm": [17.0, 20.0]},
            "protocols": PROTOCOLS, "seeds_per_point": 2, "lr": lr,
            "local_epochs": epochs, "seg_len": 64, "rounds_per_call": 2,
            "aayg_mixes": 2, "aggregator": 2, "limits": real["limits"],
            "loss_floor": real.get("loss_floor", 0.0),
            **cell_overrides}
    workload = {"name": cell["name"], "config": config["name"],
                "traffic": "t", "chips": 1}
    return harness.Cell(workload, cell, config, [], [])
