"""The port's benchmark: D-FL sweeps through `repro_torch`'s grid runner.

`run.py` runs one cell once; `harness.py` holds the run; `traffic.py` the
one generator of inputs; `flops.py` and `peaks.json` the arithmetic of
model FLOPs and the card's peaks; `devtrace.py` the profiler trace's
reader; `reference/` the plain reference; `configs/`, `cells/` and
`metrics/` the configurations, cells and per-layer readers, found by name.
"""
