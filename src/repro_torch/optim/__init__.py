"""Local optimizers (port of the reference package's `optim/`)."""
