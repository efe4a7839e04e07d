"""Model configurations of the port (the reference's `configs/`)."""
