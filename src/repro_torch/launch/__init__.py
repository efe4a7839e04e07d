"""Entry points of the port (the reference's `launch/`)."""
