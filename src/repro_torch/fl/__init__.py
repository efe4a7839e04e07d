"""The D-FL round loop."""
